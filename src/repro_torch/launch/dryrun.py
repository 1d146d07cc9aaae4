"""Dry-run: trace every (arch x shape x mesh) cell's step on the meta
device over a fake process group (the counterpart of
``repro/launch/dryrun.py``, which lowers and compiles each cell with
XLA).

One process stands for every rank of the mesh: the default process group
is the fake backend (``distributed.compat.init_fake_process_group``,
collectives return at once), the parameters, optimizer state and batch
are DTensors laid out by ``distributed.sharding`` whose local shards are
meta tensors (a shape and a dtype, no storage), and the cell's step runs
eagerly on them -- DTensor inserts the same collectives it would on the
cards.  A dispatch mode (``StepCounter``) sees every local operation of
one rank and records, per device:

  * ``flops``: the operations' FLOPs by ``torch.utils.flop_counter``'s
    formulas (``FlopCounterMode``'s registry) on the local shapes; the
    trace runs every layer and microbatch, so the count is
    trip-count-correct without the reference's unrolled cost variant;
  * ``collective_bytes``: the output bytes of each ``_c10d_functional``
    collective by kind (all-reduce, all-gather, reduce-scatter,
    all-to-all, collective-permute), as the reference sums them from the
    partitioned HLO (``collective_bytes``);
  * ``peak_bytes_per_device``: the high-water mark of live local
    storage, the step's arguments included (each storage counted once
    and released when its last tensor dies);
  * ``argument_bytes`` (the local state and batch), ``output_bytes``
    (the local bytes of what the step returns), ``alias_bytes`` (the
    outputs that are the arguments' own storage: the parameters are
    updated in place) and ``temp_bytes`` (peak minus arguments).

The port computes past the embedding in float32 with float32 weights:
a prefill/decode cell's parameters are float32 (the reference casts them
to bfloat16), and a train cell's ``cast_params`` rounds each weight
through bfloat16 on its shard before DTensor gathers it, so the FSDP
all-gathers move float32 words where the reference's move bfloat16.

Results are written as JSON under ``build/dryrun/`` (or ``--out``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import sys
import time
import traceback
import weakref
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

import repro_torch.configs as C
from repro_torch.distributed import compat as CP
from repro_torch.distributed import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import production_shape
from repro_torch.models import model as mdl
from repro_torch.train import optim, step as tstep

__all__ = ["TRAIN_OVERRIDES", "TARGET_DEVICE", "TARGET_HBM_BYTES",
           "COLLECTIVE_KINDS", "collective_bytes", "StepCounter",
           "fake_mesh", "lower_cell", "run_cell", "main"]

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

#: the card the records are held against, and its memory
TARGET_DEVICE = "NVIDIA H100 80GB HBM3"
TARGET_HBM_BYTES = 80 * 10 ** 9

# Per-arch training knobs (the reference's): the 100B+ configs need bf16
# optimizer state + gradient accumulation to fit a device's memory.
TRAIN_OVERRIDES = {
    "nemotron-4-340b": dict(state_dtype="bfloat16", accum=8),
    "deepseek-v3-671b": dict(state_dtype="bfloat16", accum=8),
    "qwen3-14b": dict(accum=2),
    "stablelm-12b": dict(accum=2),
    "gemma3-12b": dict(accum=4),
    "paligemma-3b": dict(accum=2),
    "musicgen-large": dict(accum=2),
    "olmoe-1b-7b": dict(accum=4),
    "xlstm-1.3b": dict(accum=4),
    "recurrentgemma-2b": dict(accum=2),
}

#: torch collective op -> the reference's HLO kind
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
        "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "alltoall_base_": "all-to-all",
    # point to point: the receiving side's bytes, as a permute's output
    "recv_": "collective-permute",
}
_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")


def collective_bytes(records: List[Tuple[str, int]]) -> Dict[str, int]:
    """Sum the output bytes of every collective record (kind, bytes) by
    kind, the reference's five keys."""
    out = {k: 0 for k in _KINDS}
    for kind, n in records:
        out[kind] += int(n)
    return out


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _local(t):
    return t.to_local() if isinstance(t, CP.DTensor) else t


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation is on the stack: it runs
    each new operation once on global-shape meta tensors to infer the
    output's shape, which is neither a device's work nor its memory."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("sharding_prop.py"):
            return True
        f = f.f_back
    return False


class StepCounter(TorchDispatchMode):
    """Records one rank's local operations (module docstring): FLOPs,
    collective records (kind, output bytes) and live storage bytes (the
    peak).  Operations on DTensors pass through (``NotImplemented``) so
    that DTensor's local operations, which carry the per-device shapes,
    reach the mode; so do the operations DTensor's sharding propagation
    runs on global shapes, which are skipped (``_in_propagation``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.records: List[Tuple[str, int]] = []
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        self._registry = FlopCounterMode(display=False).flop_registry

    def _free(self, n: int):
        self.live -= n

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until its last tensor dies."""
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, CP.DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        packet = func.overloadpacket
        if packet in self._registry:
            self.flops += int(self._registry[packet](*args, **kwargs,
                                                     out_val=out))
        name = func.name().split("::")[-1].split(".")[0]
        if func.namespace in ("_c10d_functional", "c10d", "_dtensor") \
                and name in COLLECTIVE_KINDS:
            outs = list(_tensors(out))
            if func.namespace == "c10d":       # in-place: the buffers
                outs = list(_tensors(args[0]))
            self.records.append((COLLECTIVE_KINDS[name], sum(
                o.numel() * o.element_size() for o in outs)))
        for o in _tensors(out):
            self.track(o)
        return out


def fake_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` (axis names ``axes``) over the fake
    process group, which this call (re)starts with ``prod(shape)``
    ranks (device type "cpu": DTensor's sharding propagation makes
    tensors of the mesh's device type, which this CPU build cannot for
    "cuda"; ``_card_collectives`` restores the cards' all-to-all)."""
    n = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != n:
        dist.destroy_process_group()
    CP.init_fake_process_group(n)
    return CP.init_device_mesh("cpu", tuple(shape),
                               mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def _card_collectives():
    """DTensor's shard-dim changes as the all-to-all it runs on cards
    (NCCL): on a "cpu" mesh it falls back to an all-gather and a chunk
    (gloo has no all-to-all), which would count the gathered tensor as
    both traffic and memory."""
    PT = sys.modules[CP.Shard.__module__]
    saved = getattr(PT, "shard_dim_alltoall", None)
    if saved is None or not hasattr(torch.ops._dtensor,
                                    "shard_dim_alltoall"):
        yield               # a torch without the op: its own path
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    PT.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        PT.shard_dim_alltoall = saved


def _local_bytes(tree) -> int:
    seen, n = set(), 0
    for t in _tensors(tree):
        st = _local(t).untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            n += st.nbytes()
    return n


def _state_tree(state):
    return {"params": dict(state["params"].named_parameters()),
            "opt": state["opt"], "step": state["step"]}


def lower_cell(arch: str, shape: str, multi_pod: bool = False, *,
               cell=None, mesh_shape=None, overrides=None,
               verbose: bool = True) -> dict:
    """Trace one cell's step (module docstring) and return its record.
    ``cell`` (a ``specs.Cell``) replaces the registered (arch, shape)
    cell, ``mesh_shape`` ((shape, axis names)) the production mesh and
    ``overrides`` (``state_dtype``, ``accum``, ``cast_params``) the
    arch's ``TRAIN_OVERRIDES``."""
    c = cell if cell is not None else SP.cell(arch, shape)
    shp, axes = mesh_shape or production_shape(multi_pod=multi_pod)
    mesh = fake_mesh(shp, axes)
    shard = SH.make_shard_fn(mesh, rules=SH.act_rules_for(c.step_kind))
    ov = dict(TRAIN_OVERRIDES.get(c.arch, {}) if overrides is None
              else overrides)
    counter = StepCounter()
    with _card_collectives():
        rec = _trace(c, mesh, shard, ov, counter)
    n_dev = math.prod(shp)
    peak = int(counter.peak)
    rec.update({
        "arch": c.arch, "shape": c.shape, "variant": "trace",
        "mesh": "x".join(map(str, shp)), "devices": n_dev,
        "step_kind": c.step_kind,
        "flops": float(counter.flops),
        "temp_bytes": int(peak - rec["argument_bytes"]),
        "peak_bytes_per_device": peak,
        "collective_bytes": collective_bytes(counter.records),
        "model_params": int(c.cfg.param_count()),
        "active_params": int(c.cfg.active_param_count()),
        "tokens_per_step": (c.global_batch * c.seq_len
                            if c.step_kind != "decode" else c.global_batch),
        "target_device": TARGET_DEVICE,
        "target_hbm_bytes": TARGET_HBM_BYTES,
        "fits": peak <= TARGET_HBM_BYTES,
        "torch": torch.__version__,
    })
    rec["collective_bytes_total"] = int(sum(
        rec["collective_bytes"].values()))
    if verbose:
        print(f"[{c.arch} x {c.shape} x {rec['mesh']}] "
              f"flops={rec['flops']:.3e} peak={peak / 1e9:.2f}GB "
              f"args={rec['argument_bytes'] / 1e9:.2f}GB "
              f"coll={rec['collective_bytes_total'] / 1e9:.2f}GB "
              f"trace={rec['trace_s']:.0f}s", flush=True)
    return rec


def _trace(c, mesh, shard, ov, counter) -> dict:
    """Run cell ``c``'s step on meta DTensors under ``counter``; returns
    the byte counts of its arguments and outputs and its seconds."""
    meta = torch.device("meta")
    t0 = time.time()
    if c.step_kind == "train":
        ocfg = optim.OptConfig(state_dtype=ov.get("state_dtype", "float32"))
        params = tstep.trainable(mdl.Transformer(c.cfg, meta))
        tstep.shard_params(params, mesh)
        state = {"params": params, "opt": optim.init(params, ocfg),
                 "step": torch.zeros((), dtype=torch.int32, device=meta)}
        batch = SP.batch_specs(c)
        step = tstep.make_train_step(
            c.cfg, ocfg, mesh, shard, accum_steps=ov.get("accum", 1),
            param_specs=mdl.param_specs(params),
            cast_params=ov.get("cast_params", True))
        args = [_state_tree(state), batch]
        arg_bytes = _local_bytes(args)
        in_storages = {id(_local(t).untyped_storage())
                       for t in _tensors(args)}
        for t in _tensors(args):
            counter.track(_local(t))
        with counter:
            state, metrics = step(state, batch)
        outs = [_state_tree(state), metrics]
    else:
        params = mdl.Transformer(c.cfg, meta)
        tstep.shard_params(params, mesh)
        pshard = SH.make_param_shard_fn(mesh, gather=("data",))
        with CP.implicit_replication(), torch.no_grad():
            if c.step_kind == "prefill":
                batch = tstep.shard_batch(
                    {k: v for k, v in SP.batch_specs(c).items()}, mesh)
                kw = dict(extra_embeds=batch.get("extra_embeds"),
                          cond=batch.get("cond"))
                args = [dict(params.named_parameters()), batch]
                fn = lambda: mdl.prefill(
                    params, c.cfg, batch["tokens"], mesh=mesh, shard=shard,
                    param_specs=mdl.param_specs(params), pshard=pshard,
                    **kw)
            else:
                dsp = SP.decode_specs(c)
                cache = _shard_cache(dsp["cache"], c.cfg, mesh)
                tok = _place(dsp["tokens"], ("batch", "seq"), mesh)
                pos = _place(dsp["cur_pos"], ("batch",), mesh)
                cond = (_place(dsp["cond"], ("batch", "seq", "embed"), mesh)
                        if "cond" in dsp else None)
                args = [dict(params.named_parameters()), cache, tok, pos,
                        cond]
                fn = lambda: mdl.decode_step(params, c.cfg, cache, tok, pos,
                                             cond=cond, mesh=mesh,
                                             shard=shard)
            arg_bytes = _local_bytes(args)
            in_storages = {id(_local(t).untyped_storage())
                           for t in _tensors(args)}
            for t in _tensors(args):
                counter.track(_local(t))
            with counter:
                outs = fn()
    trace_s = time.time() - t0
    alias, seen = 0, set()
    for t in _tensors(outs):
        st = _local(t).untyped_storage()
        if id(st) in in_storages and id(st) not in seen:
            seen.add(id(st))
            alias += st.nbytes()
    return {"argument_bytes": int(arg_bytes),
            "output_bytes": int(_local_bytes(outs)),
            "alias_bytes": int(alias), "trace_s": round(trace_s, 1)}


def _place(t, names, mesh):
    spec = SH._resolve(names, tuple(t.shape), SH.ACT_RULES, mesh)
    return CP.distribute_local(t, mesh, SH.placements(spec, mesh))


def _shard_cache(cache, cfg, mesh):
    """The decode cache's leaves laid out by ``model.cache_specs``."""
    specs = mdl.cache_specs(cfg)
    segs = []
    for slots, sslots in zip(cache["segments"], specs["segments"]):
        segs.append([{k: _place(v, sp[k], mesh) for k, v in e.items()}
                     for e, sp in zip(slots, sslots)])
    return {"segments": segs}


def run_cell(arch, shape, mesh_mode, force=False, out_dir=None):
    out_dir = pathlib.Path(out_dir or OUT_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = "multi" if mesh_mode == "multi" else "single"
    path = out_dir / f"{arch}__{shape}__{tag}.json"
    if path.exists() and not force:
        print(f"[skip cached] {path.name}")
        return json.loads(path.read_text())
    rec = lower_cell(arch, shape, multi_pod=(mesh_mode == "multi"))
    path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None,
                    help="directory for the JSON records (default "
                         "build/dryrun/)")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = (C.cells() if args.all
             else [(args.arch, args.shape)])
    failures = []
    for m in meshes:
        for arch, shape in cells:
            try:
                run_cell(arch, shape, m, force=args.force, out_dir=args.out)
            except Exception as e:  # noqa: BLE001 - report all failures
                traceback.print_exc()
                failures.append((arch, shape, m, str(e)[:200]))
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nAll requested dry-run cells traced.")


if __name__ == "__main__":
    main()
