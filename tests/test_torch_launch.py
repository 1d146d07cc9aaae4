"""The port's launch layer against the reference's (the counterpart of
``tests/test_launch.py``): the dry-run's collective counter on known
redistributions over a small fake mesh (hand-counted bytes, each of the
five kinds), the cells' meta-tensor inputs against the reference's
``ShapeDtypeStruct``s, the cell table, the mesh builders, the training
overrides, and a reduced cell's dry-run whose ``argument_bytes`` are the
local shard bytes reckoned by hand from ``param_spec``.

The fake process group lives in this process (one rank standing for
all); the module's fixture tears it down.  Exact equality throughout."""
import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch
import torch.distributed as dist

import repro.configs as RC
from repro.launch import dryrun as RD
from repro.launch import specs as RSP

import repro_torch.configs as TC
from repro_torch.distributed import compat as CP
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as LM
from repro_torch.launch import specs as SP
from repro_torch.models import model as TM


@pytest.fixture(autouse=True, scope="module")
def _fake_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def test_collective_counter_five_kinds():
    """Each redistribution's collective and its output bytes, on a (2, 2)
    mesh of float32 [8, 4] / [4, 4] tensors (rank 0's view)."""
    m = D.fake_mesh((2, 2), ("data", "model"))
    c = D.StepCounter()
    rep = [CP.Replicate(), CP.Replicate()]
    with D._card_collectives(), c:
        x = CP.distribute_local(_meta(8, 4), m, [CP.Shard(0), CP.Replicate()])
        x.redistribute(m, rep)                       # gather [8, 4]
        p = CP.DTensor.from_local(_meta(4, 4), m,
                                  [CP.Partial(), CP.Replicate()])
        p.redistribute(m, rep)                       # sum [4, 4]
        p.redistribute(m, [CP.Shard(0), CP.Replicate()])   # -> [2, 4]
        x.redistribute(m, [CP.Shard(1), CP.Replicate()])   # -> [8, 2]
        dist.recv(torch.empty(16), 1)                # point to point
    assert c.records == [("all-gather", 8 * 4 * 4), ("all-reduce", 4 * 4 * 4),
                         ("reduce-scatter", 2 * 4 * 4),
                         ("all-to-all", 8 * 2 * 4),
                         ("collective-permute", 16 * 4)]
    assert D.collective_bytes(c.records) == {
        "all-reduce": 64, "all-gather": 128, "reduce-scatter": 32,
        "all-to-all": 64, "collective-permute": 64}
    assert D.collective_bytes([]) == {k: 0 for k in (
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute")}


def _tdt(t):
    return str(t.dtype).removeprefix("torch.")


def test_input_specs_all_cells():
    """``batch_specs`` / ``decode_specs`` of every cell: the reference's
    shapes and dtypes leaf for leaf, nothing allocated."""
    for arch, shape in RC.cells():
        rc, tc = RSP.cell(arch, shape), SP.cell(arch, shape)
        assert (tc.step_kind, tc.seq_len, tc.global_batch) == (
            rc.step_kind, rc.seq_len, rc.global_batch)
        if rc.step_kind in ("train", "prefill"):
            want, got = RSP.batch_specs(rc), SP.batch_specs(tc)
            assert sorted(got) == sorted(want)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape), k
                assert _tdt(got[k]) == str(want[k].dtype), k
                assert got[k].is_meta
        else:
            want, got = RSP.decode_specs(rc), SP.decode_specs(tc)
            assert sorted(got) == sorted(want)
            wl, gl = jax.tree.leaves(want), jax.tree.leaves(got)
            assert len(gl) == len(wl), (arch, shape)
            for g, w in zip(gl, wl):
                assert tuple(g.shape) == tuple(w.shape), (arch, shape)
                assert _tdt(g) == str(w.dtype), (arch, shape)
                assert g.is_meta


def test_cell_table_is_the_assignment():
    assert TC.cells(include_skipped=True) == RC.cells(include_skipped=True)
    cells = TC.cells(include_skipped=True)
    assert len(cells) == len(TC.ARCHS) * len(TC.SHAPES)
    skipped = {(a, s) for a, s, sk in cells if sk}
    assert all(s == "long_500k" for _, s in skipped)
    assert len(skipped) == sum(not TC.get(a).supports_long_context
                               for a in TC.ARCHS)


def test_host_mesh_shapes():
    assert LM.production_shape() == ((16, 16), ("data", "model"))
    assert LM.production_shape(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))
    D.fake_mesh((1,), ("x",))                          # a group of 1
    m = LM.make_host_mesh(data=1, model=1, device_type="cpu")
    assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (1, 1)
    with pytest.raises(ValueError, match="4 ranks"):
        LM.make_host_mesh(data=2, model=2, device_type="cpu")
    D.fake_mesh((4,), ("x",))                          # a group of 4
    m = LM.make_host_mesh(data=2, model=2, device_type="cpu")
    assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (2, 2)
    m = LM.make_host_mesh(data=1, model=2, pod=2, device_type="cpu")
    assert m.mesh_dim_names == ("pod", "data", "model")
    assert tuple(m.shape) == (2, 1, 2)


def test_train_overrides_are_the_reference():
    assert D.TRAIN_OVERRIDES == RD.TRAIN_OVERRIDES
    assert D.TRAIN_OVERRIDES["nemotron-4-340b"]["state_dtype"] == "bfloat16"
    assert D.TRAIN_OVERRIDES["deepseek-v3-671b"]["accum"] >= 4
    assert D.TARGET_HBM_BYTES == 80 * 10 ** 9


def _local_numel(shape, spec, sizes):
    """Rank 0's shard size: each named dim split (ceil) over its axes."""
    n = 1
    for dim, e in zip(shape, spec):
        k = math.prod(sizes[a] for a in ((e,) if isinstance(e, str)
                                         else (e or ())))
        n *= -(-dim // k)
    return n


def test_reduced_train_dryrun_argument_bytes():
    """A reduced qwen3-14b train cell on a (2, 2) mesh: the argument
    bytes are rank 0's shards of the parameters and both float32
    moments (``fold(param_spec(...))``), the two int32 counts and the
    global int32 batch (every rank is handed the whole batch); the record
    carries every reference key."""
    cfg = TC.reduced("qwen3-14b")
    c = SP.Cell("qwen3-14b", "reduced", cfg, "train", 32, 8)
    rec = D.lower_cell("qwen3-14b", "reduced", cell=c, verbose=False,
                       mesh_shape=((2, 2), ("data", "model")))
    meta = TM.Transformer(cfg, torch.device("meta"))
    specs, refs = TM.param_specs(meta), TM.param_ref_shapes(meta)
    sizes = {"data": 2, "model": 2}
    mesh = D.fake_mesh((2, 2), ("data", "model"))
    local = 0
    for n, t in meta.named_parameters():
        spec = SH.fold(SH.param_spec(specs[n], refs[n], mesh), refs[n],
                       tuple(t.shape))
        local += _local_numel(t.shape, spec, sizes) * 4
    batch = 2 * 8 * 32 * 4                       # tokens, targets int32
    assert rec["argument_bytes"] == 3 * local + 4 + 4 + batch
    for k in ("flops", "argument_bytes", "temp_bytes", "output_bytes",
              "peak_bytes_per_device", "collective_bytes",
              "collective_bytes_total", "model_params", "active_params",
              "tokens_per_step"):
        assert k in rec, k
    assert rec["flops"] > 0 and rec["collective_bytes_total"] > 0
    assert rec["peak_bytes_per_device"] >= rec["argument_bytes"]
    assert rec["tokens_per_step"] == 8 * 32
    assert rec["alias_bytes"] >= local            # parameters in place
    assert rec["fits"] and rec["target_device"] == D.TARGET_DEVICE


@pytest.mark.parametrize("arch,kind", [("deepseek-v3-671b", "decode"),
                                       ("gemma3-12b", "prefill")])
def test_reduced_dryrun_prefill_and_decode(arch, kind):
    """The serving cells trace too: a MoE + MLA decode (expert-parallel,
    the cache over batch x kv_seq) and a sliding-window prefill."""
    cfg = dataclasses.replace(TC.reduced(arch), moe_impl="shard_map") \
        if TC.reduced(arch).moe else TC.reduced(arch)
    c = SP.Cell(arch, "reduced", cfg, kind, 32, 8)
    rec = D.lower_cell(arch, "reduced", cell=c, verbose=False,
                       mesh_shape=((2, 2), ("data", "model")))
    assert rec["step_kind"] == kind and rec["flops"] > 0
    assert rec["tokens_per_step"] == (8 if kind == "decode" else 8 * 32)
    assert rec["peak_bytes_per_device"] >= rec["argument_bytes"] > 0


def test_mesh_modules_import_no_jax():
    """The new modules import neither JAX nor the reference package."""
    root = pathlib.Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "import repro_torch.distributed.sharding, "
            "repro_torch.distributed.compat\n"
            "import repro_torch.launch.mesh, repro_torch.launch.specs, "
            "repro_torch.launch.dryrun\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert r.returncode == 0, r.stderr
