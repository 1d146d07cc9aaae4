"""The port's mesh step (``train.step.make_train_step(cfg, ocfg, mesh)``)
on gloo ranks on the CPU: each rank is a process of its own
(``test_torch_distributed._spawn``, a ``file://`` rendezvous, a timeout
on every spawn) holding a ``DeviceMesh`` from ``launch.mesh``.

  * reduced qwen3-14b on ("data", "model") = (2, 2): one step from the
    reference's initial state (``bridge.state_from_reference``) against
    the port's single-device step and the reference's own single-device
    step on the same batch; every rank's local shard shapes are
    ``param_spec``'s (folded for the fused projections);
  * reduced stablelm-12b on ("pod", "data", "model") = (2, 1, 2) with
    ``grad_compression``: the int8 pod step against the exact-DP step on
    the same mesh (the reference's ``test_pod_grad_compression_step_runs``),
    and the exact-DP step against the single-device step;
  * reduced olmoe-1b-7b with ``moe_impl="shard_map"`` on (2, 2): the
    expert-parallel MoE over data x model (``moe.moe_apply_shard_map``:
    tokens split over "data", experts over "model").  With
    ``capacity_factor=8`` (nothing dropped) against the reference's
    ``moe_apply_dense``, and its gradients against the port's dense route
    on one device; a ``"dense"`` MoE on the same mesh (replicated)
    against it too.  With ``capacity_factor=1`` (pairs dropped, the
    capacity taken from each data shard's token count) against the
    reference's ``moe_apply_shard_map`` on the same (2, 2) mesh and
    against a numpy oracle that drops, in each data shard, every
    expert's pairs past the capacity in (token, k) order;
  * ``python -m repro_torch.launch.train --device cpu --data-mesh 2
    --model-mesh 2``: trains, checkpoints, resumes, and the resumed run's
    losses equal an unbroken run's.

Bars (measured at these seeds on the CPU).  The mesh step against the
port's single-device step: loss 1e-6 relative, parameters 1e-4 (measured
1.6e-7 and 1.0e-5: float32 sums in another order, and the token table's
gradient summed a shard at a time in bfloat16 before the shards are
reduced, where one device sums every row in turn; one of 16384 table
elements, whose gradient is ~0, stepped 0.01 of a step apart).  Against
the reference's single-device step: loss 1e-6 relative and parameters
1e-4, tighter than the reference's own bars of 2e-3 and 3e-3 (measured 0
and 1.0e-5; AdamW's first step is ~lr * sign(g), so an element whose
gradient is ~0 in float32 could step either way, which is what the
reference's 3e-3 allows for).  Since that first step hardly depends on
the gradients' scale, the gradient norm is held too: 1e-4 relative
against both single-device steps, whose norms are equal (measured
5.1e-5: the token table's bfloat16 sums again, its gradient ~2e-3 apart
and most of the norm).  The pod step: parameters within the reference's
5e-3 of exact DP and loss 2e-3 relative (measured 1.0e-5 and 0); exact
DP against the single-device step: loss 1e-6 relative, parameters 1e-6
(measured 0 and 7.5e-9), gradient norm 1e-4 relative (measured 6.1e-5,
the same bfloat16 sums).  The MoE: outputs 2e-5 absolute and the aux
loss 1e-5 relative (the reference test's), gradients 1e-5 of each leaf's
largest magnitude; the dropping oracle's outputs 2e-5 absolute."""
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro_torch.configs as TC
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.train import optim as TO
from repro_torch.train import step as TS
from test_torch_distributed import SPAWN_TIMEOUT_S, _spawn

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = dict(seed=0, global_batch=4, seq_len=32)
POD_DATA = dict(seed=0, global_batch=8, seq_len=32)
OCFG = TO.OptConfig(lr=1e-3)


def _mesh(data, model, pod=1):
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(data, model, pod, device_type="cpu")


def _named(params):
    return {n: p for n, p in params.named_parameters()}


# ---------------------------------------------------------------------------
# FSDP/TP step: reduced qwen3-14b on (2, 2)
# ---------------------------------------------------------------------------


def _ref_state(tmp):
    """The reference's initial state and single-device step, written as
    the port's state (``torch.save``) and numpy results for the ranks."""
    import jax

    import repro.configs as RC
    from repro.train import optim as RO
    from repro.train import step as RS
    from repro_torch import bridge
    cfg = RC.reduced("qwen3-14b")
    ocfg = RO.OptConfig(lr=1e-3)
    st, _ = RS.init_state(jax.random.PRNGKey(0), cfg, ocfg)
    host = jax.tree.map(np.asarray, st)
    tcfg = TC.reduced("qwen3-14b")
    port = bridge.state_from_reference(host, tcfg, device="cpu")
    torch.save({"params": {n: p.detach() for n, p in
                           port["params"].named_parameters()}},
               tmp / "state.pt")
    batch = {k: jax.numpy.asarray(v)
             for k, v in batch_at(DataConfig(**DATA), tcfg, 0).items()}
    st1, m1 = jax.jit(RS.make_train_step(cfg, ocfg))(st, batch)
    want = bridge.from_reference(jax.tree.map(np.asarray, st1["params"]),
                                 tcfg, device="cpu")
    return tcfg, {n: p.detach().numpy() for n, p in
                  want.named_parameters()}, float(m1["loss"]), \
        float(m1["grad_norm"])


def _load_state(tmp, cfg):
    from repro_torch.models import model as mdl
    params = TS.trainable(mdl.Transformer(cfg, torch.device("cpu")))
    saved = torch.load(tmp / "state.pt")["params"]
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(saved[n])
    return params


def _mesh_worker(rank, world, tmp):
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as mdl
    cfg = TC.reduced("qwen3-14b")
    mesh = _mesh(2, 2)
    params = TS.shard_params(_load_state(tmp, cfg), mesh)
    specs, refs = mdl.param_specs(params), mdl.param_ref_shapes(params)
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for n, p in params.named_parameters():
        spec = SH.fold(SH.param_spec(specs[n], refs[n], mesh), refs[n],
                       tuple(p.shape))
        want = [d // (sizes[e] if isinstance(e, str) else 1)
                for d, e in zip(p.shape, spec)]
        assert list(p.to_local().shape) == want, (n, spec, coords)
    state = {"params": params, "opt": TO.init(params, OCFG),
             "step": torch.zeros((), dtype=torch.int32)}
    step = TS.make_train_step(cfg, OCFG, mesh,
                              param_specs=mdl.param_specs(params))
    state, m = step(state, batch_at(DataConfig(**DATA), cfg, 0))
    whole = TS.gather_state(state)
    out = {f"p.{n}": t.numpy() for n, t in whole["params"].items()}
    out.update(loss=m["loss"].numpy(), grad_norm=m["grad_norm"].numpy())
    return out


def test_mesh_step_matches_single_device(tmp_path):
    tcfg, ref_params, ref_loss, ref_norm = _ref_state(tmp_path)
    outs = _spawn("_mesh_worker", 4, tmp_path, module=__name__)
    # the port's single-device step from the same state
    params = _load_state(tmp_path, tcfg)
    state = {"params": params, "opt": TO.init(params, OCFG),
             "step": torch.zeros((), dtype=torch.int32)}
    state, m = TS.make_train_step(tcfg, OCFG)(
        state, batch_at(DataConfig(**DATA), tcfg, 0))
    single = {n: p.detach().numpy() for n, p in _named(params).items()}
    for o in outs:
        np.testing.assert_allclose(float(o["loss"]), float(m["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(o["loss"]), ref_loss, rtol=1e-6)
        np.testing.assert_allclose(float(o["grad_norm"]),
                                   float(m["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(o["grad_norm"]), ref_norm,
                                   rtol=1e-4)
        for n in single:
            np.testing.assert_allclose(o[f"p.{n}"], single[n], atol=1e-4,
                                       rtol=0, err_msg=n)
            np.testing.assert_allclose(o[f"p.{n}"], ref_params[n],
                                       atol=1e-4, rtol=0, err_msg=n)
        np.testing.assert_array_equal(o["loss"], outs[0]["loss"])


# ---------------------------------------------------------------------------
# the pod step: reduced stablelm-12b on (2, 1, 2)
# ---------------------------------------------------------------------------


def _pod_worker(rank, world, tmp):
    from repro_torch.models import model as mdl
    cfg = TC.reduced("stablelm-12b")
    mesh = _mesh(1, 2, pod=2)
    batch = batch_at(DataConfig(**POD_DATA), cfg, 0)
    out = {}
    for tag, gc in (("c", True), ("x", False)):
        state = TS.init_state(cfg, OCFG, device="cpu", mesh=mesh)
        step = TS.make_train_step(cfg, OCFG, mesh, grad_compression=gc,
                                  param_specs=mdl.param_specs(
                                      state["params"]))
        state, m = step(state, batch)
        whole = TS.gather_state(state)
        out.update({f"{tag}.{n}": t.numpy()
                    for n, t in whole["params"].items()})
        out[f"{tag}.loss"] = m["loss"].numpy()
        out[f"{tag}.norm"] = m["grad_norm"].numpy()
    return out


def test_pod_compressed_step_matches_exact_dp(tmp_path):
    outs = _spawn("_pod_worker", 4, tmp_path, module=__name__)
    names = [k[2:] for k in outs[0] if k.startswith("c.")
             and k not in ("c.loss", "c.norm")]
    # exact DP over (pod, data) computes the single-device step's function
    cfg = TC.reduced("stablelm-12b")
    state, m = TS.make_train_step(cfg, OCFG)(
        TS.init_state(cfg, OCFG, device="cpu"),
        batch_at(DataConfig(**POD_DATA), cfg, 0))
    single = {n: p.detach().numpy() for n, p in _named(
        state["params"]).items()}
    assert sorted(single) == sorted(names)
    for o in outs:
        np.testing.assert_allclose(float(o["x.loss"]), float(m["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(o["x.norm"]),
                                   float(m["grad_norm"]), rtol=1e-4)
        for n in names:
            np.testing.assert_allclose(o[f"x.{n}"], single[n], atol=1e-6,
                                       rtol=0, err_msg=n)
    for o in outs:
        np.testing.assert_allclose(float(o["c.loss"]), float(o["x.loss"]),
                                   rtol=2e-3)
        diff = max(float(np.abs(o[f"c.{n}"] - o[f"x.{n}"]).max())
                   for n in names)
        assert diff < 5e-3, diff
        for n in names:       # every rank ends on the same parameters
            np.testing.assert_array_equal(o[f"c.{n}"], outs[0][f"c.{n}"])


# ---------------------------------------------------------------------------
# expert parallelism over data x model: reduced olmoe-1b-7b on (2, 2)
# ---------------------------------------------------------------------------

MOE_BATCH = (8, 16)


def _moe_cfg(cf=8.0):
    c = TC.reduced("olmoe-1b-7b")
    return dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, capacity_factor=cf),
        moe_impl="shard_map")


def _moe_module(cfg, z):
    from repro_torch.models import moe as TMoE
    m = TMoE.MoE(cfg, 1, "cpu")
    with torch.no_grad():
        for n, t in m.named_parameters():
            t.copy_(torch.from_numpy(np.array(z[f"w.{n}"]))[None])
            t.requires_grad_(True)
    return m


def _ep_worker(rank, world, tmp, cf):
    from repro_torch.distributed import compat as CP
    from repro_torch.models import moe as TMoE
    z = np.load(tmp / "in.npz")
    cfg = _moe_cfg(cf)
    mesh = _mesh(2, 2)
    m = _moe_module(cfg, z)
    TS.shard_params(m, mesh)       # the experts over "model"
    with CP.implicit_replication():
        x = CP.distribute_local(torch.from_numpy(z["x"]), mesh,
                                [CP.Shard(0), CP.Replicate()])
        x.requires_grad_(True)
        y, aux = TMoE.moe_apply(m, 0, cfg, x, mesh=mesh)
        ct = CP.distribute_local(torch.from_numpy(z["ct"]), mesh,
                                 [CP.Shard(0), CP.Replicate()])
        (y * ct).sum().add(aux).backward()
        out = {"y": y.full_tensor().detach().numpy(),
               "aux": aux.full_tensor().detach().numpy(),
               "g.x": x.grad.full_tensor().numpy()}
        out.update({f"g.{n}": t.grad.full_tensor()[0].numpy()
                    for n, t in m.named_parameters()})
        # a "dense" MoE on the mesh: the single-device semantics on
        # replicated inputs
        yd, auxd = TMoE.moe_apply(m, 0, dataclasses.replace(
            cfg, moe_impl="dense"), x.detach(), mesh=mesh)
        out.update(y_dense=yd.full_tensor().detach().numpy(),
                   aux_dense=auxd.full_tensor().detach().numpy())
    return out


def _dropping_oracle(p, cfg, x, n_data):
    """(y, dropped [T, k]) of the expert-parallel MoE in numpy: the
    reference's routing, then in each of the ``n_data`` contiguous token
    shards every expert keeps its first ceil(T_local k / E * cf) pairs in
    (token, k) order and drops the rest."""
    import math

    import jax.numpy as jnp

    from repro.models import moe as RMoE
    mo = cfg.moe
    xt = x.reshape(-1, x.shape[-1])
    w, idx, _ = (np.asarray(a) for a in RMoE._route(
        jnp.asarray(xt), p["router"], mo.top_k))
    t = xt.shape[0] // n_data
    cap = max(1, math.ceil(t * mo.top_k / mo.num_experts
                           * mo.capacity_factor))
    dropped = np.zeros(idx.shape, bool)
    for shard in range(n_data):
        seen = np.zeros(mo.num_experts, int)
        for tok in range(shard * t, (shard + 1) * t):
            for j, e in enumerate(idx[tok]):
                dropped[tok, j] = seen[e] >= cap
                seen[e] += 1
    wg, wu, wo = (np.asarray(p[k], np.float64)
                  for k in ("wi_gate", "wi_up", "wo"))
    y = np.zeros(xt.shape, np.float64)
    for tok, j in zip(*np.nonzero(~dropped)):
        e, v = idx[tok, j], xt[tok].astype(np.float64)
        h = v @ wg[e]
        y[tok] += w[tok, j] * ((h / (1 + np.exp(-h))) * (v @ wu[e])) @ wo[e]
    return y.reshape(x.shape), dropped


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_expert_parallel_over_data_and_model(tmp_path, cf):
    import jax

    import repro.configs as RC
    from repro.models import moe as RMoE
    from test_torch_distributed_moe import _reference_shard_map
    rcfg = RC.reduced("olmoe-1b-7b")
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, capacity_factor=cf))
    p, _ = RMoE.moe_init(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(MOE_BATCH + (rcfg.d_model,)).astype(np.float32)
    ct = rng.standard_normal(MOE_BATCH + (rcfg.d_model,)).astype(np.float32)
    np.savez(tmp_path / "in.npz", x=x, ct=ct,
             **{f"w.{k}": np.asarray(v) for k, v in p.items()})
    y_ref, aux_ref = RMoE.moe_apply_dense(p, rcfg, x)
    outs = _spawn("_ep_worker", 4, tmp_path, module=__name__, cf=cf)
    if cf < 8:
        # pairs past each data shard's capacity are dropped
        y_drop, dropped = _dropping_oracle(p, rcfg, x, 2)
        assert dropped.any() and not dropped.all()
        ref = _reference_shard_map(tmp_path, "olmoe-1b-7b", cf, 4, data=2)
        np.testing.assert_allclose(ref["y"], y_drop, atol=2e-5, rtol=0)
        assert np.abs(ref["y"] - np.asarray(y_ref)).max() > 1e-2
        for o in outs:
            np.testing.assert_allclose(o["y"], ref["y"], atol=2e-5, rtol=0)
            np.testing.assert_allclose(o["y"], y_drop, atol=2e-5, rtol=0)
            np.testing.assert_allclose(float(o["aux"]), float(ref["aux"]),
                                       rtol=1e-5)
            # the dense route on the mesh drops nothing
            np.testing.assert_allclose(o["y_dense"], np.asarray(y_ref),
                                       atol=2e-5, rtol=0)
        return
    # the dense semantics' gradients on one device (the port's route)
    z = np.load(tmp_path / "in.npz")
    from repro_torch.models import moe as TMoE
    m = _moe_module(dataclasses.replace(_moe_cfg(), moe_impl="dense"), z)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = TMoE.moe_apply(m, 0, _moe_cfg(), xt)
    (y * torch.from_numpy(ct)).sum().add(aux).backward()
    want = {"g.x": xt.grad.numpy()}
    want.update({f"g.{n}": t.grad[0].numpy()
                 for n, t in m.named_parameters()})
    for o in outs:
        for y_key, aux_key in (("y", "aux"), ("y_dense", "aux_dense")):
            np.testing.assert_allclose(o[y_key], np.asarray(y_ref),
                                       atol=2e-5, rtol=0)
            np.testing.assert_allclose(float(o[aux_key]), float(aux_ref),
                                       rtol=1e-5)
        for k, g in want.items():
            np.testing.assert_allclose(o[k], g, rtol=0, atol=1e-5 * float(
                np.abs(g).max()), err_msg=k)


# ---------------------------------------------------------------------------
# the training driver on a (2, 2) mesh
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _train(tmp, steps, ckpt, tag):
    """``launch.train`` as 4 torchrun-style ranks; rank 0's metrics."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE="4")
    out = tmp / f"{tag}.json"
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen3-14b", "--reduced", "--device", "cpu", "--data-mesh", "2",
            "--model-mesh", "2", "--steps", str(steps), "--batch", "4",
            "--seq", "16", "--log-every", "1", "--metrics-out", str(out),
            "--ckpt-dir", str(ckpt), "--ckpt-every", "2"]
    procs = [subprocess.Popen(args, env=dict(env, RANK=str(r),
                                             LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    return json.loads(out.read_text())


def test_launch_train_mesh_checkpoints_and_resumes(tmp_path):
    whole = _train(tmp_path, 4, tmp_path / "a", "whole")
    first = _train(tmp_path, 2, tmp_path / "b", "first")
    resumed = _train(tmp_path, 4, tmp_path / "b", "resumed")
    assert whole["mesh"] == [2, 2] and whole["steps_run"] == 4
    assert first["steps_run"] == 2 and resumed["start"] == 2
    assert resumed["steps_run"] == 2
    # the checkpoint holds the whole state: the resumed steps repeat the
    # unbroken run's
    np.testing.assert_allclose(first["losses"] + resumed["losses"],
                               whole["losses"], rtol=1e-6)
    from repro_torch.ckpt import checkpoint as ckpt
    assert ckpt.latest_step(tmp_path / "b") == 4
