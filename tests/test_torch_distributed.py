"""The port's multi-rank code on the CPU over gloo: ``compressed_psum`` /
``compressed_psum_ef`` against the collective's numpy definition (the
reference's own tests of them, ``tests/test_distributed.py``, fail on this
JAX version since the repo began: its shim targets jax 0.4), and the pod
step (int8-compressed gradients across 2 ranks, on a (2, 1, 1) ("pod",
"data", "model") mesh) against the single-device step, as
``test_pod_grad_compression_step_runs`` does.

Each rank is a process of its own (``_spawn``: ``torch.distributed`` over
gloo, a ``file://`` rendezvous in the test's directory), waited for with a
timeout; the ranks write their results to files the test reads.

Tolerances: the collective equals its numpy definition bit for bit (the
same float32 operations; an exact int32 sum), and the reference's bounds
hold (the mean within max|x| / 127, the residual too).  The pod step's
compressed gradients equal the numpy definition over the two halves'
gradients bit for bit, its parameters equal an ``optim.update`` with
those gradients bit for bit, its gradient norm is theirs within 1e-6
relative, and against the single-device step on the
whole batch the loss agrees within 1e-6 relative and the parameters
within the reference's 5e-3."""
import json
import os
import pathlib
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

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 240


def _spawn(worker: str, world: int, tmp: pathlib.Path, module=__name__,
           **kw):
    """Run ``worker`` (a function of test module ``module``: (rank, world,
    tmp, **kw) -> {name: array}) on ``world`` gloo ranks, each a process
    of its own, and return each rank's arrays; fail if a rank fails or the
    ranks outlast ``SPAWN_TIMEOUT_S``."""
    tests = str(pathlib.Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), tests]), OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        code = (f"import {__name__} as T\n"
                f"T._run_rank({module!r}, {worker!r}, {rank}, {world}, "
                f"{str(tmp)!r}, {json.dumps(kw)!r})\n")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=SPAWN_TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out}"
    return [dict(np.load(tmp / f"out_{r}.npz")) for r in range(world)]


def _run_rank(module, worker, rank, world, tmp, kw):
    import importlib

    import torch.distributed as dist
    torch.set_num_threads(1)
    fn = getattr(importlib.import_module(module), worker)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, pathlib.Path(tmp), **json.loads(kw))
        np.savez(pathlib.Path(tmp) / f"out_{rank}.npz", **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# compressed_psum / compressed_psum_ef
# ---------------------------------------------------------------------------


def _psum_worker(rank, world, tmp):
    from repro_torch.distributed.collectives import (compressed_psum,
                                                     compressed_psum_ef)
    x = torch.from_numpy(np.load(tmp / "x.npy")[rank])
    ef = torch.from_numpy(np.load(tmp / "ef.npy")[rank])
    y = compressed_psum(x, None)
    y2, ef2 = compressed_psum_ef(x, ef, None)
    return {"y": y.numpy(), "y2": y2.numpy(), "ef2": ef2.numpy()}


def _numpy_psum(xs):
    """The collective's definition: a scale agreed by the max, int8
    codes, their exact int32 sum, the mean."""
    n = xs.shape[0]
    gmax = np.abs(xs).max()
    scale = np.maximum(gmax / np.float32(127.0), np.float32(1e-12))
    q = np.clip(np.round(xs / scale), -127, 127).astype(np.int8)
    total = q.astype(np.int32).sum(axis=0).astype(np.float32)
    return total * scale / np.float32(n), q, scale


@pytest.mark.parametrize("world", [1, 4])
def test_compressed_psum_numerics(tmp_path, world):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((world, 64)).astype(np.float32)
    ef = (rng.standard_normal((world, 64)) * 0.01).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "ef.npy", ef)
    outs = _spawn("_psum_worker", world, tmp_path)
    if world == 1:
        np.testing.assert_array_equal(outs[0]["y"], x[0])
        np.testing.assert_array_equal(outs[0]["y2"], x[0])
        np.testing.assert_array_equal(outs[0]["ef2"], ef[0])
        return
    want, _, _ = _numpy_psum(x)
    xf = x + ef
    want2, q2, scale2 = _numpy_psum(xf)
    bound = np.abs(x).max() / 127 + 1e-6
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["y"], want)
        np.testing.assert_array_equal(o["y2"], want2)
        np.testing.assert_array_equal(
            o["ef2"], xf[r] - q2[r].astype(np.float32) * scale2)
        # the reference test's bounds
        assert np.abs(o["y"] - x.mean(axis=0)).max() <= bound
        assert np.abs(o["ef2"]).max() <= np.abs(xf).max() / 127 + 1e-6


# ---------------------------------------------------------------------------
# the pod step
# ---------------------------------------------------------------------------

POD_CFG = "stablelm-12b"
POD_DATA = dict(seed=0, global_batch=8, seq_len=32)


def _pod_state():
    cfg = TC.reduced(POD_CFG)
    return cfg, TS.init_state(cfg, TO.OptConfig(lr=1e-3), device="cpu")


def _pod_worker(rank, world, tmp):
    import torch.distributed as dist
    from repro_torch.distributed.collectives import compressed_psum
    cfg, state = _pod_state()
    batch = batch_at(DataConfig(**POD_DATA), cfg, 0)
    half = TS.to_device({k: v[rank * 4:(rank + 1) * 4]
                         for k, v in batch.items()}, "cpu")
    grads, _ = TS._grads(state["params"], cfg, half, 1, False)
    out = {f"cg.{n}": compressed_psum(g, dist.group.WORLD).numpy()
           for n, g in grads.items()}
    # the pod group is a (pod, 1, 1) mesh
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, 1, world, device_type="cpu")
    state = TS.init_state(cfg, TO.OptConfig(lr=1e-3), device="cpu",
                          mesh=mesh)
    step = TS.make_train_step(cfg, TO.OptConfig(lr=1e-3), mesh,
                              grad_compression=True)
    state, m = step(state, batch)
    out.update({f"p.{n}": p.numpy()
                for n, p in TS.gather_state(state)["params"].items()})
    out.update(loss=m["loss"].numpy(), grad_norm=m["grad_norm"].numpy())
    return out


def test_pod_step_matches_single_device(tmp_path):
    outs = _spawn("_pod_worker", 2, tmp_path)
    cfg, state = _pod_state()
    names = [n for n, _ in state["params"].named_parameters()]
    batch = TS.to_device(batch_at(DataConfig(**POD_DATA), cfg, 0), "cpu")
    halves = [TS._grads(state["params"], cfg,
                        {k: v[r * 4:(r + 1) * 4] for k, v in batch.items()},
                        1, False)[0] for r in range(2)]
    want = {n: _numpy_psum(np.stack([h[n].numpy() for h in halves]))[0]
            for n in names}
    for o in outs:
        for n in names:
            np.testing.assert_array_equal(o[f"cg.{n}"], want[n])
    # every rank applies the same update: the compressed gradients' step
    replay = TS.init_state(cfg, TO.OptConfig(lr=1e-3), device="cpu")
    TO.update({n: torch.from_numpy(want[n]) for n in names}, replay["opt"],
              replay["params"], TO.OptConfig(lr=1e-3))
    for n, p in replay["params"].named_parameters():
        for o in outs:
            np.testing.assert_array_equal(o[f"p.{n}"], p.detach().numpy())
    # the step's gradient norm is the compressed gradients'
    norm = float(TO.global_norm({n: torch.from_numpy(want[n])
                                 for n in names}))
    for o in outs:
        np.testing.assert_allclose(float(o["grad_norm"]), norm, rtol=1e-6)
    # against the single-device step on the whole batch
    single, m = TS.make_train_step(cfg, TO.OptConfig(lr=1e-3))(
        state, batch_at(DataConfig(**POD_DATA), cfg, 0))
    for o in outs:
        np.testing.assert_allclose(float(o["loss"]), float(m["loss"]),
                                   rtol=1e-6)
        for n, p in single["params"].named_parameters():
            assert np.abs(o[f"p.{n}"] - p.detach().numpy()).max() < 5e-3
