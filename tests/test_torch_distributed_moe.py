"""The port's expert-parallel MoE (``models.moe.moe_apply_shard_map``) on
2 and 4 gloo ranks on the CPU, on a (1, n) ("data", "model") mesh (a
model-axis group), against the reference: with ``capacity_factor=8``
nothing is dropped and it must equal the reference's ``moe_apply_dense``
(as ``tests/test_distributed.py``'s
``test_moe_shard_map_matches_dense_oracle``); with a capacity of one
expert's fair share (``capacity_factor=1``) pairs are dropped and it must
equal the reference's ``moe_apply_shard_map`` on the same (1, n) mesh,
run in a subprocess with n forced host devices.  Both on the reference's
weights (``moe_init``), olmoe-1b-7b's reduced MoE and deepseek-v3-671b's
(a shared expert).

The backward without drops: each rank's local shard of an expert leaf
holds the dense gradients of its experts, and the whole gradients
(gathered) of every leaf and of x are the dense ones on every rank.

Tolerances: outputs 2e-5 absolute and the aux loss 1e-5 relative (the
reference test's); gradients 1e-5 of each leaf's largest magnitude
(float32 sums in other orders, a 4-way all-reduce among them)."""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

import repro.configs as RC
from repro.models import moe as RMoE

import repro_torch.configs as TC
from repro_torch.models import moe as TMoE
from test_torch_distributed import _spawn

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH = (8, 16)
Y_TOL, AUX_RTOL, GRAD_TOL = 2e-5, 1e-5, 1e-5
LEAVES = ("router", "wi_gate", "wi_up", "wo")


def _cfg(pkg, name, cf):
    c = pkg.reduced(name)
    return dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, capacity_factor=cf),
        moe_impl="shard_map")


def _weights(name):
    """The reference's MoE leaves (numpy) and a seeded input and
    cotangent."""
    p, _ = RMoE.moe_init(jax.random.PRNGKey(0), RC.reduced(name))
    w = {k: np.asarray(v) for k, v in p.items() if k != "shared"}
    w.update({f"shared.{k}": np.asarray(v)
              for k, v in p.get("shared", {}).items()})
    rng = np.random.default_rng(1)
    d = RC.reduced(name).d_model
    x = rng.standard_normal(BATCH + (d,)).astype(np.float32)
    ct = rng.standard_normal(BATCH + (d,)).astype(np.float32)
    return w, x, ct


def _moe(cfg, w):
    """The port's MoE module (one repeat) holding ``w``, gradients on."""
    m = TMoE.MoE(cfg, 1, "cpu")
    with torch.no_grad():
        for n, t in m.named_parameters():
            t.copy_(torch.from_numpy(np.array(w[n]))[None])
            t.requires_grad_(True)
    return m


def _grads(m, x, y, aux, ct):
    (y * ct).sum().add(aux).backward()
    out = {f"g.{n}": t.grad[0].numpy() for n, t in m.named_parameters()}
    out["g.x"] = x.grad.numpy()
    return out


def _ep_worker(rank, world, tmp, name, cf):
    from repro_torch.distributed import compat as CP
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import step as TS
    z = np.load(tmp / "in.npz")
    w = {k[2:]: z[k] for k in z.files if k.startswith("w.")}
    cfg = _cfg(TC, name, cf)
    mesh = make_host_mesh(1, world, device_type="cpu")
    m = TS.shard_params(_moe(cfg, w), mesh)     # the experts over "model"
    tok = [CP.Shard(0), CP.Replicate()]
    with CP.implicit_replication():
        x = CP.distribute_local(torch.from_numpy(z["x"]), mesh, tok)
        x.requires_grad_(True)
        y, aux = TMoE.moe_apply_shard_map(m, 0, cfg, x, mesh)
        y2, _ = TMoE.moe_apply(m, 0, cfg, x.detach(), mesh=mesh)
        ct = CP.distribute_local(torch.from_numpy(z["ct"]), mesh, tok)
        (y * ct).sum().add(aux).backward()
        out = {"y": y.full_tensor().detach().numpy(),
               "aux": aux.full_tensor().detach().numpy(),
               "y_via_apply": y2.full_tensor().detach().numpy(),
               "g.x": x.grad.full_tensor().numpy()}
        for n, t in m.named_parameters():
            out[f"g.{n}"] = t.grad.full_tensor()[0].numpy()
            out[f"local.{n}"] = t.grad.to_local()[0].numpy()
    return out


def _reference_shard_map(tmp, name, cf, world, data=1):
    """The reference's ``moe_apply_shard_map`` on a (data, world / data)
    ("data", "model") mesh of forced host devices, in a subprocess."""
    code = textwrap.dedent(f"""
        import dataclasses, jax, numpy as np
        import repro.configs as C
        from repro.models import moe as M
        c = C.reduced({name!r})
        cfg = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor={cf}))
        z = np.load({str(tmp / "in.npz")!r})
        p = {{k[2:]: z[k] for k in z.files
              if k.startswith("w.") and "." not in k[2:]}}
        sh = {{k[9:]: z[k] for k in z.files if k.startswith("w.shared.")}}
        if sh:
            p["shared"] = sh
        mesh = jax.make_mesh(({data}, {world // data}), ("data", "model"))
        with jax.set_mesh(mesh):
            y, aux = M.moe_apply_shard_map(p, cfg, z["x"], mesh)
        np.savez({str(tmp / "ref.npz")!r}, y=np.asarray(y),
                 aux=np.asarray(aux))
    """)
    env = {"XLA_FLAGS": f"--xla_force_host_platform_device_count={world}",
           "PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    return dict(np.load(tmp / "ref.npz"))


@pytest.mark.parametrize("name,world,cf", [
    ("olmoe-1b-7b", 2, 8.0), ("olmoe-1b-7b", 4, 8.0),
    ("deepseek-v3-671b", 2, 8.0), ("olmoe-1b-7b", 2, 1.0),
    ("olmoe-1b-7b", 4, 1.0), ("deepseek-v3-671b", 4, 1.0)])
def test_expert_parallel_matches_reference(tmp_path, name, world, cf):
    w, x, ct = _weights(name)
    np.savez(tmp_path / "in.npz", x=x, ct=ct,
             **{f"w.{k}": v for k, v in w.items()})
    outs = _spawn("_ep_worker", world, tmp_path, module=__name__, name=name,
                  cf=cf)
    rcfg = RC.reduced(name)
    y_dense, aux_dense = RMoE.moe_apply_dense(
        {**{k: v for k, v in w.items() if "." not in k},
         **({"shared": {k[7:]: v for k, v in w.items()
                        if k.startswith("shared.")}}
            if rcfg.moe.num_shared else {})}, rcfg, x)
    if cf >= 8:
        want_y, want_aux = np.asarray(y_dense), float(aux_dense)
    else:
        ref = _reference_shard_map(tmp_path, name, cf, world)
        want_y, want_aux = ref["y"], float(ref["aux"])
        # the capacity bound dropped pairs: the output is not the dense one
        assert np.abs(want_y - np.asarray(y_dense)).max() > 1e-2
    for o in outs:
        np.testing.assert_allclose(o["y"], want_y, atol=Y_TOL, rtol=0)
        np.testing.assert_array_equal(o["y_via_apply"], o["y"])
        np.testing.assert_allclose(float(o["aux"]), want_aux,
                                   rtol=AUX_RTOL)
    if cf < 8:
        return
    # the backward against the port's dense route (its expert loop)
    tcfg = _cfg(TC, name, cf)
    m = _moe(tcfg, w)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = TMoE.moe_apply(m, 0, tcfg, xt)
    want = _grads(m, xt, y, aux, torch.from_numpy(ct))
    e_local = tcfg.moe.num_experts // world
    for rank, o in enumerate(outs):
        for k, g in want.items():
            bar = GRAD_TOL * np.abs(g).max()
            assert np.abs(o[k] - g).max() <= bar, (rank, k)
            if k[2:] in LEAVES[1:]:           # this rank's experts only
                mine = g[rank * e_local:(rank + 1) * e_local]
                assert np.abs(o[f"local.{k[2:]}"] - mine).max() <= bar, \
                    (rank, k)
