"""The port's data pipeline and checkpoints against the reference's
(``tests/test_substrate.py`` case for case), and the new subpackages'
imports.

Batches: tokens and targets bit-equal to the reference's ``batch_at`` for
every seed, index and shard count tried.  The reference seeds a batch's
image prefix and conditioning with negative words that numpy refuses
(``ValueError``), so its pipeline cannot make a batch for paligemma-3b or
musicgen-large; the port draws them from non-negative keys
(``data/pipeline.py``), and their tokens are held to the reference's on
the same config without the prefix / conditioning.  Checkpoints restore
bit for bit.  The training launcher and the restart drill (its resumed
losses equal an uninterrupted run's bit for bit: the CPU step is
deterministic) are held in ``tests/test_torch_ckpt_restart.py``."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import repro.configs as RC
from repro.ckpt import checkpoint as rckpt
from repro.data import pipeline as RD
from repro.train import optim as RO
from repro.train import step as RS

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.pipeline import DataConfig, DataPipeline, batch_at
from repro_torch.train import optim as TO
from repro_torch.train import step as TS

CFG = TC.reduced("stablelm-12b")
ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["stablelm-12b", "qwen3-14b",
                                  "olmoe-1b-7b"])
@pytest.mark.parametrize("seed,index,num_shards",
                         [(0, 0, 1), (3, 5, 2), (7, 11, 4), (1, 2, 8)])
def test_batches_bit_equal_reference(name, seed, index, num_shards):
    dcfg = dict(seed=seed, global_batch=8, seq_len=24)
    for shard in range(num_shards):
        got = batch_at(DataConfig(**dcfg), TC.reduced(name), index, shard,
                       num_shards)
        want = RD.batch_at(RD.DataConfig(**dcfg), RC.reduced(name), index,
                           shard, num_shards)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", ["paligemma-3b", "musicgen-large"])
def test_prefix_and_cond_batches(name):
    dcfg = dict(seed=2, global_batch=4, seq_len=16)
    tcfg, rcfg = TC.reduced(name), RC.reduced(name)
    with pytest.raises(ValueError):
        RD.batch_at(RD.DataConfig(**dcfg), rcfg, 3)
    got = batch_at(DataConfig(**dcfg), tcfg, 3)
    plain = RD.batch_at(RD.DataConfig(**dcfg), dataclasses.replace(
        rcfg, prefix_len=0, cond_len=0), 3)
    np.testing.assert_array_equal(got["tokens"], plain["tokens"])
    p = tcfg.prefix_len
    if p:
        assert got["extra_embeds"].shape == (4, p, tcfg.d_model)
        assert (got["targets"][:, :p] == -1).all()
        np.testing.assert_array_equal(got["targets"][:, p:],
                                      plain["targets"])
    else:
        assert got["cond"].shape == (4, tcfg.cond_len, tcfg.cond_dim)
        np.testing.assert_array_equal(got["targets"], plain["targets"])
    extra = "extra_embeds" if p else "cond"
    again = batch_at(DataConfig(**dcfg), tcfg, 3)
    np.testing.assert_array_equal(got[extra], again[extra])
    other = batch_at(DataConfig(**dcfg), tcfg, 4)
    assert not np.array_equal(got[extra], other[extra])
    halves = [batch_at(DataConfig(**dcfg), tcfg, 3, s, 2) for s in (0, 1)]
    np.testing.assert_array_equal(
        np.concatenate([h["tokens"] for h in halves]), got["tokens"])


def test_data_deterministic_and_elastic():
    dcfg = DataConfig(seed=3, global_batch=8, seq_len=32)
    full = batch_at(dcfg, CFG, index=5)
    halves = [batch_at(dcfg, CFG, index=5, shard=s, num_shards=2)
              for s in (0, 1)]
    np.testing.assert_array_equal(
        full["tokens"], np.concatenate([h["tokens"] for h in halves]))
    np.testing.assert_array_equal(full["tokens"],
                                  batch_at(dcfg, CFG, index=5)["tokens"])


def test_data_targets_are_shifted():
    b = batch_at(DataConfig(seed=0, global_batch=2, seq_len=16), CFG, 0)
    np.testing.assert_array_equal(b["targets"][:, :-1], b["tokens"][:, 1:])
    assert (b["targets"][:, -1] == -1).all()


def test_pipeline_prefetch_matches_pure():
    dcfg = DataConfig(seed=1, global_batch=2, seq_len=16, prefetch=2)
    pipe = DataPipeline(dcfg, CFG, start_index=4)
    try:
        got = [next(pipe) for _ in range(3)]
    finally:
        pipe.close()
    pipe._thread.join(timeout=10)
    assert not pipe._thread.is_alive()
    for i, b in enumerate(got):
        for k, v in batch_at(dcfg, CFG, 4 + i).items():
            np.testing.assert_array_equal(b[k], v)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _leaves_equal(a, b):
    la, lb = ckpt._leaves(a), ckpt._leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.detach(), y.detach())


def _stepped(dtype, seed=0):
    ocfg = TO.OptConfig(state_dtype=dtype)
    state = TS.init_state(CFG, ocfg, seed=seed, device="cpu")
    batch = batch_at(DataConfig(seed=seed, global_batch=2, seq_len=8), CFG, 0)
    state, _ = TS.make_train_step(CFG, ocfg)(state, batch)
    return state, ocfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_checkpoint_roundtrip(tmp_path, dtype):
    """A stepped state in each precision (int8 ``QLeaf`` moments; bfloat16
    stored as its bits) restores bit for bit into a differently seeded
    template, on the template's device."""
    state, ocfg = _stepped(dtype)
    ckpt.save(tmp_path, 7, state)
    assert ckpt.latest_step(tmp_path) == 7
    manifest = json.loads((tmp_path / "step_0000000007" /
                           "manifest.json").read_text())
    assert manifest["num_leaves"] == len(ckpt._leaves(state))
    other = TS.init_state(CFG, ocfg, seed=1, device="cpu")
    restored = ckpt.restore(tmp_path, 7, other)
    _leaves_equal(state, restored)
    assert isinstance(restored["opt"]["m"]["tok"], TO.QLeaf) == \
        (dtype == "int8")


def test_checkpoint_gc_and_latest(tmp_path):
    state = {"a": torch.arange(4)}
    for s in (1, 2, 3, 4):
        ckpt.save(tmp_path, s, state, keep=2)
    steps = sorted(int(p.name.split("_")[1])
                   for p in pathlib.Path(tmp_path).glob("step_*"))
    assert steps == [3, 4]
    assert ckpt.latest_step(tmp_path) == 4
    # a save without its manifest (cut mid-write) does not count
    (tmp_path / "step_0000000009").mkdir()
    assert ckpt.latest_step(tmp_path) == 4


def test_checkpoint_structure_mismatch_raises(tmp_path):
    ckpt.save(tmp_path, 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="incompatible"):
        ckpt.restore(tmp_path, 1, {"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="incompatible"):
        ckpt.restore(tmp_path, 1, {"a": torch.zeros(4)})


def test_async_checkpointer_copies_before_the_step(tmp_path):
    """The saved values are the state's at ``save``, though the next step
    updates the state in place while the writer runs."""
    state, ocfg = _stepped("float32")
    before = {n: p.detach().clone()
              for n, p in state["params"].named_parameters()}
    saver = ckpt.AsyncCheckpointer(tmp_path)
    saver.save(1, state)
    batch = batch_at(DataConfig(seed=0, global_batch=2, seq_len=8), CFG, 1)
    state, _ = TS.make_train_step(CFG, ocfg)(state, batch)
    saver.wait()
    restored = ckpt.restore(tmp_path, 1,
                            TS.init_state(CFG, ocfg, device="cpu"))
    for n, p in restored["params"].named_parameters():
        assert torch.equal(p.detach(), before[n])
    assert int(restored["step"]) == 1


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_reference_checkpoint_loads_into_port(tmp_path, dtype):
    """A reference checkpoint (a stepped state, its own format) read back
    with the reference's ``restore`` and carried into the port through
    ``state_from_reference``: every leaf as the reference holds it."""
    rcfg = RC.reduced("stablelm-12b")
    rocfg = RO.OptConfig(state_dtype=dtype)
    rs, _ = RS.init_state(jax.random.PRNGKey(0), rcfg, rocfg)
    batch = {k: jnp.asarray(v) for k, v in RD.batch_at(
        RD.DataConfig(global_batch=2, seq_len=8), rcfg, 0).items()}
    rs, _ = jax.jit(RS.make_train_step(rcfg, rocfg))(rs, batch)
    rckpt.save(tmp_path, 1, rs)
    template, _ = RS.init_state(jax.random.PRNGKey(1), rcfg, rocfg)
    loaded = jax.tree.map(np.asarray, rckpt.restore(tmp_path, 1, template))
    ts = bridge.state_from_reference(loaded, CFG, device="cpu")
    want = bridge.state_from_reference(jax.tree.map(np.asarray, rs), CFG,
                                       device="cpu")
    _leaves_equal(ts, want)
    assert int(ts["step"]) == 1 and int(ts["opt"]["count"]) == 1
    p = ts["params"].segments[0][0].wq
    np.testing.assert_array_equal(
        p.detach().numpy().reshape(-1),
        np.asarray(rs["params"]["segments"][0][0]["attn"]["wq"]).reshape(-1))
    m = ts["opt"]["m"]["segments.0.0.wq"]
    rm = rs["opt"]["m"]["segments"][0][0]["attn"]["wq"]
    if dtype == "int8":
        np.testing.assert_array_equal(m.q.numpy(), np.asarray(rm.q))
    else:
        np.testing.assert_array_equal(m.numpy().reshape(-1),
                                      np.asarray(rm).reshape(-1))


# ---------------------------------------------------------------------------
# the training launcher's environment, and the new subpackages' imports
# ---------------------------------------------------------------------------


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_FAIL_AT_STEP", None)
    env.update(kw)
    return env


def test_new_subpackages_import_no_jax():
    """``repro_torch.{train,ckpt,data,distributed,launch}`` import neither
    JAX nor the reference package."""
    code = ("import sys\n"
            "import repro_torch.train.step, repro_torch.train.optim\n"
            "import repro_torch.ckpt.checkpoint, repro_torch.data.pipeline\n"
            "import repro_torch.distributed.collectives\n"
            "import repro_torch.launch.train, repro_torch.bridge\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
