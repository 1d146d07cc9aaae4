"""The port's serving loop against the JAX reference: the fully-paged
``ContinuousBatcher`` (macro and per-token) must emit the reference
batcher's greedy streams rid for rid under staggered admission, with
allclose merged page masses at every monitor feed; sampled streams must
agree across the port's own three paths (``generate``, per-token paged,
macro).  Also pins that running the port never imports JAX or the
reference.

Reduced qwen3-14b with GQA 4/2 and a 2-repeat segment, float32, on the
CPU (the kernel's plain version).  Mass tolerance: 1e-5 absolute."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax

import repro.configs as RC
from repro.memtier.tiering import SharedPagedPools as RPools
from repro.memtier.tiering import TierConfig as RTierConfig
from repro.memtier.tiering import TieringManager as RManager
from repro.core.cori import OnlineTuner as RTuner
from repro.models import model as RM
from repro.serve import sched as RS

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.core.cori import OnlineTuner as TTuner
from repro_torch.memtier.tiering import SharedPagedPools as TPools
from repro_torch.memtier.tiering import TierConfig as TTierConfig
from repro_torch.memtier.tiering import TieringManager as TManager
from repro_torch.serve import sched as TS
from repro_torch.serve.engine import generate as t_generate

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_LOGICAL, HBM, PAGE = 48, 10, 4
KW = dict(num_kv_heads=2, segments=((("attn",), 2),), dtype="float32")
PROMPT_LENS = (6, 9, 5, 11)
NEW = (6, 4, 9, 7)

_CACHE = {}


def _models():
    if not _CACHE:
        rcfg = dataclasses.replace(RC.reduced("qwen3-14b"), **KW)
        tcfg = dataclasses.replace(TC.reduced("qwen3-14b"), **KW)
        rp, _ = RM.init(jax.random.PRNGKey(0), rcfg)
        tp = bridge.from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                   device="cpu")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, rcfg.vocab_size, n).astype(np.int32)
                   for n in PROMPT_LENS]
        _CACHE.update(rcfg=rcfg, rp=rp, tcfg=tcfg, tp=tp, prompts=prompts)
    return _CACHE


def _stack(side):
    tier = dict(page_size=PAGE, hbm_pages=HBM, period_steps=2)
    tune = dict(default_period=2, profile_steps=8, trial_steps=4)
    if side == "ref":
        return RS.TrafficMonitor(RPools.create(N_LOGICAL, HBM),
                                 RManager(N_LOGICAL, RTierConfig(**tier)),
                                 RTuner(N_LOGICAL, **tune))
    return TS.TrafficMonitor(TPools.create(N_LOGICAL, HBM),
                             TManager(N_LOGICAL, TTierConfig(**tier)),
                             TTuner(N_LOGICAL, **tune))


def _record_merges(mon):
    seen = []
    merge = mon.merge

    def rec(contrib):
        out = merge(contrib)
        seen.append(out.copy())
        return out

    mon.merge = rec
    return seen


def _serve(side, macro, temps=(0.0, 0.0, 0.0, 0.0)):
    """Serve the four requests with two rows: two submitted up front,
    the others joining mid-flight (staggered, recycled rows)."""
    m = _models()
    mon = _stack(side)
    merges = _record_merges(mon)
    if side == "ref":
        b = RS.ContinuousBatcher(m["rp"], m["rcfg"], max_active=2,
                                 max_len=32, page_size=PAGE, monitor=mon,
                                 paged_impl="reference", macro=macro)
        mk = lambda i: RS.Request(rid=i, prompt=m["prompts"][i],
                                  max_new_tokens=NEW[i],
                                  key=jax.random.PRNGKey(0))
    else:
        b = TS.ContinuousBatcher(m["tp"], m["tcfg"], max_active=2,
                                 max_len=32, page_size=PAGE, monitor=mon,
                                 macro=macro, device="cpu")
        mk = lambda i: TS.Request(rid=i, prompt=m["prompts"][i],
                                  max_new_tokens=NEW[i],
                                  temperature=temps[i], seed=100 + i)
    b.submit(mk(0))
    b.submit(mk(1))
    for t in range(200):
        if t in (1, 3):
            b.submit(mk(2 if t == 1 else 3))
        b.step()
        if t > 3 and not b.queue and not b.active:
            break
    got = {r.rid: list(r.tokens) for r in b.completed}
    assert sorted(got) == [0, 1, 2, 3]
    assert mon.pools.free_pages == N_LOGICAL
    return got, merges, mon


@pytest.mark.parametrize("macro", [True, False])
def test_batcher_greedy_streams_match_reference(macro):
    ref, ref_m, ref_mon = _serve("ref", macro)
    port, port_m, port_mon = _serve("port", macro)
    assert port == ref
    assert len(port_m) == len(ref_m)
    for a, b in zip(port_m, ref_m):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert port_mon.manager.migrations == ref_mon.manager.migrations
    assert port_mon.tuner.history == ref_mon.tuner.history


def test_batcher_streams_match_generate():
    """Greedy rows equal ``generate``; a sampled row draws the same tokens
    on the per-token path, the macro path and ``generate``."""
    m = _models()
    temps = (0.0, 0.8, 0.0, 0.8)
    per_token, _, _ = _serve("port", False, temps)
    macro, _, _ = _serve("port", True, temps)
    assert per_token == macro
    for i, p in enumerate(m["prompts"]):
        ref = t_generate(m["tp"], m["tcfg"], p[None], steps=NEW[i],
                         temperature=temps[i], seed=100 + i,
                         device="cpu")[0].tolist()
        assert macro[i] == ref, i


def test_batcher_retires_on_eos():
    m = _models()
    prompt = m["prompts"][1]
    ref = t_generate(m["tp"], m["tcfg"], prompt[None], steps=8,
                     device="cpu")[0].tolist()
    mon = _stack("port")
    b = TS.ContinuousBatcher(m["tp"], m["tcfg"], max_active=2, max_len=32,
                             page_size=PAGE, monitor=mon, device="cpu")
    b.submit(TS.Request(rid=0, prompt=prompt, max_new_tokens=8,
                        eos_id=ref[3]))
    got = b.run()
    assert got[0] == ref[: ref.index(ref[3]) + 1]
    assert mon.pools.free_pages == N_LOGICAL


def test_batcher_path_imports_neither_jax_nor_reference():
    """A fresh interpreter running the port's serving path never loads
    JAX or the reference package."""
    code = (
        "import sys, dataclasses, numpy as np, torch\n"
        "import repro_torch.configs as C\n"
        "from repro_torch.models import model as M\n"
        "from repro_torch.memtier import SharedPagedPools, TierConfig, "
        "TieringManager\n"
        "from repro_torch.core.cori import OnlineTuner\n"
        "from repro_torch.serve.sched import ContinuousBatcher, Request, "
        "TrafficMonitor\n"
        "from repro_torch.serve.engine import generate\n"
        "cfg = C.reduced('qwen3-14b')\n"
        "p = M.init(cfg, device='cpu')\n"
        "mon = TrafficMonitor(SharedPagedPools.create(16, 8), "
        "TieringManager(16, TierConfig(page_size=4, hbm_pages=8)), "
        "OnlineTuner(16))\n"
        "b = ContinuousBatcher(p, cfg, monitor=mon, max_active=2, "
        "max_len=16, page_size=4, device='cpu')\n"
        "b.submit(Request(0, np.arange(5, dtype=np.int32), 4))\n"
        "out = b.run()\n"
        "assert len(out[0]) == 4\n"
        "generate(p, cfg, np.arange(5)[None], 3, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
