"""The port's recurrent cells and state pages against the JAX reference.

Reduced ``recurrentgemma-2b`` (RG-LRU cells, lru_width 64) and reduced
``xlstm-1.3b`` (mLSTM with dm 128 over 4 heads of 32, sLSTM over 4 heads
of 16), float32, with the reference's parameters carried over through
``repro_torch.bridge``:

  * ``pack_state`` bit-equal to the reference's (the pages' bytes, leaf
    order included), ``unpack_state`` its exact inverse, ``state_dim``,
    the zero states and ``write_state_pages`` as the reference's;
  * the paging predicates of every registered config and the full
    configs' state pages.

Each cell's sequence and one-token forms against the reference's are
held in ``tests/test_torch_recurrent_cells.py``, and the models' seeded
init, dense decode from an empty cache and a demoted state page fetched
back from the host tier in ``tests/test_torch_recurrent_model.py``, on
this file's cells and models.

The reference initialises every cell's conv taps to zero
(``repro/models/recurrent.py:62``, ``:181``, ``:277``), and with them all
three cells output exactly zero and keep zero ``h``, ``C`` and ``c``:
only the conv input buffer carries data, so an init-only comparison
would hold an identity on the residual stream and none of the cells'
arithmetic.  ``test_zero_conv_taps_make_every_cell_an_identity`` pins
that finding; every other test draws the taps from N(0, 0.5) in numpy
from a seed and sets them in the reference's parameters before the
bridge.  Tolerances: 1e-5 absolute on cell outputs and states, 1e-4 on
logits (float32, different reduction orders; the RG-LRU's scan runs its
products in another tree than ``lax.associative_scan``)."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import repro.configs as RC
from repro.memtier import tiering as RT
from repro.models import model as RM
from repro.models import recurrent as RR

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.memtier import tiering as TT
from repro_torch.models import model as TM
from repro_torch.models import recurrent as TR
from repro_torch.models.config import parse_kind

TOL, LOGIT_TOL = 1e-5, 1e-4
# float32 relative term: two frameworks' summation orders on different CPUs
F32_RTOL = 4e-6
CONV_STD = 0.5
ARCHS = ["recurrentgemma-2b", "xlstm-1.3b"]
# (arch, segment, slot) of each cell kind in the reduced configs
CELLS = {"rglru": ("recurrentgemma-2b", 0, 0), "mlstm": ("xlstm-1.3b", 0, 0),
         "slstm": ("xlstm-1.3b", 0, 7)}
REF_FNS = {"rglru": (RR.rglru_apply, RR.rglru_step, RR.rglru_zero_state),
           "mlstm": (RR.mlstm_apply, RR.mlstm_step, RR.mlstm_zero_state),
           "slstm": (RR.slstm_apply, RR.slstm_step, RR.slstm_zero_state)}

_CACHE = {}


def _models(arch, perturbed=True):
    """(reference cfg, reference numpy params, port cfg, port params)."""
    key = (arch, perturbed)
    if key not in _CACHE:
        rcfg = dataclasses.replace(RC.reduced(arch), dtype="float32")
        tcfg = dataclasses.replace(TC.reduced(arch), dtype="float32")
        rp = jax.tree.map(np.asarray, RM.init(jax.random.PRNGKey(0),
                                              rcfg)[0])
        if perturbed:
            rng = np.random.default_rng(7)
            for seg in rp["segments"]:
                for slot in seg:
                    if "cell" in slot:
                        slot["cell"]["conv"] = rng.normal(
                            0.0, CONV_STD, slot["cell"]["conv"].shape) \
                            .astype(np.float32)
        _CACHE[key] = (rcfg, rp, tcfg,
                       bridge.from_reference(rp, tcfg, device="cpu"))
    return _CACHE[key]


def _cell(kind, perturbed=True):
    """(ref cfg, ref cell params at repeat 0, port cfg, port Cell)."""
    arch, si, j = CELLS[kind]
    rcfg, rp, tcfg, tp = _models(arch, perturbed)
    ref = jax.tree.map(lambda a: jnp.asarray(a[0]),
                       rp["segments"][si][j]["cell"])
    return rcfg, ref, tcfg, tp.segments[si][j].cell


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _to_torch(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def _close_state(t, r, tol=TOL):
    assert sorted(t) == sorted(r)
    for k in r:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(r[k]), atol=tol,
                                   rtol=F32_RTOL, err_msg=k)


def _close(t, r, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(r), atol=tol,
                               rtol=F32_RTOL)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_zero_conv_taps_make_every_cell_an_identity(kind):
    """At the reference's own init (conv taps zero) a cell outputs exactly
    zero and its recurrent state stays exactly zero, in both packages;
    with the taps drawn from N(0, 0.5) neither holds -- which is why the
    other tests perturb them."""
    apply = REF_FNS[kind][0]
    for perturbed in (False, True):
        rcfg, ref, tcfg, cell = _cell(kind, perturbed)
        x = _x(rcfg, 2, 6, seed=1)
        ry, rst = apply(ref, rcfg, jnp.asarray(x))
        ty, tst = TR.apply(cell, 0, tcfg, torch.from_numpy(x))
        inner = {k: v for k, v in tst.items()
                 if k in ("h", "C", "c")}
        if perturbed:
            assert float(np.abs(np.asarray(ry)).max()) > 0.1
            assert float(ty.abs().max()) > 0.1
            assert all(float(v.abs().max()) > 0 for v in inner.values())
        else:
            assert float(np.abs(np.asarray(ry)).max()) == 0.0
            assert float(ty.abs().max()) == 0.0
            assert all(float(np.abs(np.asarray(rst[k])).max()) == 0.0
                       for k in inner)
            assert all(float(v.abs().max()) == 0.0 for v in inner.values())
        # the conv input buffer carries the inputs either way
        assert float(tst["conv"].abs().max()) > 0


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_zero_state_matches_reference(kind):
    rcfg, _, tcfg, _ = _cell(kind)
    ref = REF_FNS[kind][2](rcfg, 3)
    got = TR.zero_state(tcfg, parse_kind(kind), 3)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_pack_state_is_the_reference_bytes(kind):
    """``pack_state`` bit-equal to the reference's on a carried state, its
    leaves in ``jax.tree.leaves`` order (sorted keys); ``unpack_state``
    returns every leaf bit for bit; ``state_dim`` is the reference's."""
    apply = REF_FNS[kind][0]
    rcfg, ref, tcfg, _ = _cell(kind)
    _, rst = apply(ref, rcfg, jnp.asarray(_x(rcfg, 2, 5, seed=4)))
    order = [p[0].key for p, _ in jax.tree_util.tree_flatten_with_path(rst)[0]]
    assert order == sorted(rst)
    want = np.asarray(RM.pack_state(rst))
    tst = _to_torch(rst)
    flat = TM.pack_state(tst)
    assert flat.dtype == torch.float32
    np.testing.assert_array_equal(flat.numpy().view(np.uint32),
                                  want.view(np.uint32))
    back = TM.unpack_state(flat, TR.zero_state(tcfg, parse_kind(kind), 1,
                                               "meta"))
    assert sorted(back) == sorted(tst)
    for k in tst:
        assert torch.equal(back[k], tst[k]), k
    kind_ = parse_kind(kind)
    assert TM.state_dim(tcfg, kind_) == RM.state_dim(rcfg, kind_) \
        == flat.shape[1]


def test_write_state_pages_matches_reference():
    """One joiner dropped (``PAGE_DROP``), a layer without a state leaf:
    both tiers as the reference's."""
    rng = np.random.default_rng(5)
    r, dim, n_logical, hbm = 2, 7, 6, 4
    host = rng.standard_normal((r, n_logical, dim)).astype(np.float32)
    dev = rng.standard_normal((r, hbm, dim)).astype(np.float32)
    states = rng.standard_normal((r, 3, dim)).astype(np.float32)
    gids = np.asarray([4, RT.PAGE_DROP, 1], np.int32)
    slots = np.asarray([2, RT.PAGE_DROP, 0], np.int32)
    ref = RT.write_state_pages(
        {"state_host": [jnp.asarray(host), None],
         "state_hbm": [jnp.asarray(dev), None]},
        [jnp.asarray(states), None], jnp.asarray(gids), jnp.asarray(slots))
    kv = {"state_host": [torch.from_numpy(host.copy()), None],
          "state_hbm": [torch.from_numpy(dev.copy()), None]}
    TT.write_state_pages(kv, [torch.from_numpy(states), None], gids, slots)
    for k in kv:
        np.testing.assert_array_equal(kv[k][0].numpy(), np.asarray(ref[k][0]))
    assert kv["state_host"][1] is None


# ---------------------------------------------------------------------------
# configs, init and paging predicates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", RC.ARCHS)
def test_paging_predicates_match_reference(arch):
    """``has_state_pages``, ``has_attention`` and
    ``batched_prefill_supported`` of every registered config."""
    rcfg, tcfg = RC.reduced(arch), TC.reduced(arch)
    for name in ("has_state_pages", "has_attention",
                 "batched_prefill_supported"):
        assert getattr(TM, name)(tcfg) == getattr(RM, name)(rcfg), name


def test_full_configs_state_pages():
    """The full configs' leaf specs equal the reference's: an RG-LRU state
    page of 3 x 2560 + 2560 floats, an mLSTM one of C [4, 1024, 1024] and
    more (16.84 MB), xlstm-1.3b's page over its 48 layers ~707 MB."""
    for arch in ARCHS:
        tcfg, rcfg = TC.get(arch), RC.get(arch)
        assert TM.slot_leaf_specs(tcfg, 16) == [
            (r, {k: tuple(v) for k, v in lv.items()})
            for r, lv in RM.slot_leaf_specs(rcfg, 16)]
    g = TC.get("recurrentgemma-2b")
    assert TM.state_dim(g, parse_kind("rglru")) == 4 * 2560
    assert (g.num_layers, g.window_size, g.num_heads, g.num_kv_heads,
            g.head_dim) == (26, 2048, 10, 1, 256)
    x = TC.get("xlstm-1.3b")
    mdim = TM.state_dim(x, parse_kind("mlstm"))
    assert mdim == 4 * 1024 * 1024 + 3 * 4096 + 4 + 4 * 1024
    page = sum(r * lv["state"][0] * 4 for r, lv in TM.slot_leaf_specs(x, 16))
    assert 700e6 < page < 710e6, page
