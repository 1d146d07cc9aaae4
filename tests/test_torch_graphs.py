"""The port's one-sync decode macro on the CPU: the step body that the
CUDA graph captures reads nothing back to the host, the device-side
uniform is the numpy hash bit for bit, and the masked write-through into
the pools' sink pages leaves both tiers bit-identical to the
``torch.nonzero`` write it replaced (kept below as ``_nonzero_core``,
the port's earlier decode core).  Also the route rule: which configs
and devices take the graph, and that nothing falls back to the eager
route.

Reduced configs (GQA, sliding window, MLA + MoE, GQA + MoE, and the
recurrent
recurrentgemma-2b and xlstm-1.3b with their conv taps drawn from
N(0, 0.5), since the reference's zero taps make every cell an identity),
float32, on the CPU (the kernels' plain versions).  Pools compare with
``torch.equal``."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

torch.set_num_threads(1)

import repro_torch.configs as TC
from repro_torch.core.cori import OnlineTuner
from repro_torch.kernels import ops
from repro_torch.memtier.tiering import (SharedPagedPools, TierConfig,
                                         TieringManager)
from repro_torch.models import graphs
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.serve import sched as TS

PAGE, N_ROW, HBM, N_LOGICAL = 4, 5, 12, 20
ARCHS = {"gqa": "qwen3-14b", "window": "gemma3-12b", "mla": "deepseek-v3-671b",
         "rglru": "recurrentgemma-2b", "xlstm": "xlstm-1.3b",
         "olmoe": "olmoe-1b-7b"}
_CACHE = {}


def _model(kind):
    if kind not in _CACHE:
        cfg = dataclasses.replace(TC.reduced(ARCHS[kind]), dtype="float32")
        params = TM.init(cfg, seed=3, device="cpu")
        g = torch.Generator().manual_seed(5)
        for seg in params.segments:
            for slot in seg:
                if slot.kind.is_recurrent:
                    conv = slot.cell.conv
                    conv.copy_(0.5 * torch.randn(conv.shape, generator=g))
        _CACHE[kind] = (cfg, params)
    return _CACHE[kind]


def _pools(cfg, seed=1, hbm=HBM):
    """Sinked pools (``SharedPagedPools.attach_layered``) filled with
    seeded values, the sinks included (state pages in [0.5, 1.5), which
    keeps the sLSTM's normaliser clear of its floor)."""
    pools = SharedPagedPools.create(N_LOGICAL, hbm)
    pools.attach_layered(TM.slot_leaf_specs(cfg, PAGE), device="cpu")
    g = torch.Generator().manual_seed(seed)
    for key, leaves in pools.kv_with_sink.items():
        for t in leaves:
            if t is not None:
                draw = torch.randn(t.shape, generator=g)
                t.copy_(1.0 + draw.clamp(-0.5, 0.49)
                        if key.startswith("state") else draw)
    return pools


# the row tables every case starts from: rows 0, 1 and 3 own disjoint
# pages, row 2 holds none
TABLES = np.asarray([[3, 7, 1, -1, -1],
                     [0, 2, 5, 9, 11],
                     [-1, -1, -1, -1, -1],
                     [4, 6, 8, 10, -1]], np.int32)


def _case(name):
    """(tables, gid_tables, cur_pos) of a write-through case."""
    tables = TABLES.copy()
    gids = np.where(tables >= 0, tables + 5, -1).astype(np.int32)
    cur = np.asarray([9, 18, -1, 13], np.int64)
    if name == "hbm_unmapped":        # row 1's write page has no HBM slot
        tables[1, 4] = -1
    elif name == "host_unmapped":     # row 3's write page has no host page
        gids[3, 3] = -1
    elif name == "clamp_collides":
        # dead rows 0 and 2 whose clamped write (page 0 -> slot 0 / gid 5,
        # offset 0) is the slot, gid and offset live row 1 writes
        tables[2] = tables[1]
        gids[2] = gids[1]
        cur = np.asarray([-1, 0, -1, 13], np.int64)
        tables[0, 0], gids[0, 0] = tables[1, 0], gids[1, 0]
    elif name == "all_dead":
        cur = np.full((4,), -1, np.int64)
    return tables, gids, cur


def _nonzero_core(params, cfg, kv, tables, gid_tables, tokens, cur_pos, *,
                  page_size):
    """The port's earlier decode core, whose write-through picked the
    writing rows with two ``torch.nonzero`` (a host read each), over
    leaves without a sink."""
    b = tokens.shape[0]
    rows = torch.arange(b)
    active = cur_pos >= 0
    lengths = torch.where(active, cur_pos + 1, 0).to(torch.int32)
    safe_pos = cur_pos.clamp_min(0)
    pg, off = safe_pos // page_size, safe_pos % page_size
    wslot = tables[rows, pg].long()
    wgid = gid_tables[rows, pg].long()
    hbm_rows = torch.nonzero(active & (wslot >= 0)).squeeze(1)
    host_rows = torch.nonzero(active & (wgid >= 0)).squeeze(1)
    hbm_at = (wslot[hbm_rows], off[hbm_rows])
    host_at = (wgid[host_rows], off[host_rows])
    x = L.embed(params.tok, cfg, tokens)
    mass_sum = torch.zeros((b, tables.shape[1]))
    n_layers = 0
    for li, r, slot in TM._layers(params, cfg):
        names = TM.slot_leaf_names(slot.kind)
        hbm = [kv[f"{n}_hbm"][li][r] for n in names]
        host = [kv[f"{n}_host"][li][r] for n in names]
        h = L.rms_norm(x, slot.norm1[r])
        if slot.kind.mla:
            q_nope, q_rope = L._mla_q(slot, r, cfg, h, cur_pos[:, None])
            new = L._mla_kv(slot, r, cfg, h, cur_pos[:, None])
        else:
            q, *new = L._qkv(slot, r, cfg, h, cur_pos[:, None])
        for pool_h, pool_host, e in zip(hbm, host, new):
            e1 = e[:, 0].to(pool_h.dtype)
            pool_h.index_put_(hbm_at, e1[hbm_rows])
            pool_host.index_put_(host_at, e1[host_rows])
        if slot.kind.mla:
            q_abs = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], slot.w_uk[r])
            ctx, mass = ops.paged_attention_mla(
                q_abs.contiguous(), q_rope[:, 0].contiguous(), hbm[0], hbm[1],
                tables, lengths, scale=L.mla_scale(cfg), return_mass=True)
            ctx = torch.einsum("bhr,rhk->bhk", ctx, slot.w_uv[r])
        else:
            ctx, mass = ops.paged_attention(q[:, 0].contiguous(), hbm[0],
                                            hbm[1], tables, lengths,
                                            window=TM._window(cfg, slot.kind),
                                            softcap=cfg.softcap,
                                            return_mass=True)
        x, _ = TM._block_tail(slot, r, cfg, x + ctx.reshape(b, 1, -1)
                              @ slot.wo[r])
        mass_sum += mass
        n_layers += 1
    logits = L.unembed(params, cfg, L.rms_norm(x, params.final_norm))
    page_mass = torch.where(active[:, None], mass_sum / max(1, n_layers),
                            torch.zeros_like(mass_sum))
    return logits, page_mass


@pytest.mark.parametrize("case", ["dead_rows", "hbm_unmapped",
                                  "host_unmapped", "clamp_collides",
                                  "all_dead"])
@pytest.mark.parametrize("kind", ["gqa", "window", "mla"])
def test_masked_write_through_equals_the_nonzero_write(kind, case):
    """Both tiers of every leaf bit-identical to the nonzero write, and the
    logits and masses too: dead rows, a write page unmapped on either
    tier, and dead rows whose clamped slot and offset are a live row's
    write (the nonzero write skipped them; the masked write sends them to
    the sink)."""
    cfg, params = _model(kind)
    tables, gids, cur = _case(case)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (4, 1)))
    args = (torch.from_numpy(tables), torch.from_numpy(gids), tokens,
            torch.from_numpy(cur))
    new = _pools(cfg)
    old = _pools(cfg)
    logits, mass = TM.decode_step_paged(params, cfg, new.kv_with_sink,
                                        *args, page_size=PAGE)
    ref_logits, ref_mass = _nonzero_core(params, cfg, old.kv_layers, *args,
                                         page_size=PAGE)
    assert torch.equal(logits, ref_logits)
    assert torch.equal(mass, ref_mass)
    for key, leaves in new.kv_layers.items():
        for t, r in zip(leaves, old.kv_layers[key]):
            if t is not None:
                assert torch.equal(t, r), key
    # the real pages moved only where a live row wrote
    fresh = _pools(cfg)
    live = (cur >= 0) & (tables[np.arange(4), np.maximum(cur, 0) // PAGE]
                         >= 0)
    changed = {int(tables[i, cur[i] // PAGE]) for i in np.nonzero(live)[0]}
    k0 = next(k for k in new.kv_layers if k.endswith("_hbm"))
    moved = {int(s) for s in torch.nonzero(
        (new.kv_layers[k0][0][0] != fresh.kv_layers[k0][0][0])
        .flatten(1).any(dim=1))}
    assert moved == changed


class _NoHostReads(TorchDispatchMode):
    """Fails on every op that reads a tensor's value back to the host or
    has a data-dependent shape (a sync on a card)."""

    BANNED = {"_local_scalar_dense", "nonzero", "masked_select", "unique",
              "_unique", "_unique2", "unique_consecutive", "unique_dim",
              "equal", "is_nonzero"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.BANNED:
            raise AssertionError(f"host read in the step body: {func}")
        return func(*args, **(kwargs or {}))


def _no_host_reads(monkeypatch):
    """Also bans what does not reach the dispatcher: ``tolist``,
    ``numpy``, ``cpu`` and tensors built from host values."""
    def banned(name):
        def fail(*a, **k):
            raise AssertionError(f"host read in the step body: {name}")
        return fail
    for name in ("tolist", "numpy", "cpu", "item"):
        monkeypatch.setattr(torch.Tensor, name, banned(name))
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, banned(f"torch.{name}"))
    return _NoHostReads()


def _carry(cfg, n_row=N_ROW):
    """A carry over four rows: two greedy, one sampled, one without a
    request."""
    c = TM.MacroCarry.empty(4, n_row, 8, "cpu")
    c.load(tokens=torch.tensor([[5], [9], [0], [17]]),
           cur_pos=torch.tensor([9, 14, -1, 13]),
           seeds=torch.tensor([1, 2, 0, 3]), iters=torch.tensor([4, 0, 0, 7]),
           emitted=torch.tensor([5, 1, 0, 8]),
           max_new=torch.tensor([9, 9, 0, 20]),
           eos_ids=torch.tensor([-1, 3, -1, -1]),
           temps=torch.tensor([0.0, 0.8, 0.0, 0.0]))
    return c


@pytest.mark.parametrize("kind", ["gqa", "window"])
def test_step_body_reads_nothing_back(kind, monkeypatch):
    """``decode_body`` (what the CUDA graph captures) makes no host read:
    no ``.item()``/``bool()``/``int()``/``float()`` of a tensor, no
    ``tolist``, no ``nonzero``, no tensor built from host values -- over
    three steps with a greedy, a sampled and an empty row."""
    cfg, params = _model(kind)
    pools = _pools(cfg)
    tables = torch.from_numpy(TABLES)
    gids = torch.from_numpy(np.where(TABLES >= 0, TABLES + 5, -1)
                            .astype(np.int32))
    c = _carry(cfg)
    mode = _no_host_reads(monkeypatch)
    with mode:
        for _ in range(3):
            TM.decode_body(params, cfg, pools.kv_with_sink, tables, gids, c,
                           page_size=PAGE)
    monkeypatch.undo()
    assert c.step.tolist() == [3]
    assert c.alive_steps[[0, 2, 3]].tolist() == [3, 0, 3]
    assert c.toks_out[:3, 2].tolist() == [-1, -1, -1]


@pytest.mark.parametrize("kind", ["rglru", "xlstm"])
def test_recurrent_step_body_reads_nothing_back(kind, monkeypatch):
    """``decode_body`` of a recurrent config makes no host read either:
    each row's state page is read from its HBM slot and written through
    both tiers at its ``state_cols`` column (a sixth column, past the
    token pages), the empty row's into the sinks.  Live rows' state pages
    change on both tiers, alike; the mass at each live row's state column
    counts one per recurrent layer a step."""
    cfg, params = _model(kind)
    pools = _pools(cfg, hbm=HBM + 4)
    tables_np = np.concatenate([TABLES, [[12], [13], [-1], [14]]], axis=1) \
        .astype(np.int32)
    tables = torch.from_numpy(tables_np)
    gids = torch.from_numpy(np.where(tables_np >= 0, tables_np + 5, -1)
                            .astype(np.int32))
    state_cols = torch.full((4,), N_ROW, dtype=torch.int64)
    before = {k: [None if t is None else t.clone() for t in v]
              for k, v in pools.kv_layers.items()}
    c = _carry(cfg, N_ROW + 1)
    mode = _no_host_reads(monkeypatch)
    with mode:
        for _ in range(3):
            TM.decode_body(params, cfg, pools.kv_with_sink, tables, gids, c,
                           page_size=PAGE, state_cols=state_cols)
    monkeypatch.undo()
    assert c.alive_steps[[0, 2, 3]].tolist() == [3, 0, 3]
    recurrent = sum(r for _, _, r, _, k in TM.state_slot_meta(cfg)
                    if k.is_recurrent)
    n_layers = cfg.num_layers
    for row in (0, 3):
        assert abs(float(c.mass_sum[row, N_ROW]) - 3 * recurrent / n_layers) \
            < 1e-5
    assert float(c.mass_sum[2].abs().sum()) == 0.0
    for li, leaf in enumerate(pools.kv_layers["state_hbm"]):
        if leaf is None:
            continue
        host = pools.kv_layers["state_host"][li]
        for slot, gid in ((12, 17), (14, 19)):
            assert not torch.equal(leaf[:, slot],
                                   before["state_hbm"][li][:, slot])
            assert torch.equal(leaf[:, slot], host[:, gid])
        # slot 15, which no table names, keeps its bytes
        assert torch.equal(leaf[:, 15], before["state_hbm"][li][:, 15])


def test_routed_moe_step_reads_its_expert_counts(monkeypatch):
    """A routed MoE layer groups its tokens by expert on the device
    (``kernels.routed_experts``; its plain version here): ``decode_body``
    of an MLA + MoE config (deepseek-v3-671b, with a shared expert) and a
    GQA + MoE one (olmoe-1b-7b) makes no host read over three steps,
    under the detector above, and equals the per-step
    ``decode_step_paged`` it wraps."""
    tables = torch.from_numpy(TABLES)
    gids = torch.from_numpy(np.where(TABLES >= 0, TABLES + 5, -1)
                            .astype(np.int32))
    for kind in ("mla", "olmoe"):
        cfg, params = _model(kind)
        pools, again = _pools(cfg), _pools(cfg)
        c = _carry(cfg)
        tok, pos = c.tok.clone(), torch.where(c.alive(), c.pos, -1)
        mode = _no_host_reads(monkeypatch)
        with mode:
            for step in range(3):
                TM.decode_body(params, cfg, pools.kv_with_sink, tables, gids,
                               c, page_size=PAGE)
                if step == 0:
                    first = c.mass_sum.clone()
        monkeypatch.undo()
        assert c.step.tolist() == [3], kind
        assert c.alive_steps[[0, 2, 3]].tolist() == [3, 0, 3], kind
        _, mass = TM.decode_step_paged(params, cfg, again.kv_with_sink,
                                       tables, gids, tok, pos,
                                       page_size=PAGE)
        assert torch.equal(first, mass) and float(mass.sum()) > 0, kind


_M = np.uint64(0xFFFFFFFF)


def _np_mix32(x):
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x7FEB352D)) & _M
    x = x ^ (x >> np.uint64(15))
    x = (x * np.uint64(0x846CA68B)) & _M
    return x ^ (x >> np.uint64(16))


def _np_uniform(seeds, iters):
    """The hash in numpy uint64, with full 64-bit products."""
    s = np.asarray(seeds, np.int64).view(np.uint64)
    i = np.asarray(iters, np.int64).view(np.uint64)
    h = _np_mix32(_np_mix32((s + np.uint64(0x9E3779B9)) & _M) ^ (i & _M))
    return (h >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24)


SEEDS = [0, 1, 2, 7, 100, 101, 12345, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1,
         2 ** 32, 2 ** 40 + 3, -1, -5]


@pytest.mark.parametrize("iters", [range(0, 64), range(2 ** 31 - 8,
                                                         2 ** 31 + 8),
                                   [2 ** 32 - 1, 2 ** 32, 2 ** 33 + 1]])
def test_uniform_is_the_numpy_hash_bit_for_bit(iters):
    s, i = np.meshgrid(np.asarray(SEEDS, np.int64),
                       np.asarray(list(iters), np.int64), indexing="ij")
    got = TM.uniform(torch.from_numpy(s.ravel()), torch.from_numpy(i.ravel()))
    want = _np_uniform(s.ravel(), i.ravel())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


def test_uniform_draws_spread_over_the_unit_interval():
    """Over one seed's first 4096 iterations the draws fill every tenth
    of [0, 1) and no two coincide."""
    u = TM.uniform(torch.full((4096,), 11), torch.arange(4096)).numpy()
    counts = np.histogram(u, bins=10, range=(0.0, 1.0))[0]
    assert counts.min() > 300 and len(np.unique(u)) == 4096


def test_sample_draws_at_the_hashed_uniform():
    """A sampled row takes the inverse-CDF index of ``uniform(seed,
    iter)``; a greedy row the argmax."""
    logits = torch.randn((3, 50), generator=torch.Generator().manual_seed(0))
    temps = torch.tensor([0.0, 0.7, 1.3])
    seeds = torch.tensor([4, 5, 6])
    iters = torch.tensor([0, 3, 9])
    got = TM.sample(logits, temps, seeds, iters)
    u = _np_uniform(seeds.numpy(), iters.numpy())
    assert int(got[0]) == int(logits[0].argmax())
    for row in (1, 2):
        p = torch.softmax(logits[row] / temps[row], dim=-1).cumsum(0)
        want = int(torch.searchsorted(p, float(u[row]) * p[-1]))
        assert int(got[row]) == want


def _monitor():
    return TS.TrafficMonitor(
        SharedPagedPools.create(48, 10),
        TieringManager(48, TierConfig(page_size=4, hbm_pages=10)),
        OnlineTuner(48))


@pytest.mark.parametrize("kind,macro,eager", [("gqa", True, False),
                                              ("window", True, False),
                                              ("gqa", False, False),
                                              ("gqa", True, True),
                                              ("mla", True, False),
                                              ("olmoe", True, False)])
def test_cpu_batchers_take_the_eager_route(kind, macro, eager):
    """On the CPU every batcher is eager, whatever the config; its device
    steps equal its decode steps."""
    cfg, params = _model(kind)
    b = TS.ContinuousBatcher(params, cfg, monitor=_monitor(), max_active=2,
                             max_len=32, page_size=4, macro=macro,
                             eager=eager, device="cpu")
    assert b.route == "eager" and b._graph is None
    b.submit(TS.Request(0, np.arange(5, dtype=np.int32), 6))
    out = b.run()
    assert len(out[0]) == 6
    assert b.device_steps == b.decode_steps > 0


@pytest.mark.parametrize("kind,takes", [("gqa", True), ("window", True),
                                        ("mla", True), ("rglru", True),
                                        ("xlstm", True), ("olmoe", True)])
def test_graph_route_supports_configs_without_routed_moe(kind, takes):
    """Every served config, reduced and at full width, routed MoE
    included, takes the graph route on a card for macro steps
    (``sched.decode_route``); the CPU, per-token steps and ``eager=True``
    take the eager route."""
    cfg, _ = _model(kind)
    for c in (cfg, TC.get(ARCHS[kind])):
        TM.check_supported(c)
    assert (TS.decode_route(torch.device("cuda"), macro=True, eager=False)
            == "graph") is takes
    for device, macro, eager in (("cpu", True, False), ("cuda", False, False),
                                 ("cuda", True, True)):
        assert TS.decode_route(device, macro=macro, eager=eager) == "eager"


def test_decode_graph_refuses_what_it_cannot_capture():
    """No fallback: CPU tables raise, for a routed MoE config as for any
    other (no config is refused)."""
    for kind in ("mla", "gqa"):
        cfg, params = _model(kind)
        pools = _pools(cfg)
        t = torch.full((2, N_ROW), -1, dtype=torch.int32)
        with pytest.raises(ValueError, match="CUDA tables"):
            graphs.DecodeGraph(params, cfg, pools.kv_with_sink, t, t.clone(),
                               max_steps=8, page_size=PAGE)


def test_pools_keep_their_shapes_beside_the_sinks():
    """``kv_layers`` is the sinked storage without its last page: same
    shapes as before the sinks, writes through a view land in the
    storage."""
    cfg, _ = _model("gqa")
    pools = _pools(cfg)
    for key, leaves in pools.kv_layers.items():
        n = HBM if key.endswith("_hbm") else N_LOGICAL
        for t, full in zip(leaves, pools.kv_with_sink[key]):
            assert t.shape[1] == n and full.shape[1] == n + 1
            assert t.data_ptr() == full.data_ptr()
            t[0, 0].fill_(7.0)
            assert bool((full[0, 0] == 7.0).all())
