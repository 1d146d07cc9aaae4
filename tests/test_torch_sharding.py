"""The port's sharding rules and logical spec trees against the JAX
reference, in process, with no ranks: both resolvers read a duck-typed
mesh (axis names and sizes), so the production meshes resolve without
256 devices.

  * every leaf of the reference's ``init_specs_only`` tree, at its shape
    under ``jax.eval_shape(init)``, resolves to the same spec in both
    packages, for every registered arch on the meshes (16, 16),
    (2, 16, 16), (2, 4), (2, 2, 2) and (1, 1) -- and so do the
    activation specs of a cell's inputs;
  * ``test_sharding_rules_resolution``'s cases (``tests/test_distributed.py``)
    word for word on the port;
  * the port's spec trees (``model.init_specs_only``, ``cache_specs``,
    ``optim.state_specs`` in every state precision, ``step.state_specs``)
    equal the reference's leaf for leaf through the bridge's name map,
    and ``model.param_ref_shapes`` gives the reference's shape of every
    leaf;
  * the fused-projection finding (ROADMAP Queue 3): where the fallback
    shards ``head_dim`` (qwen3-14b's 40 heads on a 16-way model axis),
    the port's ``Shard`` of the fused ``[d, H*hd]`` dim holds the same
    bytes per rank as the reference's head_dim shard, but other
    elements.

Exact equality throughout (specs are tuples of names)."""
import types

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.distributed import sharding as RSH
from repro.models import model as RM
from repro.train import optim as RO
from repro.train import step as RS

import repro_torch.configs as TC
from repro_torch import bridge
from repro_torch.distributed import sharding as SH
from repro_torch.models import model as TM
from repro_torch.train import optim as TO
from repro_torch.train import step as TS

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}

_is_axes = lambda x: x is None or (isinstance(x, tuple) and all(
    isinstance(a, (str, type(None))) for a in x))


def _mesh(name):
    """A duck-typed mesh both resolvers read: ``axis_names`` and a
    ``shape`` mapping (a JAX ``Mesh``'s), ``mesh_dim_names`` for the
    port's ``placements``."""
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, mesh_dim_names=axes,
                                 shape=dict(zip(axes, shape)))


_REF = {}


def _ref(arch):
    """(the reference's spec tree, its leaves' shapes) for ``arch``."""
    if arch not in _REF:
        cfg = RC.get(arch)
        specs = RM.init_specs_only(cfg)
        shapes = jax.eval_shape(
            lambda: RM.init(jax.random.PRNGKey(0), cfg)[0])
        _REF[arch] = (specs, shapes)
    return _REF[arch]


def _pairs(arch):
    """[(path, reference axes, reference shape)] of every parameter."""
    specs, shapes = _ref(arch)
    flat_s = jax.tree_util.tree_flatten_with_path(specs, is_leaf=_is_axes)[0]
    flat_x = jax.tree_util.tree_leaves(shapes)
    assert len(flat_s) == len(flat_x)
    return [(jax.tree_util.keystr(p), ax, tuple(x.shape))
            for (p, ax), x in zip(flat_s, flat_x)]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", TC.ARCHS)
def test_param_specs_resolve_as_reference(arch, mesh):
    m = _mesh(mesh)
    for path, axes, shape in _pairs(arch):
        want = tuple(RSH.param_spec(axes, shape, m))
        assert SH.param_spec(axes, shape, m) == want, (path, axes, shape)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_act_specs_resolve_as_reference(mesh):
    """Every cell's step inputs (``_batch_shardings``' logical names) and
    every decode cell's cache leaves (``cache_specs``)."""
    m = _mesh(mesh)
    names = {"tokens": ("batch", "seq"), "targets": ("batch", "seq"),
             "extra_embeds": ("batch", "seq", "embed"),
             "cond": ("batch", "seq", "embed"), "cur_pos": ("batch",)}
    for arch, shape in RC.cells():
        sh = RC.SHAPES[shape]
        b, s = sh["global_batch"], sh["seq_len"]
        for n, shp in (("tokens", (b, s)), ("cur_pos", (b,)),
                       ("cond", (b, 64, 2048))):
            assert SH.act_spec(names[n], shp, m) == tuple(
                RSH.act_spec(names[n], shp, m)), (arch, shape, n)
        if sh["step"] != "decode":
            continue
        cfg = RC.get(arch)
        cache = jax.eval_shape(lambda: RM.init_cache(cfg, b, s))
        flat_s = jax.tree_util.tree_leaves(RM.cache_specs(cfg),
                                           is_leaf=_is_axes)
        for ax, x in zip(flat_s, jax.tree_util.tree_leaves(cache)):
            assert SH.act_spec(ax, x.shape, m) == tuple(
                RSH.act_spec(ax, x.shape, m)), (arch, shape, ax)


def test_sharding_rules_resolution():
    """``tests/test_distributed.py::test_sharding_rules_resolution`` word
    for word, on the port's resolver (specs as tuples)."""
    P = lambda *a: tuple(a)
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 2, "model": 4})
    # qwen-style: 40 heads don't divide 4 -> head_dim fallback
    s = SH.param_spec(("embed", "heads", "head_dim"), (64, 39, 128), mesh)
    assert s == P("data", None, "model"), s
    s = SH.param_spec(("embed", "heads", "head_dim"), (64, 40, 128), mesh)
    assert s == P("data", "model", None), s
    s = SH.param_spec(("vocab", "embed"), (1000, 64), mesh)
    assert s == P("model", "data"), s
    # batch over (pod, data) with joint divisibility
    mesh3 = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                  shape={"pod": 2, "data": 2, "model": 2})
    # SP: seq shards over model when divisible
    s = SH.act_spec(("batch", "seq", "embed"), (8, 16, 64), mesh3)
    assert s == P(("pod", "data"), "model", None), s
    s = SH.act_spec(("batch", "seq", "embed"), (8, 15, 64), mesh3)
    assert s == P(("pod", "data"), None, None), s
    s = SH.act_spec(("batch",), (2,), mesh3)    # only one axis fits
    assert s == P("pod"), s


@pytest.mark.parametrize("mesh", ["16x16", "2x2x2"])
def test_input_sharding_and_rules_as_reference(mesh, monkeypatch):
    """``input_sharding`` (the reference's builds a ``NamedSharding``
    over a real mesh: its spec is taken before it is wrapped) and the
    rule tables."""
    m = _mesh(mesh)
    monkeypatch.setattr(RSH, "NamedSharding", lambda mesh, spec: spec)
    for names in (("batch", "seq"), ("batch",), ("batch", None),
                  ("batch", "seq", "embed")):
        assert SH.input_sharding(m, *names) == tuple(
            RSH.input_sharding(m, *names))
    assert SH.PARAM_RULES == RSH.PARAM_RULES
    assert SH.ACT_RULES == RSH.ACT_RULES
    for kind in ("train", "prefill", "decode"):
        assert SH.act_rules_for(kind) == RSH.act_rules_for(kind)


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_spec_trees_equal_reference(arch):
    """``init_specs_only`` and ``param_ref_shapes`` through the bridge's
    name map; ``cache_specs``; both ``state_specs`` in every state
    precision."""
    tcfg = TC.get(arch)
    specs, shapes = _ref(arch)
    port = TM.init_specs_only(tcfg)
    meta = TM.Transformer(tcfg, torch.device("meta"))
    names = {id(t): n for n, t in meta.named_parameters()}
    refs = TM.param_ref_shapes(meta)
    seen = set()
    for (dst, ax), (_, x) in zip(bridge._walk(meta, specs, tcfg),
                                 bridge._walk(meta, shapes, tcfg)):
        n = names[id(dst)]
        seen.add(n)
        assert port[n] == ax, (n, port[n], ax)
        assert refs[n] == tuple(x.shape), (n, refs[n], x.shape)
        assert int(np.prod(x.shape)) == dst.numel()
    assert seen == set(port)
    assert TM.cache_specs(tcfg) == RM.cache_specs(RC.get(arch))
    for sd in ("float32", "bfloat16", "int8"):
        rspec = RS.state_specs(specs, RO.OptConfig(state_dtype=sd))
        tspec = TS.state_specs(port, TO.OptConfig(state_dtype=sd))
        assert tspec["step"] is None and rspec["step"] is None
        assert tspec["opt"]["count"] is None
        for key in ("m", "v"):
            got = {names[id(d)]: tuple(t) if isinstance(t, tuple) else t
                   for d, t in bridge._walk(meta, rspec["opt"][key], tcfg)}
            want = {n: tuple(tspec["opt"][key][n]) for n in port}
            assert got == want, (sd, key)
        if sd == "int8":
            assert set(tspec["opt"]["m"].values()) == {
                TO.QLeaf(("qblocks", None), ("qblocks", None),
                         ("qblocks", None))}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fold_and_placements(mesh):
    """A fused leaf's spec: ``fold`` of the reference's unfused spec; the
    placements shard each named dim on its mesh dim (a joint batch on
    both, pod first) and replicate the rest, a mesh dim of one rank too;
    ``tree_shardings`` gives every leaf's."""
    m = _mesh(mesh)
    cfg = TC.get("qwen3-14b")
    meta = TM.Transformer(cfg, torch.device("meta"))
    specs, refs = TM.param_specs(meta), TM.param_ref_shapes(meta)
    for n, t in meta.named_parameters():
        spec = SH.param_spec(specs[n], refs[n], m)
        folded = SH.fold(spec, refs[n], tuple(t.shape))
        assert len(folded) == t.dim()
        named = [a for e in spec if e for a in
                 (e if isinstance(e, tuple) else (e,))]
        named_f = [a for e in folded if e for a in
                   (e if isinstance(e, tuple) else (e,))]
        assert sorted(named) == sorted(named_f), n
        pl = SH.placements(folded, m)
        for i, axis in enumerate(m.mesh_dim_names):
            dims = [d for d, e in enumerate(folded) if e == axis or (
                isinstance(e, tuple) and axis in e)]
            if dims and m.shape[axis] > 1:
                assert pl[i] == SH.Shard(dims[0]), (n, axis)
            else:
                assert pl[i] == SH.Replicate(), (n, axis)
    tree = SH.tree_shardings(specs, refs, m, leaf_shapes={
        n: t.shape for n, t in meta.named_parameters()})
    assert sorted(tree) == sorted(specs)
    for n, t in meta.named_parameters():
        assert tree[n] == SH.placements(SH.fold(
            SH.param_spec(specs[n], refs[n], m), refs[n], tuple(t.shape)), m)
    joint = SH.placements((("pod", "data"), "model", None), m) \
        if "pod" in m.axis_names else None
    if joint is not None:
        assert joint == (SH.Shard(0), SH.Shard(0), SH.Shard(1))


def test_fused_projection_finding():
    """qwen3-14b's ``wq`` on a (16, 16) mesh: the reference shards
    ``head_dim`` (40 heads do not divide 16) -- each model rank holds 8 of
    every head's 128 columns; the port's fused ``[d, 40*128]`` leaf takes
    ``Shard`` on the fused dim -- each rank holds 320 contiguous columns,
    2.5 whole heads.  Same bytes per rank, other elements."""
    m = _mesh("16x16")
    cfg = TC.get("qwen3-14b")
    meta = TM.Transformer(cfg, torch.device("meta"))
    specs, refs = TM.param_specs(meta), TM.param_ref_shapes(meta)
    n = "segments.0.0.wq"
    spec = SH.param_spec(specs[n], refs[n], m)
    assert spec == (None, "data", None, "model")        # head_dim fallback
    assert spec == tuple(RSH.param_spec(specs[n], refs[n], m))
    folded = SH.fold(spec, refs[n], tuple(meta.get_parameter(n).shape))
    assert folded == (None, "data", "model")
    h, hd = cfg.num_heads, cfg.head_dim
    cols = np.arange(h * hd).reshape(h, hd)
    ref_rank0 = set(cols[:, :hd // 16].ravel())          # head_dim shard
    port_rank0 = set(range(h * hd // 16))                # fused shard
    assert len(ref_rank0) == len(port_rank0) == h * hd // 16
    assert ref_rank0 != port_rank0
    # where heads divide (gemma3-12b: 16 heads), both hold the same heads
    g = TC.get("gemma3-12b")
    gm = TM.Transformer(g, torch.device("meta"))
    gs, gr = TM.param_specs(gm), TM.param_ref_shapes(gm)
    sp = SH.param_spec(gs[n], gr[n], m)
    assert sp == (None, "data", "model", None)
    assert SH.fold(sp, gr[n], tuple(gm.get_parameter(n).shape)) == (
        None, "data", "model")
