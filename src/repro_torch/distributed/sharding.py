"""Logical-axis sharding rules and their resolution to mesh axes (the
counterpart of ``repro/distributed/sharding.py``).

Parallelism encoded here:
  * DP    -- activation "batch" over ("pod", "data")
  * FSDP  -- param "embed" dim over "data" (ZeRO-3-style weight sharding;
             params stay *within-pod* sharded and pod-replicated, so the
             per-layer all-gathers stay inside a pod while only the
             once-per-step gradient all-reduce crosses the pod axis)
  * TP    -- param "mlp"/"heads"/"vocab" (and fallbacks) over "model"
  * EP    -- param "expert" over "model" (expert-parallel MoE)
  * SP/CP -- decode KV cache "kv_seq" over "model" (context parallelism)

Resolution is divisibility-aware with per-dim fallback: each logical name
maps to a list of candidate mesh axes; a dim takes the first candidate
whose size divides it and which is not already used by another dim of the
same tensor.  E.g. Qwen3's 40 heads don't divide a 16-way model axis, so
the attention projections shard their 128-wide head_dim instead.

A spec is a tuple with one entry per dim -- ``None``, a mesh axis name, or
a tuple of names (the joint ``("pod", "data")`` batch) -- equal entry for
entry to the reference's ``PartitionSpec``.  ``placements`` turns it into
DTensor placements on a ``DeviceMesh`` with named dims.  The resolver
reads only the mesh's axis names and sizes, so it takes a ``DeviceMesh``
or any object with ``axis_names`` and ``shape`` (a mapping or a tuple):
a 256-way mesh resolves without 256 ranks.

The port keeps the attention projections fused (``wq [d, H*hd]``, ``wo
[H*hd, d]``).  A fused leaf resolves on the reference's unfused shape
(``[d, H, hd]``) -- the same spec as the reference -- and ``fold`` maps
that spec onto the fused dims: the fused dim takes the axis of whichever
of its parts has one.  When ``heads`` takes the axis, each rank holds the
reference's heads; when the fallback shards ``head_dim`` (Qwen3's 40 heads
on 16 ranks), ``Shard`` of the fused dim holds the same number of bytes
per rank but other elements (ROADMAP Queue 3).
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.distributed.compat import DTensor, Replicate, Shard

__all__ = ["PARAM_RULES", "ACT_RULES", "axis_sizes", "param_spec",
           "act_spec", "act_rules_for", "input_sharding", "fold",
           "placements", "leaf_placements", "tree_shardings",
           "make_param_shard_fn", "make_shard_fn"]

# candidate mesh axes per logical axis name, in priority order
PARAM_RULES: Dict[str, Tuple[str, ...]] = {
    "embed": ("data",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "lru": ("model",),
    "q_lora": (),
    "kv_lora": (),
    "layers": (),
    "cond": (),
    "qblocks": ("data",),
}

ACT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    # Sequence parallelism: the residual stream (and thus every remat-saved
    # layer input) shards its seq dim over "model".
    "seq": ("model",),
    "embed": (),
    "vocab": ("model",),
    "kv_seq": ("model",),
    "heads": ("model",),
    "layers": (),
}


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a duck-typed mesh
    (``axis_names`` and ``shape``, a mapping or a tuple)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(s) for s in shape)))


def _resolve(axes: Optional[Sequence[Optional[str]]], shape: Tuple[int, ...],
             rules: Dict[str, Tuple[str, ...]], mesh) -> tuple:
    """Resolve a logical-axis tuple to a spec for ``shape``."""
    if axes is None:
        return ()
    assert len(axes) == len(shape), (axes, shape)
    sizes = axis_sizes(mesh)
    used: set = set()
    out = []
    for name, dim in zip(axes, shape):
        if name is None:
            out.append(None)
            continue
        cands = rules.get(name, ())
        if name == "batch":
            # batch may take several axes jointly (pod x data)
            take = [a for a in cands if a in sizes and a not in used]
            sz = math.prod(sizes[a] for a in take) if take else 1
            if take and dim % sz == 0:
                used.update(take)
                out.append(tuple(take) if len(take) > 1 else take[0])
            else:
                # try the largest single axis that divides
                picked = None
                for a in take:
                    if dim % sizes[a] == 0:
                        picked = a
                        break
                if picked:
                    used.add(picked)
                out.append(picked)
            continue
        picked = None
        for a in cands:
            if a in sizes and a not in used and dim % sizes[a] == 0:
                picked = a
                break
        if picked:
            used.add(picked)
        out.append(picked)
    return tuple(out)


def param_spec(axes, shape, mesh) -> tuple:
    return _resolve(axes, shape, PARAM_RULES, mesh)


def act_spec(axes, shape, mesh) -> tuple:
    return _resolve(axes, shape, ACT_RULES, mesh)


def act_rules_for(step_kind: str) -> Dict[str, Tuple[str, ...]]:
    """SP (seq over model) stays on for every sequence-mode step, as the
    reference's."""
    return ACT_RULES


def input_sharding(mesh, *axes_names) -> tuple:
    """The spec of a step input given logical names (divisibility left to
    the caller -- used for token/target arrays)."""
    sizes = axis_sizes(mesh)
    out = []
    used: set = set()
    for name in axes_names:
        if name is None:
            out.append(None)
            continue
        cands = [a for a in ACT_RULES.get(name, ()) if a in sizes
                 and a not in used]
        used.update(cands)
        out.append(tuple(cands) if len(cands) > 1 else
                   (cands[0] if cands else None))
    return tuple(out)


def fold(spec: tuple, ref_shape, shape) -> tuple:
    """A spec resolved on ``ref_shape`` carried to ``shape``, whose dims
    merge runs of consecutive dims of ``ref_shape`` (a fused projection:
    ``[d, H, hd]`` -> ``[d, H*hd]``).  A merged dim takes the axes of its
    parts (``None`` when none has one)."""
    ref_shape, shape = tuple(ref_shape), tuple(shape)
    if ref_shape == shape or not spec:
        return spec
    out, i = [], 0
    for k, dim in enumerate(shape):
        prod, parts = 1, []
        while i < len(ref_shape) and (not parts or prod < dim or (
                k == len(shape) - 1 and ref_shape[i] == 1)):
            prod *= ref_shape[i]
            parts.append(spec[i])
            i += 1
        if prod != dim:
            raise ValueError(f"{shape} does not merge dims of {ref_shape}")
        named = []
        for p in parts:
            if p is not None:
                named.extend(p if isinstance(p, tuple) else (p,))
        out.append(None if not named else
                   (named[0] if len(named) == 1 else tuple(named)))
    if i != len(ref_shape):
        raise ValueError(f"{shape} does not merge dims of {ref_shape}")
    return tuple(out)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements on ``mesh`` (a ``DeviceMesh`` with named dims)
    for a spec: a tensor dim that takes an axis is ``Shard(dim)`` on that
    mesh dim, a joint ``("pod", "data")`` dim is ``Shard(dim)`` on both
    (in mesh order, pod first as the reference's), every other mesh dim
    ``Replicate()`` -- a mesh dim of one rank too, where a shard is the
    whole tensor (and older DTensor releases refuse to fold a dim
    sharded over one rank into another)."""
    names = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if sizes[a] > 1:
                out[names.index(a)] = Shard(dim)
    return tuple(out)


def leaf_placements(axes, ref_shape, shape, mesh,
                    rules: Dict[str, Tuple[str, ...]] = PARAM_RULES,
                    sizes_mesh=None) -> tuple:
    """Placements on ``mesh`` of a leaf of ``shape`` whose logical ``axes``
    describe ``ref_shape`` (the reference's layout: equal to ``shape``
    but for fused dims).  ``sizes_mesh`` resolves in place of ``mesh``
    (the full mesh when ``mesh`` is a sub-mesh of it)."""
    spec = _resolve(axes, tuple(ref_shape), rules, sizes_mesh or mesh)
    return placements(fold(spec, ref_shape, shape), mesh)


def tree_shardings(spec_tree: Dict[str, tuple], shape_tree, mesh,
                   rules: Dict[str, Tuple[str, ...]] = PARAM_RULES,
                   leaf_shapes=None) -> Dict[str, tuple]:
    """{name: placements} from a logical-spec map and a map of shapes the
    specs describe (tensors or shapes); ``leaf_shapes`` (when the leaves
    fuse dims of those shapes) gives the leaves' own shapes."""
    shp = lambda t: tuple(t.shape) if hasattr(t, "shape") else tuple(t)
    out = {}
    for name, axes in spec_tree.items():
        ref = shp(shape_tree[name])
        own = shp(leaf_shapes[name]) if leaf_shapes is not None else ref
        out[name] = leaf_placements(axes, ref, own, mesh, rules)
    return out


def _redistribute(x, place):
    if tuple(x.placements) == tuple(place):
        return x
    return x.redistribute(x.device_mesh, place)


def make_param_shard_fn(mesh, gather: Tuple[str, ...] = ()):
    """Constraint fn for a repeat's slot leaves: ``shard(x, axes,
    ref_shape=None)`` lays a DTensor leaf out by its resolved spec (the
    reference pins a scanned layer's leaves so that the FSDP all-gather
    stays per layer), with the mesh axes in ``gather`` replicated: the
    mesh step passes ("data",), so each repeat's weights are gathered
    over the FSDP axis where they are used and their gradients
    reduce-scattered back (ZeRO-3), where DTensor's per-op choice would
    otherwise gather the activations.  None with no mesh, the identity on
    a plain tensor."""
    if mesh is None:
        return None

    def shard(x, axes, ref_shape=None):
        if not isinstance(x, DTensor):
            return x
        ref = tuple(x.shape) if ref_shape is None else tuple(ref_shape)
        place = leaf_placements(axes, ref, tuple(x.shape), x.device_mesh,
                                PARAM_RULES, mesh)
        names = list(x.device_mesh.mesh_dim_names)
        place = tuple(Replicate() if names[i] in gather else pl
                      for i, pl in enumerate(place))
        return _redistribute(x, place)

    return shard


def _ident(x, names):
    return x


def make_shard_fn(mesh, exclude: Tuple[str, ...] = (),
                  rules: Optional[Dict[str, Tuple[str, ...]]] = None):
    """Activation-constraint fn: shard(x, logical_names) -> x, laid out by
    the resolved spec (a DTensor ``redistribute``).  ``exclude`` drops
    mesh axes from the rules (the pod axis, which the pod step handles
    by hand).  The identity with no mesh or on a plain tensor."""
    if mesh is None:
        return _ident
    rules = dict(rules if rules is not None else ACT_RULES)
    rules = {k: tuple(a for a in v if a not in exclude)
             for k, v in rules.items()}

    def shard(x, names):
        if not isinstance(x, DTensor):
            return x
        spec = _resolve(names, tuple(x.shape), rules, mesh)
        return _redistribute(x, placements(spec, x.device_mesh))

    return shard
