"""Production mesh construction (the counterpart of
``repro/launch/mesh.py``).

Single pod: 256 ranks as (16, 16) ("data", "model").
Multi-pod:  2 pods x 256 ranks as (2, 16, 16) ("pod", "data", "model");
the "pod" axis carries cross-pod data parallelism (optionally with int8
gradient compression -- see ``repro_torch.distributed.collectives``).

The meshes are ``init_device_mesh`` calls over the default process group,
which the caller starts (``torch.distributed.init_process_group``: NCCL
on cards, gloo on the CPU, the fake backend for the dry-run).  Defined as
functions, so importing this module touches no process group.  The device
type is "cuda" unless the caller asks for another.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.distributed.compat import init_device_mesh

__all__ = ["production_shape", "make_production_mesh", "make_host_mesh"]


def production_shape(*, multi_pod: bool = False):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _mesh(shape, axes, device_type: str):
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != n:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{n} ranks, not {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape, axes = production_shape(multi_pod=multi_pod)
    return _mesh(shape, axes, device_type)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1, *,
                   device_type: str = "cuda"):
    """A small mesh over the process group's ranks -- used by tests,
    ``launch.train`` and the smoke: ("data", "model"), with "pod" first
    when ``pod > 1``."""
    if pod > 1:
        return _mesh((pod, data, model), ("pod", "data", "model"),
                     device_type)
    return _mesh((data, model), ("data", "model"), device_type)
