"""torch version shim for the mesh APIs the port leans on (the counterpart
of ``repro/distributed/compat.py``, which adapts JAX's ``shard_map`` /
``set_mesh`` to jax 0.4).

The names moved between torch releases:

  * ``DTensor``, ``distribute_tensor``, ``Shard``, ``Replicate``,
    ``Partial`` live in ``torch.distributed.tensor`` from torch 2.4 and in
    ``torch.distributed._tensor`` before (``Partial`` was ``_Partial``);
  * ``implicit_replication`` in ``torch.distributed.tensor.experimental``
    (``_tensor.experimental`` before);
  * ``init_device_mesh`` / ``DeviceMesh`` in
    ``torch.distributed.device_mesh`` (2.2 on).

Every other module imports them from here.  ``init_fake_process_group``
starts the in-process fake backend (``torch.testing``'s ``FakeStore``,
backend ``"fake"``): collectives return at once without moving data, so
one process can stand for every rank of a 256-way mesh (the dry-run).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

try:                                            # torch >= 2.4
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication
except ImportError:                             # pragma: no cover - older
    from torch.distributed._tensor import (DTensor, Replicate, Shard,
                                           distribute_tensor)
    from torch.distributed._tensor import _Partial as Partial
    from torch.distributed._tensor.experimental import implicit_replication
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["DTensor", "DeviceMesh", "Partial", "Replicate", "Shard",
           "distribute_tensor", "distribute_local", "implicit_replication",
           "init_device_mesh", "init_fake_process_group"]


def distribute_local(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t`` (the same whole tensor on every rank) as a DTensor whose
    local shard each rank cuts from its own copy: no collective
    (``src_data_rank=None``; older releases scatter from rank 0)."""
    try:
        return distribute_tensor(t, mesh, placements, src_data_rank=None)
    except TypeError:                           # pragma: no cover - older
        return distribute_tensor(t, mesh, placements)


def init_fake_process_group(world_size: int, rank: int = 0) -> None:
    """The default process group over the fake backend, ``world_size``
    ranks of which this process is ``rank``; a no-op when one is already
    up with that size (raises for another size)."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"already up; the fake mesh needs {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
