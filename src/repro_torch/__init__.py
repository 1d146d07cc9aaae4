"""PyTorch/CUDA port of the online-Cori paged serving loop.

``repro_torch`` mirrors the JAX package's module layout (``core``,
``obs``, ``ft``, ``models``, ``configs``, ``kernels``, ``memtier``,
``serve``) so each module's counterpart is easy to find.  It imports
``torch`` and never JAX or the JAX package: the host-only modules it needs
(configs, the Cori tuner, the reuse collector, the flight recorder, the
fault plan) are copies kept behaviourally identical to the reference.

Every entry point (``models.model.init``, ``bridge.from_reference``,
``memtier.SharedPagedPools.attach_layered``,
``serve.sched.ContinuousBatcher``, ``serve.engine.generate``) runs on the
CUDA card unless the caller passes ``device="cpu"``; with no card visible
it raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one.  Raises when CUDA is asked for (explicitly or by
    default) and no card is visible.  On a card, float32 matrix products
    and convolutions are pinned to full float32 (no TF32): the reference
    computes in float32 past the embedding, and the port mirrors it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass "
                               "device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
