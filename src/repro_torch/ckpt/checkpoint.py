"""Atomic, async-capable checkpoints of the train state (the counterpart
of ``repro/ckpt/checkpoint.py``, with its on-disk layout).

Format: ``step_%010d/`` holding ``state.npz`` (the state's leaves, key
``leaf_<i>``) and ``manifest.json`` (step, leaf count, shapes, dtypes,
time).  Writes go to a temporary directory that is renamed into place,
so a crash mid-save never corrupts the newest checkpoint, and ``keep``
checkpoints are kept.  The structure is code-defined, not serialised:
``restore`` walks a template of the same structure and loads each leaf
into it, on the template's device.

Leaf order: dicts by sorted key (as ``jax.tree.leaves``), a module's
parameters by sorted name, an int8 moment ``QLeaf`` as (q, scale, zero).
numpy has no bfloat16, so a bfloat16 leaf is stored as its int16 bits
and the manifest names its dtype.

``AsyncCheckpointer`` overlaps the write with training: one save in
flight, joined before the next; the state is copied to the host before
the writer starts (the step updates it in place).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import List, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]


def _ckpt_dir(base, step: int) -> pathlib.Path:
    return pathlib.Path(base) / f"step_{step:010d}"


def _leaves(tree) -> List:
    """The state's leaves in checkpoint order (module docstring)."""
    if isinstance(tree, nn.Module):
        named = dict(tree.named_parameters())
        return [named[k] for k in sorted(named)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):                   # QLeaf
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _dtype_name(x) -> str:
    if torch.is_tensor(x):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _host(x, copy: bool) -> np.ndarray:
    """A leaf as a numpy array (bfloat16 as its int16 bits); ``copy``
    detaches it from a tensor that will change."""
    if not torch.is_tensor(x):
        return np.array(x) if copy else np.asarray(x)
    t = x.detach().to("cpu", copy=copy)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _write(base, step: int, arrays: List[np.ndarray], dtypes: List[str],
           keep: int) -> pathlib.Path:
    base = pathlib.Path(base)
    base.mkdir(parents=True, exist_ok=True)
    final = _ckpt_dir(base, step)
    tmp = base / f".tmp_{step}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    np.savez(tmp / "state.npz",
             **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    manifest = {
        "step": step,
        "num_leaves": len(arrays),
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": dtypes,
        "time": time.time(),
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _gc(base, keep)
    return final


def save(base, step: int, state, keep: int = 3) -> pathlib.Path:
    """Atomic synchronous save."""
    leaves = _leaves(state)
    return _write(base, step, [_host(x, copy=False) for x in leaves],
                  [_dtype_name(x) for x in leaves], keep)


def _gc(base: pathlib.Path, keep: int):
    steps = sorted(int(p.name.split("_")[1]) for p in base.glob("step_*"))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(_ckpt_dir(base, s), ignore_errors=True)


def latest_step(base) -> Optional[int]:
    """The newest step with a manifest (a finished save), or None."""
    base = pathlib.Path(base)
    if not base.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in base.glob("step_*")
                   if (p / "manifest.json").exists())
    return steps[-1] if steps else None


@torch.no_grad()
def restore(base, step: int, template):
    """Load checkpoint ``step`` into ``template`` (a state of the same
    structure) in place, each leaf on the template leaf's device, and
    return it.  Raises ``ValueError`` when the leaf counts or a leaf's
    shape differ (another config)."""
    d = _ckpt_dir(base, step)
    manifest = json.loads((d / "manifest.json").read_text())
    dst = _leaves(template)
    if len(dst) != manifest["num_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, template "
            f"{len(dst)} -- incompatible config")
    with np.load(d / "state.npz") as z:
        for i, (t, dt) in enumerate(zip(dst, manifest["dtypes"])):
            src = torch.from_numpy(z[f"leaf_{i}"])
            if dt == "bfloat16":
                src = src.view(torch.bfloat16)
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(
                    f"checkpoint leaf {i} has shape {tuple(src.shape)}, "
                    f"template {tuple(t.shape)} -- incompatible config")
            t.copy_(src)
    return template


class AsyncCheckpointer:
    """One-in-flight background saver."""

    def __init__(self, base, keep: int = 3):
        self.base = base
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, state):
        self.wait()
        # Copy to the host *before* handing over to the thread: the next
        # step updates the state in place.
        leaves = _leaves(state)
        arrays = [_host(x, copy=True) for x in leaves]
        # Non-daemon: an enqueued checkpoint survives an orderly crash (an
        # uncaught exception unwinding the trainer) -- interpreter shutdown
        # joins the writer, so restarts resume from the newest enqueued
        # step, not the previous one.
        self._thread = threading.Thread(
            target=_write, args=(self.base, step, arrays,
                                 [_dtype_name(x) for x in leaves],
                                 self.keep))
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
