"""Builds the port's CUDA kernels from ``csrc/<name>.cu`` with ``nvcc``.

Each kernel is compiled for ``sm_90a`` into a shared library with a plain
C interface (bound with ``ctypes`` by its module), once per content of its
source and flags: the library is named after a hash of both and kept in
``build/`` beside this file (gitignored), with the compiler's
``-Xptxas -v`` report (registers, shared memory, spills) as ``<lib>.log``.
``build_many`` starts one ``nvcc`` per source at once and waits for all.

Beside the build, the wrappers' launch bookkeeping: ``scratch`` (a
wrapper's float32 scratch, cached per stream, or the capturing graph's)
and ``count_launch`` (the launch counters, which a CUDA graph's capture
does not move).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, List, Sequence, Tuple

import torch

__all__ = ["BASE_FLAGS", "build_many", "count_launch", "load", "scratch"]

_DIR = pathlib.Path(__file__).resolve().parent
CSRC = _DIR / "csrc"
BUILD = _DIR / "build"
# Flags every kernel takes; a kernel's module may append its own.
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_loaded: Dict[pathlib.Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source with the CUDA toolkit")


def _lib_path(name: str, flags: Sequence[str]) -> pathlib.Path:
    """Where the library for ``csrc/<name>.cu`` built with ``flags`` goes."""
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}_{tag}.so"


def build_many(specs: Sequence[Tuple[str, Sequence[str]]]
               ) -> List[pathlib.Path]:
    """Build every ``(name, flags)`` whose library is missing, one ``nvcc``
    process per source, all started together.  Returns the libraries'
    paths in the order given; raises if any compile fails."""
    libs = [_lib_path(name, flags) for name, flags in specs]
    jobs = []
    for (name, flags), lib in zip(specs, libs):
        if lib.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        src = CSRC / f"{name}.cu"
        proc = subprocess.Popen([_nvcc(), *flags, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((src, lib, tmp, proc))
    errors = []
    for src, lib, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {src.name}:\n{err}")
            continue
        lib.with_suffix(".log").write_text(out + err)
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def load(name: str, flags: Sequence[str]) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = build_many([(name, flags)])[0]
    if lib not in _loaded:
        _loaded[lib] = ctypes.CDLL(str(lib))
    return _loaded[lib]


def scratch(cache: Dict, need: int, device, zero: bool = False
            ) -> torch.Tensor:
    """A kernel's float32 scratch of at least ``need`` elements on
    ``device``.  Eager calls reuse one buffer per (device, stream) from
    ``cache``: a call reuses it only after the previous call on that
    stream (stream order), and an allocation costs host time on every
    decode layer.  Under CUDA graph capture every call allocates its own
    from the graph's private pool, so the graph owns it for as long as it
    replays, and no other graph or eager call can regrow or free it.
    ``zero``: a new buffer starts zeroed (under capture, by a fill the
    graph replays before each of its launches); a reused one holds what
    the last call on the stream left."""
    make = torch.zeros if zero else torch.empty
    if torch.cuda.is_current_stream_capturing():
        return make(need, dtype=torch.float32, device=device)
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = cache.get(key)
    if buf is None or buf.numel() < need:
        buf = cache[key] = make(need, dtype=torch.float32, device=device)
    return buf


def count_launch(fn) -> None:
    """One kernel launch by the wrapper ``fn``: ``fn.launches += 1``.
    Under CUDA graph capture nothing runs, so the call counts in
    ``fn.captured`` instead, and each replay of the graph adds its
    captured launches to ``fn.launches`` (``models.graphs``)."""
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1
    else:
        fn.launches += 1
