"""Hold the flash kernel to other builds of it on one NVIDIA card, bit for
bit, and time them in turns.

    python3 scripts/flash_ab.py name=other.cu [name=other.cu ...]

Each ``name=other.cu`` (an earlier or an alternative
``csrc/flash_attention.cu``) is built with the port's flags into a
temporary directory, and each flash kernel instantiation's registers and
spills are printed from its ``-Xptxas -v`` report, beside this
checkout's.  A source whose C entry ``flash_attention_launch`` takes no
query offset (before it had one) runs only at ``q_offset = 0``.  Every
build runs beside this checkout's wrapper ("change") on the same inputs
at the head dims all of them take (16, 32, 64, 128, 256): the shapes the
served path gives the kernel (gemma3-12b's packed admissions, B=4 and 2,
S=T=2048, 16/8 heads of 256; musicgen-large's B=4, S=T=512, 32/32 heads
of 64; gemma3-12b's admission chunks, B=1, S=512 at starts 512 and 1536
and S=1 at 2047), and a grid over GQA, head dims, ragged lengths, S < T
and the masks, in float32 and bfloat16.  One line a case says whether
the outputs are bit-identical.  Then the builds run in turns -- the
others, change, change, the others in reverse -- at the main-path shape
(float32 and bfloat16, window 1024) and musicgen-large's prefill
(float32, causal), each timed a call (CUDA events) and on the device
(profiler), the L2 flushed before each call.  Prints the card's name and
power limit first; exits non-zero if any output differs in any bit.
"""
from __future__ import annotations

import ctypes
import math
import pathlib
import re
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# (B, S, T, H, KV, D, causal, window, q_offset); T = q_offset + S, or T > S
# with q_offset 0 (positions from 0 for both)
CASES = [(4, 2048, 2048, 16, 8, 256, True, 1024, 0),
         (4, 2048, 2048, 16, 8, 256, True, 0, 0),
         (2, 2048, 2048, 16, 8, 256, True, 1024, 0),
         (4, 512, 512, 32, 32, 64, True, 0, 0),
         (1, 512, 1024, 16, 8, 256, True, 1024, 512),
         (1, 512, 2048, 16, 8, 256, True, 1024, 1536),
         (1, 1, 2048, 16, 8, 256, True, 0, 2047),
         (2, 37, 37, 4, 2, 64, True, 0, 0), (2, 1, 1, 8, 1, 128, True, 0, 0),
         (2, 200, 200, 4, 4, 16, False, 0, 0),
         (2, 300, 300, 8, 2, 32, True, 64, 0),
         (1, 333, 333, 40, 8, 256, True, 0, 0),
         (2, 70, 300, 16, 8, 256, True, 0, 0),
         (1, 37, 100, 10, 2, 64, False, 16, 0),
         (2, 600, 600, 40, 8, 128, True, 1024, 0)]
# (label, B, S, H, KV, D, dtype, window) timed in turns
TIMED = [("main float32 window 1024", 4, 2048, 16, 8, 256, torch.float32,
          1024),
         ("main bfloat16 window 1024", 4, 2048, 16, 8, 256, torch.bfloat16,
          1024),
         ("musicgen-large prefill float32 causal", 4, 512, 32, 32, 64,
          torch.float32, 0)]


def _report(name: str, log: str) -> None:
    """Registers and spills of each flash kernel instantiation."""
    kernel = None
    for ln in log.splitlines():
        m = re.search(r"flash_attention_kernelI(13__nv_bfloat16|f)Li(\d+)E",
                      ln)
        if "Compiling entry function" in ln and m:
            kernel = ("bf16" if m.group(1) != "f" else "f32") \
                + f" D={m.group(2)}"
        elif kernel and ("spill" in ln or "Used" in ln):
            print(f"{name} {kernel}: {ln.split(':', 1)[-1].strip()}",
                  flush=True)
            if "Used" in ln:
                kernel = None


def _build_other(src: pathlib.Path, tmp: pathlib.Path, name: str):
    """A build's launcher ``(q, k, v, causal, window, q_offset) -> out``
    and whether it takes a query offset."""
    text = src.read_text()
    offset = re.search(r"flash_attention_launch\([^)]*q_off", text) \
        is not None
    lib = tmp / f"lib{name}.so"
    r = subprocess.run([_build._nvcc(), *fa.NVCC_FLAGS, "-o", str(lib),
                        str(src)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr[-3000:]}")
    _report(name, r.stdout + r.stderr)
    fn = ctypes.CDLL(str(lib)).flash_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_int] * (3 if offset else 2)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(q, k, v, causal=True, window=0, q_offset=0):
        b, s, h, d = q.shape
        out = torch.empty_like(q)
        tail = (int(causal), int(window)) + ((q_offset,) if offset else ())
        err = fn(fa._DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), b, s, k.shape[1], h,
                 k.shape[2], d, 1.0 / math.sqrt(d), *tail,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed, CUDA error {err}")
        return out
    return run, offset


def _inputs(b, s, t, h, kv, d, dtype, seed):
    g = torch.Generator(device=CS.DEV).manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=g,
                                   device=CS.DEV).to(dtype)
    return f(b, s, h, d), f(b, t, kv, d), f(b, t, kv, d)


def main() -> int:
    args = sys.argv[1:]
    if not torch.cuda.is_available() or not args \
            or any("=" not in a for a in args):
        print(__doc__)
        return 1
    resolve_device()
    CS.phase_device()
    fns = {"change": (fa.flash_attention, True)}
    fa._load()
    _report("change", _build._lib_path(fa.NAME, fa.NVCC_FLAGS)
            .with_suffix(".log").read_text())
    bad = total = 0
    with tempfile.TemporaryDirectory() as tmp:
        for a in args:
            name, path = a.split("=", 1)
            fns[name] = _build_other(pathlib.Path(path), pathlib.Path(tmp),
                                     name)
        others = [n for n in fns if n != "change"]
        for dtype in (torch.float32, torch.bfloat16):
            for b, s, t, h, kv, d, causal, window, off in CASES:
                q, k, v = _inputs(b, s, t, h, kv, d, dtype, s + h + d + off)
                kw = dict(causal=causal, window=window, q_offset=off)
                mine = fa.flash_attention(q, k, v, **kw)
                for name in others:
                    fn, has_off = fns[name]
                    if off and not has_off:
                        continue
                    got = fn(q, k, v, **kw)
                    torch.cuda.synchronize()
                    same = torch.equal(got.view(torch.int16 if dtype ==
                                                torch.bfloat16 else
                                                torch.int32),
                                       mine.view(torch.int16 if dtype ==
                                                 torch.bfloat16 else
                                                 torch.int32))
                    bad += not same
                    total += 1
                    print(f"{name} {str(dtype)[6:]} B={b} S={s} T={t} H={h} "
                          f"KV={kv} D={d} causal={causal} window={window} "
                          f"q_offset={off}: bit-identical to change {same}",
                          flush=True)
        print(f"{total - bad} of {total} cases bit-identical to change",
              flush=True)
        flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=CS.DEV)
        cases = {label: _inputs(b, s, s, h, kv, d, dtype, 7)
                 for label, b, s, h, kv, d, dtype, _ in TIMED}
        for name in others + ["change", "change"] + others[::-1]:
            fn = fns[name][0]
            for label, *_, window in TIMED:
                q, k, v = cases[label]
                call = lambda: fn(q, k, v, window=window)
                ms = CS._time(call, 20, flush)
                dev_ms, how, _ = CS._device_ms(call, 10, flush)
                print(f"A/B {name} {label}: {ms:.4f} ms a call, "
                      f"{dev_ms:.4f} on the device ({how})", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
