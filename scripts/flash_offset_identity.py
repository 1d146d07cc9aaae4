"""Hold the flash kernel at ``q_offset = 0`` to a build of the kernel from
before the query offset, bit for bit, on one NVIDIA card.

    python3 scripts/flash_offset_identity.py <earlier flash_attention.cu>

The earlier source's C entry ``flash_attention_launch`` takes no query
offset.  It is built with the port's flags into a temporary directory
and run beside this checkout's kernel (``q_offset=0``) on the same
inputs: the shapes the served path gives the kernel (gemma3-12b's packed
admissions, B=4 and 2, S=T=2048, 16/8 heads of 256; musicgen-large's
B=4, S=T=512, 32/32 heads of 64) and a grid over GQA, head dims, ragged
lengths, S < T and the masks, in float32 and bfloat16.  Prints one line a
case and exits non-zero if any output differs in any bit.
"""
from __future__ import annotations

import ctypes
import math
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# (B, S, T, H, KV, D, causal, window)
CASES = [(4, 2048, 2048, 16, 8, 256, True, 1024),
         (4, 2048, 2048, 16, 8, 256, True, 0),
         (2, 2048, 2048, 16, 8, 256, True, 1024),
         (4, 512, 512, 32, 32, 64, True, 0),
         (2, 37, 37, 4, 2, 64, True, 0), (2, 1, 1, 8, 1, 128, True, 0),
         (2, 200, 200, 4, 4, 16, False, 0),
         (2, 300, 300, 8, 2, 32, True, 64),
         (1, 333, 333, 40, 8, 256, True, 0),
         (2, 70, 300, 16, 8, 256, True, 0),
         (1, 37, 100, 10, 2, 64, False, 16)]


def _earlier(src: pathlib.Path, out: pathlib.Path):
    lib = out / "libflash_attention_earlier.so"
    subprocess.run([_build._nvcc(), *fa.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).flash_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__)
        return 1
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        earlier = _earlier(pathlib.Path(sys.argv[1]), pathlib.Path(tmp))
        bad = 0
        for dtype in (torch.float32, torch.bfloat16):
            for b, s, t, h, kv, d, causal, window in CASES:
                g = torch.Generator(device=dev).manual_seed(s + h + d)
                f = lambda *shape: torch.randn(shape, generator=g,
                                               device=dev).to(dtype)
                q, k, v = f(b, s, h, d), f(b, t, kv, d), f(b, t, kv, d)
                new = fa.flash_attention(q, k, v, causal=causal,
                                         window=window, q_offset=0)
                old = torch.empty_like(q)
                err = earlier(fa._DTYPES[dtype], q.data_ptr(), k.data_ptr(),
                              v.data_ptr(), old.data_ptr(), b, s, t, h, kv,
                              d, 1.0 / math.sqrt(d), int(causal),
                              int(window),
                              torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                same = err == 0 and torch.equal(new, old)
                bad += not same
                print(f"{str(dtype)[6:]} B={b} S={s} T={t} H={h} KV={kv} "
                      f"D={d} causal={causal} window={window}: "
                      f"bit-identical {same}", flush=True)
    print(f"{2 * len(CASES) - bad} of {2 * len(CASES)} cases bit-identical "
          f"to the kernel without the offset", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
