"""Time the RG-LRU backward kernel against other builds of it in one
process on one NVIDIA card, at phase 49's four cases (recurrentgemma-2b's
lru_width 2560: B = 4, S = 256 from the zero state and a carried h,
B = 4, S = 40, B = 2, S = 300), and compare their gradients bit for bit.

    python3 scripts/rglru_bwd_ab.py [--stamps] [name=other.cu ...]

Each ``name=other.cu`` (an earlier or an alternative
``csrc/rglru_scan.cu`` whose C entry ``rglru_scan_bwd_launch`` takes the
same arguments and the same scratch) is built with the port's flags into
a temporary directory, its compiler report (registers, spills) printed.
Per case, every build's five gradients (dra, dia, dxc, dlam, dh0) are
compared with the first other's and with this checkout's wrapper's
("change") bits.  Then the builds run in turns -- the others, change,
change, the others in reverse -- each timed a call (CUDA events) and on
the device (profiler) at every case, with the L2 flushed before each
call.  Prints the card's name and power limit first, and the tiles an SM
of each build's S > 64 kernel (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``;
a source without ``rglru_scan_bwd_blocks_per_sm`` gets one appended).
``--stamps``: a copy of this checkout's source with ``%globaltimer``
stamps of thread 0 in every tile of the S > 64 kernel at its steps'
boundaries (start, a and dh loaded, the scan done, the gradients
stored, dlam's partial stored), at B = 4, S = 256: each step's median,
p10 and p90 in us, and when the tiles start and end from the first
start.
"""
from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rglru_scan as rg_  # noqa: E402

OCCUPANCY = r"""
extern "C" int rglru_scan_bwd_blocks_per_sm(int vec) {
  auto kernel = vec ? rglru_bwd_kernel<4> : rglru_bwd_kernel<1>;
  int n = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kBwdSmem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                    kBwdSmem) != cudaSuccess)
    return -1;
  return n;
}
"""


STAMP_DEF = """__device__ unsigned long long g_stamp[4096][5];
#define STAMP(i) do { if (threadIdx.x == 0 && tile < 4096) { \\
  unsigned long long now_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now_)); \\
  g_stamp[tile][i] = now_; } } while (0)
"""
# (anchor in the source, the text put in its place)
STAMPS = [("  // 1. a and dh of the tile\n",
           "  STAMP(0);\n  // 1. a and dh of the tile\n"),
          ("  __syncthreads();\n\n  const int lane = tid % kStrip;\n"
           "  const int c = c0 + lane;\n  if (tid < kStrip) {\n",
           "  __syncthreads();\n  STAMP(1);\n\n  const int lane = tid % "
           "kStrip;\n  const int c = c0 + lane;\n  if (tid < kStrip) {\n"),
          ("  // 4. every element's gradients from its g\n",
           "  STAMP(2);\n  // 4. every element's gradients from its g\n"),
          ("  // 5. dlam's partial of the tile\n",
           "  STAMP(3);\n  // 5. dlam's partial of the tile\n"),
          ("  if (tid == 0)\n    s_last = last_arrival(ctrs + strip, tag,",
           "  STAMP(4);\n  if (tid == 0)\n    s_last = last_arrival(ctrs + "
           "strip, tag,")]
STEPS = ("a and dh loaded", "the scan (carry included)",
         "the gradients stored", "dlam's partial")


def _report(name: str, log: str) -> None:
    """The backward kernels' registers, shared memory and spills from a
    build's ``-Xptxas -v`` report."""
    kernel, report = "?", []
    for ln in log.splitlines():
        found = re.findall(r"rglru_\w*kernel(?:ILi\d)?", ln)
        if "Compiling entry function" in ln and found:
            kernel = found[-1]
        elif ("Used" in ln or "spill" in ln) and "bwd" in kernel:
            report.append(f"{kernel}: {ln.split(':', 1)[-1].strip()}")
    print(f"{name}: " + "; ".join(report), flush=True)


def _build_lib(src: pathlib.Path, tmp: pathlib.Path, name: str):
    text = src.read_text()
    if "rglru_scan_bwd_blocks_per_sm" not in text:
        text += OCCUPANCY
    cu = tmp / f"{name}.cu"
    cu.write_text(text)
    lib = tmp / f"lib{name}.so"
    r = subprocess.run([_build._nvcc(), *rg_.NVCC_FLAGS, "-o", str(lib),
                        str(cu)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr[-3000:]}")
    _report(name, r.stdout + r.stderr)
    out = ctypes.CDLL(str(lib))
    out.rglru_scan_bwd_launch.argtypes = [ctypes.c_void_p] * 14 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out.rglru_scan_bwd_launch.restype = ctypes.c_int
    out.rglru_scan_bwd_blocks_per_sm.argtypes = [ctypes.c_int]
    out.rglru_scan_bwd_blocks_per_sm.restype = ctypes.c_int
    return out


def _launcher(lib, need: int, parts: int):
    """A build's backward as the wrapper launches it, over a scratch of
    its own kept between calls (zeroed once) and dlam's partials."""
    scratch = torch.zeros(need, device=CS.DEV)
    part = torch.empty(parts, device=CS.DEV)

    def run(ra, ia, xc, lam, h0, h, dh):
        b, s, w = ra.shape
        dra, dia, dxc = (torch.empty_like(ra) for _ in range(3))
        dlam, dh0 = torch.empty_like(lam), torch.empty_like(h0)
        err = lib.rglru_scan_bwd_launch(
            *(t.data_ptr() for t in (ra, ia, xc, lam, h0, h, dh, dra, dia,
                                     dxc, dlam, dh0, scratch, part)),
            b, s, w, torch.cuda.current_stream(ra.device).cuda_stream)
        if err:
            raise RuntimeError(f"backward launch failed: CUDA error {err}")
        return dra, dia, dxc, dlam, dh0
    return run


def _cases():
    """Phase 49's cases as ``chip_smoke._rglru_bwd_case`` draws them."""
    out = []
    for i, (b, s, carried) in enumerate(CS.RGLRU_BWD_CASES):
        seed = CS.SEED + 490 + i
        args = list(CS._rglru_data(b, s, CS.RGLRU_W, seed))
        if not carried:
            args[4].zero_()
        dh = torch.randn((b, s, CS.RGLRU_W), device=CS.DEV,
                         generator=torch.Generator(device=CS.DEV)
                         .manual_seed(seed))
        label = f"B={b} S={s}{' carried' if carried else ''}"
        out.append((label, (*args, rg_.rglru_scan(*args), dh)))
    return out


def main() -> int:
    args = sys.argv[1:]
    if not torch.cuda.is_available() or any(
            "=" not in a and a != "--stamps" for a in args):
        print(__doc__)
        return 1
    others = dict(a.split("=", 1) for a in args if "=" in a)
    resolve_device()
    CS.phase_device()
    cases = _cases()
    plans = [rg_.backward_plan(*c[0].shape) for _, c in cases]
    need = max(p["scratch"] for p in plans)
    parts = max(p["partials"] for p in plans)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=CS.DEV)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        libs = {name: _build_lib(pathlib.Path(path), tmp, name)
                for name, path in others.items()}
        libs["change"] = rg_._load()
        _report("change", _build._lib_path(rg_.NAME, rg_.NVCC_FLAGS)
                .with_suffix(".log").read_text())
        for name, lib in libs.items():
            print(f"{name}: {lib.rglru_scan_bwd_blocks_per_sm(1)} tiles an "
                  f"SM (16-byte form), {lib.rglru_scan_bwd_blocks_per_sm(0)} "
                  "(scalar form)", flush=True)
        fns = {name: _launcher(lib, need, parts)
               for name, lib in libs.items() if name != "change"}
        fns["change"] = rg_.rglru_scan_backward
        first = next(iter(others), "change")
        same = True
        for label, case in cases:
            mine, ref = fns["change"](*case), fns[first](*case)
            for name, fn in fns.items():
                got = fn(*case)
                bits = [torch.equal(x.view(torch.int32), y.view(torch.int32))
                        for x, y in zip(got, mine)]
                same &= all(bits)
                print(f"{label} {name}: |x - {first}| " + ", ".join(
                    f"{n} {float((x - y).abs().max()):.3g}"
                    for n, x, y in zip(rg_.GRAD_NAMES, got, ref))
                    + "; bit-identical to change: " + ", ".join(
                        f"{n} {e}" for n, e in zip(rg_.GRAD_NAMES, bits)),
                    flush=True)
        print(f"every build bit-identical to change at every case: {same}",
              flush=True)
        names = list(others)
        for name in names + ["change", "change"] + names[::-1]:
            for label, case in cases:
                fn = lambda f=fns[name], c=case: f(*c)
                ms = CS._time(fn, 30, flush)
                dev_ms, how, split = CS._device_ms(fn, 30, flush)
                kern = split.get("rglru_bwd_kernel",
                                 split.get("rglru_bwd_short_kernel", dev_ms))
                print(f"A/B {name} {label}: {ms:.4f} ms a call, "
                      f"{kern:.4f} on the device ({how}: "
                      f"{CS._ms_list(split)})", flush=True)
        if "--stamps" in args:
            _stamps(tmp, cases[0], need, parts, flush)
    return 0


def _stamps(tmp, case, need, parts, flush) -> None:
    """``--stamps`` (module docstring) on ``case``."""
    text = (ROOT / "src/repro_torch/kernels/csrc/rglru_scan.cu").read_text()
    text = text.replace("namespace {\n", STAMP_DEF + "namespace {\n", 1)
    for anchor, put in STAMPS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"no single stamp anchor: {anchor!r}")
        text = text.replace(anchor, put)
    text += ('\nextern "C" int rglru_stamps(void* out) {\n  return '
             'static_cast<int>(cudaMemcpyFromSymbol(out, g_stamp, '
             'sizeof(g_stamp)));\n}\n')
    (tmp / "stamps.src").write_text(text)
    lib = _build_lib(tmp / "stamps.src", tmp, "stamps")
    lib.rglru_stamps.argtypes = [ctypes.c_void_p]
    label, args = case
    run = _launcher(lib, need, parts)
    fn = lambda: run(*args)
    dev_ms, _, split = CS._device_ms(fn, 30, flush)
    flush.zero_()
    fn()
    torch.cuda.synchronize()
    raw = torch.zeros(4096 * 5, dtype=torch.int64)
    if lib.rglru_stamps(raw.data_ptr()):
        raise RuntimeError("reading the stamps failed")
    tiles = rg_.backward_plan(*args[0].shape)["blocks"]
    x = raw.view(4096, 5)[:tiles].double().numpy() / 1e3      # us
    x -= x[:, 0].min()
    kern_us = split.get("rglru_bwd_kernel", dev_ms) * 1e3
    print(f"stamps {label}: the kernel {kern_us:.2f} us on the device; "
          f"{tiles} tiles from the "
          f"first start: the last starts at {x[:, 0].max():.2f} us, the "
          f"first ends at {x[:, 4].min():.2f}, the last at "
          f"{x[:, 4].max():.2f}", flush=True)
    for k, step in enumerate(STEPS):
        d = x[:, k + 1] - x[:, k]
        print(f"  {step}: median {np.median(d):.2f} us, p10 "
              f"{np.percentile(d, 10):.2f}, p90 {np.percentile(d, 90):.2f}; "
              f"the last tile there at {x[:, k + 1].max():.2f}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
