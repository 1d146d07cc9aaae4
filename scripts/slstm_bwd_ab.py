"""Time the sLSTM backward kernel against other builds of it in one
process on one NVIDIA card, at phase 48's shape (B = 4, S = 256, 4 heads
of 512, r_gates at fan-in hd), and split this checkout's kernel's
positions by ``clock64()`` stamps.

    python3 scripts/slstm_bwd_ab.py [--stamps] [--cluster] [name=other.cu ...]

Each ``name=other.cu`` (an earlier or an alternative
``csrc/slstm_scan.cu`` whose C entry ``slstm_scan_bwd_launch`` takes the
same arguments) is built with the port's flags into a temporary
directory and given a ring large enough for either form's.  The builds
run in turns with this checkout's wrapper ("change"): the others, change,
change, the others in reverse; each is timed a call (CUDA events) and on
the device (profiler), with the L2 flushed before each call, and its
gradients are compared with the first other's and with change's bits.
``--stamps``: a copy of this checkout's source with ``clock64()`` stamps
of thread 0 in the first and the last block at each position's stages
(start, own words summed, the two barriers, partials stored), in cycles
and in us at the rate the stamps span the kernel's device time.
``--cluster``: whether a cooperative launch takes a cluster dimension,
and how many blocks of the backward's 256 threads stay resident in
clusters of 1-8.  Prints the card's name and power limit first.
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
from repro_torch.kernels import slstm_scan as ss_  # noqa: E402

SRC = ROOT / "src/repro_torch/kernels/csrc/slstm_scan.cu"

STAMP_DEF = """__device__ long long g_stamp[2][1024][5];
#define STAMP(i) do { if (tid == 0 && b0 == 0 && tau < 1024 && \\
  (blockIdx.x == 0 || blockIdx.x == gridDim.x - 1)) \\
  g_stamp[blockIdx.x != 0][tau][i] = clock64(); } while (0)
"""
# (anchor in the source, the stamp put after it)
STAMPS = [("      const bool cell = tid < nb * kUnits;\n"
           "      const int rb = tid / kUnits, u = tid % kUnits;\n",
           "      STAMP(0);\n"),
          ("          red_s[lane * (kRows * kUnits) + o] = sum;\n        }\n"
           "      }\n", "      STAMP(1);\n"),
          ("      __syncthreads();          // red_s filled; dg_s free "
           "again\n", "      STAMP(2);\n"),
          ("      __syncthreads();          // dg_s filled; red_s free "
           "again\n", "      STAMP(3);\n"),
          ("          default: bwd_partials<8>(wv, dg_s, out, rstride, hd, "
           "tag); break;\n        }\n", "        STAMP(4);\n")]

CLUSTER = r"""
#include <cuda_runtime.h>
#include <cstdio>
__global__ void k(int* out) {
  extern __shared__ float s[];
  s[threadIdx.x] = 1.f;
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = (int)s[0];
}
int main() {
  // a block an SM, as the backward's 255 registers a thread force
  const int smem = 143360;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int* out;
  cudaMalloc(&out, 1024 * sizeof(int));
  for (int cs = 1; cs <= 8; cs *= 2) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(128);
    cfg.blockDim = dim3(256);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = -1;
    cudaError_t e = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
    cudaGetLastError();
    cfg.numAttrs = 2;
    cudaError_t l = cudaLaunchKernelEx(&cfg, k, out);
    cudaError_t sy = cudaDeviceSynchronize();
    cudaGetLastError();
    printf("cluster %d: %d clusters (%s), %d blocks resident; cooperative "
           "launch of 128 blocks: %s (sync %s)\n", cs, n,
           cudaGetErrorString(e), n * cs, cudaGetErrorString(l),
           cudaGetErrorString(sy));
  }
  return 0;
}
"""


def _build_lib(src: pathlib.Path, tmp: pathlib.Path, name: str):
    lib = tmp / f"lib{name}.so"
    r = subprocess.run([_build._nvcc(), *ss_.NVCC_FLAGS, "-o", str(lib),
                        str(src)], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr[-3000:]}")
    kernel, report = "?", []
    for ln in (r.stdout + r.stderr).splitlines():
        found = re.findall(r"slstm_(?:bwd|scan)_kernel", ln)
        if "Compiling entry function" in ln and found:
            kernel = found[-1]
        elif "Used" in ln or "spill" in ln:
            report.append(f"{kernel}: {ln.split(':', 1)[-1].strip()}")
    print(f"{name}: " + "; ".join(report), flush=True)
    out = ctypes.CDLL(str(lib))
    out.slstm_scan_bwd_launch.argtypes = [ctypes.c_void_p] * 14 \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    out.slstm_scan_bwd_launch.restype = ctypes.c_int
    return out


def _backward(lib, wx, r, c0, n0, m0, h0, hs, saves, dhs):
    """A build's backward, as the wrapper launches it: (dwx, dr)."""
    b, s, nh, _ = wx.shape
    hd = r.shape[1]
    dwx = torch.empty_like(wx)
    dc, dn, dm = (torch.zeros_like(c0) for _ in range(3))
    ring = torch.empty(max(4 * b * nh * (hd // 16) * hd, 16 * b * nh * hd),
                       device=wx.device)
    err = lib.slstm_scan_bwd_launch(
        r.data_ptr(), dhs.data_ptr(), *(t.data_ptr() for t in saves),
        c0.data_ptr(), n0.data_ptr(), m0.data_ptr(), dc.data_ptr(),
        dn.data_ptr(), dm.data_ptr(), dwx.data_ptr(), ring.data_ptr(), b, s,
        nh, hd, torch.cuda.current_stream(wx.device).cuda_stream)
    if err:
        raise RuntimeError(f"backward launch failed: CUDA error {err}")
    return dwx, ss_._dr(h0, hs, dwx)


def _timed(name, fn, flush):
    ms = CS._time(fn, 10, flush)
    dev_ms, how, names = CS._device_ms(fn, 10, flush)
    print(f"{name}: {ms:.4f} ms a call, {dev_ms:.4f} on the device ({how}: "
          f"{CS._ms_list(names)})", flush=True)
    return names.get("slstm_bwd_kernel", dev_ms)


def main() -> int:
    args = sys.argv[1:]
    if not torch.cuda.is_available() or any(
            a.startswith("-") and a not in ("--stamps", "--cluster")
            for a in args):
        print(__doc__)
        return 1
    others = dict(a.split("=", 1) for a in args if "=" in a)
    resolve_device()
    CS.phase_device()
    dev = CS.DEV
    b, s, nh, hd = CS.TRAIN_BATCH, CS.TRAIN_SEQ, CS.SLSTM_NH, CS.SLSTM_HD
    wx = CS._slstm_data(b, s, nh, hd, CS.SEED + 475)[0]
    r = CS._slstm_r(nh, hd, hd, CS.SEED + 476)
    st = CS._slstm_start(ss_, b, nh, hd, r, CS.SEED + 477, False)
    dh = torch.randn((b, s, nh, hd), generator=torch.Generator(
        device=dev).manual_seed(CS.SEED + 478), device=dev)
    (hs, *_), saves = CS._slstm_fwd_saved(ss_, wx, r, st, True)
    sb = (wx, r, *st, hs, saves, dh)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        fns = {name: (lambda lib=_build_lib(pathlib.Path(path), tmp, name):
                      _backward(lib, *sb))
               for name, path in others.items()}
        fns["change"] = lambda: ss_.slstm_scan_backward(*sb)[:2]
        first = next(iter(others), "change")
        mine, ref = fns["change"](), fns[first]()
        for name, fn in fns.items():
            got = fn()
            print(f"{name}: |x - {first}| " + ", ".join(
                f"{n} {float((x - y).abs().max()):.3g}"
                for n, x, y in zip(ss_.GRAD_NAMES, got, ref))
                + "; bit-equal to change " + str(all(
                    torch.equal(x.view(torch.int32), y.view(torch.int32))
                    for x, y in zip(got, mine))), flush=True)
        names = list(others)
        for name in names + ["change", "change"] + names[::-1]:
            _timed(f"A/B {name}", fns[name], flush)
        if "--stamps" in args:
            text = SRC.read_text().replace(
                "constexpr int kLanes = 4;",
                STAMP_DEF + "constexpr int kLanes = 4;", 1)
            for anchor, stamp in STAMPS:
                if text.count(anchor) != 1:
                    raise RuntimeError(f"no single stamp anchor: {anchor!r}")
                text = text.replace(anchor, anchor + stamp)
            text += ('\nextern "C" int slstm_stamps(void* out) {\n  return '
                     'static_cast<int>(cudaMemcpyFromSymbol(out, g_stamp, '
                     'sizeof(g_stamp)));\n}\n')
            (tmp / "stamps.cu").write_text(text)
            lib = _build_lib(tmp / "stamps.cu", tmp, "stamps")
            lib.slstm_stamps.argtypes = [ctypes.c_void_p]
            kern_ms = _timed("stamps", lambda: _backward(lib, *sb), flush)
            _backward(lib, *sb)
            torch.cuda.synchronize()
            raw = torch.zeros(2 * 1024 * 5, dtype=torch.int64)
            if lib.slstm_stamps(raw.data_ptr()):
                raise RuntimeError("reading the stamps failed")
            for blk, x in zip(("first", "last"),
                              raw.view(2, 1024, 5)[:, :s].double().numpy()):
                total = x[-1, 3] - x[0, 0]
                us = kern_ms * 1e3 / total
                print(f"stamps, {blk} block: {total / s:.0f} cycles a "
                      f"position ({1e-3 / us:.3f} GHz over the kernel)",
                      flush=True)
                for k, v in (("start -> own words summed", x[:, 1] - x[:, 0]),
                             ("-> barrier 1", x[:, 2] - x[:, 1]),
                             ("-> barrier 2 (the cell)", x[:, 3] - x[:, 2]),
                             ("-> partials stored", x[:-1, 4] - x[:-1, 3]),
                             ("-> next start", x[1:, 0] - x[:-1, 4])):
                    print(f"  {k}: median {np.median(v):.0f} cycles "
                          f"({np.median(v) * us:.3f} us), p10 "
                          f"{np.percentile(v, 10):.0f}, p90 "
                          f"{np.percentile(v, 90):.0f}", flush=True)
        if "--cluster" in args:
            (tmp / "cluster.cu").write_text(CLUSTER)
            subprocess.run([_build._nvcc(), "-gencode",
                            "arch=compute_90a,code=sm_90a", "-o",
                            str(tmp / "cluster"), str(tmp / "cluster.cu")],
                           check=True, capture_output=True)
            print(subprocess.run([str(tmp / "cluster")], capture_output=True,
                                 text=True, timeout=60).stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
