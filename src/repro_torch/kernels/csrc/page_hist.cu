// Per-period page-access histogram with the EMA hotness update, for Hopper.
//
// Replaces the TPU kernel repro/kernels/page_hist.py::page_hist (Pallas body
// `_kernel`).  That kernel counts ids with a [TILE, P] compare matrix on the
// VPU because TPUs have no fast scatter; on Hopper a histogram is what shared
// memory atomics are for.  One CTA per row of ids:
//
//   1. zero a shared-memory histogram of n unsigned counters;
//   2. each thread adds its ids with integer atomicAdd (ids < 0 or >= n are
//      ignored, as the Pallas kernel's padded lanes are), so the counts are
//      exact whatever order the atomics land in;
//   3. write counts (as float32), new_hot = alpha*counts + beta*hot and the
//      mask new_hot >= threshold for every page, coalesced.
//
// `beta` is (1 - alpha) rounded to float32 by the caller.  The multiplies and
// the add use __fmul_rn/__fadd_rn so no FMA contraction changes the bits
// against the plain PyTorch version.
//
// What bounds it on an H100: bytes.  The outputs (rows x n x 9 bytes) dwarf
// the ids; the per-element arithmetic is three flops.  Shared memory holds the
// histogram, so the wrapper limits n to MAX_PAGES (57,344 counters, 224 KB).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
page_hist_kernel(const int* __restrict__ ids, const float* __restrict__ hot,
                 float* __restrict__ counts, float* __restrict__ new_hot,
                 uint8_t* __restrict__ mask, int p, int n, float alpha,
                 float beta, float threshold) {
  extern __shared__ unsigned int hist[];
  const int tid = threadIdx.x;
  for (int j = tid; j < n; j += kThreads) hist[j] = 0u;
  __syncthreads();
  const int* row = ids + static_cast<size_t>(blockIdx.x) * p;
  for (int j = tid; j < p; j += kThreads) {
    const int id = row[j];
    if (id >= 0 && id < n) atomicAdd(&hist[id], 1u);
  }
  __syncthreads();
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  for (int j = tid; j < n; j += kThreads) {
    const float c = static_cast<float>(hist[j]);
    const float h = __fadd_rn(__fmul_rn(alpha, c), __fmul_rn(beta, hot[j]));
    counts[base + j] = c;
    new_hot[base + j] = h;
    mask[base + j] = h >= threshold ? 1 : 0;
  }
}

}  // namespace

extern "C" int page_hist_launch(const void* ids, const void* hot,
                                void* counts, void* new_hot, void* mask,
                                int rows, int p, int n, float alpha,
                                float beta, float threshold, void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(unsigned int);
  cudaError_t err = cudaFuncSetAttribute(
      page_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  page_hist_kernel<<<rows, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(hot),
      static_cast<float*>(counts), static_cast<float*>(new_hot),
      static_cast<uint8_t*>(mask), p, n, alpha, beta, threshold);
  return static_cast<int>(cudaGetLastError());
}
