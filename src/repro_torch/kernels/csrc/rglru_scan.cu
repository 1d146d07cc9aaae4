// The RG-LRU's gates and linear recurrence over a sequence, for Hopper.
//
// No Pallas kernel stands behind it: the reference runs the recurrence
// h_t = a_t h_{t-1} + b_t as a log-depth lax.associative_scan
// (repro/models/recurrent.py::rglru_apply, :326) and one update for a
// decode token (::rglru_step, :337-338).  The port's plain version is a
// Hillis-Steele scan, log2(S) rounds of torch.cat over [B, S, w], after
// some eight full passes of elementwise gates.  This kernel fuses the
// gates into a chunked scan that reads each input once a pass.
//
// Per row b, channel c and position t (rglru_scan.py, ``rglru_gates``):
//
//   log_a = (-8 softplus(lam_c)) sigmoid(ra);  a = exp(log_a)
//   b_t   = sqrt(max(1 - exp(2 log_a), 1e-6)) (sigmoid(ia) xc)
//   h_t   = a h_{t-1} + b_t,  h_{-1} = h0
//
// (products and sums rounded on their own: __fmul_rn / __fadd_rn).
//
// Two passes over chunks of kChunk positions; a thread a (row, channel,
// chunk), so B = 1 at w = 2560 and S = 2600 gives 20 x 41 blocks of 128.
//   1. summary (every chunk but the last): the chunk's product of a and
//      its scan from h = 0, to a scratch [2, B, chunks - 1, w];
//   2. apply: the carry into the chunk, from h0 through the summaries of
//      the chunks before it in order, then the chunk's scan from it,
//      writing h.
// S <= kChunk (every decode step) is the apply pass alone.  Within a
// thread the inputs of the coming positions are loaded while the serial
// multiply-add chain runs (the loop is unrolled).
//
// What bounds it on an H100: bytes.  ra, ia and xc read and h written once
// (4 x 26.6 MB at recurrentgemma-2b's B = 1, S = 2600, w = 2560: 32 us at
// 3.35 TB/s); the two passes read the inputs twice (186 MB).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;
constexpr int kThreads = 128;

struct Gates {
  float a, b;
};

// -8 softplus(lam), as F.softplus (threshold 20) and the plain version's
// product order
__device__ __forceinline__ float neg_c_softplus(float lam) {
  const float sp = lam > 20.f ? lam : log1pf(expf(lam));
  return __fmul_rn(-8.f, sp);
}

__device__ __forceinline__ Gates gates(float ra, float ia, float xc,
                                       float ncs) {
  const float rg = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-ra)));
  const float ig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-ia)));
  const float log_a = __fmul_rn(ncs, rg);
  const float beta =
      sqrtf(fmaxf(__fsub_rn(1.f, expf(__fmul_rn(2.f, log_a))), 1e-6f));
  return {expf(log_a), __fmul_rn(beta, __fmul_rn(ig, xc))};
}

__global__ void __launch_bounds__(kThreads)
rglru_summary_kernel(const float* __restrict__ ra,
                     const float* __restrict__ ia,
                     const float* __restrict__ xc,
                     const float* __restrict__ lam,
                     float* __restrict__ summary, int seq, int w) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  if (ch >= w) return;
  const int chunk = blockIdx.y, b = blockIdx.z;
  const int chunks1 = gridDim.y;             // the chunks but the last
  const float ncs = neg_c_softplus(lam[ch]);
  const size_t base = (static_cast<size_t>(b) * seq + chunk * kChunk) * w +
                      ch;
  float prod = 1.f, h = 0.f;
#pragma unroll 8
  for (int t = 0; t < kChunk; ++t) {
    const size_t at = base + static_cast<size_t>(t) * w;
    const Gates g = gates(ra[at], ia[at], xc[at], ncs);
    h = __fadd_rn(__fmul_rn(g.a, h), g.b);
    prod = __fmul_rn(prod, g.a);
  }
  const size_t out = (static_cast<size_t>(b) * chunks1 + chunk) * w + ch;
  const size_t half = static_cast<size_t>(gridDim.z) * chunks1 * w;
  summary[out] = prod;
  summary[half + out] = h;
}

__global__ void __launch_bounds__(kThreads)
rglru_apply_kernel(const float* __restrict__ ra, const float* __restrict__ ia,
                   const float* __restrict__ xc,
                   const float* __restrict__ lam,
                   const float* __restrict__ h0,
                   const float* __restrict__ summary, float* __restrict__ hs,
                   int seq, int w) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  if (ch >= w) return;
  const int chunk = blockIdx.y, b = blockIdx.z;
  const int chunks1 = gridDim.y - 1;
  float h = h0[static_cast<size_t>(b) * w + ch];
  if (chunk > 0) {
    const size_t half = static_cast<size_t>(gridDim.z) * chunks1 * w;
#pragma unroll 8
    for (int c = 0; c < chunk; ++c) {
      const size_t at = (static_cast<size_t>(b) * chunks1 + c) * w + ch;
      h = __fadd_rn(__fmul_rn(summary[at], h), summary[half + at]);
    }
  }
  const float ncs = neg_c_softplus(lam[ch]);
  const int t0 = chunk * kChunk;
  const int len = min(kChunk, seq - t0);
  const size_t base = (static_cast<size_t>(b) * seq + t0) * w + ch;
#pragma unroll 8
  for (int t = 0; t < len; ++t) {
    const size_t at = base + static_cast<size_t>(t) * w;
    const Gates g = gates(ra[at], ia[at], xc[at], ncs);
    h = __fadd_rn(__fmul_rn(g.a, h), g.b);
    hs[at] = h;
  }
}

}  // namespace

// ra, ia, xc f32 [B, S, w]; lam f32 [w]; h0 f32 [B, w]; hs f32 [B, S, w];
// summary: scratch of 2 x B x (ceil(S / 64) - 1) x w floats, null when S
// <= 64.  Returns the launches' CUDA error, or 0.
extern "C" int rglru_scan_launch(const void* ra, const void* ia,
                                 const void* xc, const void* lam,
                                 const void* h0, void* hs, void* summary,
                                 int batch, int seq, int w,
                                 void* stream_ptr) {
  const int chunks = (seq + kChunk - 1) / kChunk;
  if (batch <= 0 || seq <= 0 || w <= 0 || batch > 65535 ||
      (chunks > 1 && summary == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (w + kThreads - 1) / kThreads;
  auto* ra_ = static_cast<const float*>(ra);
  auto* ia_ = static_cast<const float*>(ia);
  auto* xc_ = static_cast<const float*>(xc);
  auto* lam_ = static_cast<const float*>(lam);
  auto* sum_ = static_cast<float*>(summary);
  if (chunks > 1) {
    rglru_summary_kernel<<<dim3(blocks, chunks - 1, batch), kThreads, 0,
                           stream>>>(ra_, ia_, xc_, lam_, sum_, seq, w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rglru_apply_kernel<<<dim3(blocks, chunks, batch), kThreads, 0, stream>>>(
      ra_, ia_, xc_, lam_, static_cast<const float*>(h0), sum_,
      static_cast<float*>(hs), seq, w);
  return static_cast<int>(cudaGetLastError());
}
