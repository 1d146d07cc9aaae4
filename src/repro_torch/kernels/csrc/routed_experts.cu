// The routed experts of a MoE layer's decode step, for Hopper.
//
// No TPU kernel stands behind it: the reference computes the MoE with
// einsums over every expert (repro/models/moe.py::moe_apply_dense, :85).
// What the port needs is a step it can capture in a CUDA graph, so the
// tokens are grouped by expert on the device, into arrays of fixed shape,
// and nothing is read back to the host.  One call is four launches on the
// caller's stream, over the T*k (token, expert) pairs of the route:
//
//   0. group (one block): sort the pairs by expert, stably (the rank of
//      pair p is the number of pairs with a smaller expert, plus those with
//      its expert and a smaller index), and write, at each sorted position
//      s, the pair it holds (pair_of[s]) and, where s leads a group (its
//      expert differs from position s-1's), the expert and the group's size
//      (g_expert[s], g_count[s]); positions inside a group hold -1 in both.
//      A token picks an expert at most once, so a group holds at most T
//      tokens.
//   1. gate/up, grid (f / 128 column tiles, T*k positions): a block at a
//      group's leader reads its expert's Wg and Wu column tiles once, over
//      all d rows, for every token of the group (8 a pass: a larger group
//      reads the tiles once per 8 tokens), and writes h = silu(g) * u for
//      each of the group's sorted positions; the other blocks exit.
//   2. down, grid (d / 128 column tiles, T*k positions): a leader block
//      reads Wo's column tile once, over f rows, and writes each pair's
//      unweighted output at its original index t*k + j.
//   3. combine, grid (d / 256, T): y[t] = sum over j = 0..k-1, in top-k
//      order as the reference's take_along_axis and sum, of w[t,j] * the
//      pair's output, with __fmul_rn / __fadd_rn so that no FMA changes
//      the bits against the plain version's mul and add.
//
// Every sum runs in a fixed order (no atomics), so two calls on the same
// inputs are bit-identical.
//
// What bounds it on an H100: bytes.  A decode step's few tokens make each
// weight element one or two FMAs per chosen token, so the time is the
// chosen experts' weights over the memory rate: at deepseek-v3's decode
// shape (4 tokens, top-8 of 256 experts of 7168 x 2048) ~31 distinct
// experts, 5.4 GB, 1.6 ms at 3.35 TB/s.  The design keeps that: each
// chosen expert's weights are read once, as 16-byte loads (a warp reads
// 512 contiguous bytes of a row), with 8 loads in flight a thread; a
// block's tokens sit in shared memory in chunks of 512 rows, so one float4
// of x serves four weight rows.  The products run on the CUDA cores in
// float32 (2 FMA a weight element at 8 tokens a pass: far below their
// rate); the 8 warps' partial sums meet in shared memory, in warp order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;       // output columns a block: 32 lanes x float4
constexpr int kTok = 8;          // tokens a pass
constexpr int kChunk = 512;      // input rows staged in shared memory a step
constexpr int kRows = 4;         // rows a warp takes a step (one float4 of x)
constexpr int kGroupThreads = 1024;
static_assert(kTok == kWarps, "a thread finishes one token's columns");

__global__ void __launch_bounds__(kGroupThreads)
routed_group_kernel(const int64_t* __restrict__ idx, int pairs,
                    int* __restrict__ g_expert, int* __restrict__ g_count,
                    int* __restrict__ pair_of) {
  extern __shared__ int e_s[];
  for (int p = threadIdx.x; p < pairs; p += blockDim.x)
    e_s[p] = static_cast<int>(idx[p]);
  __syncthreads();
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const int e = e_s[p];
    int less = 0, before = 0, same = 0;
    for (int q = 0; q < pairs; ++q) {
      const int eq = e_s[q];
      less += eq < e;
      same += eq == e;
      before += (eq == e) & (q < p);
    }
    const int s = less + before;
    pair_of[s] = p;
    g_expert[s] = before == 0 ? e : -1;
    g_count[s] = before == 0 ? same : -1;
  }
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& w) {
  acc.x += a * w.x;
  acc.y += a * w.y;
  acc.z += a * w.z;
  acc.w += a * w.w;
}

__device__ __forceinline__ float silu(float g) {
  return g / (1.0f + expf(-g));
}

// One block: the column tile blockIdx.x of the group that leads at sorted
// position blockIdx.y.  kGateUp: in = x [T, K=d] (the token of sorted
// position s is pair_of[s] / k), mats Wg, Wu [E, K, N=f], out = h [P, f] at
// the sorted position.  Otherwise: in = h [P, K=f] at the sorted position,
// mat Wo [E, K, N=d], out = y_pair [P, d] at the pair's original index.
template <bool kGateUp>
__global__ void __launch_bounds__(kThreads, 2)
routed_expert_kernel(const float* __restrict__ in,
                     const float* __restrict__ wa,
                     const float* __restrict__ wb, float* __restrict__ out,
                     const int* __restrict__ g_expert,
                     const int* __restrict__ g_count,
                     const int* __restrict__ pair_of, int k, int kdim,
                     int ndim, int experts) {
  // the staged inputs [kTok][kChunk], then the warps' partial sums
  // [kWarps][kTok][kCols]
  __shared__ __align__(16) float smem[kWarps * kTok * kCols];
  const int s = blockIdx.y;
  const int cnt = g_count[s];
  if (cnt <= 0) return;
  const int e = g_expert[s];
  const bool valid = e >= 0 && e < experts;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = blockIdx.x * kCols + lane * 4;
  const bool col_ok = col < ndim;
  const size_t mat = static_cast<size_t>(kdim) * ndim;
  const float* a = wa + (valid ? static_cast<size_t>(e) * mat : 0) + col;
  const float* b = kGateUp ? wb + (valid ? static_cast<size_t>(e) * mat : 0)
                                 + col
                           : nullptr;
  for (int t0 = 0; t0 < cnt; t0 += kTok) {
    const int nt = min(kTok, cnt - t0);
    float4 acc_a[kTok], acc_b[kTok];
#pragma unroll
    for (int t = 0; t < kTok; ++t) {
      acc_a[t] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc_b[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int r0 = 0; valid && r0 < kdim; r0 += kChunk) {
      const int rows = min(kChunk, kdim - r0);
      __syncthreads();
      for (int i = tid; i < kTok * (kChunk / 4); i += kThreads) {
        const int t = i / (kChunk / 4), c4 = (i % (kChunk / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < nt && c4 < rows) {
          const int sp = s + t0 + t;
          const size_t row = kGateUp ? pair_of[sp] / k : sp;
          v = *reinterpret_cast<const float4*>(in + row * kdim + r0 + c4);
        }
        *reinterpret_cast<float4*>(smem + t * kChunk + c4) = v;
      }
      __syncthreads();
      if (!col_ok) continue;
#pragma unroll 1
      for (int rr = warp * kRows; rr < rows; rr += kWarps * kRows) {
        const size_t off = static_cast<size_t>(r0 + rr) * ndim;
        float4 va[kRows], vb[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          va[j] = __ldg(reinterpret_cast<const float4*>(
              a + off + static_cast<size_t>(j) * ndim));
          if (kGateUp)
            vb[j] = __ldg(reinterpret_cast<const float4*>(
                b + off + static_cast<size_t>(j) * ndim));
        }
#pragma unroll
        for (int t = 0; t < kTok; ++t) {
          const float4 xv =
              *reinterpret_cast<const float4*>(smem + t * kChunk + rr);
          fma4(acc_a[t], xv.x, va[0]);
          fma4(acc_a[t], xv.y, va[1]);
          fma4(acc_a[t], xv.z, va[2]);
          fma4(acc_a[t], xv.w, va[3]);
          if (kGateUp) {
            fma4(acc_b[t], xv.x, vb[0]);
            fma4(acc_b[t], xv.y, vb[1]);
            fma4(acc_b[t], xv.z, vb[2]);
            fma4(acc_b[t], xv.w, vb[3]);
          }
        }
      }
    }
    // the warps' partial sums, added in warp order: thread tid finishes
    // token tid / 32 at columns (tid % 32) * 4 .. + 3 of the tile
    const int ot = tid >> 5, oc = lane * 4;
    float4 sum[2];
#pragma unroll
    for (int m = 0; m < (kGateUp ? 2 : 1); ++m) {
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kTok; ++t)
        *reinterpret_cast<float4*>(smem + (warp * kTok + t) * kCols + oc) =
            m == 0 ? acc_a[t] : acc_b[t];
      __syncthreads();
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float4 p = *reinterpret_cast<const float4*>(
            smem + (w * kTok + ot) * kCols + oc);
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
      sum[m] = v;
    }
    if (ot < nt && col_ok) {
      const int sp = s + t0 + ot;
      float4 r = sum[0];
      if (kGateUp) {
        const float4 u = sum[1];
        r = make_float4(silu(r.x) * u.x, silu(r.y) * u.y, silu(r.z) * u.z,
                        silu(r.w) * u.w);
      }
      const size_t row = kGateUp ? sp : pair_of[sp];
      *reinterpret_cast<float4*>(out + row * ndim + col) = r;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
routed_combine_kernel(const float* __restrict__ y_pair,
                      const float* __restrict__ w, float* __restrict__ y,
                      int k, int d) {
  const int t = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float acc = 0.f;
  for (int j = 0; j < k; ++j) {
    const size_t p = static_cast<size_t>(t) * k + j;
    acc = __fadd_rn(acc, __fmul_rn(w[p], y_pair[p * d + c]));
  }
  y[static_cast<size_t>(t) * d + c] = acc;
}

}  // namespace

// x f32 [T, d]; idx int64 [T, k]; w f32 [T, k]; wg, wu f32 [E, d, f];
// wo f32 [E, f, d]; y f32 [T, d].  Scratch: h f32 [T*k, f], y_pair f32
// [T*k, d], groups int32 [3, T*k].  Returns the first CUDA error, or 0.
extern "C" int routed_experts_launch(const void* x, const void* idx,
                                     const void* w, const void* wg,
                                     const void* wu, const void* wo, void* y,
                                     void* h, void* y_pair, void* groups,
                                     int t, int k, int d, int f, int experts,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int pairs = t * k;
  int* g_expert = static_cast<int*>(groups);
  int* g_count = g_expert + pairs;
  int* pair_of = g_count + pairs;
  const int gthreads = pairs < kGroupThreads ? ((pairs + 31) / 32) * 32
                                             : kGroupThreads;
  routed_group_kernel<<<1, gthreads, pairs * sizeof(int), stream>>>(
      static_cast<const int64_t*>(idx), pairs, g_expert, g_count, pair_of);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  routed_expert_kernel<true>
      <<<dim3((f + kCols - 1) / kCols, pairs), kThreads, 0, stream>>>(
          static_cast<const float*>(x), static_cast<const float*>(wg),
          static_cast<const float*>(wu), static_cast<float*>(h), g_expert,
          g_count, pair_of, k, d, f, experts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  routed_expert_kernel<false>
      <<<dim3((d + kCols - 1) / kCols, pairs), kThreads, 0, stream>>>(
          static_cast<const float*>(h), static_cast<const float*>(wo),
          nullptr, static_cast<float*>(y_pair), g_expert, g_count, pair_of,
          k, f, d, experts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  routed_combine_kernel<<<dim3((d + kThreads - 1) / kThreads, t), kThreads,
                          0, stream>>>(static_cast<const float*>(y_pair),
                                       static_cast<const float*>(w),
                                       static_cast<float*>(y), k, d);
  return static_cast<int>(cudaGetLastError());
}
