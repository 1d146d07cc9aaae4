// Decode attention over a paged KV pool, with the per-page attention mass
// fused in: the Hopper (sm_90a) counterpart of the TPU kernel
// repro/kernels/paged_attention.py::paged_attention (body `_kernel`).
//
// What it computes, per row b (one decoding token):
//   out[b, h]   = softmax_t(q[b, h] . k[t] * scale) @ v[t] over the row's
//                 positions t in [max(0, len - window), len), read through
//                 the page table (page pi of the row lives in physical slot
//                 table[b, pi] of the pool [P, page, KV, D]); GQA maps head
//                 h to KV head h / (H / KV); softcap > 0 applies
//                 tanh(logit / softcap) * softcap.
//   mass[b, pi] = (1 / H) * sum_h (softmax mass of head h on page pi), the
//                 head-normalised per-page mass the Cori tiering loop reads.
//
// Bound on this card: bandwidth.  Per row it reads the live K and V pages
// once (2 * len * KV * D * sizeof(T) bytes) and does ~4 * len * H * D flops,
// about H / KV / sizeof(T) flops per byte -- far below the ~295 flops per
// byte where an H100 stops being memory-bound.
//
// Design (simple and right first; wgmma, TMA and a split over pages are
// later work):
//   * grid (B, KV): one block per (row, KV head), so a page's K/V is read
//     from device memory once for the whole GQA group of rep = H / KV query
//     heads, which stay in shared memory as float32;
//   * the block walks the row's logical pages in order, visiting only pages
//     that intersect [max(0, len - window), len) and whose table entry is a
//     valid slot (-1 padding and out-of-range slots are never dereferenced);
//     a row with len == 0 visits nothing and writes zeros.  Each visited
//     page's K and V rows are staged in shared memory first (all loads of a
//     page in flight together), then read from there by the logits (a warp
//     per token), the softmax (a warp per head) and the value update (a
//     thread per (head, dim));
//   * per head it keeps the online softmax (m, l, acc[D]) in float32 and
//     records each visited page's partial (m_page, s_page) -- the running
//     max after the page and the page's exp-sum under it -- into a float32
//     scratch [B, H, n];
//   * a second launch, grid B, turns the partials into the mass:
//     mass[b, pi] = sum_h s_page * exp(m_page - m_final) / l_final / H,
//     summing heads in a fixed order (deterministic, no atomics).  That is
//     the TPU kernel's per-page exp-sum carried under the same max
//     correction, rescaled once at the end instead of every page.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float s) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__device__ __forceinline__ float warp_max(float m) {
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// Logical pages [lo, hi) of a row that intersect its attended span.
__device__ __forceinline__ void visited_pages(int len, int window, int page,
                                              int n, int* lo, int* hi) {
  if (len <= 0) {
    *lo = 0;
    *hi = 0;
    return;
  }
  const int start = window > 0 ? max(0, len - window) : 0;
  *lo = start / page;
  *hi = min(n, (len + page - 1) / page);
}

template <typename T>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ table,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ m_page, float* __restrict__ s_page,
    float* __restrict__ m_final, float* __restrict__ l_final, int H, int KV,
    int D, int page, int n, int P, float scale, int window, float softcap) {
  const int b = blockIdx.x;
  const int g = blockIdx.y;  // KV head
  const int rep = H / KV;
  const int h0 = g * rep;    // first query head of the group
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                 // [rep, D]
  float* acc = q_s + rep * D;        // [rep, D]
  float* k_s = acc + rep * D;        // [page, D]: this page's keys
  float* v_s = k_s + page * D;       // [page, D]: this page's values
  float* p_s = v_s + page * D;       // [rep, page]: logits, then probs
  float* m_s = p_s + rep * page;     // [rep] running max
  float* l_s = m_s + rep;            // [rep] running exp-sum
  float* c_s = l_s + rep;            // [rep] this page's correction

  for (int i = tid; i < rep * D; i += nt) {
    q_s[i] = to_float(q[((size_t)b * H + h0) * D + i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rep; r += nt) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int len = lengths[b];
  int lo, hi;
  visited_pages(len, window, page, n, &lo, &hi);
  const int span_lo = window > 0 ? len - window : 0;
  const size_t kv_stride = (size_t)KV * D;  // one token row of a page

  for (int pi = lo; pi < hi; ++pi) {
    const int slot = table[b * n + pi];
    if (slot < 0 || slot >= P) continue;  // uniform across the block
    const size_t base = (size_t)slot * page * kv_stride + (size_t)g * D;

    // stage the page's K and V rows of this KV head: every thread issues
    // its loads before any is consumed, so they are all in flight at once
    for (int i = tid; i < page * D; i += nt) {
      const size_t at = base + (size_t)(i / D) * kv_stride + i % D;
      k_s[i] = to_float(k_pages[at]);
      v_s[i] = to_float(v_pages[at]);
    }
    __syncthreads();

    // logits: one warp per token, lanes split the head dim
    for (int t = warp; t < page; t += nwarps) {
      const int pos = pi * page + t;
      const bool valid = pos < len && pos >= span_lo;
      for (int r = 0; r < rep; ++r) {
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += q_s[r * D + d] * k_s[t * D + d];
        s = warp_sum(s);
        if (lane == 0) {
          float lg = s * scale;
          if (softcap > 0.f) lg = tanhf(lg / softcap) * softcap;
          p_s[r * page + t] = valid ? lg : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per head, lanes split the page's tokens
    for (int r = warp; r < rep; r += nwarps) {
      float* lg = p_s + r * page;
      float m_cur = -INFINITY;
      for (int t = lane; t < page; t += 32) m_cur = fmaxf(m_cur, lg[t]);
      m_cur = warp_max(m_cur);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, m_cur);
      // m_new == -inf: no valid token seen yet, so nothing to weigh
      const bool none = m_new == -INFINITY;
      float s = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = none ? 0.f : expf(lg[t] - m_new);
        lg[t] = p;
        s += p;
      }
      s = warp_sum(s);
      if (lane == 0) {
        const float corr = none ? 1.f : expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + s;
        c_s[r] = corr;
        const size_t o = ((size_t)b * H + h0 + r) * n + pi;
        m_page[o] = m_new;
        s_page[o] = s;
      }
    }
    __syncthreads();

    // acc[r, d] = acc[r, d] * corr[r] + sum_t p[r, t] * v[t, d]
    for (int i = tid; i < rep * D; i += nt) {
      const int r = i / D, d = i % D;
      float a = acc[i] * c_s[r];
      for (int t = 0; t < page; ++t) a += p_s[r * page + t] * v_s[t * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < rep * D; i += nt) {
    const int r = i / D;
    out[((size_t)b * H + h0) * D + i] =
        from_float<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
  for (int r = tid; r < rep; r += nt) {
    m_final[b * H + h0 + r] = m_s[r];
    l_final[b * H + h0 + r] = l_s[r];
  }
}

__global__ void page_mass_kernel(const int* __restrict__ table,
                                 const int* __restrict__ lengths,
                                 const float* __restrict__ m_page,
                                 const float* __restrict__ s_page,
                                 const float* __restrict__ m_final,
                                 const float* __restrict__ l_final,
                                 float* __restrict__ mass, int H, int n,
                                 int page, int P, int window) {
  const int b = blockIdx.x;
  int lo, hi;
  visited_pages(lengths[b], window, page, n, &lo, &hi);
  for (int pi = threadIdx.x; pi < n; pi += blockDim.x) {
    const int slot = table[b * n + pi];
    float total = 0.f;
    if (pi >= lo && pi < hi && slot >= 0 && slot < P) {
      for (int h = 0; h < H; ++h) {
        const size_t o = ((size_t)b * H + h) * n + pi;
        total += s_page[o] * expf(m_page[o] - m_final[b * H + h]) /
                 l_final[b * H + h];
      }
      total /= (float)H;
    }
    mass[b * n + pi] = total;
  }
}

constexpr int kThreads = 256;

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* table, const int* lengths, void* out,
                   float* mass, float* m_page, float* s_page, float* m_final,
                   float* l_final, int B, int H, int KV, int D, int page,
                   int n, int P, float scale, int window, float softcap,
                   cudaStream_t stream) {
  const int rep = H / KV;
  const size_t smem =
      sizeof(float) * (2 * (size_t)rep * D + 2 * (size_t)page * D +
                       (size_t)rep * page + 3 * (size_t)rep);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  paged_attention_kernel<T><<<dim3(B, KV), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), table, lengths, static_cast<T*>(out),
      m_page, s_page, m_final, l_final, H, KV, D, page, n, P, scale, window,
      softcap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  page_mass_kernel<<<B, 128, 0, stream>>>(table, lengths, m_page, s_page,
                                          m_final, l_final, mass, H, n, page,
                                          P, window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k_pages, v_pages and out share it).
extern "C" cudaError_t paged_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* lengths, void* out, void* mass,
    void* m_page, void* s_page, void* m_final, void* l_final, int B, int H,
    int KV, int D, int page, int n, int P, float scale, int window,
    float softcap, void* stream) {
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  float* ms = static_cast<float*>(mass);
  float* mp = static_cast<float*>(m_page);
  float* sp = static_cast<float*>(s_page);
  float* mf = static_cast<float*>(m_final);
  float* lf = static_cast<float*>(l_final);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, tb, ln, out, ms, mp, sp, mf, lf,
                         B, H, KV, D, page, n, P, scale, window, softcap, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tb, ln, out, ms, mp, sp,
                                 mf, lf, B, H, KV, D, page, n, P, scale,
                                 window, softcap, st);
  return cudaErrorInvalidValue;
}
