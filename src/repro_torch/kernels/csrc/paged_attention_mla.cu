// Absorbed-matrix MLA decode over compressed KV pages, with the per-page
// attention mass fused in: the Hopper (sm_90a) counterpart of the TPU kernel
// repro/kernels/paged_attention.py::paged_attention_mla (body `_mla_kernel`).
//
// What it computes, per row b (one decoding token):
//   ctx[b, h]   = softmax_t((q_abs[b, h] . ckv[t] + q_rope[b, h] . krope[t])
//                 * scale) @ ckv[t] over the row's positions t in [0, len),
//                 read through the page table (page pi of the row lives in
//                 physical slot table[b, pi] of the pools [P, page, R] and
//                 [P, page, K]).  The ckv rows are both keys and values and
//                 are shared by every head; the caller up-projects ctx with
//                 W_uv.
//   mass[b, pi] = (1 / H) * sum_h (softmax mass of head h on page pi), the
//                 head-normalised per-page mass the Cori tiering loop reads.
//
// Bound on this card: operations.  Per row it reads each live compressed
// row once (len * (R + K) * sizeof(T) bytes, shared by all H heads) and
// does 2 * len * H * (R + K + R) flops: at H = 128 that is ~128 / sizeof(T)
// flops per byte, so in float32 on CUDA cores (67 TFLOP/s) the arithmetic,
// not the 3.35 TB/s of HBM, sets the floor -- unlike the k/v kernel, whose
// K/V rows serve only one GQA group.
//
// Design (simple and right first; wgmma/mma, TMA and a split over pages
// are later work):
//   * the accumulator of all heads does not fit one block (128 heads x
//     R = 512 x 4 B = 256 KB > 227 KB), so the grid is (B, ceil(H / 8)):
//     one block per (row, group of up to 8 heads), whose queries and
//     accumulators [8, R] live in shared memory as float32;
//   * the block walks the row's logical pages in order, visiting only
//     pages that intersect [0, len) and whose table entry is a valid slot
//     (-1 padding and out-of-range slots are never dereferenced); a row
//     with len == 0 visits nothing and writes zeros.  A visited page's ckv
//     and krope rows are contiguous in the pools, so they are copied into
//     shared memory as they are (in T) with 16-byte cp.async, double
//     buffered: the next visited page's copy is in flight while the block
//     computes on the current one, and every head of the group reuses it;
//   * the two products are register-tiled over the group's 8 heads, so
//     each ckv/krope element read from shared memory feeds 8 FMAs in 8
//     independent chains: the logits take a warp per token (lanes split
//     the R + K dims, 8 head sums reduced by shuffles), the value update a
//     thread per column r (8 head accumulators over the page's tokens);
//     the online softmax takes a warp per head;
//   * per head it keeps the online softmax (m, l, acc[R]) in float32 and
//     records each visited page's partial (m_page, s_page) -- the running
//     max after the page and the page's exp-sum under it -- into a float32
//     scratch [B, H, n];
//   * the mass sums over heads, which now span blocks: a second launch,
//     grid B, computes mass[b, pi] = sum_h s_page * exp(m_page - m_final)
//     / l_final / H, summing heads in a fixed order (deterministic, no
//     atomics) -- the TPU kernel's per-page exp-sum carried under the same
//     max correction, rescaled once at the end instead of every page.
//
// The wrapper guarantees 16-byte aligned pools whose page rows are a
// multiple of 16 bytes (page * R * sizeof(T) and page * K * sizeof(T)).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr int kHeads = 8;     // heads per block
constexpr int kThreads = 256;

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

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory with the block's threads, asynchronously.
__device__ __forceinline__ void stage_async(void* dst, const void* src,
                                            int bytes) {
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  for (int o = threadIdx.x * 16; o < bytes; o += blockDim.x * 16) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(d + o));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
                 "l"(s + o)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void wait_async_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The first visited logical page >= pi of a row (hi when none is left).
__device__ __forceinline__ int next_page(const int* row_table, int pi, int hi,
                                         int P) {
  while (pi < hi && (row_table[pi] < 0 || row_table[pi] >= P)) ++pi;
  return pi;
}

template <typename T>
__global__ void paged_attention_mla_kernel(
    const T* __restrict__ q_abs, const T* __restrict__ q_rope,
    const T* __restrict__ ckv_pages, const T* __restrict__ krope_pages,
    const int* __restrict__ table, const int* __restrict__ lengths,
    T* __restrict__ out, float* __restrict__ m_page,
    float* __restrict__ s_page, float* __restrict__ m_final,
    float* __restrict__ l_final, int H, int R, int K, int page, int n, int P,
    float scale) {
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * kHeads;     // first head of the group
  const int hg = min(kHeads, H - h0);     // heads in this group
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int ckv_elems = page * R, kr_elems = page * K;

  // the cp.async buffers come first (16-byte aligned, sizes multiples of
  // 16 bytes), then the float32 state
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ckv_buf = reinterpret_cast<T*>(smem_raw);    // [2][page, R]
  T* kr_buf = ckv_buf + 2 * ckv_elems;            // [2][page, K]
  float* qa_s = reinterpret_cast<float*>(kr_buf + 2 * kr_elems);  // [8, R]
  float* qr_s = qa_s + kHeads * R;                // [8, K]
  float* acc = qr_s + kHeads * K;                 // [8, R]
  float* p_s = acc + kHeads * R;                  // [8, page] logits, probs
  float* m_s = p_s + kHeads * page;               // [8] running max
  float* l_s = m_s + kHeads;                      // [8] running exp-sum
  float* c_s = l_s + kHeads;                      // [8] page correction

  const int len = lengths[b];
  const int hi = len > 0 ? min(n, (len + page - 1) / page) : 0;
  const int* row_table = table + (size_t)b * n;

  // start the first page's copy before anything else
  int cur = next_page(row_table, 0, hi, P);
  if (cur < hi) {
    const size_t slot = row_table[cur];
    stage_async(ckv_buf, ckv_pages + slot * ckv_elems,
                ckv_elems * (int)sizeof(T));
    stage_async(kr_buf, krope_pages + slot * kr_elems,
                kr_elems * (int)sizeof(T));
  }
  commit_async();

  // heads past the group's end (a partial last group) hold zeros
  for (int i = tid; i < kHeads * R; i += nt) {
    const int h = i / R;
    qa_s[i] = h < hg ? to_float(q_abs[((size_t)b * H + h0) * R + i]) : 0.f;
    acc[i] = 0.f;
  }
  for (int i = tid; i < kHeads * K; i += nt) {
    const int h = i / K;
    qr_s[i] = h < hg ? to_float(q_rope[((size_t)b * H + h0) * K + i]) : 0.f;
  }
  for (int i = tid; i < kHeads * page; i += nt) p_s[i] = 0.f;
  for (int h = tid; h < kHeads; h += nt) {
    m_s[h] = -INFINITY;
    l_s[h] = 0.f;
    c_s[h] = 0.f;
  }
  __syncthreads();

  int buf = 0;
  while (cur < hi) {
    // prefetch the next visited page into the other buffer (an empty
    // group when there is none, so the wait below stays uniform)
    const int nxt = next_page(row_table, cur + 1, hi, P);
    if (nxt < hi) {
      const size_t slot = row_table[nxt];
      stage_async(ckv_buf + (buf ^ 1) * ckv_elems,
                  ckv_pages + slot * ckv_elems, ckv_elems * (int)sizeof(T));
      stage_async(kr_buf + (buf ^ 1) * kr_elems,
                  krope_pages + slot * kr_elems, kr_elems * (int)sizeof(T));
    }
    commit_async();
    wait_async_but_one();
    __syncthreads();
    const T* ckv_s = ckv_buf + buf * ckv_elems;
    const T* kr_s = kr_buf + buf * kr_elems;

    // logits: one warp per token, lanes split the R + K dims, one sum per
    // head of the group
    for (int t = warp; t < page; t += nwarps) {
      float s[kHeads];
#pragma unroll
      for (int h = 0; h < kHeads; ++h) s[h] = 0.f;
      for (int d = lane; d < R; d += 32) {
        const float kv = to_float(ckv_s[t * R + d]);
#pragma unroll
        for (int h = 0; h < kHeads; ++h) s[h] += qa_s[h * R + d] * kv;
      }
      for (int d = lane; d < K; d += 32) {
        const float kr = to_float(kr_s[t * K + d]);
#pragma unroll
        for (int h = 0; h < kHeads; ++h) s[h] += qr_s[h * K + d] * kr;
      }
      const bool valid = cur * page + t < len;
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        const float v = warp_sum(s[h]);
        if (lane == 0 && h < hg)
          p_s[h * page + t] = valid ? v * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: one warp per head, lanes split the page's tokens
    for (int h = warp; h < hg; h += nwarps) {
      float* lg = p_s + h * page;
      float m_cur = -INFINITY;
      for (int t = lane; t < page; t += 32) m_cur = fmaxf(m_cur, lg[t]);
      m_cur = warp_max(m_cur);
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, m_cur);
      // a visited page holds at least one valid token, so m_new is finite
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = expf(lg[t] - m_new);
        lg[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);  // 0 on the first page
        m_s[h] = m_new;
        l_s[h] = l_s[h] * corr + sum;
        c_s[h] = corr;
        const size_t o = ((size_t)b * H + h0 + h) * n + cur;
        m_page[o] = m_new;
        s_page[o] = sum;
      }
    }
    __syncthreads();

    // acc[h, r] = acc[h, r] * corr[h] + sum_t p[h, t] * ckv[t, r]: one
    // thread per column r, the group's heads in registers
    for (int d = tid; d < R; d += nt) {
      float a[kHeads];
#pragma unroll
      for (int h = 0; h < kHeads; ++h) a[h] = acc[h * R + d] * c_s[h];
      for (int t = 0; t < page; ++t) {
        const float kv = to_float(ckv_s[t * R + d]);
#pragma unroll
        for (int h = 0; h < kHeads; ++h) a[h] += p_s[h * page + t] * kv;
      }
#pragma unroll
      for (int h = 0; h < kHeads; ++h) acc[h * R + d] = a[h];
    }
    __syncthreads();   // the next iteration refills this buffer
    cur = nxt;
    buf ^= 1;
  }

  for (int i = tid; i < hg * R; i += nt) {
    const int h = i / R;
    out[((size_t)b * H + h0) * R + i] =
        from_float<T>(acc[i] / fmaxf(l_s[h], 1e-30f));
  }
  for (int h = tid; h < hg; h += nt) {
    m_final[b * H + h0 + h] = m_s[h];
    l_final[b * H + h0 + h] = l_s[h];
  }
}

__global__ void page_mass_kernel(const int* __restrict__ table,
                                 const int* __restrict__ lengths,
                                 const float* __restrict__ m_page,
                                 const float* __restrict__ s_page,
                                 const float* __restrict__ m_final,
                                 const float* __restrict__ l_final,
                                 float* __restrict__ mass, int H, int n,
                                 int page, int P) {
  const int b = blockIdx.x;
  const int len = lengths[b];
  const int hi = len > 0 ? min(n, (len + page - 1) / page) : 0;
  for (int pi = threadIdx.x; pi < n; pi += blockDim.x) {
    const int slot = table[b * n + pi];
    float total = 0.f;
    if (pi < hi && slot >= 0 && slot < P) {
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

template <typename T>
cudaError_t launch(const void* q_abs, const void* q_rope,
                   const void* ckv_pages, const void* krope_pages,
                   const int* table, const int* lengths, void* out,
                   float* mass, float* m_page, float* s_page, float* m_final,
                   float* l_final, int B, int H, int R, int K, int page,
                   int n, int P, float scale, cudaStream_t stream) {
  const size_t smem =
      2 * sizeof(T) * (size_t)page * (R + K) +
      sizeof(float) * (2 * (size_t)kHeads * R + (size_t)kHeads * K +
                       (size_t)kHeads * page + 3 * (size_t)kHeads);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_mla_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(B, (H + kHeads - 1) / kHeads);
  paged_attention_mla_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q_abs), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv_pages), static_cast<const T*>(krope_pages),
      table, lengths, static_cast<T*>(out), m_page, s_page, m_final, l_final,
      H, R, K, page, n, P, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  page_mass_kernel<<<B, 128, 0, stream>>>(table, lengths, m_page, s_page,
                                          m_final, l_final, mass, H, n, page,
                                          P);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q_abs, q_rope, ckv_pages, krope_pages
// and out share it).
extern "C" cudaError_t paged_attention_mla_launch(
    int dtype, const void* q_abs, const void* q_rope, const void* ckv_pages,
    const void* krope_pages, const void* table, const void* lengths,
    void* out, void* mass, void* m_page, void* s_page, void* m_final,
    void* l_final, int B, int H, int R, int K, int page, int n, int P,
    float scale, void* stream) {
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  float* ms = static_cast<float*>(mass);
  float* mp = static_cast<float*>(m_page);
  float* sp = static_cast<float*>(s_page);
  float* mf = static_cast<float*>(m_final);
  float* lf = static_cast<float*>(l_final);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q_abs, q_rope, ckv_pages, krope_pages, tb, ln, out,
                         ms, mp, sp, mf, lf, B, H, R, K, page, n, P, scale,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q_abs, q_rope, ckv_pages, krope_pages, tb,
                                 ln, out, ms, mp, sp, mf, lf, B, H, R, K,
                                 page, n, P, scale, st);
  return cudaErrorInvalidValue;
}
