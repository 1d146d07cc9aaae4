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
// Bound on this card: bytes.  Per row it reads the live K and V rows once
// (2 * len * KV * D * sizeof(T) bytes) and does 4 * len * H * D flops: with
// H / KV = 5 in float32 that is 4 * 5 / (2 * 4) = 2.5 flops per byte, so at
// 3.35 TB/s the arithmetic needs ~8 TFLOP/s, 12% of the CUDA cores' 67.
// Tensor cores would buy nothing (and float32 would need 3xTF32).  What
// sets the time is how many bytes are in flight and how short each block's
// chain of dependent steps is: qwen3-14b's decode reads 21.6 MB (6.4 us at
// 3.35 TB/s) over B * KV = 32 (row, KV head) pairs, and one block per pair
// walking its pages one after another (this kernel's first version) left
// 100 of the 132 SMs idle and each page's loads exposed.
//
// Design:
//   * split over pages: the grid is (splits, KV * head groups, B).  Each
//     block takes a run of `pps` logical pages of one row and one KV head,
//     counted from the row's first visited page lo = max(0, len - window)
//     / page, so a windowed layer launches only the splits its span
//     (<= ceil(window / page) + 1 pages) can fill.  The host chooses pps
//     and splits from n, window, page, B and KV alone (no read of
//     `lengths`, which would cost a device sync per layer); a block whose
//     run lies past its row's last page writes neutral partials (m = -inf,
//     l = 0) and exits.  A page's K/V rows are read once for a group of
//     RB query heads: the GQA group, cut into equal groups of at most 5, 2
//     or 1 heads for D <= 128, 256, 512 (one group at every served shape);
//   * loads in flight: the block's valid pages stream through a ring of
//     2-4 page stages in shared memory (~64 KB), filled with 16-byte
//     cp.async (a warp per token row, a lane per 16-byte piece; bfloat16
//     converted when read), so the next pages' copies are in flight while
//     the current page is computed, with one barrier per page (the ring's:
//     the stage refilled is the one every warp just left);
//   * within a page each warp owns 4 tokens at a time, 8 lanes a token:
//     lanes split the head dim for q . k (q held in registers, 3 shuffles
//     reduce a head's dot product), then each warp keeps its own online
//     softmax (m, l, acc) per head in registers, acc split over the lanes
//     by head dim, so no block-wide barrier stands between the logits, the
//     softmax and the value update of a page.  RB is a compile-time count
//     and a pass has no branch (loads predicated, -inf handled by selects),
//     so every step runs for all heads at once and their latencies
//     overlap: runtime head guards had serialised the heads and cost 2x.
//     Each warp records its per-page exp-sum under its running max; at the
//     end the block merges its warps in a fixed order into (m, l, acc[D])
//     per head and the page sums s_page[pi] under the block's m;
//   * a second launch combines the splits, deterministically and without
//     atomics: grid (H + 1, B); block (h, b) merges head h's splits in
//     split order, m_f = max_s m_s, l_f = sum_s l_s exp(m_s - m_f), out =
//     sum_s acc_s exp(m_s - m_f) / max(l_f, 1e-30), with empty splits (m_s
//     = -inf) weighing 0, so a length-0 row gives zeros and no NaN; block
//     (H, b) writes the mass, mass[b, pi] = sum_h s_page exp(m_s(pi) -
//     m_f) / l_f / H (heads summed in groups of 8, the groups in order),
//     zero outside the visited span and on -1 / out-of-range slots (never
//     dereferenced).
//
// Left for a later pass: a block still spends most of its time in a
// serial chain (its table and q loads, the first page's arrival, then
// each page's softmax); TMA copies with mbarriers in place of cp.async,
// persistent blocks that keep the ring full across splits, and fusing
// the combine into the first launch through a last-block-per-row counter
// (the second launch costs ~6 us at qwen3-14b's shape).
//
// The wrapper guarantees 16-byte aligned pools and rows of a multiple of 16
// bytes (D * sizeof(T)), D <= 512, and provides the float32 scratch:
// part_acc [B, H, splits, D], part_m / part_l [B, H, splits], s_page
// [B, H, n].
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 8;                     // lanes per token (logits)
constexpr int kTokensPerWarp = 32 / kGroup;   // tokens per warp per pass
constexpr int kTokensPerPass = kWarps * kTokensPerWarp;
constexpr int kRingBytes = 64 * 1024;         // target ring size
constexpr int kCombineThreads = 256;
constexpr int kMassPages = 256;        // pages per pass of the mass block

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

// four consecutive elements as float32 (16-byte / 8-byte aligned reads)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 c =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, c.x, c.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until the oldest page of a ring of `stages` has landed: at most
// stages - 2 committed groups may still be in flight
__device__ __forceinline__ void wait_oldest(int stages) {
  if (stages == 2)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (stages == 3)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// Logical pages [lo, hi) of a row that intersect its attended span.
__host__ __device__ __forceinline__ void visited_pages(int len, int window,
                                                       int page, int n,
                                                       int* lo, int* hi) {
  if (len <= 0) {
    *lo = 0;
    *hi = 0;
    return;
  }
  const int start = window > 0 ? (len - window > 0 ? len - window : 0) : 0;
  const int end = (len + page - 1) / page;
  *lo = start / page;
  *hi = n < end ? n : end;
}

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// What both launches read: the inputs, outputs and float32 scratch, the
// shapes, and the split (pps pages a split, `splits` of them; hg head
// groups of RB heads per KV head; a ring of `stages` pages).
struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* table;
  const int* lengths;
  void* out;
  float* mass;
  float* part_acc;   // [B, H, splits, D]
  float* part_m;     // [B, H, splits]
  float* part_l;     // [B, H, splits]
  float* s_page;     // [B, H, n]
  int B, H, KV, D, page, n, P;
  float scale;
  int window;
  float softcap;
  int pps, splits, hg, stages;
};

// Byte offsets of the split kernel's shared memory.  The ring (stages x
// [K page | V page] in T) is reused after the page loop for the warps'
// accumulators [warps, RB, D].
struct Layout {
  size_t q, st_m, st_s, mg_m, mg_l, mg_e, slot, pi, count, total;
};

__host__ __device__ __forceinline__ Layout layout(int stages, int page,
                                                  int D, int elem, int RB,
                                                  int pps) {
  Layout L;
  const size_t ring = (size_t)stages * 2 * page * D * elem;
  const size_t merge = (size_t)kWarps * RB * D * sizeof(float);
  const size_t per_warp = (size_t)kWarps * RB * sizeof(float);
  L.q = align16(ring > merge ? ring : merge);
  L.st_m = align16(L.q + (size_t)RB * D * sizeof(float));
  L.st_s = L.st_m + pps * per_warp;
  L.mg_m = L.st_s + pps * per_warp;
  L.mg_l = L.mg_m + per_warp;
  L.mg_e = L.mg_l + per_warp;
  L.slot = align16(L.mg_e + per_warp);
  L.pi = L.slot + (size_t)pps * sizeof(int);
  L.count = L.pi + (size_t)pps * sizeof(int);
  L.total = align16(L.count + sizeof(int));
  return L;
}

// One block per (split, KV head x head group, row).  NCH = ceil(D / 128):
// 16-byte head-dim chunks per lane in the value update.  RB: the query
// heads of the block, a compile-time count (<= 5 / NCH rounded down, 1 at
// least, so q and the accumulators fit the registers) -- with it every
// per-head loop unrolls without guards and the heads' loads, products and
// shuffles interleave instead of running one head after another.
template <typename T, int NCH, int RB>
__global__ void __launch_bounds__(kThreads)
    paged_attention_split_kernel(const Params p) {
  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k_pages = static_cast<const T*>(p.k_pages);
  const T* __restrict__ v_pages = static_cast<const T*>(p.v_pages);
  const int H = p.H, KV = p.KV, D = p.D, page = p.page, n = p.n;
  const int pps = p.pps, splits = p.splits, stages = p.stages;
  const int s = blockIdx.x;
  const int g = blockIdx.y / p.hg;               // KV head
  const int h0 = g * (H / KV) + (blockIdx.y % p.hg) * RB;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int len = p.lengths[b];
  int lo, hi;
  visited_pages(len, p.window, page, n, &lo, &hi);
  const int p0 = lo + s * pps;
  const int p1 = min(hi, p0 + pps);
  // head r's partial of this split sits at part + r * splits
  const size_t part = ((size_t)b * H + h0) * splits + s;
  if (p0 >= p1) {                                // nothing of the row here
    if (tid < RB) {
      p.part_m[part + (size_t)tid * splits] = -INFINITY;
      p.part_l[part + (size_t)tid * splits] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(stages, page, D, (int)sizeof(T), RB, pps);
  T* ring = reinterpret_cast<T*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + L.q);      // [RB, D]
  float* st_m = reinterpret_cast<float*>(smem + L.st_m);  // [pps, warps, RB]
  float* st_s = reinterpret_cast<float*>(smem + L.st_s);
  int* slots = reinterpret_cast<int*>(smem + L.slot);     // [pps]
  int* pis = reinterpret_cast<int*>(smem + L.pi);         // [pps]
  int* count_s = reinterpret_cast<int*>(smem + L.count);

  // the run's pages with a valid slot, in order (-1 padding and slots out
  // of range are never dereferenced)
  if (warp == 0) {
    int cnt = 0;
    for (int base = p0; base < p1; base += 32) {
      const int pi = base + lane;
      const int slot = pi < p1 ? p.table[(size_t)b * n + pi] : -1;
      const bool ok = slot >= 0 && slot < p.P;
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        const int at = cnt + __popc(m & ((1u << lane) - 1u));
        slots[at] = slot;
        pis[at] = pi;
      }
      cnt += __popc(m);
    }
    if (lane == 0) *count_s = cnt;
  }
  for (int i = tid; i < RB * D; i += kThreads)
    q_s[i] = to_float(q[((size_t)b * H + h0) * D + i]);
  for (int i = tid; i < pps * kWarps * RB; i += kThreads) {
    st_m[i] = -INFINITY;
    st_s[i] = 0.f;
  }
  __syncthreads();
  const int count = *count_s;

  // copy valid page k of the run into its ring stage: page rows of this KV
  // head are D * sizeof(T) contiguous bytes at a stride of KV * D elements
  const int pieces = D * (int)sizeof(T) / 16;
  const size_t stage_elems = 2 * (size_t)page * D;
  auto stage_page = [&](int k) {
    char* ks = reinterpret_cast<char*>(ring + (k % stages) * stage_elems);
    char* vs = ks + (size_t)page * D * sizeof(T);
    const size_t base = ((size_t)slots[k] * page * KV + g) * D;
    // a warp per token row, a lane per 16-byte piece of it
    for (int t = warp; t < page; t += kWarps) {
      const char* kr = reinterpret_cast<const char*>(
          k_pages + base + (size_t)t * KV * D);
      const char* vr = reinterpret_cast<const char*>(
          v_pages + base + (size_t)t * KV * D);
      const size_t row = (size_t)t * D * sizeof(T);
      for (int c = lane; c < pieces; c += 32) {
        cp_async16(ks + row + c * 16, kr + c * 16);
        cp_async16(vs + row + c * 16, vr + c * 16);
      }
    }
  };
  for (int k = 0; k < stages - 1; ++k) {
    if (k < count) stage_page(k);
    commit_async();
  }

  float m_w[RB], l_w[RB], acc[RB][NCH][4];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m_w[r] = -INFINITY;
    l_w[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      acc[r][c][0] = acc[r][c][1] = acc[r][c][2] = acc[r][c][3] = 0.f;
  }
  const int gi = lane / kGroup, j = lane % kGroup;
  const int nchunk = D / 4;
  // this lane's q chunks c = j + kGroup * i of every head, in registers
  constexpr int KCH = 128 * NCH / 4 / kGroup;
  float4 qr[RB][KCH];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int i = 0; i < KCH; ++i) {
      const int c = j + kGroup * i;
      qr[r][i] = c < nchunk ? *reinterpret_cast<const float4*>(
                                  q_s + r * D + c * 4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  const int span_lo = p.window > 0 ? len - p.window : 0;
  const float scale = p.scale, softcap = p.softcap;

  for (int k = 0; k < count; ++k) {
    wait_oldest(stages);
    __syncthreads();   // page k visible; every warp is done with page k - 1
    if (k + stages - 1 < count) stage_page(k + stages - 1);
    commit_async();
    const T* ks = ring + (k % stages) * stage_elems;
    const T* vs = ks + (size_t)page * D;
    const int pi = pis[k];

    float ps[RB];      // this warp's exp-sum of the page under m_w
#pragma unroll
    for (int r = 0; r < RB; ++r) ps[r] = 0.f;
    for (int t0 = warp * kTokensPerWarp; t0 < page; t0 += kTokensPerPass) {
      // branch-free from here to the end of the pass (loads predicated),
      // each step taken for every head at once, so the heads' products,
      // shuffles and exponentials interleave
      const int t = t0 + gi;
      const bool in_page = t < page;
      float dot[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) dot[r] = 0.f;
#pragma unroll
      for (int i = 0; i < KCH; ++i) {
        const int c = j + kGroup * i;
        const float4 kk = in_page && c < nchunk
                              ? load4(ks + (size_t)t * D + c * 4)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < RB; ++r) dot[r] += dot4(kk, qr[r][i]);
      }
#pragma unroll
      for (int o = 1; o < kGroup; o <<= 1)
#pragma unroll
        for (int r = 0; r < RB; ++r)
          dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
      const int pos = pi * page + t;
      const bool valid = in_page && pos < len && pos >= span_lo;
      float lg[RB], mx[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) lg[r] = dot[r] * scale;
      if (softcap > 0.f) {
#pragma unroll
        for (int r = 0; r < RB; ++r) lg[r] = tanhf(lg[r] / softcap) * softcap;
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) mx[r] = lg[r] = valid ? lg[r] : -INFINITY;
      // the max over the warp's tokens of this pass (one per kGroup lanes)
#pragma unroll
      for (int o = kGroup; o < 32; o <<= 1)
#pragma unroll
        for (int r = 0; r < RB; ++r)
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], o));
      float p_t[RB], corr[RB], sum[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float m_new = fmaxf(m_w[r], mx[r]);
        // m_new == -inf: no valid token seen yet, so nothing to weigh
        // (corr = exp(0) = 1, p = exp(-inf) = 0; selects, not branches)
        const bool none = m_new == -INFINITY;
        corr[r] = expf(none ? 0.f : m_w[r] - m_new);
        sum[r] = p_t[r] = expf(none ? -INFINITY : lg[r] - m_new);
        m_w[r] = m_new;
      }
#pragma unroll
      for (int o = kGroup; o < 32; o <<= 1)
#pragma unroll
        for (int r = 0; r < RB; ++r)
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], o);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        l_w[r] = l_w[r] * corr[r] + sum[r];
        ps[r] = ps[r] * corr[r] + sum[r];
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          acc[r][c][0] *= corr[r];
          acc[r][c][1] *= corr[r];
          acc[r][c][2] *= corr[r];
          acc[r][c][3] *= corr[r];
        }
      }
      // acc[r] += p[r, t] * v[t] over the pass's tokens; lanes split D (a
      // token past the page has p = 0 and reads no value)
#pragma unroll
      for (int tt = 0; tt < kTokensPerWarp; ++tt) {
        const int tv = t0 + tt;
        float pt[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r)
          pt[r] = __shfl_sync(0xffffffffu, p_t[r], tt * kGroup);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int ch = lane + 32 * c;
          const float4 vv = tv < page && ch < nchunk
                                ? load4(vs + (size_t)tv * D + ch * 4)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            acc[r][c][0] += pt[r] * vv.x;
            acc[r][c][1] += pt[r] * vv.y;
            acc[r][c][2] += pt[r] * vv.z;
            acc[r][c][3] += pt[r] * vv.w;
          }
        }
      }
    }
    if (lane < RB) {   // lane r records head r (registers indexed by unroll)
      const int at = ((pi - p0) * kWarps + warp) * RB + lane;
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r == lane) {
          st_m[at] = m_w[r];
          st_s[at] = ps[r];
        }
    }
  }

  // merge the warps, in warp order, through the ring's memory: the block's
  // max m_b per head, each warp's scale e_w = exp(m_w - m_b) (0 for a warp
  // that saw no valid token), then acc, l and the page sums under m_b
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  float* mg_acc = reinterpret_cast<float*>(smem);              // [W, RB, D]
  float* mg_m = reinterpret_cast<float*>(smem + L.mg_m);       // [W, RB]
  float* mg_l = reinterpret_cast<float*>(smem + L.mg_l);
  float* mg_e = reinterpret_cast<float*>(smem + L.mg_e);
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    float* row = mg_acc + ((size_t)warp * RB + r) * D;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int ch = lane + 32 * c;
      if (ch < nchunk)
        *reinterpret_cast<float4*>(row + ch * 4) =
            make_float4(acc[r][c][0], acc[r][c][1], acc[r][c][2],
                        acc[r][c][3]);
    }
    if (lane == r) {
      mg_m[warp * RB + r] = m_w[r];
      mg_l[warp * RB + r] = l_w[r];
    }
  }
  __syncthreads();
  if (tid < RB) {
    const int r = tid;
    float mb = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, mg_m[w * RB + r]);
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float mw = mg_m[w * RB + r];
      const float e = mw == -INFINITY ? 0.f : expf(mw - mb);
      mg_e[w * RB + r] = e;
      l += mg_l[w * RB + r] * e;
    }
    p.part_m[part + (size_t)r * splits] = mb;
    p.part_l[part + (size_t)r * splits] = l;
    // the page sums reuse mg_m for m_b (read below after the barrier)
    mg_m[r] = mb;
  }
  __syncthreads();
  for (int i = tid; i < RB * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    float a = 0.f;
    for (int w = 0; w < kWarps; ++w)
      a += mg_acc[((size_t)w * RB + r) * D + d] * mg_e[w * RB + r];
    p.part_acc[(part + (size_t)r * splits) * D + d] = a;
  }
  // each page's exp-sum under the block's max (0 on pages with no slot)
  for (int i = tid; i < (p1 - p0) * RB; i += kThreads) {
    const int kl = i / RB, r = i - kl * RB;
    const float mb = mg_m[r];
    float sp = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const int at = (kl * kWarps + w) * RB + r;
      if (st_s[at] > 0.f) sp += st_s[at] * expf(st_m[at] - mb);
    }
    p.s_page[((size_t)b * H + h0 + r) * n + p0 + kl] = sp;
  }
}

// Split weights of one head, by one thread, in split order: w[s] =
// exp(m_s - m_f) / max(l_f, 1e-30), 0 for an empty split (m_s = -inf),
// written over m.
__device__ __forceinline__ void split_weights(float* m, const float* l,
                                              int splits) {
  float mf = -INFINITY;
  for (int s = 0; s < splits; ++s) mf = fmaxf(mf, m[s]);
  float lf = 0.f;
  for (int s = 0; s < splits; ++s)
    lf += m[s] == -INFINITY ? 0.f : l[s] * expf(m[s] - mf);
  const float inv = 1.f / fmaxf(lf, 1e-30f);
  for (int s = 0; s < splits; ++s)
    m[s] = m[s] == -INFINITY ? 0.f : expf(m[s] - mf) * inv;
}

// Block (h, b), h < H: head h's output from its splits.  Block (H, b): the
// row's page mass.  Each reads its heads' (m_s, l_s) into shared memory in
// one sweep and turns them into split weights (split_weights, a thread per
// head).  A weight of 0 masks its term (an empty split's accumulator is
// never written); every sum runs in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    paged_attention_combine_kernel(const Params p) {
  extern __shared__ float w_s[];   // [heads, splits] m, then w; l; partials
  const int H = p.H, D = p.D, n = p.n, splits = p.splits;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const bool mass_block = blockIdx.x == H;
  const int h0 = mass_block ? 0 : blockIdx.x;
  const int nh = mass_block ? H : 1;
  float* l_s = w_s + (size_t)nh * splits;
  const size_t base = ((size_t)b * H + h0) * splits;
  for (int i = tid; i < nh * splits; i += kCombineThreads) {
    w_s[i] = p.part_m[base + i];
    l_s[i] = p.part_l[base + i];
  }
  __syncthreads();
  for (int h = tid; h < nh; h += kCombineThreads)
    split_weights(w_s + (size_t)h * splits, l_s + (size_t)h * splits,
                  splits);
  __syncthreads();
  if (!mass_block) {
    const float* acc = p.part_acc + base * D;
    for (int d = tid; d < D; d += kCombineThreads) {
      float o = 0.f;
#pragma unroll 16
      for (int s = 0; s < splits; ++s) {
        const float a = acc[(size_t)s * D + d];
        o += w_s[s] != 0.f ? a * w_s[s] : 0.f;
      }
      static_cast<T*>(p.out)[((size_t)b * H + h0) * D + d] =
          from_float<T>(o);
    }
    return;
  }
  // mass[b, pi] = sum_h s_page[h, pi] w[h, s(pi)] / H: a thread per (page,
  // group of 8 heads), then a thread per page sums the groups in order
  int lo, hi;
  visited_pages(p.lengths[b], p.window, p.page, n, &lo, &hi);
  const int groups = (H + 7) / 8;
  const int chunk = min(n, kMassPages);
  float* part = l_s + (size_t)H * splits;   // [groups, chunk]
  for (int c0 = 0; c0 < n; c0 += chunk) {
    for (int i = tid; i < groups * chunk; i += kCombineThreads) {
      const int gr = i / chunk, pi = c0 + i % chunk;
      float sum = 0.f;
      if (pi < n && pi >= lo && pi < hi) {
        const int s = (pi - lo) / p.pps;
        float sp[8], w[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {   // the group's loads all in flight
          const int h = gr * 8 + k;
          w[k] = h < H ? w_s[(size_t)h * splits + s] : 0.f;
          sp[k] = h < H ? p.s_page[((size_t)b * H + h) * n + pi] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) sum += w[k] != 0.f ? sp[k] * w[k] : 0.f;
      }
      part[i] = sum;
    }
    __syncthreads();
    for (int i = tid; i < chunk && c0 + i < n; i += kCombineThreads) {
      const int pi = c0 + i;
      const int slot = p.table[(size_t)b * n + pi];
      float total = 0.f;
      if (pi >= lo && pi < hi && slot >= 0 && slot < p.P) {
        for (int gr = 0; gr < groups; ++gr) total += part[gr * chunk + i];
        total /= (float)H;
      }
      p.mass[(size_t)b * n + pi] = total;
    }
    __syncthreads();
  }
}

// Raise a kernel's dynamic shared memory limit to `bytes` on the current
// device, calling the runtime only when the limit last set there (one
// record per kernel and device) is lower: host calls cost time on every
// decode layer.
template <auto kernel>
cudaError_t raise_smem(size_t bytes) {
  constexpr int kDevices = 16;
  static size_t set[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (bytes <= 48 * 1024 || (dev < kDevices && bytes <= set[dev]))
    return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < kDevices) set[dev] = bytes;
  return e;
}

template <typename T, int NCH, int RB>
cudaError_t launch(const Params& prm, cudaStream_t stream) {
  const size_t smem =
      layout(prm.stages, prm.page, prm.D, (int)sizeof(T), RB, prm.pps).total;
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t e = raise_smem<paged_attention_split_kernel<T, NCH, RB>>(smem);
  if (e != cudaSuccess) return e;
  paged_attention_split_kernel<T, NCH, RB>
      <<<dim3(prm.splits, prm.KV * prm.hg, prm.B), kThreads, smem, stream>>>(
          prm);
  return cudaGetLastError();
}

// the split kernel's instance for the block's exact head count rb
template <typename T, int NCH, int RB>
cudaError_t launch_rb(int rb, const Params& prm, cudaStream_t stream) {
  if (rb == RB) return launch<T, NCH, RB>(prm, stream);
  if constexpr (RB > 1) return launch_rb<T, NCH, RB - 1>(rb, prm, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_all(Params prm, cudaStream_t stream) {
  const int nch = (prm.D + 127) / 128;
  const int rb_max = nch == 1 ? 5 : nch == 2 ? 2 : 1;
  // head groups: the fewest that split the GQA group evenly into at most
  // rb_max heads each
  const int rep = prm.H / prm.KV;
  int hg = (rep + rb_max - 1) / rb_max;
  while (rep % hg) ++hg;
  const int rb = rep / hg;
  prm.hg = hg;
  const int stage_bytes = 2 * prm.page * prm.D * (int)sizeof(T);
  int stages = kRingBytes / stage_bytes;
  stages = stages > 4 ? 4 : stages;
  stages = stages > prm.pps ? prm.pps : stages;
  prm.stages = stages < 2 ? 2 : stages;
  cudaError_t e;
  if (nch == 1)
    e = launch_rb<T, 1, 5>(rb, prm, stream);
  else if (nch == 2)
    e = launch_rb<T, 2, 2>(rb, prm, stream);
  else if (nch <= 4)
    e = launch_rb<T, 4, 1>(rb, prm, stream);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  const size_t csmem = (2 * (size_t)prm.H * prm.splits +
                        (size_t)((prm.H + 7) / 8) * kMassPages) *
                       sizeof(float);
  if (csmem > 232448) return cudaErrorInvalidValue;
  e = raise_smem<paged_attention_combine_kernel<T>>(csmem);
  if (e != cudaSuccess) return e;
  paged_attention_combine_kernel<T>
      <<<dim3(prm.H + 1, prm.B), kCombineThreads, csmem, stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k_pages, v_pages and out share it).
extern "C" cudaError_t paged_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const void* table, const void* lengths, void* out, void* mass,
    void* part_acc, void* part_m, void* part_l, void* s_page, int B, int H,
    int KV, int D, int page, int n, int P, float scale, int window,
    float softcap, int pps, int splits, void* stream) {
  Params prm{q,
             k_pages,
             v_pages,
             static_cast<const int*>(table),
             static_cast<const int*>(lengths),
             out,
             static_cast<float*>(mass),
             static_cast<float*>(part_acc),
             static_cast<float*>(part_m),
             static_cast<float*>(part_l),
             static_cast<float*>(s_page),
             B, H, KV, D, page, n, P, scale, window, softcap, pps, splits,
             1, 2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_all<float>(prm, st);
  if (dtype == 1) return launch_all<__nv_bfloat16>(prm, st);
  return cudaErrorInvalidValue;
}
