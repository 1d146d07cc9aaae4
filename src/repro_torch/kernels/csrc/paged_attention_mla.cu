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
// Bound on this card: operations, on the tensor cores.  Per row it reads
// each live compressed row once (len * (R + K) * sizeof(T) bytes, shared by
// all H heads) and does 2 * len * H * (R + K + R) flops: at H = 128 the two
// products are real matrix products, [H, R + K] x [R + K, len] for the
// logits and [H, len] x [len, R] for the context, ~128 / sizeof(T) flops a
// byte.  float32 runs each product as 3xTF32 (3x the flops at 495 TFLOP/s;
// mma.sync itself reaches ~280 TFLOP/s of TF32 on an H100, PERF.md),
// bfloat16 in one pass; the 3.35 TB/s of HBM is not the limit.
//
// Design (the first version took a block per (row, 8 heads), 64 blocks at
// the served shape walking 64 pages one after another on CUDA cores, with
// four barriers a page and every page read by 16 blocks):
//   * split over pages, as the k/v kernel: the grid is (splits, head
//     groups, B).  Split s takes the row's logical pages [s pps, (s + 1)
//     pps); a block takes HB = 32 heads, and the host picks pps from the
//     shapes alone (kernels/paged_attention_mla.py::mla_split_plan, ~132
//     blocks: one an SM, which their shared memory allows), never from
//     `lengths`.  One instance a dtype serves every width the wrapper
//     takes: q rows past H are zeros, and value columns past R are
//     computed but never stored.  A split past its row's last page, or
//     whose pages are all -1 / out-of-range slots, writes an empty partial
//     (m = -inf, l = 0) and exits;
//   * heads are the M dimension of mma.sync: a block holds its HB queries
//     (q_abs ++ q_rope, zero rows past H) in shared memory and walks its
//     tokens in tiles of 32 rows of (ckv ++ krope), skipping tiles with no
//     visited token.  The rope dims are the last K of the same 576-deep
//     contraction;
//   * copies: one copy warp beside the compute warps issues each token's
//     ckv and krope rows as two bulk copies (cp.async.bulk, the copy
//     engine; no registers or issue slots of the compute warps) into a
//     two-tile ring, completing on a transaction barrier per buffer, and
//     refills a buffer when every compute warp has arrived on its "empty"
//     barrier; a token past the split's end or on a -1 page is a zero row
//     and masked.  Issued from the compute warps with 16-byte cp.async, the
//     copies stalled the issuing warps for ~11k cycles a tile (probe);
//   * float32: m16n8k8 TF32 mma with each operand split as hi = rna(x), lo
//     = x - hi (truncated to TF32 by the tensor core), lo*hi and hi*lo
//     before hi*hi into one float32
//     accumulator (3xTF32, as flash_attention.cu: one pass misses the
//     float32 bars, tests/test_torch_mla.py), each 16-dim step of q . k
//     in a fresh accumulator added to the running sum (below); bfloat16:
//     m16n8k16 in one pass, p rounded to bfloat16;
//   * compute warps: 2 row tiles x 4.  q . k: a warp takes one row
//     tile, half the contraction (alternate 16-dim (float32) / 32-dim
//     (bfloat16) steps) and 16 of the tile's tokens, so a q row is read by
//     2 warps a tile, not 4; the two halves meet in shared memory and the
//     softmax adds them in a fixed order (8 threads a head, 4 tokens each,
//     base-2 logits); p . v: a warp takes one row tile and a quarter of the
//     value columns (128: 64 float32 accumulators a thread),
//     with p read from shared memory and the output rescaled only when a
//     row max moved.  Three barriers of the compute warps a tile of 32;
//   * shared-memory rows of q and of the tile are padded to 16 bytes mod
//     128, and q . k reads chunk 2t (+1) of an 8-chunk group (the
//     contraction order is free), so its loads (rows g, g + 1) and the
//     float32 p . v loads (rows 2t, 2t + 1, chunk g of a 32-column group)
//     hit distinct banks: 232,360 of 232,448 B at HB = 32, R + K = 576 in
//     float32;
//   * each visited page's exp-sum under the running max, and that max, go
//     to float32 scratch (s_page, m_page) after the tile that ends the
//     page, summed by the softmax's own lanes where a page is 4 | page
//     whole lanes (page 4..32 or a multiple of 32), else by a thread a
//     (head, page); each split's (m, l, acc[R]) to part_m / part_l /
//     part_acc;
//   * a second launch combines the splits, deterministically and without
//     atomics: grid (H + ceil(n / 16), B); block (h, b) weighs head h's
//     splits by 2^(m_s - m_f) / l_f in split order (an empty split weighs
//     0, so a length-0 row gives zeros); block (H + j, b) writes mass[b,
//     pi] = sum_h s_page 2^(m_page - m_f) / l_f / H for 16 pages, heads
//     summed in groups of 8, the groups in order, zero outside [0, len)
//     and on -1 / out-of-range slots (never dereferenced).  No atomics
//     anywhere: repeats are bit-identical.
//
// The tensor core's float32 accumulation drops low bits of each sum (a
// bias that grows with the accumulator): one 288-dim chain of 108 mma into
// one accumulator left errors of 1.0-1.2e-5 against the 1e-5 bar; a fresh
// accumulator a 16-dim step and one rounded add keep them under 8.1e-6.
//
// DeepSeek's FlashMLA takes 64 heads a block over two warpgroups on wgmma;
// 64 heads of float32 q (147 KB) leave no room for a tile ring beside them
// on mma.sync, and at B = 4 they would give 2 head groups and so half as
// many blocks a split.
//
// The wrapper guarantees 16-byte aligned, contiguous inputs whose rows are
// a multiple of 16 bytes (R * sizeof(T), K * sizeof(T)), R <= 512, R + K <=
// 576, H >= 1, n >= 1, and provides the float32 scratch: part_acc [B, H,
// splits, R], part_m / part_l [B, H, splits], m_page / s_page [B, H, n].
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 32;          // tokens a tile
constexpr int kHB = 32;            // heads a block (2 row tiles of mma)
constexpr int kCols = 512;         // value columns the warps cover (>= R)
constexpr int kLDP = 36;           // row stride of the logit / p tile (floats)
constexpr int kMaxPages = 32;      // pages a split (mla_split_plan's cap)
constexpr int kCombineThreads = 256;
constexpr int kMassPages = 16;     // pages a mass block of the combine
constexpr int kSmemMax = 232448;

struct Params {
  const void* q_abs;
  const void* q_rope;
  const void* ckv;
  const void* krope;
  const int* table;
  const int* lengths;
  void* out;
  float* mass;
  float* part_acc;
  float* part_m;
  float* part_l;
  float* m_page;
  float* s_page;
  int B, H, R, K, page, n, P;
  float scale2;     // scale * log2(e): logits in base 2
  int pps, splits;
  int Dq;           // contraction dims staged (R + K rounded up, zeros past)
  int LD;           // shared-memory row stride, elements
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Transaction barriers in shared memory: a phase completes when `count`
// arrivals have been made and the bytes they announced have landed.
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// a barrier of the compute warps alone (the copy warp takes no part)
__device__ __forceinline__ void sync_compute(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One row of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory by the copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// order this thread's generic shared-memory writes before later bulk
// copies to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TF32 rounding as cvt.rna.tf32.f32 on the bit pattern, and the 3xTF32
// split hi = rna(x), lo = x - hi (exact) handed over as it is: the tensor
// core reads a TF32 operand's top 19 bits, so lo is truncated to TF32, one
// instruction fewer than rounding it (3.64e-6 against 4.05e-6 at the
// served shape, and ~2 us less; the splits are most of q . k's issue
// slots).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 2^x, ~2 ulp (MUFU.EX2); 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: the two small terms first, then hi * hi, into one accumulator
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Shared memory of the split kernel: q [kHB][LD] and the tile ring
// [2][kTile][LD] in T, then the logit halves / p [2][kHB][kLDP], the heads'
// running max and correction [HB] each, the split's slots [kMaxPages],
// five barriers (q landed; each ring buffer full; each ring buffer empty)
// and each buffer's mask of the tile's visited tokens.
__host__ __device__ constexpr size_t split_smem(int ld, int size) {
  return (size_t)size * (kHB + 2 * kTile) * ld +
         sizeof(float) * (2 * kHB * kLDP + 2 * kHB) + sizeof(int) * kMaxPages +
         5 * sizeof(uint64_t) + 2 * sizeof(unsigned);
}

// One warp stages `rows` (<= 32) shared rows of stride LD as [a (len_a
// elements) | b (len_b)], lane r taking row r: two bulk copies where
// `src(r, a, b)` says the row exists, zeros where it does not (an unread
// logit's p is 0, and 0 x a stale NaN would not be).  Lane 0 writes the
// mask of rows that exist to `have_out`, then arms `bar` with the bytes
// to expect.
template <typename T, typename Src>
__device__ __forceinline__ void stage_rows(T* dst, int rows, int LD,
                                           int len_a, int len_b,
                                           uint64_t* bar, Src src,
                                           unsigned* have_out = nullptr) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const T* a = nullptr;
  const T* b = nullptr;
  const bool ok = lane < rows && src(lane, a, b);
  const unsigned have = __ballot_sync(0xffffffffu, ok);
  // rows that do not exist: zeros, the whole warp a row, ordered before
  // the arrival that publishes the tile and before later copies here
  unsigned miss = ~have & (rows >= 32 ? 0xffffffffu : (1u << rows) - 1u);
  while (miss) {
    const int r = __ffs(miss) - 1;
    miss &= miss - 1;
    uint4* d = reinterpret_cast<uint4*>(dst + (size_t)r * LD);
    for (int c = lane; c < (len_a + len_b) / kVec; c += 32)
      d[c] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  __syncwarp();
  const uint32_t row_bytes = (uint32_t)(len_a + len_b) * sizeof(T);
  if (lane == 0 && have_out) *have_out = have;
  if (lane == 0) bar_expect(bar, __popc(have) * row_bytes);
  __syncwarp();
  if (ok) {
    T* d = dst + (size_t)lane * LD;
    bulk_copy(d, a, len_a * sizeof(T), bar);
    if (len_b) bulk_copy(d + len_a, b, len_b * sizeof(T), bar);
  }
}

template <typename T>
__global__ void __launch_bounds__(8 * 32 + 32, 1)
    paged_attention_mla_split_kernel(const Params p) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kCompute = 8 * 32;              // the compute warps' threads
  constexpr int kThreads = kCompute + 32;       // and one copy warp
  constexpr int kWarps = kCompute / 32;
  constexpr int HB = kHB;
  constexpr int NJ = kCols / 128;               // 32-column groups a warp
  const int R = p.R, K = p.K, page = p.page, n = p.n, H = p.H;
  const int LD = p.LD, Dq = p.Dq;
  const int s = blockIdx.x;
  const int h0 = blockIdx.y * HB;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);              // [HB][LD]
  T* kv_s = q_s + (size_t)HB * LD;                      // [2][kTile][LD]
  float* sp = reinterpret_cast<float*>(kv_s + (size_t)2 * kTile * LD);
  float* m_s = sp + 2 * HB * kLDP;                      // [HB]
  float* c_s = m_s + HB;                                // [HB]
  int* slots = reinterpret_cast<int*>(c_s + HB);        // [kMaxPages]
  // q landed, buffer 0 / 1 full, buffer 0 / 1 empty
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + kMaxPages);
  unsigned* tok_mask = reinterpret_cast<unsigned*>(bars + 5);   // [2]

  // this split's pages [p0, p1) and positions [t_begin, t_end)
  const int len = p.lengths[b];
  const int hi = len > 0 ? min(n, (len + page - 1) / page) : 0;
  const int p0 = s * p.pps;
  const int p1 = min(p0 + p.pps, hi);
  const int t_begin = p0 * page;
  const int t_end = min(p1 * page, len);
  const int ntiles = p1 > p0 ? (t_end - t_begin + kTile - 1) / kTile : 0;
  const int* row_table = p.table + (size_t)b * n;
  for (int i = tid; i < p1 - p0; i += kThreads) {
    const int slot = row_table[p0 + i];
    slots[i] = slot >= 0 && slot < p.P ? slot : -1;
  }
  if (tid < 5) bar_init(bars + tid, tid < 3 ? 1 : kWarps);
  // the contraction's zero columns [R + K, Dq) and the value columns the
  // warps read past them [Dq, LD_base): written once, never copied over
  const int lo_col = R + K, row_len = LD - 16 / (int)sizeof(T);
  for (int i = tid; i < (HB + 2 * kTile) * (row_len - lo_col); i += kThreads)
    q_s[(size_t)(i / (row_len - lo_col)) * LD + lo_col +
        i % (row_len - lo_col)] = from_float<T>(0.f);
  fence_proxy_async();
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // the first tile at or after i that holds a visited token (ntiles if
  // none)
  auto next_live = [&](int i) {
    for (; i < ntiles; ++i) {
      const int a = t_begin + i * kTile;
      const int e = min(a + kTile, t_end);
      for (int pi = a / page; pi <= (e - 1) / page; ++pi)
        if (slots[pi - p0] >= 0) return i;
    }
    return ntiles;
  };
  auto visited = [&](int pos) {
    return pos < t_end && slots[pos / page - p0] >= 0;
  };

  const size_t part = ((size_t)b * H + h0) * p.splits + s;  // head h0's
  int cur = next_live(0);
  if (cur >= ntiles) {           // nothing to attend: an empty partial
    for (int h = tid; h < HB && h0 + h < H; h += kThreads) {
      p.part_m[part + (size_t)h * p.splits] = -INFINITY;
      p.part_l[part + (size_t)h * p.splits] = 0.f;
    }
    return;
  }

  const T* ckv = static_cast<const T*>(p.ckv);
  const T* krope = static_cast<const T*>(p.krope);
  // the copy warp stages tile i of the split into buffer `buf`
  auto stage_tile = [&](int i, int buf) {
    const int a = t_begin + i * kTile;
    stage_rows<T>(kv_s + (size_t)buf * kTile * LD, kTile, LD, R, K,
                  bars + 1 + buf, [&](int r, const T*& x, const T*& y) {
                    const int pos = a + r;
                    if (!visited(pos)) return false;
                    const size_t row =
                        (size_t)slots[pos / page - p0] * page + pos % page;
                    x = ckv + row * R;
                    y = krope + row * K;
                    return true;
                  }, tok_mask + buf);
  };
  if (warp == kWarps) {
    // the copy warp: q (zero rows past H), then each live tile once the
    // compute warps have left the buffer it goes to
    const T* qa = static_cast<const T*>(p.q_abs);
    const T* qr = static_cast<const T*>(p.q_rope);
    stage_rows<T>(q_s, HB, LD, R, K, bars,
                  [&](int r, const T*& x, const T*& y) {
                    const size_t hh = (size_t)b * H + h0 + r;
                    x = qa + hh * R;
                    y = qr + hh * K;
                    return h0 + r < H;
                  });
    uint32_t empty_phase = 0;
    for (int i = cur, k = 0; i < ntiles; i = next_live(i + 1), ++k) {
      const int bf = k & 1;
      if (k >= 2) {
        bar_wait(bars + 3 + bf, (empty_phase >> bf) & 1u);
        empty_phase ^= 1u << bf;
      }
      stage_tile(i, bf);
    }
    return;
  }

  // warp roles: q . k (row tile mt, contraction half kh, tokens 16 nh..);
  // p . v (row tile mt, value columns cb..cb + 32 NJ)
  const int mt = warp >> 2;
  const int kh = (warp >> 1) & 1, nh = warp & 1;
  const int cb = (warp & 3) * 32 * NJ;
  const int hr0 = mt * 16 + g, hr1 = hr0 + 8;    // this thread's q rows
  // softmax roles: head sh, tokens 4 sj..4 sj + 3
  const int sh = tid >> 3, sj = tid & 7;

  constexpr int kNO = 4 * NJ;                   // 8-column n-tiles a warp
  float o[kNO][4];
#pragma unroll
  for (int j = 0; j < kNO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;          // head sh's, base 2

  // pages that the softmax's lanes can sum among themselves: a page of 4,
  // 8, 16 or 32 tokens (whole pages in a tile) or of a multiple of 32 (a
  // tile inside a page), 4 | page lanes a page
  const bool lane_sums = page % 4 == 0 && (kTile % page == 0 ||
                                           page % kTile == 0);
  const int grp = min(page, kTile) / 4;
  bar_wait(bars, 0);                             // q landed
  int buf = 0;
  uint32_t phase = 0;                            // the ring's parities
  while (cur < ntiles) {
    const int nxt = next_live(cur + 1);
    const int pos0 = t_begin + cur * kTile;
    // this tile landed, and every compute warp is done with p
    bar_wait(bars + 1 + buf, (phase >> buf) & 1u);
    phase ^= 1u << buf;
    sync_compute(kCompute);

    const T* kv = kv_s + (size_t)buf * kTile * LD;
    const unsigned mask_now = tok_mask[buf];
    // ---- logits: s[n] = q k^T of rows hr0 / hr1 and tokens 16 nh + 8 n +
    // (2t, 2t + 1), over this warp's half of the contraction.  Step st
    // reads 16-byte chunk 8 (st / 2) + 2t + st % 2 of each row (the
    // contraction order is free), so with rows 16 bytes apart mod 128 the
    // lanes of a load phase (rows g, g + 1) hit distinct banks
    float sacc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
    if constexpr (kF32) {
      // a 16-dim step: dims 4c..4c+1 as columns t, t+4 of one k-step,
      // 4c+2, 4c+3 of the next
      const float* qa = reinterpret_cast<const float*>(q_s) + hr0 * LD;
      const float* qb = reinterpret_cast<const float*>(q_s) + hr1 * LD;
      const float* kvf = reinterpret_cast<const float*>(kv);
#pragma unroll 2
      for (int st = kh; st < Dq / 16; st += 2) {
        const int e0 = 4 * (8 * (st >> 1) + 2 * t + (st & 1));
        const float4 x0 = *reinterpret_cast<const float4*>(qa + e0);
        const float4 x1 = *reinterpret_cast<const float4*>(qb + e0);
        uint32_t ah[2][4], al[2][4];
        split(x0.x, ah[0][0], al[0][0]);
        split(x1.x, ah[0][1], al[0][1]);
        split(x0.y, ah[0][2], al[0][2]);
        split(x1.y, ah[0][3], al[0][3]);
        split(x0.z, ah[1][0], al[1][0]);
        split(x1.z, ah[1][1], al[1][1]);
        split(x0.w, ah[1][2], al[1][2]);
        split(x1.w, ah[1][3], al[1][3]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = nh * 16 + j * 8 + g;
          const float4 y = *reinterpret_cast<const float4*>(kvf + r * LD + e0);
          uint32_t bh0[2], bl0[2], bh1[2], bl1[2];
          split(y.x, bh0[0], bl0[0]);
          split(y.y, bh0[1], bl0[1]);
          split(y.z, bh1[0], bl1[0]);
          split(y.w, bh1[1], bl1[1]);
          // the step's 16 dims in a fresh accumulator, then one rounded
          // add (the header: float32 accumulation in the tensor core)
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(d, ah[0], al[0], bh0, bl0);
          mma_3xtf32(d, ah[1], al[1], bh1, bl1);
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[j][e] += d[e];
        }
      }
    } else {
      // a 32-dim step: dims 8c..8c+3 as one m16n8k16 k-step, 8c+4..8c+7
      // as the next
      const __nv_bfloat16* qa = reinterpret_cast<const __nv_bfloat16*>(q_s);
      const __nv_bfloat16* kvb = reinterpret_cast<const __nv_bfloat16*>(kv);
#pragma unroll 2
      for (int st = kh; st < Dq / 32; st += 2) {
        const int e0 = 8 * (8 * (st >> 1) + 2 * t + (st & 1));
        const uint4 x0 = *reinterpret_cast<const uint4*>(qa + hr0 * LD + e0);
        const uint4 x1 = *reinterpret_cast<const uint4*>(qa + hr1 * LD + e0);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = nh * 16 + j * 8 + g;
          const uint4 y = *reinterpret_cast<const uint4*>(kvb + r * LD + e0);
          mma_bf16(sacc[j], x0.x, x1.x, x0.y, x1.y, y.x, y.y);
          mma_bf16(sacc[j], x0.z, x1.z, x0.w, x1.w, y.z, y.w);
        }
      }
    }
    {
      float* h0r = sp + (kh * HB + hr0) * kLDP + nh * 16 + 2 * t;
      float* h1r = h0r + 8 * kLDP;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        *reinterpret_cast<float2*>(h0r + 8 * j) =
            make_float2(sacc[j][0], sacc[j][1]);
        *reinterpret_cast<float2*>(h1r + 8 * j) =
            make_float2(sacc[j][2], sacc[j][3]);
      }
    }
    sync_compute(kCompute);

    // ---- online softmax: 8 threads a head, the two contraction halves
    // added in order; a masked token's logit is -inf and its p 0
    {
      const float4 u = *reinterpret_cast<const float4*>(sp + sh * kLDP + 4 * sj);
      const float4 v =
          *reinterpret_cast<const float4*>(sp + (HB + sh) * kLDP + 4 * sj);
      float x[4] = {u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w};
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = (mask_now >> (4 * sj + e)) & 1u ? x[e] * p.scale2 : -INFINITY;
        mx = fmaxf(mx, x[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      // a live tile holds a visited token, so m_new is finite
      const float m_new = fmaxf(m_run, mx);
      const float corr = ex2(m_run - m_new);      // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = ex2(x[e] - m_new);
        sum += x[e];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l_run = l_run * corr + sum;
      m_run = m_new;
      *reinterpret_cast<float4*>(sp + sh * kLDP + 4 * sj) =
          make_float4(x[0], x[1], x[2], x[3]);
      if (sj == 0) {
        m_s[sh] = m_new;
        c_s[sh] = corr;
      }
      // each page of the tile: its exp-sum under the running max, added to
      // what an earlier tile of the split left (rescaled), here from the
      // lanes' own p where the page's tokens are whole lanes
      if (lane_sums) {
        float ps = (x[0] + x[1]) + (x[2] + x[3]);
        for (int off = 1; off < grp; off <<= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, off);
        const int pos = pos0 + 4 * sj;
        if ((sj & (grp - 1)) == 0 && h0 + sh < H && pos < t_end &&
            slots[pos / page - p0] >= 0) {
          const int pi = pos / page;
          const size_t at = ((size_t)b * H + h0 + sh) * n + pi;
          if (pi * page < pos0) ps += p.s_page[at] * ex2(p.m_page[at] - m_new);
          p.s_page[at] = ps;
          p.m_page[at] = m_new;
        }
      }
    }
    sync_compute(kCompute);

    // ---- the same for other page sizes: a thread a (head, page), tokens
    // in order, the tasks spread over the warps
    if (!lane_sums) {
      const int last = min(pos0 + kTile, t_end) - 1;
      const int pa = pos0 / page, np = last / page - pa + 1;
      for (int task = lane * kWarps + warp; task < HB * np;
           task += kCompute) {
        const int h = task / np, pi = pa + task % np;
        if (h0 + h >= H || slots[pi - p0] < 0) continue;
        const int lo = max(pos0, pi * page) - pos0;
        const int up = min(last + 1, (pi + 1) * page) - pos0;
        const float* pr = sp + h * kLDP;
        float sum = 0.f;
        int q = lo;
        if ((lo & 3) == 0)
          for (; q + 4 <= up; q += 4) {
            const float4 v = *reinterpret_cast<const float4*>(pr + q);
            sum += v.x + v.y + v.z + v.w;
          }
        for (; q < up; ++q) sum += pr[q];
        const size_t at = ((size_t)b * H + h0 + h) * n + pi;
        const float mn = m_s[h];
        if (pi * page < pos0) sum += p.s_page[at] * ex2(p.m_page[at] - mn);
        p.s_page[at] = sum;
        p.m_page[at] = mn;
      }
    }

    // ---- o = o * corr + p v over the tile's tokens
    {
      const float c0 = c_s[hr0], c1 = c_s[hr1];
      if (__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {
#pragma unroll
        for (int j = 0; j < kNO; ++j) {
          o[j][0] *= c0;
          o[j][1] *= c0;
          o[j][2] *= c1;
          o[j][3] *= c1;
        }
      }
      const float* pr0 = sp + hr0 * kLDP;
      const float* pr1 = sp + hr1 * kLDP;
      if constexpr (kF32) {
        // k-step ks: tokens 8ks + 2t, 8ks + 2t + 1 as A-columns t, t + 4;
        // B-column g of n-tile 4j + m is value column cb + 32j + 4g + m,
        // so each token row gives a float4 for four n-tiles (rows 2t and
        // 2t + 1, chunk g: distinct banks with rows 16 bytes apart mod 128)
        const float* kvf = reinterpret_cast<const float*>(kv);
#pragma unroll
        for (int ks = 0; ks < kTile / 8; ++ks) {
          const float2 pa = *reinterpret_cast<const float2*>(pr0 + 8 * ks + 2 * t);
          const float2 pb = *reinterpret_cast<const float2*>(pr1 + 8 * ks + 2 * t);
          uint32_t ah[4], al[4];
          split(pa.x, ah[0], al[0]);
          split(pb.x, ah[1], al[1]);
          split(pa.y, ah[2], al[2]);
          split(pb.y, ah[3], al[3]);
          const float* v0 = kvf + (8 * ks + 2 * t) * LD + cb + 4 * g;
          const float* v1 = v0 + LD;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float4 y0 = *reinterpret_cast<const float4*>(v0 + 32 * j);
            const float4 y1 = *reinterpret_cast<const float4*>(v1 + 32 * j);
            const float w0[4] = {y0.x, y0.y, y0.z, y0.w};
            const float w1[4] = {y1.x, y1.y, y1.z, y1.w};
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              uint32_t bh[2], bl[2];
              split(w0[m], bh[0], bl[0]);
              split(w1[m], bh[1], bl[1]);
              mma_3xtf32(o[4 * j + m], ah, al, bh, bl);
            }
          }
        }
      } else {
        // k-step ks: tokens 16ks.. in the A layout's own order; V read by
        // ldmatrix.trans, lane l giving the row of token 16ks + 8((l >> 3)
        // & 1) + (l & 7) at column 8(l >> 4) of a 16-column pair of n-tiles
        const __nv_bfloat16* kvb = reinterpret_cast<const __nv_bfloat16*>(kv);
        const int lr = ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
        for (int ks = 0; ks < kTile / 16; ++ks) {
          const int k0 = 16 * ks + 2 * t;
          const uint32_t a0 = pack_bf16(pr0[k0], pr0[k0 + 1]);
          const uint32_t a1 = pack_bf16(pr1[k0], pr1[k0 + 1]);
          const uint32_t a2 = pack_bf16(pr0[k0 + 8], pr0[k0 + 9]);
          const uint32_t a3 = pack_bf16(pr1[k0 + 8], pr1[k0 + 9]);
          const __nv_bfloat16* vr =
              kvb + (16 * ks + lr) * LD + cb + 8 * (lane >> 4);
#pragma unroll
          for (int j = 0; j < 2 * NJ; ++j) {
            uint32_t bv[4];
            ldsm_x4_trans(bv, vr + 16 * j);
            mma_bf16(o[2 * j], a0, a1, a2, a3, bv[0], bv[1]);
            mma_bf16(o[2 * j + 1], a0, a1, a2, a3, bv[2], bv[3]);
          }
        }
      }
    }
    // this warp is done with the buffer: the copy warp may refill it
    __syncwarp();
    if (lane == 0) bar_arrive(bars + 3 + buf);
    cur = nxt;
    buf ^= 1;
  }

  // the split's partial: (m, l) per head, acc [R] unnormalised
  if (sj == 0 && h0 + sh < H) {
    p.part_m[part + (size_t)sh * p.splits] = m_run;
    p.part_l[part + (size_t)sh * p.splits] = l_run;
  }
  const int rows[2] = {hr0, hr1};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (h0 + rows[half] >= H) continue;
    float* dst = p.part_acc + (part + (size_t)rows[half] * p.splits) * R;
    if constexpr (kF32) {
      // n-tile 4j + m, columns 2t and 2t + 1: value columns cb + 32j + 8t
      // + m and + 4 + m
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = cb + 32 * j + 8 * t;
        if (d < R)
          *reinterpret_cast<float4*>(dst + d) =
              make_float4(o[4 * j][2 * half], o[4 * j + 1][2 * half],
                          o[4 * j + 2][2 * half], o[4 * j + 3][2 * half]);
        if (d + 4 < R)
          *reinterpret_cast<float4*>(dst + d + 4) = make_float4(
              o[4 * j][2 * half + 1], o[4 * j + 1][2 * half + 1],
              o[4 * j + 2][2 * half + 1], o[4 * j + 3][2 * half + 1]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNO; ++j) {
        const int d = cb + 8 * j + 2 * t;
        if (d < R)
          *reinterpret_cast<float2*>(dst + d) =
              make_float2(o[j][2 * half], o[j][2 * half + 1]);
      }
    }
  }
}

// Block (h, b), h < H: head h's output from its splits, weighed by 2^(m_s
// - m_f) / l_f in split order (an empty split's m_s = -inf weighs 0 and its
// accumulator, never written, is not read).  Block (H + j, b): the row's
// page mass on pages [j kMassPages, (j + 1) kMassPages).
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    paged_attention_mla_combine_kernel(const Params p) {
  extern __shared__ float w_s[];
  const int H = p.H, R = p.R, n = p.n, splits = p.splits;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < H) {
    const int h = blockIdx.x;
    float* l_s = w_s + splits;
    const size_t base = ((size_t)b * H + h) * splits;
    for (int i = tid; i < splits; i += kCombineThreads) {
      w_s[i] = p.part_m[base + i];
      l_s[i] = p.part_l[base + i];
    }
    __syncthreads();
    if (tid == 0) {
      float mf = -INFINITY;
      for (int i = 0; i < splits; ++i) mf = fmaxf(mf, w_s[i]);
      float lf = 0.f;
      for (int i = 0; i < splits; ++i)
        lf += w_s[i] == -INFINITY ? 0.f : l_s[i] * exp2f(w_s[i] - mf);
      const float inv = 1.f / fmaxf(lf, 1e-30f);
      for (int i = 0; i < splits; ++i)
        w_s[i] = w_s[i] == -INFINITY ? 0.f : exp2f(w_s[i] - mf) * inv;
    }
    __syncthreads();
    const float* acc = p.part_acc + base * R;
    T* out = static_cast<T*>(p.out) + ((size_t)b * H + h) * R;
    for (int d = tid; d < R; d += kCombineThreads) {
      float o = 0.f;
      for (int i = 0; i < splits; ++i)
        if (w_s[i] != 0.f) o += acc[(size_t)i * R + d] * w_s[i];
      out[d] = from_float<T>(o);
    }
    return;
  }
  // mass[b, pi] = sum_h s_page 2^(m_page - m_f) / l_f / H: every head's
  // (m_f, 1 / l_f) first, then a thread per (page, group of 8 heads), then
  // a thread per page sums the groups in order
  float* mf_s = w_s;                  // [H] m_f
  float* inv_s = mf_s + H;            // [H] 1 / l_f
  float* part = inv_s + H;            // [groups, kMassPages]
  for (int h = tid; h < H; h += kCombineThreads) {
    const float* pm = p.part_m + ((size_t)b * H + h) * splits;
    const float* pl = p.part_l + ((size_t)b * H + h) * splits;
    float mf = -INFINITY;
    for (int i = 0; i < splits; ++i) mf = fmaxf(mf, pm[i]);
    float lf = 0.f;
    for (int i = 0; i < splits; ++i)
      lf += pm[i] == -INFINITY ? 0.f : pl[i] * exp2f(pm[i] - mf);
    mf_s[h] = mf;
    inv_s[h] = 1.f / fmaxf(lf, 1e-30f);
  }
  __syncthreads();
  const int len = p.lengths[b];
  const int hi = len > 0 ? min(n, (len + p.page - 1) / p.page) : 0;
  const int groups = (H + 7) / 8;
  const int pg0 = ((int)blockIdx.x - H) * kMassPages;
  const int np = min(kMassPages, n - pg0);
  const int* row_table = p.table + (size_t)b * n;
  for (int i = tid; i < groups * np; i += kCombineThreads) {
    const int gr = i / np, pi = pg0 + i % np;
    const int slot = row_table[pi];
    const bool live = pi < hi && slot >= 0 && slot < p.P;
    // every load of the group in flight at once; a page outside the span
    // (never written) is selected away, not multiplied
    float sp[8], mp[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int h = min(gr * 8 + k, H - 1);
      const size_t at = ((size_t)b * H + h) * n + pi;
      sp[k] = p.s_page[at];
      mp[k] = p.m_page[at];
    }
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int h = gr * 8 + k;
      const float c = sp[k] * exp2f(mp[k] - mf_s[min(h, H - 1)]) *
                      inv_s[min(h, H - 1)];
      sum += live && h < H ? c : 0.f;
    }
    part[gr * kMassPages + i % np] = sum;
  }
  __syncthreads();
  for (int i = tid; i < np; i += kCombineThreads) {
    float total = 0.f;
    for (int gr = 0; gr < groups; ++gr) total += part[gr * kMassPages + i];
    p.mass[(size_t)b * n + pg0 + i] = total / (float)H;
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

template <typename T>
cudaError_t launch_all(Params prm, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (prm.R > kCols || prm.pps > kMaxPages || prm.R % kVec || prm.K % kVec)
    return cudaErrorInvalidValue;
  // the contraction in steps of 8 chunks (32 float32 / 64 bfloat16
  // elements), zeros past R + K; rows 16 bytes apart mod 128 (one chunk of
  // padding), so the fragment loads hit distinct banks
  const int grp = 8 * kVec;
  prm.Dq = (prm.R + prm.K + grp - 1) / grp * grp;
  prm.LD = (prm.Dq > kCols ? prm.Dq : kCols) + kVec;
  const size_t ssmem = split_smem(prm.LD, (int)sizeof(T));
  if (ssmem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t e = raise_smem<paged_attention_mla_split_kernel<T>>(ssmem);
  if (e != cudaSuccess) return e;
  paged_attention_mla_split_kernel<T>
      <<<dim3(prm.splits, (prm.H + kHB - 1) / kHB, prm.B), 8 * 32 + 32,
         ssmem, stream>>>(prm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t csmem =
      sizeof(float) * ((size_t)2 * prm.H +
                       (size_t)((prm.H + 7) / 8) * kMassPages);
  const size_t hsmem = sizeof(float) * 2 * (size_t)prm.splits;
  const size_t smem = csmem > hsmem ? csmem : hsmem;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  e = raise_smem<paged_attention_mla_combine_kernel<T>>(smem);
  if (e != cudaSuccess) return e;
  const int mass_blocks = (prm.n + kMassPages - 1) / kMassPages;
  paged_attention_mla_combine_kernel<T>
      <<<dim3(prm.H + mass_blocks, prm.B), kCombineThreads, smem, stream>>>(
          prm);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q_abs, q_rope, ckv_pages, krope_pages
// and out share it).  pps and splits come from the host's mla_split_plan.
extern "C" cudaError_t paged_attention_mla_launch(
    int dtype, const void* q_abs, const void* q_rope, const void* ckv_pages,
    const void* krope_pages, const void* table, const void* lengths,
    void* out, void* mass, void* part_acc, void* part_m, void* part_l,
    void* m_page, void* s_page, int B, int H, int R, int K, int page, int n,
    int P, float scale, int pps, int splits, void* stream) {
  Params prm{q_abs,
             q_rope,
             ckv_pages,
             krope_pages,
             static_cast<const int*>(table),
             static_cast<const int*>(lengths),
             out,
             static_cast<float*>(mass),
             static_cast<float*>(part_acc),
             static_cast<float*>(part_m),
             static_cast<float*>(part_l),
             static_cast<float*>(m_page),
             static_cast<float*>(s_page),
             B, H, R, K, page, n, P,
             scale * 1.4426950408889634f,
             pps, splits, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_all<float>(prm, st);
  if (dtype == 1) return launch_all<__nv_bfloat16>(prm, st);
  return cudaErrorInvalidValue;
}
