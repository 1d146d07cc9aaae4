// Blockwise (flash) attention forward: the Hopper (sm_90a) counterpart of
// the TPU kernel repro/kernels/flash_attention.py::flash_attention (body
// `_kernel`, defined at :73).
//
// What it computes: q [B, S, H, D], k/v [B, T, KV, D] (KV divides H; query
// head h reads KV head h / (H / KV)), q_off + S <= T.  For query i of head h
//   out[b, i, h] = sum_j p_j v[b, j, h / rep] / max(sum_j p_j, 1e-30),
//   p_j = exp(s_j - max s),  s_j = (q[b, i, h] . k[b, j, h / rep]) * scale,
// over the keys j it attends: j <= q_off + i when causal, and
// j > q_off + i - window when window > 0 (query i sits at position q_off + i
// and key j at j: q_off is a prefill chunk's start, its keys the earlier
// chunks' and its own; q_off = 0 is the TPU kernel's semantics).  A
// masked key's p is 0 (the TPU kernel's masked logits are -1e30, and every
// query attends its own position); the scale 1/sqrt(D) is multiplied, as
// in the TPU kernel; in bfloat16, p is rounded to bfloat16 before the PV
// product, as the TPU kernel casts it to v's dtype.  The output has q's
// dtype.
//
// Bound on this card: operations, on the tensor cores.  Per (query,
// attended key) pair and head it does 4 * D flops (2 * D in q . k, 2 * D in
// p v) on k and v rows that every query of a tile and every head of the
// GQA group reads again: at prefill's S = T = 2048, H = 16, D = 256 that
// is ~100 GFLOP against ~0.4 GB.  float32 runs each product as 3xTF32
// (three TF32 passes, so 3x the flops at 495 TFLOP/s); bfloat16 in one
// pass at 989 TFLOP/s.  Either way the arithmetic, not the 3.35 TB/s of
// HBM, sets the floor.  mma.sync itself reaches only ~280-310 TFLOP/s in
// TF32 and ~600-630 in bf16 on an H100 (8-32 warps an SM; PERF.md);
// wgmma is the way to the rest.
//
// Design (FlashAttention-2's warp layout on mma.sync):
//   * the TPU kernel's sequential kv grid axis carried (m, l, acc) in
//     scratch from one grid step to the next; here one block of 8 warps
//     owns 128 query rows that share one KV head and walks its kv tiles of
//     32 keys in a loop.  Where rep = H / KV divides 128, the rows are
//     128 / rep positions x the group's rep heads (position-major), so each
//     k/v tile is staged once for every head of the group; otherwise 128
//     positions of one head.  Blocks run the last query tile first over
//     every (head group, batch row), so the causal tail is short;
//   * warp w owns rows 16w..16w+15: its logits S (16 x 32) and its output
//     O (16 x D) live in mma accumulators; (m, l) per row in registers.
//     The row max takes two quad shuffles; l is kept per thread and summed
//     over the quad once, at the end; O is rescaled only when a row max of
//     the warp moved.  Logits are kept in base 2 (scale * log2 e folded
//     into one multiply, p = ex2(x - max));
//   * float32: m16n8k8 TF32 mma with each operand split as hi =
//     rna(x), lo = rna(x - hi) (rna: round to nearest, ties away from
//     zero, to TF32's 10-bit mantissa), lo*hi and hi*lo before hi*hi into
//     one float32 accumulator.  One TF32 pass would round v itself by
//     ~5e-4 (S = 1); three keep the float32 tolerances.  A k tile is split
//     once a block, in shared memory (hi over the copy, lo beside it), not
//     once a warp; q and v are split in registers.  bfloat16: m16n8k16 in
//     one pass;
//   * no shuffles between the products: the contraction order inside an
//     mma k-step is free, so q . k reads dims {4t..4t+3} (float32) or
//     {8t..8t+7} (bfloat16) of a row as one 16-byte load per thread, and
//     p v takes key 2t and 2t+1 (float32) as the A-fragment's columns t and
//     t+4, exactly the S accumulator's elements of that thread.  float32
//     p v also gives B-fragment column g of four adjacent n-tiles the
//     dims 4g..4g+3 of a 32-dim group, so V is read as float4 and each
//     thread writes 8 contiguous outputs; bfloat16 reads V with
//     ldmatrix.trans;
//   * shared memory: the q tile (128 rows), a k tile (float32: hi and lo)
//     and a v tile, in q's dtype, laid out so that every fragment load is
//     free of bank conflicts: float32 q and k rows unpadded with their
//     16-byte chunks swizzled by row parity, v rows padded to 4 words mod
//     32; bfloat16 rows 64 bytes mod 128 (q and k, padded where 2D is 0
//     mod 128) and v an odd number of 16-byte units for ldmatrix --
//     229,888 B in float32 at D = 256;
//   * 16-byte cp.async copies, a tile's (row, 16-byte chunk) pairs walked
//     row-major by the block's 256 threads (for_chunks: a row's chunks
//     need not divide 256, 40 at D = 160 in float32).  Where two k/v
//     buffers fit (bfloat16, and float32 up to D = 160: 205,824 B there)
//     the next tile is copied during this one, with one barrier a tile
//     (11-14% faster than one buffer of each in bfloat16, 2-3% in float32
//     at D = 128; PERF.md).  float32 at D = 192, 224 and 256 has room
//     for one of each (172,544, 201,216 and 229,888 B): v of this tile is
//     copied during q . k and softmax, k of the next tile during p v,
//     with two barriers a tile.  Rows past S or T are zero-filled;
//   * only kv tiles that hold an attended key of the block are visited
//     (mirrored by kernels/flash_attention.py::block_plan); a warp none of
//     whose rows attends a key of the tile skips its products, and the
//     mask is evaluated only on tiles that cross a mask edge;
//   * no atomics: every sum runs in a fixed order, so repeats are
//     bit-identical.
//
// The wrapper guarantees contiguous inputs, 16-byte aligned pointers and
// D in {16, 32, 64, 96, 128, 160, 192, 224, 256}: 16 and every multiple of
// 32 up to 256, the TPU kernel's registered head dims among them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRows = 128;      // query rows per block (8 warps x 16)
constexpr int kBKV = 32;        // keys per kv tile
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;  // the row max's start: the TPU kernel's
                                // masked logit

// Row strides of the shared tiles, in elements, and the ring (see the
// header).
template <typename T, int D>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // q and k: float32 rows unpadded, their 16-byte chunks swizzled
  // (swz_qk); bfloat16 rows 64 bytes mod 128 for the 16-byte loads (D >=
  // 32: 2D is 64 mod 128 as it is at D = 32, 96, 160 and 224, and is
  // padded by 32 elements where it is 0 mod 128), 32 bytes for D = 16's
  // 8-byte ones
  static constexpr int kLDQ = (kF32 || D % 64) ? D : D + 32;
  // v: 4 words mod 32 (float32), an odd number of 16-byte units (bf16)
  static constexpr int kLDV = kF32 ? (D % 32 ? D + 20 : D + 4) : D + 8;
  static constexpr size_t kQ = (size_t)kRows * kLDQ;             // elements
  // a k tile (float32: its hi and lo halves) and a v tile
  static constexpr size_t kK = (size_t)(kF32 ? 2 : 1) * kBKV * kLDQ;
  static constexpr size_t kV = (size_t)kBKV * kLDV;
  // two k/v buffers where they fit beside the q tile, else one of each
  static constexpr bool kRing =
      sizeof(T) * (kQ + 2 * (kK + kV)) <= 232448;
  static constexpr size_t kSmem =
      sizeof(T) * (kQ + (kRing ? 2 : 1) * (kK + kV));
};

// float32 q and k rows: 16-byte chunk c of row r sits at chunk
// c ^ 4 (r & 1), so the 8 lanes of a 16-byte load phase (rows g = 0, 1,
// chunks 4j + t) hit 8 distinct bank groups.  D = 16 rows (4 chunks) are
// conflict-free as they are.
template <int D>
__device__ __forceinline__ int swz_qk(int r, int c) {
  return D >= 32 ? c ^ ((r & 1) << 2) : c;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_async_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Walk this thread's (row, chunk) pairs of a tile of `rows` rows of
// kChunks 16-byte chunks: the pairs in row-major order, thread i taking
// pairs i, i + 256, ...  Where kChunks divides 256 (D a power of two) a
// thread keeps one chunk column and the carry below compiles away; at D =
// 96, 160, 192 and 224 it does not.
template <int kChunks, typename F>
__device__ __forceinline__ void for_chunks(int rows, F f) {
  constexpr int kStep = kThreads / kChunks;   // whole rows a pass
  constexpr int kRem = kThreads % kChunks;    // and chunks beyond them
  int cc = threadIdx.x % kChunks;
  for (int r = threadIdx.x / kChunks; r < rows; r += kStep) {
    f(r, cc);
    if constexpr (kRem != 0) {
      cc += kRem;
      if (cc >= kChunks) {
        cc -= kChunks;
        ++r;
      }
    }
  }
}

// Copy `rows` rows of D elements into a shared tile of row stride LD with
// 16-byte cp.async (for_chunks' pairs), float32 q and k rows swizzled
// (kSwz).  `src(r, ok)` gives row r's source and whether it exists; rows
// that do not are zero-filled (src-size 0 reads nothing).
template <typename T, int D, int LD, bool kSwz, typename Src>
__device__ __forceinline__ void stage(T* dst, int rows, Src src) {
  constexpr int kVec = 16 / sizeof(T);
  for_chunks<D / kVec>(rows, [&](int r, int cc) {
    bool ok;
    const T* s = src(r, ok);
    const int pc = kSwz ? swz_qk<D>(r, cc) : cc;
    cp_async16(dst + r * LD + pc * kVec, s + cc * kVec, ok ? 16 : 0);
  });
}

// TF32 rounding as cvt.rna.tf32.f32 (to nearest, ties away from zero, to
// a 10-bit mantissa) on the bit pattern: add half of the 13 dropped bits'
// range, clear them.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The 3xTF32 split: hi = rna(x), lo = rna(x - hi) (x - hi is exact).  The
// tensor core reads a TF32 operand's top 19 bits and ignores the other 13,
// so lo is handed over with the half-range added and not cleared: the
// product sees rna(x - hi) for one instruction fewer (bit-identical
// outputs on the card against clearing them, or against cvt.rna.tf32.f32).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// 2^x, ~2 ulp (MUFU.EX2)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Split a float32 k tile that this thread staged (stage's pairs: its own
// cp.async copies are the ones it waited for) in place, once a block
// instead of once a warp: hi over the copy, lo into `lo` at the same
// offsets.
template <int D>
__device__ __forceinline__ void split_tile(float* hi, float* lo) {
  for_chunks<D / 4>(kBKV, [&](int r, int cc) {
    const int off = r * D + 4 * swz_qk<D>(r, cc);
    const float4 x = *reinterpret_cast<const float4*>(hi + off);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  });
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

// s = q k^T for the warp's 16 rows and the tile's 32 keys: s[n] is the
// m16n8 accumulator of keys 8n..8n+7 (thread (g, t): rows g and g + 8,
// keys 8n + 2t and 8n + 2t + 1).
//
// float32: q0 / q1 point at rows g and g + 8, kh / kl at key g of the k
// tile's hi and lo halves, all at word 4t; a 16-dim chunk at word offset
// `off` is two k-steps, dims 4t, 4t+1 as columns t, t+4 of the first,
// 4t+2, 4t+3 of the second.  Chunk 2j + 1 - (g & 1) and 2j + (g & 1) of
// a swizzled row sit at offsets 32j + 16 - xd and 32j + xd (xd = 16 (g & 1)).
template <int D>
__device__ __forceinline__ void qk_f32(float (&s)[4][4], const float* q0,
                                       const float* q1, const uint32_t* kh,
                                       const uint32_t* kl, int xd) {
  auto chunk = [&](int off) {
    const float4 x0 = *reinterpret_cast<const float4*>(q0 + off);
    const float4 x1 = *reinterpret_cast<const float4*>(q1 + off);
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
    for (int n = 0; n < 4; ++n) {
      const uint4 yh = *reinterpret_cast<const uint4*>(kh + 8 * n * D + off);
      const uint4 yl = *reinterpret_cast<const uint4*>(kl + 8 * n * D + off);
      const uint32_t bh0[2] = {yh.x, yh.y}, bl0[2] = {yl.x, yl.y};
      const uint32_t bh1[2] = {yh.z, yh.w}, bl1[2] = {yl.z, yl.w};
      mma_3xtf32(s[n], ah[0], al[0], bh0, bl0);
      mma_3xtf32(s[n], ah[1], al[1], bh1, bl1);
    }
  };
  if constexpr (D == 16) {
    chunk(0);
  } else {
#pragma unroll 2
    for (int d = 0; d < D; d += 32) {
      chunk(d + xd);
      chunk(d + 16 - xd);
    }
  }
}

// bfloat16: q0 / q1 / kg at dim 8t (D >= 32: a 32-dim chunk is two
// k-steps, dims 8t..8t+3 as columns {2t, 2t+1, 2t+8, 2t+9} of the first,
// 8t+4..8t+7 of the second) or 4t (D = 16: one k-step)
template <int D, int LD>
__device__ __forceinline__ void qk(float (&s)[4][4], const __nv_bfloat16* q0,
                                   const __nv_bfloat16* q1,
                                   const __nv_bfloat16* kg) {
  if constexpr (D >= 32) {
#pragma unroll 2
    for (int d = 0; d < D; d += 32) {
      const uint4 x0 = *reinterpret_cast<const uint4*>(q0 + d);
      const uint4 x1 = *reinterpret_cast<const uint4*>(q1 + d);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const uint4 y = *reinterpret_cast<const uint4*>(kg + 8 * n * LD + d);
        mma_bf16(s[n], x0.x, x1.x, x0.y, x1.y, y.x, y.y);
        mma_bf16(s[n], x0.z, x1.z, x0.w, x1.w, y.z, y.w);
      }
    }
  } else {
    const uint2 x0 = *reinterpret_cast<const uint2*>(q0);
    const uint2 x1 = *reinterpret_cast<const uint2*>(q1);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const uint2 y = *reinterpret_cast<const uint2*>(kg + 8 * n * LD);
      mma_bf16(s[n], x0.x, x1.x, x0.y, x1.y, y.x, y.y);
    }
  }
}

// Output groups of float32 p v: NG n-tiles of 8 dims, B-fragment column g of
// n-tile NG * j + m holding dim 8 * NG * j + NG * g + m.
template <int D>
struct Groups {
  static constexpr int NG = D >= 32 ? 4 : 2;
  static constexpr int N = D / (8 * NG);
};

// o += p v for the warp's 16 rows over the tile's 32 keys; p in the S
// accumulator's layout.  float32: k-step ks takes keys 8ks + 2t and
// 8ks + 2t + 1 as A-columns t and t + 4 (the thread's own s[ks]); v0 / v1
// point at those two keys' rows, at dim NG * g.
template <int D, int LD>
__device__ __forceinline__ void pv(float (&o)[D / 8][4],
                                   const float (&s)[4][4], const float* vt) {
  constexpr int NG = Groups<D>::NG;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t ah[4], al[4];
    split(s[ks][0], ah[0], al[0]);
    split(s[ks][2], ah[1], al[1]);
    split(s[ks][1], ah[2], al[2]);
    split(s[ks][3], ah[3], al[3]);
    const float* v0 = vt + 8 * ks * LD;
    const float* v1 = v0 + LD;
#pragma unroll
    for (int j = 0; j < Groups<D>::N; ++j) {
      float y0[NG], y1[NG];
      if constexpr (NG == 4) {
        const float4 a = *reinterpret_cast<const float4*>(v0 + 32 * j);
        const float4 b = *reinterpret_cast<const float4*>(v1 + 32 * j);
        y0[0] = a.x; y0[1] = a.y; y0[2] = a.z; y0[3] = a.w;
        y1[0] = b.x; y1[1] = b.y; y1[2] = b.z; y1[3] = b.w;
      } else {
        const float2 a = *reinterpret_cast<const float2*>(v0);
        const float2 b = *reinterpret_cast<const float2*>(v1);
        y0[0] = a.x; y0[1] = a.y;
        y1[0] = b.x; y1[1] = b.y;
      }
#pragma unroll
      for (int m = 0; m < NG; ++m) {
        uint32_t bh[2], bl[2];
        split(y0[m], bh[0], bl[0]);
        split(y1[m], bh[1], bl[1]);
        mma_3xtf32(o[NG * j + m], ah, al, bh, bl);
      }
    }
  }
}

// bfloat16: k-step ks takes keys 16ks..16ks+15 in the accumulator's own
// order (s[2ks], s[2ks+1]); v is read by ldmatrix.trans, lane l giving the
// row of key 16ks + 8((l >> 3) & 1) + (l & 7) at dim 8(l >> 4) (vt).
template <int D, int LD>
__device__ __forceinline__ void pv(float (&o)[D / 8][4],
                                   const float (&s)[4][4],
                                   const __nv_bfloat16* vt) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const uint32_t a0 = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
    const uint32_t a1 = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
    const uint32_t a2 = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
    const uint32_t a3 = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t b[4];
      ldsm_x4_trans(b, vt + 16 * ks * LD + 16 * j);
      mma_bf16(o[2 * j], a0, a1, a2, a3, b[0], b[1]);
      mma_bf16(o[2 * j + 1], a0, a1, a2, a3, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void store_row(float* dst, const float* x, int n) {
#pragma unroll
  for (int i = 0; i < n; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int B, int S, int T_len,
    int H, int KV, int hb, int n_qt, float scale2, int causal, int window,
    int q_off) {
  using L = Layout<T, D>;
  constexpr bool kF32 = L::kF32;
  constexpr int LDQ = L::kLDQ;
  constexpr int LDV = L::kLDV;
  constexpr int kBufs = L::kRing ? 2 : 1;

  // block -> (query tile, head group, batch row), the last query tile
  // first over every head group and batch row (block_plan's order)
  const int n_hg = H / hb;
  const int per_qt = n_hg * B;
  const int qt = n_qt - 1 - (int)blockIdx.x / per_qt;
  const int rest = (int)blockIdx.x % per_qt;
  const int h0 = (rest % n_hg) * hb;
  const int b = rest / n_hg;
  const int kvh = h0 / (H / KV);
  const int P = kRows / hb;                  // positions per block
  const int q0 = qt * P;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);   // [kRows][LDQ]
  T* k_s = q_s + L::kQ;                      // [kBufs][hi, lo][kBKV][LDQ]
  T* v_s = k_s + kBufs * L::kK;              // [kBufs][kBKV][LDV]

  // the kv tiles holding an attended key of this block (its queries sit at
  // positions q_off + q0 .. q_off + q_last)
  const int q_last = min(q0 + P, S) - 1;
  const int k_lo = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
  const int k_end = causal ? min(T_len, q_off + q_last + 1) : T_len;
  const int kt_lo = k_lo / kBKV;
  const int kt_hi = (k_end + kBKV - 1) / kBKV;

  // row `key` of this block's KV head in k or v
  auto kv_row = [=](const T* base, int key) {
    return base + (((size_t)b * T_len + min(key, T_len - 1)) * KV + kvh) * D;
  };
  auto stage_k = [&](int kt, int buf) {
    const int k0 = kt * kBKV;
    stage<T, D, LDQ, kF32>(k_s + buf * L::kK, kBKV, [=](int r, bool& ok) {
      ok = k0 + r < T_len;
      return kv_row(k, k0 + r);
    });
  };
  auto stage_v = [&](int kt, int buf) {
    const int k0 = kt * kBKV;
    stage<T, D, LDV, false>(v_s + buf * kBKV * LDV, kBKV,
                            [=](int r, bool& ok) {
      ok = k0 + r < T_len;
      return kv_row(v, k0 + r);
    });
  };

  // prologue: q and the first k tile (and v tile, with a ring)
  stage<T, D, LDQ, kF32>(q_s, kRows, [=](int r, bool& ok) {
    const int i = q0 + r / hb;
    ok = i < S;
    return q + (((size_t)b * S + min(i, S - 1)) * H + h0 + r % hb) * D;
  });
  if (kt_lo < kt_hi) {
    stage_k(kt_lo, 0);
    if (L::kRing) stage_v(kt_lo, 0);
  }
  commit_async();

  // this thread's rows (g and g + 8 of the warp)
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  // the warp's first and last query rows, and their positions
  const int w_lo = q0 + warp * 16 / hb, w_hi = q0 + (warp * 16 + 15) / hb;
  const int p_lo = q_off + w_lo, p_hi = q_off + w_hi;

  // fragment bases in buffer 0
  const T* qa = q_s + r0 * LDQ + (kF32 ? 4 : (D >= 32 ? 8 : 4)) * t;
  const T* qb = qa + 8 * LDQ;
  const T* kg = k_s + g * LDQ + (kF32 ? 4 : (D >= 32 ? 8 : 4)) * t;
  const T* vt;
  if constexpr (kF32)
    vt = v_s + 2 * t * LDV + Groups<D>::NG * g;
  else
    vt = v_s + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDV + (lane >> 4) * 8;

  // logits in base 2: x = (q . k) * scale2, scale2 = scale * log2(e),
  // p = 2^(x - max x)
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  int buf = 0;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBKV;
    // does any row of the warp attend a key of this tile, and does any
    // (row, key) pair of it fall outside the mask
    const bool active = w_lo < S && k0 < T_len && (!causal || k0 <= p_hi) &&
                        (window <= 0 || k0 + kBKV - 1 > p_lo - window);
    const bool edge = k0 + kBKV > T_len ||
                      (causal && k0 + kBKV - 1 > p_lo) ||
                      (window > 0 && k0 <= p_hi - window);

    // this tile's k (and v, with a ring) landed, and every warp is done
    // with the last tile's buffers: refill them
    wait_async_all();
    if constexpr (kF32) {
      T* kb = k_s + buf * L::kK;
      split_tile<D>(kb, kb + kBKV * D);
    }
    __syncthreads();
    if constexpr (L::kRing) {
      if (kt + 1 < kt_hi) {
        stage_k(kt + 1, buf ^ 1);
        stage_v(kt + 1, buf ^ 1);
      }
    } else {
      stage_v(kt, 0);
    }
    commit_async();

    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if (active) {
      if constexpr (kF32) {
        const uint32_t* kh =
            reinterpret_cast<const uint32_t*>(kg + buf * L::kK);
        qk_f32<D>(s, qa, qb, kh, kh + kBKV * D, 16 * (g & 1));
      } else {
        qk<D, LDQ>(s, qa, qb, kg + buf * L::kK);
      }
      // online softmax; thread (g, t) holds keys k0 + 8n + 2t + (e & 1) of
      // rows g (e < 2) and g + 8 (e >= 2).  A masked key's logit is -inf
      // here: it takes no part in the max, which starts at -1e30 as the
      // TPU kernel's masked logits, and its p is 0.
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale2;
      if (edge) {
        const int i0 = q_off + q0 + r0 / hb, i1 = q_off + q0 + r1 / hb;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * n + 2 * t + (e & 1);
            const int i = e < 2 ? i0 : i1;
            if (!(key < T_len && (!causal || key <= i) &&
                  (window <= 0 || key > i - window)))
              s[n][e] = -INFINITY;
          }
      }
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = ex2(m0 - mn0), c1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        s[n][0] = ex2(s[n][0] - mn0);
        s[n][1] = ex2(s[n][1] - mn0);
        s[n][2] = ex2(s[n][2] - mn1);
        s[n][3] = ex2(s[n][3] - mn1);
        sum0 += s[n][0] + s[n][1];
        sum1 += s[n][2] + s[n][3];
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
      // rescale o only where a row's max moved (x * 1 == x)
      if (__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[j][0] *= c0;
          o[j][1] *= c0;
          o[j][2] *= c1;
          o[j][3] *= c1;
        }
      }
    }

    if constexpr (!L::kRing) {
      // this tile's v landed, and every warp is done with the k tile
      wait_async_all();
      __syncthreads();
      if (kt + 1 < kt_hi) stage_k(kt + 1, 0);
      commit_async();
    }
    if (active) pv<D, LDV>(o, s, vt + buf * kBKV * LDV);
    if (L::kRing) buf ^= 1;
  }

  // out = o / max(l, 1e-30), rows past S not written
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den[2] = {fmaxf(l0, 1e-30f), fmaxf(l1, 1e-30f)};
  const int rows[2] = {r0, r1};
  const int pos[2] = {q0 + r0 / hb, q0 + r1 / hb};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (pos[half] >= S) continue;
    T* orow = out + (((size_t)b * S + pos[half]) * H + h0 +
                     rows[half] % hb) * D;
    if constexpr (kF32) {
      // group j: dims 8 NG j + 2 NG t + (c NG + m) <- o[NG j + m][c]
      constexpr int NG = Groups<D>::NG;
#pragma unroll
      for (int j = 0; j < Groups<D>::N; ++j) {
        float x[2 * NG];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int m = 0; m < NG; ++m)
            x[c * NG + m] = o[NG * j + m][2 * half + c] / den[half];
        store_row(orow + 8 * NG * j + 2 * NG * t, x, 2 * NG);
      }
    } else {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack_bf16(o[j][2 * half] / den[half],
                      o[j][2 * half + 1] / den[half]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int T_len, int H, int KV, float scale,
                   int causal, int window, int q_off, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D>::kSmem;
  static unsigned attr_set = 0;            // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && dev < 32 && !(attr_set >> dev & 1u)) {
    e = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    attr_set |= 1u << dev;
  }
  // heads per block: the whole GQA group where it divides the block's rows
  const int rep = H / KV;
  const int hb = kRows % rep == 0 ? rep : 1;
  const int P = kRows / hb;
  const int n_qt = (S + P - 1) / P;
  const long long blocks = (long long)n_qt * (H / hb) * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_attention_kernel<T, D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), B, S, T_len, H, KV, hb,
      n_qt, scale * 1.4426950408889634f, causal, window, q_off);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* out, int B, int S, int T_len, int H, int KV,
                     float scale, int causal, int window, int q_off,
                     cudaStream_t stream) {
#define FLASH_CASE(d)                                                       \
  case d:                                                                   \
    return launch<T, d>(q, k, v, out, B, S, T_len, H, KV, scale, causal,    \
                        window, q_off, stream);
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(96)
    FLASH_CASE(128)
    FLASH_CASE(160)
    FLASH_CASE(192)
    FLASH_CASE(224)
    FLASH_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
extern "C" cudaError_t flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out, int B,
    int S, int T, int H, int KV, int D, float scale, int causal, int window,
    int q_off, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, out, B, S, T, H, KV, scale, causal,
                           window, q_off, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, out, B, S, T, H, KV, scale,
                                   causal, window, q_off, st);
  return cudaErrorInvalidValue;
}
