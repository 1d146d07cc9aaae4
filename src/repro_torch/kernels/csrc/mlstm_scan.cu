// The mLSTM recurrence over a sequence, for Hopper, in place on the state
// rows it reads and writes.  Two kernels: a strip kernel for one position
// (S = 1, every decode step) and a chunkwise kernel on the tensor cores for
// a sequence (S > 1, a prefill).  The wrapper picks by S alone.
//
// No Pallas kernel stands behind them: the reference runs the recurrence
// as a lax.scan over positions (repro/models/recurrent.py::mlstm_apply,
// :116-140) and one cell for a decode token (::mlstm_step, :149), which
// XLA compiles to one loop on the chip.  The port's plain version is a
// Python loop over positions whose every op rewrites the whole matrix
// state C (nh x hd x hd float32: 16.8 MB a row at xlstm-1.3b's 4 heads of
// 1024), and a paged decode step gathered, unpacked, packed and scattered
// the whole state page around it.  Both kernels keep C on the chip for all
// S positions and read and write it where it lives.
//
// Per row b, head h and position t, in the plain version's order:
//
//   k_t    = k_t / sqrt(hd)
//   m_new  = max(f_t + m, i_t);  i_p = exp(i_t - m_new)
//   f_p    = exp((f_t + m) - m_new)
//   n      = f_p * n + i_p * k_t
//   C      = f_p * C + i_p * (k_t v_t^T)      (f_p*C, k*v, i_p*(k*v), sum)
//   h_t    = (C^T q_t) / max(|n . q_t|, 1)
//
// The strip kernel (S = 1) rounds every product and sum of the state on
// its own (__fmul_rn / __fadd_rn, so no multiply-add contraction changes a
// bit; k / sqrt(hd) a division; expf, not __expf): C, n and m come out
// bit-equal to the plain version; h sums its two dot products in another
// order (fused multiply-adds, per warp then across warps) and is held to a
// bound on that difference (mlstm_scan.py).
//
// Strip kernel grid (hd / 32 strips, nh, B): a block owns one strip of 32
// columns of one head's C, [hd, 32] (8 warps, each 32 lanes x hd / 8 rows),
// reads it once from the source row (zeros for row -1), keeps it in
// registers for all S positions (128 floats a thread at hd = 1024, one
// block an SM), and writes it once to each destination row.  The scalars,
// n (hd floats) and the denominator are recomputed by every strip of a
// head: no block needs another's data, so nothing crosses blocks.  q and
// the scaled k of a position sit in shared memory (double-buffered: two
// barriers a position), and the next position's inputs are loaded into
// registers while the current one runs.
//
// What bounds the strip kernel on an H100.  A decode step (S = 1) is
// bytes: C read once and written once to each tier, 16.8 MB x 3 a row,
// 0.06 ms at B = 4 and 3.35 TB/s; a warp moves one 128-byte row of its
// strip a load or store, with all of a thread's rows in flight at once.
// (A form that streamed the strip 16 rows at a time, two blocks an SM,
// measured slower on an H100.)  Over a sequence it does 6 float32
// operations an element of C a position, unfused, with two barriers a
// position: issue-bound (0.56 ms for S = 256, B = 1 on an H100), which is
// why a sequence takes the chunkwise kernel below.
//
// In place: a block reads only its own strip of its source row and writes
// only that strip of its destination rows.  The caller keeps every row a
// launch writes distinct from every other row's source (a row the step
// drops reads no page: source -1, a zero C).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTv = 32;                      // columns of C a block owns
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHd = 1024;
constexpr int kMaxRows = kMaxHd / kWarps;    // rows of the strip a thread
constexpr int kMaxLoad = kMaxHd / kThreads;  // q / k elements a thread loads

// C = f_p*C + i_p*(k*v) for four rows of a thread's column, and their
// share of C^T q, in the plain version's rounding order
__device__ __forceinline__ void update4(float* c, float4 kk, float4 qq,
                                        float vt, float f_p, float i_p,
                                        float& num) {
  const float kr[4] = {kk.x, kk.y, kk.z, kk.w};
  const float qr[4] = {qq.x, qq.y, qq.z, qq.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float kv = __fmul_rn(kr[u], vt);
    c[u] = __fadd_rn(__fmul_rn(f_p, c[u]), __fmul_rn(i_p, kv));
    num = __fmaf_rn(c[u], qr[u], num);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
mlstm_scan_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ ig,
                  const float* __restrict__ fg, const float* __restrict__ n0,
                  const float* __restrict__ m0, const float* src,
                  const int64_t* __restrict__ src_rows, int64_t src_stride,
                  float* dst1, const int64_t* __restrict__ dst1_rows,
                  int64_t dst1_stride, float* dst2,
                  const int64_t* __restrict__ dst2_rows, int64_t dst2_stride,
                  float* __restrict__ h, float* __restrict__ n_out,
                  float* __restrict__ m_out, int seq, int nh, int hd,
                  float sqrt_hd) {
  __shared__ __align__(16) float q_s[2][kMaxHd];
  __shared__ __align__(16) float k_s[2][kMaxHd];
  __shared__ float red_num[kWarps][kTv];
  __shared__ float red_den[kWarps];

  const int strip = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = hd / kWarps;              // a multiple of 4
  const int row0 = warp * rows;
  const int col = strip * kTv + lane;
  const size_t bh = static_cast<size_t>(b) * nh + head;
  const size_t mat = static_cast<size_t>(hd) * hd;
  const size_t off = static_cast<size_t>(head) * mat +
                     static_cast<size_t>(row0) * hd + col;

  // this thread's column of the strip, at the source row and each
  // destination row (a destination row -1 is not written)
  const int64_t srow = src_rows[b];
  const float* cs = src + (srow >= 0 ? srow : 0) * src_stride + off;
  float* cd[2] = {nullptr, nullptr};
  if (dst1 != nullptr && dst1_rows[b] >= 0)
    cd[0] = dst1 + dst1_rows[b] * dst1_stride + off;
  if (dst2 != nullptr && dst2_rows[b] >= 0)
    cd[1] = dst2 + dst2_rows[b] * dst2_stride + off;

  // the strip of C in registers, from the source row
  float c[kMaxRows];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    if (i < rows) c[i] = srow >= 0 ? cs[static_cast<size_t>(i) * hd] : 0.f;
  }
  // this thread's elements of n (the same ones it loads of q and k)
  float n[kMaxLoad];
#pragma unroll
  for (int j = 0; j < kMaxLoad; ++j) {
    const int e = tid + j * kThreads;
    n[j] = e < hd ? n0[bh * hd + e] : 0.f;
  }
  float m = m0[bh];

  // the inputs of position t, loaded one position ahead
  float pq[kMaxLoad], pk[kMaxLoad], pv, pi, pf;
  auto fetch = [&](int t) {
    const size_t bt = static_cast<size_t>(b) * seq + t;
    const size_t base = (bt * nh + head) * hd;
#pragma unroll
    for (int j = 0; j < kMaxLoad; ++j) {
      const int e = tid + j * kThreads;
      pq[j] = e < hd ? q[base + e] : 0.f;
      pk[j] = e < hd ? k[base + e] : 0.f;
    }
    pv = v[base + col];
    pi = ig[bt * nh + head];
    pf = fg[bt * nh + head];
  };
  fetch(0);

  for (int t = 0; t < seq; ++t) {
    const int buf = t & 1;
    float ks[kMaxLoad], qs[kMaxLoad];
#pragma unroll
    for (int j = 0; j < kMaxLoad; ++j) {
      const int e = tid + j * kThreads;
      ks[j] = __fdiv_rn(pk[j], sqrt_hd);
      qs[j] = pq[j];
      if (e < hd) {
        k_s[buf][e] = ks[j];
        q_s[buf][e] = qs[j];
      }
    }
    const float vt = pv, it = pi, ft = pf;
    if (t + 1 < seq) fetch(t + 1);
    __syncthreads();

    const float fm = __fadd_rn(ft, m);
    const float m_new = fmaxf(fm, it);
    const float i_p = expf(__fsub_rn(it, m_new));
    const float f_p = expf(__fsub_rn(fm, m_new));
    m = m_new;

    // n and this thread's share of n . q
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxLoad; ++j) {
      n[j] = __fadd_rn(__fmul_rn(f_p, n[j]), __fmul_rn(i_p, ks[j]));
      dot = __fmaf_rn(n[j], qs[j], dot);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (lane == 0) red_den[warp] = dot;

    // the strip's update and this thread's share of C^T q
    float num = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(k_s[buf] + row0);
    const float4* q4 = reinterpret_cast<const float4*>(q_s[buf] + row0);
#pragma unroll
    for (int i4 = 0; i4 < kMaxRows / 4; ++i4) {
      if (4 * i4 < rows)
        update4(c + 4 * i4, k4[i4], q4[i4], vt, f_p, i_p, num);
    }
    red_num[warp][lane] = num;
    __syncthreads();

    if (warp == 0) {
      float d = 0.f, s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        d = __fadd_rn(d, red_den[w]);
        s = __fadd_rn(s, red_num[w][lane]);
      }
      const float den = fmaxf(fabsf(d), 1.f);
      const size_t bt = static_cast<size_t>(b) * seq + t;
      h[(bt * nh + head) * hd + col] = __fdiv_rn(s, den);
    }
  }

  // the strip to each destination row
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    if (cd[d] == nullptr) continue;
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      if (i < rows) cd[d][static_cast<size_t>(i) * hd] = c[i];
    }
  }
  if (strip == 0) {
#pragma unroll
    for (int j = 0; j < kMaxLoad; ++j) {
      const int e = tid + j * kThreads;
      if (e < hd) n_out[bh * hd + e] = n[j];
    }
    if (tid == 0) m_out[bh] = m;
  }
}

}  // namespace

// q, k, v f32 [B, S, nh, hd]; ig, fg f32 [B, S, nh]; n0 f32 [B, nh, hd];
// m0 f32 [B, nh]; src f32 [P, >= nh*hd*hd] rows of src_stride floats,
// src_rows int64 [B] (-1: a zero C); dst1 (and dst2, or null) likewise
// with their rows (-1: no write); h f32 [B, S, nh, hd], n_out, m_out as
// n0, m0.  hd a multiple of 32, at most 1024.  Returns the launch's CUDA
// error, or 0.
extern "C" int mlstm_scan_launch(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fg, const void* n0, const void* m0, const void* src,
    const void* src_rows, int64_t src_stride, void* dst1,
    const void* dst1_rows, int64_t dst1_stride, void* dst2,
    const void* dst2_rows, int64_t dst2_stride, void* h, void* n_out,
    void* m_out, int batch, int seq, int nh, int hd, float sqrt_hd,
    void* stream_ptr) {
  if (hd % kTv != 0 || hd > kMaxHd || hd <= 0 || seq <= 0 || batch <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  mlstm_scan_kernel<<<dim3(hd / kTv, nh, batch), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<const float*>(n0),
      static_cast<const float*>(m0), static_cast<const float*>(src),
      static_cast<const int64_t*>(src_rows), src_stride,
      static_cast<float*>(dst1), static_cast<const int64_t*>(dst1_rows),
      dst1_stride, static_cast<float*>(dst2),
      static_cast<const int64_t*>(dst2_rows), dst2_stride,
      static_cast<float*>(h), static_cast<float*>(n_out),
      static_cast<float*>(m_out), seq, nh, hd, sqrt_hd);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// S > 1: the chunkwise form on the tensor cores
// ---------------------------------------------------------------------------
//
// The mLSTM has no nonlinearity on its recurrent path, so a chunk of L
// positions can be done as matrix products.  Per (row, head) and a chunk
// of positions c..c+L-1, with the state C, n before it:
//
//   m       the plain version's own serial chain, fm = f + m, m = max(fm,
//           i), in its order and rounding: m comes out bit-equal.  With it
//           a_p = fm - m_new and b_p = i - m_new, the plain version's own
//           arguments of f_p = exp(a_p) and i_p = exp(b_p);
//   A_t     = sum_{p=c..t} a_p in double (each a_p clamped at -1e4: such
//           a step zeroes everything it carries in either version);
//   D_tj    = exp(b_j + A_t - A_j), j <= t: the weight the plain version's
//           products f_p and i_j give term j at position t (telescoped);
//   g_t     = exp(A_t): the weight of the state before the chunk;
//   h_t     = (g_t C^T q_t + sum_j D_tj (q_t . k~_j) v_j)
//             / max(|g_t n . q_t + sum_j D_tj (q_t . k~_j)|, 1);
//   C       <- g_{c+L-1} C + sum_j D_{c+L-1,j} k~_j v_j^T, n likewise,
//
// with k~ = k / sqrt(hd) (here 1 / sqrt(hd) is taken with D, not with k).
// The exponents are taken from the double sums rounded to float once, so
// D and g are within expf's ulps and one rounding of their argument of
// the plain version's products.  The products over hd or
// over positions run on the tensor cores as 3xTF32 (each operand split
// into hi = rna(x) and lo = rna(x - hi) to TF32, lo*hi + hi*lo + hi*hi
// into one float32 accumulator, as csrc/flash_attention.cu does): C^T q
// [32, L] and q . k~ [L, L] a chunk, the chunk's h [L, 32] and its update
// of C [hd, 32].  C, n and h are held to bounds derived from the plain
// replay's magnitudes (mlstm_scan.py: tolerances).
//
// Grid (hd / 32 strips, nh, B), as the strip kernel: a block owns one
// strip of 32 columns of one head's C and keeps it, transposed [32, hd],
// as mma accumulators in registers for all chunks (warp w owns hd rows
// 8 nks w .. 8 nks (w + 1) - 1, nks = ceil(hd / 64); 128 floats a thread
// at hd = 1024).  That accumulator layout is also the A operand of C^T q
// once the 8 rows of a k-step are read in the order 2t, 2t + 1 (the order
// of a k-step's sum is free), so C never leaves the registers.  Each
// chunk's q . k comes from a pre-pass kernel (one block a chunk and head,
// the same split of the hd rows over warps); every strip of a head
// recomputes n and the denominators: no block of the chunkwise kernel
// needs another's data, and every sum runs in a fixed order, so repeats
// are bit-identical.  While warps 0-3 take this chunk's h, warp 4 runs the
// next chunk's m chain and warps 5-7 issue the next chunk's copies.  Shared memory: the chunk's q and k rows (k
// double-buffered; rows padded to 8 words mod 32 so both fragment
// patterns are free of bank conflicts), v's strip (double-buffered), the
// per-warp partials and their sums, D q . k~ -- 224,160 bytes at hd =
// 1024.  The bulk copy engine brings each row (one cp.async.bulk a lane,
// completing on an mbarrier): the next chunk's k, q and v during this
// chunk's h and update, a warp each (a bulk copy holds its lane ~100
// cycles; issued from warp 0 at the chunk's start they held it back: 10%
// slower on an H100).
//
// What bounds it on an H100: operations on the tensor cores.  A chunk of L
// positions does 2 L hd hd (C^T q) + 2 L hd hd (update) + 4 L L hd (q . k~
// and D v) flops a head; at S = 256, B = 1, 4 heads of 1024 and L = 16
// that is 4.36 GFLOP, times 3 for 3xTF32 at 495 TFLOP/s: 0.026 ms; its
// bytes (C in and out, q, k, v, h) are 50 MB, 0.015 ms at 3.35 TB/s.
// Each strip block reads the chunk's q and k from L2 (q . k in every
// strip block was a third of its products; the pre-pass does it once).
// Measured on an H100 (PERF.md): ~0.15 ms at that shape (the pre-pass
// 0.008 of it), 3.7x faster than the strip kernel; 8 warps an SM, two to
// a scheduler, issue the 3xTF32 splits and fragment loads beside the
// tensor-core products and are bound by both (sharing q and k across a
// cluster of 2 strips by multicast moved it by 1-2%: not kept).
namespace {

// Positions a chunk, L = 16.  Shared memory sets it: the chunk's q and k
// rows (k double-buffered) take 3 L (hd + 8) floats, 198 KB of the 224 KB
// at hd = 1024, so L = 32 (396 KB) does not fit the 227 KB a block may
// have.  The m chain's warp also holds a chunk's i and log f in its 32
// lanes (2 L <= 32), and L is the n of C^T q's two m16n8 tiles and the k
// of the update's two k-steps.  A smaller L passes over C more often (a
// chunk's update reads and writes every accumulator); no other L was
// measured on an H100.
constexpr int kL = 16;
constexpr int kMaxSteps = kMaxHd / 64;      // k-steps (8 rows) a warp owns
constexpr int kVld = 40;                    // row stride of v's tiles
constexpr int kPld = 20;                    // row stride of D q . k~
constexpr int kChainWarp = 4;               // the warp that runs the m chain
constexpr double kClampA = -1e4;            // a_p below it zeroes its terms
constexpr int kLoadWarp = 5;                // warps 5-7 issue the copies

// q and k rows padded to 8 words mod 32: the float2 loads at (row g,
// column 2t) and the loads at (row t, column g) are free of bank conflicts
__host__ __device__ constexpr int ldq(int hd) { return hd + 8; }

constexpr size_t chunk_smem_bytes(int hd) {
  return 4 * sizeof(uint64_t) + 2 * kL * sizeof(double) +
         sizeof(float) * (static_cast<size_t>(3) * kL * ldq(hd) +
                          2 * kL * kVld + (kWarps + 1) * kTv * kL +
                          kWarps * kL + kL * kPld +
                          2 * kL + 4 * kL);
}
static_assert(chunk_smem_bytes(kMaxHd) <= 232448,
              "the chunkwise kernel's shared memory at hd = 1024");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one contiguous row global -> shared by the bulk copy engine, completing
// on the mbarrier `bar`
__device__ __forceinline__ void bulk_row(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// TF32 rounding as cvt.rna.tf32.f32 on the bit pattern, and the 3xTF32
// split hi = rna(x), lo = rna(x - hi) (lo handed over with the half-range
// added: the tensor core reads its top 19 bits), as flash_attention.cu
// (cvt.rna.tf32.f32 itself measured slower here on an H100)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: the two small terms first, then hi * hi, into one accumulator
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// one step of reducing a lane's kL sums across the warp: lanes whose bit
// 2 H is set keep sums H .. 2 H - 1, the others 0 .. H - 1, each added to
// its partner's
template <int H>
__device__ __forceinline__ void halve(float (&pq)[kL], int lane) {
  const bool up = lane & (2 * H);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? pq[i] : pq[i + H];
    const float keep = up ? pq[i + H] : pq[i];
    pq[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 2 * H));
  }
}

// D_tj / sqrt(hd): the argument summed in double, rounded to float once
__device__ __forceinline__ float decay(const double* a_s, const float* b_s,
                                       int t, int j, float sqrt_hd) {
  const float arg = static_cast<float>(static_cast<double>(b_s[j]) +
                                       (a_s[t] - a_s[j]));
  return __fdiv_rn(expf(arg), sqrt_hd);
}

// The m chain of one chunk (lc positions), run by every lane of one warp
// alike from the gates it holds (lane t < kL: i_t, lane kL + t: log f_t):
// lane t keeps position t's b_t, A_t (the double sum of the a_p, each
// clamped) and g_t = exp(A_t) in b_s, a_s and g_s.  Returns the new m.
// (Each lane picks its position's values by a select and takes its exp
// after the chain: a store and an exp under `lane == t` a step made the
// warp run them one lane at a time, 3.8k cycles a chunk on an H100.)
__device__ __forceinline__ float chain(float m, float gate, int lc, int lane,
                                       double* a_s, float* b_s, float* g_s) {
  float it[kL], ft[kL];
#pragma unroll
  for (int t = 0; t < kL; ++t) {
    it[t] = __shfl_sync(0xffffffffu, gate, t);
    ft[t] = __shfl_sync(0xffffffffu, gate, kL + t);
  }
  double acc = 0.0, my_a = 0.0;
  float my_b = 0.f;
#pragma unroll
  for (int t = 0; t < kL; ++t) {
    if (t < lc) {
      const float fm = __fadd_rn(ft[t], m);
      const float mn = fmaxf(fm, it[t]);
      acc += fmax(static_cast<double>(__fsub_rn(fm, mn)), kClampA);
      const float bt = __fsub_rn(it[t], mn);
      my_a = lane == t ? acc : my_a;
      my_b = lane == t ? bt : my_b;
      m = mn;
    }
  }
  if (lane < lc) {
    b_s[lane] = my_b;
    a_s[lane] = my_a;
    g_s[lane] = expf(static_cast<float>(my_a));
  }
  return m;
}

// q . k [L, L] of every chunk, before the chunkwise kernel: grid (chunks,
// nh, B), 8 warps, warp w the same hd rows as in the chunkwise kernel, its
// partial on the tensor cores as 3xTF32, the warps' partials summed in
// order into qk[b][head][chunk] (rows past S zero).  Every strip of a head
// reads it instead of computing it again.
__global__ void __launch_bounds__(kThreads)
mlstm_scan_qk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     float* __restrict__ qk, int seq, int nh, int hd) {
  __shared__ float sp_s[kWarps][kL][kL];
  const int ch = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int nks = (hd + 63) / 64, ks0 = warp * nks;
  const int steps = min(max(hd / 8 - ks0, 0), nks);
  const size_t pos_stride = static_cast<size_t>(nh) * hd;
  // rows gq and gq + 8 of the chunk (zero past S)
  const int p0 = ch * kL + gq, p1 = p0 + 8;
  const bool ok0 = p0 < seq, ok1 = p1 < seq;
  const size_t base = (static_cast<size_t>(b) * seq * nh + head) * hd;
  const float* q0 = q + base + (ok0 ? p0 : 0) * pos_stride;
  const float* q1 = q + base + (ok1 ? p1 : 0) * pos_stride;
  const float* k0 = k + base + (ok0 ? p0 : 0) * pos_stride;
  const float* k1 = k + base + (ok1 ? p1 : 0) * pos_stride;
  // every step's fragments loaded first (all in flight at once), then the
  // products in step order
  float2 x[kMaxSteps][4];
  const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s) {
    const int col = 8 * (ks0 + s) + 2 * tq;
    const bool in = s < steps;
    x[s][0] = in && ok0 ? *reinterpret_cast<const float2*>(q0 + col) : zero;
    x[s][1] = in && ok1 ? *reinterpret_cast<const float2*>(q1 + col) : zero;
    x[s][2] = in && ok0 ? *reinterpret_cast<const float2*>(k0 + col) : zero;
    x[s][3] = in && ok1 ? *reinterpret_cast<const float2*>(k1 + col) : zero;
  }
  float sa[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s) {
    if (s >= steps) break;
    const float2 x0 = x[s][0], x1 = x[s][1], y0 = x[s][2], y1 = x[s][3];
    uint32_t qh[4], ql[4], kh[4], kl[4];
    split(x0.x, qh[0], ql[0]);
    split(x1.x, qh[1], ql[1]);
    split(x0.y, qh[2], ql[2]);
    split(x1.y, qh[3], ql[3]);
    split(y0.x, kh[0], kl[0]);
    split(y1.x, kh[1], kl[1]);
    split(y0.y, kh[2], kl[2]);
    split(y1.y, kh[3], kl[3]);
    mma3(sa[0], qh, ql, kh[0], kh[2], kl[0], kl[2]);
    mma3(sa[1], qh, ql, kh[1], kh[3], kl[1], kl[3]);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int j = 8 * nt + 2 * tq;
    sp_s[warp][gq][j] = sa[nt][0];
    sp_s[warp][gq][j + 1] = sa[nt][1];
    sp_s[warp][gq + 8][j] = sa[nt][2];
    sp_s[warp][gq + 8][j + 1] = sa[nt][3];
  }
  __syncthreads();
  const int t = tid >> 4, j = tid & 15;
  float sv = sp_s[0][t][j];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) sv = __fadd_rn(sv, sp_s[w][t][j]);
  const int nch = (seq + kL - 1) / kL;
  qk[((static_cast<size_t>(b) * nh + head) * nch + ch) * kL * kL + tid] = sv;
}

__global__ void __launch_bounds__(kThreads, 1)
mlstm_scan_chunk_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ ig,
    const float* __restrict__ fg, const float* __restrict__ n0,
    const float* __restrict__ m0, const float* src,
    const int64_t* __restrict__ src_rows, int64_t src_stride, float* dst1,
    const int64_t* __restrict__ dst1_rows, int64_t dst1_stride, float* dst2,
    const int64_t* __restrict__ dst2_rows, int64_t dst2_stride,
    float* __restrict__ h, float* __restrict__ n_out,
    float* __restrict__ m_out, const float* __restrict__ qk,
    float* __restrict__ c_save, float* __restrict__ n_save,
    float* __restrict__ d_save, int seq, int nh, int hd, float sqrt_hd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem_raw);  // q and v in
  uint64_t* full_k = full_q + 1;                      // [2]: k in
  double* a_s = reinterpret_cast<double*>(full_q + 4);  // [2][kL] A_t
  const int lq = ldq(hd);
  float* q_s = reinterpret_cast<float*>(a_s + 2 * kL);  // [kL][lq]
  float* k_s = q_s + kL * lq;                          // [2][kL][lq]
  float* v_s = k_s + 2 * kL * lq;                      // [2][kL][kVld]
  float* cq_s = v_s + 2 * kL * kVld;                   // [kWarps][kTv][kL]
  float* cqr_s = cq_s + kWarps * kTv * kL;             // [kTv][kL] summed
  float* nq_s = cqr_s + kTv * kL;                      // [kWarps][kL]
  float* p_s = nq_s + kWarps * kL;                     // [kL][kPld]
  float* wt_s = p_s + kL * kPld;                       // [kL]
  float* den_s = wt_s + kL;                            // [kL]
  float* b_s = den_s + kL;                             // [2][kL]
  float* g_s = b_s + 2 * kL;                           // [2][kL]

  const int strip = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // the mma fragments' group, thread
  const int nks = (hd + 63) / 64;
  const int ks0 = warp * nks;               // this warp's first k-step
  const int steps = min(max(hd / 8 - ks0, 0), nks);
  const int r0 = 8 * ks0, r1 = 8 * (ks0 + steps);  // its hd rows
  const int col0 = strip * kTv;
  const int nch = (seq + kL - 1) / kL;
  const size_t bh = static_cast<size_t>(b) * nh + head;
  const size_t mat = static_cast<size_t>(hd) * hd;

  // the offset of row (b, pos, head) of q, k, v or h
  auto row_off = [&](int pos) {
    return ((static_cast<size_t>(b) * seq + pos) * nh + head) * hd;
  };
  auto rows_in = [&](int ch) { return min(kL, seq - ch * kL); };
  // chunk ch's rows, issued by one warp (a lane a row): k to k_s[buf], q
  // to q_s (its expected bytes count v's too), this strip of v to v_s[buf]
  auto load_k = [&](int ch, int buf) {
    const int lc = rows_in(ch);
    if (lane == 0) mbar_expect_tx(full_k + buf, lc * hd * 4);
    if (lane < lc)
      bulk_row(k_s + (buf * kL + lane) * lq, k + row_off(ch * kL + lane),
               hd * 4, full_k + buf);
  };
  auto load_q = [&](int ch) {
    const int lc = rows_in(ch);
    if (lane == 0) mbar_expect_tx(full_q, lc * (hd + kTv) * 4);
    if (lane < lc)
      bulk_row(q_s + lane * lq, q + row_off(ch * kL + lane), hd * 4, full_q);
  };
  auto load_v = [&](int ch, int buf) {
    if (lane < rows_in(ch))
      bulk_row(v_s + (buf * kL + lane) * kVld,
               v + row_off(ch * kL + lane) + col0, kTv * 4, full_q);
  };
  // the chain warp's gates of chunk ch: lane t < kL i_t, lane kL + t f_t
  auto gate_of = [&](int ch) {
    const int t = lane % kL, pos = ch * kL + t;
    const float* gp = lane < kL ? ig : fg;
    return pos < seq ? gp[(static_cast<size_t>(b) * seq + pos) * nh + head]
                     : 0.f;
  };

  if (tid == 0) {
    mbar_init(full_q, 1);
    mbar_init(full_k, 1);
    mbar_init(full_k + 1, 1);
    // the barriers' initialisation visible to the bulk copy engine
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    load_q(0);
    load_v(0, 0);
    load_k(0, 0);
  }

  // the strip of C^T as accumulators: c[s][mt] is the m16n8 tile of columns
  // 16 mt .. 16 mt + 15 and hd rows 8 (ks0 + s) ..; element e is column
  // 16 mt + gq + 8 (e >> 1), row 8 (ks0 + s) + 2 tq + (e & 1)
  const int64_t srow = src_rows[b];
  const float* cs = src + (srow >= 0 ? srow : 0) * src_stride +
                    head * mat + col0;
  float c[kMaxSteps][2][4];
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * (ks0 + s) + 2 * tq + (e & 1);
        const int cc = 16 * mt + gq + 8 * (e >> 1);
        c[s][mt][e] = (s < steps && srow >= 0)
                          ? cs[static_cast<size_t>(r) * hd + cc]
                          : 0.f;
      }
    }
  }
  // n: this lane's rows r0 + lane + 32 j of the warp's
  float nr[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = r0 + lane + 32 * j;
    nr[j] = r < r1 ? n0[bh * hd + r] : 0.f;
  }
  // the chain warp's m (every lane alike) and chunk 0's scalars
  float m = m0[bh];
  if (warp == kChainWarp)
    m = chain(m, gate_of(0), rows_in(0), lane, a_s, b_s, g_s);

  for (int ch = 0; ch < nch; ++ch) {
    const int cur = ch & 1;
    const int lc = rows_in(ch);
    const double* ac = a_s + cur * kL;
    const float* bc = b_s + cur * kL;
    const float* gc = g_s + cur * kL;
    // the next chunk's gates, for the chain during this chunk's h
    const float gate = warp == kChainWarp && ch + 1 < nch ? gate_of(ch + 1)
                                                          : 0.f;
    // no block barrier here: a warp that is done with the last chunk goes
    // on as soon as this chunk's rows are in, while warps 0-3 may still
    // take its h (this chunk's partials go to the warps' own slots; the
    // barrier after them orders everything shared)
    mbar_wait(full_q, ch & 1);
    mbar_wait(full_k + cur, (ch >> 1) & 1);
    if (lc < kL) {                // rows past S: zeros, not stale bytes
      __syncthreads();
      for (int e = tid; e < (kL - lc) * lq; e += kThreads) {
        q_s[lc * lq + e] = 0.f;
        k_s[(cur * kL + lc) * lq + e] = 0.f;
      }
      for (int e = tid; e < (kL - lc) * kVld; e += kThreads)
        v_s[(cur * kL + lc) * kVld + e] = 0.f;
      __syncthreads();
    }
    const float* kc = k_s + cur * kL * lq;
    const float* vc = v_s + cur * kL * kVld;
    if (c_save != nullptr) {
      // the saves for the backward: C and n before this chunk
      float* cb = c_save + (bh * nch + ch) * mat + col0;
#pragma unroll
      for (int s = 0; s < kMaxSteps; ++s) {
        if (s < steps) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 8 * (ks0 + s) + 2 * tq + (e & 1);
              const int cc = 16 * mt + gq + 8 * (e >> 1);
              cb[static_cast<size_t>(r) * hd + cc] = c[s][mt][e];
            }
          }
        }
      }
      if (strip == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + lane + 32 * j;
          if (r < r1) n_save[(bh * nch + ch) * hd + r] = nr[j];
        }
      }
    }

    // this chunk's q . k (the pre-pass's), for the sums after the loop
    const float qk_tj =
        qk[((static_cast<size_t>(b) * nh + head) * nch + ch) * kL * kL + tid];
    // this warp's rows of C^T q [32, L]
    float cqa[2][2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cqa[0][0][e] = cqa[0][1][e] = cqa[1][0][e] = cqa[1][1][e] = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSteps; ++s) {
      if (s < steps) {
        const int col = 8 * (ks0 + s) + 2 * tq;
        const float2 x0 =
            *reinterpret_cast<const float2*>(q_s + gq * lq + col);
        const float2 x1 =
            *reinterpret_cast<const float2*>(q_s + (gq + 8) * lq + col);
        // q as the B operand of C^T q: positions gq (x0) and gq + 8 (x1),
        // the k-step's rows tq, tq + 4 being hd rows 2 tq, 2 tq + 1
        uint32_t qh[4], ql[4];
        split(x0.x, qh[0], ql[0]);
        split(x1.x, qh[1], ql[1]);
        split(x0.y, qh[2], ql[2]);
        split(x1.y, qh[3], ql[3]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t ah[4], al[4];
          split(c[s][mt][0], ah[0], al[0]);
          split(c[s][mt][2], ah[1], al[1]);
          split(c[s][mt][1], ah[2], al[2]);
          split(c[s][mt][3], ah[3], al[3]);
          mma3(cqa[mt][0], ah, al, qh[0], qh[2], ql[0], ql[2]);
          mma3(cqa[mt][1], ah, al, qh[1], qh[3], ql[1], ql[3]);
        }
      }
    }
    // this warp's rows of n . q_t, fused multiply-adds a lane over its rows,
    // then halved across lanes down to one position a lane pair
    float pq[kL];
#pragma unroll
    for (int t = 0; t < kL; ++t) pq[t] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + lane + 32 * j;
      if (r < r1) {
#pragma unroll
        for (int t = 0; t < kL; ++t)
          pq[t] = __fmaf_rn(nr[j], q_s[t * lq + r], pq[t]);
      }
    }
    halve<8>(pq, lane);
    halve<4>(pq, lane);
    halve<2>(pq, lane);
    halve<1>(pq, lane);
    pq[0] = __fadd_rn(pq[0], __shfl_xor_sync(0xffffffffu, pq[0], 1));
    if ((lane & 1) == 0) {
      const int t = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                    ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
      nq_s[warp * kL + t] = pq[0];
    }
    {
      float* cqw = cq_s + warp * kTv * kL;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int cl = 16 * mt + gq, t = 8 * nt + 2 * tq;
          *reinterpret_cast<float2*>(cqw + cl * kL + t) =
              make_float2(cqa[mt][nt][0], cqa[mt][nt][1]);
          *reinterpret_cast<float2*>(cqw + (cl + 8) * kL + t) =
              make_float2(cqa[mt][nt][2], cqa[mt][nt][3]);
        }
      }
    }
    __syncthreads();  // partials in; q_s free

    // the warps' partials summed in order: D q . k~ (and its row sums, the
    // denominators), C^T q, n . q; the update's weights
    {
      const int t = tid >> 4, j = tid & 15;
      const float sv = qk_tj;
      const float dt = (j <= t && t < lc) ? decay(ac, bc, t, j, sqrt_hd)
                                          : 0.f;
      const float p = __fmul_rn(dt, sv);
      p_s[t * kPld + j] = p;
      if (t == lc - 1) wt_s[j] = dt;
      float d = p;
#pragma unroll
      for (int o = 8; o >= 1; o >>= 1)
        d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, o));
      if (j == 0) {
        float nq = nq_s[t];
#pragma unroll
        for (int w = 1; w < kWarps; ++w)
          nq = __fadd_rn(nq, nq_s[w * kL + t]);
        const float dq = __fadd_rn(d, __fmul_rn(gc[t], nq));
        den_s[t] = fmaxf(fabsf(dq), 1.f);
        // the save for the backward: n . q a position, signed
        if (d_save != nullptr && strip == 0 && t < lc)
          d_save[(static_cast<size_t>(b) * seq + ch * kL + t) * nh + head] =
              dq;
      }
    }
    for (int e = tid; e < kTv * kL; e += kThreads) {
      float sv = cq_s[e];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        sv = __fadd_rn(sv, cq_s[w * kTv * kL + e]);
      cqr_s[e] = sv;
    }
    __syncthreads();  // D q . k~, C^T q, the denominators and weights in

    if (warp < 4) {
      // h: warp w the 16 columns 16 (w & 1) .. and 8 positions 8 (w >> 1)
      // .. of (D q . k~) v on the tensor cores, then the carried part
      const int mt = warp & 1, nt = warp >> 1;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int js = 0; js < 2; ++js) {
        const int j0 = 8 * js + tq;
        uint32_t ah[4], al[4], bh[2], bl[2];
        split(vc[j0 * kVld + 16 * mt + gq], ah[0], al[0]);
        split(vc[j0 * kVld + 16 * mt + gq + 8], ah[1], al[1]);
        split(vc[(j0 + 4) * kVld + 16 * mt + gq], ah[2], al[2]);
        split(vc[(j0 + 4) * kVld + 16 * mt + gq + 8], ah[3], al[3]);
        split(p_s[(8 * nt + gq) * kPld + j0], bh[0], bl[0]);
        split(p_s[(8 * nt + gq) * kPld + j0 + 4], bh[1], bl[1]);
        mma3(acc, ah, al, bh[0], bh[1], bl[0], bl[1]);
      }
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int t = 8 * nt + 2 * tq + e2;
        if (t < lc) {
          float* ht = h + row_off(ch * kL + t) + col0;
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int cl = 16 * mt + gq + 8 * e1;
            const float num = __fadd_rn(__fmul_rn(gc[t], cqr_s[cl * kL + t]),
                                        acc[2 * e1 + e2]);
            ht[cl] = __fdiv_rn(num, den_s[t]);
          }
        }
      }
    } else if (warp == kChainWarp && ch + 1 < nch) {
      // the next chunk's m chain, while the first four warps take h
      const int nx = (ch + 1) & 1;
      m = chain(m, gate, rows_in(ch + 1), lane, a_s + nx * kL,
                b_s + nx * kL, g_s + nx * kL);
    }
    // the next chunk's rows, a warp each for k, q and v, while the first
    // four warps take h: k_s[cur ^ 1] and v_s[cur ^ 1] are free since the
    // last chunk's update, q_s since this chunk's partials
    if (ch + 1 < nch && warp >= kLoadWarp) {
      if (warp == kLoadWarp)
        load_k(ch + 1, cur ^ 1);
      else if (warp == kLoadWarp + 1)
        load_q(ch + 1);
      else
        load_v(ch + 1, cur ^ 1);
    }

    // the state: C <- g C + k (w v)^T, the chunk's products accumulated on
    // the tensor cores onto g C; n <- g n + sum_j w_j k_j
    {
      const float g_last = gc[lc - 1];
      uint32_t vh[2][2][4], vl[2][2][4];
#pragma unroll
      for (int js = 0; js < 2; ++js) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int j0 = 8 * js + tq, cl = 16 * mt + gq;
          const float w0 = wt_s[j0], w4 = wt_s[j0 + 4];
          split(__fmul_rn(w0, vc[j0 * kVld + cl]), vh[js][mt][0],
                vl[js][mt][0]);
          split(__fmul_rn(w0, vc[j0 * kVld + cl + 8]), vh[js][mt][1],
                vl[js][mt][1]);
          split(__fmul_rn(w4, vc[(j0 + 4) * kVld + cl]), vh[js][mt][2],
                vl[js][mt][2]);
          split(__fmul_rn(w4, vc[(j0 + 4) * kVld + cl + 8]), vh[js][mt][3],
                vl[js][mt][3]);
        }
      }
#pragma unroll
      for (int s = 0; s < kMaxSteps; ++s) {
        if (s < steps) {
          const int r = 8 * (ks0 + s) + gq;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              c[s][mt][e] = __fmul_rn(g_last, c[s][mt][e]);
          }
#pragma unroll
          for (int js = 0; js < 2; ++js) {
            const int j0 = 8 * js + tq;
            uint32_t bh0, bl0, bh1, bl1;
            split(kc[j0 * lq + r], bh0, bl0);
            split(kc[(j0 + 4) * lq + r], bh1, bl1);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma3(c[s][mt], vh[js][mt], vl[js][mt], bh0, bh1, bl0, bl1);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + lane + 32 * j;
        if (r < r1) {
          float tn = 0.f;
#pragma unroll
          for (int p = 0; p < kL; ++p)
            tn = __fmaf_rn(wt_s[p], kc[p * lq + r], tn);
          nr[j] = __fadd_rn(__fmul_rn(g_last, nr[j]), tn);
        }
      }
    }
  }

  // the strip to each destination row (a destination row -1 is not
  // written), n and m once a head
  const int64_t drow[2] = {dst1 != nullptr ? dst1_rows[b] : -1,
                           dst2 != nullptr ? dst2_rows[b] : -1};
  float* dbase[2] = {dst1, dst2};
  const int64_t dstride[2] = {dst1_stride, dst2_stride};
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    if (drow[d] < 0) continue;
    float* cd = dbase[d] + drow[d] * dstride[d] + head * mat + col0;
#pragma unroll
    for (int s = 0; s < kMaxSteps; ++s) {
      if (s < steps) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 8 * (ks0 + s) + 2 * tq + (e & 1);
            const int cc = 16 * mt + gq + 8 * (e >> 1);
            cd[static_cast<size_t>(r) * hd + cc] = c[s][mt][e];
          }
        }
      }
    }
  }
  if (strip == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + lane + 32 * j;
      if (r < r1) n_out[bh * hd + r] = nr[j];
    }
    if (tid == kChainWarp * 32) m_out[bh] = m;
  }
}

cudaError_t opt_in_smem() {
  // the opt-in above 48 KB of shared memory, once a device, for the
  // largest head dim
  static bool opted[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !opted[device]) {
    err = cudaFuncSetAttribute(mlstm_scan_chunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(chunk_smem_bytes(kMaxHd)));
    if (err != cudaSuccess) return err;
    opted[device] = true;
  }
  return cudaSuccess;
}

}  // namespace

// The chunkwise form, for S > 1: the same arguments as mlstm_scan_launch,
// and qk, float32 scratch of B nh ceil(S / 16) 256 floats; two launches
// (q . k a chunk, then the chunkwise kernel).  c_save, n_save and d_save
// (all null, or all set: the saves for the backward) take C [B, nh, nch,
// hd, hd] and n [B, nh, nch, hd] before each chunk and n . q [B, S, nh]
// (signed) a position; they change nothing else.  Returns the first
// launch error, or 0.
extern "C" int mlstm_scan_chunk_launch(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fg, const void* n0, const void* m0, const void* src,
    const void* src_rows, int64_t src_stride, void* dst1,
    const void* dst1_rows, int64_t dst1_stride, void* dst2,
    const void* dst2_rows, int64_t dst2_stride, void* h, void* n_out,
    void* m_out, int batch, int seq, int nh, int hd, float sqrt_hd,
    void* qk, void* c_save, void* n_save, void* d_save, void* stream_ptr) {
  if (hd % kTv != 0 || hd > kMaxHd || hd <= 0 || seq <= 0 || batch <= 0 ||
      qk == nullptr || (c_save == nullptr) != (n_save == nullptr) ||
      (c_save == nullptr) != (d_save == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nch = (seq + kL - 1) / kL;
  mlstm_scan_qk_kernel<<<dim3(nch, nh, batch), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<float*>(qk), seq, nh, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_scan_chunk_kernel<<<dim3(hd / kTv, nh, batch), kThreads,
                            chunk_smem_bytes(hd), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<const float*>(n0),
      static_cast<const float*>(m0), static_cast<const float*>(src),
      static_cast<const int64_t*>(src_rows), src_stride,
      static_cast<float*>(dst1), static_cast<const int64_t*>(dst1_rows),
      dst1_stride, static_cast<float*>(dst2),
      static_cast<const int64_t*>(dst2_rows), dst2_stride,
      static_cast<float*>(h), static_cast<float*>(n_out),
      static_cast<float*>(m_out), static_cast<const float*>(qk),
      static_cast<float*>(c_save), static_cast<float*>(n_save),
      static_cast<float*>(d_save), seq, nh, hd, sqrt_hd);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The backward of the chunkwise form (S >= 1), under autograd
// ---------------------------------------------------------------------------
//
// The reference differentiates its lax.scan with jax.grad, which XLA
// compiles to one reverse loop that keeps every position's C.  Here the
// forward saved C and n before each chunk (csave, nsave) and n . q a
// position (dsave), and the backward runs the chunkwise form in reverse.
// With dnum_t = dh_t / den_t, dd_t the gradient of n . q_t (through the
// clamp max(|n . q|, 1): zero where the clamp binds), and in a chunk the
// gradient dCe of the C after it (the later chunks' share), D, g and A as
// in the forward (k~ = k / sqrt(hd)):
//
//   dv_j  = D_Lj (dCe^T k~_j) + sum_{t>=j} D_tj (q_t . k~_j) dnum_t
//   dq_t  = g_t (Cb dnum_t + dd_t nb) + sum_{j<=t} D_tj P_tj k~_j
//   dk~_j = D_Lj (dCe v_j + dne) + sum_{t>=j} D_tj P_tj q_t
//   dCb   = g_L dCe + sum_t g_t q_t dnum_t^T
//   dnb   = g_L dne + sum_t g_t dd_t q_t
//
// with P_tj = dnum_t . v_j + dd_t (n is C's column of ones), Cb, nb the
// state before the chunk and L its last position.  The gates: the
// gradient of b_t = i_t - m_t is K_t = k~_t . dk~_t, and of a_t = f_t +
// m_{t-1} - m_t (the log of f_p) da_t = Q_t - K_t + da_{t+1} (Q_t = dh_t
// . h_t where the clamp binds, else 0: <dC_t, C_t> + dn_t . n_t less the
// new term's share), zero where f_p = exp(a_t) is 0 (the plain version's
// f_p * df_p); then the m chain in reverse: m_t = max(f_t + m_{t-1}, i_t)
// hands the gradient of m_t (the next position's, less da_t and db_t) to
// the larger side, half each at a tie (as PyTorch's and JAX's maximum).
// The initial state carries no gradient (the wrapper refuses one that
// asks for it).
//
// Four launches, each counted:
//
// * the prep (grid chunks x nh x B): the m chain up to the chunk (a, m
//   and Q a position, for the gate pass), dnum = dh / den (for both
//   passes) and the chunk's record: g_t, D_Lj, dd_t, D (q . k~) and W =
//   D P, from float32 dot products on the CUDA cores;
// * the dv pass (grid hd / 32 strips of dC's columns x nh x B, 8 warps,
//   one block an SM), the forward's chunkwise kernel turned round: dC^T
//   of the strip [32, hd] as mma.sync m16n8k8 accumulators laid out as the
//   forward's C^T (a warp ceil(hd / 64) k-steps of 8 rows), carried from
//   the last chunk to the first.  A chunk: dCe written to the boundary
//   for the next pass (through shared memory, a row a float4 store a
//   lane); dCe^T k [32, 16] (the forward's C^T q with k in q's place);
//   then, onto g_L dCe, the update
//   (g o dnum)^T [32, 16] . Q [16, hd] (the forward's, q in k's place);
//   both 3xTF32 through split / mma3.  The in-chunk term of dv, [16, 16]
//   . [16, 32], stays on the CUDA cores.  q, k and the strip of dnum come
//   by bulk copies onto mbarriers, the previous chunk's in flight while
//   this one's update runs (q and dnum double-buffered, k single: three
//   buffers of L (hd + 8) floats are 198 KB at hd = 1024, and four do not
//   fit the 227 KB a block may have).  One warp carries dn's 32 rows of
//   the strip's index (dnb = g_L dne + sum_t g_t dd_t q_t) and writes dne
//   at each boundary, so the next pass carries nothing;
// * the dq / dk pass (grid hd / 32 strips of rows x chunks x B nh: every
//   (strip, chunk) its own block, two an SM): X1 = Cb dnum^T and X2 = dCe
//   V^T [32, 16] over the hd columns as 3xTF32 mma.sync, the columns split
//   over the 8 warps (two k-steps of 8 each a tile) and the partials summed
//   in warp order; Cb, dCe, dnum and v stream through two buffers of
//   tiles of 128 columns, 16-byte cp.async pieces from every thread (the
//   bulk copy engine took too long a 256-byte row), each boundary byte
//   read once, the next tile in flight during the current one's
//   products; then dq, dk and K's partial over the strip's rows on the
//   CUDA cores;
// * the gate pass (one warp a row and head, the serial chain).
//
// Every sum runs in a fixed order and no float atomics are used: two runs
// give the same bits.
//
// What bounds it on an H100 at B = 4, S = 256, 4 heads of 1024: bytes,
// 1.209 GB read or written once (0.361 ms at 3.35 TB/s), against 3 x
// 34.645 GFLOP of 3xTF32 (0.210 ms at 495 TFLOP/s; 0.517 ms in float32
// on the CUDA cores); the two passes also write and read the dce
// scratch, 1.074 GB each way, so their own floor is ~1.0 ms.  Measured
// there on an H100 (PERF.md): 1.78 ms on the device (dq / dk 0.89, dv
// 0.68, prep 0.16, gates 0.05), 20% of the bound and 56% of the two
// passes' floor; the same four passes in float32 on the CUDA cores took
// 5.72 (the dv pass 3.38, with 400 bytes of spills).
namespace {

constexpr int kBwdTile = 64;                 // hd columns a prep tile
constexpr int kGateTile = 256;               // positions a gate-pass tile
constexpr int kSc = 3;  // a, m and Q a position, for the gate pass
// a chunk's record (floats): D (q . k~) [L][L], then g, D_L, dd and a
// spare [L] each, then W = D P [L][L]; the dv pass copies its first
// kRecDv floats, the dq / dk pass the kRecQk from kRecG on
constexpr int kRecG = kL * kL, kRecDl = kRecG + kL, kRecDd = kRecDl + kL;
constexpr int kRecW = kRecDd + 2 * kL;
constexpr int kRec = kRecW + kL * kL;
constexpr int kRecDv = kRecW, kRecQk = kRec - kRecG;

// the chunk's A_t (double, clamped as the forward), g_t and D_tj from a_s
// and b_s (rows past lc give 0), by the block's threads
__device__ __forceinline__ void bwd_decay(const float* a_s, const float* b_s,
                                          int lc, double* A_s, float* g_s,
                                          float* D_s, int tid) {
  if (tid < kL) {
    double acc = 0.0;
    for (int p = 0; p <= tid && p < lc; ++p)
      acc += fmax(static_cast<double>(a_s[p]), kClampA);
    A_s[tid] = acc;
    g_s[tid] = tid < lc ? expf(static_cast<float>(acc)) : 0.f;
  }
  __syncthreads();
  if (tid < kL * kL) {
    const int t = tid >> 4, j = tid & 15;
    D_s[tid] = (j <= t && t < lc)
                   ? expf(static_cast<float>(static_cast<double>(b_s[j]) +
                                             (A_s[t] - A_s[j])))
                   : 0.f;
  }
}

// the prep: grid (nch, nh, B), 256 threads
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_prep_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ ig,
                      const float* __restrict__ fg,
                      const float* __restrict__ m0,
                      const float* __restrict__ h,
                      const float* __restrict__ dh,
                      const float* __restrict__ dsave, float* __restrict__ sc,
                      float* __restrict__ rec, float* __restrict__ dnum,
                      int seq, int nh, int hd, float sqrt_hd) {
  __shared__ float gi_s[kGateTile], gf_s[kGateTile];
  // rows padded by one word: thread (t, j) reads row j of k and v
  __shared__ float q_s[kL][kBwdTile + 1], k_s[kL][kBwdTile + 1];
  __shared__ float v_s[kL][kBwdTile + 1], dn_s[kL][kBwdTile + 1];
  __shared__ float den_s[kL], dd_s[kL], hh_s[kL];
  __shared__ double A_s[kL];
  __shared__ float a_s[kL], b_s[kL], g_s[kL], D_s[kL * kL];
  const int ch = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nch = (seq + kL - 1) / kL;
  const int c0 = ch * kL, lc = min(kL, seq - c0);
  const size_t bh = static_cast<size_t>(b) * nh + head;
  auto row = [&](int pos) {
    return ((static_cast<size_t>(b) * seq + pos) * nh + head) * hd;
  };
  auto gate = [&](int pos) { return (static_cast<size_t>(b) * seq + pos) * nh
                                    + head; };
  float* scb = sc + bh * seq * kSc;

  // the m chain from position 0 through this chunk, in the forward's
  // rounding (m bit-equal), in tiles of gates staged in shared memory
  float m = m0[bh];
  for (int t0 = 0; t0 < c0 + lc; t0 += kGateTile) {
    const int nt = min(kGateTile, c0 + lc - t0);
    __syncthreads();
    for (int e = tid; e < nt; e += kThreads) {
      gi_s[e] = ig[gate(t0 + e)];
      gf_s[e] = fg[gate(t0 + e)];
    }
    __syncthreads();
    if (tid == 0) {
      for (int e = 0; e < nt; ++e) {
        const float fm = __fadd_rn(gf_s[e], m);
        const float mn = fmaxf(fm, gi_s[e]);
        const int pos = t0 + e;
        if (pos >= c0) {
          const float a = __fsub_rn(fm, mn), bb = __fsub_rn(gi_s[e], mn);
          scb[pos * kSc + 0] = a;
          scb[pos * kSc + 1] = mn;
          a_s[pos - c0] = a;
          b_s[pos - c0] = bb;
        }
        m = mn;
      }
    }
  }
  // den and dh . h a position (a warp two positions)
  for (int t = 2 * warp; t < 2 * warp + 2; ++t) {
    float s = 0.f;
    if (t < lc) {
      const float* hr = h + row(c0 + t);
      const float* dr = dh + row(c0 + t);
      for (int e = lane; e < hd; e += 32) s = __fmaf_rn(dr[e], hr[e], s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0) {
      const float d = t < lc ? dsave[gate(c0 + t)] : 0.f;
      const float den = fmaxf(fabsf(d), 1.f);
      const bool open = fabsf(d) >= 1.f;   // the clamp passes the gradient
      den_s[t] = den;
      hh_s[t] = s;
      // d(den) = -(dh . h) / den, through |d| where the clamp is open
      const float dden = -__fdiv_rn(s, den);
      dd_s[t] = t < lc && open ? (d > 0.f ? dden : (d < 0.f ? -dden : 0.f))
                               : 0.f;
    }
  }
  __syncthreads();
  if (tid < lc) {
    const float d = dsave[gate(c0 + tid)];
    scb[(c0 + tid) * kSc + 2] = fabsf(d) >= 1.f ? 0.f : hh_s[tid];
  }
  bwd_decay(a_s, b_s, lc, A_s, g_s, D_s, tid);

  // q . k~ and dnum . v over tiles of hd columns: thread (t, j); dnum
  // written for both passes
  const int t = tid >> 4, j = tid & 15;
  float sqk = 0.f, spv = 0.f;
  for (int x0 = 0; x0 < hd; x0 += kBwdTile) {
    __syncthreads();
    for (int e = tid; e < kL * kBwdTile; e += kThreads) {
      const int r = e / kBwdTile, cl = e % kBwdTile, x = x0 + cl;
      const bool in = r < lc && x < hd;
      const size_t at = row(c0 + (r < lc ? r : 0)) + x;
      q_s[r][cl] = in ? q[at] : 0.f;
      k_s[r][cl] = in ? __fdiv_rn(k[at], sqrt_hd) : 0.f;
      v_s[r][cl] = in ? v[at] : 0.f;
      const float dn = in ? __fdiv_rn(dh[at], den_s[r]) : 0.f;
      dn_s[r][cl] = dn;
      if (in) dnum[at] = dn;
    }
    __syncthreads();
#pragma unroll 8
    for (int cl = 0; cl < kBwdTile; ++cl) {
      sqk = __fmaf_rn(q_s[t][cl], k_s[j][cl], sqk);
      spv = __fmaf_rn(dn_s[t][cl], v_s[j][cl], spv);
    }
  }
  // the record (rows and columns past lc: zeros)
  float* rc = rec + (bh * nch + ch) * kRec;
  const float d = D_s[tid];
  rc[tid] = __fmul_rn(d, sqk);
  rc[kRecW + tid] = __fmul_rn(d, __fadd_rn(spv, dd_s[t]));
  if (tid < kL) {
    rc[kRecG + tid] = g_s[tid];
    rc[kRecDl + tid] = D_s[(lc - 1) * kL + tid];
    rc[kRecDd + tid] = dd_s[tid];
    rc[kRecDd + kL + tid] = 0.f;
  }
}

// the dv pass: grid (hd / 32 strips of dC's columns, nh, B), 256 threads,
// one block an SM
constexpr size_t dv_smem_bytes(int hd) {
  return 4 * sizeof(uint64_t) +
         sizeof(float) * (static_cast<size_t>(3) * kL * ldq(hd) +
                          2 * kL * kVld + 2 * kRecDv + kWarps * kTv * kL);
}
static_assert(dv_smem_bytes(kMaxHd) <= 232448, "the dv pass's shared memory");

__global__ void __launch_bounds__(kThreads, 1)
mlstm_bwd_dv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ dnum,
                    const float* __restrict__ rec,
                    const float* __restrict__ dc_end,
                    const float* __restrict__ dn_end, float* __restrict__ dce,
                    float* __restrict__ dne, float* __restrict__ dv, int seq,
                    int nh, int hd, float sqrt_hd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem_raw);  // k in
  uint64_t* full_q = full_k + 1;              // [2]: q, dnum, the record in
  const int lq = ldq(hd);
  float* q_s = reinterpret_cast<float*>(full_k + 4);   // [2][kL][lq]
  float* k_s = q_s + 2 * kL * lq;                      // [kL][lq]
  float* dn_s = k_s + kL * lq;                         // [2][kL][kVld]
  float* rc_s = dn_s + 2 * kL * kVld;                  // [2][kRecDv]
  float* cq_s = rc_s + 2 * kRecDv;                     // [kWarps][kTv][kL]

  const int strip = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // the mma fragments' group, thread
  const int nks = (hd + 63) / 64;
  const int ks0 = warp * nks;               // this warp's first k-step
  const int steps = min(max(hd / 8 - ks0, 0), nks);
  const int col0 = strip * kTv;
  const int nch = (seq + kL - 1) / kL;
  const size_t bh = static_cast<size_t>(b) * nh + head;
  const size_t mat = static_cast<size_t>(hd) * hd;

  auto row_off = [&](int pos) {
    return ((static_cast<size_t>(b) * seq + pos) * nh + head) * hd;
  };
  auto rows_in = [&](int ch) { return min(kL, seq - ch * kL); };
  // chunk ch's rows, issued by one warp (a lane a row): k to k_s; q, this
  // strip of dnum and the record to buffer buf
  auto load_k = [&](int ch) {
    const int lc = rows_in(ch);
    if (lane == 0) mbar_expect_tx(full_k, lc * hd * 4);
    if (lane < lc)
      bulk_row(k_s + lane * lq, k + row_off(ch * kL + lane), hd * 4, full_k);
  };
  auto load_q = [&](int ch, int buf) {
    const int lc = rows_in(ch);
    uint64_t* bar = full_q + buf;
    if (lane == 0) mbar_expect_tx(bar, (lc * (hd + kTv) + kRecDv) * 4);
    if (lane < lc) {
      bulk_row(q_s + (buf * kL + lane) * lq, q + row_off(ch * kL + lane),
               hd * 4, bar);
      bulk_row(dn_s + (buf * kL + lane) * kVld,
               dnum + row_off(ch * kL + lane) + col0, kTv * 4, bar);
    }
    if (lane == 31)
      bulk_row(rc_s + buf * kRecDv, rec + (bh * nch + ch) * kRec, kRecDv * 4,
               bar);
  };

  if (tid == 0) {
    mbar_init(full_k, 1);
    mbar_init(full_q, 1);
    mbar_init(full_q + 1, 1);
    // the barriers' initialisation visible to the bulk copy engine
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the last chunk, the first taken, may hold fewer than kL rows: the
  // rest of its buffers zero, not stale bytes (q and dnum meet the
  // update's zero weights there), before any copy lands
  const int lc_last = rows_in(nch - 1);
  if (lc_last < kL) {
    for (int e = tid; e < (kL - lc_last) * lq; e += kThreads) {
      q_s[lc_last * lq + e] = 0.f;
      k_s[lc_last * lq + e] = 0.f;
    }
    for (int e = tid; e < (kL - lc_last) * kVld; e += kThreads)
      dn_s[lc_last * kVld + e] = 0.f;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    load_q(nch - 1, 0);
    load_k(nch - 1);
  }

  // the strip of dC^T as accumulators, as the forward's C^T: c[s][mt] is
  // the m16n8 tile of columns 16 mt .. 16 mt + 15 and hd rows 8 (ks0 + s)
  // ..; element e is column 16 mt + gq + 8 (e >> 1), row 8 (ks0 + s) + 2
  // tq + (e & 1).  dC after the last chunk: dc_end's strip, or zero.
  const float* ce = dc_end != nullptr ? dc_end + bh * mat + col0 : nullptr;
  float c[kMaxSteps][2][4];
#pragma unroll
  for (int s = 0; s < kMaxSteps; ++s) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * (ks0 + s) + 2 * tq + (e & 1);
        const int cc = 16 * mt + gq + 8 * (e >> 1);
        c[s][mt][e] = (s < steps && ce != nullptr)
                          ? ce[static_cast<size_t>(r) * hd + cc]
                          : 0.f;
      }
    }
  }
  // dn after the chunk, rows col0 + lane, carried by the chain warp
  float dn_r = warp == kChainWarp && dn_end != nullptr
                   ? dn_end[bh * hd + col0 + lane]
                   : 0.f;

  for (int it = 0; it < nch; ++it) {
    const int ch = nch - 1 - it, buf = it & 1, lc = rows_in(ch);
    const float* qc = q_s + buf * kL * lq;
    const float* dnc = dn_s + buf * kL * kVld;
    const float* rc = rc_s + buf * kRecDv;
    // dCe, the gradient of the C after this chunk, to boundary ch for the
    // dq / dk pass, before waiting (the stores go while the rows land):
    // two k-steps' [8 rows, 32 columns] at a time through the warp's slot
    // of cq_s (free until this chunk's partials; column c of row r at c
    // XOR 8 (r / 2), free of bank conflicts both ways), then stored a row
    // as eight float4 (a 4-byte store from the accumulators put 32 bytes
    // in each of four rows, and the dv pass took 0.43 ms longer)
    {
      float* sl = cq_s + warp * kTv * kL;
      const size_t step = static_cast<size_t>(8) * hd;   // a k-step's rows
      const int rr = lane >> 3, c4 = 4 * (lane & 7);
      float* dp = dce + (bh * nch + ch) * mat +
                  static_cast<size_t>(8 * ks0 + rr) * hd + col0 + c4;
#pragma unroll
      for (int s2 = 0; s2 < kMaxSteps; s2 += 2) {
        if (s2 < steps) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (s2 + u < steps) {
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int cc = 16 * mt + gq + 8 * (e >> 1);
                  sl[u * 256 + (2 * tq + (e & 1)) * kTv + (cc ^ (8 * tq))] =
                      c[s2 + u][mt][e];
                }
              }
            }
          }
          __syncwarp();
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int u = i >> 1, r = rr + 4 * (i & 1);
            if (s2 + u < steps)
              *reinterpret_cast<float4*>(dp + u * step + 4 * (i & 1) * hd) =
                  *reinterpret_cast<const float4*>(
                      sl + u * 256 + r * kTv + (c4 ^ (8 * (r >> 1))));
          }
          __syncwarp();
          dp += 2 * step;
        }
      }
    }
    mbar_wait(full_q + buf, (it >> 1) & 1);
    mbar_wait(full_k, it & 1);

    // this warp's rows of dCe^T k [32, L] (k~'s 1 / sqrt(hd) applied to
    // the sum), the forward's C^T q with k in q's place
    float xa[2][2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      xa[0][0][e] = xa[0][1][e] = xa[1][0][e] = xa[1][1][e] = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSteps; ++s) {
      if (s < steps) {
        const int col = 8 * (ks0 + s) + 2 * tq;
        const float2 x0 =
            *reinterpret_cast<const float2*>(k_s + gq * lq + col);
        const float2 x1 =
            *reinterpret_cast<const float2*>(k_s + (gq + 8) * lq + col);
        uint32_t kh[4], kl[4];
        split(x0.x, kh[0], kl[0]);
        split(x1.x, kh[1], kl[1]);
        split(x0.y, kh[2], kl[2]);
        split(x1.y, kh[3], kl[3]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t ah[4], al[4];
          split(c[s][mt][0], ah[0], al[0]);
          split(c[s][mt][2], ah[1], al[1]);
          split(c[s][mt][1], ah[2], al[2]);
          split(c[s][mt][3], ah[3], al[3]);
          mma3(xa[mt][0], ah, al, kh[0], kh[2], kl[0], kl[2]);
          mma3(xa[mt][1], ah, al, kh[1], kh[3], kl[1], kl[3]);
        }
      }
    }
    {
      float* cqw = cq_s + warp * kTv * kL;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int cl = 16 * mt + gq, t = 8 * nt + 2 * tq;
          *reinterpret_cast<float2*>(cqw + cl * kL + t) =
              make_float2(xa[mt][nt][0], xa[mt][nt][1]);
          *reinterpret_cast<float2*>(cqw + (cl + 8) * kL + t) =
              make_float2(xa[mt][nt][2], xa[mt][nt][3]);
        }
      }
    }
    __syncthreads();  // partials in; k_s free, and buffer buf ^ 1 since the
                      // last chunk's update
    // the previous chunk's rows, a warp each for k and for q, dnum and
    // the record, while this chunk's dv and update run
    if (ch > 0) {
      if (warp == kLoadWarp)
        load_k(ch - 1);
      else if (warp == kLoadWarp + 1)
        load_q(ch - 1, buf ^ 1);
    }
    if (warp == kChainWarp) {
      // dne at boundary ch for the dq / dk pass, then dn before the chunk
      dne[(bh * nch + ch) * hd + col0 + lane] = dn_r;
      float sn = __fmul_rn(rc[kRecG + lc - 1], dn_r);
      for (int p = 0; p < lc; ++p)
        sn = __fmaf_rn(__fmul_rn(rc[kRecG + p], rc[kRecDd + p]),
                       qc[p * lq + col0 + lane], sn);
      dn_r = sn;
    }
    // dv: thread (column cl, position j), the warps' partials summed in
    // order, then D_Lj x_j + sum_{t>=j} D_tj (q_t . k~_j) dnum_t
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int cl = (tid >> 4) + 16 * u, j = tid & 15;
      float xs = cq_s[cl * kL + j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        xs = __fadd_rn(xs, cq_s[(w * kTv + cl) * kL + j]);
      float sv = __fmul_rn(rc[kRecDl + j], __fdiv_rn(xs, sqrt_hd));
      for (int t = j; t < lc; ++t)
        sv = __fmaf_rn(rc[t * kL + j], dnc[t * kVld + cl], sv);
      if (j < lc) dv[row_off(ch * kL + j) + col0 + cl] = sv;
    }
    __syncthreads();  // the partials read

    // dC before the chunk: g_L dCe + sum_t (g_t dnum_t) q_t^T, the
    // chunk's products accumulated on the tensor cores onto g_L dCe (the
    // forward's update with q in k~'s place and g o dnum in D v's); the
    // first chunk's is not needed
    if (ch > 0) {
      const float g_last = rc[kRecG + lc - 1];
      // a k-step (8 positions) at a time: its A fragments, then onto every
      // k-step of rows (g_L applied with the first)
#pragma unroll
      for (int js = 0; js < 2; ++js) {
        const int j0 = 8 * js + tq;
        const float w0 = rc[kRecG + j0], w4 = rc[kRecG + j0 + 4];
        uint32_t wh[2][4], wl[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int cl = 16 * mt + gq;
          split(__fmul_rn(w0, dnc[j0 * kVld + cl]), wh[mt][0], wl[mt][0]);
          split(__fmul_rn(w0, dnc[j0 * kVld + cl + 8]), wh[mt][1],
                wl[mt][1]);
          split(__fmul_rn(w4, dnc[(j0 + 4) * kVld + cl]), wh[mt][2],
                wl[mt][2]);
          split(__fmul_rn(w4, dnc[(j0 + 4) * kVld + cl + 8]), wh[mt][3],
                wl[mt][3]);
        }
#pragma unroll
        for (int s = 0; s < kMaxSteps; ++s) {
          if (s < steps) {
            const int r = 8 * (ks0 + s) + gq;
            if (js == 0) {
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  c[s][mt][e] = __fmul_rn(g_last, c[s][mt][e]);
              }
            }
            uint32_t bh0, bl0, bh1, bl1;
            split(qc[j0 * lq + r], bh0, bl0);
            split(qc[(j0 + 4) * lq + r], bh1, bl1);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma3(c[s][mt], wh[mt], wl[mt], bh0, bh1, bl0, bl1);
          }
        }
      }
    }
  }
}

// 16 bytes global -> shared through the load / store unit, in the
// thread's current group (cp.async: pieces of any row size, where the bulk
// copy engine took its time a row: 256-byte rows ran the pass at 1.1 TB/s)
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the thread's groups but the newest N complete
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the dq / dk pass: grid (hd / 32 strips of rows, nch, B nh), 256
// threads, two blocks an SM.  A ring of kStages tiles of kTk columns:
// the strip's rows of Cb and dCe [32][kTk], the chunk's dnum and v
// [16][kTk], rows padded to 8 words mod 32 (the float2 fragment loads at
// (row g, column 2 t) are free of bank conflicts).  At B = 4, S = 256, 4
// heads of 1024 on an H100, two tiles of 128 columns took 0.885 ms,
// three of 64 0.92, four of 64 (one block an SM) 1.37.
constexpr int kRowsB = 32;                   // rows a block
constexpr int kTk = 128;                     // hd columns a tile
constexpr int kTld = kTk + 8;
constexpr int kStages = 2;
constexpr int kStage = (2 * kRowsB + 2 * kL) * kTld;   // floats a stage

constexpr size_t dqk_smem_bytes() {
  return sizeof(float) * (kStages * kStage + kRecQk + 2 * kL * kRowsB +
                          2 * kRowsB + kL * kRowsB);
}
static_assert(kTk % (8 * kWarps) == 0, "whole k-steps a warp a tile");
static_assert(kWarps * 2 * kRowsB * kL <= kStages * kStage,
              "the warps' partials fit the ring");
static_assert(2 * (dqk_smem_bytes() + 1024) <= 233472,
              "two dq / dk blocks an SM");

__global__ void __launch_bounds__(kThreads, 2)
mlstm_bwd_dqk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dnum,
                     const float* __restrict__ rec,
                     const float* __restrict__ csave,
                     const float* __restrict__ nsave,
                     const float* __restrict__ dce,
                     const float* __restrict__ dne,
                     float* __restrict__ dq, float* __restrict__ dk,
                     float* __restrict__ kpart, int seq, int nh, int hd,
                     float sqrt_hd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* st_s = reinterpret_cast<float*>(smem_raw);        // [kStages][kStage]
  float* rc_s = st_s + kStages * kStage;                   // [kRecQk]
  float* qr_s = rc_s + kRecQk;                             // [kL][kRowsB]
  float* kr_s = qr_s + kL * kRowsB;                        // [kL][kRowsB] k~
  float* nb_s = kr_s + kL * kRowsB;                        // [kRowsB]
  float* dne_s = nb_s + kRowsB;                            // [kRowsB]
  float* kp_s = dne_s + kRowsB;                            // [kL][kRowsB]
  const float* g_s = rc_s;
  const float* dl_s = rc_s + kL;
  const float* dd_s = rc_s + 2 * kL;
  const float* w_s = rc_s + (kRecW - kRecG);               // [kL][kL] D P

  const int rs = blockIdx.x, ch = blockIdx.y;
  const int b = blockIdx.z / nh, head = blockIdx.z % nh;
  const size_t bh = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int nch = (seq + kL - 1) / kL, nrs = hd / kRowsB;
  const int r0 = rs * kRowsB, c0 = ch * kL, lc = min(kL, seq - c0);
  const int ntile = (hd + kTk - 1) / kTk;
  const size_t bnd = bh * nch + ch;
  const size_t mat = static_cast<size_t>(hd) * hd;
  const float* cb = csave + bnd * mat + static_cast<size_t>(r0) * hd;
  const float* de = dce + bnd * mat + static_cast<size_t>(r0) * hd;
  auto row = [&](int pos) {
    return ((static_cast<size_t>(b) * seq + pos) * nh + head) * hd;
  };
  // tile t's 16-byte pieces, by every thread (consecutive threads along
  // a row): the strip's rows of Cb and dCe, the chunk's positions of dnum
  // and v; with tile 0 the block's small inputs (the strip's q and k
  // rows, nb, dne, the record)
  auto piece = [&](float* st, int x0, int r, int x) {
    const float* src;
    int dr = r;
    if (r < kRowsB)
      src = cb + static_cast<size_t>(r) * hd;
    else if (r < 2 * kRowsB)
      src = de + static_cast<size_t>(r - kRowsB) * hd;
    else if (r < 2 * kRowsB + lc)
      src = dnum + row(c0 + r - 2 * kRowsB);
    else {
      src = v + row(c0 + r - 2 * kRowsB - lc);
      dr = r - lc + kL;
    }
    cp16(st + dr * kTld + x, src + x0 + x);
  };
  auto issue = [&](int t) {
    const int x0 = t * kTk, w4 = min(kTk, hd - x0) / 4;
    float* st = st_s + (t % kStages) * kStage;
    const int n = (2 * kRowsB + 2 * lc) * w4;
    if (w4 == kTk / 4) {   // a whole tile: the row and column by shifts
      for (int e = tid; e < n; e += kThreads)
        piece(st, x0, e / (kTk / 4), 4 * (e % (kTk / 4)));
    } else {
      for (int e = tid; e < n; e += kThreads)
        piece(st, x0, e / w4, 4 * (e % w4));
    }
    if (t == 0) {
      const int nq = lc * kRowsB / 4;     // pieces of the q (and k) rows
      for (int e = tid; e < 2 * nq + kRowsB / 2 + kRecQk / 4;
           e += kThreads) {
        if (e < 2 * nq) {
          const int e2 = e < nq ? e : e - nq, p = e2 / (kRowsB / 4);
          const int x = 4 * (e2 - p * (kRowsB / 4));
          cp16((e < nq ? qr_s : kr_s) + 4 * e2,
               (e < nq ? q : k) + row(c0 + p) + r0 + x);
        } else if (e < 2 * nq + kRowsB / 4) {
          const int e2 = e - 2 * nq;
          cp16(nb_s + 4 * e2, nsave + bnd * hd + r0 + 4 * e2);
        } else if (e < 2 * nq + kRowsB / 2) {
          const int e2 = e - 2 * nq - kRowsB / 4;
          cp16(dne_s + 4 * e2, dne + bnd * hd + r0 + 4 * e2);
        } else {
          const int e2 = e - 2 * nq - kRowsB / 2;
          cp16(rc_s + 4 * e2, rec + bnd * kRec + kRecG + 4 * e2);
        }
      }
    }
  };

  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntile) issue(t);
    cp_commit();
  }

  // X1 = Cb dnum^T and X2 = dCe V^T [32 rows, L positions]: xa[p][mt][nt]
  // the m16n8 tile of rows 16 mt .. and positions 8 nt .., over this
  // warp's k-steps of each tile (positions past lc: unused columns)
  float xa[2][2][2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) xa[p][mt][nt][e] = 0.f;
  for (int t = 0; t < ntile; ++t) {
    const int w = min(kTk, hd - t * kTk);
    cp_wait<kStages - 2>();
    __syncthreads();   // tile t in; the stage tile t - 1 took is free
    if (t + kStages - 1 < ntile) issue(t + kStages - 1);
    cp_commit();
    if (t == 0)        // k~ of the strip's rows, in place
      for (int e = tid; e < lc * kRowsB; e += kThreads)
        kr_s[e] = __fdiv_rn(kr_s[e], sqrt_hd);
    const float* st = st_s + (t % kStages) * kStage;
#pragma unroll
    for (int i = 0; i < kTk / (8 * kWarps); ++i) {
      const int ks = warp + kWarps * i;        // this warp's k-step
      if (8 * ks >= w) break;
      const int col = 8 * ks + 2 * tq;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float* am = st + p * kRowsB * kTld;          // Cb or dCe
        const float* bm = st + (2 * kRowsB + p * kL) * kTld;  // dnum or v
        const float2 y0 = *reinterpret_cast<const float2*>(bm + gq * kTld +
                                                           col);
        const float2 y1 = *reinterpret_cast<const float2*>(
            bm + (gq + 8) * kTld + col);
        uint32_t yh[4], yl[4];
        split(y0.x, yh[0], yl[0]);
        split(y1.x, yh[1], yl[1]);
        split(y0.y, yh[2], yl[2]);
        split(y1.y, yh[3], yl[3]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float2 a0 = *reinterpret_cast<const float2*>(
              am + (16 * mt + gq) * kTld + col);
          const float2 a1 = *reinterpret_cast<const float2*>(
              am + (16 * mt + gq + 8) * kTld + col);
          uint32_t ah[4], al[4];
          split(a0.x, ah[0], al[0]);
          split(a1.x, ah[1], al[1]);
          split(a0.y, ah[2], al[2]);
          split(a1.y, ah[3], al[3]);
          mma3(xa[p][mt][0], ah, al, yh[0], yh[2], yl[0], yl[2]);
          mma3(xa[p][mt][1], ah, al, yh[1], yh[3], yl[1], yl[3]);
        }
      }
    }
  }
  __syncthreads();     // every warp done with the ring

  // the warps' partials, in the ring's space: part[w][p][row][position]
  float* part = st_s;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int rr = 16 * mt + gq, tt = 8 * nt + 2 * tq;
        float* pw = part + (warp * 2 + p) * kRowsB * kL;
        *reinterpret_cast<float2*>(pw + rr * kL + tt) =
            make_float2(xa[p][mt][nt][0], xa[p][mt][nt][1]);
        *reinterpret_cast<float2*>(pw + (rr + 8) * kL + tt) =
            make_float2(xa[p][mt][nt][2], xa[p][mt][nt][3]);
      }
    }
  }
  __syncthreads();

  // dq and dk: thread (row rl, positions tg and tg + 8)
  {
    const int rl = tid >> 3, tg = tid & 7;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = tg + 8 * u;
      if (t >= lc) continue;
      float x1 = part[rl * kL + t], x2 = part[(kRowsB + rl) * kL + t];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        x1 = __fadd_rn(x1, part[((2 * w) * kRowsB + rl) * kL + t]);
        x2 = __fadd_rn(x2, part[((2 * w + 1) * kRowsB + rl) * kL + t]);
      }
      float sq = __fmul_rn(g_s[t], __fmaf_rn(dd_s[t], nb_s[rl], x1));
      for (int j = 0; j <= t; ++j)
        sq = __fmaf_rn(w_s[t * kL + j], kr_s[j * kRowsB + rl], sq);
      float sk = __fmul_rn(dl_s[t], __fadd_rn(x2, dne_s[rl]));
      for (int p = t; p < lc; ++p)
        sk = __fmaf_rn(w_s[p * kL + t], qr_s[p * kRowsB + rl], sk);
      dq[row(c0 + t) + r0 + rl] = sq;
      dk[row(c0 + t) + r0 + rl] = __fdiv_rn(sk, sqrt_hd);
      kp_s[t * kRowsB + rl] = __fmul_rn(kr_s[t * kRowsB + rl], sk);
    }
  }
  __syncthreads();                 // K's products in
  if (tid < lc) {
    float s = kp_s[tid * kRowsB];
    for (int r = 1; r < kRowsB; ++r) s = __fadd_rn(s, kp_s[tid * kRowsB + r]);
    kpart[(bh * nrs + rs) * seq + c0 + tid] = s;
  }
}

// the gate pass: grid (nh, B), one warp; K_t summed over the row strips in
// order, then the serial chain (double) from the last position to the
// first, in tiles staged in shared memory
__global__ void __launch_bounds__(32)
mlstm_bwd_gate_kernel(const float* __restrict__ ig,
                      const float* __restrict__ fg,
                      const float* __restrict__ m0, float* __restrict__ sc,
                      const float* __restrict__ kpart,
                      const float* __restrict__ e_end,
                      const float* __restrict__ dm_end,
                      float* __restrict__ di, float* __restrict__ df,
                      int seq, int nh, int hd) {
  __shared__ float st_s[kGateTile][kSc + 3];   // and K, i, f
  const int head = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const int nrs = hd / kRowsB;
  const size_t bh = static_cast<size_t>(b) * nh + head;
  float* scb = sc + bh * seq * kSc;
  auto gate = [&](int pos) { return (static_cast<size_t>(b) * seq + pos) * nh
                                    + head; };
  double da = e_end != nullptr ? static_cast<double>(e_end[bh]) : 0.0;
  double dmf = dm_end != nullptr ? static_cast<double>(dm_end[bh]) : 0.0;
  for (int hi = seq; hi > 0; hi -= kGateTile) {
    const int lo = max(0, hi - kGateTile);
    __syncwarp();
    for (int e = lane; e < hi - lo; e += 32) {
      const int pos = lo + e;
      float kk = kpart[bh * nrs * seq + pos];
      for (int r = 1; r < nrs; ++r)
        kk = __fadd_rn(kk, kpart[(bh * nrs + r) * seq + pos]);
#pragma unroll
      for (int x = 0; x < kSc; ++x) st_s[e][x] = scb[pos * kSc + x];
      st_s[e][kSc] = kk;
      st_s[e][kSc + 1] = ig[gate(pos)];
      st_s[e][kSc + 2] = fg[gate(pos)];
    }
    // m before the tile's first position
    const float m_lo = lo > 0 ? scb[(lo - 1) * kSc + 1] : m0[bh];
    __syncwarp();
    if (lane == 0) {
      for (int e = hi - lo - 1; e >= 0; --e) {
        const float a = st_s[e][0], kk = st_s[e][kSc], qq = st_s[e][2];
        const float it = st_s[e][kSc + 1], ft = st_s[e][kSc + 2];
        const float mp = e > 0 ? st_s[e - 1][1] : m_lo;
        da = expf(a) == 0.f ? 0.0
                            : static_cast<double>(qq) - kk + da;
        const double db = kk;
        const float fm = __fadd_rn(ft, mp);
        const double dm = dmf - da - db;
        double dfm = da, dit = db;
        if (fm > it) dfm += dm;
        else if (it > fm) dit += dm;
        else { dfm += 0.5 * dm; dit += 0.5 * dm; }
        df[gate(lo + e)] = static_cast<float>(dfm);
        di[gate(lo + e)] = static_cast<float>(dit);
        dmf = dfm;
      }
    }
  }
}

cudaError_t opt_in_bwd_smem() {
  static bool opted[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && !opted[device]) {
    err = cudaFuncSetAttribute(mlstm_bwd_dv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dv_smem_bytes(kMaxHd)));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(mlstm_bwd_dqk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dqk_smem_bytes()));
    if (err != cudaSuccess) return err;
    // the largest carveout, so that two dq / dk blocks share an SM
    err = cudaFuncSetAttribute(mlstm_bwd_dqk_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    if (err != cudaSuccess) return err;
    opted[device] = true;
  }
  return cudaSuccess;
}

}  // namespace

// The backward of the chunkwise form: q, k, v, h, dh f32 [B, S, nh, hd];
// ig, fg f32 [B, S, nh]; m0 f32 [B, nh]; csave, nsave, dsave the forward's
// saves; dc_end [B, nh, hd, hd], dn_end [B, nh, hd], e_end [B, nh] (the
// final C's and n's gradients dotted with the final C and n) and dm_end
// [B, nh], each null for none; scratch: sc [B, nh, S, 3], rec [B, nh,
// nch, 576], dnum as q, dce [B, nh, nch, hd, hd], dne [B, nh, nch, hd],
// kpart [B, nh, hd / 32, S]; out: dq, dk, dv as q, di and df as ig.  Four
// launches; returns the first launch error, or 0.
extern "C" int mlstm_scan_bwd_launch(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fg, const void* m0, const void* h, const void* dh,
    const void* csave, const void* nsave, const void* dsave,
    const void* dc_end, const void* dn_end, const void* e_end,
    const void* dm_end, void* sc, void* rec, void* dnum, void* dce,
    void* dne, void* kpart, void* dq, void* dk, void* dv, void* di, void* df,
    int batch, int seq, int nh, int hd, float sqrt_hd, void* stream_ptr) {
  const int nch = (seq + kL - 1) / kL;
  if (hd % kTv != 0 || hd > kMaxHd || hd <= 0 || seq <= 0 || batch <= 0 ||
      nch > 65535 || batch * nh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in_bwd_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto F = [](const void* p) { return static_cast<const float*>(p); };
  auto W = [](void* p) { return static_cast<float*>(p); };
  mlstm_bwd_prep_kernel<<<dim3(nch, nh, batch), kThreads, 0, stream>>>(
      F(q), F(k), F(v), F(ig), F(fg), F(m0), F(h), F(dh), F(dsave), W(sc),
      W(rec), W(dnum), seq, nh, hd, sqrt_hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_dv_kernel<<<dim3(hd / kTv, nh, batch), kThreads,
                        dv_smem_bytes(hd), stream>>>(
      F(q), F(k), F(dnum), F(rec), F(dc_end), F(dn_end), W(dce), W(dne),
      W(dv), seq, nh, hd, sqrt_hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_dqk_kernel<<<dim3(hd / kRowsB, nch, batch * nh), kThreads,
                         dqk_smem_bytes(), stream>>>(
      F(q), F(k), F(v), F(dnum), F(rec), F(csave), F(nsave), F(dce), F(dne),
      W(dq), W(dk), W(kpart), seq, nh, hd, sqrt_hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_gate_kernel<<<dim3(nh, batch), 32, 0, stream>>>(
      F(ig), F(fg), F(m0), W(sc), F(kpart), F(e_end), F(dm_end), W(di), W(df),
      seq, nh, hd);
  return static_cast<int>(cudaGetLastError());
}
