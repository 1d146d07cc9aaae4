// The mLSTM recurrence over a sequence, for Hopper, in place on the state
// rows it reads and writes.
//
// No Pallas kernel stands behind it: the reference runs the recurrence as
// a lax.scan over positions (repro/models/recurrent.py::mlstm_apply,
// :116-140) and one cell for a decode token (::mlstm_step, :149), which
// XLA compiles to one loop on the chip.  The port's plain version is a
// Python loop over positions whose every op rewrites the whole matrix
// state C (nh x hd x hd float32: 16.8 MB a row at xlstm-1.3b's 4 heads of
// 1024), and a paged decode step gathered, unpacked, packed and scattered
// the whole state page around it.  This kernel keeps C on the chip for
// all S positions and reads and writes it where it lives.
//
// Per row b, head h and position t, in the plain version's order (every
// product and sum of the state rounded on its own: __fmul_rn / __fadd_rn,
// so no multiply-add contraction changes a bit; k / sqrt(hd) a division;
// expf, not __expf):
//
//   k_t    = k_t / sqrt(hd)
//   m_new  = max(f_t + m, i_t);  i_p = exp(i_t - m_new)
//   f_p    = exp((f_t + m) - m_new)
//   n      = f_p * n + i_p * k_t
//   C      = f_p * C + i_p * (k_t v_t^T)      (f_p*C, k*v, i_p*(k*v), sum)
//   h_t    = (C^T q_t) / max(|n . q_t|, 1)
//
// C, n and m come out bit-equal to the plain version; h sums its two dot
// products in another order (fused multiply-adds, per warp then across
// warps) and is held to a bound on that difference (mlstm_scan.py).
//
// Grid (hd / 32 strips, nh, B): a block owns one strip of 32 columns of
// one head's C, [hd, 32] (8 warps, each 32 lanes x hd / 8 rows), reads it
// once from the source row (zeros for row -1), keeps it in registers for
// all S positions (128 floats a thread at hd = 1024, one block an SM),
// and writes it once to each destination row.  The scalars, n (hd floats)
// and the denominator are recomputed by every strip of a head: no block
// needs another's data, so nothing crosses blocks.  q and the scaled k of
// a position sit in shared memory (double-buffered: two barriers a
// position), and the next position's inputs are loaded into registers
// while the current one runs.
//
// What bounds it on an H100.  A decode step (S = 1) is bytes: C read once
// and written once to each tier, 16.8 MB x 3 a row, 0.06 ms at B = 4 and
// 3.35 TB/s; a warp moves one 128-byte row of its strip a load or store,
// with all of a thread's rows in flight at once.  (A form that streamed
// the strip 16 rows at a time, two blocks an SM, measured slower on an
// H100.)
// A prefill (S = 256, B = 1) is operations: 6 float32 operations an
// element of C a position, 6.4 GFLOP, 0.1 ms at 67 TFLOP/s; 128 blocks
// for 132 SMs, each bound by its own instruction issue (the multiplies
// and adds of the state may not fuse).
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
