// The sLSTM recurrence over a sequence, for Hopper.
//
// No Pallas kernel stands behind it: the reference runs the recurrence as
// a lax.scan over positions (repro/models/recurrent.py::slstm_apply, :237,
// over _slstm_cell, :204) and one cell for a decode token (::slstm_step,
// :245-251).  The port's plain version is a Python loop over positions of
// some fifteen ops each, whose einsum reads the whole recurrent weight
// [nh, hd, 4 hd] (16.8 MB a layer at xlstm-1.3b's 4 heads of 512) at every
// position.  This kernel splits that weight over the SMs once and keeps it
// in shared memory for all S positions.
//
// Per row b, head, unit u and position t (slstm_scan.py, ``slstm_cell``):
//
//   g_j   = wx[b, t, head, j] + sum_k h_{t-1}[b, head, k] r[head, k, j]
//           for the unit's four gate columns j = u, hd+u, 2hd+u, 3hd+u
//   z = tanh(g_z);  o = sigmoid(g_o);  f = log-sigmoid(g_f)
//   m' = max(f + m, g_i);  i' = exp(g_i - m');  f' = exp((f + m) - m')
//   c' = f' c + i' z;  n' = f' n + i';  h' = (o c') / max(n', 1e-6)
//
// (the products and sums of c, n and h rounded on their own, in the plain
// version's order: __fmul_rn / __fadd_rn; the dot products are fused
// multiply-adds, which the caller's tolerance bounds).
//
// Grid: nh x (hd / 16) blocks of 256 threads.  A block owns 16 hidden
// units of one head: it copies their 64 gate columns of r[head] (hd x 64
// floats, 128 KB at hd = 512: dynamic shared memory) once, 16 bytes a
// load.  At each position it reads the head's h_{t-1} (rows of 8 at a
// time) into shared memory; each thread sums four neighbouring columns
// over a sixteenth of the hd rows (four independent chains of fused
// multiply-adds), the sixteen slices are added in order, and 16 threads
// a row run the cell for the block's units (c, n, m live in the output
// buffers, each element read and written by one thread only).
//
// No barrier between positions: each block publishes its units' h_t as
// 64-bit words of (float value, position tag t + 1) in a ring of two
// positions ([2][B][nh][hd], zeroed before the launch, so no tag of an
// earlier launch matches), and a block reads the head's h_{t-1} by
// loading each word through L2 (ld.relaxed.gpu) until its tag is t.  Value
// and tag travel in one store, so no fence is needed; and two slots
// suffice, because no block can write h_{t+1} into h_{t-1}'s slot before
// every block of the head has published h_t, which each does only after
// it has read all of h_{t-1}.  The cell's wx is loaded before the wait.
// Blocks that wait on each other must all be resident, so S > 1 is a
// cooperative launch (it fails, and the wrapper raises, if the card cannot
// hold the grid); S = 1, every decode step, reads the starting h and needs
// no ring: a plain launch, which a CUDA graph captures.
//
// What bounds it on an H100.  A decode step (S = 1) is bytes: the weights
// once, 16.8 MB at 3.35 TB/s = 5.0 us at xlstm-1.3b's width, in 128
// blocks, one an SM.  A prefill (S = 256, B = 1) does 2 B S nh hd 4hd =
// 2.15 GFLOP (32 us at 67 TFLOP/s), but its positions are a serial chain:
// each waits for the head's h_{t-1}, so a position's latency (h's words
// from L2 once they are there, 32 rows of four multiply-adds a thread,
// the cell, the store) sets the time: 2.4 us a position at S = 256 on an
// H100, against 4.84 us with the barrier the ring replaced (an arrival
// counter a head, a fence on either side) and the dot products issuing a
// pass's absent rows as predicated-off instructions (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnits = 16;                   // hidden units a block
constexpr int kCols = 4 * kUnits;            // gate columns a block
constexpr int kThreads = 256;
constexpr int kGroups = kCols / 4;           // 4-column groups a block
constexpr int kSlices = kThreads / kGroups;  // slices of the hd rows
constexpr int kRows = 8;                     // batch rows a pass
constexpr int kMaxHd = 512;

constexpr size_t smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(hd) * kCols +
                          static_cast<size_t>(kRows) * hd +
                          kSlices * kRows * kCols);
}

// a ring word: the value in the low half, its position tag in the high
__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(w)
               : "l"(p)
               : "memory");
  return w;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(w)
               : "memory");
}

// this thread's four columns (group grp) of NB rows' dot products over
// its slice of the hd rows, four independent chains of fused multiply-adds
// a row, into part[slice][rb][.] (NB a template argument: rows past the
// pass's own would otherwise issue as predicated-off instructions)
template <int NB>
__device__ __forceinline__ void dots(const float* w_s, const float* h_s,
                                     float* part, int hd, int k0, int span,
                                     int grp, int slice) {
  float4 acc[NB];
#pragma unroll
  for (int rb = 0; rb < NB; ++rb) acc[rb] = make_float4(0, 0, 0, 0);
#pragma unroll 4
  for (int k = k0; k < k0 + span; ++k) {
    const float4 w = reinterpret_cast<const float4*>(w_s)[k * kGroups + grp];
#pragma unroll
    for (int rb = 0; rb < NB; ++rb) {
      const float x = h_s[rb * hd + k];
      acc[rb].x = __fmaf_rn(x, w.x, acc[rb].x);
      acc[rb].y = __fmaf_rn(x, w.y, acc[rb].y);
      acc[rb].z = __fmaf_rn(x, w.z, acc[rb].z);
      acc[rb].w = __fmaf_rn(x, w.w, acc[rb].w);
    }
  }
#pragma unroll
  for (int rb = 0; rb < NB; ++rb)
    reinterpret_cast<float4*>(part)[(slice * kRows + rb) * kGroups + grp] =
        acc[rb];
}

__global__ void __launch_bounds__(kThreads, 1)
slstm_scan_kernel(const float* __restrict__ wx, const float* __restrict__ r,
                  const float* __restrict__ c0, const float* __restrict__ n0,
                  const float* __restrict__ m0, const float* __restrict__ h0,
                  float* __restrict__ h, float* c_out, float* n_out,
                  float* m_out, float* h_out, unsigned long long* ring,
                  float* __restrict__ g_save, float* __restrict__ c_save,
                  float* __restrict__ n_save, float* __restrict__ m_save,
                  int batch, int seq, int nh, int hd) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                                   // [hd][kCols]
  float* h_s = w_s + static_cast<size_t>(hd) * kCols;  // [kRows][hd]
  float* part = h_s + static_cast<size_t>(kRows) * hd;  // [kSlices][kRows]
                                                        // [kCols]

  const int per_head = hd / kUnits;
  const int head = blockIdx.x / per_head;
  const int unit0 = (blockIdx.x % per_head) * kUnits;
  const int tid = threadIdx.x;
  const int gw = 4 * hd;                    // gate columns of a head
  const size_t d4 = static_cast<size_t>(nh) * gw;

  // this block's 64 columns of r[head], 4 at a time: column j is gate
  // j / 16 of unit unit0 + j % 16
  const float* rh = r + static_cast<size_t>(head) * hd * gw;
#pragma unroll 8
  for (int e = tid; e < hd * kGroups; e += kThreads) {
    const int k = e / kGroups, j = (e % kGroups) * 4;
    reinterpret_cast<float4*>(w_s)[e] = *reinterpret_cast<const float4*>(
        rh + static_cast<size_t>(k) * gw + (j / kUnits) * hd + unit0 +
        j % kUnits);
  }

  const int grp = tid % kGroups, slice = tid / kGroups;
  const int span = hd / kSlices;
  const int k0 = slice * span;

  const size_t slot = static_cast<size_t>(batch) * nh * hd;  // ring slot
  for (int t = 0; t < seq; ++t) {
    for (int b0 = 0; b0 < batch; b0 += kRows) {
      const int nb = min(kRows, batch - b0);
      // the cell's input part of the gates and its state (each element
      // read and written by this thread only), loaded before the wait
      const bool cell = tid < nb * kUnits;
      const size_t at_cell = (static_cast<size_t>(b0 + tid / kUnits) * nh +
                              head) * hd + unit0 + tid % kUnits;
      float gx[4] = {0.f, 0.f, 0.f, 0.f}, cnm[3] = {0.f, 0.f, 0.f};
      if (cell) {
        const size_t bt = static_cast<size_t>(b0 + tid / kUnits) * seq + t;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gx[q] = wx[bt * d4 + static_cast<size_t>(head) * gw + q * hd +
                     unit0 + tid % kUnits];
        cnm[0] = t == 0 ? c0[at_cell] : c_out[at_cell];
        cnm[1] = t == 0 ? n0[at_cell] : n_out[at_cell];
        cnm[2] = t == 0 ? m0[at_cell] : m_out[at_cell];
      }
      __syncthreads();               // w_s loaded; h_s / part free again
      const unsigned long long* prev = ring + ((t + 1) & 1) * slot;
      for (int e = tid; e < nb * hd; e += kThreads) {
        const int rb = e / hd, k = e - rb * hd;
        const size_t at = (static_cast<size_t>(b0 + rb) * nh + head) * hd + k;
        if (t == 0) {
          h_s[e] = h0[at];
        } else {
          unsigned long long w = load_word(prev + at);
          while (static_cast<unsigned>(w >> 32) != static_cast<unsigned>(t))
            w = load_word(prev + at);
          h_s[e] = __uint_as_float(static_cast<unsigned>(w));
        }
      }
      __syncthreads();

      switch (nb) {
        case 1: dots<1>(w_s, h_s, part, hd, k0, span, grp, slice); break;
        case 2: dots<2>(w_s, h_s, part, hd, k0, span, grp, slice); break;
        case 3: dots<3>(w_s, h_s, part, hd, k0, span, grp, slice); break;
        case 4: dots<4>(w_s, h_s, part, hd, k0, span, grp, slice); break;
        case 5: dots<5>(w_s, h_s, part, hd, k0, span, grp, slice); break;
        case 6: dots<6>(w_s, h_s, part, hd, k0, span, grp, slice); break;
        case 7: dots<7>(w_s, h_s, part, hd, k0, span, grp, slice); break;
        default: dots<8>(w_s, h_s, part, hd, k0, span, grp, slice); break;
      }
      __syncthreads();

      if (cell) {
        const int rb = tid / kUnits, u = tid % kUnits;
        const size_t bt = static_cast<size_t>(b0 + rb) * seq + t;
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float dot = 0.f;
#pragma unroll
          for (int s = 0; s < kSlices; ++s)
            dot = __fadd_rn(dot, part[(s * kRows + rb) * kCols +
                                      q * kUnits + u]);
          g[q] = __fadd_rn(gx[q], dot);
        }
        const size_t at = at_cell;
        const float c = cnm[0], n = cnm[1], m = cnm[2];
        const float z = tanhf(g[0]);
        const float o = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g[3])));
        const float fl = __fsub_rn(fminf(g[2], 0.f),
                                   log1pf(expf(-fabsf(g[2]))));
        const float fm = __fadd_rn(fl, m);
        const float m_new = fmaxf(fm, g[1]);
        const float i_p = expf(__fsub_rn(g[1], m_new));
        const float f_p = expf(__fsub_rn(fm, m_new));
        const float c_new = __fadd_rn(__fmul_rn(f_p, c), __fmul_rn(i_p, z));
        const float n_new = __fadd_rn(__fmul_rn(f_p, n), i_p);
        const float h_new = __fdiv_rn(__fmul_rn(o, c_new),
                                      fmaxf(n_new, 1e-6f));
        c_out[at] = c_new;
        n_out[at] = n_new;
        m_out[at] = m_new;
        if (g_save != nullptr) {
          // the saves for the backward: the pre-activations and the state
          const size_t sg = (bt * nh + head) * gw + unit0 + u;
#pragma unroll
          for (int q = 0; q < 4; ++q) g_save[sg + q * hd] = g[q];
          const size_t ss = (bt * nh + head) * hd + unit0 + u;
          c_save[ss] = c_new;
          n_save[ss] = n_new;
          m_save[ss] = m_new;
        }
        h[(bt * nh + head) * hd + unit0 + u] = h_new;
        if (t + 1 < seq)
          store_word(ring + (t & 1) * slot + at,
                     (static_cast<unsigned long long>(t + 1) << 32) |
                         __float_as_uint(h_new));
        else
          h_out[at] = h_new;
      }
    }
  }
}

}  // namespace

// wx f32 [B, S, nh, 4hd]; r f32 [nh, hd, 4hd]; c0, n0, m0, h0 f32
// [B, nh, hd]; h f32 [B, S, nh, hd]; c_out, n_out, m_out, h_out as c0;
// ring: 2 B nh hd 64-bit words (zeroed here), used only for S > 1.
// g_save [B, S, nh, 4hd] and c_save, n_save, m_save [B, S, nh, hd] (all
// null, or all set: the saves for the backward) take each position's
// pre-activations and state; they change nothing else.  hd a multiple of
// 16, at most 512.  Returns the launch's CUDA error, or 0.
extern "C" int slstm_scan_launch(const void* wx, const void* r,
                                 const void* c0, const void* n0,
                                 const void* m0, const void* h0, void* h,
                                 void* c_out, void* n_out, void* m_out,
                                 void* h_out, void* ring, void* g_save,
                                 void* c_save, void* n_save, void* m_save,
                                 int batch, int seq, int nh, int hd,
                                 void* stream_ptr) {
  const bool save = g_save != nullptr;
  if (hd % kUnits != 0 || hd > kMaxHd || hd <= 0 || nh <= 0 || seq <= 0 ||
      batch <= 0 || (seq > 1 && ring == nullptr) ||
      save != (c_save != nullptr) || save != (n_save != nullptr) ||
      save != (m_save != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  // the opt-in above 48 KB of shared memory, once a device, for the
  // largest head dim (so every launch, captured ones included, may use it)
  static bool opted[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 64 && !opted[device]) {
    err = cudaFuncSetAttribute(slstm_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(kMaxHd)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[device] = true;
  }
  const dim3 grid(nh * (hd / kUnits));
  const size_t smem = smem_bytes(hd);
  auto* wx_ = static_cast<const float*>(wx);
  auto* r_ = static_cast<const float*>(r);
  auto* c0_ = static_cast<const float*>(c0);
  auto* n0_ = static_cast<const float*>(n0);
  auto* m0_ = static_cast<const float*>(m0);
  auto* h0_ = static_cast<const float*>(h0);
  auto* h_ = static_cast<float*>(h);
  auto* c_ = static_cast<float*>(c_out);
  auto* n_ = static_cast<float*>(n_out);
  auto* m_ = static_cast<float*>(m_out);
  auto* ho_ = static_cast<float*>(h_out);
  auto* rg = static_cast<unsigned long long*>(ring);
  auto* gs_ = static_cast<float*>(g_save);
  auto* cs_ = static_cast<float*>(c_save);
  auto* ns_ = static_cast<float*>(n_save);
  auto* ms_ = static_cast<float*>(m_save);
  if (seq == 1) {
    slstm_scan_kernel<<<grid, kThreads, smem, stream>>>(
        wx_, r_, c0_, n0_, m0_, h0_, h_, c_, n_, m_, ho_, nullptr, gs_, cs_,
        ns_, ms_, batch, seq, nh, hd);
    return static_cast<int>(cudaGetLastError());
  }
  err = cudaMemsetAsync(rg, 0,
                        sizeof(unsigned long long) * 2 * batch * nh * hd,
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&wx_, &r_,  &c0_, &n0_, &m0_, &h0_, &h_,
                  &c_,  &n_,  &m_,  &ho_, &rg,  &gs_, &cs_,
                  &ns_, &ms_, &batch, &seq, &nh, &hd};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(slstm_scan_kernel), grid,
      dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The backward, under autograd
// ---------------------------------------------------------------------------
//
// The reference differentiates its lax.scan with jax.grad.  Here the
// forward saved each position's pre-activations g and state c, n, m, and
// the backward runs the positions in reverse.  Per row, head and unit, at
// position t, with dh the output's gradient plus the recurrent one
// (sum_j r[head, u, j] dg_{t+1, j}: the next position's gate gradients of
// the whole head) and the carried dc, dn, dm:
//
//   N = max(n, 1e-6);  d(oc) = dh / N;  dN = -d(oc) (o c) / N
//   dc += d(oc) o;  dn += dN where n >= 1e-6;  do = d(oc) c
//   df' = dc c_{t-1} + dn n_{t-1};  di' = dc z + dn;  dz = dc i'
//   da = f' df';  db = i' di';  dM = dm - da - db (the gradient of m)
//   m = max(f + m_{t-1}, g_i): dM to the larger side (half each at a tie)
//   dg = [dz (1 - z^2), db + dM_i, (da + dM_f) sigmoid(-g_f), do o (1 - o)]
//   carried: dc f', dn f', dm = da + dM_f
//
// Grid: nh x (hd / 16) blocks of 256 threads, as the forward, with the
// partition transposed: a block owns 16 units' rows of r[head] ([16, 4 hd],
// 128 KB at hd = 512, in shared memory, rows padded by 4 words), so at each
// position it forms its units' recurrent gradient from all 4 hd gate
// gradients of the head (16 slices of the 4 hd columns, summed in order),
// runs the cell's backward for its units (16 threads a row) and publishes
// their 64 gate gradients as tagged 64-bit words in a ring of two
// positions, as the forward publishes h (the same argument makes two slots
// enough).  Blocks that wait on each other must all be resident: a
// cooperative launch.  d r_gates = sum_{b,t} h_{t-1} (x) dg_t is a plain
// product the wrapper leaves to torch.matmul; d wx = dg.
//
// What bounds it on an H100: as the forward, the serial chain of
// positions (each waits for the head's gate gradients of the position
// after); its products are 2 B S nh hd 4hd (8.59 GFLOP at B = 4, S = 256,
// 4 heads of 512: 0.128 ms at 67 TFLOP/s).  Measured (PERF.md): 2.23 ms
// at that shape, 8.7 us a position, with the ring's words loaded eight a
// thread at once (3.59 ms one at a time).
namespace {

__host__ __device__ constexpr int bwd_ld(int hd) { return 4 * hd + 4; }
constexpr int kRing = 8;                     // ring words a thread in flight

constexpr size_t bwd_smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(kUnits) * bwd_ld(hd) +
                          static_cast<size_t>(kRows) * 4 * hd +
                          kSlices * kRows * kUnits);
}
static_assert(bwd_smem_bytes(kMaxHd) <= 232448,
              "the backward's shared memory at hd = 512");

template <int NB>
__device__ __forceinline__ void bwd_dots(const float* w_s, const float* g_s,
                                         float* part, int hd, int uu,
                                         int slice) {
  const int span = hd / 4;                  // a sixteenth of the 4 hd
  const int c0 = slice * span;
  const int ld = bwd_ld(hd);
  float acc[NB];
#pragma unroll
  for (int rb = 0; rb < NB; ++rb) acc[rb] = 0.f;
#pragma unroll 2
  for (int c = c0; c < c0 + span; c += 4) {
    const float4 w = *reinterpret_cast<const float4*>(w_s + uu * ld + c);
#pragma unroll
    for (int rb = 0; rb < NB; ++rb) {
      const float4 x =
          *reinterpret_cast<const float4*>(g_s + rb * 4 * hd + c);
      acc[rb] = __fmaf_rn(w.x, x.x, acc[rb]);
      acc[rb] = __fmaf_rn(w.y, x.y, acc[rb]);
      acc[rb] = __fmaf_rn(w.z, x.z, acc[rb]);
      acc[rb] = __fmaf_rn(w.w, x.w, acc[rb]);
    }
  }
#pragma unroll
  for (int rb = 0; rb < NB; ++rb)
    part[(slice * kRows + rb) * kUnits + uu] = acc[rb];
}

__global__ void __launch_bounds__(kThreads, 1)
slstm_bwd_kernel(const float* __restrict__ r, const float* __restrict__ dhs,
                 const float* __restrict__ gsave,
                 const float* __restrict__ csave,
                 const float* __restrict__ nsave,
                 const float* __restrict__ msave,
                 const float* __restrict__ c0, const float* __restrict__ n0,
                 const float* __restrict__ m0, float* dcar, float* dncar,
                 float* dmcar, float* __restrict__ dwx,
                 unsigned long long* ring, int batch, int seq, int nh,
                 int hd) {
  extern __shared__ __align__(16) float smem[];
  const int ld = bwd_ld(hd);
  float* w_s = smem;                                      // [kUnits][ld]
  float* g_s = w_s + static_cast<size_t>(kUnits) * ld;    // [kRows][4 hd]
  float* part = g_s + static_cast<size_t>(kRows) * 4 * hd;  // [kSlices]
                                                          // [kRows][kUnits]
  const int per_head = hd / kUnits;
  const int head = blockIdx.x / per_head;
  const int unit0 = (blockIdx.x % per_head) * kUnits;
  const int tid = threadIdx.x;
  const int gw = 4 * hd;
  const size_t d4 = static_cast<size_t>(nh) * gw;

  // this block's 16 rows of r[head], 4 floats at a time
  const float* rh = r + (static_cast<size_t>(head) * hd + unit0) * gw;
  for (int e = tid; e < kUnits * hd; e += kThreads) {
    const int u = e / hd, c = (e - u * hd) * 4;
    *reinterpret_cast<float4*>(w_s + u * ld + c) =
        *reinterpret_cast<const float4*>(rh + static_cast<size_t>(u) * gw + c);
  }
  const int uu = tid % kUnits, slice = tid / kUnits;

  const size_t slot = static_cast<size_t>(batch) * d4;   // ring slot
  for (int tau = 0; tau < seq; ++tau) {
    const int t = seq - 1 - tau;
    for (int b0 = 0; b0 < batch; b0 += kRows) {
      const int nb = min(kRows, batch - b0);
      const bool cell = tid < nb * kUnits;
      const int rb = tid / kUnits, u = tid % kUnits;
      const size_t at = (static_cast<size_t>(b0 + rb) * nh + head) * hd +
                        unit0 + u;
      const size_t bt = static_cast<size_t>(b0 + rb) * seq + t;
      const size_t sat = (bt * nh + head) * hd + unit0 + u;
      const size_t gat = (bt * nh + head) * gw + unit0 + u;
      // the cell's saves and carries, loaded before the wait
      float g[4] = {0.f, 0.f, 0.f, 0.f}, st[6] = {0.f, 0.f, 0.f, 0.f, 0.f,
                                                 0.f};
      float car[3] = {0.f, 0.f, 0.f}, dh = 0.f;
      if (cell) {
#pragma unroll
        for (int q = 0; q < 4; ++q) g[q] = gsave[gat + q * hd];
        st[0] = csave[sat];
        st[1] = nsave[sat];
        st[2] = msave[sat];
        const size_t pat = sat - static_cast<size_t>(nh) * hd;
        st[3] = t > 0 ? csave[pat] : c0[at];
        st[4] = t > 0 ? nsave[pat] : n0[at];
        st[5] = t > 0 ? msave[pat] : m0[at];
        car[0] = dcar[at];
        car[1] = dncar[at];
        car[2] = dmcar[at];
        dh = dhs[sat];
      }
      __syncthreads();               // w_s loaded; g_s / part free again
      if (tau > 0) {
        // the head's gate gradients of the position after, kRing words a
        // thread in flight at once, each polled again until its tag is tau
        const unsigned long long* prev = ring + ((tau - 1) & 1) * slot;
        const size_t row0 = (static_cast<size_t>(b0) * nh + head) * gw;
        const size_t rstride = static_cast<size_t>(nh) * gw;
        for (int e0 = tid; e0 < nb * gw; e0 += kRing * kThreads) {
          unsigned long long w[kRing];
#pragma unroll
          for (int j = 0; j < kRing; ++j) {
            const int e = e0 + j * kThreads;
            if (e < nb * gw)
              w[j] = load_word(prev + row0 + (e / gw) * rstride + e % gw);
          }
#pragma unroll
          for (int j = 0; j < kRing; ++j) {
            const int e = e0 + j * kThreads;
            if (e < nb * gw) {
              const unsigned long long* at =
                  prev + row0 + (e / gw) * rstride + e % gw;
              while (static_cast<unsigned>(w[j] >> 32) !=
                     static_cast<unsigned>(tau))
                w[j] = load_word(at);
              g_s[e] = __uint_as_float(static_cast<unsigned>(w[j]));
            }
          }
        }
        __syncthreads();
        switch (nb) {
          case 1: bwd_dots<1>(w_s, g_s, part, hd, uu, slice); break;
          case 2: bwd_dots<2>(w_s, g_s, part, hd, uu, slice); break;
          case 3: bwd_dots<3>(w_s, g_s, part, hd, uu, slice); break;
          case 4: bwd_dots<4>(w_s, g_s, part, hd, uu, slice); break;
          case 5: bwd_dots<5>(w_s, g_s, part, hd, uu, slice); break;
          case 6: bwd_dots<6>(w_s, g_s, part, hd, uu, slice); break;
          case 7: bwd_dots<7>(w_s, g_s, part, hd, uu, slice); break;
          default: bwd_dots<8>(w_s, g_s, part, hd, uu, slice); break;
        }
        __syncthreads();
      }
      if (cell) {
        if (tau > 0) {
          float rec = 0.f;
#pragma unroll
          for (int s = 0; s < kSlices; ++s)
            rec = __fadd_rn(rec, part[(s * kRows + rb) * kUnits + u]);
          dh = __fadd_rn(dh, rec);
        }
        const float c = st[0], n = st[1], m = st[2];
        const float cp = st[3], np = st[4], mp = st[5];
        const float z = tanhf(g[0]);
        const float o = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g[3])));
        const float fl = __fsub_rn(fminf(g[2], 0.f),
                                   log1pf(expf(-fabsf(g[2]))));
        const float sf = __fdiv_rn(1.f, __fadd_rn(1.f, expf(g[2])));
        const float fm = __fadd_rn(fl, mp);
        const float i_p = expf(__fsub_rn(g[1], m));
        const float f_p = expf(__fsub_rn(fm, m));
        const float big_n = fmaxf(n, 1e-6f);
        const float doc = __fdiv_rn(dh, big_n);
        const float oc = __fmul_rn(o, c);
        const float dn_h = -__fdiv_rn(__fmul_rn(doc, oc), big_n);
        const float dct = __fadd_rn(car[0], __fmul_rn(doc, o));
        const float dnt = n >= 1e-6f ? __fadd_rn(car[1], dn_h) : car[1];
        const float d_o = __fmul_rn(doc, c);
        const float dfp = __fadd_rn(__fmul_rn(dct, cp), __fmul_rn(dnt, np));
        const float dip = __fadd_rn(__fmul_rn(dct, z), dnt);
        const float dz = __fmul_rn(dct, i_p);
        const float da = __fmul_rn(f_p, dfp), db = __fmul_rn(i_p, dip);
        const float dm = __fsub_rn(__fsub_rn(car[2], da), db);
        float dfm = da, dgi = db;
        if (fm > g[1]) dfm = __fadd_rn(dfm, dm);
        else if (g[1] > fm) dgi = __fadd_rn(dgi, dm);
        else {
          dfm = __fadd_rn(dfm, 0.5f * dm);
          dgi = __fadd_rn(dgi, 0.5f * dm);
        }
        float dg[4];
        dg[0] = __fmul_rn(dz, __fsub_rn(1.f, __fmul_rn(z, z)));
        dg[1] = dgi;
        dg[2] = __fmul_rn(dfm, sf);
        dg[3] = __fmul_rn(__fmul_rn(d_o, o), __fsub_rn(1.f, o));
        dcar[at] = __fmul_rn(dct, f_p);
        dncar[at] = __fmul_rn(dnt, f_p);
        dmcar[at] = dfm;
        const size_t wat = (static_cast<size_t>(b0 + rb) * nh + head) * gw +
                           unit0 + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dwx[bt * d4 + static_cast<size_t>(head) * gw + q * hd + unit0 + u] =
              dg[q];
          if (tau + 1 < seq)
            store_word(ring + (tau & 1) * slot + wat + q * hd,
                       (static_cast<unsigned long long>(tau + 1) << 32) |
                           __float_as_uint(dg[q]));
        }
      }
    }
  }
}

}  // namespace

// The backward: r f32 [nh, hd, 4hd]; dhs f32 [B, S, nh, hd] (the outputs'
// gradient, the final h's added at the last position); gsave, csave,
// nsave, msave the forward's saves; c0, n0, m0 [B, nh, hd] the starting
// state; dcar, dncar, dmcar [B, nh, hd]: in, the final state's gradients
// (zeros for none), out, the starting state's; dwx f32 [B, S, nh, 4hd];
// ring: 2 B nh 4hd 64-bit words (zeroed here), used only for S > 1.  A
// cooperative launch for S > 1.  Returns the launch's CUDA error, or 0.
extern "C" int slstm_scan_bwd_launch(
    const void* r, const void* dhs, const void* gsave, const void* csave,
    const void* nsave, const void* msave, const void* c0, const void* n0,
    const void* m0, void* dcar, void* dncar, void* dmcar, void* dwx,
    void* ring, int batch, int seq, int nh, int hd, void* stream_ptr) {
  if (hd % kUnits != 0 || hd > kMaxHd || hd <= 0 || nh <= 0 || seq <= 0 ||
      batch <= 0 || (seq > 1 && ring == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  static bool opted[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 64 && !opted[device]) {
    err = cudaFuncSetAttribute(slstm_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bwd_smem_bytes(kMaxHd)));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[device] = true;
  }
  const dim3 grid(nh * (hd / kUnits));
  const size_t smem = bwd_smem_bytes(hd);
  auto* r_ = static_cast<const float*>(r);
  auto* dhs_ = static_cast<const float*>(dhs);
  auto* gs_ = static_cast<const float*>(gsave);
  auto* cs_ = static_cast<const float*>(csave);
  auto* ns_ = static_cast<const float*>(nsave);
  auto* ms_ = static_cast<const float*>(msave);
  auto* c0_ = static_cast<const float*>(c0);
  auto* n0_ = static_cast<const float*>(n0);
  auto* m0_ = static_cast<const float*>(m0);
  auto* dc_ = static_cast<float*>(dcar);
  auto* dn_ = static_cast<float*>(dncar);
  auto* dm_ = static_cast<float*>(dmcar);
  auto* dwx_ = static_cast<float*>(dwx);
  auto* rg = static_cast<unsigned long long*>(ring);
  if (seq == 1) {
    slstm_bwd_kernel<<<grid, kThreads, smem, stream>>>(
        r_, dhs_, gs_, cs_, ns_, ms_, c0_, n0_, m0_, dc_, dn_, dm_, dwx_,
        nullptr, batch, seq, nh, hd);
    return static_cast<int>(cudaGetLastError());
  }
  err = cudaMemsetAsync(rg, 0,
                        sizeof(unsigned long long) * 2 * batch * nh * 4 * hd,
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&r_,  &dhs_, &gs_, &cs_, &ns_, &ms_,  &c0_,
                  &n0_, &m0_,  &dc_, &dn_, &dm_, &dwx_, &rg,
                  &batch, &seq, &nh, &hd};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(slstm_bwd_kernel), grid, dim3(kThreads),
      args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
