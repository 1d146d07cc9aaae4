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
// Grid: nh x (hd / 16) blocks of 256 threads, the forward's partition: a
// block owns 16 units of one head and their 64 gate columns of r[head]
// ([hd][64], 128 KB at hd = 512).  Each thread keeps two rows k of them in
// registers for the whole launch (128 floats), so a position's product
// reads nothing but the gate gradients from shared memory, as a broadcast
// (the rows in shared memory, read again at every position, took 15% more
// time: PERF.md).  Every gate gradient a block's cells produce meets its
// own columns, and at each position, for each pass of up to 8 rows, it
//
//   1. reads its units' recurrent gradient: the hd / 16 partials of each
//      (row, unit) that the head's blocks published a position before,
//      all of a thread's words (8 at B = 4, hd = 512; 16 above 4 rows) in
//      flight before any is polled again, and sums them in source order,
//      a fixed tree: four lanes of hd / 64 consecutive sources each,
//      summed in order, then (l0 + l1) + (l2 + l3) -- no float atomics,
//      two calls agree bit for bit;
//   2. adds the output's gradient and runs the cell's backward for its
//      16 units x nb rows (16 threads a row; dc, dn, dm carried in place);
//   3. writes dwx and keeps its 64 gate gradients in shared memory;
//   4. forms its partial of the head's recurrent gradient,
//      p[b, k] = sum over its 64 columns j of r[head, k, j] dg_t[b, j]
//      for all hd rows k (two rows k a thread, its nb rows: 512 fused
//      multiply-adds a thread at B = 4), and publishes it as 64-bit words
//      (value, tag tau + 1) in a ring [2][B][nh][hd / 16 source
//      blocks][hd] (zeroed before the launch: 4 MB at B = 4, 4 heads of
//      512).
//
// Two ring slots suffice.  A block writes position tau + 1's partials
// into the slot that held tau - 1's only after it has read all hd / 16
// partials of position tau, one from every block of its head; each of
// those blocks published tau only after it had read all of tau - 1's.
// So no block overwrites a slot while another still needs it.  The
// argument needs every block to read from every block of its head, which
// the partition gives: each (row, unit) takes a partial from each block.
// Blocks that wait on each other must all be resident: a cooperative
// launch.  S = 1 reads and publishes nothing: a plain launch.
// d r_gates = sum_{b,t} h_{t-1} (x) dg_t is a plain product the wrapper
// leaves to torch.matmul; d wx = dg.
//
// What bounds it on an H100: as the forward, the serial chain of
// positions (each waits for the head's partials of the position after);
// its products are 2 B S nh hd 4hd (8.59 GFLOP at B = 4, S = 256, 4 heads
// of 512: 0.128 ms at 67 TFLOP/s).  A position exchanges 2 MB through L2
// each way across the grid, one round trip a block.  Measured at that
// shape (PERF.md; NVIDIA H100 80GB HBM3, 700 W): 0.77-0.92 ms on the
// device, 3.0-3.6 us a position, where the earlier partition (a block a
// head's 16 units' rows of r[head], reading the head's 4 hd gate
// gradients of each row: 8 MB a position, four rounds of loads) took
// 2.23-2.51 ms in the same processes.  clock64() stamps split a position
// of 3.4 us into 1.3 us waiting for and summing the partials, 0.5 us the
// cell and 1.4 us the product and its stores.  The kernel sits at the
// register limit (255, 12 bytes spilled): forms that kept more live (the
// cell's dh-free part computed while the words travel) or polled the two
// rounds of reads one after the other ran 23-38% slower.
namespace {

constexpr int kLanes = 4;                    // threads a (row, unit) sum
constexpr int kLaneSrc = kMaxHd / kUnits / kLanes;  // sources a lane
constexpr int kOutSpan = kThreads / kLanes;  // (row, unit)s a lane round
constexpr int kOutRounds = kRows * kUnits / kOutSpan;
constexpr int kRowsPer = 2;                  // rows k of r a thread
static_assert(kRowsPer * kThreads >= kMaxHd, "two rows k a thread");

// shared memory: the gate gradients dg_s [kRows][kCols] and the lanes'
// sums red_s [kLanes][kRows kUnits]
constexpr size_t kBwdSmem = sizeof(float) * (kRows * kCols +
                                             kLanes * kRows * kUnits);

// the block's partial of the head's recurrent gradient for this thread's
// rows k of r[head] (tid + i kThreads; their 64 columns in registers, wv)
// and the pass's NB batch rows, from the gate gradients dg_s, as ring
// words tagged ``tag``: out + rb * rstride + k
template <int NB>
__device__ __forceinline__ void bwd_partials(
    const float4 (&wv)[kRowsPer][kGroups], const float* dg_s,
    unsigned long long* out, size_t rstride, int hd, unsigned tag) {
  const int tid = threadIdx.x;
  if (tid >= hd) return;
  float acc[kRowsPer][NB];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
#pragma unroll
    for (int rb = 0; rb < NB; ++rb) acc[i][rb] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
#pragma unroll
    for (int rb = 0; rb < NB; ++rb) {
      const float4 g = reinterpret_cast<const float4*>(dg_s + rb * kCols)[j];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        acc[i][rb] = __fmaf_rn(wv[i][j].x, g.x, acc[i][rb]);
        acc[i][rb] = __fmaf_rn(wv[i][j].y, g.y, acc[i][rb]);
        acc[i][rb] = __fmaf_rn(wv[i][j].z, g.z, acc[i][rb]);
        acc[i][rb] = __fmaf_rn(wv[i][j].w, g.w, acc[i][rb]);
      }
    }
  }
  const unsigned long long hi = static_cast<unsigned long long>(tag) << 32;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int k = tid + i * kThreads;
    if (k >= hd) continue;
#pragma unroll
    for (int rb = 0; rb < NB; ++rb)
      store_word(out + rb * rstride + k, hi | __float_as_uint(acc[i][rb]));
  }
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
  float* dg_s = smem;                    // [kRows][kCols]
  float* red_s = dg_s + kRows * kCols;   // [kLanes][kRows * kUnits]
  const int per_head = hd / kUnits;      // source blocks a head
  const int head = blockIdx.x / per_head;
  const int src = blockIdx.x % per_head;
  const int unit0 = src * kUnits;
  const int tid = threadIdx.x;
  const int gw = 4 * hd;
  const size_t d4 = static_cast<size_t>(nh) * gw;

  // this block's 64 columns of r[head] (column j: gate j / 16 of unit
  // unit0 + j % 16), this thread's rows k of them in registers for every
  // position (a row past hd takes row hd - 1 and stores nothing)
  const float* rh = r + static_cast<size_t>(head) * hd * gw + unit0;
  float4 wv[kRowsPer][kGroups];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const size_t k = min(tid + i * kThreads, hd - 1);
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
      wv[i][j] = *reinterpret_cast<const float4*>(
          rh + k * gw + (j * 4 / kUnits) * hd + j * 4 % kUnits);
  }

  // the ring: word (slot, b, head, source, k); a row b's words are
  // rstride apart
  const size_t rstride = static_cast<size_t>(nh) * per_head * hd;
  const size_t slot = static_cast<size_t>(batch) * rstride;
  const size_t mine = (static_cast<size_t>(head) * per_head + src) * hd;
  const size_t theirs = static_cast<size_t>(head) * per_head * hd + unit0;
  // the reads: lane ``lane`` sums sources [lane q, lane q + q) of the
  // (row, unit)s o = oo + kOutSpan i
  const int q = (per_head + kLanes - 1) / kLanes;
  const int lane = tid / kOutSpan, oo = tid % kOutSpan;

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
        for (int qq = 0; qq < 4; ++qq) g[qq] = gsave[gat + qq * hd];
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
      if (tau > 0) {
        // the partials of position tau - 1 (tag tau), every word of this
        // thread's in flight at once, each polled again until its tag is
        // tau; a lane's sources summed in order
        const unsigned long long* prev =
            ring + ((tau - 1) & 1) * slot + b0 * rstride + theirs;
        unsigned long long w[kOutRounds][kLaneSrc];
#pragma unroll
        for (int i = 0; i < kOutRounds; ++i) {
          const int o = oo + i * kOutSpan;
#pragma unroll
          for (int j = 0; j < kLaneSrc; ++j) {
            const int s = lane * q + j;
            if (o < nb * kUnits && j < q && s < per_head)
              w[i][j] = load_word(prev + (o / kUnits) * rstride +
                                  static_cast<size_t>(s) * hd + o % kUnits);
          }
        }
#pragma unroll
        for (int i = 0; i < kOutRounds; ++i) {
          const int o = oo + i * kOutSpan;
          if (o >= nb * kUnits) continue;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kLaneSrc; ++j) {
            const int s = lane * q + j;
            if (j < q && s < per_head) {
              const unsigned long long* p = prev + (o / kUnits) * rstride +
                                            static_cast<size_t>(s) * hd +
                                            o % kUnits;
              while (static_cast<unsigned>(w[i][j] >> 32) !=
                     static_cast<unsigned>(tau))
                w[i][j] = load_word(p);
              sum = __fadd_rn(sum,
                              __uint_as_float(static_cast<unsigned>(w[i][j])));
            }
          }
          red_s[lane * (kRows * kUnits) + o] = sum;
        }
      }
      __syncthreads();          // red_s filled; dg_s free again
      if (cell) {
        if (tau > 0) {
          constexpr int n = kRows * kUnits;
          const int o = tid;
          const float rec = __fadd_rn(__fadd_rn(red_s[o], red_s[n + o]),
                                      __fadd_rn(red_s[2 * n + o],
                                                red_s[3 * n + o]));
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
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          dwx[bt * d4 + static_cast<size_t>(head) * gw + qq * hd + unit0 + u] =
              dg[qq];
          dg_s[rb * kCols + qq * kUnits + u] = dg[qq];
        }
      }
      __syncthreads();          // dg_s filled; red_s free again
      if (tau + 1 < seq) {
        unsigned long long* out =
            ring + (tau & 1) * slot + b0 * rstride + mine;
        const unsigned tag = static_cast<unsigned>(tau + 1);
        switch (nb) {
          case 1: bwd_partials<1>(wv, dg_s, out, rstride, hd, tag); break;
          case 2: bwd_partials<2>(wv, dg_s, out, rstride, hd, tag); break;
          case 3: bwd_partials<3>(wv, dg_s, out, rstride, hd, tag); break;
          case 4: bwd_partials<4>(wv, dg_s, out, rstride, hd, tag); break;
          case 5: bwd_partials<5>(wv, dg_s, out, rstride, hd, tag); break;
          case 6: bwd_partials<6>(wv, dg_s, out, rstride, hd, tag); break;
          case 7: bwd_partials<7>(wv, dg_s, out, rstride, hd, tag); break;
          default: bwd_partials<8>(wv, dg_s, out, rstride, hd, tag); break;
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
// ring: 2 B nh (hd / 16) hd 64-bit words (zeroed here), used only for
// S > 1.  A cooperative launch for S > 1.  Returns the launch's CUDA
// error, or 0.
extern "C" int slstm_scan_bwd_launch(
    const void* r, const void* dhs, const void* gsave, const void* csave,
    const void* nsave, const void* msave, const void* c0, const void* n0,
    const void* m0, void* dcar, void* dncar, void* dmcar, void* dwx,
    void* ring, int batch, int seq, int nh, int hd, void* stream_ptr) {
  if (hd % kUnits != 0 || hd > kMaxHd || hd <= 0 || nh <= 0 || seq <= 0 ||
      batch <= 0 || (seq > 1 && ring == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid(nh * (hd / kUnits));
  const size_t smem = kBwdSmem;
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
  cudaError_t err = cudaMemsetAsync(
      rg, 0, sizeof(unsigned long long) * 2 * batch * nh * (hd / kUnits) * hd,
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
