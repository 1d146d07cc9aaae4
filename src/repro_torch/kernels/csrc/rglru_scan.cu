// The RG-LRU's gates and linear recurrence over a sequence, for Hopper.
//
// No Pallas kernel stands behind it: the reference runs the recurrence
// h_t = a_t h_{t-1} + b_t as a log-depth lax.associative_scan
// (repro/models/recurrent.py::rglru_apply, :326) and one update for a
// decode token (::rglru_step, :337-338).  The port's plain version is a
// Hillis-Steele scan, log2(S) rounds of torch.cat over [B, S, w], after
// some eight full passes of elementwise gates.  This kernel fuses the
// gates into a chunked scan that reads each input once.
//
// Per row b, channel c and position t (rglru_scan.py, ``rglru_gates``):
//
//   log_a = (-8 softplus(lam_c)) sigmoid(ra);  a = exp(log_a)
//   b_t   = sqrt(max(1 - exp(2 log_a), 1e-6)) (sigmoid(ia) xc)
//   h_t   = a h_{t-1} + b_t,  h_{-1} = h0
//
// (products and sums rounded on their own: __fmul_rn / __fadd_rn).
//
// One launch a call.  S <= kChunk (every decode step): rglru_short_kernel,
// a thread a (row, channel) runs the positions from h0.  S > kChunk:
// rglru_scan_kernel, one pass, a block of 128 threads a tile of (row,
// kStrip = 64 channels, chunk of kChunk = 64 positions):
//   1. gates: the block loads the tile's ra, ia and xc once (neighbouring
//      threads on neighbouring channels, four channels a thread when w and
//      the pointers allow), the next position's inputs loading while a
//      position's gates compute, and keeps a and b in shared memory (32 KB:
//      six blocks an SM);
//   2. warps 0-1, a thread a channel: the chunk's scan from h = 0 to its
//      (prod a, local h), published at once for the later chunks of its
//      (row, strip) as two tagged 64-bit words;
//   3. warps 2-3 meanwhile: the carry into the chunk, from h0 through the
//      pairs of every earlier chunk of the (row, strip) in chunk order
//      (kBatch words loaded at once, each polled through L2 until its tag
//      is this call's), then the chunk's scan from it over the kept a and
//      b, writing h.
// The arithmetic is that of the two-pass kernel this one replaced (a
// summary pass, then an apply pass that computed every gate again), step
// for step, so h is bit-identical to it.
//
// Forward progress: a block takes its tile from an atomic ticket in the
// order blocks start, chunk-major, so each chunk it waits for belongs to a
// block that is already running, and publishing waits for nothing.  Calls
// never see each other's words: a word carries the tag 2 e + 1 of the
// call's epoch e (a control word beside the ticket), and the last block to
// take its ticket resets the ticket and advances the epoch for the next
// launch on the stream.  The scratch is zeroed when it is allocated (under
// CUDA graph capture by a fill the graph replays before the launch), so
// an odd tag never matches a word no call wrote.
//
// What bounds it on an H100: bytes, ra, ia and xc read and h written once
// (4 x 26.6 MB at recurrentgemma-2b's B = 1, S = 2600, w = 2560: 32 us at
// 3.35 TB/s; the two-pass kernel moved 186 MB in 158 us).  The gates take
// some 90 instructions an element (four expf, two IEEE divisions, a
// sqrtf: seven MUFU operations), about half the bytes' time at full
// issue.  Clock stamps of each tile (PERF.md) put the kernel's 60 us in
// the gates' phase of each wave of tiles, below the card's rate of loads,
// each tile's serial tail after it (the scans, and the carry's rounds of
// L2 loads), and the 2.07 waves that B = 1, S = 2600 makes: the last
// tiles run almost alone.
//
// The backward (rglru_scan_bwd_launch; rglru_scan.py's module docstring):
// no kernel stands behind it either -- the reference trains through
// jax.grad of the associative scan.  With u_t = a_t g_t, the gradient
// g_t = dh_t + u_{t+1} runs in reverse, and every gradient is g_t times a
// factor of the position's gates, inputs and h_{t-1} (grad_factors, on
// the forward's gate_parts), so one pass computes them all: S <= kChunk
// rglru_bwd_short_kernel (a thread a (row, channel), the positions in
// reverse); S > kChunk rglru_bwd_kernel, the one pass above turned round
// (tiles taken in reverse chunk order, (prod a, local u) published for
// the earlier chunks, the carry folded from the last chunk down).  dlam
// sums over rows and positions: each tile writes its channels' partial,
// and the last tile of a strip to arrive (a tagged counter) sums the
// strip's partials in (row, chunk) order -- no float atomics, the same
// bits every call.  Bound: bytes, ra, ia, xc, h and dh read and dra, dia
// and dxc written once (8 x 10.49 MB at B = 4, S = 256, w = 2560: 25 us
// at 3.35 TB/s); the factors take some 130 instructions an element, about
// half that time at the full instruction rate.  A tile keeps in shared
// memory only what its serial scan reads, a and dh (32 KB, the forward's
// budget: six tiles an SM, so the 640 tiles of recurrentgemma-2b's
// training shape run in one wave); the scan writes g over dh, an add and
// a multiply a step, and all four warps then form the factors from ra
// (read again, from L2), ia, xc and h_{t-1} with 16-byte loads and
// stores.  A form that kept the five factors and dh (96 KB, two tiles an
// SM: 2.42 waves) took 1.4 x as long with the same bits; PERF.md has the
// times.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;
constexpr int kStrip = 64;                   // channels a tile
constexpr int kThreads = 2 * kStrip;         // two scan groups of kStrip
constexpr int kShortThreads = 128;
constexpr int kBatch = 8;                    // earlier chunks' words at once
constexpr int kSmem = 2 * kChunk * kStrip * sizeof(float);   // a and b
constexpr int kBlocksPerSm = 232448 / (kSmem + 1024);

struct Gates {
  float a, b;
};

// a position's gate values: sigmoid(ra), sigmoid(ia), exp(2 log a), beta
// and a
struct GateParts {
  float rg, ig, e2, beta, a;
};

// -8 softplus(lam), as F.softplus (threshold 20) and the plain version's
// product order
__device__ __forceinline__ float neg_c_softplus(float lam) {
  const float sp = lam > 20.f ? lam : log1pf(expf(lam));
  return __fmul_rn(-8.f, sp);
}

__device__ __forceinline__ GateParts gate_parts(float ra, float ia,
                                               float ncs) {
  const float rg = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-ra)));
  const float ig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-ia)));
  const float log_a = __fmul_rn(ncs, rg);
  const float e2 = expf(__fmul_rn(2.f, log_a));
  const float beta = sqrtf(fmaxf(__fsub_rn(1.f, e2), 1e-6f));
  return {rg, ig, e2, beta, expf(log_a)};
}

__device__ __forceinline__ Gates gates(float ra, float ia, float xc,
                                       float ncs) {
  const GateParts q = gate_parts(ra, ia, ncs);
  return {q.a, __fmul_rn(q.beta, __fmul_rn(q.ig, xc))};
}

// a published word: the value in the low half, the call's tag in the high
__device__ __forceinline__ unsigned long long tagged(float v, unsigned tag) {
  return (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
}

__device__ __forceinline__ void store_pair(unsigned long long* p,
                                           unsigned long long x,
                                           unsigned long long y) {
  asm volatile("st.relaxed.gpu.global.v2.b64 [%0], {%1, %2};\n" ::"l"(p),
               "l"(x), "l"(y)
               : "memory");
}

__device__ __forceinline__ ulonglong2 load_pair(const unsigned long long* p) {
  ulonglong2 v;
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];\n"
               : "=l"(v.x), "=l"(v.y)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ bool ready(ulonglong2 v, unsigned tag) {
  return static_cast<unsigned>(v.x >> 32) == tag &&
         static_cast<unsigned>(v.y >> 32) == tag;
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    out[0] = q.x, out[1] = q.y, out[2] = q.z, out[3] = q.w;
  } else {
    out[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_inputs(const float* ra, const float* ia,
                                            const float* xc, size_t at,
                                            float* r, float* i, float* x) {
  load_vec<V>(ra + at, r);
  load_vec<V>(ia + at, i);
  load_vec<V>(xc + at, x);
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

__global__ void __launch_bounds__(kShortThreads)
rglru_short_kernel(const float* __restrict__ ra, const float* __restrict__ ia,
                   const float* __restrict__ xc,
                   const float* __restrict__ lam,
                   const float* __restrict__ h0, float* __restrict__ hs,
                   int seq, int w) {
  const int ch = blockIdx.x * kShortThreads + threadIdx.x;
  if (ch >= w) return;
  const int b = blockIdx.y;
  float h = h0[static_cast<size_t>(b) * w + ch];
  const float ncs = neg_c_softplus(lam[ch]);
  const size_t base = static_cast<size_t>(b) * seq * w + ch;
#pragma unroll 8
  for (int t = 0; t < seq; ++t) {
    const size_t at = base + static_cast<size_t>(t) * w;
    const Gates g = gates(ra[at], ia[at], xc[at], ncs);
    h = __fadd_rn(__fmul_rn(g.a, h), g.b);
    hs[at] = h;
  }
}

// ctrl: [0] the ticket, [1] the blocks that took one, [2] the epoch.
// words: a pair (prod a, local h) a (row, chunk but the last, channel).
template <int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
rglru_scan_kernel(const float* __restrict__ ra, const float* __restrict__ ia,
                  const float* __restrict__ xc, const float* __restrict__ lam,
                  const float* __restrict__ h0, float* __restrict__ hs,
                  unsigned* __restrict__ ctrl,
                  unsigned long long* __restrict__ words, int batch, int seq,
                  int w) {
  extern __shared__ float smem[];
  float* s_a = smem;
  float* s_b = smem + kChunk * kStrip;
  __shared__ unsigned s_tile, s_tag;
  const int tid = threadIdx.x;
  if (tid == 0) {
    const unsigned tile = atomicAdd(&ctrl[0], 1u);
    const unsigned epoch = *reinterpret_cast<volatile unsigned*>(&ctrl[2]);
    __threadfence();
    if (atomicAdd(&ctrl[1], 1u) == gridDim.x - 1) {
      // every block has its ticket and the epoch: ready the next launch
      __threadfence();
      ctrl[0] = 0;
      ctrl[1] = 0;
      ctrl[2] = epoch + 1;
    }
    s_tile = tile;
    s_tag = 2u * epoch + 1u;
  }
  __syncthreads();
  const int strips = (w + kStrip - 1) / kStrip;
  const int chunks = (seq + kChunk - 1) / kChunk;
  const int per_chunk = batch * strips;
  const int tile = static_cast<int>(s_tile);
  const unsigned tag = s_tag;
  const int chunk = tile / per_chunk;
  const int b = (tile - chunk * per_chunk) / strips;
  const int c0 = (tile - chunk * per_chunk - b * strips) * kStrip;
  const int t0 = chunk * kChunk;
  const int len = min(kChunk, seq - t0);
  const size_t row0 = (static_cast<size_t>(b) * seq + t0) * w;

  // 1. the tile's gates, once
  constexpr int kCols = kStrip / V;
  constexpr int kRows = kThreads / kCols;
  const int col = tid % kCols;
  const int ch = c0 + col * V;
  if (ch < w) {
    float ncs[V];
#pragma unroll
    for (int v = 0; v < V; ++v) ncs[v] = neg_c_softplus(lam[ch + v]);
    // the inputs of a thread's next position load while its present
    // position's gates compute
    float r[V], i[V], x[V];
    int t = tid / kCols;
    if (t < len)
      load_inputs<V>(ra, ia, xc, row0 + static_cast<size_t>(t) * w + ch, r,
                     i, x);
    for (; t < len; t += kRows) {
      float rn[V], in[V], xn[V], a[V], g[V];
      if (t + kRows < len)
        load_inputs<V>(ra, ia, xc,
                       row0 + static_cast<size_t>(t + kRows) * w + ch, rn,
                       in, xn);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const Gates q = gates(r[v], i[v], x[v], ncs[v]);
        a[v] = q.a;
        g[v] = q.b;
        r[v] = rn[v], i[v] = in[v], x[v] = xn[v];
      }
      store_vec<V>(s_a + t * kStrip + col * V, a);
      store_vec<V>(s_b + t * kStrip + col * V, g);
    }
  }
  __syncthreads();

  const int lane = tid % kStrip;
  const int c = c0 + lane;
  if (c >= w) return;
  const float* a_col = s_a + lane;
  const float* b_col = s_b + lane;
  unsigned long long* col_words =
      words + 2 * (static_cast<size_t>(b) * (chunks - 1) * w + c);
  const size_t chunk_words = 2 * static_cast<size_t>(w);
  if (tid < kStrip) {
    // 2. the chunk's (prod a, local h) from h = 0; the last chunk's is
    // never read
    if (chunk + 1 == chunks) return;
    float prod = 1.f, h = 0.f;
#pragma unroll 16
    for (int t = 0; t < kChunk; ++t) {
      const float a = a_col[t * kStrip];
      h = __fadd_rn(__fmul_rn(a, h), b_col[t * kStrip]);
      prod = __fmul_rn(prod, a);
    }
    store_pair(col_words + chunk * chunk_words, tagged(prod, tag),
               tagged(h, tag));
    return;
  }
  // 3. the carry from h0 through every earlier chunk in order, then h
  float h = h0[static_cast<size_t>(b) * w + c];
  for (int j0 = 0; j0 < chunk; j0 += kBatch) {
    ulonglong2 p[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (j0 + k < chunk) p[k] = load_pair(col_words + (j0 + k) * chunk_words);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (j0 + k < chunk) {
        while (!ready(p[k], tag))
          p[k] = load_pair(col_words + (j0 + k) * chunk_words);
        h = __fadd_rn(
            __fmul_rn(__uint_as_float(static_cast<unsigned>(p[k].x)), h),
            __uint_as_float(static_cast<unsigned>(p[k].y)));
      }
    }
  }
  float* out = hs + row0 + c;
#pragma unroll 16
  for (int t = 0; t < len; ++t) {
    h = __fadd_rn(__fmul_rn(a_col[t * kStrip], h), b_col[t * kStrip]);
    out[static_cast<size_t>(t) * w] = h;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---------------------------------------------------------------------------
// the backward
// ---------------------------------------------------------------------------

constexpr int kBwdArrays = 2;                // a; dh, then g, then g kl
constexpr int kBwdSmem = kBwdArrays * kChunk * kStrip * sizeof(float);
constexpr int kBwdBlocksPerSm = 232448 / (kBwdSmem + 1024);

// what g_t multiplies at a position (rglru_scan.py, ``_grad_factors``): a,
// and the factors of dra, dia, dxc and dlam's summand
struct GradFactors {
  float a, kr, ki, kx, kl;
};

__device__ __forceinline__ GradFactors grad_factors(float ra, float ia,
                                                    float xc, float hp,
                                                    float ncs) {
  const GateParts q = gate_parts(ra, ia, ncs);
  const float gx = __fmul_rn(q.ig, xc);
  // d log a per unit of g: through a, and through beta where the clamp
  // passes it (its tie included, as torch.clamp_min's gradient)
  const float via_beta = __fsub_rn(1.f, q.e2) >= 1e-6f
                             ? __fdiv_rn(__fmul_rn(gx, q.e2), q.beta)
                             : 0.f;
  const float k1 = __fsub_rn(__fmul_rn(q.a, hp), via_beta);
  const float kl = __fmul_rn(k1, q.rg);
  const float kx = __fmul_rn(q.beta, q.ig);
  return {q.a, __fmul_rn(__fmul_rn(kl, ncs), __fsub_rn(1.f, q.rg)),
          __fmul_rn(__fmul_rn(kx, xc), __fsub_rn(1.f, q.ig)), kx, kl};
}

// a of a position: gate_parts's a, by its operations in its order
__device__ __forceinline__ float decay(float ra, float ncs) {
  const float rg = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-ra)));
  return expf(__fmul_rn(ncs, rg));
}

// ra, ia, xc and h_{t-1} of position t of a tile (h0 before position 0)
template <int V>
__device__ __forceinline__ void load_bwd_inputs(
    const float* ra, const float* ia, const float* xc, const float* hs,
    const float* h0_row, size_t row0, int t0, int t, int w, int ch, float* r,
    float* i, float* x, float* hp) {
  const size_t at = row0 + static_cast<size_t>(t) * w + ch;
  load_inputs<V>(ra, ia, xc, at, r, i, x);
  load_vec<V>(t0 + t > 0 ? hs + at - w : h0_row, hp);
}

// Barrier 1 of the backward's tile: warps 0-1 arrive once they have read
// the chunk's dh, and warps 2-3 wait for them before writing g over it
// (the unaligned form: a warp may reach it diverged)
__device__ __forceinline__ void dh_read_arrive() {
  asm volatile("barrier.arrive 1, %0;\n" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ void dh_read_wait() {
  asm volatile("barrier.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// The block's ticket and this call's tag (thread 0): the forward's scheme.
// The last block to take a ticket resets the ticket and advances the epoch
// for the next launch on the stream.
__device__ __forceinline__ void take_ticket(unsigned* ctrl, unsigned blocks,
                                            unsigned* tile, unsigned* tag) {
  const unsigned t = atomicAdd(&ctrl[0], 1u);
  const unsigned epoch = *reinterpret_cast<volatile unsigned*>(&ctrl[2]);
  __threadfence();
  if (atomicAdd(&ctrl[1], 1u) == blocks - 1) {
    __threadfence();
    ctrl[0] = 0;
    ctrl[1] = 0;
    ctrl[2] = epoch + 1;
  }
  *tile = t;
  *tag = 2u * epoch + 1u;
}

// One arrival at a strip's counter, a tagged 64-bit word (tag, count): a
// word of an earlier call (or of the scratch's other layout) carries
// another tag and counts as 0.  True for the n-th arrival of this call.
__device__ __forceinline__ bool last_arrival(unsigned long long* ctr,
                                             unsigned tag, unsigned n) {
  unsigned long long old = *reinterpret_cast<volatile unsigned long long*>(
      ctr);
  while (true) {
    const unsigned cnt =
        static_cast<unsigned>(old >> 32) == tag
            ? static_cast<unsigned>(old) + 1u
            : 1u;
    const unsigned long long prev =
        atomicCAS(ctr, old, (static_cast<unsigned long long>(tag) << 32) |
                                cnt);
    if (prev == old) return cnt == n;
    old = prev;
  }
}

// dlam of channel c: its n partials (row-major over (row, chunk)) summed
// in order, times -8 softplus'(lam) (1 above softplus's threshold)
__device__ __forceinline__ void reduce_dlam(const float* __restrict__ lam,
                                            const float* parts, float* dlam,
                                            int n, int w, int c) {
  float sum = 0.f;
#pragma unroll 8
  for (int p = 0; p < n; ++p)
    sum = __fadd_rn(sum, __ldcg(parts + static_cast<size_t>(p) * w + c));
  const float l = lam[c];
  const float dsp = l > 20.f ? 1.f : __fdiv_rn(1.f, __fadd_rn(1.f, expf(-l)));
  dlam[c] = __fmul_rn(__fmul_rn(-8.f, dsp), sum);
}

// S <= kChunk: a thread a (row, channel) runs the positions in reverse from
// g = 0, a block a (row, strip).  The last block of a strip sums its B
// partials of dlam.
__global__ void __launch_bounds__(kStrip)
rglru_bwd_short_kernel(const float* __restrict__ ra,
                       const float* __restrict__ ia,
                       const float* __restrict__ xc,
                       const float* __restrict__ lam,
                       const float* __restrict__ h0,
                       const float* __restrict__ hs,
                       const float* __restrict__ dhs, float* __restrict__ dra,
                       float* __restrict__ dia, float* __restrict__ dxc,
                       float* __restrict__ dlam, float* __restrict__ dh0,
                       unsigned* __restrict__ ctrl,
                       unsigned long long* __restrict__ ctrs,
                       float* __restrict__ parts, int seq, int w) {
  __shared__ unsigned s_tile, s_tag;
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  if (tid == 0) take_ticket(ctrl, gridDim.x * gridDim.y, &s_tile, &s_tag);
  __syncthreads();
  const int b = blockIdx.y;
  const int c = blockIdx.x * kStrip + tid;
  if (c < w) {
    const float ncs = neg_c_softplus(lam[c]);
    const size_t base = static_cast<size_t>(b) * seq * w + c;
    float u = 0.f, acc = 0.f;
    for (int t = seq - 1; t >= 0; --t) {
      const size_t at = base + static_cast<size_t>(t) * w;
      const float hp = t > 0 ? hs[at - w] : h0[static_cast<size_t>(b) * w + c];
      const GradFactors f = grad_factors(ra[at], ia[at], xc[at], hp, ncs);
      const float g = __fadd_rn(dhs[at], u);
      dra[at] = __fmul_rn(g, f.kr);
      dia[at] = __fmul_rn(g, f.ki);
      dxc[at] = __fmul_rn(g, f.kx);
      acc = __fadd_rn(acc, __fmul_rn(g, f.kl));
      u = __fmul_rn(f.a, g);
    }
    parts[static_cast<size_t>(b) * w + c] = acc;
    dh0[static_cast<size_t>(b) * w + c] = u;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) s_last = last_arrival(ctrs + blockIdx.x, s_tag, gridDim.y);
  __syncthreads();
  if (s_last) {
    __threadfence();
    if (c < w) reduce_dlam(lam, parts, dlam, gridDim.y, w, c);
  }
}

// S > kChunk: the forward's one pass turned round.  A block of 128 threads
// a tile (row, kStrip channels, chunk), from the ticket in reverse chunk
// order; shared memory holds a and dh alone (32 KB: six blocks an SM, so
// recurrentgemma-2b's 640 training tiles run in one wave):
//   1. the tile's a (decay) and dh into shared memory, 16-byte loads, the
//      next position's in flight while a position's a computes;
//   2. warps 0-1, a thread a channel: the chunk's (prod a, local u) from
//      u = 0 in reverse (u_t = a_t g_t, g_t = dh_t + u_{t+1}), published
//      for the earlier chunks as two tagged words (chunk 0's is never
//      read), then an arrival at barrier 1: the chunk's dh is read;
//   3. warps 2-3 meanwhile: the carry into the chunk, from u = 0 through
//      the pairs of every later chunk from the last, each polled through
//      L2 until its tag is this call's; then (barrier 1) the chunk in
//      reverse from it, g_t over dh_t, an add and a multiply a step; in
//      chunk 0, dh0 = u_0;
//   4. all four warps, the elements as in 1 (the first position's inputs
//      loaded before the scan): grad_factors from ra (again, from L2), ia,
//      xc and h_{t-1}, dra, dia and dxc stored 16 bytes at a time, g kl
//      over g;
//   5. a thread a channel: dlam's partial, the column of g kl summed in
//      reverse position order.
// Every gradient is the arithmetic of the six-array form in its order, so
// the bits are the same.  The last tile of a strip sums the
// strip's B x chunks partials in order.
template <int V>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
rglru_bwd_kernel(const float* __restrict__ ra, const float* __restrict__ ia,
                 const float* __restrict__ xc, const float* __restrict__ lam,
                 const float* __restrict__ h0, const float* __restrict__ hs,
                 const float* __restrict__ dhs, float* __restrict__ dra,
                 float* __restrict__ dia, float* __restrict__ dxc,
                 float* __restrict__ dlam, float* __restrict__ dh0,
                 unsigned* __restrict__ ctrl,
                 unsigned long long* __restrict__ words,
                 unsigned long long* __restrict__ ctrs,
                 float* __restrict__ parts, int batch, int seq, int w) {
  extern __shared__ float smem[];
  float* s_a = smem;
  float* s_g = smem + kChunk * kStrip;         // dh, then g, then g kl
  __shared__ unsigned s_tile, s_tag;
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  if (tid == 0) take_ticket(ctrl, gridDim.x, &s_tile, &s_tag);
  __syncthreads();
  const int strips = (w + kStrip - 1) / kStrip;
  const int chunks = (seq + kChunk - 1) / kChunk;
  const int per_chunk = batch * strips;
  const int tile = static_cast<int>(s_tile);
  const unsigned tag = s_tag;
  const int k = tile / per_chunk;
  const int chunk = chunks - 1 - k;
  const int b = (tile - k * per_chunk) / strips;
  const int strip = tile - k * per_chunk - b * strips;
  const int c0 = strip * kStrip;
  const int t0 = chunk * kChunk;
  const int len = min(kChunk, seq - t0);
  const size_t row0 = (static_cast<size_t>(b) * seq + t0) * w;

  // 1. a and dh of the tile
  constexpr int kCols = kStrip / V;
  constexpr int kRows = kThreads / kCols;
  const int col = tid % kCols;
  const int ch = c0 + col * V;
  const int t_first = tid / kCols;
  const float* h0_row = h0 + static_cast<size_t>(b) * w + ch;
  float ncs[V], r[V], i[V], x[V], hp[V];
  if (ch < w) {
#pragma unroll
    for (int v = 0; v < V; ++v) ncs[v] = neg_c_softplus(lam[ch + v]);
    float d[V];
    int t = t_first;
    if (t < len) {
      const size_t at = row0 + static_cast<size_t>(t) * w + ch;
      load_vec<V>(ra + at, r);
      load_vec<V>(dhs + at, d);
    }
    for (; t < len; t += kRows) {
      float rn[V], dn[V], a[V];
      if (t + kRows < len) {
        const size_t at = row0 + static_cast<size_t>(t + kRows) * w + ch;
        load_vec<V>(ra + at, rn);
        load_vec<V>(dhs + at, dn);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) a[v] = decay(r[v], ncs[v]);
      store_vec<V>(s_a + t * kStrip + col * V, a);
      store_vec<V>(s_g + t * kStrip + col * V, d);
#pragma unroll
      for (int v = 0; v < V; ++v) r[v] = rn[v], d[v] = dn[v];
    }
    // step 4's first position loads across the scan
    if (t_first < len)
      load_bwd_inputs<V>(ra, ia, xc, hs, h0_row, row0, t0, t_first, w, ch, r,
                         i, x, hp);
  }
  __syncthreads();

  const int lane = tid % kStrip;
  const int c = c0 + lane;
  if (tid < kStrip) {
    // 2. the chunk's (prod a, local u) from u = 0
    if (c < w && chunk > 0) {
      unsigned long long* col_words =
          words + 2 * (static_cast<size_t>(b) * (chunks - 1) * w + c);
      float prod = 1.f, u = 0.f;
#pragma unroll 16
      for (int t = len - 1; t >= 0; --t) {
        const float a = s_a[t * kStrip + lane];
        u = __fmul_rn(a, __fadd_rn(s_g[t * kStrip + lane], u));
        prod = __fmul_rn(prod, a);
      }
      store_pair(col_words + (chunk - 1) * 2 * static_cast<size_t>(w),
                 tagged(prod, tag), tagged(u, tag));
    }
    dh_read_arrive();
  } else {
    // 3. the carry from every later chunk, the last first, then g
    float u = 0.f;
    if (c < w) {
      // chunk j's pair (j >= 1) of this (row, channel)
      const unsigned long long* col_words =
          words + 2 * (static_cast<size_t>(b) * (chunks - 1) * w + c);
      const size_t chunk_words = 2 * static_cast<size_t>(w);
      for (int j0 = chunks - 1; j0 > chunk; j0 -= kBatch) {
        ulonglong2 p[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          if (j0 - q > chunk)
            p[q] = load_pair(col_words + (j0 - q - 1) * chunk_words);
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          if (j0 - q > chunk) {
            while (!ready(p[q], tag))
              p[q] = load_pair(col_words + (j0 - q - 1) * chunk_words);
            u = __fadd_rn(
                __fmul_rn(__uint_as_float(static_cast<unsigned>(p[q].x)), u),
                __uint_as_float(static_cast<unsigned>(p[q].y)));
          }
        }
      }
    }
    dh_read_wait();
    if (c < w) {
#pragma unroll 16
      for (int t = len - 1; t >= 0; --t) {
        const int at_s = t * kStrip + lane;
        const float g = __fadd_rn(s_g[at_s], u);
        s_g[at_s] = g;
        u = __fmul_rn(s_a[at_s], g);
      }
      if (chunk == 0) dh0[static_cast<size_t>(b) * w + c] = u;
    }
  }
  __syncthreads();

  // 4. every element's gradients from its g
  if (ch < w) {
    for (int t = t_first; t < len; t += kRows) {
      float rn[V], in[V], xn[V], hn[V];
      if (t + kRows < len)
        load_bwd_inputs<V>(ra, ia, xc, hs, h0_row, row0, t0, t + kRows, w,
                           ch, rn, in, xn, hn);
      float* g_at = s_g + t * kStrip + col * V;
      float g[V], dr[V], di[V], dx[V];
      load_vec<V>(g_at, g);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const GradFactors f = grad_factors(r[v], i[v], x[v], hp[v], ncs[v]);
        dr[v] = __fmul_rn(g[v], f.kr);
        di[v] = __fmul_rn(g[v], f.ki);
        dx[v] = __fmul_rn(g[v], f.kx);
        g[v] = __fmul_rn(g[v], f.kl);
        r[v] = rn[v], i[v] = in[v], x[v] = xn[v], hp[v] = hn[v];
      }
      const size_t at = row0 + static_cast<size_t>(t) * w + ch;
      store_vec<V>(dra + at, dr);
      store_vec<V>(dia + at, di);
      store_vec<V>(dxc + at, dx);
      store_vec<V>(g_at, g);
    }
  }
  __syncthreads();

  // 5. dlam's partial of the tile
  if (tid < kStrip && c < w) {
    float acc = 0.f;
#pragma unroll 16
    for (int t = len - 1; t >= 0; --t)
      acc = __fadd_rn(acc, s_g[t * kStrip + lane]);
    parts[(static_cast<size_t>(b) * chunks + chunk) * w + c] = acc;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0)
    s_last = last_arrival(ctrs + strip, tag,
                          static_cast<unsigned>(batch * chunks));
  __syncthreads();
  if (s_last) {
    __threadfence();
    if (tid < kStrip && c < w) reduce_dlam(lam, parts, dlam, batch * chunks,
                                           w, c);
  }
}

// the S > kChunk backward's shared memory: kBwdSmem of dynamic memory, the
// carveout at its largest so that kBwdBlocksPerSm tiles fit an SM
template <typename Kernel>
cudaError_t bwd_attributes(Kernel kernel) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// ra, ia, xc f32 [B, S, w]; lam f32 [w]; h0 f32 [B, w]; hs f32 [B, S, w];
// scratch: null when S <= 64, else 16 bytes of control words and a pair of
// 64-bit words a (row, chunk but the last, channel): 4 + 4 B (ceil(S / 64)
// - 1) w floats, zeroed when allocated and kept between calls on one
// stream.  Returns the launch's CUDA error, or 0.
extern "C" int rglru_scan_launch(const void* ra, const void* ia,
                                 const void* xc, const void* lam,
                                 const void* h0, void* hs, void* scratch,
                                 int batch, int seq, int w,
                                 void* stream_ptr) {
  const int chunks = (seq + kChunk - 1) / kChunk;
  if (batch <= 0 || seq <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* ra_ = static_cast<const float*>(ra);
  auto* ia_ = static_cast<const float*>(ia);
  auto* xc_ = static_cast<const float*>(xc);
  auto* lam_ = static_cast<const float*>(lam);
  auto* h0_ = static_cast<const float*>(h0);
  auto* hs_ = static_cast<float*>(hs);
  if (chunks == 1) {
    if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
    rglru_short_kernel<<<dim3((w + kShortThreads - 1) / kShortThreads,
                              batch),
                         kShortThreads, 0, stream>>>(ra_, ia_, xc_, lam_, h0_,
                                                     hs_, seq, w);
    return static_cast<int>(cudaGetLastError());
  }
  const long long tiles = static_cast<long long>(batch) *
                          ((w + kStrip - 1) / kStrip) * chunks;
  if (scratch == nullptr || tiles >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* ctrl = static_cast<unsigned*>(scratch);
  auto* words = reinterpret_cast<unsigned long long*>(ctrl + 4);
  const bool vec = w % 4 == 0 && aligned16(ra) && aligned16(ia) &&
                   aligned16(xc);
  auto kernel = vec ? rglru_scan_kernel<4> : rglru_scan_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(tiles), kThreads, kSmem, stream>>>(
      ra_, ia_, xc_, lam_, h0_, hs_, ctrl, words, batch, seq, w);
  return static_cast<int>(cudaGetLastError());
}


// The backward.  ra, ia, xc, h (the forward's output) and dh f32
// [B, S, w]; lam f32 [w]; h0 f32 [B, w]; dra, dia, dxc f32 [B, S, w],
// dlam f32 [w] and dh0 f32 [B, w] written.  scratch: 16 bytes of control
// words, a pair of tagged 64-bit words a (row, chunk but the first,
// channel), then a tagged 64-bit counter a strip of 64 channels: 4 +
// 4 B (ceil(S / 64) - 1) w + 2 ceil(w / 64) floats, zeroed when allocated
// and kept between calls on one stream; parts: B ceil(S / 64) w floats,
// dlam's per-tile partials.  Returns the launch's CUDA error, or 0.
extern "C" int rglru_scan_bwd_launch(
    const void* ra, const void* ia, const void* xc, const void* lam,
    const void* h0, const void* hs, const void* dhs, void* dra, void* dia,
    void* dxc, void* dlam, void* dh0, void* scratch, void* parts, int batch,
    int seq, int w, void* stream_ptr) {
  if (batch <= 0 || seq <= 0 || w <= 0 || scratch == nullptr ||
      parts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (seq + kChunk - 1) / kChunk;
  const int strips = (w + kStrip - 1) / kStrip;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* ctrl = static_cast<unsigned*>(scratch);
  auto* words = reinterpret_cast<unsigned long long*>(ctrl + 4);
  auto* ctrs = words + 2 * static_cast<size_t>(batch) * (chunks - 1) * w;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (chunks == 1) {
    if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
    rglru_bwd_short_kernel<<<dim3(strips, batch), kStrip, 0, stream>>>(
        f(ra), f(ia), f(xc), f(lam), f(h0), f(hs), f(dhs), o(dra), o(dia),
        o(dxc), o(dlam), o(dh0), ctrl, ctrs, o(parts), seq, w);
    return static_cast<int>(cudaGetLastError());
  }
  const long long tiles = static_cast<long long>(batch) * strips * chunks;
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = w % 4 == 0 && aligned16(ra) && aligned16(ia) &&
                   aligned16(xc) && aligned16(hs) && aligned16(dhs) &&
                   aligned16(h0) && aligned16(dra) && aligned16(dia) &&
                   aligned16(dxc);
  auto kernel = vec ? rglru_bwd_kernel<4> : rglru_bwd_kernel<1>;
  cudaError_t err = bwd_attributes(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(tiles), kThreads, kBwdSmem, stream>>>(
      f(ra), f(ia), f(xc), f(lam), f(h0), f(hs), f(dhs), o(dra), o(dia),
      o(dxc), o(dlam), o(dh0), ctrl, words, ctrs, o(parts), batch, seq, w);
  return static_cast<int>(cudaGetLastError());
}

// The tiles of the S > 64 backward (vec: its 16-byte form) that one SM
// holds at once, as the card computes them from the kernel's registers
// and shared memory; -1 on a CUDA error.
extern "C" int rglru_scan_bwd_blocks_per_sm(int vec) {
  auto kernel = vec ? rglru_bwd_kernel<4> : rglru_bwd_kernel<1>;
  int n = 0;
  if (bwd_attributes(kernel) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                    kBwdSmem) != cudaSuccess)
    return -1;
  return n;
}
