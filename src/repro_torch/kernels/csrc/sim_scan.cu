// The hybrid-memory simulator's period scan over a candidate set, for Hopper.
//
// Replaces the TPU kernel repro/kernels/sim_step.py::sim_scan (Pallas body
// `_kernel`), itself the fused form of core/sim.py::_scan_one.  The TPU kernel
// walks a sequential (candidate, period) grid with the carry in VMEM and picks
// the fast set with an O(n^2) compare matrix, which caps it near 1.5k pages.
//
// What bounds it: neither bytes nor flops but a serial chain.  A candidate's
// periods run one after another (each period's placement decides the next
// period's scores), so a launch takes (its longest candidate's periods) x
// (one period's latency); the bytes (each period row read once) would take
// well under 1% of that.  A period's latency is its barriers and the
// dependent steps between them, and the instructions every thread issues
// (the SM runs one candidate, so the per-thread work of a block's warps
// shares four schedulers).  The design shortens that chain so:
//
//   * One CTA per candidate, and every candidate of a sweep in one launch:
//     candidate c reads rows [row_start[c], row_start[c] + num_reals[c]) of
//     one [R, n] array (a stack [C, P, n] passes c * P).
//   * Thread t owns the contiguous run of pages [t * PER, t * PER + PER),
//     so page order is (thread, position in run) -- the order the tie
//     ranking needs.  Up to 4096 pages: runs of 8 (one warp with runs of
//     1-8 up to 256 pages), each thread keeping its pages' hotness, last
//     access, placement, keys and counts in registers across periods.
//     Fewer, longer runs than one page a thread: what every warp does once
//     a pass (the scan below) costs issue slots in proportion to the warps
//     (on an H100 at 4096 pages, runs of 8 at 512 threads ran a period
//     faster than runs of 4 at 1024 threads or of 16 and 32 at 256 and
//     128).  Beyond 4096 pages: 512 threads (128
//     registers each) with runs of 16 or 32, which keep hotness, last
//     access and keys in shared memory laid out [position][thread] (no
//     bank conflicts).
//   * The next period's counts are loaded into a register double buffer
//     while this period runs (each count read once).  Runs of 32 read them
//     from device memory where they are used instead, after a prefetch into
//     L2 a period ahead.
//   * The fast set is an exact radix select.  Every key adds one to a
//     shared 256-bin histogram of its next 8 bits (an atomicAdd that the
//     hardware merges across a warp's lanes on one address; keys out of
//     play add to a dummy bin a lane), one barrier, then EVERY warp scans
//     the histogram itself (two 16-byte loads a lane, a shuffle scan, a
//     branch-free search), so no second barrier broadcasts the digit.
//     Three histograms rotate, so the one two passes ahead is cleared in
//     the shadow of this one.  The select stops as soon as the threshold's
//     bin holds exactly the keys still to take.
//   * The threshold's top 16 bits rarely change from one period to the
//     next on the simulator's traces, so the first pass histograms bits
//     15..8 of the keys that share the previous threshold's top 16 bits and
//     counts the keys above them; when the threshold lies in that group
//     (checked exactly from the counts), one more pass finds it: 2 passes
//     instead of 4.  Otherwise the select starts over from the top byte.
//   * Keys equal to the threshold are taken in page order: ballots a run
//     position rank them inside the warp, and the last byte's pass also
//     counts each warp's keys by byte in a row of its own, which ranks
//     them across warps with no further barrier.  So a period has 2
//     barriers when the guess holds (at most 5).
//   * The period's sums (total, fast hits, swaps) are reduced per warp and
//     across warps one period later, by warp 0 after the next period's
//     first barrier, where thread 0 adds the period's runtime.  Per-period
//     sums over pages are exact integers below 2**24 (the simulator feeds
//     integer counts), so their order does not matter; it is fixed anyway.
//   * The arithmetic is core/sim.py::_scan_one's float32 expressions in the
//     same order.  Where XLA fuses a multiply and an add when it compiles
//     the reference for the CPU (x*y + z -> fma(x, y, z), x*y + z*w ->
//     fma(x, y, z*w): the score, the bandwidth term, the latency and the
//     adds of the bandwidth and migration terms to it, the EMA) the kernel
//     calls __fmaf_rn; everywhere else it rounds after every operation
//     (__f*_rn and the build's -fmad=false), so its bits equal the plain
//     PyTorch version's.  The recency's division is IEEE division computed
//     without a branch (`div_by`).  Runtime, swaps and hits accumulate in
//     float32 one period after another, as the TPU kernel's acc_scr does.
//
// Left for later: splitting one candidate's pages over a thread-block
// cluster (a cluster barrier per pass costs a round trip between SMs, so it
// pays only where per-page work dominates), and batching the Cori tuner's
// one-candidate `simulate` calls into shared launches.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// a histogram: 256 bins, the count of keys above the group (bin 256), a
// dummy bin a lane for keys out of play; rows 16-byte aligned
constexpr int kAbove = 256;
constexpr int kHistW = 292;

struct Costs {
  float lat_fast, lat_slow, bw_slow, bw_penalty, mig_cost, period_overhead,
      alpha, one_minus_alpha;
};

// Order-preserving map float -> uint32 (larger float, larger key).  -0 is
// folded into +0 first: the plain version's sort ties them (lax.top_k
// would rank +0 higher; the simulator's scores are never -0).
__device__ __forceinline__ uint32_t order_key(float s) {
  const uint32_t b = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// A load of the next period's counts, issued where it stands (a volatile
// asm is not sunk to its first use, which is a period later).
__device__ __forceinline__ float load_count(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// a / d rounded to nearest (IEEE division) for 0 <= a < d <= 2**24, given
// y = RN(1/d): a first quotient, then two corrections by the exact residual
// (Markstein: a faithful quotient corrected once with a correctly rounded
// reciprocal is the correctly rounded quotient).  No branch, unlike
// __fdiv_rn's range check; tests/test_torch_sim.py holds it to IEEE
// division over the simulator's range.
__device__ __forceinline__ float div_by(float a, float d, float y) {
  const float q0 = __fmul_rn(a, y);
  const float q1 = __fmaf_rn(__fmaf_rn(-d, q0, a), y, q0);
  return __fmaf_rn(__fmaf_rn(-d, q1, a), y, q1);
}

// One period's runtime from its sums over pages (total accesses t, fast
// hits f, swaps s), added to the running sums.
__device__ __forceinline__ void add_period(const Costs& k, float t, float f,
                                           float s, float& acc_rt,
                                           float& acc_sw, float& acc_fh) {
  const float n_slow = __fsub_rn(t, f);
  const float latency =
      __fmaf_rn(f, k.lat_fast, __fmul_rn(n_slow, k.lat_slow));
  const float over = fmaxf(0.0f, __fmaf_rn(t, -k.bw_slow, n_slow));
  // latency + over*bw_penalty + swaps*mig_cost + period_overhead
  const float period_rt = __fadd_rn(
      __fmaf_rn(s, k.mig_cost, __fmaf_rn(over, k.bw_penalty, latency)),
      k.period_overhead);
  acc_rt = __fadd_rn(acc_rt, period_rt);
  acc_sw = __fadd_rn(acc_sw, s);
  acc_fh = __fadd_rn(acc_fh, f);
}

// PER values of one kind per thread: in registers, or in shared memory at
// [position][thread] (consecutive threads, consecutive banks).
template <typename T, int NT, int PER, bool SMEM>
struct Run {
  T reg[SMEM ? 1 : PER];
  T* sm;
  __device__ __forceinline__ T& operator[](int j) {
    if constexpr (SMEM) {
      return sm[j * NT];
    } else {
      return reg[j];
    }
  }
};

// Where an instance keeps its pages' state.  Up to 4096 pages, runs of 8
// keep everything in registers.  Beyond, runs of 16 and 32 at 512 threads
// (128 registers a thread) keep hotness, last access and keys in shared
// memory; runs of 32 (kDirect) read the counts from device memory where
// they are used, prefetched into L2 a period ahead instead of into
// registers.
template <int NT, int PER>
struct Layout {
  static constexpr bool kSmem = NT * PER > 4096;
  static constexpr bool kDirect = NT * PER > 8192;
  static constexpr int kSmemWords = kSmem ? 3 * PER * NT : 0;
};

// Where the `want`-th largest key in play falls in a histogram.
struct Digit {
  unsigned digit, rest, in_bin;   // its bin, its rank there, the bin's count
  bool hit;                       // false: not among the histogram's keys
};

// One radix pass over the keys whose `known` bits equal `prefix`: each adds
// one to the bin of its 8 bits at `shift` (with ABOVE, keys whose known bits
// exceed `prefix` add one to bin kAbove); one barrier; then every warp finds
// the bin of the want-th largest key (counting the keys above first).  The
// last byte's pass (FINAL) also counts each warp's keys by bin in the
// warp's own row of `whist`, so the ties at the threshold can be ranked
// across warps without another barrier.
template <int NT, int PER, bool ABOVE, bool FINAL, class Keys>
__device__ __forceinline__ Digit radix_pass(Keys& key, unsigned valid,
                                            int shift, uint32_t prefix,
                                            uint32_t known, int want,
                                            unsigned int (*hist)[kHistW],
                                            unsigned int* whist, int& hq,
                                            int tid, int lane) {
  unsigned int* h = hist[hq];
  if (FINAL) {
    // this warp's row: every warp read it after the previous last-byte
    // pass, before a barrier that this warp has passed since
    for (int b = lane; b < 256; b += 32) whist[b] = 0u;
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const uint32_t mk = key[j] & known;
    const bool v = (valid >> j) & 1u;
    const unsigned bin = (v && mk == prefix) ? (key[j] >> shift) & 255u
                         : (ABOVE && v && mk > prefix) ? kAbove
                                                      : kAbove + 1 + lane;
    atomicAdd(&h[bin], 1u);
    if (FINAL) atomicAdd(&whist[bin], 1u);
  }
  // the histogram two passes ahead: every warp read it before the barrier
  // that preceded this pass
  const int hn = hq == 2 ? 0 : hq + 1;
  for (int b = tid; b <= kAbove; b += NT) hist[hn][b] = 0u;
  __syncthreads();
  hq = hn;

  // lane l holds bins 255-8l down to 248-8l
  const uint4 lo = *reinterpret_cast<const uint4*>(&h[248 - 8 * lane]);
  const uint4 hi = *reinterpret_cast<const uint4*>(&h[252 - 8 * lane]);
  const unsigned cnt[8] = {hi.w, hi.z, hi.y, hi.x, lo.w, lo.z, lo.y, lo.x};
  const int w = ABOVE ? want - static_cast<int>(h[kAbove]) : want;
  unsigned own = 0u;
#pragma unroll
  for (int b = 0; b < 8; ++b) own += cnt[b];
  unsigned incl = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  const unsigned excl = incl - own;
  const unsigned u = static_cast<unsigned>(w);
  const bool mine = w > 0 && excl < u && u <= incl;
  // every lane finds where want falls in its own 8 bins (branch-free; only
  // the crossing lane's answer is used): `d` bins lie wholly above it,
  // `above` keys in them and the lanes before
  unsigned above = excl, d = 0u, in_bin = 0u;
  bool found = false;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned next = above + cnt[b];
    const bool past = !found && next < u;
    in_bin = (!found && !past) ? cnt[b] : in_bin;
    found = found || !past;
    above = past ? next : above;
    d += past;
  }
  const unsigned ball = __ballot_sync(kFull, mine);
  const int src = ball ? __ffs(ball) - 1 : 0;
  // digit (8 bits) and rest (< 2**16) travel in one shuffle
  const unsigned packed = __shfl_sync(
      kFull, (255u - 8u * lane - d) | ((u - above) << 8), src);
  return Digit{packed & 255u, packed >> 8, __shfl_sync(kFull, in_bin, src),
               ball != 0u};
}

template <int NT, int PER>
__global__ void __launch_bounds__(NT, 1)
sim_scan_kernel(const float* __restrict__ hists,
                const long long* __restrict__ row_start,
                const int* __restrict__ num_reals, int max_periods,
                const uint8_t* __restrict__ init_fast,
                float* __restrict__ rt_out, float* __restrict__ sw_out,
                float* __restrict__ fh_out, int n, int capacity,
                int predictive, Costs k) {
  using L = Layout<NT, PER>;
  constexpr int kWarps = NT / 32;
  extern __shared__ float smem[];
  __shared__ __align__(16) unsigned int hist[3][kHistW];
  __shared__ float red[2][3][kWarps];   // per-warp period sums, by parity
  // per warp, its keys' counts by last byte in the last-byte pass
  __shared__ __align__(16) unsigned int whist[kWarps][kHistW];

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = tid * PER;           // first page of this thread's run

  Run<float, NT, PER, L::kSmem> hot, last;
  Run<uint32_t, NT, PER, L::kSmem> key;
  hot.sm = smem + tid;
  last.sm = smem + PER * NT + tid;
  key.sm = reinterpret_cast<uint32_t*>(smem) + 2 * PER * NT + tid;

  unsigned valid = 0u, fast = 0u;       // bit j: page base + j
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const bool v = base + j < n;
    valid |= static_cast<unsigned>(v) << j;
    fast |= static_cast<unsigned>(v && init_fast[base + j] != 0) << j;
    hot[j] = 0.0f;
    last[j] = -1.0f;
    key[j] = 0u;
  }
  for (int b = tid; b < 3 * kHistW; b += NT) (&hist[0][0])[b] = 0u;

  const int nr = min(num_reals[c], max_periods);
  const long long row0 =
      row_start ? row_start[c] : static_cast<long long>(c) * max_periods;
  const float* cand = hists + row0 * n + base;
  constexpr int kBuf = L::kDirect ? 1 : PER;
  float cur[kBuf], nxt[kBuf];
#pragma unroll
  for (int j = 0; j < kBuf; ++j) {
    cur[j] = (nr > 0 && ((valid >> j) & 1u)) ? cand[j] : 0.0f;
    nxt[j] = 0.0f;
  }
  // this period's count of page base + j (0 past n)
  const float* row = cand;
  auto count = [&](int j) -> float {
    if constexpr (L::kDirect) {
      return ((valid >> j) & 1u) ? __ldg(row + j) : 0.0f;
    } else {
      return cur[j];
    }
  };
  float acc_rt = 0.0f, acc_sw = 0.0f, acc_fh = 0.0f;   // thread 0's
  int hq = 0;                  // the histogram the next pass fills
  uint32_t guess = 0u;         // the previous threshold's top 16 bits
  __syncthreads();

  for (int i = 0; i < nr; ++i) {
    // the next period's counts, in flight while this one runs
    row = cand + static_cast<long long>(i) * n;
    if (i + 1 < nr && valid) {
      const float* next = row + n;
      if constexpr (L::kDirect) {
        // the run's first and last page's lines (a run spans at most two)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(next));
        asm volatile("prefetch.global.L2 [%0];" ::"l"(
            next + min(PER, n - base) - 1));
      } else {
#pragma unroll
        for (int j = 0; j < PER; ++j)
          if ((valid >> j) & 1u) nxt[j] = load_count(next + j);
      }
    }

    // --- scheduler decision at period start ------------------------------
    const float denom = __fadd_rn(static_cast<float>(i), 2.0f);
    const float inv = __frcp_rn(denom);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const float rank = predictive ? count(j) : hot[j];
      const float recency = div_by(__fadd_rn(last[j], 1.0f), denom, inv);
      const float score = __fadd_rn(__fmaf_rn(rank, 1e6f, recency),
                                    ((fast >> j) & 1u) ? 0.5f : 0.0f);
      key[j] = order_key(score);
    }

    // the select: the capacity-th largest key's bits, `prefix` on the
    // `known` bits; `remaining` keys equal to it there are still to take;
    // `all_in`: exactly that many share them
    uint32_t prefix = guess, known = 0xffff0000u;
    int remaining = capacity;
    bool all_in = false;
    Digit g = radix_pass<NT, PER, true, false>(
        key, valid, 8, prefix, known, capacity, hist, whist[warp], hq, tid,
        lane);
    if (warp == 0) {
      // the previous period's sums, whose per-warp partials were all
      // written before this barrier; thread 0 adds its runtime
      const int par = (i + 1) & 1;
      float t = lane < kWarps ? red[par][0][lane] : 0.0f;
      float f = lane < kWarps ? red[par][1][lane] : 0.0f;
      float s = lane < kWarps ? red[par][2][lane] : 0.0f;
#pragma unroll
      for (int off = 1; off < kWarps; off <<= 1) {
        t = __fadd_rn(t, __shfl_xor_sync(kFull, t, off));
        f = __fadd_rn(f, __shfl_xor_sync(kFull, f, off));
        s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
      }
      if (i > 0 && lane == 0) add_period(k, t, f, s, acc_rt, acc_sw, acc_fh);
    }
    if (g.hit) {                        // the same in every thread
      prefix |= g.digit << 8;
      known = 0xffffff00u;
      remaining = static_cast<int>(g.rest);
      all_in = g.in_bin == g.rest;
      if (!all_in) {
        const Digit d = radix_pass<NT, PER, false, true>(
            key, valid, 0, prefix, known, remaining, hist, whist[warp], hq,
            tid, lane);
        prefix |= d.digit;
        known = kFull;
        remaining = static_cast<int>(d.rest);
        all_in = d.in_bin == d.rest;
      }
    } else {
      // from the top byte, 8 bits a pass
      prefix = 0u;
      known = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int shift = 24 - 8 * q;
        const Digit d =
            q < 3 ? radix_pass<NT, PER, false, false>(
                        key, valid, shift, prefix, known, remaining, hist,
                        whist[warp], hq, tid, lane)
                  : radix_pass<NT, PER, false, true>(
                        key, valid, shift, prefix, known, remaining, hist,
                        whist[warp], hq, tid, lane);
        prefix |= d.digit << shift;
        known |= 255u << shift;
        remaining = static_cast<int>(d.rest);
        if (d.in_bin == d.rest) {
          all_in = true;
          break;
        }
      }
    }
    guess = prefix & 0xffff0000u;

    // rank the keys equal to the threshold in page order: ballots a run
    // position rank them inside the warp, the last-byte pass's per-warp
    // counts of the threshold's byte across warps (no barrier)
    int tie_rank = 0;
    if (!all_in) {
      const unsigned lt = (1u << lane) - 1u;
      int below = 0;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const bool t = ((valid >> j) & 1u) && key[j] == prefix;
        below += __popc(__ballot_sync(kFull, t) & lt);
      }
      const int w = lane < kWarps ? whist[lane][prefix & 255u] : 0;
      tie_rank = __reduce_add_sync(kFull, lane < warp ? w : 0) + below;
    }

    // --- placement, this period's accesses, post-period state -------------
    float total = 0.0f, n_fast = 0.0f;
    const float fi = static_cast<float>(i);
    unsigned new_fast = 0u;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      // branch-free: a page past n has no key in play and counts 0, and
      // adding +0 to these non-negative sums changes no bit
      const bool v = (valid >> j) & 1u;
      const uint32_t mk = key[j] & known;
      const bool tie = v && mk == prefix;
      const bool in = v && (mk > prefix ||
                            (tie && (all_in || tie_rank < remaining)));
      tie_rank += tie;
      const float cnt_j = count(j);
      total = __fadd_rn(total, cnt_j);
      n_fast = __fadd_rn(n_fast, in ? cnt_j : 0.0f);
      hot[j] = __fmaf_rn(k.alpha, cnt_j, __fmul_rn(k.one_minus_alpha,
                                                   hot[j]));
      last[j] = cnt_j > 0.0f ? fi : last[j];
      new_fast |= static_cast<unsigned>(in) << j;
    }
    float swaps = static_cast<float>(__popc(new_fast & ~fast));
    fast = new_fast;
#pragma unroll
    for (int j = 0; j < kBuf; ++j) cur[j] = nxt[j];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      total = __fadd_rn(total, __shfl_xor_sync(kFull, total, off));
      n_fast = __fadd_rn(n_fast, __shfl_xor_sync(kFull, n_fast, off));
      swaps = __fadd_rn(swaps, __shfl_xor_sync(kFull, swaps, off));
    }
    if (lane == 0) {
      red[i & 1][0][warp] = total;
      red[i & 1][1][warp] = n_fast;
      red[i & 1][2][warp] = swaps;
    }
  }

  // the last period's sums
  __syncthreads();
  if (warp == 0 && nr > 0) {
    const int par = (nr - 1) & 1;
    float t = lane < kWarps ? red[par][0][lane] : 0.0f;
    float f = lane < kWarps ? red[par][1][lane] : 0.0f;
    float s = lane < kWarps ? red[par][2][lane] : 0.0f;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      t = __fadd_rn(t, __shfl_xor_sync(kFull, t, off));
      f = __fadd_rn(f, __shfl_xor_sync(kFull, f, off));
      s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
    }
    if (lane == 0) add_period(k, t, f, s, acc_rt, acc_sw, acc_fh);
  }
  if (tid == 0) {
    rt_out[c] = acc_rt;
    sw_out[c] = acc_sw;
    fh_out[c] = acc_fh;
  }
}

template <int NT, int PER>
int launch(const float* hists, const long long* row_start,
           const int* num_reals, int max_periods, const uint8_t* init_fast,
           float* rt, float* sw, float* fh, int n_cand, int n, int capacity,
           int predictive, const Costs& k, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(Layout<NT, PER>::kSmemWords) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sim_scan_kernel<NT, PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sim_scan_kernel<NT, PER><<<n_cand, NT, smem, stream>>>(
      hists, row_start, num_reals, max_periods, init_fast, rt, sw, fh, n,
      capacity, predictive, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Candidate c scans rows [row0, row0 + min(num_reals[c], max_periods)) of
// hists [R, n], with row0 = row_start[c], or c * max_periods when row_start
// is null (a [C, max_periods, n] stack).  The instance: one warp with runs
// of 1-8 pages up to 256 pages, runs of 8 up to 4096, then 512 threads with
// runs of 16 and 32.
extern "C" int sim_scan_launch(const void* hists, const void* row_start,
                               const void* num_reals, int max_periods,
                               const void* init_fast, void* rt, void* sw,
                               void* fh, int n_cand, int n, int capacity,
                               int predictive, float lat_fast,
                               float lat_slow, float bw_slow, float bw_penalty,
                               float mig_cost, float period_overhead,
                               float alpha, float one_minus_alpha,
                               void* stream) {
  const Costs k{lat_fast, lat_slow,        bw_slow, bw_penalty,
                mig_cost, period_overhead, alpha,   one_minus_alpha};
  const auto* h = static_cast<const float*>(hists);
  const auto* rs = static_cast<const long long*>(row_start);
  const auto* nr = static_cast<const int*>(num_reals);
  const auto* init = static_cast<const uint8_t*>(init_fast);
  auto* r = static_cast<float*>(rt);
  auto* s = static_cast<float*>(sw);
  auto* f = static_cast<float*>(fh);
  auto st = static_cast<cudaStream_t>(stream);
#define SIM_SCAN_LAUNCH(NT, PER)                                              \
  return launch<NT, PER>(h, rs, nr, max_periods, init, r, s, f, n_cand, n, \
                         capacity, predictive, k, st)
  if (n <= 32) SIM_SCAN_LAUNCH(32, 1);
  if (n <= 64) SIM_SCAN_LAUNCH(32, 2);
  if (n <= 128) SIM_SCAN_LAUNCH(32, 4);
  if (n <= 256) SIM_SCAN_LAUNCH(32, 8);
  if (n <= 512) SIM_SCAN_LAUNCH(64, 8);
  if (n <= 1024) SIM_SCAN_LAUNCH(128, 8);
  if (n <= 2048) SIM_SCAN_LAUNCH(256, 8);
  if (n <= 4096) SIM_SCAN_LAUNCH(512, 8);
  if (n <= 8192) SIM_SCAN_LAUNCH(512, 16);
  if (n <= 16384) SIM_SCAN_LAUNCH(512, 32);
#undef SIM_SCAN_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
