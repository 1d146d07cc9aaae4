// The hybrid-memory simulator's period scan over a candidate stack, for Hopper.
//
// Replaces the TPU kernel repro/kernels/sim_step.py::sim_scan (Pallas body
// `_kernel`), itself the fused form of core/sim.py::_scan_one.  The TPU kernel
// walks a sequential (candidate, period) grid with the carry in VMEM and picks
// the fast set with an O(n^2) compare matrix, which caps it near 1.5k pages.
// Here:
//
//   * One CTA per candidate; the CTA loops over its own periods and stops at
//     num_reals[c] (padded periods would change nothing).  Blocks run in
//     parallel, so no carry crosses blocks.
//   * The carry lives in shared memory: placement (1 byte), hotness EMA and
//     last access (float32) per page, plus the 32-bit selection key, 13 bytes
//     a page (53 KB at 4096 pages; the wrapper allows up to MAX_PAGES).
//   * Selection of the top-`capacity` pages is a shared-memory radix select
//     written here: the score is mapped to an order-preserving 32-bit key,
//     four 8-bit passes find the capacity-th largest key T, and pages with
//     key == T are taken in ascending page order until the count is met (a
//     block-wide scan ranks them).  That is lax.top_k's membership exactly:
//     score descending, then index ascending.
//   * The arithmetic is core/sim.py::_scan_one's float32 expressions in the
//     same order.  Where XLA fuses a multiply and an add when it compiles
//     the reference for the CPU (x*y + z -> fma(x, y, z), x*y + z*w ->
//     fma(x, y, z*w): the score, the bandwidth term, the latency and the
//     adds of the bandwidth and migration terms to it, the EMA) the kernel
//     calls __fmaf_rn; everywhere else
//     it rounds after every operation (__f*_rn and the build's -fmad=false),
//     so its bits equal the plain PyTorch version's.  Runtime, swaps and
//     hits accumulate in float32 one period after another, as the TPU
//     kernel's acc_scr does.  Per-period sums over pages are exact (and so
//     independent of their order) for integer counts below 2**24, which is
//     what the simulator feeds.
//
// What bounds it on an H100: neither bytes nor flops but the serial period
// loop: a candidate's periods run one after another on one SM, each a chain
// of block barriers.  The longest candidate sets the launch's time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Costs {
  float lat_fast, lat_slow, bw_slow, bw_penalty, mig_cost, period_overhead,
      alpha, one_minus_alpha;
};

// Order-preserving map float -> uint32 (larger float, larger key).  -0 is
// folded into +0 first: the reference ranks by comparisons, where they tie.
__device__ __forceinline__ uint32_t order_key(float s) {
  const uint32_t b = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
sim_scan_kernel(const float* __restrict__ hists,
                const int* __restrict__ num_reals,
                const uint8_t* __restrict__ init_fast,
                float* __restrict__ rt_out, float* __restrict__ sw_out,
                float* __restrict__ fh_out, int n_periods, int n,
                int capacity, int predictive, Costs k) {
  extern __shared__ float smem[];
  float* hot = smem;                                     // [n] hotness EMA
  float* last = hot + n;                                 // [n] last access
  uint32_t* keys = reinterpret_cast<uint32_t*>(last + n);  // [n]
  uint8_t* fast = reinterpret_cast<uint8_t*>(keys + n);    // [n] placement
  __shared__ unsigned int hist[256];
  __shared__ float red[3][kWarps];
  __shared__ int scan[kWarps];
  __shared__ uint32_t s_prefix;
  __shared__ int s_remaining;

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // each thread owns a contiguous run of pages, so page order is
  // (thread, position in run) -- what the tie ranking needs
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, tid * per);
  const int hi = min(n, lo + per);

  for (int p = lo; p < hi; ++p) {
    hot[p] = 0.0f;
    last[p] = -1.0f;
    fast[p] = init_fast[p] ? 1 : 0;
  }
  const int nr = min(num_reals[c], n_periods);
  const float* cand = hists + static_cast<size_t>(c) * n_periods * n;
  float acc_rt = 0.0f, acc_sw = 0.0f, acc_fh = 0.0f;   // thread 0's
  __syncthreads();

  for (int i = 0; i < nr; ++i) {
    const float* counts = cand + static_cast<size_t>(i) * n;
    const float denom = __fadd_rn(static_cast<float>(i), 2.0f);

    // --- scheduler decision at period start ------------------------------
    for (int p = lo; p < hi; ++p) {
      const float rank = predictive ? counts[p] : hot[p];
      const float recency = __fdiv_rn(__fadd_rn(last[p], 1.0f), denom);
      const float score = __fadd_rn(__fmaf_rn(rank, 1e6f, recency),
                                    fast[p] ? 0.5f : 0.0f);
      keys[p] = order_key(score);
    }
    // radix select: the capacity-th largest key, 8 bits at a time from the
    // top; `remaining` counts how many keys equal to the prefix to still take
    uint32_t prefix = 0u, known = 0u;
    int remaining = capacity;
    for (int shift = 24; shift >= 0; shift -= 8) {
      if (tid < 256) hist[tid] = 0u;
      __syncthreads();
      for (int p = lo; p < hi; ++p) {
        const uint32_t key = keys[p];
        if ((key & known) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
      }
      __syncthreads();
      if (warp == 0) {
        // lane l holds bins 255-8l down to 248-8l; scan from the top
        unsigned int cnt[8];
        unsigned int own = 0u;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          cnt[b] = hist[255 - 8 * lane - b];
          own += cnt[b];
        }
        unsigned int incl = own;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned int t = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += t;
        }
        const unsigned int excl = incl - own;
        const unsigned int want = static_cast<unsigned int>(remaining);
        if (excl < want && want <= incl) {
          unsigned int above = excl;
          int digit = 0;
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            if (above + cnt[b] >= want) {
              digit = 255 - 8 * lane - b;
              break;
            }
            above += cnt[b];
          }
          s_prefix = prefix | (static_cast<uint32_t>(digit) << shift);
          s_remaining = static_cast<int>(want - above);
        }
      }
      __syncthreads();
      prefix = s_prefix;
      remaining = s_remaining;
      known |= 255u << shift;
    }
    const uint32_t thr = prefix;   // keys > thr are in; `remaining` of == thr

    // rank the ties in page order: exclusive scan of per-thread tie counts
    int ties = 0;
    for (int p = lo; p < hi; ++p) ties += keys[p] == thr;
    int incl = ties;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) scan[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = scan[lane];
      int wi = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, wi, off);
        if (lane >= off) wi += t;
      }
      scan[lane] = wi - w;
    }
    __syncthreads();
    int tie_rank = scan[warp] + incl - ties;

    // --- placement, this period's accesses, post-period state -------------
    float total = 0.0f, n_fast = 0.0f, swaps = 0.0f;
    const float fi = static_cast<float>(i);
    for (int p = lo; p < hi; ++p) {
      const uint32_t key = keys[p];
      bool in = key > thr;
      if (key == thr) {
        in = tie_rank < remaining;
        ++tie_rank;
      }
      const float cnt = counts[p];
      total = __fadd_rn(total, cnt);
      if (in) n_fast = __fadd_rn(n_fast, cnt);
      if (in && !fast[p]) swaps = __fadd_rn(swaps, 1.0f);
      hot[p] = __fmaf_rn(k.alpha, cnt, __fmul_rn(k.one_minus_alpha, hot[p]));
      if (cnt > 0.0f) last[p] = fi;
      fast[p] = in ? 1 : 0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      total = __fadd_rn(total, __shfl_down_sync(kFull, total, off));
      n_fast = __fadd_rn(n_fast, __shfl_down_sync(kFull, n_fast, off));
      swaps = __fadd_rn(swaps, __shfl_down_sync(kFull, swaps, off));
    }
    if (lane == 0) {
      red[0][warp] = total;
      red[1][warp] = n_fast;
      red[2][warp] = swaps;
    }
    __syncthreads();
    if (warp == 0) {
      total = red[0][lane];
      n_fast = red[1][lane];
      swaps = red[2][lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        total = __fadd_rn(total, __shfl_down_sync(kFull, total, off));
        n_fast = __fadd_rn(n_fast, __shfl_down_sync(kFull, n_fast, off));
        swaps = __fadd_rn(swaps, __shfl_down_sync(kFull, swaps, off));
      }
      if (lane == 0) {
        const float n_slow = __fsub_rn(total, n_fast);
        const float latency = __fmaf_rn(n_fast, k.lat_fast,
                                        __fmul_rn(n_slow, k.lat_slow));
        const float over = fmaxf(0.0f, __fmaf_rn(total, -k.bw_slow, n_slow));
        // latency + over*bw_penalty + swaps*mig_cost + period_overhead
        const float period_rt = __fadd_rn(
            __fmaf_rn(swaps, k.mig_cost,
                      __fmaf_rn(over, k.bw_penalty, latency)),
            k.period_overhead);
        acc_rt = __fadd_rn(acc_rt, period_rt);
        acc_sw = __fadd_rn(acc_sw, swaps);
        acc_fh = __fadd_rn(acc_fh, n_fast);
      }
    }
    // the next period's first barrier orders its reuse of hist/scan/red
    // after every read of them above
  }
  if (tid == 0) {
    rt_out[c] = acc_rt;
    sw_out[c] = acc_sw;
    fh_out[c] = acc_fh;
  }
}

}  // namespace

extern "C" int sim_scan_launch(const void* hists, const void* num_reals,
                               const void* init_fast, void* rt, void* sw,
                               void* fh, int n_cand, int n_periods, int n,
                               int capacity, int predictive, float lat_fast,
                               float lat_slow, float bw_slow, float bw_penalty,
                               float mig_cost, float period_overhead,
                               float alpha, float one_minus_alpha,
                               void* stream) {
  const size_t smem = static_cast<size_t>(n) * 13;
  cudaError_t err = cudaFuncSetAttribute(
      sim_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Costs k{lat_fast, lat_slow,        bw_slow, bw_penalty,
                mig_cost, period_overhead, alpha,   one_minus_alpha};
  sim_scan_kernel<<<n_cand, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hists), static_cast<const int*>(num_reals),
      static_cast<const uint8_t*>(init_fast), static_cast<float*>(rt),
      static_cast<float*>(sw), static_cast<float*>(fh), n_periods, n,
      capacity, predictive, k);
  return static_cast<int>(cudaGetLastError());
}
