// Blockwise (flash) attention forward: the Hopper (sm_90a) counterpart of
// the TPU kernel repro/kernels/flash_attention.py::flash_attention (body
// `_kernel`).
//
// What it computes: q [B, S, H, D], k/v [B, T, KV, D] (KV divides H; query
// head h reads KV head h / (H / KV)), S <= T.  For query i of head h
//   out[b, i, h] = sum_j p_j v[b, j, h / rep] / max(sum_j p_j, 1e-30),
//   p_j = exp(s_j - max s),  s_j = (q[b, i, h] . k[b, j, h / rep]) * scale,
// over the keys j it attends: j <= i when causal, and j > i - window when
// window > 0 (positions counted from 0 for both queries and keys).  Masked
// logits are -1e30 and the scale 1/sqrt(D) is multiplied, as in the TPU
// kernel; in bfloat16, p is rounded to bfloat16 before the PV product, as
// the TPU kernel casts it to v's dtype.  The output has q's dtype.
//
// Bound on this card: operations.  Per (query, attended key) pair it does
// 4 * D flops for each head (2 * D in q . k, 2 * D in p * v) on 4 * D * 2
// bytes of k and v that every query of the tile and every head of the GQA
// group reads again: at prefill's S = T = 2048, H = 16, D = 256 that is
// ~100 GFLOP against ~0.4 GB, so in float32 on CUDA cores (67 TFLOP/s) the
// arithmetic, not the 3.35 TB/s of HBM, sets the floor.
//
// Design (simple and right first; mma/wgmma, TMA and K/V reuse across a
// GQA group are later work):
//   * the TPU kernel's sequential kv grid axis carried (m, l, acc) in
//     scratch from one grid step to the next; here one block owns one
//     (batch, query head, tile of 64 query rows) and walks its kv tiles of
//     32 rows in a loop, with (m, l) in registers and acc [64, D] in the
//     registers of its 8 warps (warp w owns query rows 8w..8w+7);
//   * only kv tiles that hold an attended key are visited: for causal,
//     none past the tile's last query; with a window, none wholly before
//     its first query's window.  The TPU kernel computes every tile and
//     lets exp(m_prev - m_new) wash out what a wholly masked tile left;
//     here a masked key gets p = 0, so no tile leaves anything to wash;
//   * the q tile is converted to float32 in shared memory once; k and v
//     tiles are copied in their own dtype with 16-byte cp.async into a
//     double buffer (rows padded by 16 bytes, so a warp's 32 rows fall in
//     distinct banks), the next tile in flight while the block computes
//     on the current one; rows past T are zero-filled;
//   * q . k: lane j of a warp computes the logits of key j of the tile for
//     the warp's 8 rows (q read as float4 broadcasts, k as one 16-byte
//     read feeding 8 FMA chains); the row max and sum take warp shuffles;
//     p goes to shared memory (each warp its own rows);
//   * p v: the warp's lanes split its 8 rows x D output columns, each
//     holding up to 8 rows x 8 columns of acc in registers, one v read
//     feeding up to 8 rows;
//   * any S and T (S <= T): rows past S are computed on zeros and never
//     written, keys past T are masked.  Query tiles are launched heaviest
//     first (a causal tile near the end of the sequence visits the most kv
//     tiles).
//
// The wrapper guarantees contiguous inputs, 16-byte aligned pointers and
// D in {16, 32, 64, 128, 256}.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBKV = 32;       // key rows per kv tile
constexpr int kThreads = 256;  // 8 warps, 8 query rows each
constexpr int kLDP = kBKV + 4; // p row stride (floats; keeps float4 rows)
constexpr float kNeg = -1e30f; // masked logits, as the TPU kernel

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// p as the PV product sees it: rounded to v's dtype
__device__ __forceinline__ float as_v(float p, const float*) { return p; }
__device__ __forceinline__ float as_v(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ float warp_sum(float s) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__device__ __forceinline__ float warp_max(float m) {
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void wait_async_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy key rows [row0, row0 + kBKV) of one KV head into a padded shared
// tile [kBKV][D + pad] with 16-byte cp.async; rows >= T are zero-filled
// (src-size 0 reads nothing).  `src` points at row 0 of the head, rows
// `stride` elements apart.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int row0,
                                           int T_len, size_t stride) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;       // 16-byte chunks per row
  constexpr int kLD = D + kVec;
  for (int c = threadIdx.x; c < kBKV * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const int j = row0 + r;
    const T* s = src + (size_t)min(j, T_len - 1) * stride + cc * kVec;
    const unsigned a = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + r * kLD + cc * kVec));
    const int bytes = j < T_len ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
                 "l"(s), "r"(bytes)
                 : "memory");
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int S, int T_len, int H,
    int KV, float scale, int causal, int window) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLD = D + kVec;              // k/v row stride (elements)
  // p v: lanes along the columns (LC) and rows (LR) of the warp's 8 rows
  constexpr int LC = D >= 128 ? 32 : D / 4;
  constexpr int LR = 32 / LC;
  constexpr int RPL = 8 / LR;                // rows per lane
  constexpr int NCH = D / (4 * LC);          // 4-column chunks per lane

  const int qt = gridDim.x - 1 - blockIdx.x; // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);             // [2][kBKV][kLD]
  T* v_s = k_s + 2 * kBKV * kLD;                       // [2][kBKV][kLD]
  float* q_s = reinterpret_cast<float*>(v_s + 2 * kBKV * kLD);  // [kBQ][D]
  float* p_s = q_s + kBQ * D;                          // [kBQ][kLDP]
  float* c_s = p_s + kBQ * kLDP;                       // [kBQ] per-row factor

  // the kv tiles holding an attended key of this query tile
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(T_len, q_last + 1) : T_len;
  const int kt_lo = k_lo / kBKV;
  const int kt_hi = (k_end + kBKV - 1) / kBKV;

  const size_t kv_stride = (size_t)KV * D;
  const T* k_head = k + ((size_t)b * T_len * KV + g) * D;
  const T* v_head = v + ((size_t)b * T_len * KV + g) * D;
  if (kt_lo < kt_hi) {
    stage_tile<T, D>(k_s, k_head, kt_lo * kBKV, T_len, kv_stride);
    stage_tile<T, D>(v_s, v_head, kt_lo * kBKV, T_len, kv_stride);
  }
  commit_async();

  // the q tile in float32; rows past S hold zeros
  for (int c = tid; c < kBQ * D / 4; c += kThreads) {
    const int r = c / (D / 4), d = (c % (D / 4)) * 4;
    const int i = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < S) x = load4(q + (((size_t)b * S + i) * H + h) * D + d);
    store4(q_s + r * D + d, x);
  }

  float m[8], l[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
  }
  const int lr = lane / LC, lc = lane % LC;
  float acc[RPL][NCH][4];
#pragma unroll
  for (int i = 0; i < RPL; ++i)
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;

  const int row0 = warp * 8;                 // the warp's first tile row
  int buf = 0;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    if (kt + 1 < kt_hi) {
      stage_tile<T, D>(k_s + (buf ^ 1) * kBKV * kLD, k_head,
                       (kt + 1) * kBKV, T_len, kv_stride);
      stage_tile<T, D>(v_s + (buf ^ 1) * kBKV * kLD, v_head,
                       (kt + 1) * kBKV, T_len, kv_stride);
    }
    commit_async();
    wait_async_but_one();
    __syncthreads();
    const T* kb = k_s + buf * kBKV * kLD;
    const T* vb = v_s + buf * kBKV * kLD;

    // logits of key `lane` of the tile for the warp's 8 rows
    float s[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) s[r] = 0.f;
    const T* krow = kb + lane * kLD;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv = load4(krow + d);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 qv = load4(q_s + (row0 + r) * D + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    // online softmax, one row at a time across the warp
    const int key = kt * kBKV + lane;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = q0 + row0 + r;
      const bool valid = key < T_len && (!causal || key <= i) &&
                         (window <= 0 || key > i - window);
      const float x = valid ? s[r] * scale : kNeg;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float p = valid ? expf(x - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
      p_s[(row0 + r) * kLDP + lane] = as_v(p, vb);
      if (lane == 0) c_s[row0 + r] = corr;
    }
    __syncwarp();

    // acc = acc * corr + p v over the tile's keys
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const float corr = c_s[row0 + lr * RPL + i];
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }
#pragma unroll 2
    for (int j0 = 0; j0 < kBKV; j0 += 4) {
      float4 pv[RPL];
#pragma unroll
      for (int i = 0; i < RPL; ++i)
        pv[i] = load4(p_s + (row0 + lr * RPL + i) * kLDP + j0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const T* vrow = vb + (j0 + jj) * kLD;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const float4 vv = load4(vrow + 4 * (lc + c * LC));
#pragma unroll
          for (int i = 0; i < RPL; ++i) {
            const float p = jj == 0   ? pv[i].x
                            : jj == 1 ? pv[i].y
                            : jj == 2 ? pv[i].z
                                      : pv[i].w;
            acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
          }
        }
      }
    }
    __syncthreads();   // the next iteration refills this buffer
    buf ^= 1;
  }

  // out = acc / max(l, 1e-30), rows past S not written
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 8; ++r) c_s[row0 + r] = fmaxf(l[r], 1e-30f);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int r = row0 + lr * RPL + i;
    const int qi = q0 + r;
    if (qi >= S) continue;
    const float den = c_s[r];
    T* orow = out + (((size_t)b * S + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      store4(orow + 4 * (lc + c * LC),
             make_float4(acc[i][c][0] / den, acc[i][c][1] / den,
                         acc[i][c][2] / den, acc[i][c][3] / den));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int T_len, int H, int KV, float scale,
                   int causal, int window, cudaStream_t stream) {
  constexpr int kLD = D + 16 / (int)sizeof(T);
  const size_t smem = 4 * sizeof(T) * (size_t)kBKV * kLD +
                      sizeof(float) * ((size_t)kBQ * D + (size_t)kBQ * kLDP +
                                       kBQ);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_len, H, KV, scale,
      causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* out, int B, int S, int T_len, int H, int KV,
                     float scale, int causal, int window,
                     cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, S, T_len, H, KV, scale, causal,
                           window, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, B, S, T_len, H, KV, scale, causal,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, T_len, H, KV, scale, causal,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, T_len, H, KV, scale, causal,
                            window, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, B, S, T_len, H, KV, scale, causal,
                            window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
extern "C" cudaError_t flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* out, int B,
    int S, int T, int H, int KV, int D, float scale, int causal, int window,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, out, B, S, T, H, KV, scale, causal,
                           window, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, out, B, S, T, H, KV, scale,
                                   causal, window, st);
  return cudaErrorInvalidValue;
}
