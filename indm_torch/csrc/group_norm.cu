// GroupNorm (+ optional swish), forward and backward, for Hopper (sm_90a),
// NCHW.
//
// Forward: replaces the TPU kernel `indm_tpu/ops/group_norm_pallas.py:
// _fwd_call` / `_fwd_kernel`: per-(sample, group) statistics in f32,
// variance as E[x^2] - mean^2, y = (x - mean) * rsqrt(var + eps) * scale[c]
// + bias[c], then optionally swish u * sigmoid(u); the output is cast to
// x's dtype.
//
// Backward: replaces `group_norm_pallas.py:_bwd_call` / `_bwd_kernel`.
// It recomputes the statistics from x (the same formula about the same
// shift as the forward, summed in another order, so they agree with the
// forward's to float32 rounding, not to the bit), then g = dy * swish'(u)
// (or dy),
// dx = rstd * (g*scale - mean_grp(g*scale) - xhat * mean_grp(g*scale*xhat)),
// and the per-sample partials of dscale = sum g*xhat and dbias = sum g.
//
// Forward design (and the backward's one-block-a-row kernel). In NCHW the
// C/G * H * W values of one (sample, group) are one contiguous row, so one
// thread block owns one row: grid = B * G blocks.
// The block reads its row once from device memory (16-byte vector loads
// where the row allows), keeps it in shared memory as f32, reduces the two
// sums across the block with warp shuffles, and writes the normalised row
// once. Nothing crosses blocks in the forward, so there is no second pass
// and no atomics.
// A row is cached only while it fits in the 48 KB of shared memory a block
// gets without an opt-in (12 288 f32 values less the reduction scratch);
// a longer row (at full width only the 384-channel GroupNorm at 32x32) is
// read a second time, which the 50 MB L2 mostly serves, since the block
// read the same row just before.
// The TPU kernel's [C, C] group-averaging matmul and its batch-tile picker
// were workarounds for Mosaic's lane layout and for VMEM; neither is needed.
//
// Backward design (`group_norm_bwd_rows_kernel`). It must read x and dy
// once and write dx once. Each row is held in registers while it is
// used, so nothing is read twice: the row's tpr threads (a power of two,
// 32 to 1024, the least that leaves each at most kBwdChunks 16-byte
// chunks of x and of dy) issue all their loads at once, so that a thread
// keeps up to 128 bytes in flight. Chunk j of a row is thread j % tpr's
// (j / tpr)-th, so a warp's loads and stores are 512 contiguous bytes.
// Rows of up to 256 threads go several to a 256-thread block (a ragged
// last block leaves rows idle, never returns before a barrier); a warp
// never spans two rows, so a row of one warp reduces by shuffles alone.
// The row's statistics: each thread's sums, a shuffle tree, the row's
// warps in order through shared memory. Then each chunk's two sums of g
// and g*xhat go to shared memory by chunk index, the row's warps sum each
// channel's chunks (lanes in chunk order, then a shuffle tree) into the
// per-channel partials, and dx is computed from the registers, with g
// recomputed, and stored once. A row longer than the plan holds (over
// 1024 * kBwdChunks chunks, or over 48 KB of shared memory; the 32x32
// net has none, the 64x64 net two shapes) takes the one-block-a-row
// kernel (`group_norm_bwd_kernel`),
// which reads dy twice and x again where the row does not fit in shared
// memory. Plan and bound at the net's 13 (shape, act) pairs at batch 128,
// float32 (rows = 128 * 32 = 4096; bound = 3 * 4 bytes an element over
// 3.35 TB/s):
//
//   C x H x W     launches  row values  tpr x chunks  rows/block  bound us
//   256 x 4 x 4       20        128        32 x 1          8          1.9
//   512 x 4 x 4        5        256        32 x 2          8          3.8
//   256 x 8 x 8       17        512        32 x 4          8          7.5
//   128 x 16 x 16      2       1024        64 x 4          4         15.0
//   512 x 8 x 8        5       1024        64 x 4          4         15.0
//   256 x 16 x 16     20       2048       128 x 4          2         30.0
//   384 x 16 x 16      1       3072       256 x 3          1         45.1
//   128 x 32 x 32     15       4096       256 x 4          1         60.1
//   512 x 16 x 16      4       4096       256 x 4          1         60.1
//   256 x 32 x 32      5       8192       512 x 4          1        120.2
//   384 x 32 x 32      1      12288      1024 x 3          1        180.3
//
// 95 launches, 2.858 ms a training step. In bfloat16 a chunk is 8 values,
// so a row takes half the threads (32 at least).
//
// At 64x64 (the CelebA nets, `vp/CELEBA/*` and `ve/CELEBA/indm`) the same
// 95 launches take 11 shapes, 10.983 ms a training step at batch 128. The
// two longest rows pass the plan (over 1024 threads of 4 chunks) and take
// the one-block-a-row kernel, which reads dy twice and x again where the
// row does not fit in shared memory (both rows here): 6 of the 95
// launches, 3.125 ms of the bound.
//
//   C x H x W     launches  row values  tpr x chunks  rows/block  bound us
//   256 x 8 x 8       20        512        32 x 4          8          7.5
//   512 x 8 x 8        5       1024        64 x 4          4         15.0
//   256 x 16 x 16     22       2048       128 x 4          2         30.0
//   128 x 32 x 32      2       4096       256 x 4          1         60.1
//   512 x 16 x 16      5       4096       256 x 4          1         60.1
//   256 x 32 x 32     15       8192       512 x 4          1        120.2
//   384 x 32 x 32      1      12288      1024 x 3          1        180.3
//   128 x 64 x 64     15      16384      1024 x 4          1        240.4
//   512 x 32 x 32      4      16384      1024 x 4          1        240.4
//   256 x 64 x 64      5      32768      one block         1        480.8
//   384 x 64 x 64      1      49152      one block         1        721.2
// The design it replaces gave each row a block of 256 threads
// however short the row, read dy twice (the channel sums, then dx) with
// scalar loads in the first pass, and read the 384 x 32 x 32 row's x
// three times.
//
// The backward's parameter gradients are sums over the batch. The TPU grid
// ran in order and carried them from one grid step to the next; Hopper's
// blocks run in parallel, so each block writes its sample's per-channel
// partials ([B, C], a fixed order) and a second, small kernel sums them
// over the batch in a fixed order (`sum_over_batch_kernel`). No atomics:
// the gradients are the same from run to run.
//
// Cancellation. The sums are taken about a shift K = the row's first
// element: s1 = sum(x - K), s2 = sum((x - K)^2), mean = K + s1/n,
// var = s2/n - (s1/n)^2. This is E[x^2] - mean^2 rewritten about K, so
// it is the same formula, but its two terms no longer carry mean^2 when
// |mean| >> std.
//
// Bound. The forward must read x once and write y once:
// 2 * B*C*H*W * sizeof(dtype) bytes over 3.35 TB/s on an H100 SXM; the
// backward must read x and dy once and write dx once (3 * B*C*H*W *
// sizeof(dtype)). Their arithmetic (under 40 flops per element) is far
// below the compute roof.
//
// Interface: plain C, loaded with ctypes (indm_torch/ops/group_norm.py).
// Launches go on the caller's stream; each function returns the CUDA
// error code of its launches (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// Elements per 16-byte vector access.
template <typename T>
struct VecWidth;
template <>
struct VecWidth<float> {
  static constexpr int N = 4;
};
template <>
struct VecWidth<__nv_bfloat16> {
  static constexpr int N = 8;
};

template <typename T, int N>
__device__ __forceinline__ void load16(const T* p, float (&v)[N]) {
  static_assert(sizeof(T) * N == 16, "16-byte vector");
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = to_f32(e[k]);
}

template <typename T, int N>
__device__ __forceinline__ void store16(T* p, const float (&v)[N]) {
  static_assert(sizeof(T) * N == 16, "16-byte vector");
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < N; ++k) from_f32(v[k], e + k);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Sum a and b over the block; every thread returns with the totals.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  a = lane < kWarps ? red[lane] : 0.f;
  b = lane < kWarps ? red[kWarps + lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

__device__ __forceinline__ float swish(float u) {
  return u / (1.f + expf(-u));
}

// d/du of u * sigmoid(u)
__device__ __forceinline__ float swish_grad(float u) {
  const float s = 1.f / (1.f + expf(-u));
  return s * (1.f + u * (1.f - s));
}

// Mean and rstd of the row xr[0, n), summed about its first element; with
// CACHE the row is also written to `row` as f32. Every thread returns with
// both. VEC: 16-byte vector loads (see the kernels below).
template <typename T, bool VEC, bool CACHE>
__device__ __forceinline__ void row_stats(const T* __restrict__ xr, int n,
                                          float eps, float* row, float* red,
                                          float& mean, float& rstd) {
  const float shift = to_f32(xr[0]);
  float s1 = 0.f, s2 = 0.f;
  if (VEC) {
    constexpr int N = VecWidth<T>::N;
    for (int i = threadIdx.x * N; i < n; i += kThreads * N) {
      float v[N];
      load16<T, N>(xr + i, v);
      if (CACHE) {
#pragma unroll
        for (int k = 0; k < N; k += 4)
          *reinterpret_cast<float4*>(row + i + k) =
              make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float d = v[k] - shift;
        s1 += d;
        s2 += d * d;
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float v = to_f32(xr[i]);
      if (CACHE) row[i] = v;
      const float d = v - shift;
      s1 += d;
      s2 += d * d;
    }
  }
  block_sum2(s1, s2, red);

  const float inv_n = 1.f / static_cast<float>(n);
  const float m = s1 * inv_n;  // mean - shift
  mean = shift + m;
  const float var = fmaxf(s2 * inv_n - m * m, 0.f);
  rstd = rsqrtf(var + eps);
}

// Elements [i, i + N) of the row as f32: from the shared-memory copy when
// the row is cached, else from device memory.
template <typename T, int N, bool CACHE>
__device__ __forceinline__ void row_chunk(const T* __restrict__ xr,
                                          const float* row, int i,
                                          float (&v)[N]) {
  if (CACHE) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(row + i + k);
      v[k] = q.x;
      v[k + 1] = q.y;
      v[k + 2] = q.z;
      v[k + 3] = q.w;
    }
  } else {
    load16<T, N>(xr + i, v);
  }
}

// VEC: the row is read and written in 16-byte vectors. The wrapper takes
// this path only when H*W is a multiple of the vector width (so a vector
// never straddles two channels) and every pointer is 16-byte aligned.
// CACHE: the row is kept in shared memory between the passes; otherwise
// the later passes read it again from device memory.
template <typename T, bool VEC, bool SWISH, bool CACHE>
__global__ void __launch_bounds__(kThreads)
    group_norm_fwd_kernel(const T* __restrict__ x,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias, T* __restrict__ y,
                          int C, int HW, int G, float eps) {
  extern __shared__ float4 smem4[];
  float* row = reinterpret_cast<float*>(smem4);
  __shared__ float red[2 * kWarps];

  const int cpg = C / G;
  const int n = cpg * HW;
  const int bg = blockIdx.x;  // b * G + g
  const int c0 = (bg % G) * cpg;
  const T* xr = x + static_cast<int64_t>(bg) * n;
  T* yr = y + static_cast<int64_t>(bg) * n;

  float mean, rstd;
  row_stats<T, VEC, CACHE>(xr, n, eps, row, red, mean, rstd);

  if (VEC) {
    constexpr int N = VecWidth<T>::N;
    for (int i = threadIdx.x * N; i < n; i += kThreads * N) {
      const int c = c0 + i / HW;
      const float a = rstd * __ldg(scale + c);
      const float b = __ldg(bias + c);
      float v[N];
      row_chunk<T, N, CACHE>(xr, row, i, v);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float u = (v[k] - mean) * a + b;
        v[k] = SWISH ? swish(u) : u;
      }
      store16<T, N>(yr + i, v);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int c = c0 + i / HW;
      const float v = CACHE ? row[i] : to_f32(xr[i]);
      const float u = (v - mean) * (rstd * __ldg(scale + c)) +
                      __ldg(bias + c);
      from_f32(SWISH ? swish(u) : u, yr + i);
    }
  }
}

// One block per (sample, group) row, as in the forward. Shared memory:
// the cached row (CACHE), then 2 * cpg channel sums.
template <typename T, bool VEC, bool SWISH, bool CACHE>
__global__ void __launch_bounds__(kThreads)
    group_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias, T* __restrict__ dx,
                          float* __restrict__ part, int C, int HW, int G,
                          float eps) {
  extern __shared__ float4 smem4[];
  float* row = reinterpret_cast<float*>(smem4);
  __shared__ float red[2 * kWarps];

  const int cpg = C / G;
  const int n = cpg * HW;
  const int bg = blockIdx.x;  // b * G + g
  const int b = bg / G;
  const int c0 = (bg % G) * cpg;
  const T* xr = x + static_cast<int64_t>(bg) * n;
  const T* dyr = dy + static_cast<int64_t>(bg) * n;
  T* dxr = dx + static_cast<int64_t>(bg) * n;
  float* csum = row + (CACHE ? n : 0);  // [sum g, sum g*xhat] per channel

  float mean, rstd;
  row_stats<T, VEC, CACHE>(xr, n, eps, row, red, mean, rstd);

  // channel sums: warp w takes channels w, w + kWarps, ... of the group
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int ci = warp; ci < cpg; ci += kWarps) {
    const int c = c0 + ci;
    const float sc = __ldg(scale + c);
    const float bi = __ldg(bias + c);
    float sg = 0.f, sgx = 0.f;
    for (int p = lane; p < HW; p += 32) {
      const int i = ci * HW + p;
      const float xh = ((CACHE ? row[i] : to_f32(xr[i])) - mean) * rstd;
      const float d = to_f32(dyr[i]);
      const float g = SWISH ? d * swish_grad(xh * sc + bi) : d;
      sg += g;
      sgx += g * xh;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sg += __shfl_xor_sync(0xffffffffu, sg, o);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, o);
    }
    if (lane == 0) {
      csum[ci] = sg;
      csum[cpg + ci] = sgx;
      // part is [B, 2, C]: dscale, then dbias
      part[static_cast<int64_t>(b) * 2 * C + c] = sgx;
      part[static_cast<int64_t>(b) * 2 * C + C + c] = sg;
    }
  }
  __syncthreads();
  float p1 = 0.f, p2 = 0.f;
  for (int ci = 0; ci < cpg; ++ci) {
    const float sc = __ldg(scale + c0 + ci);
    p1 += sc * csum[ci];
    p2 += sc * csum[cpg + ci];
  }
  const float inv_n = 1.f / static_cast<float>(n);
  p1 *= inv_n;  // mean over the group of g * scale
  p2 *= inv_n;  // mean over the group of g * scale * xhat

  if (VEC) {
    constexpr int N = VecWidth<T>::N;
    for (int i = threadIdx.x * N; i < n; i += kThreads * N) {
      const int c = c0 + i / HW;
      const float sc = __ldg(scale + c);
      const float bi = __ldg(bias + c);
      float v[N], d[N];
      row_chunk<T, N, CACHE>(xr, row, i, v);
      load16<T, N>(dyr + i, d);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float xh = (v[k] - mean) * rstd;
        const float g = SWISH ? d[k] * swish_grad(xh * sc + bi) : d[k];
        v[k] = rstd * (g * sc - p1 - xh * p2);
      }
      store16<T, N>(dxr + i, v);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int c = c0 + i / HW;
      const float sc = __ldg(scale + c);
      const float xh = ((CACHE ? row[i] : to_f32(xr[i])) - mean) * rstd;
      const float d = to_f32(dyr[i]);
      const float g = SWISH ? d * swish_grad(xh * sc + __ldg(bias + c)) : d;
      from_f32(rstd * (g * sc - p1 - xh * p2), dxr + i);
    }
  }
}

// The backward's row plan: at most this many 16-byte chunks of x and of
// dy a thread, and rows of up to this many threads.
constexpr int kBwdChunks = 4;
constexpr int kBwdMaxRowThreads = 1024;

// One chunk of a row in registers as loaded: a 16-byte vector (VEC) or
// one element.
template <typename T, bool VEC>
struct Chunk {
  static constexpr int N = VEC ? VecWidth<T>::N : 1;
  typename std::conditional<VEC, uint4, T>::type raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = *reinterpret_cast<const decltype(raw)*>(p);
  }
  __device__ __forceinline__ float operator[](int k) const {
    return to_f32(reinterpret_cast<const T*>(&raw)[k]);
  }
};

// a and b summed over the `tpr` threads of a row (tpr a power of two, 32
// or more); every thread of the row returns with the totals. red holds
// two floats a warp; a row of one warp takes no barrier (tpr is the same
// for the whole block, so the branch is too).
__device__ __forceinline__ void row_sum2(float& a, float& b, float2* red,
                                         int tpr) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (tpr == 32) return;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  const int first = warp & ~((tpr >> 5) - 1);  // the row's first warp
  a = b = 0.f;
  for (int w = first; w < first + (tpr >> 5); ++w) {
    a += red[w].x;
    b += red[w].y;
  }
}

// The backward on rows held in registers (the note's "backward design").
// Shared memory: [blockDim * NV] chunk sums, [rows a block][cpg] channel
// sums, [warps] row partials, all float2.
template <typename T, bool VEC, int NV, bool SWISH, int MAXT>
__global__ void __launch_bounds__(MAXT)
    group_norm_bwd_rows_kernel(const T* __restrict__ x,
                               const T* __restrict__ dy,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias,
                               T* __restrict__ dx, float* __restrict__ part,
                               int rows, int C, int HW, int G, int tpr_log2,
                               float eps) {
  using Ch = Chunk<T, VEC>;
  constexpr int N = Ch::N;
  extern __shared__ float2 smem2[];
  const int cpg = C / G;
  const int n = cpg * HW;
  const int chunks = n / N;  // HW % N == 0 where VEC
  const int tpr = 1 << tpr_log2;
  const int r = threadIdx.x >> tpr_log2;  // the block's row
  const int t = threadIdx.x & (tpr - 1);
  const int row = blockIdx.x * (blockDim.x >> tpr_log2) + r;  // b * G + g
  const bool live = row < rows;
  float2* cpart = smem2 + r * tpr * NV;  // this row's chunk sums
  float2* csum = smem2 + blockDim.x * NV + r * cpg;  // its channel sums
  float2* red = smem2 + blockDim.x * NV + (blockDim.x >> tpr_log2) * cpg;
  const int64_t base = static_cast<int64_t>(live ? row : 0) * n;
  const int c0 = (row % G) * cpg;

  Ch xv[NV], dv[NV];
  float shift = 0.f;
  if (live) {
    shift = to_f32(x[base]);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int j = v * tpr + t;
      if (j < chunks) {
        xv[v].load(x + base + static_cast<int64_t>(j) * N);
        dv[v].load(dy + base + static_cast<int64_t>(j) * N);
      }
    }
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!live || v * tpr + t >= chunks) continue;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float d = xv[v][k] - shift;
      s1 += d;
      s2 += d * d;
    }
  }
  row_sum2(s1, s2, red, tpr);
  const float inv_n = 1.f / static_cast<float>(n);
  const float m = s1 * inv_n;  // mean - shift
  const float mean = shift + m;
  const float rstd = rsqrtf(fmaxf(s2 * inv_n - m * m, 0.f) + eps);

  // g and g * xhat summed over each chunk (a chunk lies in one channel)
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int j = v * tpr + t;
    if (!live || j >= chunks) continue;
    const int c = c0 + j * N / HW;
    const float sc = __ldg(scale + c);
    const float bi = __ldg(bias + c);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float xh = (xv[v][k] - mean) * rstd;
      const float g = SWISH ? dv[v][k] * swish_grad(xh * sc + bi) : dv[v][k];
      sg += g;
      sgx += g * xh;
    }
    cpart[j] = make_float2(sg, sgx);
  }
  __syncthreads();
  // channel sums: the row's warps take its channels in turn, lanes the
  // channel's chunks in order
  const int cpc = chunks / cpg;  // chunks a channel
  const int lane = threadIdx.x & 31;
  if (live) {
    const int b = row / G;
    for (int ci = t >> 5; ci < cpg; ci += tpr >> 5) {
      float sg = 0.f, sgx = 0.f;
      for (int q = lane; q < cpc; q += 32) {
        const float2 p = cpart[ci * cpc + q];
        sg += p.x;
        sgx += p.y;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sg += __shfl_xor_sync(0xffffffffu, sg, o);
        sgx += __shfl_xor_sync(0xffffffffu, sgx, o);
      }
      if (lane == 0) {
        csum[ci] = make_float2(sg, sgx);
        // part is [B, 2, C]: dscale, then dbias
        part[static_cast<int64_t>(b) * 2 * C + c0 + ci] = sgx;
        part[static_cast<int64_t>(b) * 2 * C + C + c0 + ci] = sg;
      }
    }
  }
  __syncthreads();
  if (!live) return;
  float p1 = 0.f, p2 = 0.f;
  for (int ci = 0; ci < cpg; ++ci) {
    const float sc = __ldg(scale + c0 + ci);
    p1 += sc * csum[ci].x;
    p2 += sc * csum[ci].y;
  }
  p1 *= inv_n;  // mean over the group of g * scale
  p2 *= inv_n;  // mean over the group of g * scale * xhat

#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int j = v * tpr + t;
    if (j >= chunks) continue;
    const int c = c0 + j * N / HW;
    const float sc = __ldg(scale + c);
    const float bi = __ldg(bias + c);
    float out[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float xh = (xv[v][k] - mean) * rstd;
      const float g = SWISH ? dv[v][k] * swish_grad(xh * sc + bi) : dv[v][k];
      out[k] = rstd * (g * sc - p1 - xh * p2);
    }
    T* dst = dx + base + static_cast<int64_t>(j) * N;
    if constexpr (VEC) {
      store16<T, N>(dst, out);
    } else {
      from_f32(out[0], dst);
    }
  }
}

// out[j] = sum over b of part[b * J + j] in a fixed order: a block takes
// 32 columns (a lane each, so a warp's loads are 128 contiguous bytes),
// warp w sums b = w, w + kWarps, ... in turn, and the block adds its
// warps' sums in warp order, so that no thread adds all B in turn.
__global__ void __launch_bounds__(kThreads)
    sum_over_batch_kernel(const float* __restrict__ part,
                          float* __restrict__ out, int B, int J) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < J) {
#pragma unroll 4
    for (int b = warp; b < B; b += kWarps)
      s += part[static_cast<int64_t>(b) * J + j];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < J) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][lane];
    out[j] = t;
  }
}

// Shared memory a block may take without an opt-in.
constexpr size_t kSmemNoOptIn = 48 * 1024;

template <typename T, bool VEC, bool SWISH>
cudaError_t launch_fwd(const void* x, const float* scale, const float* bias,
                       void* y, int B, int C, int HW, int G, float eps,
                       cudaStream_t stream) {
  const size_t row = static_cast<size_t>(C / G) * HW * sizeof(float);
  const bool cache = row + 2 * kWarps * sizeof(float) <= kSmemNoOptIn;
  auto kernel = cache ? group_norm_fwd_kernel<T, VEC, SWISH, true>
                      : group_norm_fwd_kernel<T, VEC, SWISH, false>;
  kernel<<<B * G, kThreads, cache ? row : 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), C, HW, G,
      eps);
  return cudaGetLastError();
}

// The backward's row plan, chosen by the wrapper (`group_norm.py:
// bwd_plan`): threads a row as a power of two, chunks a thread (1, 2 or
// kBwdChunks), and from them the block and its shared memory; false where
// the plan does not hold the row or would take more than kSmemNoOptIn.
struct BwdPlan {
  int tpr_log2, nv, block;
  size_t smem;
};

template <typename T, bool VEC>
bool bwd_plan(int C, int HW, int G, int tpr_log2, int nv, BwdPlan* plan) {
  if (tpr_log2 < 5 || (1 << tpr_log2) > kBwdMaxRowThreads ||
      (nv != 1 && nv != 2 && nv != kBwdChunks))
    return false;
  const int chunks = C / G * HW / Chunk<T, VEC>::N;
  const int tpr = 1 << tpr_log2;
  if (static_cast<int64_t>(nv) * tpr < chunks) return false;
  plan->tpr_log2 = tpr_log2;
  plan->nv = nv;
  plan->block = tpr > kThreads ? tpr : kThreads;
  plan->smem = sizeof(float2) * (static_cast<size_t>(plan->block) * nv +
                                 static_cast<size_t>(plan->block / tpr) *
                                     (C / G) +
                                 plan->block / 32);
  return plan->smem <= kSmemNoOptIn;
}

template <typename T, bool VEC, int NV, bool SWISH>
cudaError_t launch_bwd_rows(const void* x, const void* dy, const float* scale,
                            const float* bias, void* dx, float* part, int B,
                            int C, int HW, int G, float eps,
                            const BwdPlan& plan, cudaStream_t stream) {
  const int rows = B * G;
  const int per_block = plan.block >> plan.tpr_log2;
  auto kernel = plan.block > 512
                    ? group_norm_bwd_rows_kernel<T, VEC, NV, SWISH, 1024>
                    : group_norm_bwd_rows_kernel<T, VEC, NV, SWISH, 512>;
  kernel<<<(rows + per_block - 1) / per_block, plan.block, plan.smem,
           stream>>>(static_cast<const T*>(x), static_cast<const T*>(dy),
                     scale, bias, static_cast<T*>(dx), part, rows, C, HW, G,
                     plan.tpr_log2, eps);
  return cudaGetLastError();
}

// nv = 0: the one-block-a-row kernel; else the row plan (tpr_log2, nv).
template <typename T, bool VEC, bool SWISH>
cudaError_t launch_bwd(const void* x, const void* dy, const float* scale,
                       const float* bias, void* dx, float* part, float* grads,
                       int B, int C, int HW, int G, float eps, int tpr_log2,
                       int nv, cudaStream_t stream) {
  BwdPlan plan;
  cudaError_t err;
  if (nv != 0) {
    if (!bwd_plan<T, VEC>(C, HW, G, tpr_log2, nv, &plan))
      return cudaErrorInvalidValue;
    auto launch = plan.nv == 1   ? launch_bwd_rows<T, VEC, 1, SWISH>
                  : plan.nv == 2 ? launch_bwd_rows<T, VEC, 2, SWISH>
                                 : launch_bwd_rows<T, VEC, kBwdChunks, SWISH>;
    err = launch(x, dy, scale, bias, dx, part, B, C, HW, G, eps, plan,
                 stream);
  } else {
    const size_t sums = 2 * static_cast<size_t>(C / G) * sizeof(float);
    const size_t row = static_cast<size_t>(C / G) * HW * sizeof(float);
    const bool cache =
        row + sums + 2 * kWarps * sizeof(float) <= kSmemNoOptIn;
    auto kernel = cache ? group_norm_bwd_kernel<T, VEC, SWISH, true>
                        : group_norm_bwd_kernel<T, VEC, SWISH, false>;
    kernel<<<B * G, kThreads, (cache ? row : 0) + sums, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), scale, bias,
        static_cast<T*>(dx), part, C, HW, G, eps);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const int J = 2 * C;
  sum_over_batch_kernel<<<(J + 31) / 32, kThreads, 0, stream>>>(part, grads,
                                                                B, J);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fwd(const void* x, const float* scale, const float* bias,
                         void* y, int B, int C, int HW, int G, float eps,
                         int act, int vec, cudaStream_t stream) {
  if (vec) {
    return act ? launch_fwd<T, true, true>(x, scale, bias, y, B, C, HW, G,
                                           eps, stream)
               : launch_fwd<T, true, false>(x, scale, bias, y, B, C, HW, G,
                                            eps, stream);
  }
  return act ? launch_fwd<T, false, true>(x, scale, bias, y, B, C, HW, G, eps,
                                          stream)
             : launch_fwd<T, false, false>(x, scale, bias, y, B, C, HW, G,
                                           eps, stream);
}

template <typename T>
cudaError_t dispatch_bwd(const void* x, const void* dy, const float* scale,
                         const float* bias, void* dx, float* part,
                         float* grads, int B, int C, int HW, int G, float eps,
                         int act, int vec, int tpr_log2, int nv,
                         cudaStream_t stream) {
  auto launch = vec ? (act ? launch_bwd<T, true, true>
                           : launch_bwd<T, true, false>)
                    : (act ? launch_bwd<T, false, true>
                           : launch_bwd<T, false, false>);
  return launch(x, dy, scale, bias, dx, part, grads, B, C, HW, G, eps,
                tpr_log2, nv, stream);
}

}  // namespace

extern "C" {

// x, y: [B, C, HW] contiguous, dtype 0 = float32, 1 = bfloat16;
// scale, bias: [C] float32; act 0 = none, 1 = swish; vec 1 selects the
// 16-byte vector path. Returns the cudaError_t of the launch.
int indm_group_norm_fwd(const void* x, const void* scale, const void* bias,
                        void* y, int B, int C, int HW, int G, float eps,
                        int act, int dtype, int vec, void* stream) {
  if (B <= 0 || G <= 0 || C % G != 0 || HW <= 0) return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_fwd<float>(x, s, b, y, B, C, HW, G, eps, act, vec, st);
  if (dtype == 1)
    return dispatch_fwd<__nv_bfloat16>(x, s, b, y, B, C, HW, G, eps, act, vec,
                                       st);
  return cudaErrorInvalidValue;
}

// x, dy, dx: [B, C, HW] contiguous, one dtype (0 = float32, 1 = bfloat16);
// scale, bias: [C] float32; part: [B, 2, C] float32 scratch; grads: [2, C]
// float32 out, dscale then dbias; (tpr_log2, nv) the row plan, nv = 0 for
// the one-block-a-row kernel. Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for a plan that does not hold the row).
int indm_group_norm_bwd(const void* x, const void* dy, const void* scale,
                        const void* bias, void* dx, void* part, void* grads,
                        int B, int C, int HW, int G, float eps, int act,
                        int dtype, int vec, int tpr_log2, int nv,
                        void* stream) {
  if (B <= 0 || G <= 0 || C % G != 0 || HW <= 0) return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* p = static_cast<float*>(part);
  float* g = static_cast<float*>(grads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bwd<float>(x, dy, s, b, dx, p, g, B, C, HW, G, eps, act,
                               vec, tpr_log2, nv, st);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(x, dy, s, b, dx, p, g, B, C, HW, G,
                                       eps, act, vec, tpr_log2, nv, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
