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
// It recomputes the statistics with the forward's own code (so they are
// bit-identical to the forward's), then g = dy * swish'(u) (or dy),
// dx = rstd * (g*scale - mean_grp(g*scale) - xhat * mean_grp(g*scale*xhat)),
// and the per-sample partials of dscale = sum g*xhat and dbias = sum g.
//
// Design. In NCHW the C/G * H * W values of one (sample, group) are one
// contiguous row, so one thread block owns one row: grid = B * G blocks.
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
// The backward's parameter gradients are sums over the batch. The TPU grid
// ran in order and carried them from one grid step to the next; Hopper's
// blocks run in parallel, so each block writes its sample's per-channel
// partials ([B, C], one warp per channel, a fixed order) and a second,
// small kernel sums them over the batch in order b = 0..B-1. No atomics:
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
// below the compute roof. The backward reads dy twice (the channel sums,
// then dx), the second time mostly from L2.
//
// Interface: plain C, loaded with ctypes (indm_torch/ops/group_norm.py).
// Launches go on the caller's stream; each function returns the CUDA
// error code of its launches (0 on success) and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// out[j] = sum over b = 0..B-1 of part[b * J + j], in that order.
__global__ void sum_over_batch_kernel(const float* __restrict__ part,
                                      float* __restrict__ out, int B, int J) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= J) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part[static_cast<int64_t>(b) * J + j];
  out[j] = s;
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

template <typename T, bool VEC, bool SWISH>
cudaError_t launch_bwd(const void* x, const void* dy, const float* scale,
                       const float* bias, void* dx, float* part, float* grads,
                       int B, int C, int HW, int G, float eps,
                       cudaStream_t stream) {
  const size_t sums = 2 * static_cast<size_t>(C / G) * sizeof(float);
  const size_t row = static_cast<size_t>(C / G) * HW * sizeof(float);
  const bool cache = row + sums + 2 * kWarps * sizeof(float) <= kSmemNoOptIn;
  auto kernel = cache ? group_norm_bwd_kernel<T, VEC, SWISH, true>
                      : group_norm_bwd_kernel<T, VEC, SWISH, false>;
  kernel<<<B * G, kThreads, (cache ? row : 0) + sums, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), scale, bias,
      static_cast<T*>(dx), part, C, HW, G, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int J = 2 * C;
  sum_over_batch_kernel<<<(J + 255) / 256, 256, 0, stream>>>(part, grads, B,
                                                             J);
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
                         int act, int vec, cudaStream_t stream) {
  if (vec) {
    return act ? launch_bwd<T, true, true>(x, dy, scale, bias, dx, part,
                                           grads, B, C, HW, G, eps, stream)
               : launch_bwd<T, true, false>(x, dy, scale, bias, dx, part,
                                            grads, B, C, HW, G, eps, stream);
  }
  return act ? launch_bwd<T, false, true>(x, dy, scale, bias, dx, part, grads,
                                          B, C, HW, G, eps, stream)
             : launch_bwd<T, false, false>(x, dy, scale, bias, dx, part,
                                           grads, B, C, HW, G, eps, stream);
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
// float32 out, dscale then dbias. Returns the cudaError_t of the launches.
int indm_group_norm_bwd(const void* x, const void* dy, const void* scale,
                        const void* bias, void* dx, void* part, void* grads,
                        int B, int C, int HW, int G, float eps, int act,
                        int dtype, int vec, void* stream) {
  if (B <= 0 || G <= 0 || C % G != 0 || HW <= 0) return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  float* p = static_cast<float*>(part);
  float* g = static_cast<float*>(grads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bwd<float>(x, dy, s, b, dx, p, g, B, C, HW, G, eps, act,
                               vec, st);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(x, dy, s, b, dx, p, g, B, C, HW, G,
                                       eps, act, vec, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
