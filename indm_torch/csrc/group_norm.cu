// GroupNorm (+ optional swish) forward for Hopper (sm_90a), NCHW.
//
// Replaces the TPU kernel `indm_tpu/ops/group_norm_pallas.py:_fwd_call`
// / `_fwd_kernel`: per-(sample, group) statistics in f32, variance as
// E[x^2] - mean^2, y = (x - mean) * rsqrt(var + eps) * scale[c] + bias[c],
// then optionally swish u * sigmoid(u); the output is cast to x's dtype.
//
// Design. In NCHW the C/G * H * W values of one (sample, group) are one
// contiguous row, so one thread block owns one row: grid = B * G blocks.
// The block reads its row once from device memory (16-byte vector loads
// where the row allows), keeps it in shared memory as f32, reduces the two
// sums across the block with warp shuffles, and writes the normalised row
// once. Nothing crosses blocks, so there is no second pass and no atomics.
// A row is cached only while it fits in the 48 KB of shared memory a block
// gets without an opt-in (12 288 f32 values less the reduction scratch);
// a longer row (at full width only the 384-channel GroupNorm at 32x32) is
// read a second time for the normalising pass, which the 50 MB L2 mostly
// serves, since the block read the same row just before.
// The TPU kernel's [C, C] group-averaging matmul and its batch-tile picker
// were workarounds for Mosaic's lane layout and for VMEM; neither is needed.
//
// Cancellation. The sums are taken about a shift K = the row's first
// element: s1 = sum(x - K), s2 = sum((x - K)^2), mean = K + s1/n,
// var = s2/n - (s1/n)^2. This is E[x^2] - mean^2 rewritten about K, so
// it is the same formula, but its two terms no longer carry mean^2 when
// |mean| >> std.
//
// Bound. The kernel must read x once and write y once:
// 2 * B*C*H*W * sizeof(dtype) bytes over 3.35 TB/s on an H100 SXM; its
// arithmetic (under 20 flops per element) is far below the compute roof.
//
// Interface: plain C, loaded with ctypes (indm_torch/ops/group_norm.py).
// The launch goes on the caller's stream; the function returns the CUDA
// error code of the launch (0 on success) and never synchronises.

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

// VEC: the row is read and written in 16-byte vectors. The wrapper takes
// this path only when H*W is a multiple of the vector width (so a vector
// never straddles two channels) and both pointers are 16-byte aligned.
// CACHE: the row is kept in shared memory between the two passes;
// otherwise the second pass reads it again from device memory.
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
  const float mean = shift + m;
  const float var = fmaxf(s2 * inv_n - m * m, 0.f);
  const float rstd = rsqrtf(var + eps);

  if (VEC) {
    constexpr int N = VecWidth<T>::N;
    for (int i = threadIdx.x * N; i < n; i += kThreads * N) {
      const int c = c0 + i / HW;
      const float a = rstd * __ldg(scale + c);
      const float b = __ldg(bias + c);
      float v[N];
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

// Shared memory a block may take without an opt-in.
constexpr size_t kSmemNoOptIn = 48 * 1024;

template <typename T, bool VEC, bool SWISH>
cudaError_t launch(const void* x, const float* scale, const float* bias,
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

template <typename T>
cudaError_t dispatch(const void* x, const float* scale, const float* bias,
                     void* y, int B, int C, int HW, int G, float eps, int act,
                     int vec, cudaStream_t stream) {
  if (vec) {
    return act ? launch<T, true, true>(x, scale, bias, y, B, C, HW, G, eps,
                                       stream)
               : launch<T, true, false>(x, scale, bias, y, B, C, HW, G, eps,
                                        stream);
  }
  return act ? launch<T, false, true>(x, scale, bias, y, B, C, HW, G, eps,
                                      stream)
             : launch<T, false, false>(x, scale, bias, y, B, C, HW, G, eps,
                                       stream);
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
    return dispatch<float>(x, s, b, y, B, C, HW, G, eps, act, vec, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, s, b, y, B, C, HW, G, eps, act, vec,
                                   st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
