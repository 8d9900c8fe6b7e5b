// The per-block device sequences of the fused iResBlock pair for Hopper
// (sm_90a), NCHW: kernel 3's forward (`fwd<C, T>`) and kernel 4's backward
// (`bwd<C, T>`), their scratch sizes, the layer epilogues and the row-wise
// and reduction kernels, templated on the storage type T of the
// temporaries: float, or bfloat16 in the bfloat16 mode. fused_block.cu runs
// them for one block and fused_stack.cu for each block of a stack, so both
// give the same bits for the same block in either mode. The arithmetic,
// the bound and the design are in the note of fused_block.cu. Each library
// includes this header from one source. In float32 the forward's 512-wide
// products run the `wgmma` GEMM of lipnet_wgmma.cuh on W1 and W1^T split
// once per call (make_planes) and the backward's
// lipnet::gemm_3xtf32_kernel (lipnet_ops.cuh); in bfloat16 all of them run
// lipnet::wgmma_bf16_kernel (lipnet_wgmma_bf16.cuh).

#pragma once

#include <type_traits>

#include "lipnet_ops.cuh"
#include "lipnet_wgmma.cuh"
#include "lipnet_wgmma_bf16.cuh"

namespace fused_ops {

using lipnet::Geometry;
using lipnet::load4;
using lipnet::put;
using lipnet::rnd;
using lipnet::Store;
using lipnet::store4;
using lipnet::to_f32;

constexpr float kInvTwoPi = 0.159154943091895336f;
constexpr float kSig2 = 39.4784176043574344f;  // (2 pi)^2
constexpr int kRowThreads = 256;               // 8 warps
constexpr int kWarps = kRowThreads / 32;
constexpr int kWgradChannelsPerWarp = 4;
// C * (H + 2) * (W + 2): the backward's narrow_wgrad_kernel holds two such
// planes of floats in dynamic shared memory, at most the 227 KB (232 448
// bytes) a block may opt in to on Hopper. CelebA's first flow scale,
// 12 x 32 x 32, takes 13 872 (111 KB for the two).
constexpr int kMaxPadded = 232448 / (2 * 4);

// sigma(z) = sin(2 pi z) / (2 pi), sigma'(z) = cos(2 pi z)
__device__ __forceinline__ void act(float z, float* s, float* d) {
  float sn, cs;
  sincospif(2.f * z, &sn, &cs);
  *s = sn * kInvTwoPi;
  *d = cs;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// ---- epilogues ----
// T is the storage type of the 512-wide and narrow temporaries: float, or
// bfloat16 in the bfloat16 mode, which rounds each value where the TPU
// kernel's `.astype(cdt)` rounds it (lipnet::rnd, the identity for float:
// the float instantiations compute what they always did).

// sigma and sigma' of a value, each rounded to T
template <class T>
__device__ __forceinline__ void act_r(float z, float* s, float* d) {
  act(z, s, d);
  *s = lipnet::rnd<T>(*s);
  *d = lipnet::rnd<T>(*d);
}

// layer 0: z1 = [[s] + b0]; s1 = sigma(z1) [+ hp]; d1 = sigma'(z1);
// sin1 = sigma(z1) where asked ([.] rounds to T)
template <class T>
struct Layer0T {
  const T* bias;
  const T* hp;
  T* s1;
  T* d1;
  T* sin1;
  int I;
  __device__ void operator()(int64_t idx, int b, int o, float s) const {
    float sn, cs;
    act_r<T>(rnd<T>(rnd<T>(s) + to_f32(bias[o])), &sn, &cs);
    if (sin1) put(sin1 + idx, sn);
    put(s1 + idx, hp ? rnd<T>(sn + to_f32(hp[b * I + o])) : sn);
    put(d1 + idx, cs);
  }
};
using Layer0 = Layer0T<float>;

// layer 1: z2 = [[s] + b1]; s2 = sigma(z2); d2 = sigma'(z2)
template <class T>
struct Layer1T {
  const T* bias;
  T* s2;
  T* d2;
  __device__ void operator()(int64_t idx, int, int m, float4 s) const {
    const float bm = to_f32(bias[m]);
    float4 sv, dv;
    act_r<T>(rnd<T>(rnd<T>(s.x) + bm), &sv.x, &dv.x);
    act_r<T>(rnd<T>(rnd<T>(s.y) + bm), &sv.y, &dv.y);
    act_r<T>(rnd<T>(rnd<T>(s.z) + bm), &sv.z, &dv.z);
    act_r<T>(rnd<T>(rnd<T>(s.w) + bm), &sv.w, &dv.w);
    store4(s2 + idx, sv);
    store4(d2 + idx, dv);
  }
  __device__ void prefetch(int64_t) const {}
};
using Layer1 = Layer1T<float>;

// layer 2: y = [x] + (s + b2), float32
template <class T>
struct Layer2T {
  const float* x;
  const T* bias;
  float* y;
  __device__ void operator()(int64_t idx, int, int c, float s) const {
    y[idx] = rnd<T>(x[idx]) + (s + to_f32(bias[c]));
  }
};

// the tangent J vareps: a = [s]; t = [d * a]
template <class T>
struct TangentT {
  const T* d;
  T* a;
  T* t;
  __device__ void operator()(int64_t idx, int, int, float s) const {
    put(a + idx, s);
    put(t + idx, to_f32(d[idx]) * rnd<T>(s));
  }
  __device__ void operator()(int64_t idx, int, int, float4 s) const {
    const float4 dv = load4(d + idx);
    store4(a + idx, s);
    store4(t + idx, make_float4(dv.x * rnd<T>(s.x), dv.y * rnd<T>(s.y),
                                dv.z * rnd<T>(s.z), dv.w * rnd<T>(s.w)));
  }
};

// out = [[s] * d] or [s], float32: the last layer of J^T, D0 only for a
// pre-activated block
template <class T>
struct OptDMulT {
  const T* d;
  float* out;
  __device__ void operator()(int64_t idx, int, int, float s) const {
    out[idx] = d ? rnd<T>(rnd<T>(s) * to_f32(d[idx])) : rnd<T>(s);
  }
};

// ---- elementwise and reduction kernels ----

// The narrow inputs of a block in the storage type, each written where
// its pointer is given: s0 = [sigma([x])], d0 = [sigma'([x])] (a
// pre-activated block) and t0 = [d0 [eps]] where given; vv = [lbar[b] u];
// xc = [x], ec = [eps], yc = [ybar] (the bfloat16 mode's copies).
template <class T>
struct NarrowPre {
  const float* x;
  const float* eps;
  const float* u;
  const float* lbar;
  const float* ybar;
  T* s0;
  T* d0;
  T* t0;
  T* vv;
  T* xc;
  T* ec;
  T* yc;
};

template <class T>
__global__ void narrow_pre_kernel(NarrowPre<T> q, int64_t n,
                                  int64_t per_sample) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (q.s0) {
      float s, d;
      act_r<T>(rnd<T>(q.x[i]), &s, &d);
      put(q.s0 + i, s);
      put(q.d0 + i, d);
      if (q.t0) put(q.t0 + i, d * rnd<T>(q.eps[i]));
    }
    if (q.vv) put(q.vv + i, q.lbar[i / per_sample] * q.u[i]);
    if (q.xc) put(q.xc + i, q.x[i]);
    if (q.ec) put(q.ec + i, q.eps[i]);
    if (q.yc) put(q.yc + i, q.ybar[i]);
  }
}

// out = a + b, and outc = [out] where given
template <class T>
__global__ void add_kernel(const float* __restrict__ a,
                           const float* __restrict__ b, float* out, T* outc,
                           int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    out[i] = a[i] + b[i];
    if (outc) put(outc + i, out[i]);
  }
}

// xbar = ybar + [d0 s0b] - (2pi)^2 [[s0 eps] t0b] (d0 given) or ybar + s0b
template <class T>
__global__ void xbar_kernel(const float* __restrict__ ybar,
                            const T* __restrict__ s0b,
                            const T* __restrict__ d0,
                            const T* __restrict__ s0,
                            const T* __restrict__ eps,
                            const T* __restrict__ t0b, float* xbar,
                            int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    xbar[i] = d0 ? ybar[i] + rnd<T>(to_f32(d0[i]) * to_f32(s0b[i])) -
                       kSig2 * rnd<T>(rnd<T>(to_f32(s0[i]) * to_f32(eps[i])) *
                                      to_f32(t0b[i]))
                 : ybar[i] + to_f32(s0b[i]);
}

// out[b] = sum_i a[b, i] b[b, i], one block per sample, in a fixed order
__global__ void __launch_bounds__(kRowThreads)
    sample_dot_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* out,
                      int per_sample) {
  __shared__ float red[kRowThreads];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * per_sample;
  float s = 0.f;
  for (int i = threadIdx.x; i < per_sample; i += kRowThreads)
    s = fmaf(a[base + i], b[base + i], s);
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = kRowThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = red[0];
}

// One warp per row of `len` values (a sample's channel):
//   zb = [d sb] - (2pi)^2 sv [a tb] (float32: the float32 constant
//   promotes the sigma'' term, `fused_block.py:418`), ab = [d tb];
//   zb goes to zf (float32) where given, else to zhi = [zb] and, where
//   given, zlo = [zb - zhi] (the bfloat16 GEMM's two pairs for it); ab to ab;
//   rs[row] = sum zb, and hs[row] = sum sb (the incoming sb) where given.
// The float mode runs it in place: zf = sb (or zhi = sb), ab = tb.
template <class T>
__global__ void __launch_bounds__(kRowThreads)
    act_bwd_kernel(const T* __restrict__ d, const T* __restrict__ sv,
                   const T* __restrict__ a, const T* sb, const T* tb,
                   float* zf, T* zhi, T* zlo, T* ab, float* rs, float* hs,
                   int64_t rows, int len) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int64_t base = row * len;
  float zs = 0.f, ss = 0.f;
  for (int p = lane; p < len; p += 32) {
    const int64_t i = base + p;
    const float s_b = to_f32(sb[i]), t_b = to_f32(tb[i]), dd = to_f32(d[i]);
    const float zb = rnd<T>(dd * s_b) -
                     kSig2 * to_f32(sv[i]) * rnd<T>(to_f32(a[i]) * t_b);
    ss += s_b;
    zs += zb;
    if (zf) {
      zf[i] = zb;
    } else {
      put(zhi + i, zb);
      if (zlo) put(zlo + i, zb - rnd<T>(zb));
    }
    put(ab + i, dd * t_b);
  }
  zs = warp_sum(zs);
  ss = warp_sum(ss);
  if (lane == 0) {
    rs[row] = zs;
    if (hs) hs[row] = ss;
  }
}

// out[row] = sum of the row's `len` values, one warp per row
template <class T>
__global__ void __launch_bounds__(kRowThreads)
    row_sum_kernel(const T* __restrict__ x, float* out, int64_t rows,
                   int len) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
  for (int p = lane; p < len; p += 32) s += to_f32(x[row * len + p]);
  s = warp_sum(s);
  if (lane == 0) out[row] = s;
}

// out[j] = sum_b part[b, j], b in order
__global__ void batch_sum_kernel(const float* __restrict__ part, float* out,
                                 int nb, int64_t n) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int b = 0; b < nb; ++b) s += part[b * n + j];
  out[j] = s;
}

// The weight gradient of a narrow 3x3 conv, one sample's partial:
//   part[b, i, c, tap] = sum_p wide0[b, i, p] nar0[b, c, p + off(tap)]
//                               + wide1[b, i, p] nar1[b, c, p + off(tap)]
// with off(tap) = (dy - 1, dx - 1): the gradient of a conv C -> I whose
// input is nar and output cotangent wide (w0g). With kReverse the offset is
// subtracted and the partial is stored as part[b, c, i, tap]: the gradient
// of a conv I -> C whose input is wide and output cotangent nar (w2g).
// A block holds both narrow tensors of its sample with a zero border in
// shared memory; each warp walks kWgradChannelsPerWarp wide channels, a
// lane every 32nd pixel, and sums its 9*C products over the warp in a
// fixed order. The operands load as their storage types (W0, W1: the wide
// ones; N: the narrow ones) and sum in float32.
template <int C, bool kReverse, class W0, class W1, class N>
__global__ void __launch_bounds__(kRowThreads)
    narrow_wgrad_kernel(const W0* __restrict__ wide0,
                        const N* __restrict__ nar0,
                        const W1* __restrict__ wide1,
                        const N* __restrict__ nar1, float* part, int I,
                        int H, int W) {
  extern __shared__ float pad[];  // [2][C][H + 2][W + 2]
  const int b = blockIdx.y;
  const int W2 = W + 2, plane = (H + 2) * W2, hw = H * W;
  for (int j = threadIdx.x; j < 2 * C * plane; j += kRowThreads) {
    const int k = j / (C * plane), r = j % (C * plane);
    const int c = r / plane, q = r % plane;
    const int yy = q / W2 - 1, xx = q % W2 - 1;
    const N* src = k ? nar1 : nar0;
    pad[j] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                 ? to_f32(
                       src[(static_cast<int64_t>(b) * C + c) * hw + yy * W + xx])
                 : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int rep = 0; rep < kWgradChannelsPerWarp; ++rep) {
    const int i = (blockIdx.x * kWgradChannelsPerWarp + rep) * kWarps +
                  threadIdx.x / 32;
    if (i >= I) break;
    float acc[C * 9];
#pragma unroll
    for (int j = 0; j < C * 9; ++j) acc[j] = 0.f;
    const int64_t row = (static_cast<int64_t>(b) * I + i) * hw;
    for (int p = lane; p < hw; p += 32) {
      const float u0 = to_f32(wide0[row + p]), u1 = to_f32(wide1[row + p]);
      const int y = p / W, x = p % W;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int q = kReverse ? (y + 2 - dy) * W2 + (x + 2 - dx)
                                 : (y + dy) * W2 + (x + dx);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float& s = acc[c * 9 + dy * 3 + dx];
            s = fmaf(u0, pad[c * plane + q], s);
            s = fmaf(u1, pad[(C + c) * plane + q], s);
          }
        }
    }
#pragma unroll
    for (int j = 0; j < C * 9; ++j) acc[j] = warp_sum(acc[j]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int64_t idx =
              kReverse ? ((static_cast<int64_t>(b) * C + c) * I + i) * 9 + t
                       : ((static_cast<int64_t>(b) * I + i) * C + c) * 9 + t;
          part[idx] = acc[c * 9 + t];
        }
    }
  }
}

// ---- host side ----

inline int grid_1d(int64_t n) {
  const int64_t blocks = (n + 255) / 256;
  return static_cast<int>(blocks < 4096 ? blocks : 4096);
}

#define RETURN_IF(expr)                         \
  do {                                          \
    const cudaError_t err_ = (expr);            \
    if (err_ != cudaSuccess) return err_;       \
  } while (0)

template <class T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

// narrow_wgrad_kernel's launch: a block a (sample, 32 wide channels), both
// narrow tensors' padded planes in dynamic shared memory, 2*C*(H+2)*(W+2)
// floats (111 KB at C = 12 on 32x32, past the 48 KB of a launch without an
// opt-in; bad_geometry caps it at kMaxPadded). The attribute is set at
// every launch, as conv_in sets its own.
template <int C, bool kReverse, class W0, class W1, class N>
cudaError_t narrow_wgrad(const Geometry& g, const W0* wide0, const N* nar0,
                         const W1* wide1, const N* nar1, float* part,
                         cudaStream_t st) {
  const int ch_per_block = kWarps * kWgradChannelsPerWarp;
  const dim3 grid((g.I + ch_per_block - 1) / ch_per_block, g.B);
  const int smem =
      static_cast<int>(2 * C * (g.H + 2) * (g.W + 2) * sizeof(float));
  RETURN_IF(cudaFuncSetAttribute(narrow_wgrad_kernel<C, kReverse, W0, W1, N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem));
  narrow_wgrad_kernel<C, kReverse, W0, W1, N>
      <<<grid, kRowThreads, smem, st>>>(wide0, nar0, wide1, nar1, part, g.I,
                                        g.H, g.W);
  return cudaGetLastError();
}


// Consecutive regions of a scratch buffer: every region the sizes below
// count is a multiple of 16 bytes for the geometries the entry points take
// (H*W and I multiples of 4 in float, of 8 in bfloat16).
struct Carve {
  char* p;
  template <class T>
  T* take(int64_t n) {
    T* q = reinterpret_cast<T*>(p);
    p += n * static_cast<int64_t>(sizeof(T));
    return q;
  }
};

// fwd's temporaries: 4*B*I*H*W + 5*B*C*H*W floats
inline int64_t fwd_scratch(const Geometry& g, int C) {
  const int64_t hw = static_cast<int64_t>(g.H) * g.W;
  return 4 * g.B * g.I * hw + 5 * g.B * C * hw;
}

// fwd's temporaries in bytes for the storage type T: in bfloat16,
// 8*B*I*H*W + 18*B*C*H*W bytes (the wide ones and five narrow ones in
// bfloat16, acc and J^T u in float32)
template <class T>
int64_t fwd_scratch_bytes(const Geometry& g, int C) {
  if (!kBf16<T>) return 4 * fwd_scratch(g, C);
  const int64_t hw = static_cast<int64_t>(g.H) * g.W;
  return 8 * g.B * g.I * hw + 18 * g.B * C * hw;
}

// one block's weight planes for fwd: W1 and W1^T as TF32 hi and lo
// (lipnet::split_weights), 4*I*I8 floats with I8 = I rounded up to 8
inline int64_t plane_floats(int I) { return 2 * lipnet::split_floats(I, I); }

// the planes of `count` blocks (w1 and w1t [count, I, I]) at
// planes + j * plane_floats(I): W1 hi, W1 lo, W1^T hi, W1^T lo
inline cudaError_t make_planes(const float* w1, const float* w1t, int count,
                               int I, float* planes, cudaStream_t st) {
  const int64_t ii = static_cast<int64_t>(I) * I, per = plane_floats(I);
  RETURN_IF(lipnet::split_weights(w1, ii, planes, per, count, I, I, st));
  return lipnet::split_weights(w1t, ii, planes + lipnet::split_floats(I, I),
                               per, count, I, I, st);
}

inline int64_t bwd_scratch(const Geometry& g, int C) {
  const int64_t hw = static_cast<int64_t>(g.H) * g.W;
  const int64_t b = g.B, i = g.I;
  return 11 * b * i * hw + 6 * b * C * hw + b * i * i + 2 * b * i * 9 * C +
         2 * b * i + b * C;
}

// bwd's scratch in bytes for the storage type T: in bfloat16, 28*B*I*H*W +
// 16*B*C*H*W + 4*(B*I*I + 18*B*I*C + 2*B*I + B*C) bytes (twelve wide
// temporaries in bfloat16 and z1b in float32; eight narrow ones in
// bfloat16; the float32 partials)
template <class T>
int64_t bwd_scratch_bytes(const Geometry& g, int C) {
  if (!kBf16<T>) return 4 * bwd_scratch(g, C);
  const int64_t hw = static_cast<int64_t>(g.H) * g.W;
  const int64_t b = g.B, i = g.I;
  return 28 * b * i * hw + 16 * b * C * hw +
         4 * (b * i * i + 2 * b * i * 9 * C + 2 * b * i + b * C);
}

// Kernel 3's sequence for one block. w1, w1t: W1 and W1^T as the block's
// make_planes (SplitWeight, the float mode's `wgmma` product) or bfloat16
// (the bfloat16 GEMM); the other weights, the biases and hp in T.
template <int C, class T, class Mid>
cudaError_t fwd(const Geometry& g, const float* x, const float* eps,
                const T* w0, const Mid& w1, const Mid& w1t, const T* w2,
                const T* w2t, const T* w0t, const T* b0, const T* b1,
                const T* b2, const T* hp, const float* coeffs, int n_terms,
                bool preact, float* y, float* u, float* logdet,
                void* scratch, cudaStream_t st) {
  const int64_t hw = static_cast<int64_t>(g.H) * g.W;
  const int64_t nn = g.B * C * hw, nw = g.B * g.I * hw;
  Carve sc{static_cast<char*>(scratch)};
  T* s1 = sc.take<T>(nw);
  T* d1 = sc.take<T>(nw);
  T* s2 = sc.take<T>(nw);
  T* d2 = sc.take<T>(nw);
  T* s0buf = sc.take<T>(nn);
  T* d0 = sc.take<T>(nn);
  T* v = sc.take<T>(nn);
  float* acc = sc.take<float>(nn);
  float* jtu = sc.take<float>(nn);
  // the bfloat16 mode's copies of vareps and u
  T* ec = kBf16<T> ? sc.take<T>(nn) : nullptr;
  T* uc = kBf16<T> ? sc.take<T>(nn) : nullptr;
  // the chain's temporaries take s1 and s2 once layer 2 has read them
  T* t1 = s1;
  T* t2 = s2;

  const T* s0;
  const T* eps_c;
  const T* jin;
  if constexpr (kBf16<T>) {
    narrow_pre_kernel<<<grid_1d(nn), 256, 0, st>>>(
        NarrowPre<T>{x, eps, nullptr, nullptr, nullptr,
                     preact ? s0buf : nullptr, d0, nullptr, nullptr,
                     preact ? nullptr : s0buf, ec, nullptr},
        nn, C * hw);
    RETURN_IF(cudaGetLastError());
    s0 = s0buf;
    eps_c = ec;
    jin = uc;
  } else {
    s0 = x;
    eps_c = eps;
    jin = u;
    if (preact) {
      narrow_pre_kernel<<<grid_1d(nn), 256, 0, st>>>(
          NarrowPre<T>{x, eps, nullptr, nullptr, nullptr, s0buf, d0}, nn,
          C * hw);
      RETURN_IF(cudaGetLastError());
      s0 = s0buf;
    }
  }
  if (!preact) d0 = nullptr;
  RETURN_IF(lipnet::conv_in<C>(
      g, s0, w0, Layer0T<T>{b0, hp, s1, d1, nullptr, g.I}, st));
  RETURN_IF(lipnet::product(g, w1, s1, Layer1T<T>{b1, s2, d2}, st));
  RETURN_IF(lipnet::conv_out<C>(g, s2, w2, Layer2T<T>{x, b2, y}, st));
  RETURN_IF(lipnet::run_chain<C>(g, eps_c, d2, d1, d0, w2t, w1t, w0t, coeffs,
                                 n_terms, acc, v, t1, t2, st));
  add_kernel<<<grid_1d(nn), 256, 0, st>>>(eps, acc, u, uc, nn);
  RETURN_IF(cudaGetLastError());
  RETURN_IF(lipnet::launch_jt<C>(g, jin, w2t, d2, w1t, d1, w0t,
                                 OptDMulT<T>{d0, jtu}, t1, t2, st));
  sample_dot_kernel<<<g.B, kRowThreads, 0, st>>>(jtu, eps, logdet,
                                                 static_cast<int>(C * hw));
  return cudaGetLastError();
}

// the layer-1 weight gradient's partials and W1^T on z2b: the float mode's
// 3xTF32 products, z2b in place in zb2
inline cudaError_t layer1_products(const Geometry& g, const float* w1t,
                                   const float* zb2, const float*,
                                   const float* ab2, const float* s1,
                                   const float* t1, float* p_w1, float* s1b,
                                   cudaStream_t st) {
  const int64_t iw = static_cast<int64_t>(g.I) * g.H * g.W;
  const lipnet::GemmArgs wg{{zb2, ab2}, {s1, t1}, 2, iw, iw,
                            g.I, g.I, g.H * g.W};
  RETURN_IF(lipnet::gemm<true>(wg, g.B, Store{p_w1}, st));
  return lipnet::mat_wide(g, w1t, zb2, Store{s1b}, st);
}

// ... and the bfloat16 mode's: z2b as its hi (zb2) and lo parts, three
// pairs for the weight gradient and two for W1^T z2b
inline cudaError_t layer1_products(const Geometry& g, const __nv_bfloat16* w1t,
                                   const __nv_bfloat16* zb2,
                                   const __nv_bfloat16* z_lo,
                                   const __nv_bfloat16* ab2,
                                   const __nv_bfloat16* s1,
                                   const __nv_bfloat16* t1, float* p_w1,
                                   __nv_bfloat16* s1b, cudaStream_t st) {
  const int64_t iw = static_cast<int64_t>(g.I) * g.H * g.W;
  const lipnet::GemmBf16Args wg{{zb2, z_lo, ab2}, {s1, s1, t1}, 3, iw, iw,
                                g.I, g.I, g.H * g.W};
  RETURN_IF(lipnet::gemm_bf16<true>(wg, g.B, Store{p_w1}, st));
  return lipnet::mat_wide(g, w1t, zb2, lipnet::StoreT<__nv_bfloat16>{s1b},
                          st, z_lo);
}

// Kernel 4's sequence for one block; the weights, biases and hp in T.
template <int C, class T>
cudaError_t bwd(const Geometry& g, const float* x, const float* eps,
                const float* u, const float* ybar, const float* lbar,
                const T* w0, const T* w1, const T* w2t, const T* w1t,
                const T* w0t, const T* b0, const T* b1, const T* hp,
                bool preact, float* xbar, float* w0g, float* w1g, float* w2g,
                float* b0g, float* b1g, float* b2g, float* hbar,
                void* scratch, cudaStream_t st) {
  const int64_t hw = static_cast<int64_t>(g.H) * g.W;
  const int64_t nn = g.B * C * hw, nw = g.B * g.I * hw;
  const int64_t I = g.I;
  Carve sc{static_cast<char*>(scratch)};
  T *sin1 = sc.take<T>(nw), *s1 = sc.take<T>(nw), *d1 = sc.take<T>(nw),
    *s2 = sc.take<T>(nw), *d2 = sc.take<T>(nw), *a1 = sc.take<T>(nw),
    *t1 = sc.take<T>(nw), *a2 = sc.take<T>(nw), *t2 = sc.take<T>(nw),
    *zb2 = sc.take<T>(nw), *ab2 = sc.take<T>(nw);
  T *s0buf = sc.take<T>(nn), *d0 = sc.take<T>(nn), *t0buf = sc.take<T>(nn),
    *vv = sc.take<T>(nn), *s0b = sc.take<T>(nn), *t0b = sc.take<T>(nn);
  // layer 1's cotangents take s2 and a2 once layer 2's backward has read
  // them; the float mode writes z2b and z1b in place, the bfloat16 mode
  // keeps z2b's lo part, z1b (float32) and the copies of vareps and ybar
  // in regions of their own
  T* s1b = s2;
  T* t1b = a2;
  T* z_lo = kBf16<T> ? sc.take<T>(nw) : nullptr;
  float* z1b =
      kBf16<T> ? sc.take<float>(nw) : reinterpret_cast<float*>(s1b);
  T* ec = kBf16<T> ? sc.take<T>(nn) : nullptr;
  T* yc = kBf16<T> ? sc.take<T>(nn) : nullptr;
  // the partials last: the bias ones (B*C floats) end off 16 bytes
  float *p_w1 = sc.take<float>(g.B * I * I),
        *p_w0 = sc.take<float>(g.B * I * 9 * C),
        *p_w2 = sc.take<float>(g.B * I * 9 * C),
        *r_b0 = sc.take<float>(g.B * I), *r_b1 = sc.take<float>(g.B * I),
        *r_b2 = sc.take<float>(g.B * C);
  const T *s0, *t0, *eps_c, *ybar_c;
  if constexpr (kBf16<T>) {
    narrow_pre_kernel<<<grid_1d(nn), 256, 0, st>>>(
        NarrowPre<T>{x, eps, u, lbar, ybar, preact ? s0buf : nullptr, d0,
                     t0buf, vv, preact ? nullptr : s0buf, ec, yc},
        nn, C * hw);
    s0 = s0buf;
    t0 = preact ? t0buf : ec;
    eps_c = ec;
    ybar_c = yc;
  } else {
    narrow_pre_kernel<<<grid_1d(nn), 256, 0, st>>>(
        NarrowPre<T>{x, eps, u, lbar, nullptr, preact ? s0buf : nullptr, d0,
                     t0buf, vv},
        nn, C * hw);
    s0 = preact ? s0buf : x;
    t0 = preact ? t0buf : eps;
    eps_c = eps;
    ybar_c = ybar;
  }
  RETURN_IF(cudaGetLastError());
  if (!preact) d0 = nullptr;

  // the primal and the tangent J vareps
  RETURN_IF(lipnet::conv_in<C>(
      g, s0, w0, Layer0T<T>{b0, hp, s1, d1, sin1, g.I}, st));
  RETURN_IF(lipnet::mat_wide(g, w1, s1, Layer1T<T>{b1, s2, d2}, st));
  RETURN_IF(lipnet::conv_in<C>(g, t0, w0, TangentT<T>{d1, a1, t1}, st));
  RETURN_IF(lipnet::mat_wide(g, w1, t1, TangentT<T>{d2, a2, t2}, st));

  // layer 2
  RETURN_IF(lipnet::conv_in<C>(g, ybar_c, w2t, lipnet::StoreT<T>{zb2}, st));
  RETURN_IF(lipnet::conv_in<C>(g, vv, w2t, lipnet::StoreT<T>{ab2}, st));
  const int64_t rows = g.B * I;
  const int row_blocks = static_cast<int>((rows + kWarps - 1) / kWarps);
  if constexpr (kBf16<T>) {
    act_bwd_kernel<<<row_blocks, kRowThreads, 0, st>>>(
        d2, s2, a2, zb2, ab2, static_cast<float*>(nullptr), zb2, z_lo, ab2,
        r_b1, static_cast<float*>(nullptr), rows, static_cast<int>(hw));
  } else {
    act_bwd_kernel<<<row_blocks, kRowThreads, 0, st>>>(
        d2, s2, a2, zb2, ab2, zb2, static_cast<T*>(nullptr),
        static_cast<T*>(nullptr), ab2, r_b1, static_cast<float*>(nullptr),
        rows, static_cast<int>(hw));
  }
  RETURN_IF(cudaGetLastError());
  RETURN_IF((narrow_wgrad<C, true>(g, s2, ybar_c, t2, vv, p_w2, st)));
  const int64_t nrows = g.B * C;
  row_sum_kernel<<<static_cast<int>((nrows + kWarps - 1) / kWarps),
                   kRowThreads, 0, st>>>(ybar_c, r_b2, nrows,
                                         static_cast<int>(hw));
  RETURN_IF(cudaGetLastError());

  // layer 1: w1g partials, then the cotangents through W1^T
  RETURN_IF(layer1_products(g, w1t, zb2, z_lo, ab2, s1, t1, p_w1, s1b, st));
  RETURN_IF(lipnet::mat_wide(g, w1t, ab2, lipnet::StoreT<T>{t1b}, st));
  act_bwd_kernel<<<row_blocks, kRowThreads, 0, st>>>(
      d1, sin1, a1, s1b, t1b, z1b, static_cast<T*>(nullptr),
      static_cast<T*>(nullptr), t1b, r_b0, hp ? hbar : nullptr, rows,
      static_cast<int>(hw));
  RETURN_IF(cudaGetLastError());

  // layer 0 (z1b and t1b now hold z1b and a1b)
  RETURN_IF((narrow_wgrad<C, false>(g, z1b, s0, t1b, t0, p_w0, st)));
  RETURN_IF(lipnet::conv_out<C>(g, z1b, w0t, lipnet::StoreT<T>{s0b}, st));
  if (preact)
    RETURN_IF(lipnet::conv_out<C>(g, t1b, w0t, lipnet::StoreT<T>{t0b}, st));
  xbar_kernel<<<grid_1d(nn), 256, 0, st>>>(ybar, s0b, d0, s0, eps_c, t0b,
                                           xbar, nn);
  RETURN_IF(cudaGetLastError());

  // the batch sums, in sample order
  const struct {
    const float* part;
    float* out;
    int64_t n;
  } sums[] = {{p_w0, w0g, I * 9 * C}, {p_w1, w1g, I * I},
              {p_w2, w2g, I * 9 * C}, {r_b0, b0g, I},
              {r_b1, b1g, I},         {r_b2, b2g, C}};
  for (const auto& s : sums) {
    batch_sum_kernel<<<static_cast<int>((s.n + 255) / 256), 256, 0, st>>>(
        s.part, s.out, g.B, s.n);
    RETURN_IF(cudaGetLastError());
  }
  return cudaSuccess;
}

// H*W and I multiples of 4, of 8 in bfloat16: 16-byte rows of the GEMMs;
// C*(H+2)*(W+2) at most kMaxPadded: narrow_wgrad's shared planes
inline bool bad_geometry(int B, int C, int H, int W, int I,
                         bool bf16 = false) {
  const int align = bf16 ? 8 : 4;
  return B <= 0 || H <= 0 || W <= 0 || I <= 0 || (C != 3 && C != 12) ||
         (H * W) % align || I % align || C * (H + 2) * (W + 2) > kMaxPadded;
}

}  // namespace fused_ops
