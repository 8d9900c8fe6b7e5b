// The per-block device sequences of the fused iResBlock pair for Hopper
// (sm_90a), NCHW, float32: kernel 3's forward (`fwd<C>`) and kernel 4's
// backward (`bwd<C>`), their scratch sizes, the layer epilogues and the
// row-wise and reduction kernels. fused_block.cu runs them for one block
// and fused_stack.cu for each block of a stack, so both give the same bits
// for the same block. The arithmetic, the bound and the design are in the
// note of fused_block.cu. Each library includes this header from one source.
// The forward's 512-wide products run the `wgmma` GEMM of lipnet_wgmma.cuh
// on W1 and W1^T split once per call (make_planes); the backward's run
// lipnet::gemm_3xtf32_kernel (lipnet_ops.cuh).

#pragma once

#include "lipnet_ops.cuh"
#include "lipnet_wgmma.cuh"

namespace fused_ops {

using lipnet::Geometry;
using lipnet::Store;

constexpr float kInvTwoPi = 0.159154943091895336f;
constexpr float kSig2 = 39.4784176043574344f;  // (2 pi)^2
constexpr int kRowThreads = 256;               // 8 warps
constexpr int kWarps = kRowThreads / 32;
constexpr int kWgradChannelsPerWarp = 4;
constexpr int kMaxPadded = 6144;  // C * (H + 2) * (W + 2): 48 KB for two

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

// layer 0: z1 = s + b0; s1 = sigma(z1) [+ hp]; d1 = sigma'(z1);
// sin1 = sigma(z1) where asked
struct Layer0 {
  const float* bias;
  const float* hp;
  float* s1;
  float* d1;
  float* sin1;
  int I;
  __device__ void operator()(int64_t idx, int b, int o, float s) const {
    float sn, cs;
    act(s + bias[o], &sn, &cs);
    if (sin1) sin1[idx] = sn;
    s1[idx] = hp ? sn + hp[b * I + o] : sn;
    d1[idx] = cs;
  }
};

// layer 1: z2 = s + b1; s2 = sigma(z2); d2 = sigma'(z2)
struct Layer1 {
  const float* bias;
  float* s2;
  float* d2;
  __device__ void operator()(int64_t idx, int, int m, float4 s) const {
    const float bm = bias[m];
    float4 sv, dv;
    act(s.x + bm, &sv.x, &dv.x);
    act(s.y + bm, &sv.y, &dv.y);
    act(s.z + bm, &sv.z, &dv.z);
    act(s.w + bm, &sv.w, &dv.w);
    *reinterpret_cast<float4*>(s2 + idx) = sv;
    *reinterpret_cast<float4*>(d2 + idx) = dv;
  }
  __device__ void prefetch(int64_t) const {}
};

// layer 2: y = x + (s + b2)
struct Layer2 {
  const float* x;
  const float* bias;
  float* y;
  __device__ void operator()(int64_t idx, int, int c, float s) const {
    y[idx] = x[idx] + (s + bias[c]);
  }
};

// the tangent J vareps: a = s; t = d * s
struct Tangent {
  const float* d;
  float* a;
  float* t;
  __device__ void operator()(int64_t idx, int, int, float s) const {
    a[idx] = s;
    t[idx] = d[idx] * s;
  }
  __device__ void operator()(int64_t idx, int, int, float4 s) const {
    const float4 dv = *reinterpret_cast<const float4*>(d + idx);
    *reinterpret_cast<float4*>(a + idx) = s;
    *reinterpret_cast<float4*>(t + idx) =
        make_float4(dv.x * s.x, dv.y * s.y, dv.z * s.z, dv.w * s.w);
  }
};

// out = [d *] s: the last layer of J^T, D0 only for a pre-activated block
struct OptDMul {
  const float* d;
  float* out;
  __device__ void operator()(int64_t idx, int, int, float s) const {
    out[idx] = d ? s * d[idx] : s;
  }
};

// ---- elementwise and reduction kernels ----

// s0 = sigma(x), d0 = sigma'(x), t0 = d0 * vareps where s0 is given (a
// pre-activated block; t0 where given); vv = lbar[b] * u where vv is given
__global__ void narrow_pre_kernel(const float* __restrict__ x,
                                  const float* __restrict__ eps,
                                  const float* __restrict__ u,
                                  const float* __restrict__ lbar,
                                  float* s0, float* d0, float* t0, float* vv,
                                  int64_t n, int64_t per_sample) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (s0) {
      float s, d;
      act(x[i], &s, &d);
      s0[i] = s;
      d0[i] = d;
      if (t0) t0[i] = d * eps[i];
    }
    if (vv) vv[i] = lbar[i / per_sample] * u[i];
  }
}

__global__ void add_kernel(const float* __restrict__ a,
                           const float* __restrict__ b, float* out,
                           int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[i] = a[i] + b[i];
}

// xbar = ybar + d0 s0b - (2pi)^2 s0 vareps t0b (d0 given) or ybar + s0b
__global__ void xbar_kernel(const float* __restrict__ ybar,
                            const float* __restrict__ s0b,
                            const float* __restrict__ d0,
                            const float* __restrict__ s0,
                            const float* __restrict__ eps,
                            const float* __restrict__ t0b, float* xbar,
                            int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    xbar[i] = d0 ? ybar[i] + d0[i] * s0b[i] - kSig2 * (s0[i] * eps[i] * t0b[i])
                 : ybar[i] + s0b[i];
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
//   zb = d sb - (2pi)^2 sv (a tb), ab = d tb, in place over sb and tb;
//   rs[row] = sum zb, and hs[row] = sum sb (the incoming sb) where given.
__global__ void __launch_bounds__(kRowThreads)
    act_bwd_kernel(const float* __restrict__ d, const float* __restrict__ sv,
                   const float* __restrict__ a, float* sb, float* tb,
                   float* rs, float* hs, int64_t rows, int len) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int64_t base = row * len;
  float zs = 0.f, ss = 0.f;
  for (int p = lane; p < len; p += 32) {
    const int64_t i = base + p;
    const float s_b = sb[i], t_b = tb[i], dd = d[i];
    const float zb = dd * s_b - kSig2 * sv[i] * (a[i] * t_b);
    ss += s_b;
    zs += zb;
    sb[i] = zb;
    tb[i] = dd * t_b;
  }
  zs = warp_sum(zs);
  ss = warp_sum(ss);
  if (lane == 0) {
    rs[row] = zs;
    if (hs) hs[row] = ss;
  }
}

// out[row] = sum of the row's `len` values, one warp per row
__global__ void __launch_bounds__(kRowThreads)
    row_sum_kernel(const float* __restrict__ x, float* out, int64_t rows,
                   int len) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
  for (int p = lane; p < len; p += 32) s += x[row * len + p];
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
// fixed order.
template <int C, bool kReverse>
__global__ void __launch_bounds__(kRowThreads)
    narrow_wgrad_kernel(const float* __restrict__ wide0,
                        const float* __restrict__ nar0,
                        const float* __restrict__ wide1,
                        const float* __restrict__ nar1, float* part, int I,
                        int H, int W) {
  extern __shared__ float pad[];  // [2][C][H + 2][W + 2]
  const int b = blockIdx.y;
  const int W2 = W + 2, plane = (H + 2) * W2, hw = H * W;
  for (int j = threadIdx.x; j < 2 * C * plane; j += kRowThreads) {
    const int k = j / (C * plane), r = j % (C * plane);
    const int c = r / plane, q = r % plane;
    const int yy = q / W2 - 1, xx = q % W2 - 1;
    const float* src = k ? nar1 : nar0;
    pad[j] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                 ? src[(static_cast<int64_t>(b) * C + c) * hw + yy * W + xx]
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
      const float u0 = wide0[row + p], u1 = wide1[row + p];
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

// fwd's temporaries: 4*B*I*H*W + 5*B*C*H*W floats
inline int64_t fwd_scratch(const Geometry& g, int C) {
  const int64_t hw = static_cast<int64_t>(g.H) * g.W;
  return 4 * g.B * g.I * hw + 5 * g.B * C * hw;
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

// planes: the block's make_planes
template <int C>
cudaError_t fwd(const Geometry& g, const float* x, const float* eps,
                const float* w0, const float* planes, const float* w2,
                const float* w2t, const float* w0t, const float* b0,
                const float* b1, const float* b2, const float* hp,
                const float* coeffs, int n_terms, bool preact, float* y,
                float* u, float* logdet, float* scratch, cudaStream_t st) {
  const lipnet::SplitWeight w1{planes, g.I, g.I};
  const lipnet::SplitWeight w1t{planes + lipnet::split_floats(g.I, g.I), g.I,
                                g.I};
  const int64_t hw = static_cast<int64_t>(g.H) * g.W;
  const int64_t nn = g.B * C * hw, nw = g.B * g.I * hw;
  float* s1 = scratch;
  float* d1 = s1 + nw;
  float* s2 = d1 + nw;
  float* d2 = s2 + nw;
  float* s0buf = d2 + nw;
  float* d0 = s0buf + nn;
  float* v = d0 + nn;
  float* acc = v + nn;
  float* jtu = acc + nn;
  // the chain's temporaries take s1 and s2 once layer 2 has read them
  float* t1 = s1;
  float* t2 = s2;

  const float* s0 = x;
  if (preact) {
    narrow_pre_kernel<<<grid_1d(nn), 256, 0, st>>>(
        x, eps, nullptr, nullptr, s0buf, d0, nullptr, nullptr, nn, C * hw);
    RETURN_IF(cudaGetLastError());
    s0 = s0buf;
  } else {
    d0 = nullptr;
  }
  RETURN_IF(lipnet::conv_in<C>(g, s0, w0, Layer0{b0, hp, s1, d1, nullptr, g.I},
                               st));
  RETURN_IF(lipnet::product(g, w1, s1, Layer1{b1, s2, d2}, st));
  RETURN_IF(lipnet::conv_out<C>(g, s2, w2, Layer2{x, b2, y}, st));
  RETURN_IF(lipnet::run_chain<C>(g, eps, d2, d1, d0, w2t, w1t, w0t, coeffs,
                                 n_terms, acc, v, t1, t2, st));
  add_kernel<<<grid_1d(nn), 256, 0, st>>>(eps, acc, u, nn);
  RETURN_IF(cudaGetLastError());
  RETURN_IF(lipnet::launch_jt<C>(g, u, w2t, d2, w1t, d1, w0t,
                                 OptDMul{d0, jtu}, t1, t2, st));
  sample_dot_kernel<<<g.B, kRowThreads, 0, st>>>(jtu, eps, logdet,
                                                 static_cast<int>(C * hw));
  return cudaGetLastError();
}

template <int C>
cudaError_t bwd(const Geometry& g, const float* x, const float* eps,
                const float* u, const float* ybar, const float* lbar,
                const float* w0, const float* w1, const float* w2t,
                const float* w1t, const float* w0t, const float* b0,
                const float* b1, const float* hp, bool preact, float* xbar,
                float* w0g, float* w1g, float* w2g, float* b0g, float* b1g,
                float* b2g, float* hbar, float* scratch, cudaStream_t st) {
  const int64_t hw = static_cast<int64_t>(g.H) * g.W;
  const int64_t nn = g.B * C * hw, nw = g.B * g.I * hw;
  const int64_t I = g.I;
  float* p = scratch;
  auto take = [&](int64_t n) {
    float* q = p;
    p += n;
    return q;
  };
  float *sin1 = take(nw), *s1 = take(nw), *d1 = take(nw), *s2 = take(nw),
        *d2 = take(nw), *a1 = take(nw), *t1 = take(nw), *a2 = take(nw),
        *t2 = take(nw), *zb2 = take(nw), *ab2 = take(nw);
  float *s0buf = take(nn), *d0 = take(nn), *t0buf = take(nn), *vv = take(nn),
        *s0b = take(nn), *t0b = take(nn);
  float *p_w1 = take(g.B * I * I), *p_w0 = take(g.B * I * 9 * C),
        *p_w2 = take(g.B * I * 9 * C), *r_b0 = take(g.B * I),
        *r_b1 = take(g.B * I), *r_b2 = take(g.B * C);
  // layer 1's cotangents take s2 and a2 once layer 2's backward has read them
  float* s1b = s2;
  float* t1b = a2;

  narrow_pre_kernel<<<grid_1d(nn), 256, 0, st>>>(
      x, eps, u, lbar, preact ? s0buf : nullptr, d0, t0buf, vv, nn, C * hw);
  RETURN_IF(cudaGetLastError());
  const float* s0 = preact ? s0buf : x;
  const float* t0 = preact ? t0buf : eps;
  if (!preact) d0 = nullptr;

  // the primal and the tangent J vareps
  RETURN_IF(lipnet::conv_in<C>(g, s0, w0, Layer0{b0, hp, s1, d1, sin1, g.I},
                               st));
  RETURN_IF(lipnet::mat_wide(g, w1, s1, Layer1{b1, s2, d2}, st));
  RETURN_IF(lipnet::conv_in<C>(g, t0, w0, Tangent{d1, a1, t1}, st));
  RETURN_IF(lipnet::mat_wide(g, w1, t1, Tangent{d2, a2, t2}, st));

  // layer 2
  RETURN_IF(lipnet::conv_in<C>(g, ybar, w2t, Store{zb2}, st));
  RETURN_IF(lipnet::conv_in<C>(g, vv, w2t, Store{ab2}, st));
  const int64_t rows = g.B * I;
  const int row_blocks = static_cast<int>((rows + kWarps - 1) / kWarps);
  act_bwd_kernel<<<row_blocks, kRowThreads, 0, st>>>(
      d2, s2, a2, zb2, ab2, r_b1, nullptr, rows, static_cast<int>(hw));
  RETURN_IF(cudaGetLastError());
  const int ch_per_block = kWarps * kWgradChannelsPerWarp;
  const dim3 wgrid((g.I + ch_per_block - 1) / ch_per_block, g.B);
  const size_t smem = 2 * C * (g.H + 2) * (g.W + 2) * sizeof(float);
  narrow_wgrad_kernel<C, true><<<wgrid, kRowThreads, smem, st>>>(
      s2, ybar, t2, vv, p_w2, g.I, g.H, g.W);
  RETURN_IF(cudaGetLastError());
  const int64_t nrows = g.B * C;
  row_sum_kernel<<<static_cast<int>((nrows + kWarps - 1) / kWarps),
                   kRowThreads, 0, st>>>(ybar, r_b2, nrows,
                                         static_cast<int>(hw));
  RETURN_IF(cudaGetLastError());

  // layer 1: w1g partials, then the cotangents through W1^T
  const lipnet::GemmArgs wg{{zb2, ab2}, {s1, t1}, 2, I * hw, I * hw,
                            g.I, g.I, static_cast<int>(hw)};
  RETURN_IF(lipnet::gemm<true>(wg, g.B, Store{p_w1}, st));
  RETURN_IF(lipnet::mat_wide(g, w1t, zb2, Store{s1b}, st));
  RETURN_IF(lipnet::mat_wide(g, w1t, ab2, Store{t1b}, st));
  act_bwd_kernel<<<row_blocks, kRowThreads, 0, st>>>(
      d1, sin1, a1, s1b, t1b, r_b0, hp ? hbar : nullptr, rows,
      static_cast<int>(hw));
  RETURN_IF(cudaGetLastError());

  // layer 0 (s1b and t1b now hold z1b and a1b)
  narrow_wgrad_kernel<C, false><<<wgrid, kRowThreads, smem, st>>>(
      s1b, s0, t1b, t0, p_w0, g.I, g.H, g.W);
  RETURN_IF(cudaGetLastError());
  RETURN_IF(lipnet::conv_out<C>(g, s1b, w0t, Store{s0b}, st));
  if (preact) RETURN_IF(lipnet::conv_out<C>(g, t1b, w0t, Store{t0b}, st));
  xbar_kernel<<<grid_1d(nn), 256, 0, st>>>(ybar, s0b, d0, s0, eps, t0b, xbar,
                                           nn);
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

inline bool bad_geometry(int B, int C, int H, int W, int I) {
  return B <= 0 || H <= 0 || W <= 0 || I <= 0 || (C != 3 && C != 12) ||
         (H * W) % 4 || I % 4 || C * (H + 2) * (W + 2) > kMaxPadded;
}

}  // namespace fused_ops
