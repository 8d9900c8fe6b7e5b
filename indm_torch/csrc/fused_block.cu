// The fused iResBlock kernel pair for Hopper (sm_90a), NCHW, float32: the
// training forward of one block with its log-det estimator, and the
// complete backward of (y, logdet), second-order terms included.
//
// Replaces the TPU kernels of `indm_tpu/ops/fused_block.py`:
//   indm_fused_block_fwd  <- fused_block_fwd_pallas (kernel 3)
//   indm_fused_block_bwd  <- fused_block_bwd_pallas (kernel 4)
// whose custom VJP is `fused_block_apply` and whose oracle is
// `fused_block_reference` (same file).
//
// The block (sigma(z) = sin(2 pi z) / (2 pi), sigma' = cos(2 pi z),
// sigma'' = -(2 pi)^2 sigma; W0 the 3x3 conv C -> I, W1 the 1x1 conv I -> I,
// W2 the 3x3 conv I -> C, all Lipschitz-normalised; hp [B, I] the optional
// projection of the conditioning vector; D_k the diagonal of sigma'):
//   s0 = sigma(x) [pre-activated] or x;  z1 = W0 s0 + b0;
//   s1 = sigma(z1) + hp;  z2 = W1 s1 + b1;  s2 = sigma(z2);
//   y = x + W2 s2 + b2;  J = W2 D2 W1 D1 W0 [D0]
//   u = vareps + sum_{k=1}^{n+offset} (-1)^k coeff(k) (J^T)^k vareps
//   logdet = <J^T u, vareps> per sample (u and vareps constants).
//
// Forward (kernel 3). Each sin/cos is taken once, by the epilogue of the
// layer that makes its input: conv_in + b0 -> (s1, d1), gemm + b1 ->
// (s2, d2), conv_out + b2 + x -> y. The diagonals d1, d2 ([B, I, H, W]
// each, 2 x 2 MB for one full-width sample) stay in device memory: the
// TPU kernel kept them in 64 MB of VMEM for a batch tile, a Hopper SM has
// 227 KB. Then the n + offset chain terms (lipnet::run_chain, the device
// code of the Neumann-chain kernel), u = vareps + acc, one more J^T for
// J^T u, and the per-sample dot with vareps in a fixed order.
//
// Backward (kernel 4), the arithmetic of `_make_bwd_body`
// (fused_block.py:353-460), with v = lbar * u:
//   recompute s0, d0, z1 -> (sin1, s1, d1), z2 -> (s2, d2); tangent
//   t0 = [d0 *] vareps, a1 = W0 t0, t1 = d1 a1, a2 = W1 t1, t2 = d2 a2;
//   s2b = W2^T ybar, t2b = W2^T v; z2b = d2 s2b - (2pi)^2 s2 (a2 t2b),
//   a2b = d2 t2b; s1b = W1^T z2b, t1b = W1^T a2b, hbar = sum_hw s1b;
//   z1b = d1 s1b - (2pi)^2 sin1 (a1 t1b), a1b = d1 t1b; s0b = W0^T z1b,
//   t0b = W0^T a1b; xbar = ybar + d0 s0b - (2pi)^2 s0 vareps t0b
//   [pre-activated] or ybar + s0b;
//   w2g = s2 (x) ybar + t2 (x) v, w1g = z2b s1^T + a2b t1^T,
//   w0g = z1b (x) s0 + a1b (x) t0, and the bias sums of ybar, z2b, z1b.
// The products and convs are the lipnet kernels with storing epilogues;
// the sigma'' terms are one row-wise pass per layer (act_bwd_kernel),
// which also takes the per-sample bias and hp sums. The weight gradients
// are reductions over B*H*W rows (131 072 at scale 0): each sample's
// contribution is a partial (w1g: the gemm with both operands contracted
// over pixels; w0g, w2g: narrow_wgrad_kernel, one warp per wide channel
// over the sample's pixels, the narrow tensor's halo tile in shared
// memory), and batch_sum_kernel adds the partials in sample order. No
// atomics: two runs give the same bits.
//
// Bound. One application of the net (forward or J^T) is
// 2*B*H*W*(9*C*I + I*I + 9*I*C) flops, A0 = 76.0 GFLOP at scale 0 (B = 128,
// C = 3, 32x32, I = 512) and A1 = 24.4 GFLOP at scale 1 (C = 12, 16x16):
// 1.13 ms and 0.36 ms at 67 TFLOP/s of float32 outside the tensor cores
// on an H100 SXM. The forward is (n + offset + 2) A (forward, terms, J^T u).
// The backward is 6 A (recompute, tangent, two cotangent streams, two
// weight-gradient products) less the narrow convs it skips: the recompute
// and the tangent stop at layer 2's input (no W2 conv), and without the
// pre-activation no t-stream W0^T. A narrow 3x3 conv is N = 2*B*H*W*9*I*C
// (3.62 GFLOP at either scale), so the backward is 6 A - 2 N pre-activated
// and 6 A - 3 N not. A 512-wide float32 tensor at scale 0 is
// 268 MB (0.08 ms at 3.35 TB/s): even twenty passes over such tensors keep
// both kernels bound by operations, 90 % of which are the 1x1 products.
// No tensor cores: float32 is the contract (TF32/bf16 wait for the
// precision switches).
//
// Numerics: float32 throughout, sincospif (accurate) for sin/cos; the
// TPU kernel's polynomial sin/cos was a Mosaic workaround and is not
// carried over.
//
// Interface: plain C, loaded with ctypes (indm_torch/ops/fused_block.py).
// The caller allocates every output and one scratch buffer of the size in
// the entry point's comment. All launches go on the caller's stream; each
// entry point returns the first CUDA error (0 on success) and never
// synchronises.

#include "lipnet_ops.cuh"

namespace {

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

int64_t fwd_scratch(const Geometry& g, int C) {
  const int64_t hw = static_cast<int64_t>(g.H) * g.W;
  return 4 * g.B * g.I * hw + 5 * g.B * C * hw;
}

int64_t bwd_scratch(const Geometry& g, int C) {
  const int64_t hw = static_cast<int64_t>(g.H) * g.W;
  const int64_t b = g.B, i = g.I;
  return 11 * b * i * hw + 6 * b * C * hw + b * i * i + 2 * b * i * 9 * C +
         2 * b * i + b * C;
}

template <int C>
cudaError_t fwd(const Geometry& g, const float* x, const float* eps,
                const float* w0, const float* w1, const float* w2,
                const float* w2t, const float* w1t, const float* w0t,
                const float* b0, const float* b1, const float* b2,
                const float* hp, const float* coeffs, int n_terms,
                bool preact, float* y, float* u, float* logdet,
                float* scratch, cudaStream_t st) {
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
  RETURN_IF(lipnet::mat_wide(g, w1, s1, Layer1{b1, s2, d2}, st));
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
  lipnet::GemmArgs wg{{zb2, ab2}, {s1, t1}, 2, I * hw, I * hw,
                      g.I, g.I, static_cast<int>(hw)};
  lipnet::gemm_kernel<true><<<g.grid_mm(g.I, g.I), 256, 0, st>>>(wg,
                                                                 Store{p_w1});
  RETURN_IF(cudaGetLastError());
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

bool bad_geometry(int B, int C, int H, int W, int I) {
  return B <= 0 || H <= 0 || W <= 0 || I <= 0 || (C != 3 && C != 12) ||
         (H * W) % 4 || I % 4 || C * (H + 2) * (W + 2) > kMaxPadded;
}

}  // namespace

extern "C" {

// Kernel 3. x, eps, y, u: [B, C, H, W]; w0 [I, C, 3, 3], w1 [I, I],
// w2 [C, I, 3, 3] and their transposed convs w2t [I, C, 3, 3] (of w2),
// w1t [I, I], w0t [C, I, 3, 3] (of w0); b0, b1 [I], b2 [C]; hp [B, I] or
// null; logdet [B]; all float32, contiguous, on the card. coeffs: n_terms
// host floats, (-1)^k coeff(k) for k = 1..n_terms. scratch: at least
// 4*B*I*H*W + 5*B*C*H*W floats (scratch_floats says how many there are).
// C must be 3 or 12, H*W and I multiples of 4, C*(H+2)*(W+2) <= 6144.
int indm_fused_block_fwd(const void* x, const void* eps, const void* w0,
                         const void* w1, const void* w2, const void* w2t,
                         const void* w1t, const void* w0t, const void* b0,
                         const void* b1, const void* b2, const void* hp,
                         const float* coeffs, int n_terms, int preact,
                         void* y, void* u, void* logdet, void* scratch,
                         int64_t scratch_floats, int B, int C, int H, int W,
                         int I, void* stream) {
  if (bad_geometry(B, C, H, W, I) || n_terms < 0) return cudaErrorInvalidValue;
  const Geometry g(B, H, W, I);
  if (scratch_floats < fwd_scratch(g, C)) return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 3)
    return fwd<3>(g, f(x), f(eps), f(w0), f(w1), f(w2), f(w2t), f(w1t),
                  f(w0t), f(b0), f(b1), f(b2), f(hp), coeffs, n_terms,
                  preact != 0, m(y), m(u), m(logdet), m(scratch), st);
  return fwd<12>(g, f(x), f(eps), f(w0), f(w1), f(w2), f(w2t), f(w1t),
                 f(w0t), f(b0), f(b1), f(b2), f(hp), coeffs, n_terms,
                 preact != 0, m(y), m(u), m(logdet), m(scratch), st);
}

// Kernel 4. x, eps, u, ybar, xbar: [B, C, H, W]; lbar [B]; w0, w1, w2t,
// w1t, w0t, b0, b1, hp as for kernel 3; outputs w0g [I, C, 3, 3],
// w1g [I, I], w2g [C, I, 3, 3], b0g, b1g [I], b2g [C], hbar [B, I] (written
// when hp is given). scratch: at least 11*B*I*H*W + 6*B*C*H*W + B*I*I +
// 18*B*I*C + 2*B*I + B*C floats. Same geometry as kernel 3.
int indm_fused_block_bwd(const void* x, const void* eps, const void* u,
                         const void* ybar, const void* lbar, const void* w0,
                         const void* w1, const void* w2t, const void* w1t,
                         const void* w0t, const void* b0, const void* b1,
                         const void* hp, int preact, void* xbar, void* w0g,
                         void* w1g, void* w2g, void* b0g, void* b1g,
                         void* b2g, void* hbar, void* scratch,
                         int64_t scratch_floats, int B, int C, int H, int W,
                         int I, void* stream) {
  if (bad_geometry(B, C, H, W, I)) return cudaErrorInvalidValue;
  const Geometry g(B, H, W, I);
  if (scratch_floats < bwd_scratch(g, C)) return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 3)
    return bwd<3>(g, f(x), f(eps), f(u), f(ybar), f(lbar), f(w0), f(w1),
                  f(w2t), f(w1t), f(w0t), f(b0), f(b1), f(hp), preact != 0,
                  m(xbar), m(w0g), m(w1g), m(w2g), m(b0g), m(b1g), m(b2g),
                  m(hbar), m(scratch), st);
  return bwd<12>(g, f(x), f(eps), f(u), f(ybar), f(lbar), f(w0), f(w1),
                 f(w2t), f(w1t), f(w0t), f(b0), f(b1), f(hp), preact != 0,
                 m(xbar), m(w0g), m(w1g), m(w2g), m(b0g), m(b1g), m(b2g),
                 m(hbar), m(scratch), st);
}

}  // extern "C"
