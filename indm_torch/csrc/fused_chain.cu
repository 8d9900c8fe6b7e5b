// The fully fused Neumann chain for Hopper (sm_90a), NCHW, float32 or
// bfloat16: the
// iResBlock log-det estimator's stop-gradient chain with the activation
// derivatives made from the block input in the same call.
//
// Replaces the TPU kernel `indm_tpu/ops/neumann_pallas.py:
// fused_neumann_chain_pallas` (its inputs packed by `fused_chain_inputs`,
// same file), which the JAX package runs under INDM_FUSED_CHAIN=1:
//
//   s0 = sigma(x) [pre-activated] or x;   d0 = sigma'(x) [pre-activated]
//   z1 = W0 s0 + b0;  d1 = sigma'(z1);  s1 = sigma(z1) + hp
//   z2 = W1 s1 + b1;  d2 = sigma'(z2)
//   acc = sum_{k=1}^{n+offset} (-1)^k coeff(k) (J^T)^k vareps,
//   J^T v = [D0] W0^T D1 W1^T D2 W2^T v,
//
// with sigma(z) = sin(2 pi z) / (2 pi), sigma' = cos(2 pi z), W0 the 3x3
// conv C -> I, W1 the 1x1 conv I -> I, W2 the 3x3 conv I -> C (all
// Lipschitz-normalised, C = 3 or 12, I = 512 at full width) and hp [B, I]
// the optional projection of the conditioning vector.
//
// Design. Kernel 3's forward (fused_block_ops.cuh: `fused_ops::fwd`) up to
// layer 2, then the chain of kernel 7, from the same device code:
//   0. float32 only: W1 and W1^T split once a call into TF32 hi and lo
//      planes (fused_ops::make_planes) at the front of the scratch, for
//      the `wgmma` GEMM (lipnet_wgmma.cuh), as kernel 3 splits them.
//   1. pre-activated only: pre_kernel writes s0 and d0 ([B, C, H, W], 1.5
//      MB at scale 0) in one pass over x.
//   2. conv_in over s0; its epilogue (fused_ops::Layer0T) adds b0 and writes
//      s1 = sigma(z1) + hp and d1 = sigma'(z1). z1 is never stored.
//   3. the product W1 s1 per sample on the `wgmma` GEMM (float32: W1's
//      planes; bfloat16: lipnet::wgmma_bf16_kernel); its epilogue (D2T)
//      adds b1 and writes d2 = sigma'(z2) only. z2 and sigma(z2) are never
//      stored: the chain reads no more of layer 2.
//   4. lipnet::run_chain on (vareps, d2, d1, d0) with W1^T's planes (or the
//      bfloat16 W1^T), unchanged: for the same diagonals its terms are the
//      bits of kernel 7, which splits W1^T with the same kernel and runs
//      the same launches. s1's buffer is the chain's t1 scratch once the
//      GEMM has read it.
// Each sin/cos is taken once (sincospif, as kernels 3-7). The TPU kernel
// kept d1 and d2 in VMEM for a batch tile; here they are written once to
// device memory and read by every term: one full-width sample's two
// 512-wide diagonals are 2 x 2 MB against an SM's 227 KB of shared memory,
// and making z2 again in each term would double the chain's operations
// (the 1x1 product is 90 % of a term at scale 0).
//
// Bound. Operations: the forward 2*B*H*W*(9*C*I + I*I) flops (72.5 GFLOP
// at scale 0: B = 128, C = 3, 32x32, I = 512; 21.2 at scale 1: C = 12,
// 16x16) plus n + offset terms of 2*B*H*W*(9*C*I + I*I + 9*I*C) (76.0 and
// 24.4 GFLOP), the 1x1 products (2*B*H*W*I*I each) and conv_in as three
// TF32 passes at 495 TFLOP/s and conv_out as float32 FMA at 67 TFLOP/s on
// an H100 SXM. Bytes: x, vareps, the weights and acc once, about 3 MB at
// scale 0, against 2.6 ms of operations at n = 2: bound by operations.
// float32 is the contract, kept by the GEMM's 3xTF32 split (a fresh
// float32 sum for each 32 of K).
//
// bfloat16 (the TPU kernel's compute_dtype = x.dtype under flow.logdet_bf16
// or flow.mixed_precision, `neumann_pallas.py:359`): x, vareps, the
// weights, the biases, hp and every temporary are bfloat16, acc float32;
// the same launches with T = __nv_bfloat16, the product W1 s1 and the
// chain's on lipnet::wgmma_bf16_kernel, and each epilogue rounding where
// the TPU kernel's `.astype(cdt)` does (`neumann_pallas.py:381-404`): z1's
// and z2's float32 sums, then the bias added in bfloat16 and rounded; sin
// and cos taken in float32 and rounded; s1 + hp rounded; the chain as
// kernel 7's bfloat16 mode. hp is the caller's bfloat16 product of h (the
// TPU route's `fused_chain_inputs`), not kernel 3's rounded float32 one.
// H*W and I must be multiples of 8 (the GEMM's 16-byte copies).
//
// Interface: plain C, loaded with ctypes (indm_torch/ops/neumann.py). All
// launches go on the caller's stream; the function returns the first CUDA
// error (0 on success) and never synchronises.

#include "fused_block_ops.cuh"

namespace fused_chain_ops {

using fused_ops::act_r;
using lipnet::put;
using lipnet::rnd;
using lipnet::to_f32;

// s0 = [sigma(x)], d0 = [sigma'(x)] for a block input x in T ([.] rounds to
// T): the pre-activation's outputs, as narrow_pre_kernel makes them from a
// float32 x for kernel 3
template <class T>
__global__ void pre_kernel(const T* __restrict__ x, T* s0, T* d0, int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s, d;
    act_r<T>(to_f32(x[i]), &s, &d);
    put(s0 + i, s);
    put(d0 + i, d);
  }
}

// layer 1 for the chain: d2 = [sigma'([[s] + b1])], nothing else stored.
// It reads only the bias, one value a row: nothing to prefetch.
template <class T>
struct D2T {
  const T* bias;
  T* d2;
  __device__ void prefetch(int64_t) const {}
  __device__ void operator()(int64_t idx, int, int m, float4 s) const {
    const float bm = to_f32(bias[m]);
    float4 sv, dv;
    act_r<T>(rnd<T>(rnd<T>(s.x) + bm), &sv.x, &dv.x);
    act_r<T>(rnd<T>(rnd<T>(s.y) + bm), &sv.y, &dv.y);
    act_r<T>(rnd<T>(rnd<T>(s.z) + bm), &sv.z, &dv.z);
    act_r<T>(rnd<T>(rnd<T>(s.w) + bm), &sv.w, &dv.w);
    lipnet::store4(d2 + idx, dv);
  }
};

// the scratch in bytes: s1, d1, d2, t2 [B, I, H, W] and s0, d0, v
// [B, C, H, W] in T, and in float32 W1's and W1^T's planes in front of
// them (fused_ops::plane_floats); in float32, 16*I*I8 + 16*B*I*H*W +
// 12*B*C*H*W bytes with I8 = I rounded up to 8; in bfloat16,
// 8*B*I*H*W + 6*B*C*H*W bytes
template <class T>
int64_t scratch_bytes(int B, int C, int H, int W, int I) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t planes =
      fused_ops::kBf16<T> ? 0 : 4 * fused_ops::plane_floats(I);
  return planes + static_cast<int64_t>(sizeof(T)) *
                      (4 * static_cast<int64_t>(B) * I * hw +
                       3 * static_cast<int64_t>(B) * C * hw);
}

// w1, w_mid: W1 and W1^T as split planes (float32) or bfloat16
template <int C, class T, class Mid>
cudaError_t fused_chain(const lipnet::Geometry& g, const T* x,
                        const T* vareps, const T* w0, const Mid& w1,
                        const T* b0, const T* b1, const T* hp,
                        const T* w_in, const Mid& w_mid, const T* w_out,
                        const float* coeffs, int n_terms, bool preact,
                        float* acc, void* scratch, cudaStream_t st) {
  using fused_ops::grid_1d;
  const int64_t hw = static_cast<int64_t>(g.H) * g.W;
  const int64_t nn = g.B * C * hw, nw = g.B * g.I * hw;
  fused_ops::Carve sc{static_cast<char*>(scratch)};
  T* s1 = sc.take<T>(nw);
  T* d1 = sc.take<T>(nw);
  T* d2 = sc.take<T>(nw);
  T* t2 = sc.take<T>(nw);
  T* s0buf = sc.take<T>(nn);
  T* d0 = sc.take<T>(nn);
  T* v = sc.take<T>(nn);

  const T* s0 = x;
  if (preact) {
    pre_kernel<<<grid_1d(nn), 256, 0, st>>>(x, s0buf, d0, nn);
    RETURN_IF(cudaGetLastError());
    s0 = s0buf;
  } else {
    d0 = nullptr;
  }
  RETURN_IF(lipnet::conv_in<C>(
      g, s0, w0, fused_ops::Layer0T<T>{b0, hp, s1, d1, nullptr, g.I}, st));
  RETURN_IF(lipnet::product(g, w1, s1, D2T<T>{b1, d2}, st));
  return lipnet::run_chain<C>(g, vareps, d2, d1, d0, w_in, w_mid, w_out,
                              coeffs, n_terms, acc, v, /*t1=*/s1, t2, st);
}

// the channel count's instantiation
template <class T, class Mid>
cudaError_t by_channels(const lipnet::Geometry& g, int C, const T* x,
                        const T* vareps, const T* w0, const Mid& w1,
                        const T* b0, const T* b1, const T* hp, const T* w_in,
                        const Mid& w_mid, const T* w_out, const float* coeffs,
                        int n_terms, bool preact, float* acc, void* scratch,
                        cudaStream_t st) {
  if (C == 3)
    return fused_chain<3>(g, x, vareps, w0, w1, b0, b1, hp, w_in, w_mid,
                          w_out, coeffs, n_terms, preact, acc, scratch, st);
  return fused_chain<12>(g, x, vareps, w0, w1, b0, b1, hp, w_in, w_mid,
                         w_out, coeffs, n_terms, preact, acc, scratch, st);
}

template <class T>
int run(const void* x, const void* vareps, const void* w0, const void* w1,
        const void* b0, const void* b1, const void* hp, const void* w_in,
        const void* w_mid, const void* w_out, const float* coeffs,
        int n_terms, bool preact, void* acc, void* scratch,
        int64_t scratch_size, int B, int C, int H, int W, int I,
        void* stream) {
  constexpr int kAlign = sizeof(T) == 4 ? 4 : 8;
  if (B <= 0 || H <= 0 || W <= 0 || I <= 0 || n_terms < 0 ||
      (C != 3 && C != 12) || (H * W) % kAlign || I % kAlign ||
      scratch_size < scratch_bytes<T>(B, C, H, W, I))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const T*>(p); };
  const lipnet::Geometry g(B, H, W, I);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(acc);
  if constexpr (fused_ops::kBf16<T>) {
    return by_channels(g, C, f(x), f(vareps), f(w0), f(w1), f(b0), f(b1),
                       f(hp), f(w_in), f(w_mid), f(w_out), coeffs, n_terms,
                       preact, a, scratch, st);
  } else {
    float* planes = static_cast<float*>(scratch);
    RETURN_IF(fused_ops::make_planes(f(w1), f(w_mid), 1, I, planes, st));
    const lipnet::SplitWeight s1{planes, I, I};
    const lipnet::SplitWeight s1t{planes + lipnet::split_floats(I, I), I, I};
    return by_channels(g, C, f(x), f(vareps), f(w0), s1, f(b0), f(b1), f(hp),
                       f(w_in), s1t, f(w_out), coeffs, n_terms, preact, a,
                       planes + fused_ops::plane_floats(I), st);
  }
}

}  // namespace fused_chain_ops

extern "C" {

// The scratch bytes indm_fused_neumann_chain needs (bf16: the bfloat16 mode).
int64_t indm_fused_chain_scratch_bytes(int B, int C, int H, int W, int I,
                                       int bf16) {
  using fused_chain_ops::scratch_bytes;
  return bf16 ? scratch_bytes<__nv_bfloat16>(B, C, H, W, I)
              : scratch_bytes<float>(B, C, H, W, I);
}

// x, vareps: [B, C, H, W]; w0: [I, C, 3, 3] (W0), w1: [I, I] (W1),
// b0, b1: [I]; hp: [B, I] or null; w_in: [I, C, 3, 3] (W2^T), w_mid:
// [I, I] (W1^T), w_out: [C, I, 3, 3] (W0^T): all float32, or all bfloat16
// with bf16 != 0; acc [B, C, H, W] float32; scratch: scratch_size bytes (at
// least indm_fused_chain_scratch_bytes). All contiguous, 16-byte aligned,
// on the card. coeffs: n_terms host floats, (-1)^k coeff(k) for
// k = 1..n_terms. C must be 3 or 12; H*W and I multiples of 4 (of 8 in
// bfloat16). Returns a cudaError_t.
int indm_fused_neumann_chain(const void* x, const void* vareps,
                             const void* w0, const void* w1, const void* b0,
                             const void* b1, const void* hp, const void* w_in,
                             const void* w_mid, const void* w_out,
                             const float* coeffs, int n_terms, int preact,
                             int bf16, void* acc, void* scratch,
                             int64_t scratch_size, int B, int C, int H, int W,
                             int I, void* stream) {
  using fused_chain_ops::run;
  return (bf16 ? run<__nv_bfloat16> : run<float>)(
      x, vareps, w0, w1, b0, b1, hp, w_in, w_mid, w_out, coeffs, n_terms,
      preact != 0, acc, scratch, scratch_size, B, C, H, W, I, stream);
}

}  // extern "C"
