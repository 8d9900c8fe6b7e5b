// The fully fused Neumann chain for Hopper (sm_90a), NCHW, float32: the
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
//   1. pre-activated only: narrow_pre_kernel writes s0 and d0 ([B, C, H, W],
//      1.5 MB at scale 0) in one pass over x.
//   2. conv_in over s0; its epilogue (fused_ops::Layer0) adds b0 and writes
//      s1 = sigma(z1) + hp and d1 = sigma'(z1). z1 is never stored.
//   3. the register-tiled GEMM W1 s1 per sample; its epilogue (D2) adds b1
//      and writes d2 = sigma'(z2) only. z2 and sigma(z2) are never stored:
//      the chain reads no more of layer 2.
//   4. lipnet::run_chain on (vareps, d2, d1, d0), unchanged: for the same
//      diagonals its terms are the bits of kernel 7. s1's buffer is the
//      chain's t1 scratch once the GEMM has read it.
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
// 24.4 GFLOP), at 67 TFLOP/s of float32 outside the tensor cores on an
// H100 SXM. Bytes: x, vareps, the weights and acc once, about 3 MB at
// scale 0, against 18 ms of operations at n = 2: bound by operations.
// No tensor cores: float32 is the contract (a bf16 chain waits for the
// precision switches).
//
// Interface: plain C, loaded with ctypes (indm_torch/ops/neumann.py). All
// launches go on the caller's stream; the function returns the first CUDA
// error (0 on success) and never synchronises.

#include "fused_block_ops.cuh"

namespace fused_chain_ops {

// layer 1 for the chain: d2 = sigma'(s + b1), nothing else stored
struct D2 {
  const float* bias;
  float* d2;
  __device__ void operator()(int64_t idx, int, int m, float4 s) const {
    const float bm = bias[m];
    float4 sv, dv;
    fused_ops::act(s.x + bm, &sv.x, &dv.x);
    fused_ops::act(s.y + bm, &sv.y, &dv.y);
    fused_ops::act(s.z + bm, &sv.z, &dv.z);
    fused_ops::act(s.w + bm, &sv.w, &dv.w);
    *reinterpret_cast<float4*>(d2 + idx) = dv;
  }
};

template <int C>
cudaError_t fused_chain(const lipnet::Geometry& g, const float* x,
                        const float* vareps, const float* w0, const float* w1,
                        const float* b0, const float* b1, const float* hp,
                        const float* w_in, const float* w_mid,
                        const float* w_out, const float* coeffs, int n_terms,
                        bool preact, float* acc, float* scratch,
                        cudaStream_t st) {
  using fused_ops::grid_1d;
  const int64_t hw = static_cast<int64_t>(g.H) * g.W;
  const int64_t nn = g.B * C * hw, nw = g.B * g.I * hw;
  float* s1 = scratch;
  float* d1 = s1 + nw;
  float* d2 = d1 + nw;
  float* t2 = d2 + nw;
  float* s0buf = t2 + nw;
  float* d0 = s0buf + nn;
  float* v = d0 + nn;

  const float* s0 = x;
  if (preact) {
    fused_ops::narrow_pre_kernel<<<grid_1d(nn), 256, 0, st>>>(
        x, nullptr, nullptr, nullptr, s0buf, d0, nullptr, nullptr, nn,
        C * hw);
    RETURN_IF(cudaGetLastError());
    s0 = s0buf;
  } else {
    d0 = nullptr;
  }
  RETURN_IF(lipnet::conv_in<C>(
      g, s0, w0, fused_ops::Layer0{b0, hp, s1, d1, nullptr, g.I}, st));
  RETURN_IF(lipnet::mat_wide(g, w1, s1, D2{b1, d2}, st));
  return lipnet::run_chain<C>(g, vareps, d2, d1, d0, w_in, w_mid, w_out,
                              coeffs, n_terms, acc, v, /*t1=*/s1, t2, st);
}

}  // namespace fused_chain_ops

extern "C" {

// The scratch floats indm_fused_neumann_chain needs.
int64_t indm_fused_chain_scratch(int B, int C, int H, int W, int I) {
  const int64_t hw = static_cast<int64_t>(H) * W;
  return 4 * static_cast<int64_t>(B) * I * hw +
         3 * static_cast<int64_t>(B) * C * hw;
}

// x, vareps, acc: [B, C, H, W]; w0: [I, C, 3, 3] (W0), w1: [I, I] (W1),
// b0, b1: [I]; hp: [B, I] or null; w_in: [I, C, 3, 3] (W2^T), w_mid:
// [I, I] (W1^T), w_out: [C, I, 3, 3] (W0^T); scratch: `scratch_floats`
// floats (at least indm_fused_chain_scratch). All float32, contiguous,
// 16-byte aligned, on the card. coeffs: n_terms host floats, (-1)^k
// coeff(k) for k = 1..n_terms. C must be 3 or 12; H*W and I multiples of 4.
// Returns a cudaError_t.
int indm_fused_neumann_chain(const void* x, const void* vareps,
                             const void* w0, const void* w1, const void* b0,
                             const void* b1, const void* hp, const void* w_in,
                             const void* w_mid, const void* w_out,
                             const float* coeffs, int n_terms, int preact,
                             void* acc, void* scratch, int64_t scratch_floats,
                             int B, int C, int H, int W, int I,
                             void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || I <= 0 || n_terms < 0 || (H * W) % 4 ||
      I % 4 || scratch_floats < indm_fused_chain_scratch(B, C, H, W, I))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  const lipnet::Geometry g(B, H, W, I);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using fused_chain_ops::fused_chain;
  if (C == 3)
    return fused_chain<3>(g, f(x), f(vareps), f(w0), f(w1), f(b0), f(b1),
                          f(hp), f(w_in), f(w_mid), f(w_out), coeffs,
                          n_terms, preact != 0, m(acc), m(scratch), st);
  if (C == 12)
    return fused_chain<12>(g, f(x), f(vareps), f(w0), f(w1), f(b0), f(b1),
                           f(hp), f(w_in), f(w_mid), f(w_out), coeffs,
                           n_terms, preact != 0, m(acc), m(scratch), st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
