// The fused iResBlock kernel pair for Hopper (sm_90a), NCHW, in float32 or
// in bfloat16 (the bfloat16 mode below): the training forward of one block
// with its log-det estimator, and the complete backward of (y, logdet),
// second-order terms included.
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
// (s2, d2), conv_out + b2 + x -> y. Its 512-wide products (layer 1, each
// chain term's W1^T and J^T u's) run the `wgmma` GEMM of lipnet_wgmma.cuh
// on W1 and W1^T split into TF32 hi and lo planes once per call; the
// backward's run lipnet::gemm_3xtf32_kernel. The diagonals d1, d2 ([B, I, H, W]
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
// over the sample's pixels, both narrow tensors' padded planes in dynamic
// shared memory sized from the geometry: 111 KB at CelebA's 12 x 32 x 32,
// by the opt-in past 48 KB), and batch_sum_kernel adds the partials in
// sample order. No
// atomics: two runs give the same bits.
//
// Bound. One application of the net (forward or J^T) is
// 2*B*H*W*(9*C*I + I*I + 9*I*C) flops, A0 = 76.0 GFLOP at scale 0 (B = 128,
// C = 3, 32x32, I = 512) and A1 = 24.4 GFLOP at scale 1 (C = 12, 16x16).
// Its 1x1 product (2*B*H*W*I*I: 68.7 and 17.2 GFLOP) runs on the tensor
// cores in 3xTF32 (lipnet::gemm), three TF32 passes at 495 TFLOP/s on an
// H100 SXM, as does conv_in (the C -> I conv, an implicit GEMM); conv_out
// is float32 FMA at 67 TFLOP/s: A0 takes at least 0.49 ms and A1 0.18.
// The forward is (n + offset + 2) A (forward, terms, J^T u).
// The backward is 6 A (recompute, tangent, two cotangent streams, two
// weight-gradient products) less the narrow convs it skips: the recompute
// and the tangent stop at layer 2's input (no W2 conv), and without the
// pre-activation no t-stream W0^T. A narrow 3x3 conv is N = 2*B*H*W*9*I*C
// (3.62 GFLOP at either scale), so the backward is 6 A - 2 N pre-activated
// and 6 A - 3 N not: four conv_ins on the tensor cores, the rest (conv_out,
// the narrow weight gradients) float32 FMA. A 512-wide float32 tensor at
// scale 0 is
// 268 MB (0.08 ms at 3.35 TB/s): even twenty passes over such tensors keep
// both kernels bound by operations, 90 % of which are the 1x1 products.
// float32 is the contract: the 1x1 products keep it in 3xTF32 (the note at
// lipnet::gemm_3xtf32_kernel).
//
// Numerics: float32 throughout, sincospif (accurate) for sin/cos; the
// TPU kernel's polynomial sin/cos was a Mosaic workaround and is not
// carried over.
//
// The bfloat16 mode (bf16 != 0; the JAX package's compute_dtype =
// bfloat16, which `flow.logdet_bf16` and `flow.mixed_precision` select).
// The same sequences (fused_block_ops.cuh, templated on the storage type
// T) with the TPU kernels' rounding points (`_fwd_body`, `_make_bwd_body`):
// the weights, biases and hp come in bfloat16 (the wrapper casts them, as
// the TPU pair casts them outside its body), x and vareps are rounded once;
// each product sums in float32 and is rounded, the bias added and rounded
// again; sigma and sigma' are taken in float32 from the rounded value and
// rounded; every diagonal multiply is rounded. y = [x] + g, the chain's
// acc, u, the log-det, z2b and z1b (which the float32 constant (2 pi)^2
// promotes) and every weight gradient stay float32. The 512-wide
// temporaries are bfloat16 in device memory, half the bytes. Every 1x1
// product (the TPU kernel's `_apply_packed(kind="mat")` and `_wgrad`,
// indm_tpu/ops/fused_block.py:165) runs lipnet::wgmma_bf16_kernel
// (lipnet_wgmma_bf16.cuh: `wgmma` with both bfloat16 operands through
// TMA, float32 sums); z2b enters its two products as two bfloat16 pairs,
// its hi and lo parts, as act_bwd_kernel splits it. conv_in (the TPU's
// `_apply_packed(kind="narrow_in")`) is an implicit GEMM on bfloat16
// `mma.sync`, conv_out loads bfloat16 and sums in float32 FMA. Bound at
// B = 128, width 512: the 1x1 product of one application is 68.7 GFLOP at
// scale 0 (0.069 ms at 989 TFLOP/s dense bfloat16), bound by its bytes
// (0.12 ms: the bfloat16 activations read and the output written once at
// 3.35 TB/s); conv_in's 3.6 GFLOP take 0.004 ms on the tensor cores and
// are bound by the 0.04 ms of the outputs it writes; conv_out's 3.6 GFLOP
// take 0.054 ms of float32 FMA. So A0 is bound by bytes; the GEMM's TMA
// ring and conv_in's tensor cores keep the operations off that path. H*W
// and I must be multiples of 8.
//
// Interface: plain C, loaded with ctypes (indm_torch/ops/fused_block.py).
// The caller allocates every output and one scratch buffer of the size in
// the entry point's comment. All launches go on the caller's stream; each
// entry point returns the first CUDA error (0 on success) and never
// synchronises.

#include "fused_block_ops.cuh"

using fused_ops::bad_geometry;
using fused_ops::bwd;
using fused_ops::bwd_scratch_bytes;
using fused_ops::fwd;
using fused_ops::fwd_scratch_bytes;
using fused_ops::plane_floats;
using lipnet::Geometry;

namespace {

using bf16 = __nv_bfloat16;

template <class T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}
float* out(void* p) { return static_cast<float*>(p); }

// the float mode: W1 and W1^T split into planes at the front of the scratch
template <int C>
cudaError_t fwd_f32(const Geometry& g, const void* x, const void* eps,
                    const void* w0, const void* w1, const void* w2,
                    const void* w2t, const void* w1t, const void* w0t,
                    const void* b0, const void* b1, const void* b2,
                    const void* hp, const float* coeffs, int n_terms,
                    bool preact, void* y, void* u, void* logdet,
                    void* scratch, cudaStream_t st) {
  float* planes = out(scratch);
  RETURN_IF(fused_ops::make_planes(in<float>(w1), in<float>(w1t), 1, g.I,
                                   planes, st));
  const lipnet::SplitWeight s1{planes, g.I, g.I};
  const lipnet::SplitWeight s1t{planes + lipnet::split_floats(g.I, g.I), g.I,
                                g.I};
  return fwd<C>(g, in<float>(x), in<float>(eps), in<float>(w0), s1, s1t,
                in<float>(w2), in<float>(w2t), in<float>(w0t), in<float>(b0),
                in<float>(b1), in<float>(b2), in<float>(hp), coeffs, n_terms,
                preact, out(y), out(u), out(logdet), planes + plane_floats(g.I),
                st);
}

template <int C>
cudaError_t fwd_bf16(const Geometry& g, const void* x, const void* eps,
                     const void* w0, const void* w1, const void* w2,
                     const void* w2t, const void* w1t, const void* w0t,
                     const void* b0, const void* b1, const void* b2,
                     const void* hp, const float* coeffs, int n_terms,
                     bool preact, void* y, void* u, void* logdet,
                     void* scratch, cudaStream_t st) {
  return fwd<C>(g, in<float>(x), in<float>(eps), in<bf16>(w0), in<bf16>(w1),
                in<bf16>(w1t), in<bf16>(w2), in<bf16>(w2t), in<bf16>(w0t),
                in<bf16>(b0), in<bf16>(b1), in<bf16>(b2), in<bf16>(hp),
                coeffs, n_terms, preact, out(y), out(u), out(logdet), scratch,
                st);
}

template <int C, class T>
cudaError_t bwd_t(const Geometry& g, const void* x, const void* eps,
                  const void* u, const void* ybar, const void* lbar,
                  const void* w0, const void* w1, const void* w2t,
                  const void* w1t, const void* w0t, const void* b0,
                  const void* b1, const void* hp, bool preact, void* xbar,
                  void* w0g, void* w1g, void* w2g, void* b0g, void* b1g,
                  void* b2g, void* hbar, void* scratch, cudaStream_t st) {
  return bwd<C>(g, in<float>(x), in<float>(eps), in<float>(u),
                in<float>(ybar), in<float>(lbar), in<T>(w0), in<T>(w1),
                in<T>(w2t), in<T>(w1t), in<T>(w0t), in<T>(b0), in<T>(b1),
                in<T>(hp), preact, out(xbar), out(w0g), out(w1g), out(w2g),
                out(b0g), out(b1g), out(b2g), out(hbar), scratch, st);
}

}  // namespace

extern "C" {

// Kernel 3. x, eps, y, u: [B, C, H, W] float32; w0 [I, C, 3, 3], w1 [I, I],
// w2 [C, I, 3, 3] and their transposed convs w2t [I, C, 3, 3] (of w2),
// w1t [I, I], w0t [C, I, 3, 3] (of w0); b0, b1 [I], b2 [C]; hp [B, I] or
// null: float32, or bfloat16 with bf16 != 0 (the bfloat16 mode, which
// computes in bfloat16 with float32 sums, the values of the TPU kernel's
// compute_dtype = bfloat16); logdet [B] float32; all contiguous, on the
// card. coeffs: n_terms host floats, (-1)^k coeff(k) for k = 1..n_terms.
// scratch: scratch_bytes bytes; in float32 scratch: at least
// 4*I*I8 + 4*B*I*H*W + 5*B*C*H*W floats, I8 = I rounded up to a multiple
// of 8 (W1's and W1^T's planes, then fwd's temporaries); in bfloat16
// fwd_scratch_bytes. C must be 3 or 12, H*W and I multiples of 4 (of 8 in
// bfloat16), C*(H+2)*(W+2) <= 29056 (fused_ops::kMaxPadded: the backward's
// two padded narrow planes in the 227 KB of shared memory a block may opt
// in to; CelebA's first flow scale, 12 x 32 x 32, is 13 872).
int indm_fused_block_fwd(const void* x, const void* eps, const void* w0,
                         const void* w1, const void* w2, const void* w2t,
                         const void* w1t, const void* w0t, const void* b0,
                         const void* b1, const void* b2, const void* hp,
                         const float* coeffs, int n_terms, int preact,
                         int bf16_mode, void* y, void* u, void* logdet,
                         void* scratch, int64_t scratch_bytes, int B, int C,
                         int H, int W, int I, void* stream) {
  if (bad_geometry(B, C, H, W, I, bf16_mode != 0) || n_terms < 0)
    return cudaErrorInvalidValue;
  const Geometry g(B, H, W, I);
  const int64_t need =
      bf16_mode ? fwd_scratch_bytes<bf16>(g, C)
                : 4 * plane_floats(I) + fwd_scratch_bytes<float>(g, C);
  if (scratch_bytes < need) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = bf16_mode ? (C == 3 ? fwd_bf16<3> : fwd_bf16<12>)
                       : (C == 3 ? fwd_f32<3> : fwd_f32<12>);
  return run(g, x, eps, w0, w1, w2, w2t, w1t, w0t, b0, b1, b2, hp, coeffs,
             n_terms, preact != 0, y, u, logdet, scratch, st);
}

// Kernel 4. x, eps, u, ybar, xbar: [B, C, H, W] float32; lbar [B] float32;
// w0, w1, w2t, w1t, w0t, b0, b1, hp as for kernel 3, in float32 or (bf16
// != 0) bfloat16; outputs, float32: w0g [I, C, 3, 3], w1g [I, I],
// w2g [C, I, 3, 3], b0g, b1g [I], b2g [C], hbar [B, I] (written when hp is
// given). scratch: scratch_bytes bytes; in float32 scratch: at least
// 11*B*I*H*W + 6*B*C*H*W + B*I*I + 18*B*I*C + 2*B*I + B*C floats; in
// bfloat16 bwd_scratch_bytes. Same geometry as kernel 3.
int indm_fused_block_bwd(const void* x, const void* eps, const void* u,
                         const void* ybar, const void* lbar, const void* w0,
                         const void* w1, const void* w2t, const void* w1t,
                         const void* w0t, const void* b0, const void* b1,
                         const void* hp, int preact, int bf16_mode, void* xbar,
                         void* w0g, void* w1g, void* w2g, void* b0g,
                         void* b1g, void* b2g, void* hbar, void* scratch,
                         int64_t scratch_bytes, int B, int C, int H, int W,
                         int I, void* stream) {
  if (bad_geometry(B, C, H, W, I, bf16_mode != 0))
    return cudaErrorInvalidValue;
  const Geometry g(B, H, W, I);
  if (scratch_bytes < (bf16_mode ? bwd_scratch_bytes<bf16>(g, C)
                                 : bwd_scratch_bytes<float>(g, C)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = bf16_mode ? (C == 3 ? bwd_t<3, bf16> : bwd_t<12, bf16>)
                       : (C == 3 ? bwd_t<3, float> : bwd_t<12, float>);
  return run(g, x, eps, u, ybar, lbar, w0, w1, w2t, w1t, w0t, b0, b1, hp,
             preact != 0, xbar, w0g, w1g, w2g, b0g, b1g, b2g, hbar, scratch,
             st);
}

}  // extern "C"
