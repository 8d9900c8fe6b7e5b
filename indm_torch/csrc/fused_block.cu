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
// over the sample's pixels, the narrow tensor's halo tile in shared
// memory), and batch_sum_kernel adds the partials in sample order. No
// atomics: two runs give the same bits.
//
// Bound. One application of the net (forward or J^T) is
// 2*B*H*W*(9*C*I + I*I + 9*I*C) flops, A0 = 76.0 GFLOP at scale 0 (B = 128,
// C = 3, 32x32, I = 512) and A1 = 24.4 GFLOP at scale 1 (C = 12, 16x16).
// Its 1x1 product (2*B*H*W*I*I: 68.7 and 17.2 GFLOP) runs on the tensor
// cores in 3xTF32 (lipnet::gemm), three TF32 passes at 495 TFLOP/s on an
// H100 SXM; the narrow convs are float32 FMA at 67 TFLOP/s: A0 takes at
// least 0.52 ms and A1 0.21. The forward is (n + offset + 2) A (forward,
// terms, J^T u).
// The backward is 6 A (recompute, tangent, two cotangent streams, two
// weight-gradient products) less the narrow convs it skips: the recompute
// and the tangent stop at layer 2's input (no W2 conv), and without the
// pre-activation no t-stream W0^T. A narrow 3x3 conv is N = 2*B*H*W*9*I*C
// (3.62 GFLOP at either scale), so the backward is 6 A - 2 N pre-activated
// and 6 A - 3 N not. A 512-wide float32 tensor at scale 0 is
// 268 MB (0.08 ms at 3.35 TB/s): even twenty passes over such tensors keep
// both kernels bound by operations, 90 % of which are the 1x1 products.
// float32 is the contract: the 1x1 products keep it in 3xTF32 (the note at
// lipnet::gemm_3xtf32_kernel); bf16 waits for the precision switches.
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

#include "fused_block_ops.cuh"

using fused_ops::bad_geometry;
using fused_ops::bwd;
using fused_ops::bwd_scratch;
using fused_ops::fwd;
using fused_ops::fwd_scratch;
using fused_ops::plane_floats;
using lipnet::Geometry;

extern "C" {

// Kernel 3. x, eps, y, u: [B, C, H, W]; w0 [I, C, 3, 3], w1 [I, I],
// w2 [C, I, 3, 3] and their transposed convs w2t [I, C, 3, 3] (of w2),
// w1t [I, I], w0t [C, I, 3, 3] (of w0); b0, b1 [I], b2 [C]; hp [B, I] or
// null; logdet [B]; all float32, contiguous, on the card. coeffs: n_terms
// host floats, (-1)^k coeff(k) for k = 1..n_terms. scratch: at least
// 4*I*I8 + 4*B*I*H*W + 5*B*C*H*W floats, I8 = I rounded up to a multiple
// of 8 (scratch_floats says how many there are): W1's and W1^T's planes,
// then fwd's temporaries. C must be 3 or 12, H*W and I multiples of 4,
// C*(H+2)*(W+2) <= 6144.
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
  if (scratch_floats < plane_floats(I) + fwd_scratch(g, C))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* planes = m(scratch);
  float* temps = planes + plane_floats(I);
  const cudaError_t err =
      fused_ops::make_planes(f(w1), f(w1t), 1, I, planes, st);
  if (err != cudaSuccess) return err;
  if (C == 3)
    return fwd<3>(g, f(x), f(eps), f(w0), planes, f(w2), f(w2t), f(w0t),
                  f(b0), f(b1), f(b2), f(hp), coeffs, n_terms, preact != 0,
                  m(y), m(u), m(logdet), temps, st);
  return fwd<12>(g, f(x), f(eps), f(w0), planes, f(w2), f(w2t), f(w0t),
                 f(b0), f(b1), f(b2), f(hp), coeffs, n_terms, preact != 0,
                 m(y), m(u), m(logdet), temps, st);
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
