// The Lipschitz net's 512-wide product alone, for Hopper (sm_90a), float32:
// the tensor-core GEMM of lipnet_ops.cuh (`lipnet::gemm`, 3xTF32 `mma`
// with float32 accumulation and a `cp.async` ring) with a storing
// epilogue, so that the GEMM that kernels 3-8 run can be tested and timed
// on its own. The main path never calls this entry point.
//
// Counterpart of the products the TPU kernels make in VMEM:
// `_apply_packed(x, w, "mat")` (indm_tpu/ops/neumann_pallas.py:74-76, the
// 1x1 conv of a tile) and `_wgrad(a, b)` (indm_tpu/ops/fused_block.py:
// 165-168, a weight gradient contracted over the pixels), which in the
// port's NCHW layout are, per sample b and for one or two pairs p,
//   out[b] = sum_p A_p[b] @ B_p[b]      B_p[b] [K, N]  (bt = 0: mat_wide)
//   out[b] = sum_p A_p[b] @ B_p[b]^T    B_p[b] [N, K]  (bt = 1: the w1
//                                                       gradient)
// with A_p[b] [M, K]. The design and the bound are in the note at
// `lipnet::gemm_3xtf32_kernel`.
//
// Interface: plain C, loaded with ctypes (indm_torch/ops/lipnet_gemm.py).
// The launch goes on the caller's stream; the function returns the CUDA
// error (0 on success) and never synchronises.

#include "lipnet_ops.cuh"

extern "C" {

// a0, b0 (and a1, b1 when pairs = 2): float32, contiguous, 16-byte
// aligned, on the card; A_p[b] starts at a_p + b * a_bs, B_p[b] at
// b_p + b * b_bs (a stride of 0 shares the operand across the batch);
// out: [batch, M, N]. K and N multiples of 4, pairs 1 or 2, batch at most
// 65535 (the grid's z dimension). Returns a cudaError_t.
int indm_lipnet_gemm(const void* a0, const void* b0, const void* a1,
                     const void* b1, int pairs, int64_t a_bs, int64_t b_bs,
                     int bt, void* out, int batch, int M, int N, int K,
                     void* stream) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (batch <= 0 || batch > 65535 || M <= 0 || N <= 0 || K <= 0 || N % 4 ||
      K % 4 || a_bs % 4 || b_bs % 4 || (pairs != 1 && pairs != 2) ||
      !aligned(a0) || !aligned(b0) || !aligned(out) ||
      (pairs == 2 && (!aligned(a1) || !aligned(b1))))
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const lipnet::GemmArgs args{{f(a0), f(a1)}, {f(b0), f(b1)}, pairs, a_bs,
                              b_bs, M, N, K};
  const lipnet::Store store{static_cast<float*>(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bt) return lipnet::gemm<true>(args, batch, store, st);
  return lipnet::gemm<false>(args, batch, store, st);
}

}  // extern "C"
