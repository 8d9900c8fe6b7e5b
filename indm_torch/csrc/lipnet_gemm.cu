// The Lipschitz net's 512-wide products alone, for Hopper (sm_90a),
// float32 (3xTF32 on the tensor cores), with a storing epilogue, so that
// the two GEMMs that kernels 3-8 run can be tested and timed on their own.
// The main path never calls these entry points.
//   indm_lipnet_gemm:  lipnet_ops.cuh's `lipnet::gemm` (`mma.sync`, a
//                      `cp.async` ring): the products of kernels 4 and 6,
//                      the float32 backwards
//   indm_lipnet_wgmma: lipnet_wgmma.cuh's `lipnet::wgmma_gemm` (`wgmma`,
//                      a TMA ring, the weight split once a call): the
//                      float32 products of kernels 3, 5, 7 and 8
//   indm_lipnet_gemm_bf16: lipnet_wgmma_bf16.cuh's `lipnet::gemm_bf16`
//                      (bfloat16 `wgmma`, both operands through TMA,
//                      float32 sums): every product of the bfloat16 mode
//                      of kernels 3-8
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
// `lipnet::gemm_3xtf32_kernel` and at the top of lipnet_wgmma.cuh and
// lipnet_wgmma_bf16.cuh.
//
// Interface: plain C, loaded with ctypes (indm_torch/ops/lipnet_gemm.py).
// The launch goes on the caller's stream; the function returns the CUDA
// error (0 on success) and never synchronises.

#include "lipnet_ops.cuh"
#include "lipnet_wgmma.cuh"
#include "lipnet_wgmma_bf16.cuh"

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

// out[b] = w @ act[b]: w [M, K] (any alignment), act [batch, K, N] and out
// [batch, M, N] 16-byte aligned, all float32, contiguous, on the card;
// planes: 2*M*K8 floats, 16-byte aligned (K8: K rounded up to 8), where
// the call splits w. K and N multiples of 4. Returns a cudaError_t.
int indm_lipnet_wgmma(const void* w, const void* act, void* out,
                      void* planes, int batch, int M, int N, int K,
                      void* stream) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0 || N % 4 || K % 4 ||
      !aligned(act) || !aligned(out) || !aligned(planes))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(planes);
  const cudaError_t err = lipnet::split_weights(
      static_cast<const float*>(w), 0, p, 0, 1, M, K, st);
  if (err != cudaSuccess) return err;
  return lipnet::wgmma_gemm(lipnet::SplitWeight{p, M, K},
                            static_cast<const float*>(act), batch, N,
                            lipnet::Store{static_cast<float*>(out)}, st);
}

// The bfloat16 GEMM: a_p, b_p bfloat16 (pairs 1 to 3), out float32, all
// contiguous, 16-byte aligned, on the card; strides and bt as for
// indm_lipnet_gemm (a stride of 0 or the operand's size: the tensor maps
// read each operand as [batch, rows, K or N]). K and N multiples of 8.
// Returns a cudaError_t.
int indm_lipnet_gemm_bf16(const void* const* a, const void* const* b,
                          int pairs, int64_t a_bs, int64_t b_bs, int bt,
                          void* out, int batch, int M, int N, int K,
                          void* stream) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (batch <= 0 || batch > 65535 || M <= 0 || N <= 0 || K <= 0 || N % 8 ||
      K % 8 || (a_bs && a_bs != static_cast<int64_t>(M) * K) ||
      (b_bs && b_bs != static_cast<int64_t>(N) * K) || pairs < 1 ||
      pairs > lipnet::kMaxPairs || !aligned(out))
    return cudaErrorInvalidValue;
  lipnet::GemmBf16Args args{{}, {}, pairs, a_bs, b_bs, M, N, K};
  for (int p = 0; p < pairs; ++p) {
    if (!aligned(a[p]) || !aligned(b[p])) return cudaErrorInvalidValue;
    args.a[p] = static_cast<const __nv_bfloat16*>(a[p]);
    args.b[p] = static_cast<const __nv_bfloat16*>(b[p]);
  }
  const lipnet::Store store{static_cast<float*>(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bt ? lipnet::gemm_bf16<true>(args, batch, store, st)
            : lipnet::gemm_bf16<false>(args, batch, store, st);
}

}  // extern "C"
