// The iResBlock log-det estimator's stop-gradient Neumann chain for Hopper
// (sm_90a), NCHW, float32 or bfloat16.
//
// Replaces the TPU kernel `indm_tpu/ops/neumann_pallas.py:
// neumann_chain_pallas` (its oracle is `neumann_chain_ref`, same file):
//
//   acc = sum_{k=1}^{n+offset} (-1)^k coeff(k) (J^T)^k vareps,
//   J^T v = [D_in] W0^T D_mid W1^T D_out W2^T v,
//
// where W2^T is the transposed 3x3 conv C -> I, W1^T the transposed 1x1
// conv I -> I and W0^T the transposed 3x3 conv I -> C of the block's
// Lipschitz net (C = 3 or 12 image channels, and 48: CelebA's second scale
// after two squeezes; I = 512 at full width), and
// D_out, D_mid, D_in the activation-derivative diagonals ([B, I, H, W],
// [B, I, H, W], [B, C, H, W]; D_in only for a pre-activated block). The
// signed coefficients (-1)^k coeff(k) come from the host, which drew n.
//
// Design. One term is three launches, each with its diagonal multiply in
// its epilogue, and the host runs the loop over k (n is known there, so
// nothing is read back from the card). The device code is in
// lipnet_ops.cuh and lipnet_wgmma.cuh, which the fused kernels share:
//   0. once a call, W1^T is split into TF32 hi and lo planes
//      (lipnet::split_weights, 2*I*I8 floats with I8 = I rounded up to 8,
//      in scratch the caller gives): all n + offset terms read the same
//      weight, so no term splits it again.
//   1. conv_in: t1 = D_out * conv3x3(v, W2^T), an implicit GEMM on the
//      tensor cores (3xTF32, or bfloat16 `mma.sync`): a block owns a
//      128-pixel tile of one sample and every output channel, builds its
//      im2col rows once in shared memory and walks the channels in chunks
//      of 64 (the note at lipnet::conv_in_kernel; at C = 48, K = 432 is
//      walked in six groups of 8 channels, the im2col tile of each built in
//      turn from a halo tile kept for the block's life, in either type).
//   2. gemm: t2 = D_mid * (W1^T t1), per sample an [I, I] x [I, H*W]
//      product on the warpgroup tensor cores, lipnet::wgmma_3xtf32_kernel
//      (lipnet_wgmma.cuh): 3xTF32 `wgmma` with t1 as the register operand
//      (split in registers), the planes as the shared one, a TMA ring,
//      persistent blocks, and the DMulT epilogue's loads of D_mid started
//      a k-tile ahead. The same GEMM runs the forward's products of
//      kernels 3 and 5, and kernel 8's.
//   3. conv_out: v = [D_in *] conv3x3(t2, W0^T); acc += coeff * v. A block
//      owns a band of rows of one sample and all I input channels, split
//      in 8 runs, one per warp; each warp streams its run through a stage
//      of its own in shared memory with the next channel's loads in
//      flight, each lane keeps R rows of two columns for all C outputs,
//      and the warps' partial sums are added in warp order. At scale 1 (C = 12,
//      16x16) it is bound by operations (3.6 GFLOP, 0.054 ms), at scale 0
//      by bytes (t2 is 268 MB, 0.080 ms). At C = 48 four blocks share a
//      band, 12 outputs each (a lane's 48 sums would spill).
// The TPU kernel kept the diagonals and the running vector in VMEM for all
// terms of a batch tile; a Hopper SM has 227 KB, far from the 2 x 2 MB of
// diagonals of one full-width sample, so the diagonals stream from device
// memory once per term instead.
//
// Bound. Operations: per term 2*B*H*W*(9*C*I + I*I + 9*I*C) flops, about
// 76 GFLOP at scale 0 (B=128, C=3, 32x32, I=512) and 24 GFLOP at scale 1
// (C=12, 16x16). On an H100 SXM the 1x1 product (68.7 and 17.2 GFLOP) and
// conv_in (3.6 GFLOP) run as three TF32 passes at 495 TFLOP/s and conv_out
// as float32 FMA at 67 TFLOP/s: at least 0.49 ms and 0.18 ms a term (the
// bound of chip_smoke.py's flow_bounds). Bytes: the inputs
// once (vareps, the diagonals, the weights) and acc once, about 0.54 GB at
// scale 0 (0.16 ms at 3.35 TB/s). So the chain is bound by operations,
// and most of them (90 % at scale 0) are the 1x1 product, which is why
// that launch is the `wgmma` GEMM (`mma.sync`, lipnet::gemm_3xtf32_kernel,
// runs the same product at about a third of its bound: chip_smoke.py
// phase 6d). float32 is the contract here, kept by the 3xTF32 split with
// a fresh float32 sum for each 32 of K.
//
// Measured by launch (chip_smoke.py phase 6, torch.profiler; one H100
// 80GB HBM3 at 700 W, batch 128, width 512, pre-activated): a term takes
// 0.209 ms of conv_in, 0.633 of the GEMM and 0.165 of conv_out at scale
// 0 (1.009 with the split and the memset of a call of four terms), and
// 0.135 + 0.171 + 0.113 at scale 1. The GEMM is at 0.66 of its 0.417 ms
// bound at scale 0, slower than alone with a storing epilogue (0.517:
// D_mid's reads are not all hidden); at scale 1 the two narrow convs
// together take longer than the GEMM.
//
// bfloat16 (the chain's mode under flow.logdet_bf16 or flow.mixed_precision
// on the chain route; the TPU kernel takes compute_dtype = vareps.dtype,
// `neumann_pallas.py:196`): vareps, the diagonals, the weights and the
// temporaries v, t1, t2 are bfloat16, acc float32. The same three launches
// of lipnet::run_chain<C, __nv_bfloat16>: conv_in (the TPU kernel's
// `_apply_packed(kind="narrow_in")`) is an implicit GEMM on bfloat16
// `mma.sync` (exact products, float32 sums), conv_out loads bfloat16 and
// sums in float32, the 1x1 product (`kind="mat"`) is one pass of
// lipnet::wgmma_bf16_kernel (lipnet_wgmma_bf16.cuh; W1^T is bfloat16 in
// the TPU kernel: one pair), and each epilogue rounds where the TPU
// kernel's `.astype(cdt)` does (the sum, then its diagonal product: DMulT,
// ChainOutT), with acc += coeff * v in float32. TMA's strides are 16 bytes
// (8 values), so H*W and I must be multiples of 8. At C = 48 (CelebA's
// second scale on the chain route in bfloat16) the geometry is float32's:
// conv_in's K in six groups of 8 channels (bfloat16 `mma.sync`, each
// group's rows padded to K = 80), conv_out's outputs in four blocks of 12
// loading bfloat16, and the 512-wide product one bfloat16 `wgmma` pass.
// Its bound at scale 0:
// the 1x1 product as one bfloat16 pass at 989 TFLOP/s (0.069 ms) and
// conv_in's on the tensor cores (0.004 ms) beside conv_out's 0.054 ms of
// float32 FMA and the 0.18 ms of bytes a term (t1, t2 and v written and
// read, the diagonals read): bound by bytes, which the GEMM's TMA ring and
// conv_in's staged epilogue stream.
//
// Interface: plain C, loaded with ctypes (indm_torch/ops/neumann.py). All
// launches go on the caller's stream; the functions return the first CUDA
// error (0 on success) and never synchronise.

#include "lipnet_ops.cuh"
#include "lipnet_wgmma_bf16.cuh"

namespace {

// the geometry the kernels take: C = 3, 12 or 48; H*W and I multiples of 4
// in float32 (the GEMM's 16-byte TMA rows) and of 8 in bfloat16
template <class T>
bool takes(int B, int C, int H, int W, int I, int n_terms) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kAlign = kF32 ? 4 : 8;
  return B > 0 && H > 0 && W > 0 && I > 0 && n_terms >= 0 &&
         (C == 3 || C == 12 || C == 48) && (H * W) % kAlign == 0 &&
         I % kAlign == 0;
}

// w_mid: W1^T's split planes (float32) or the bfloat16 weight
template <class T, class Mid>
int chain(const void* vareps, const void* d_out, const void* d_mid,
          const void* d_in, const void* w_in, const Mid& w_mid,
          const void* w_out, const float* coeffs, int n_terms, void* acc,
          void* v, void* t1, void* t2, int B, int C, int H, int W, int I,
          cudaStream_t st) {
  auto f = [](const void* p) { return static_cast<const T*>(p); };
  auto m = [](void* p) { return static_cast<T*>(p); };
  const lipnet::Geometry g(B, H, W, I);
  float* a = static_cast<float*>(acc);
  if (C == 3)
    return lipnet::run_chain<3>(g, f(vareps), f(d_out), f(d_mid), f(d_in),
                                f(w_in), w_mid, f(w_out), coeffs, n_terms,
                                a, m(v), m(t1), m(t2), st);
  if (C == 48)
    return lipnet::run_chain<48>(g, f(vareps), f(d_out), f(d_mid), f(d_in),
                                 f(w_in), w_mid, f(w_out), coeffs, n_terms, a,
                                 m(v), m(t1), m(t2), st);
  return lipnet::run_chain<12>(g, f(vareps), f(d_out), f(d_mid), f(d_in),
                               f(w_in), w_mid, f(w_out), coeffs, n_terms, a,
                               m(v), m(t1), m(t2), st);
}

}  // namespace

extern "C" {

// vareps, acc, v: [B, C, H, W]; d_out, d_mid, t1, t2: [B, I, H, W];
// d_in: [B, C, H, W] or null (a block without pre-activation);
// w_in: [I, C, 3, 3] (W2^T), w_mid: [I, I] (W1^T), w_out: [C, I, 3, 3]
// (W0^T); all float32, contiguous, on the card. coeffs: n_terms host
// floats, (-1)^k coeff(k) for k = 1..n_terms. v, t1, t2 are scratch, and
// so is planes, W1^T's TF32 planes: 2*I*I8 floats with I8 = I rounded up to
// 8 (lipnet::split_floats). All 16-byte aligned. C must be 3, 12 or 48;
// H*W and I multiples of 4. Returns a cudaError_t.
int indm_neumann_chain(const void* vareps, const void* d_out,
                       const void* d_mid, const void* d_in, const void* w_in,
                       const void* w_mid, const void* w_out,
                       const float* coeffs, int n_terms, void* acc, void* v,
                       void* t1, void* t2, void* planes, int B, int C, int H,
                       int W, int I, void* stream) {
  if (!takes<float>(B, C, H, W, I, n_terms) ||
      reinterpret_cast<uintptr_t>(planes) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(planes);
  const cudaError_t err = lipnet::split_weights(
      static_cast<const float*>(w_mid), 0, p, 0, 1, I, I, st);
  if (err != cudaSuccess) return err;
  return chain<float>(vareps, d_out, d_mid, d_in, w_in,
                      lipnet::SplitWeight{p, I, I}, w_out, coeffs, n_terms,
                      acc, v, t1, t2, B, C, H, W, I, st);
}

// The same in bfloat16: every array but acc (float32) is bfloat16, W1^T is
// used as it is (no planes), H*W and I are multiples of 8, and C is 3, 12
// or 48.
int indm_neumann_chain_bf16(const void* vareps, const void* d_out,
                            const void* d_mid, const void* d_in,
                            const void* w_in, const void* w_mid,
                            const void* w_out, const float* coeffs,
                            int n_terms, void* acc, void* v, void* t1,
                            void* t2, int B, int C, int H, int W, int I,
                            void* stream) {
  if (!takes<__nv_bfloat16>(B, C, H, W, I, n_terms))
    return cudaErrorInvalidValue;
  return chain<__nv_bfloat16>(vareps, d_out, d_mid, d_in, w_in,
                              static_cast<const __nv_bfloat16*>(w_mid), w_out,
                              coeffs, n_terms, acc, v, t1, t2, B, C, H, W, I,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
