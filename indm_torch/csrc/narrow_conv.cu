// A narrow-channel 3x3 SAME stride-1 conv for Hopper (sm_90a), NCHW, in
// float32 or bfloat16 with float32 sums: C -> I ("narrow_in") or I -> C
// ("narrow_out"), with C = 3 or 12 and I the wide side (512 in the
// benchmark).
//
// Replaces the TPU kernel `scripts/bench_narrow_conv.py:pallas_conv`, the
// Pallas case of the JAX package's narrow-conv benchmark (packed taps,
// `indm_tpu/ops/neumann_pallas.py:_apply_packed`), whose output is rounded
// once to the input's type.
//
// Design. The Lipschitz net's own narrow convs (lipnet_ops.cuh), each with
// a storing epilogue, so the benchmark times the device code that kernels
// 3-8 run:
//   narrow_in:  conv_in, an implicit GEMM on the tensor cores (the TPU's
//               im2col matmul, `_apply_packed(kind="narrow_in")`): a block
//               owns a 128-pixel tile of one sample and every output
//               channel, builds the tile's im2col rows (K = 9 C padded to
//               32 or 112) once in shared memory and walks the channels
//               in chunks of 64 through bfloat16 `mma.sync`, or 3xTF32 in
//               float32 (the note at lipnet::conv_in_kernel).
//   narrow_out: conv_out. A block owns a band of rows of one sample (the
//               full width up to 32 columns, 32-column strips beyond) and
//               all I input channels, split in 8 runs, one per warp. Each
//               warp streams its run one channel at a time through a stage
//               of its own in shared memory: it stores the channel it
//               loaded, issues the next channel's loads into registers (as
//               4-byte words: a bfloat16 request moves as many bytes as a
//               float one) and computes the stored channel while they are
//               in flight, with no block-wide barrier. Each lane owns R
//               rows of two columns for all C outputs (R = 4 at C = 3 and
//               32 columns, else 2): per channel it reads 4 x (R + 2)
//               inputs as float2 pairs and the C filters as float4
//               broadcasts for 18 * R * C FMAs. The warps' partial sums are
//               added in warp order in shared memory (no atomics: the same
//               bits every call), and each output goes once to the
//               epilogue.
// The loads are templated on the stored type and widen to float (a float
// operand compiles to the float loads that kernels 3-8 run); the epilogue
// rounds each float32 sum once to the output type (round to nearest even
// for bfloat16, as torch's conversion does).
//
// Bound. Bytes: the wide operand once, the narrow operand and the weights
// once. At the benchmark's shape (B = 128, 32x32, C = 3, I = 512) that is
// 134 MB in bfloat16 (0.040 ms at 3.35 TB/s) and 269 MB in float32
// (0.080 ms). Operations: 2*B*H*W*9*C*I = 3.6 GFLOP, 0.004 ms on the bf16
// tensor cores (989 TFLOP/s), 0.022 ms as conv_in's three TF32 passes (495
// TFLOP/s), 0.054 ms as conv_out's float32 FMA (67 TFLOP/s). So the bound
// is the bytes in either type: 0.040 ms in bfloat16, 0.080 ms in float32;
// conv_out's FMAs (0.054 ms, no tensor cores) are its floor in bfloat16.
// At the chain's scale 1 (B = 128, 16x16, C = 12, I = 512) the bytes are
// 69 MB in float32 (0.021 ms): conv_in's bound is its three TF32 passes,
// 0.022 ms, and 0.010 ms of bytes in bfloat16; narrow_out's is its FMAs.
// conv_in takes the products on the tensor cores with K padded (27 -> 32,
// 108 -> 112); narrow_out's reduction (9 x I per output) would suit a bf16
// MMA with the C outputs padded to 8 or 16 rows, later speed work.
//
// Interface: plain C, loaded with ctypes (indm_torch/ops/narrow_conv.py).
// The launch goes on the caller's stream; the function returns the CUDA
// error (0 on success) and never synchronises.

#include "lipnet_ops.cuh"

namespace narrow_ops {

template <int C, class T>
cudaError_t narrow_conv(const T* x, const T* w, T* out, bool narrow_in,
                        int B, int I, int H, int W, cudaStream_t st) {
  const lipnet::Geometry g(B, H, W, I);
  if (narrow_in) return lipnet::conv_in<C>(g, x, w, lipnet::StoreT<T>{out}, st);
  return lipnet::conv_out<C>(g, x, w, lipnet::StoreT<T>{out}, st);
}

template <class T>
cudaError_t dispatch(const void* x, const void* w, void* out, int B, int cin,
                     int cout, int H, int W, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  const bool narrow_in = cin < cout;
  const int c = narrow_in ? cin : cout, wide = narrow_in ? cout : cin;
  if (c == 3) return narrow_conv<3>(xt, wt, o, narrow_in, B, wide, H, W, st);
  if (c == 12) return narrow_conv<12>(xt, wt, o, narrow_in, B, wide, H, W, st);
  return cudaErrorInvalidValue;
}

}  // namespace narrow_ops

extern "C" {

// x: [B, cin, H, W], w: [cout, cin, 3, 3], out: [B, cout, H, W]; all of
// one type, float32 (bf16 = 0) or bfloat16 (bf16 = 1), contiguous, on the
// card. One of cin and cout is 3 or 12, the other at least 33 and a
// multiple of 4; B at most 65535 (the grid's z dimension). Returns a
// cudaError_t.
int indm_narrow_conv(const void* x, const void* w, void* out, int B, int cin,
                     int cout, int H, int W, int bf16, void* stream) {
  const int narrow = cin < cout ? cin : cout, wide = cin < cout ? cout : cin;
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || wide < 33 || wide % 4 ||
      (narrow != 3 && narrow != 12))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using narrow_ops::dispatch;
  if (bf16) return dispatch<__nv_bfloat16>(x, w, out, B, cin, cout, H, W, st);
  return dispatch<float>(x, w, out, B, cin, cout, H, W, st);
}

}  // extern "C"
