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
//   narrow_in:  conv_in. A block owns an 8x16 or 4x32 pixel tile of one
//               sample and 64 output channels; the C-channel halo tile and
//               the 64 filters sit in shared memory as float, each thread
//               keeps its pixel's 9*C inputs in registers and walks the 64
//               filters.
//   narrow_out: conv_out. A block owns a pixel tile of one sample, walks
//               the I input channels 16 at a time through shared memory
//               (halo tile and filters, widened to float), and keeps the C
//               outputs of its pixel in registers.
// The loads are templated on the stored type and widen to float in shared
// memory (a float operand compiles to the float loads that kernels 3-8
// run); the epilogue rounds each float32 sum once to the output type
// (round to nearest even for bfloat16, as torch's conversion does).
//
// Bound. Bytes: the wide operand once, the narrow operand and the weights
// once. At the benchmark's shape (B = 128, 32x32, C = 3, I = 512) that is
// 134 MB in bfloat16 (0.040 ms at 3.35 TB/s) and 269 MB in float32
// (0.080 ms). Operations: 2*B*H*W*9*C*I = 3.6 GFLOP, 0.054 ms at 67 TFLOP/s
// of float32 FMA, 0.004 ms on the bf16 tensor cores (989 TFLOP/s). So the
// bound is the bytes in either type: 0.040 ms in bfloat16, 0.080 ms in
// float32. The kernels use no tensor cores: at C = 3 the reduction (27 or
// 9 per output) is too short for a 16-deep bf16 MMA without padding.
//
// Interface: plain C, loaded with ctypes (indm_torch/ops/narrow_conv.py).
// The launch goes on the caller's stream; the function returns the CUDA
// error (0 on success) and never synchronises.

#include "lipnet_ops.cuh"

namespace narrow_ops {

template <class T>
struct StoreAs;

template <>
struct StoreAs<float> {
  float* out;
  __device__ void operator()(int64_t idx, int, int, float s) const {
    out[idx] = s;
  }
};

template <>
struct StoreAs<__nv_bfloat16> {
  __nv_bfloat16* out;
  __device__ void operator()(int64_t idx, int, int, float s) const {
    out[idx] = __float2bfloat16_rn(s);
  }
};

template <int C, class T>
cudaError_t narrow_conv(const T* x, const T* w, T* out, bool narrow_in,
                        int B, int I, int H, int W, cudaStream_t st) {
  const lipnet::Geometry g(B, H, W, I);
  if (narrow_in) return lipnet::conv_in<C>(g, x, w, StoreAs<T>{out}, st);
  return lipnet::conv_out<C>(g, x, w, StoreAs<T>{out}, st);
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
