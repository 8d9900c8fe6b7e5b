// upfirdn2d for Hopper (sm_90a), NCHW float32: zero-stuff by `up`, pad by
// (pad0, pad1) on both axes, convolve with a 2-D FIR kernel of up to 8x8
// taps, keep every `down`-th output. up and down are 1 or 2.
//
// Replaces the TPU kernel `indm_tpu/ops/upfirdn2d_pallas.py:
// upfirdn2d_pallas` and computes the function of its oracle
// `indm_tpu/ops/upfirdn2d.py:upfirdn2d_native`:
//   out[oy, ox] = sum_{ty, tx} k[kh-1-ty, kw-1-tx] * xu[oy*down + ty - pad0,
//                                                      ox*down + tx - pad0]
// where xu is x with (up - 1) zeros after every pixel of each axis, and xu
// outside [0, H*up) x [0, W*up) is zero. pad1 only sets the output size.
//
// Design. One thread block holds `ppb` (sample, channel) planes of one
// th x tw output tile. It first copies the input window that the tile
// reads, with its halo, into shared memory (one warp per row; zeros where
// the window leaves the image). Then its 256 threads sit 2^k >= tw to an
// output row, the rest on the following rows of every plane, and each
// sums the taps of its pixels from the window. The zeros of up = 2 are
// never materialised: a tap whose stuffed index is odd is skipped, the
// others read input pixel floor(u / 2). A 4x4 kernel (the score net's
// [1, 3, 3, 1] outer product) is unrolled; others up to 8x8 loop. The
// taps, flipped on the host, travel in the kernel's parameter block, which
// the card serves from its constant cache as one broadcast per tap.
// Nothing crosses blocks: one pass, no atomics. The kernel does not need
// a separable kernel. The TPU kernel was VPU code built from strided
// slices and stacks, one image per grid step in VMEM; none of that
// carries over.
//
// Tile shape. Per axis, the output is cut into ceil(n / 32) equal tiles
// (33 -> 17 + 16), so that a ragged edge wastes few threads. A block
// takes up to four output pixels per thread (a first version with one
// per thread and 16 x 16 tiles did too little work per block to pay for
// its launch and barrier; PERF.md has both versions' times), but fewer
// where the launch would then have under 4096 blocks
// (about four waves of 8 blocks on 132 SMs), so that the small 8x8 and
// 4x4 planes still fill the card.
//
// Bound. The kernel must read x once and write the output once:
// 4 * (P*H*W + P*OH*OW) bytes over 3.35 TB/s on an H100 SXM; its
// arithmetic (at most 2 * 64 flops per output) is far below the compute
// roof. The halo is read again by the neighbouring tile, mostly from L2.
//
// Interface: plain C, loaded with ctypes (indm_torch/ops/upfirdn2d.py).
// The launch goes on the caller's stream; the function returns the CUDA
// error code of the launch (0 on success) and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
// output slots per block (the tile's rows times 2^k per row): at most four
// per thread, and fewer where the launch would have under kTargetBlocks
constexpr int kOutputsPerBlock = 4 * kThreads;
constexpr int kTargetBlocks = 4096;
constexpr int kMaxTaps = 8;
constexpr int kMaxTile = 32;
constexpr int kSmemBytes = 48 * 1024;

// The flipped taps: w[ty * kMaxTaps + tx] weighs the window offset (ty, tx).
struct Taps {
  float w[kMaxTaps * kMaxTaps];
};

// floor(u / UP) for UP in {1, 2}; the shift is arithmetic, so it floors
// negative u too.
template <int UP>
__device__ __forceinline__ int floor_div(int u) {
  return UP == 1 ? u : (u >> 1);
}

// The taps of one output pixel from the block's window: K > 0 unrolls a
// K x K kernel, K = 0 loops over kh x kw taps.
template <int UP, int DOWN, int K>
__device__ __forceinline__ float fir_at(const float* __restrict__ win,
                                        int iw, int oy, int ox, int iy0,
                                        int ix0, int kh, int kw, int pad0,
                                        const Taps& taps) {
  const int nh = K > 0 ? K : kh, nw = K > 0 ? K : kw;
  float acc = 0.f;
#pragma unroll
  for (int ty = 0; ty < (K > 0 ? K : kMaxTaps); ++ty) {
    const int u = oy * DOWN + ty - pad0;  // row of the zero-stuffed input
    if (ty >= nh || (UP == 2 && (u & 1))) continue;
    const float* row = win + (floor_div<UP>(u) - iy0) * iw;
#pragma unroll
    for (int tx = 0; tx < (K > 0 ? K : kMaxTaps); ++tx) {
      const int v = ox * DOWN + tx - pad0;
      if (tx >= nw || (UP == 2 && (v & 1))) continue;
      acc += taps.w[ty * kMaxTaps + tx] * row[floor_div<UP>(v) - ix0];
    }
  }
  return acc;
}

template <int UP, int DOWN, int K>
__global__ void __launch_bounds__(kThreads)
    upfirdn2d_kernel(const float* __restrict__ x, float* __restrict__ y, int P,
                     int H, int W, int OH, int OW, int kh, int kw, int pad0,
                     int th, int tw, int lanes_log2, int ppb, int ih, int iw,
                     Taps taps) {
  extern __shared__ float window[];  // [ppb][ih][iw]
  const int plane0 = blockIdx.x * ppb;
  const int oy0 = blockIdx.y * th;
  const int ox0 = blockIdx.z * tw;
  // the first input row and column that the tile's taps reach
  const int iy0 = floor_div<UP>(oy0 * DOWN - pad0);
  const int ix0 = floor_div<UP>(ox0 * DOWN - pad0);
  // one warp per window row, its lanes along the row
  const int lane = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < ppb * ih; row += kThreads / 32) {
    const int p = plane0 + row / ih;
    const int r = iy0 + row % ih;
    const bool inside = p < P && r >= 0 && r < H;
    for (int c = lane; c < iw; c += 32) {
      const int gx = ix0 + c;
      window[row * iw + c] =
          inside && gx >= 0 && gx < W
              ? x[(static_cast<int64_t>(p) * H + r) * W + gx]
              : 0.f;
    }
  }
  __syncthreads();

  // 2^lanes_log2 >= tw neighbouring threads along an output row, the
  // block's other threads on the following rows of all ppb planes
  const int cx = threadIdx.x & ((1 << lanes_log2) - 1);
  const int ox = ox0 + cx;
  if (cx >= tw || ox >= OW) return;
  for (int r = threadIdx.x >> lanes_log2; r < ppb * th;
       r += kThreads >> lanes_log2) {
    const int p = r / th;
    const int oy = oy0 + r % th;
    if (plane0 + p >= P || oy >= OH) continue;
    y[(static_cast<int64_t>(plane0 + p) * OH + oy) * OW + ox] =
        fir_at<UP, DOWN, K>(window + p * ih * iw, iw, oy, ox, iy0, ix0, kh,
                            kw, pad0, taps);
  }
}

// Tiles of at most kMaxTile per axis, cut evenly.
int tile_len(int n) {
  const int tiles = (n + kMaxTile - 1) / kMaxTile;
  return (n + tiles - 1) / tiles;
}

template <int UP, int DOWN>
int launch(const float* x, float* y, int P, int H, int W, int OH, int OW,
           int kh, int kw, int pad0, const Taps& taps, cudaStream_t stream) {
  const int th = tile_len(OH), tw = tile_len(OW);
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < tw) ++lanes_log2;
  // input rows (columns) a tile reads: floor(u / UP) over an interval of
  // (th - 1) * DOWN + kh - 1 stuffed rows, at most this many
  const int ih = ((th - 1) * DOWN + kh - 1) / UP + 2;
  const int iw = ((tw - 1) * DOWN + kw - 1) / UP + 2;
  const int plane_bytes = ih * iw * static_cast<int>(sizeof(float));
  if (plane_bytes > kSmemBytes) return cudaErrorInvalidConfiguration;
  const int tiles_y = (OH + th - 1) / th, tiles_x = (OW + tw - 1) / tw;
  const int64_t slots = static_cast<int64_t>(P) * tiles_y * tiles_x *
                        (th << lanes_log2);
  const int per_block = static_cast<int>(
      std::min<int64_t>(kOutputsPerBlock,
                        std::max<int64_t>(kThreads, slots / kTargetBlocks)));
  int ppb = per_block / (th << lanes_log2);
  if (ppb * plane_bytes > kSmemBytes) ppb = kSmemBytes / plane_bytes;
  if (ppb < 1) ppb = 1;
  const dim3 grid((P + ppb - 1) / ppb, tiles_y, tiles_x);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = static_cast<size_t>(ppb) * plane_bytes;
  if (kh == 4 && kw == 4)
    upfirdn2d_kernel<UP, DOWN, 4><<<grid, kThreads, smem, stream>>>(
        x, y, P, H, W, OH, OW, kh, kw, pad0, th, tw, lanes_log2, ppb, ih, iw,
        taps);
  else
    upfirdn2d_kernel<UP, DOWN, 0><<<grid, kThreads, smem, stream>>>(
        x, y, P, H, W, OH, OW, kh, kw, pad0, th, tw, lanes_log2, ppb, ih, iw,
        taps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [P, H, W] float32 contiguous (P = batch * channels); y: [P, OH, OW]
// float32 with OH = (H*up + pad0 + pad1 - kh) / down + 1 (OW likewise,
// computed by the caller); k: host pointer to the kh x kw taps, row-major,
// unflipped. Returns the cudaError_t of the launch.
int indm_upfirdn2d_fwd(const void* x, void* y, int P, int H, int W, int OH,
                       int OW, const float* k, int kh, int kw, int up,
                       int down, int pad0, void* stream) {
  if (P <= 0 || H <= 0 || W <= 0 || OH <= 0 || OW <= 0 || kh <= 0 ||
      kw <= 0 || kh > kMaxTaps || kw > kMaxTaps || pad0 < 0)
    return cudaErrorInvalidValue;
  Taps taps = {};
  for (int ty = 0; ty < kh; ++ty)
    for (int tx = 0; tx < kw; ++tx)
      taps.w[ty * kMaxTaps + tx] = k[(kh - 1 - ty) * kw + (kw - 1 - tx)];
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (up == 1 && down == 1)
    return launch<1, 1>(xf, yf, P, H, W, OH, OW, kh, kw, pad0, taps, st);
  if (up == 1 && down == 2)
    return launch<1, 2>(xf, yf, P, H, W, OH, OW, kh, kw, pad0, taps, st);
  if (up == 2 && down == 1)
    return launch<2, 1>(xf, yf, P, H, W, OH, OW, kh, kw, pad0, taps, st);
  if (up == 2 && down == 2)
    return launch<2, 2>(xf, yf, P, H, W, OH, OW, kh, kw, pad0, taps, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
