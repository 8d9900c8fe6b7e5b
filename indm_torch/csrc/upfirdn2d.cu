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
// Design, whole planes (the net's path). Every plane the 32x32 net passes
// is at most 32 x 32 in float32 (4 KB; 64 x 64, 16 KB, in the 64x64 net),
// and in NCHW consecutive planes are one
// contiguous span. So a block takes a run of `ppb` whole planes
// (`upfirdn2d.py:plane_plan`): it copies their input, one span, into
// shared memory with 16-byte loads (each input byte read once; no halo,
// no tile read twice), and its 256 threads then write the run's output,
// again one span, in 16-byte stores where the output width is a multiple
// of 4. The taps are separable (every kernel `setup_kernel` builds is an
// outer product), so the wrapper factors them once per distinct kernel
// (`upfirdn2d.py:separate`, an SVD cached by the kernel's bytes) and the
// block runs two 1-D passes as the TPU kernel does: rows into a shared
// intermediate [ppb][H][OW], then columns into the output. Each pass is
// polyphase: for up = 2 an output o takes only the taps of the parity of
// q = o*down - pad0 (h_0 = the even flipped taps, h_1 = the odd ones) at
// input pixels (q + (q & 1)) / 2 + j, so the stuffed zeros are never
// visited and a pass costs ceil(k / 2) taps; for up = 1, k taps at
// q + j. Padding is handled by index bounds, not by a zero-filled
// window. The column pass of a 16-byte store reads its four outputs'
// intermediate values as one 16-byte shared load a tap. Plan and bound
// at the VE net's 15 calls at batch 64 (P = 64 * C planes, 4x4 taps;
// bound = 4 bytes of input and output an element over 3.35 TB/s):
//
//   input C x H x W  up/down  pad    output  calls  planes/block  bound us
//   3 x 32 x 32       1/1     2, 2   33x33     1          1          0.48
//   128 x 16 x 16     1/1     2, 2   17x17     1          7          5.33
//   128 x 32 x 32     1/2     1, 1   16x16     2          4         12.52
//   256 x 4 x 4       2/1     2, 1    8x8      2         32          1.57
//   256 x 8 x 8       1/1     2, 2    9x9      1         25          2.84
//   256 x 8 x 8       1/2     1, 1    4x4      2         32          1.57
//   256 x 8 x 8       2/1     2, 1   16x16     2          8          6.26
//   256 x 16 x 16     1/2     1, 1    8x8      2         16          6.26
//   256 x 16 x 16     2/1     2, 1   32x32     2          2         25.04
//
// 15 launches, 0.115 ms an evaluation. At 64x64 (the CelebA VE net,
// `ve/CELEBA/indm`) the 15 calls take 9 shapes, 0.459 ms an evaluation at
// batch 64; the largest plane, 64 x 64 in (16 KB) with its intermediate,
// runs alone in a block, and every call stays on the whole-plane kernel:
//
//   input C x H x W  up/down  pad    output  calls  planes/block  bound us
//   3 x 64 x 64       1/1     2, 2   65x65     1          1          1.91
//   128 x 32 x 32     1/1     2, 2   33x33     1          1         20.67
//   128 x 64 x 64     1/2     1, 1   32x32     2          1         50.08
//   256 x 8 x 8       2/1     2, 1   16x16     2          8          6.26
//   256 x 16 x 16     1/1     2, 2   17x17     1          7         10.66
//   256 x 16 x 16     1/2     1, 1    8x8      2         16          6.26
//   256 x 16 x 16     2/1     2, 1   32x32     2          2         25.04
//   256 x 32 x 32     1/2     1, 1   16x16     2          4         25.04
//   256 x 32 x 32     2/1     2, 1   64x64     2          1        100.16
//
// A block takes at most 2048 outputs
// (8 a thread) and 24 KB of shared memory, and the launch at least 528
// blocks (four for each of the 132 SMs) where the planes allow.
// The design it replaces (kept below as the general path) cut
// each plane into tiles, read each tile's window with scalar loads, one
// warp per window row (19-35 of 32 lanes busy at the net's sizes), read
// every halo again, took 16 taps an output with stride-2 shared reads for
// down = 2, and stored 4 bytes a thread.
//
// General path (tiles). A kernel that is not separable, or a plane whose
// run would not fit in 48 KB of shared memory, takes the tile kernel: one
// thread block holds `ppb` (sample, channel) planes of one th x tw output
// tile. It first copies the input window that the tile reads, with its
// halo, into shared memory (one warp per row; zeros where the window
// leaves the image). Then its 256 threads sit 2^k >= tw to an output row,
// the rest on the following rows of every plane, and each sums the taps
// of its pixels from the window. The zeros of up = 2 are never
// materialised: a tap whose stuffed index is odd is skipped, the others
// read input pixel floor(u / 2). A 4x4 kernel is unrolled; others up to
// 8x8 loop. The taps, flipped on the host, travel in the kernel's
// parameter block, which the card serves from its constant cache as one
// broadcast per tap. Nothing crosses blocks: one pass, no atomics. The
// TPU kernel was VPU code built from strided slices and stacks, one image
// per grid step in VMEM; none of that carries over.
//
// Tile shape. Per axis, the output is cut into ceil(n / 32) equal tiles
// (33 -> 17 + 16), so that a ragged edge wastes few threads. A block
// takes up to four output pixels per thread, but fewer where the launch
// would then have under 4096 blocks (about four waves of 8 blocks on 132
// SMs).
//
// Bound. The kernel must read x once and write the output once:
// 4 * (P*H*W + P*OH*OW) bytes over 3.35 TB/s on an H100 SXM; its
// arithmetic (at most 2 * 64 flops per output) is far below the compute
// roof.
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

// n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1): with
// l = ceil(log2 d) and m = floor(2^32 (2^l - d) / d) + 1,
// n / d = (umulhi(m, n) + n) >> l.
struct FastDiv {
  uint32_t mul, shift;
};

FastDiv fast_div(uint32_t d) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  const uint64_t m = ((1ull << 32) * ((1ull << l) - d)) / d + 1;
  return {static_cast<uint32_t>(m), l};
}

__device__ __forceinline__ int quot(int n, FastDiv f) {
  return static_cast<int>(
      (__umulhi(f.mul, static_cast<uint32_t>(n)) + static_cast<uint32_t>(n)) >>
      f.shift);
}

// The whole-plane kernel's arguments: each axis's flipped taps split by
// output phase (up = 2: h[0] the even taps, h[1] the odd; up = 1: h[0]
// all), zero past the phase's length.
struct PlaneArgs {
  float hy[2][kMaxTaps], hx[2][kMaxTaps];
  FastDiv by_ow, by_oh;
  int P, H, W, OH, OW, pad0, ppb, vec_in, vec_out;
};

// The first input pixel and the phase of output o along an axis.
template <int UP, int DOWN>
__device__ __forceinline__ void phase_of(int o, int pad0, int& i0, int& ph) {
  const int q = o * DOWN - pad0;  // its first tap's zero-stuffed index
  ph = UP == 2 ? (q & 1) : 0;
  i0 = UP == 2 ? (q + ph) >> 1 : q;
}

// The note's whole-plane design: L taps a phase (unrolled; zero taps past
// the kernel's).
template <int UP, int DOWN, int L>
__global__ void __launch_bounds__(kThreads)
    upfirdn2d_planes_kernel(const float* __restrict__ x,
                            float* __restrict__ y, PlaneArgs a) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [ppb][H][W]
  const int plane0 = blockIdx.x * a.ppb;
  const int np = min(a.ppb, a.P - plane0);
  const int hw = a.H * a.W;
  float* tmp = xs + ((a.ppb * hw + 3) & ~3);  // [ppb][H][OW]
  const float* src = x + static_cast<int64_t>(plane0) * hw;
  const int n_in = np * hw;
  if (a.vec_in) {  // hw % 4 == 0, x 16-byte aligned
    for (int i = threadIdx.x; i < n_in / 4; i += kThreads)
      smem4[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
  } else {
    for (int i = threadIdx.x; i < n_in; i += kThreads) xs[i] = __ldg(src + i);
  }
  __syncthreads();

  // rows: tmp[p][r][ox] over the run's planes and input rows
  const int n_tmp = np * a.H * a.OW;
  for (int e = threadIdx.x; e < n_tmp; e += kThreads) {
    const int pr = quot(e, a.by_ow);  // p * H + r
    const int ox = e - pr * a.OW;
    int i0, ph;
    phase_of<UP, DOWN>(ox, a.pad0, i0, ph);
    const float* row = xs + pr * a.W;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int i = i0 + j;
      if (static_cast<unsigned>(i) < static_cast<unsigned>(a.W))
        acc += (ph ? a.hx[1][j] : a.hx[0][j]) * row[i];
    }
    tmp[e] = acc;
  }
  __syncthreads();

  // columns: the run's output, one span
  float* dst = y + static_cast<int64_t>(plane0) * a.OH * a.OW;
  const int n_out = np * a.OH * a.OW;
  if (a.vec_out) {  // OW % 4 == 0, y 16-byte aligned: four outputs a row
    for (int e = threadIdx.x * 4; e < n_out; e += kThreads * 4) {
      const int t = quot(e, a.by_ow);  // p * OH + oy
      const int ox = e - t * a.OW;
      const int p = quot(t, a.by_oh);
      int i0, ph;
      phase_of<UP, DOWN>(t - p * a.OH, a.pad0, i0, ph);
      const float* col = tmp + p * a.H * a.OW + ox;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int i = i0 + j;
        if (static_cast<unsigned>(i) < static_cast<unsigned>(a.H)) {
          const float w = ph ? a.hy[1][j] : a.hy[0][j];
          const float4 v = *reinterpret_cast<const float4*>(col + i * a.OW);
          acc.x += w * v.x;
          acc.y += w * v.y;
          acc.z += w * v.z;
          acc.w += w * v.w;
        }
      }
      *reinterpret_cast<float4*>(dst + e) = acc;
    }
  } else {
    for (int e = threadIdx.x; e < n_out; e += kThreads) {
      const int t = quot(e, a.by_ow);
      const int ox = e - t * a.OW;
      const int p = quot(t, a.by_oh);
      int i0, ph;
      phase_of<UP, DOWN>(t - p * a.OH, a.pad0, i0, ph);
      const float* col = tmp + p * a.H * a.OW + ox;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int i = i0 + j;
        if (static_cast<unsigned>(i) < static_cast<unsigned>(a.H))
          acc += (ph ? a.hy[1][j] : a.hy[0][j]) * col[i * a.OW];
      }
      dst[e] = acc;
    }
  }
}

// The shared memory of a run of ppb planes: the input, 16-byte aligned,
// then the rows' intermediate.
size_t plane_smem(int ppb, int H, int W, int OW) {
  return sizeof(float) * ((static_cast<size_t>(ppb) * H * W + 3) / 4 * 4 +
                          static_cast<size_t>(ppb) * H * OW);
}

// Splits a separable kernel's flipped factor f (n taps) by output phase.
void phase_taps(const float* f, int n, int up, float (&h)[2][kMaxTaps]) {
  for (int ph = 0; ph < 2; ++ph)
    for (int j = 0; j < kMaxTaps; ++j) {
      const int t = up == 2 ? 2 * j + ph : (ph == 0 ? j : n);
      h[ph][j] = t < n ? f[n - 1 - t] : 0.f;
    }
}

template <int UP, int DOWN>
int launch_planes(const float* x, float* y, const PlaneArgs& a, int taps,
                  cudaStream_t stream) {
  const dim3 grid((a.P + a.ppb - 1) / a.ppb);
  const size_t smem = plane_smem(a.ppb, a.H, a.W, a.OW);
  if (taps <= 2)
    upfirdn2d_planes_kernel<UP, DOWN, 2><<<grid, kThreads, smem, stream>>>(
        x, y, a);
  else if (taps <= 4)
    upfirdn2d_planes_kernel<UP, DOWN, 4><<<grid, kThreads, smem, stream>>>(
        x, y, a);
  else
    upfirdn2d_planes_kernel<UP, DOWN, 8><<<grid, kThreads, smem, stream>>>(
        x, y, a);
  return cudaGetLastError();
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
// unflipped. With ppb > 0 the whole-plane kernel runs `ppb` planes a
// block on the separable factors kcol [kh] and krow [kw] (host pointers;
// k = outer(kcol, krow)), with 16-byte loads where vec_in (H*W % 4 == 0,
// x 16-byte aligned) and 16-byte stores where vec_out (OW % 4 == 0, y
// 16-byte aligned); with ppb = 0 the tile kernel runs on k. Returns the
// cudaError_t of the launch.
int indm_upfirdn2d_fwd(const void* x, void* y, int P, int H, int W, int OH,
                       int OW, const float* k, const float* kcol,
                       const float* krow, int kh, int kw, int up, int down,
                       int pad0, int ppb, int vec_in, int vec_out,
                       void* stream) {
  if (P <= 0 || H <= 0 || W <= 0 || OH <= 0 || OW <= 0 || kh <= 0 ||
      kw <= 0 || kh > kMaxTaps || kw > kMaxTaps || pad0 < 0 || ppb < 0 ||
      up < 1 || up > 2 || down < 1 || down > 2)
    return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ppb > 0) {
    if (plane_smem(ppb, H, W, OW) > kSmemBytes ||
        (vec_in && (H * W % 4 || reinterpret_cast<uintptr_t>(x) % 16)) ||
        (vec_out && (OW % 4 || reinterpret_cast<uintptr_t>(y) % 16)))
      return cudaErrorInvalidValue;
    PlaneArgs a;
    phase_taps(kcol, kh, up, a.hy);
    phase_taps(krow, kw, up, a.hx);
    a.by_ow = fast_div(OW);
    a.by_oh = fast_div(OH);
    a.P = P, a.H = H, a.W = W, a.OH = OH, a.OW = OW, a.pad0 = pad0;
    a.ppb = ppb, a.vec_in = vec_in, a.vec_out = vec_out;
    const int taps = (std::max(kh, kw) + up - 1) / up;  // a phase, at most
    if (up == 1 && down == 1)
      return launch_planes<1, 1>(xf, yf, a, taps, st);
    if (up == 1 && down == 2)
      return launch_planes<1, 2>(xf, yf, a, taps, st);
    if (up == 2 && down == 1)
      return launch_planes<2, 1>(xf, yf, a, taps, st);
    return launch_planes<2, 2>(xf, yf, a, taps, st);
  }
  Taps taps = {};
  for (int ty = 0; ty < kh; ++ty)
    for (int tx = 0; tx < kw; ++tx)
      taps.w[ty * kMaxTaps + tx] = k[(kh - 1 - ty) * kw + (kw - 1 - tx)];
  if (up == 1 && down == 1)
    return launch<1, 1>(xf, yf, P, H, W, OH, OW, kh, kw, pad0, taps, st);
  if (up == 1 && down == 2)
    return launch<1, 2>(xf, yf, P, H, W, OH, OW, kh, kw, pad0, taps, st);
  if (up == 2 && down == 1)
    return launch<2, 1>(xf, yf, P, H, W, OH, OW, kh, kw, pad0, taps, st);
  return launch<2, 2>(xf, yf, P, H, W, OH, OW, kh, kw, pad0, taps, st);
}

}  // extern "C"
