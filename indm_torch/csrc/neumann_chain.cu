// The iResBlock log-det estimator's stop-gradient Neumann chain for Hopper
// (sm_90a), NCHW, float32.
//
// Replaces the TPU kernel `indm_tpu/ops/neumann_pallas.py:
// neumann_chain_pallas` (its oracle is `neumann_chain_ref`, same file):
//
//   acc = sum_{k=1}^{n+offset} (-1)^k coeff(k) (J^T)^k vareps,
//   J^T v = [D_in] W0^T D_mid W1^T D_out W2^T v,
//
// where W2^T is the transposed 3x3 conv C -> I, W1^T the transposed 1x1
// conv I -> I and W0^T the transposed 3x3 conv I -> C of the block's
// Lipschitz net (C = 3 or 12 image channels, I = 512 at full width), and
// D_out, D_mid, D_in the activation-derivative diagonals ([B, I, H, W],
// [B, I, H, W], [B, C, H, W]; D_in only for a pre-activated block). The
// signed coefficients (-1)^k coeff(k) come from the host, which drew n.
//
// Design. One term is three launches, each with its diagonal multiply in
// its epilogue, and the host runs the loop over k (n is known there, so
// nothing is read back from the card):
//   1. conv_in: t1 = D_out * conv3x3(v, W2^T). A block owns an 8x16 or
//      4x32 pixel tile of one sample and 64 output channels; the C-channel
//      halo tile and the 64 filters sit in shared memory, each thread keeps
//      its pixel's 9*C inputs in registers and walks the 64 filters.
//   2. gemm: t2 = D_mid * (W1^T t1), per sample an [I, I] x [I, H*W]
//      product: 128x128 tiles, k-steps of 8 through shared memory with the
//      next step's loads in flight in registers, 8x8 outputs per thread in
//      registers, float32 FMA.
//   3. conv_out: v = [D_in *] conv3x3(t2, W0^T); acc += coeff * v. A block
//      owns a pixel tile of one sample, walks the I input channels 16 at a
//      time through shared memory (halo tile and filters), and keeps the C
//      outputs of its pixel in registers.
// The TPU kernel kept the diagonals and the running vector in VMEM for all
// terms of a batch tile; a Hopper SM has 227 KB, far from the 2 x 2 MB of
// diagonals of one full-width sample, so the diagonals stream from device
// memory once per term instead.
//
// Bound. Operations: per term 2*B*H*W*(9*C*I + I*I + 9*I*C) flops, about
// 76 GFLOP at scale 0 (B=128, C=3, 32x32, I=512) and 24 GFLOP at scale 1
// (C=12, 16x16), against 67 TFLOP/s of float32 outside the tensor cores on
// an H100 SXM: 1.1 ms and 0.36 ms a term. Bytes: the inputs once (vareps,
// the diagonals, the weights) and acc once, about 0.54 GB at scale 0
// (0.16 ms at 3.35 TB/s). So the chain is bound by operations, and most of
// them (90 % at scale 0) are the 1x1 product, which is why that launch is
// a register-tiled GEMM. No tensor cores: float32 is the contract here (a
// TF32 or bf16 chain waits for the precision switches).
//
// Interface: plain C, loaded with ctypes (indm_torch/ops/neumann.py). All
// launches go on the caller's stream; the function returns the first CUDA
// error (0 on success) and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConvThreads = 128;
constexpr int kOcChunk = 64;    // output channels per conv_in block
constexpr int kInChunk = 16;    // input channels per conv_out step
constexpr int kMaxHalo = 6 * 34;  // (th + 2) * (tw + 2) for the widest tile

// conv_in: out[b, o, p] = d[b, o, p] * sum_{c, tap} w[o, c, tap] v[b, c, p + tap]
template <int C>
__global__ void __launch_bounds__(kConvThreads)
    conv_in_kernel(const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ d, float* __restrict__ out,
                   int I, int H, int W, int tw, int th) {
  constexpr int KC = C * 9;
  constexpr int KP = (KC + 3) & ~3;  // filter row padded to float4
  __shared__ __align__(16) float ws[kOcChunk * KP];
  __shared__ float tile[C * kMaxHalo];

  const int b = blockIdx.z;
  const int o0 = blockIdx.y * kOcChunk;
  const int tiles_x = (W + tw - 1) / tw;
  const int x0 = (blockIdx.x % tiles_x) * tw;
  const int y0 = (blockIdx.x / tiles_x) * th;
  const int hw2 = (th + 2) * (tw + 2);
  const int tid = threadIdx.x;
  const float* vb = v + static_cast<int64_t>(b) * C * H * W;

  for (int i = tid; i < C * hw2; i += kConvThreads) {
    const int c = i / hw2, r = i % hw2;
    const int yy = y0 - 1 + r / (tw + 2), xx = x0 - 1 + r % (tw + 2);
    tile[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                  ? vb[(static_cast<int64_t>(c) * H + yy) * W + xx]
                  : 0.f;
  }
  for (int i = tid; i < kOcChunk * KP; i += kConvThreads) {
    const int o = i / KP, j = i % KP;
    ws[i] = (o0 + o < I && j < KC) ? w[static_cast<int64_t>(o0 + o) * KC + j]
                                   : 0.f;
  }
  __syncthreads();

  const int px = tid % tw, py = tid / tw;
  const int x = x0 + px, y = y0 + py;
  if (py >= th || x >= W || y >= H) return;
  float r[KP];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        r[c * 9 + dy * 3 + dx] =
            tile[c * hw2 + (py + dy) * (tw + 2) + px + dx];
#pragma unroll
  for (int j = KC; j < KP; ++j) r[j] = 0.f;

  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t pix = static_cast<int64_t>(y) * W + x;
  const int oc_n = min(kOcChunk, I - o0);
  for (int o = 0; o < oc_n; ++o) {
    const float4* wr = reinterpret_cast<const float4*>(ws + o * KP);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < KP / 4; ++j) {
      const float4 q = wr[j];
      s = fmaf(r[4 * j], q.x, s);
      s = fmaf(r[4 * j + 1], q.y, s);
      s = fmaf(r[4 * j + 2], q.z, s);
      s = fmaf(r[4 * j + 3], q.w, s);
    }
    const int64_t idx = (static_cast<int64_t>(b) * I + o0 + o) * hw + pix;
    out[idx] = s * d[idx];
  }
}

// gemm: c[b] = d[b] * (a @ bm[b]); a [M, K], bm[b] [K, N], c[b], d[b]
// [M, N], all row-major. K and N are multiples of 4 (checked by the host).
constexpr int kGM = 128, kGN = 128, kGK = 8;

__global__ void __launch_bounds__(256)
    gemm_dmul_kernel(const float* __restrict__ a, const float* __restrict__ bm,
                     const float* __restrict__ d, float* __restrict__ c,
                     int M, int N, int K) {
  __shared__ __align__(16) float as[kGK][kGM];
  __shared__ __align__(16) float bs[kGK][kGN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  bm += static_cast<int64_t>(blockIdx.z) * K * N;
  d += static_cast<int64_t>(blockIdx.z) * M * N;
  c += static_cast<int64_t>(blockIdx.z) * M * N;

  // loaders: a tile 128 rows x 8, b tile 8 rows x 128, 4 floats a thread
  const int a_row = tid >> 1, a_col = (tid & 1) * 4;
  const int b_row = tid >> 5, b_col = (tid & 31) * 4;
  auto load_a = [&](int k0) {
    const int m = m0 + a_row, k = k0 + a_col;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < M && k < K)  // K % 4 == 0: the whole vector is in range
      q = *reinterpret_cast<const float4*>(a + static_cast<int64_t>(m) * K + k);
    return q;
  };
  auto load_b = [&](int k0) {
    const int k = k0 + b_row, n = n0 + b_col;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < K && n < N)  // N % 4 == 0
      q = *reinterpret_cast<const float4*>(bm + static_cast<int64_t>(k) * N + n);
    return q;
  };

  // this thread's outputs: rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
  // columns tx*4 + {0..3} and 64 + tx*4 + {0..3}
  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra = load_a(0), rb = load_b(0);
  for (int k0 = 0; k0 < K; k0 += kGK) {
    as[a_col][a_row] = ra.x;
    as[a_col + 1][a_row] = ra.y;
    as[a_col + 2][a_row] = ra.z;
    as[a_col + 3][a_row] = ra.w;
    *reinterpret_cast<float4*>(&bs[b_row][b_col]) = rb;
    __syncthreads();
    if (k0 + kGK < K) {
      ra = load_a(k0 + kGK);
      rb = load_b(k0 + kGK);
    }
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + tx * 4;
      if (n >= N) continue;
      const int64_t idx = static_cast<int64_t>(m) * N + n;
      const float4 dv = *reinterpret_cast<const float4*>(d + idx);
      float4 out;
      out.x = acc[i][half * 4] * dv.x;
      out.y = acc[i][half * 4 + 1] * dv.y;
      out.z = acc[i][half * 4 + 2] * dv.z;
      out.w = acc[i][half * 4 + 3] * dv.w;
      *reinterpret_cast<float4*>(c + idx) = out;
    }
  }
}

// conv_out: val[b, c, p] = [d[b, c, p] *] sum_{i, tap} w[c, i, tap]
// t[b, i, p + tap]; v = val; acc += coeff * val.
template <int C>
__global__ void __launch_bounds__(kConvThreads)
    conv_out_kernel(const float* __restrict__ t, const float* __restrict__ w,
                    const float* __restrict__ d, float* __restrict__ v,
                    float* __restrict__ acc, float coeff, int I, int H, int W,
                    int tw, int th) {
  __shared__ float tile[kInChunk * kMaxHalo];
  __shared__ float ws[C * kInChunk * 9];

  const int b = blockIdx.z;
  const int tiles_x = (W + tw - 1) / tw;
  const int x0 = (blockIdx.x % tiles_x) * tw;
  const int y0 = (blockIdx.x / tiles_x) * th;
  const int hw2 = (th + 2) * (tw + 2);
  const int tid = threadIdx.x;
  const int px = tid % tw, py = tid / tw;
  const int x = x0 + px, y = y0 + py;
  const bool inside = py < th && x < W && y < H;
  const float* tb = t + static_cast<int64_t>(b) * I * H * W;

  float s[C];
#pragma unroll
  for (int c = 0; c < C; ++c) s[c] = 0.f;

  for (int i0 = 0; i0 < I; i0 += kInChunk) {
    for (int i = tid; i < kInChunk * hw2; i += kConvThreads) {
      const int ci = i / hw2, r = i % hw2;
      const int yy = y0 - 1 + r / (tw + 2), xx = x0 - 1 + r % (tw + 2);
      tile[i] = (i0 + ci < I && yy >= 0 && yy < H && xx >= 0 && xx < W)
                    ? tb[(static_cast<int64_t>(i0 + ci) * H + yy) * W + xx]
                    : 0.f;
    }
    for (int i = tid; i < C * kInChunk * 9; i += kConvThreads) {
      const int c = i / (kInChunk * 9), rem = i % (kInChunk * 9);
      const int ci = rem / 9, tap = rem % 9;
      ws[i] = (i0 + ci < I)
                  ? w[(static_cast<int64_t>(c) * I + i0 + ci) * 9 + tap]
                  : 0.f;
    }
    __syncthreads();
    if (inside) {
#pragma unroll 4
      for (int ci = 0; ci < kInChunk; ++ci) {
        float r[9];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            r[dy * 3 + dx] = tile[ci * hw2 + (py + dy) * (tw + 2) + px + dx];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float* wc = ws + (c * kInChunk + ci) * 9;
#pragma unroll
          for (int k = 0; k < 9; ++k) s[c] = fmaf(r[k], wc[k], s[c]);
        }
      }
    }
    __syncthreads();
  }

  if (!inside) return;
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int64_t pix = static_cast<int64_t>(y) * W + x;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int64_t idx = (static_cast<int64_t>(b) * C + c) * hw + pix;
    const float val = d ? s[c] * d[idx] : s[c];
    v[idx] = val;
    acc[idx] += coeff * val;
  }
}

template <int C>
cudaError_t run_chain(const float* vareps, const float* d_out,
                      const float* d_mid, const float* d_in,
                      const float* w_in, const float* w_mid,
                      const float* w_out, const float* coeffs, int n_terms,
                      float* acc, float* v, float* t1, float* t2, int B,
                      int H, int W, int I, cudaStream_t stream) {
  const size_t vbytes = static_cast<size_t>(B) * C * H * W * sizeof(float);
  cudaError_t err = cudaMemsetAsync(acc, 0, vbytes, stream);
  if (err != cudaSuccess) return err;
  const int tw = W >= 32 ? 32 : (W >= 16 ? 16 : 8);
  const int th = kConvThreads / tw;
  const int tiles = ((W + tw - 1) / tw) * ((H + th - 1) / th);
  const dim3 grid_in(tiles, (I + kOcChunk - 1) / kOcChunk, B);
  const dim3 grid_mm((H * W + kGN - 1) / kGN, (I + kGM - 1) / kGM, B);
  const dim3 grid_out(tiles, 1, B);
  for (int k = 0; k < n_terms; ++k) {
    conv_in_kernel<C><<<grid_in, kConvThreads, 0, stream>>>(
        k == 0 ? vareps : v, w_in, d_out, t1, I, H, W, tw, th);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    gemm_dmul_kernel<<<grid_mm, 256, 0, stream>>>(w_mid, t1, d_mid, t2, I,
                                                  H * W, I);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    conv_out_kernel<C><<<grid_out, kConvThreads, 0, stream>>>(
        t2, w_out, d_in, v, acc, coeffs[k], I, H, W, tw, th);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// vareps, acc, v: [B, C, H, W]; d_out, d_mid, t1, t2: [B, I, H, W];
// d_in: [B, C, H, W] or null (a block without pre-activation);
// w_in: [I, C, 3, 3] (W2^T), w_mid: [I, I] (W1^T), w_out: [C, I, 3, 3]
// (W0^T); all float32, contiguous, on the card. coeffs: n_terms host
// floats, (-1)^k coeff(k) for k = 1..n_terms. v, t1, t2 are scratch.
// C must be 3 or 12; H*W and I multiples of 4. Returns a cudaError_t.
int indm_neumann_chain(const void* vareps, const void* d_out,
                       const void* d_mid, const void* d_in, const void* w_in,
                       const void* w_mid, const void* w_out,
                       const float* coeffs, int n_terms, void* acc, void* v,
                       void* t1, void* t2, int B, int C, int H, int W, int I,
                       void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || I <= 0 || n_terms < 0 || (H * W) % 4 ||
      I % 4)
    return cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 3)
    return run_chain<3>(f(vareps), f(d_out), f(d_mid), f(d_in), f(w_in),
                        f(w_mid), f(w_out), coeffs, n_terms,
                        static_cast<float*>(acc), static_cast<float*>(v),
                        static_cast<float*>(t1), static_cast<float*>(t2), B,
                        H, W, I, st);
  if (C == 12)
    return run_chain<12>(f(vareps), f(d_out), f(d_mid), f(d_in), f(w_in),
                         f(w_mid), f(w_out), coeffs, n_terms,
                         static_cast<float*>(acc), static_cast<float*>(v),
                         static_cast<float*>(t1), static_cast<float*>(t2), B,
                         H, W, I, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
