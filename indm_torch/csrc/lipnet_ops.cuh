// Device code of the iResBlock's Lipschitz net for Hopper (sm_90a), NCHW,
// float32: the three layers of the 3-1-3 net, each with an epilogue
// functor, shared by the Neumann chain (neumann_chain.cu), the fused
// iResBlock pair and stacks (fused_block.cu, fused_stack.cu), the fully
// fused chain (fused_chain.cu) and the narrow-channel conv (narrow_conv.cu).
//
// With C = 3 or 12 image channels and I the width (512 at full width):
//   conv_in:  s[b, o, p] = sum_{c, tap} w[o, c, tap] v[b, c, p + tap]
//             (a 3x3 SAME conv C -> I, w [I, C, 3, 3]). A block owns an
//             8x16 or 4x32 pixel tile of one sample and 64 output channels;
//             the C-channel halo tile and the 64 filters sit in shared
//             memory, each thread keeps its pixel's 9*C inputs in registers
//             and walks the 64 filters.
//   gemm:     s[b] = A[b] @ B[b] (+ A'[b] @ B'[b]), 128x128 tiles, k-steps
//             of 8 through shared memory with the next step's loads in
//             flight in registers, 8x8 outputs per thread in registers,
//             float32 FMA. A is [M, K] row-major, B is [K, N] row-major or,
//             with kBT, [N, K] row-major (the weight gradient of a 1x1
//             conv, which contracts over pixels). A per-batch stride of 0
//             shares an operand (a weight) across the batch.
//   conv_out: s[b, c, p] = sum_{i, tap} w[c, i, tap] t[b, i, p + tap]
//             (a 3x3 SAME conv I -> C, w [C, I, 3, 3]). A block owns a
//             pixel tile of one sample, walks the I input channels 16 at a
//             time through shared memory (halo tile and filters), and keeps
//             the C outputs of its pixel in registers.
// conv_in and conv_out load their operands as float or bfloat16 (T) and
// widen them to float in shared memory; the sums are float32 either way,
// and a float operand compiles to the plain float loads.
// Each kernel hands every output to its epilogue, which writes it: the
// chain multiplies by a diagonal, the forward adds a bias and takes
// sin/cos, the backward stores. The epilogues get (idx, b, channel, value)
// with idx the output's flat index in [B, channels, H, W] (gemm: in
// [B, M, N], and four consecutive values as a float4).
//
// J^T v = [D_in] W0^T D_mid W1^T D_out W2^T v is one conv_in, one gemm and
// one conv_out (`launch_jt`); the stop-gradient Neumann chain
// acc = sum_{k=1}^{n+offset} (-1)^k coeff(k) (J^T)^k vareps is n + offset
// of them (`run_chain`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lipnet {

constexpr int kConvThreads = 128;
constexpr int kOcChunk = 64;    // output channels per conv_in block
constexpr int kInChunk = 16;    // input channels per conv_out step
constexpr int kMaxHalo = 6 * 34;  // (th + 2) * (tw + 2) for the widest tile

// a stored element as float
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// conv_in: epi(idx, b, o, sum_{c, tap} w[o, c, tap] v[b, c, p + tap])
template <int C, class Epi, class T>
__global__ void __launch_bounds__(kConvThreads)
    conv_in_kernel(const T* __restrict__ v, const T* __restrict__ w,
                   Epi epi, int I, int H, int W, int tw, int th) {
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
  const T* vb = v + static_cast<int64_t>(b) * C * H * W;

  for (int i = tid; i < C * hw2; i += kConvThreads) {
    const int c = i / hw2, r = i % hw2;
    const int yy = y0 - 1 + r / (tw + 2), xx = x0 - 1 + r % (tw + 2);
    tile[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                  ? to_f32(vb[(static_cast<int64_t>(c) * H + yy) * W + xx])
                  : 0.f;
  }
  for (int i = tid; i < kOcChunk * KP; i += kConvThreads) {
    const int o = i / KP, j = i % KP;
    ws[i] = (o0 + o < I && j < KC)
                ? to_f32(w[static_cast<int64_t>(o0 + o) * KC + j])
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
    epi((static_cast<int64_t>(b) * I + o0 + o) * hw + pix, b, o0 + o, s);
  }
}

// gemm: epi(idx, b, m, 4 sums from column n) over the [M, N] outputs of
// sum_pairs A[b] @ B[b]; idx = (b * M + m) * N + n. K and N are multiples
// of 4 (checked by the host).
constexpr int kGM = 128, kGN = 128, kGK = 8;

struct GemmArgs {
  const float* a[2];
  const float* b[2];
  int pairs;
  int64_t a_bs, b_bs;  // per-batch strides in floats; 0 shares the operand
  int M, N, K;
};

template <bool kBT, class Epi>
__global__ void __launch_bounds__(256) gemm_kernel(GemmArgs g, Epi epi) {
  __shared__ __align__(16) float as[kGK][kGM];
  __shared__ __align__(16) float bs[kGK][kGN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int z = blockIdx.z;
  const int M = g.M, N = g.N, K = g.K;

  // loaders: a 128 x 8 tile of a K-contiguous operand, 4 floats a thread
  // (rows tid / 2); a tile 8 rows x 128 of a row-major [K, N] operand
  const int a_row = tid >> 1, a_col = (tid & 1) * 4;
  const int b_row = tid >> 5, b_col = (tid & 31) * 4;

  // this thread's outputs: rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
  // columns tx*4 + {0..3} and 64 + tx*4 + {0..3}
  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int pr = 0; pr < g.pairs; ++pr) {
    // constant indices keep the arguments out of local memory
    const float* a = (pr ? g.a[1] : g.a[0]) + static_cast<int64_t>(z) * g.a_bs;
    const float* bm =
        (pr ? g.b[1] : g.b[0]) + static_cast<int64_t>(z) * g.b_bs;
    auto load_a = [&](int k0) {
      const int m = m0 + a_row, k = k0 + a_col;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M && k < K)  // K % 4 == 0: the whole vector is in range
        q = *reinterpret_cast<const float4*>(a + static_cast<int64_t>(m) * K +
                                             k);
      return q;
    };
    auto load_b = [&](int k0) {
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kBT) {
        const int n = n0 + a_row, k = k0 + a_col;
        if (n < N && k < K)
          q = *reinterpret_cast<const float4*>(
              bm + static_cast<int64_t>(n) * K + k);
      } else {
        const int k = k0 + b_row, n = n0 + b_col;
        if (k < K && n < N)  // N % 4 == 0
          q = *reinterpret_cast<const float4*>(
              bm + static_cast<int64_t>(k) * N + n);
      }
      return q;
    };

    float4 ra = load_a(0), rb = load_b(0);
    for (int k0 = 0; k0 < K; k0 += kGK) {
      as[a_col][a_row] = ra.x;
      as[a_col + 1][a_row] = ra.y;
      as[a_col + 2][a_row] = ra.z;
      as[a_col + 3][a_row] = ra.w;
      if (kBT) {
        bs[a_col][a_row] = rb.x;
        bs[a_col + 1][a_row] = rb.y;
        bs[a_col + 2][a_row] = rb.z;
        bs[a_col + 3][a_row] = rb.w;
      } else {
        *reinterpret_cast<float4*>(&bs[b_row][b_col]) = rb;
      }
      __syncthreads();
      if (k0 + kGK < K) {
        ra = load_a(k0 + kGK);
        rb = load_b(k0 + kGK);
      }
#pragma unroll
      for (int kk = 0; kk < kGK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&as[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&bs[kk][64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + tx * 4;
      if (n >= N) continue;
      epi((static_cast<int64_t>(z) * M + m) * N + n, z, m,
          make_float4(acc[i][half * 4], acc[i][half * 4 + 1],
                      acc[i][half * 4 + 2], acc[i][half * 4 + 3]));
    }
  }
}

// conv_out: epi(idx, b, c, sum_{i, tap} w[c, i, tap] t[b, i, p + tap])
template <int C, class Epi, class T>
__global__ void __launch_bounds__(kConvThreads)
    conv_out_kernel(const T* __restrict__ t, const T* __restrict__ w,
                    Epi epi, int I, int H, int W, int tw, int th) {
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
  const T* tb = t + static_cast<int64_t>(b) * I * H * W;

  float s[C];
#pragma unroll
  for (int c = 0; c < C; ++c) s[c] = 0.f;

  for (int i0 = 0; i0 < I; i0 += kInChunk) {
    for (int i = tid; i < kInChunk * hw2; i += kConvThreads) {
      const int ci = i / hw2, r = i % hw2;
      const int yy = y0 - 1 + r / (tw + 2), xx = x0 - 1 + r % (tw + 2);
      tile[i] = (i0 + ci < I && yy >= 0 && yy < H && xx >= 0 && xx < W)
                    ? to_f32(
                          tb[(static_cast<int64_t>(i0 + ci) * H + yy) * W + xx])
                    : 0.f;
    }
    for (int i = tid; i < C * kInChunk * 9; i += kConvThreads) {
      const int c = i / (kInChunk * 9), rem = i % (kInChunk * 9);
      const int ci = rem / 9, tap = rem % 9;
      ws[i] = (i0 + ci < I)
                  ? to_f32(w[(static_cast<int64_t>(c) * I + i0 + ci) * 9 + tap])
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
  for (int c = 0; c < C; ++c)
    epi((static_cast<int64_t>(b) * C + c) * hw + pix, b, c, s[c]);
}

// ---- epilogues ----

struct Store {  // out = s
  float* out;
  __device__ void operator()(int64_t idx, int, int, float s) const {
    out[idx] = s;
  }
  __device__ void operator()(int64_t idx, int, int, float4 s) const {
    *reinterpret_cast<float4*>(out + idx) = s;
  }
};

struct DMul {  // out = s * d (a diagonal of the chain)
  const float* d;
  float* out;
  __device__ void operator()(int64_t idx, int, int, float s) const {
    out[idx] = s * d[idx];
  }
  __device__ void operator()(int64_t idx, int, int, float4 s) const {
    const float4 dv = *reinterpret_cast<const float4*>(d + idx);
    *reinterpret_cast<float4*>(out + idx) =
        make_float4(s.x * dv.x, s.y * dv.y, s.z * dv.z, s.w * dv.w);
  }
};

struct ChainOut {  // val = [d *] s; v = val; acc += coeff * val
  const float* d;
  float* v;
  float* acc;
  float coeff;
  __device__ void operator()(int64_t idx, int, int, float s) const {
    const float val = d ? s * d[idx] : s;
    v[idx] = val;
    acc[idx] += coeff * val;
  }
};

// ---- host side ----

struct Geometry {
  int B, H, W, I;
  int tw, th, tiles;
  Geometry(int B_, int H_, int W_, int I_) : B(B_), H(H_), W(W_), I(I_) {
    tw = W >= 32 ? 32 : (W >= 16 ? 16 : 8);
    th = kConvThreads / tw;
    tiles = ((W + tw - 1) / tw) * ((H + th - 1) / th);
  }
  dim3 grid_in() const { return dim3(tiles, (I + kOcChunk - 1) / kOcChunk, B); }
  dim3 grid_out() const { return dim3(tiles, 1, B); }
  // an [M, N] output per sample
  dim3 grid_mm(int M, int N) const {
    return dim3((N + kGN - 1) / kGN, (M + kGM - 1) / kGM, B);
  }
};

template <int C, class Epi, class T>
cudaError_t conv_in(const Geometry& g, const T* v, const T* w, Epi epi,
                    cudaStream_t st) {
  conv_in_kernel<C><<<g.grid_in(), kConvThreads, 0, st>>>(v, w, epi, g.I, g.H,
                                                          g.W, g.tw, g.th);
  return cudaGetLastError();
}

template <int C, class Epi, class T>
cudaError_t conv_out(const Geometry& g, const T* t, const T* w, Epi epi,
                     cudaStream_t st) {
  conv_out_kernel<C><<<g.grid_out(), kConvThreads, 0, st>>>(
      t, w, epi, g.I, g.H, g.W, g.tw, g.th);
  return cudaGetLastError();
}

// [I, I] weight @ the sample's [I, H*W] activations, for each sample
template <class Epi>
cudaError_t mat_wide(const Geometry& g, const float* w, const float* t,
                     Epi epi, cudaStream_t st) {
  GemmArgs a{{w, nullptr}, {t, nullptr}, 1, 0,
             static_cast<int64_t>(g.I) * g.H * g.W, g.I, g.H * g.W, g.I};
  gemm_kernel<false><<<g.grid_mm(g.I, g.H * g.W), 256, 0, st>>>(a, epi);
  return cudaGetLastError();
}

// J^T v: t1 = D_out * conv(v, W2^T); t2 = D_mid * (W1^T t1); then
// out_epi(conv(t2, W0^T)) (the epilogue applies D_in where there is one).
template <int C, class OutEpi>
cudaError_t launch_jt(const Geometry& g, const float* v, const float* w_in,
                      const float* d_out, const float* w_mid,
                      const float* d_mid, const float* w_out, OutEpi out_epi,
                      float* t1, float* t2, cudaStream_t st) {
  cudaError_t err;
  if ((err = conv_in<C>(g, v, w_in, DMul{d_out, t1}, st)) != cudaSuccess)
    return err;
  if ((err = mat_wide(g, w_mid, t1, DMul{d_mid, t2}, st)) != cudaSuccess)
    return err;
  return conv_out<C>(g, t2, w_out, out_epi, st);
}

// acc = sum_k coeffs[k] (J^T)^(k+1) vareps; v, t1, t2 are scratch.
template <int C>
cudaError_t run_chain(const Geometry& g, const float* vareps,
                      const float* d_out, const float* d_mid,
                      const float* d_in, const float* w_in,
                      const float* w_mid, const float* w_out,
                      const float* coeffs, int n_terms, float* acc, float* v,
                      float* t1, float* t2, cudaStream_t st) {
  const size_t vbytes =
      static_cast<size_t>(g.B) * C * g.H * g.W * sizeof(float);
  cudaError_t err = cudaMemsetAsync(acc, 0, vbytes, st);
  if (err != cudaSuccess) return err;
  for (int k = 0; k < n_terms; ++k) {
    err = launch_jt<C>(g, k == 0 ? vareps : v, w_in, d_out, w_mid, d_mid,
                       w_out, ChainOut{d_in, v, acc, coeffs[k]}, t1, t2, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace lipnet
