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
//             (a 3x3 SAME conv I -> C, w [C, I, 3, 3]). A block owns a band
//             of rows of one sample (its full width up to 32 columns,
//             strips of 32 beyond) and all I input channels, split in 8
//             runs, one per warp. Each warp streams its run through a stage
//             of its own in shared memory with the next channel's loads in
//             flight; each lane keeps R rows of two columns for all C
//             outputs in registers; the warps' partial sums are added in
//             warp order before the epilogue (the note at conv_out_kernel).
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
constexpr int kMaxHalo = 6 * 34;  // (th + 2) * (tw + 2), the widest tile

// a stored element as float
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// element e of a 4-byte word of stored elements (the lower address first)
template <class T>
__device__ __forceinline__ float word_half(uint32_t w, int e);
template <>
__device__ __forceinline__ float word_half<float>(uint32_t w, int) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ float word_half<__nv_bfloat16>(uint32_t w, int e) {
  return __uint_as_float(e ? w & 0xffff0000u : w << 16);
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

// conv_out: epi(idx, b, c, sum_{i, tap} w[c, i, tap] t[b, i, p + tap]).
// A block owns a band of TH rows and TW columns of one sample and all I
// input channels, split in kOutWarps contiguous runs, one per warp. Lane l
// of each warp owns the two columns 2 (l % (TW / 2)) + {0, 1} and the R
// rows (l / (TW / 2)) * R + [0, R) of the band, for all C outputs: per
// channel it reads the 4 x (R + 2) inputs around its columns as float2
// pairs and each filter as float4 broadcasts, for 2 * R * 9 * C FMAs. A
// warp walks its channels one at a time through its own stage in shared
// memory: it stores the channel it loaded, issues the loads of the next
// into registers (4-byte words, two bfloat16 each), and computes the
// stored one while they are in flight, with no block-wide barrier. Then
// the warps' partial sums meet in shared memory and are added in warp
// order, and each output goes once to the epilogue. The split and the tile
// depend on (C, I, W, T) only, so every caller and every batch size gets
// the same bits.
// Bound at the port's shapes (B = 128, I = 512): 2*B*H*W*9*C*I = 3.6
// GFLOP at both flow scales, 0.054 ms of float32 FMA at 67 TFLOP/s; the
// wide input is 268 MB in float32 at C = 3, 32x32 (0.080 ms at 3.35 TB/s:
// bound by bytes) and 67 MB at C = 12, 16x16 (0.020 ms: bound by
// operations). A lane does 18 * R * C FMAs a channel for 2 * (R + 2) tile
// reads and 3 * C filter reads (216 for 21 at C = 3, R = 4; 432 for 44 at
// C = 12, R = 2). Words of 4 bytes keep a bfloat16 load request as full as
// a float32 one. No tensor cores:
// kernels 3-8 share this code and are float32 by contract; a bf16 `mma`
// path (C padded to 8 or 16 rows) waits for the precision switches.
constexpr int kOutWarps = 8;  // the split of the input channels
constexpr int kOutThreads = 32 * kOutWarps;

// the shared row stride of a halo tile: TW + 2 columns, even (8-byte
// rows), padded so that the row groups of a half-warp read disjoint banks
constexpr int out_row_stride(int tw, int r) {
  int s = tw + 2;
  if (tw < 32)
    while ((r * s) % 32 != tw) s += 2;
  return s;
}

template <int C, int TW>
struct OutTile {
  static constexpr int kLanes = TW / 2;      // lanes of a row group
  static constexpr int kGroups = 32 / kLanes;  // row groups of a warp
  static constexpr int R = (C == 3 && TW == 32) ? 4 : 2;  // rows a lane
  static constexpr int TH = kGroups * R;                   // rows of a band
  static constexpr int kRows = TH + 2;                     // with the halo
  static constexpr int RS = out_row_stride(TW, R);
  // one channel's halo tile and a spare cell, then its C filters (taps
  // padded to 12), in float4-aligned runs: a warp's stage
  static constexpr int kSpare = kRows * RS;
  static constexpr int kTile = (kSpare + 1 + 3) / 4 * 4;
  static constexpr int kStage = kTile + C * 12;
  static constexpr int kFiltLoads = (C * 9 + 31) / 32;
  static constexpr int kRedC = 3;  // outputs reduced in one pass
  static constexpr int kRed = kOutWarps * kRedC * TH * TW;
  static constexpr int kSmem =
      kOutWarps * kStage > kRed ? kOutWarps * kStage : kRed;
  static_assert(C % kRedC == 0, "C must be a multiple of kRedC");
};

template <int C, int TW, class Epi, class T>
__global__ void __launch_bounds__(kOutThreads, 2)
    conv_out_kernel(const T* __restrict__ t, const T* __restrict__ w,
                    Epi epi, int I, int H, int W) {
  using Tile = OutTile<C, TW>;
  constexpr int R = Tile::R, TH = Tile::TH, RS = Tile::RS;
  constexpr int kRows = Tile::kRows, kFiltLoads = Tile::kFiltLoads;
  __shared__ __align__(16) float smem[Tile::kSmem];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = lane % Tile::kLanes, grp = lane / Tile::kLanes;
  const int strips = (W + TW - 1) / TW;
  const int x0 = (blockIdx.x % strips) * TW;
  const int y0 = (blockIdx.x / strips) * TH;
  const int b = blockIdx.z;
  const int64_t hw = static_cast<int64_t>(H) * W;
  const T* tb = t + static_cast<int64_t>(b) * I * hw;
  const int lo = warp * I / kOutWarps, hi = (warp + 1) * I / kOutWarps;
  float* tile = smem + warp * Tile::kStage;
  float* filt = tile + Tile::kTile;

  // A lane's loads of a channel: 4-byte words (kEPW elements), word
  // q = lane + 32 k from tile row q / kWords, which holds the segment of
  // columns x0 - 1 .. x0 + TW of image row y0 - 1 + q / kWords. A row's
  // first word starts at the segment's first element or, when that element
  // is the second half of an aligned word (parity p = 1, bfloat16 only), one
  // element before; a word's half outside the segment goes to the stage's
  // spare cell. A word is loaded only when it holds an image element, so no
  // load leaves the aligned words that hold the tensor. Per lane and
  // word, the same in every channel: ws, the word's first element in the
  // channel's plane at parity 0; cell, its place in the tile; bits 2 e and
  // 2 e + 1 of field k of bits[p]: element e of word k at parity p is in the
  // segment, and holds an image value (else a zero).
  constexpr int kEPW = 4 / static_cast<int>(sizeof(T));
  constexpr int kSeg = TW + 2;
  constexpr int kWords = (kSeg + 2 * (kEPW - 1)) / kEPW;
  constexpr int kWordLoads = (kRows * kWords + 31) / 32;
  constexpr int kField = 2 * kEPW;
  constexpr uint32_t kImage = kEPW == 1 ? 0x2u : 0xAu;  // a field's image bits
  static_assert(sizeof(T) == 4 || sizeof(T) == 2, "float or bfloat16");
  static_assert(kWordLoads * kField <= 32, "a parity's bits fit 32");
  const int64_t plane0 = static_cast<int64_t>(b) * I * hw;
  const int tpar =
      static_cast<int>(reinterpret_cast<uintptr_t>(t) / sizeof(T)) &
      (kEPW - 1);
  int ws[kWordLoads], cell[kWordLoads];
  uint32_t bits[kEPW] = {};
#pragma unroll
  for (int k = 0; k < kWordLoads; ++k) {
    const int q = lane + 32 * k, r = q / kWords, wi = q % kWords;
    const int y = y0 - 1 + r;
    ws[k] = y * W + x0 - 1 + wi * kEPW;
    cell[k] = r * RS + wi * kEPW;
#pragma unroll
    for (int p = 0; p < kEPW; ++p)
#pragma unroll
      for (int e = 0; e < kEPW; ++e) {
        const int pos = wi * kEPW - p + e, x = x0 - 1 + pos;
        const bool seg = q < kRows * kWords && pos >= 0 && pos < kSeg;
        const bool image = seg && y >= 0 && y < H && x >= 0 && x < W;
        bits[p] |= ((seg ? 1u : 0u) | (image ? 2u : 0u))
                   << (k * kField + 2 * e);
      }
  }
  // w[c, i, tap] at (c * I + i) * 9 + tap: element e = c * 9 + tap of a
  // channel's filters, or -1 past them
  int fsrc[kFiltLoads];
#pragma unroll
  for (int k = 0; k < kFiltLoads; ++k) {
    const int e = lane + 32 * k;
    fsrc[k] = e < C * 9 ? (e / 9) * I * 9 + e % 9 : -1;
  }

  uint32_t pw[kWordLoads];  // the next channel, in flight
  int ppar[kWordLoads];
  float pf[kFiltLoads];
  auto load = [&](int ch) {
    const int64_t plane = plane0 + static_cast<int64_t>(ch) * hw;
    const int chpar = (tpar + static_cast<int>(plane)) & (kEPW - 1);
#pragma unroll
    for (int k = 0; k < kWordLoads; ++k) {
      const int p = (chpar + ws[k]) & (kEPW - 1);
      const uint32_t m = p ? bits[kEPW - 1] : bits[0];
      ppar[k] = p;
      pw[k] = (m >> (k * kField)) & kImage
                  ? __ldg(reinterpret_cast<const uint32_t*>(
                        t + plane + ws[k] - p))
                  : 0u;
    }
#pragma unroll
    for (int k = 0; k < kFiltLoads; ++k)
      pf[k] = fsrc[k] >= 0 ? to_f32(w[ch * 9 + fsrc[k]]) : 0.f;
  };
  auto store = [&]() {
#pragma unroll
    for (int k = 0; k < kWordLoads; ++k) {
      const uint32_t m = (ppar[k] ? bits[kEPW - 1] : bits[0]) >> (k * kField);
#pragma unroll
      for (int e = 0; e < kEPW; ++e)
        tile[(m >> (2 * e)) & 1 ? cell[k] - ppar[k] + e : Tile::kSpare] =
            (m >> (2 * e + 1)) & 1 ? word_half<T>(pw[k], e) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kFiltLoads; ++k) {
      const int e = lane + 32 * k;
      if (e < C * 9) filt[(e / 9) * 12 + e % 9] = pf[k];
    }
  };

  float acc[R][2][C];  // rows grp * R + r, columns 2 pair and 2 pair + 1
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][j][c] = 0.f;

  if (lo < hi) load(lo);
  for (int ch = lo; ch < hi; ++ch) {
    __syncwarp();  // the last channel's reads are done
    store();
    __syncwarp();
    if (ch + 1 < hi) load(ch + 1);
    // tile cells 2 pair .. 2 pair + 3 of each row: columns 2 pair - 1 ..
    // 2 pair + 2 of the band
    const float* in = tile + grp * R * RS + 2 * pair;
    float v[R + 2][4];
#pragma unroll
    for (int rr = 0; rr < R + 2; ++rr) {
      const float2 a = *reinterpret_cast<const float2*>(in + rr * RS);
      const float2 z = *reinterpret_cast<const float2*>(in + rr * RS + 2);
      v[rr][0] = a.x;
      v[rr][1] = a.y;
      v[rr][2] = z.x;
      v[rr][3] = z.y;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 f0 = *reinterpret_cast<const float4*>(filt + c * 12);
      const float4 f1 = *reinterpret_cast<const float4*>(filt + c * 12 + 4);
      const float k9[9] = {f0.x, f0.y, f0.z, f0.w, f1.x,
                           f1.y, f1.z, f1.w, filt[c * 12 + 8]};
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
              acc[r][j][c] =
                  fmaf(v[r + dy][j + dx], k9[dy * 3 + dx], acc[r][j][c]);
    }
  }

  // the warps' partial sums, kRedC outputs at a time, added in warp order
  constexpr int kPart = Tile::kRedC * TH * TW;
  __syncthreads();  // every stage is read: the buffer takes the partials
#pragma unroll
  for (int c0 = 0; c0 < C; c0 += Tile::kRedC) {
#pragma unroll
    for (int cc = 0; cc < Tile::kRedC; ++cc)
#pragma unroll
      for (int r = 0; r < R; ++r)
        *reinterpret_cast<float2*>(
            smem + warp * kPart + (cc * TH + grp * R + r) * TW + 2 * pair) =
            make_float2(acc[r][0][c0 + cc], acc[r][1][c0 + cc]);
    __syncthreads();
    for (int o = threadIdx.x; o < kPart; o += kOutThreads) {
      float s = smem[o];
#pragma unroll
      for (int wp = 1; wp < kOutWarps; ++wp) s += smem[wp * kPart + o];
      const int cc = o / (TH * TW), p = o % (TH * TW);
      const int y = y0 + p / TW, x = x0 + p % TW;
      if (y < H && x < W)
        epi((static_cast<int64_t>(b) * C + c0 + cc) * hw +
                static_cast<int64_t>(y) * W + x,
            b, c0 + cc, s);
    }
    if (c0 + Tile::kRedC < C) __syncthreads();
  }
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

template <int C, int TW, class Epi, class T>
cudaError_t conv_out_tw(const Geometry& g, const T* t, const T* w, Epi epi,
                        cudaStream_t st) {
  const dim3 grid(((g.W + TW - 1) / TW) *
                      ((g.H + OutTile<C, TW>::TH - 1) / OutTile<C, TW>::TH),
                  1, g.B);
  conv_out_kernel<C, TW><<<grid, kOutThreads, 0, st>>>(t, w, epi, g.I, g.H,
                                                       g.W);
  return cudaGetLastError();
}

// the band's width: the image's up to 32 columns, strips of 32 beyond
template <int C, class Epi, class T>
cudaError_t conv_out(const Geometry& g, const T* t, const T* w, Epi epi,
                     cudaStream_t st) {
  if (g.W > 16) return conv_out_tw<C, 32>(g, t, w, epi, st);
  if (g.W > 8) return conv_out_tw<C, 16>(g, t, w, epi, st);
  return conv_out_tw<C, 8>(g, t, w, epi, st);
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
