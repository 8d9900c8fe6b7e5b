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
//   gemm:     s[b] = A[b] @ B[b] (+ A'[b] @ B'[b]) on the tensor cores in
//             3xTF32 (`mma.sync`, float32 accumulation, the float32
//             contract kept), 128x128 tiles fed by a 4-stage ring of
//             `cp.async` copies in dynamic shared memory. A is [M, K]
//             row-major, B is [K, N] row-major or, with kBT, [N, K]
//             row-major (the weight gradient of a 1x1 conv, which
//             contracts over pixels). A per-batch stride of 0 shares an
//             operand (a weight) across the batch. It is bound by the
//             tensor cores' operations (the note at gemm_3xtf32_kernel).
//   conv_out: s[b, c, p] = sum_{i, tap} w[c, i, tap] t[b, i, p + tap]
//             (a 3x3 SAME conv I -> C, w [C, I, 3, 3]). A block owns a band
//             of rows of one sample (its full width up to 32 columns,
//             strips of 32 beyond) and all I input channels, split in 8
//             runs, one per warp. Each warp streams its run through a stage
//             of its own in shared memory with the next channel's loads in
//             flight; each lane keeps R rows of two columns for all C
//             outputs in registers; the warps' partial sums are added in
//             warp order before the epilogue (the note at conv_out_kernel).
// conv_in and conv_out load their operands as float or bfloat16 (T; conv_out
// its weight as Tw) and widen them to float in shared memory; the sums are
// float32 either way, and a float operand compiles to the plain float
// loads.
//   gemm_bf16: the same product with bfloat16 operands, one `mma.sync`
//             pass with float32 accumulation (the bfloat16 mode of kernels
//             3-6, the note at gemm_bf16_kernel).
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

// x rounded to the storage type T, as float: the identity for float, round
// to nearest even for bfloat16 (the rounding of JAX's `.astype(bfloat16)`)
template <class T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a float stored as T (rounded to nearest even for bfloat16)
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// four consecutive elements (16-byte aligned floats, 8-byte aligned
// bfloat16) as a float4, and back
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
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
// of 4 (checked by the host), M any size; the ragged edges are masked.
//
// Arithmetic: 3xTF32 on the tensor cores. Each operand element x is split
// in registers, as its fragment comes from shared memory, into
// hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact in float32; tf32:
// nearest, ties away, as `cvt.rna` rounds), and each product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi, the two small terms first, through
// `mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32`. The dropped a_lo b_lo and
// the split's roundings leave each product within a few 2^-22 of its
// exact value, where one TF32 product keeps 2^-11: the float32 contract of
// kernels 3-8 (tests/test_torch_lipnet_gemm.py states it at the main
// path's depths). The tensor core's float32 accumulate rounds toward zero,
// and three of them a k-step drift: with one accumulator the H100 missed
// 1e-5 of the largest output at K = 2048. So each k-tile sums into a
// fresh `part` (12 accumulates), added to `acc` in float32 at the tile's
// end (round to nearest): 5.8e-7 at the main path's products, where
// cuBLAS's float32 SGEMM is at 2.2e-6 (chip_smoke.py phase 6d).
//
// Tile: a block of 8 warps owns a 128 x 128 output tile of one sample and
// walks K in k-tiles of 32 (both pairs one after the other: one sum, one
// order); each warp owns 64 x 32 outputs, 4 x 4 m16n8 fragments, 128
// float32 accumulators a thread with `part`. The tile, the warp split and
// the k order depend on (M, N, K, pairs) only, never on the batch, and
// there is no split-K and no atomic: every caller and every batch size
// gets the same bits. 128 x 128 keeps the loads per multiply-add at 1/64
// of a 32-bit word and gives 1024-4096 blocks at the main path's shapes
// (batch 128), 8-31 waves of 132 SMs.
//
// Memory: a ring of kGStages k-tiles in dynamic shared memory (160 KB,
// one block an SM), filled with 16-byte `cp.async.cg` copies (zero-filled
// past the edges) that run kGStages - 1 k-tiles ahead of the tensor cores;
// one barrier a k-tile. The shared rows are padded so that no fragment
// load conflicts: a K-contiguous tile row (A, and B with kBT) holds 40
// floats, an N-contiguous one (B without kBT) 132. Inside each group of 8
// k the mma's k index t < 4 takes the stored column 2t and t + 4 the column
// 2t + 1, the same for A and B (a product's k order is free): a fragment
// of a K-contiguous tile is then one 8-byte load. The accumulators leave
// through shared memory (a 136-float staging row), so each thread hands
// its epilogue rows of 4 consecutive columns and the stores stay coalesced.
//
// Bound at the main path's shapes (B = 128, I = 512): an [I, I] @ [I, H*W]
// product is 68.7 GFLOP at scale 0 (H*W = 1024) and 17.2 at scale 1 (256);
// three TF32 passes at 495 TFLOP/s (dense) take 0.416 and 0.104 ms, against
// 0.16 and 0.04 ms for the activation read and the output written once at
// 3.35 TB/s: bound by operations. What holds it at 54-59 TFLOP/s of
// float32 work (PERF.md): `mma.sync`'s own TF32 rate, and the split's five
// ALU instructions a fragment element (each A element is split by the 4
// warps that read it, each B element by 2) beside 192 `mma`s a k-tile a
// warp, with 8 warps an SM (226-236 registers, no spills). Smaller tiles
// at two blocks an SM (128 registers), 16 warps of 32 x 32, and splitting
// each element once as it lands (a split buffer, one barrier between
// split and product) were slower. Why `mma.sync` and not `wgmma`: `wgmma`
// takes TF32 operands from shared memory only K-major, and the activation
// operand of `mat_wide` is [K = I, N = H*W] with N contiguous (NCHW); TMA
// cannot transpose it, so `wgmma` needs a transposing stage or a
// channels-last layout through conv_in and conv_out, later work.
// `mma.sync` takes its fragments from plain 32-bit shared loads in either
// layout.
constexpr int kGM = 128, kGN = 128, kGK = 32;  // block tile, k-tile
constexpr int kGStages = 4;                     // the cp.async ring
constexpr int kGThreads = 256;                  // 8 warps
constexpr int kGWarpM = 64, kGWarpN = 32;       // a warp's outputs
constexpr int kGMinBlocks = 1;                  // blocks an SM
constexpr int kGWarpsM = kGM / kGWarpM;         // warps along m
constexpr int kGFragM = kGWarpM / 16, kGFragN = kGWarpN / 8;
constexpr int kKRow = kGK + 8;   // a K-contiguous tile row, in floats
constexpr int kNRow = kGN + 4;   // an N-contiguous tile row
constexpr int kCRow = kGN + 8;   // a row of the epilogue's staging tile
constexpr int kATile = kGM * kKRow;
constexpr int kBTile = kGN * kKRow > kGK * kNRow ? kGN * kKRow : kGK * kNRow;
constexpr int kGStage = kATile + kBTile;
constexpr size_t kGSmem =
    sizeof(float) * (kGStages * kGStage > kGM * kCRow ? kGStages * kGStage
                                                      : kGM * kCRow);
static_assert(kGWarpsM * (kGN / kGWarpN) * 32 == kGThreads,
              "the warps tile the block");
static_assert(kGM * kGK / 4 % kGThreads == 0 &&
                  kGN * kGK / 4 % kGThreads == 0,
              "every thread copies as many chunks");
// conflict-free fragment loads: 8-byte loads of rows g = 0..3 of a
// K-contiguous tile, 4-byte loads of rows 2 t (and 2 t + 1) of an
// N-contiguous one, 8-byte stores of rows g of the staging tile, each
// on its own 8 banks
static_assert(kKRow % 16 == 8 && kNRow % 8 == 4 && kCRow % 16 == 8,
              "padded rows");

struct GemmArgs {
  const float* a[2];
  const float* b[2];
  int pairs;
  int64_t a_bs, b_bs;  // per-batch strides in floats; 0 shares the operand
  int M, N, K;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: half of the dropped 13 bits added to the magnitude, then cleared.
// The rounding of `cvt.rna.tf32.f32` for finite x, in two integer
// operations: ptxas turns the `cvt` into a compare-and-select sequence,
// which made the GEMM slower.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32 values
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// c += a @ b for one m16n8k8 fragment
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kBT, class Epi>
__global__ void __launch_bounds__(kGThreads, kGMinBlocks)
    gemm_3xtf32_kernel(GemmArgs g, Epi epi) {
  extern __shared__ __align__(16) float gsm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int z = blockIdx.z;
  const int M = g.M, N = g.N, K = g.K;
  const int ktiles = (K + kGK - 1) / kGK, tiles = g.pairs * ktiles;

  // k-tile i (pair i / ktiles) into stage s, as 16-byte chunks: a
  // K-contiguous tile in rows of kGK / 4 chunks, an N-contiguous one in
  // rows of kGN / 4
  auto load = [&](int i, int s) {
    const int pr = i / ktiles, k0 = (i % ktiles) * kGK;
    // constant indices keep the arguments out of local memory
    const float* a = (pr ? g.a[1] : g.a[0]) + static_cast<int64_t>(z) * g.a_bs;
    const float* b = (pr ? g.b[1] : g.b[0]) + static_cast<int64_t>(z) * g.b_bs;
    float* as = gsm + s * kGStage;
    float* bs = as + kATile;
#pragma unroll
    for (int j = 0; j < kGM * kGK / 4 / kGThreads; ++j) {
      const int c = tid + kGThreads * j;
      const int r = c / (kGK / 4), kc = c % (kGK / 4) * 4;
      const bool in = m0 + r < M && k0 + kc < K;
      cp_async16(smem_addr(as + r * kKRow + kc),
                 in ? a + static_cast<int64_t>(m0 + r) * K + k0 + kc : a, in);
    }
#pragma unroll
    for (int j = 0; j < kGN * kGK / 4 / kGThreads; ++j) {
      const int c = tid + kGThreads * j;
      if (kBT) {
        const int r = c / (kGK / 4), kc = c % (kGK / 4) * 4;
        const bool in = n0 + r < N && k0 + kc < K;
        cp_async16(smem_addr(bs + r * kKRow + kc),
                   in ? b + static_cast<int64_t>(n0 + r) * K + k0 + kc : b,
                   in);
      } else {
        const int r = c / (kGN / 4), nc = c % (kGN / 4) * 4;
        const bool in = k0 + r < K && n0 + nc < N;
        cp_async16(smem_addr(bs + r * kNRow + nc),
                   in ? b + static_cast<int64_t>(k0 + r) * N + n0 + nc : b,
                   in);
      }
    }
  };

  const int wm = warp % kGWarpsM * kGWarpM, wn = warp / kGWarpsM * kGWarpN;
  const int gid = lane >> 2, tig = lane & 3;
  // acc: the sum of the finished k-tiles; part: this k-tile's, added to
  // acc in float32 (round to nearest) once the k-tile is done
  float acc[kGFragM][kGFragN][4] = {};

#pragma unroll
  for (int s = 0; s < kGStages - 1; ++s) {
    if (s < tiles) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<kGStages - 2>();  // k-tile i has landed
    __syncthreads();                // ... for every thread; stage i - 1 is read
    if (i + kGStages - 1 < tiles)
      load(i + kGStages - 1, (i + kGStages - 1) % kGStages);
    cp_async_commit();
    const float* as = gsm + (i % kGStages) * kGStage;
    const float* bs = as + kATile;
    float part[kGFragM][kGFragN][4] = {};
#pragma unroll
    for (int k8 = 0; k8 < kGK; k8 += 8) {
      // b0: k 2 tig of the group, b1: k 2 tig + 1; column gid
      uint32_t bh[kGFragN][2], bl[kGFragN][2];
#pragma unroll
      for (int j = 0; j < kGFragN; ++j) {
        const int n = wn + j * 8 + gid;
        float2 v;
        if (kBT) {
          v = *reinterpret_cast<const float2*>(bs + n * kKRow + k8 + 2 * tig);
        } else {
          v.x = bs[(k8 + 2 * tig) * kNRow + n];
          v.y = bs[(k8 + 2 * tig + 1) * kNRow + n];
        }
        split_tf32(v.x, bh[j][0], bl[j][0]);
        split_tf32(v.y, bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int mt = 0; mt < kGFragM; ++mt) {
        // a0, a2: row gid, k 2 tig and 2 tig + 1; a1, a3: row gid + 8
        const float* ar = as + (wm + mt * 16 + gid) * kKRow + k8 + 2 * tig;
        const float2 p = *reinterpret_cast<const float2*>(ar);
        const float2 q = *reinterpret_cast<const float2*>(ar + 8 * kKRow);
        uint32_t ah[4], al[4];
        split_tf32(p.x, ah[0], al[0]);
        split_tf32(q.x, ah[1], al[1]);
        split_tf32(p.y, ah[2], al[2]);
        split_tf32(q.y, ah[3], al[3]);
        // the three terms one after the other over the row's kGFragN
        // fragments: consecutive mmas write different accumulators
#pragma unroll
        for (int j = 0; j < kGFragN; ++j)
          mma_tf32(part[mt][j], al, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < kGFragN; ++j)
          mma_tf32(part[mt][j], ah, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < kGFragN; ++j)
          mma_tf32(part[mt][j], ah, bh[j][0], bh[j][1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kGFragM; ++mt)
#pragma unroll
      for (int j = 0; j < kGFragN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained and read: it takes the outputs

  // c0, c1: row gid, columns 2 tig and 2 tig + 1; c2, c3: row gid + 8
  float* cs = gsm;
#pragma unroll
  for (int mt = 0; mt < kGFragM; ++mt)
#pragma unroll
    for (int j = 0; j < kGFragN; ++j) {
      float* cr = cs + (wm + mt * 16 + gid) * kCRow + wn + j * 8 + 2 * tig;
      *reinterpret_cast<float2*>(cr) =
          make_float2(acc[mt][j][0], acc[mt][j][1]);
      *reinterpret_cast<float2*>(cr + 8 * kCRow) =
          make_float2(acc[mt][j][2], acc[mt][j][3]);
    }
  __syncthreads();
  for (int e = tid; e < kGM * kGN / 4; e += kGThreads) {
    const int r = e / (kGN / 4), c = e % (kGN / 4) * 4;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N)
      epi((static_cast<int64_t>(z) * M + m) * N + n, z, m,
          *reinterpret_cast<const float4*>(cs + r * kCRow + c));
  }
}

// gemm_bf16: epi(idx, b, m, 4 sums from column n) over the [M, N] outputs
// of sum_pairs A[b] @ B[b] with bfloat16 operands, the bfloat16 mode's
// product (kernels 3-6). Up to kMaxPairs pairs; K and N are multiples of 8
// (a 16-byte copy holds 8 bfloat16, checked by the host), M any size.
//
// Arithmetic: one `mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32` a product:
// the bfloat16 products are exact in float32 and accumulate in float32,
// the contract of the TPU kernels' bfloat16 dots (`preferred_element_type`
// float32). A float32 operand of such a dot (the backward's z2b) enters as
// two pairs, its bfloat16 hi and lo parts (the caller splits it): hi + lo
// keeps 16 of its 24 bits, where the rounding of the product's output to
// bfloat16 keeps 8. As in gemm_3xtf32_kernel, each k-tile sums into a
// fresh `part` that is added to `acc` in float32 (round to nearest) at the
// tile's end, so the tensor core's truncating accumulate runs over 32
// products at a time (chip_smoke.py holds the products against float64 at
// K = 512).
//
// Tile, warps, order and ring are gemm_3xtf32_kernel's (128 x 128 outputs
// a block, 8 warps of 64 x 32, k-tiles of 32 walked pair after pair, no
// split-K, no atomics: every caller and batch size gets the same bits),
// with bfloat16 stages: fragments come from shared memory by `ldmatrix`
// (`.trans` for an N-contiguous B, the activations of `mat_wide`), rows
// padded to 80 bytes (K-contiguous) and 272 bytes (N-contiguous) so that
// no 8-row phase of an `ldmatrix` hits a bank twice.
//
// Bound at the main path's shapes (B = 128, I = 512): an [I, I] @ [I, H*W]
// product is 68.7 GFLOP at scale 0 (H*W = 1024) and 17.2 at scale 1; one
// bfloat16 pass at 989 TFLOP/s (dense) takes 0.069 and 0.017 ms, the
// bfloat16 activation read and the output written once 0.08 and 0.02 ms
// at 3.35 TB/s (a bfloat16 output): bound by bytes at both scales, by a
// little. `mma.sync` reaches about two thirds of the dense rate that
// `wgmma` reaches; speed is later work.
constexpr int kBK = 32;                 // k-tile, in bfloat16 elements
constexpr int kBStages = 4;             // the cp.async ring
constexpr int kMaxPairs = 3;
constexpr int kBKRow = kBK + 8;         // a K-contiguous tile row (80 bytes)
constexpr int kBNRow = kGN + 8;         // an N-contiguous tile row (272)
constexpr int kBATile = kGM * kBKRow;
constexpr int kBBTile =
    kGN * kBKRow > kBK * kBNRow ? kGN * kBKRow : kBK * kBNRow;
constexpr int kBStage = kBATile + kBBTile;
constexpr size_t kBSmem =
    2 * kBStages * kBStage > sizeof(float) * kGM * kCRow
        ? 2 * kBStages * kBStage
        : sizeof(float) * kGM * kCRow;
static_assert(kGM * kBK / 8 % kGThreads == 0 &&
                  kGN * kBK / 8 % kGThreads == 0,
              "every thread copies as many chunks");
static_assert((kBKRow * 2) % 16 == 0 && (kBKRow * 2 / 4) % 32 == 20 &&
                  (kBNRow * 2) % 16 == 0 && (kBNRow * 2 / 4) % 32 == 4,
              "16-byte ldmatrix rows on distinct banks");

struct GemmBf16Args {
  const __nv_bfloat16* a[kMaxPairs];
  const __nv_bfloat16* b[kMaxPairs];
  int pairs;
  int64_t a_bs, b_bs;  // per-batch strides in elements; 0 shares the operand
  int M, N, K;
};

// four 8x8 bfloat16 matrices from shared memory, one row address a lane
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, "
               "%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a @ b for one m16n8k16 fragment
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kBT, class Epi>
__global__ void __launch_bounds__(kGThreads, 1)
    gemm_bf16_kernel(GemmBf16Args g, Epi epi) {
  extern __shared__ __align__(16) __nv_bfloat16 bsm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int z = blockIdx.z;
  const int M = g.M, N = g.N, K = g.K;
  const int ktiles = (K + kBK - 1) / kBK, tiles = g.pairs * ktiles;

  // k-tile i (pair i / ktiles) into stage s, as 16-byte chunks of 8
  auto load = [&](int i, int s) {
    const int pr = i / ktiles, k0 = (i % ktiles) * kBK;
    const __nv_bfloat16* a =
        (pr == 0 ? g.a[0] : (pr == 1 ? g.a[1] : g.a[2])) +
        static_cast<int64_t>(z) * g.a_bs;
    const __nv_bfloat16* b =
        (pr == 0 ? g.b[0] : (pr == 1 ? g.b[1] : g.b[2])) +
        static_cast<int64_t>(z) * g.b_bs;
    __nv_bfloat16* as = bsm + s * kBStage;
    __nv_bfloat16* bs = as + kBATile;
#pragma unroll
    for (int j = 0; j < kGM * kBK / 8 / kGThreads; ++j) {
      const int c = tid + kGThreads * j;
      const int r = c / (kBK / 8), kc = c % (kBK / 8) * 8;
      const bool in = m0 + r < M && k0 + kc < K;
      cp_async16(smem_addr(as + r * kBKRow + kc),
                 in ? a + static_cast<int64_t>(m0 + r) * K + k0 + kc : a, in);
    }
#pragma unroll
    for (int j = 0; j < kGN * kBK / 8 / kGThreads; ++j) {
      const int c = tid + kGThreads * j;
      if (kBT) {
        const int r = c / (kBK / 8), kc = c % (kBK / 8) * 8;
        const bool in = n0 + r < N && k0 + kc < K;
        cp_async16(smem_addr(bs + r * kBKRow + kc),
                   in ? b + static_cast<int64_t>(n0 + r) * K + k0 + kc : b,
                   in);
      } else {
        const int r = c / (kGN / 8), nc = c % (kGN / 8) * 8;
        const bool in = k0 + r < K && n0 + nc < N;
        cp_async16(smem_addr(bs + r * kBNRow + nc),
                   in ? b + static_cast<int64_t>(k0 + r) * N + n0 + nc : b,
                   in);
      }
    }
  };

  const int wm = warp % kGWarpsM * kGWarpM, wn = warp / kGWarpsM * kGWarpN;
  float acc[kGFragM][kGFragN][4] = {};

#pragma unroll
  for (int s = 0; s < kBStages - 1; ++s) {
    if (s < tiles) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<kBStages - 2>();  // k-tile i has landed
    __syncthreads();                // ... for every thread; stage i - 1 is read
    if (i + kBStages - 1 < tiles)
      load(i + kBStages - 1, (i + kBStages - 1) % kBStages);
    cp_async_commit();
    const __nv_bfloat16* as = bsm + (i % kBStages) * kBStage;
    const __nv_bfloat16* bs = as + kBATile;
    float part[kGFragM][kGFragN][4] = {};
#pragma unroll
    for (int k16 = 0; k16 < kBK; k16 += 16) {
      // b[j][0]: k 2 tig, 2 tig + 1 of the 16; b[j][1]: 8 more; column gid
      uint32_t bf[kGFragN][2];
#pragma unroll
      for (int jj = 0; jj < kGFragN / 2; ++jj) {
        const int nb = wn + jj * 16;
        uint32_t r[4];
        if (kBT) {
          const int n = nb + (lane & 7) + (lane >> 4) * 8;
          const int k = k16 + ((lane >> 3) & 1) * 8;
          ldsm_x4(r, smem_addr(bs + n * kBKRow + k));
        } else {
          const int k = k16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int n = nb + (lane >> 4) * 8;
          ldsm_x4_t(r, smem_addr(bs + k * kBNRow + n));
        }
        bf[2 * jj][0] = r[0];
        bf[2 * jj][1] = r[1];
        bf[2 * jj + 1][0] = r[2];
        bf[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < kGFragM; ++mt) {
        // a0: rows 0-7, k 0-7; a1: rows 8-15; a2, a3: k 8-15
        uint32_t af[4];
        ldsm_x4(af, smem_addr(as + (wm + mt * 16 + (lane & 15)) * kBKRow +
                              k16 + (lane >> 4) * 8));
#pragma unroll
        for (int j = 0; j < kGFragN; ++j)
          mma_bf16(part[mt][j], af, bf[j][0], bf[j][1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kGFragM; ++mt)
#pragma unroll
      for (int j = 0; j < kGFragN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained and read: it takes the outputs

  // c0, c1: row gid, columns 2 tig and 2 tig + 1; c2, c3: row gid + 8
  const int gid = lane >> 2, tig = lane & 3;
  float* cs = reinterpret_cast<float*>(bsm);
#pragma unroll
  for (int mt = 0; mt < kGFragM; ++mt)
#pragma unroll
    for (int j = 0; j < kGFragN; ++j) {
      float* cr = cs + (wm + mt * 16 + gid) * kCRow + wn + j * 8 + 2 * tig;
      *reinterpret_cast<float2*>(cr) =
          make_float2(acc[mt][j][0], acc[mt][j][1]);
      *reinterpret_cast<float2*>(cr + 8 * kCRow) =
          make_float2(acc[mt][j][2], acc[mt][j][3]);
    }
  __syncthreads();
  for (int e = tid; e < kGM * kGN / 4; e += kGThreads) {
    const int r = e / (kGN / 4), c = e % (kGN / 4) * 4;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N)
      epi((static_cast<int64_t>(z) * M + m) * N + n, z, m,
          *reinterpret_cast<const float4*>(cs + r * kCRow + c));
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
// a float32 one. No tensor cores here:
// in float32 that would mean three TF32 `mma`s a product (as gemm does),
// and C = 3 or 12 outputs would fill a 16-row fragment a fifth or three
// quarters; the bfloat16 mode of kernels 3-6 loads bfloat16 and sums in
// float32 here too (a bf16 `mma` path is later speed work).
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

template <int C, int TW, class Epi, class T, class Tw>
__global__ void __launch_bounds__(kOutThreads, 2)
    conv_out_kernel(const T* __restrict__ t, const Tw* __restrict__ w,
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

// An epilogue that the `wgmma` GEMM (lipnet_wgmma.cuh) runs also has
// prefetch(idx): called a k-tile before operator()(idx, ...), it starts the
// loads that the call will make.

// The epilogues take a storage type T: each value is rounded to T where
// the bfloat16 mode of kernels 3-8 rounds it (rnd, the identity for
// float), so the float instantiations compute what they always did.

template <class T>
struct StoreT {  // out = s
  T* out;
  __device__ void operator()(int64_t idx, int, int, float s) const {
    put(out + idx, s);
  }
  __device__ void operator()(int64_t idx, int, int, float4 s) const {
    store4(out + idx, s);
  }
  __device__ void prefetch(int64_t) const {}
};
using Store = StoreT<float>;

template <class T>
struct DMulT {  // out = [s] * d (a diagonal of the chain), [s] = rnd(s)
  const T* d;
  T* out;
  __device__ void prefetch(int64_t idx) const {
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(d + idx));
  }
  __device__ void operator()(int64_t idx, int, int, float s) const {
    put(out + idx, rnd<T>(s) * to_f32(d[idx]));
  }
  __device__ void operator()(int64_t idx, int, int, float4 s) const {
    const float4 dv = load4(d + idx);
    store4(out + idx, make_float4(rnd<T>(s.x) * dv.x, rnd<T>(s.y) * dv.y,
                                  rnd<T>(s.z) * dv.z, rnd<T>(s.w) * dv.w));
  }
};
using DMul = DMulT<float>;

template <class T>
struct ChainOutT {  // val = [[s] *d]; v = val; acc += coeff * val (float)
  const T* d;
  T* v;
  float* acc;
  float coeff;
  __device__ void operator()(int64_t idx, int, int, float s) const {
    const float val = d ? rnd<T>(rnd<T>(s) * to_f32(d[idx])) : rnd<T>(s);
    put(v + idx, val);
    acc[idx] += coeff * val;
  }
};
using ChainOut = ChainOutT<float>;

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
};

template <int C, class Epi, class T>
cudaError_t conv_in(const Geometry& g, const T* v, const T* w, Epi epi,
                    cudaStream_t st) {
  conv_in_kernel<C><<<g.grid_in(), kConvThreads, 0, st>>>(v, w, epi, g.I, g.H,
                                                          g.W, g.tw, g.th);
  return cudaGetLastError();
}

template <int C, int TW, class Epi, class T, class Tw>
cudaError_t conv_out_tw(const Geometry& g, const T* t, const Tw* w, Epi epi,
                        cudaStream_t st) {
  const dim3 grid(((g.W + TW - 1) / TW) *
                      ((g.H + OutTile<C, TW>::TH - 1) / OutTile<C, TW>::TH),
                  1, g.B);
  conv_out_kernel<C, TW><<<grid, kOutThreads, 0, st>>>(t, w, epi, g.I, g.H,
                                                       g.W);
  return cudaGetLastError();
}

// the band's width: the image's up to 32 columns, strips of 32 beyond
template <int C, class Epi, class T, class Tw>
cudaError_t conv_out(const Geometry& g, const T* t, const Tw* w, Epi epi,
                     cudaStream_t st) {
  if (g.W > 16) return conv_out_tw<C, 32>(g, t, w, epi, st);
  if (g.W > 8) return conv_out_tw<C, 16>(g, t, w, epi, st);
  return conv_out_tw<C, 8>(g, t, w, epi, st);
}

// The launches of each GEMM by this library, counted on the host where it
// launches the kernel (gemm_3xtf32_kernel and gemm_bf16_kernel here,
// wgmma_3xtf32_kernel in lipnet_wgmma.cuh): internal linkage, so every
// library that includes this header keeps its own, read through its entry
// point indm_gemm_launches. Sums a run's launches without a profiler.
static int64_t g_gemm_launches[3] = {0, 0, 0};

// the [M, N] outputs of `a` for each of `batch` samples; the pointers
// and per-batch strides keep 16-byte alignment (K, N multiples of 4)
template <bool kBT, class Epi>
cudaError_t gemm(const GemmArgs& a, int batch, Epi epi, cudaStream_t st) {
  // above 48 KB of dynamic shared memory. Set at every launch: a static
  // flag in this inline function would be one symbol for every library of
  // the process (GNU unique), and a second library would skip its own.
  const cudaError_t attr = cudaFuncSetAttribute(
      gemm_3xtf32_kernel<kBT, Epi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kGSmem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.N + kGN - 1) / kGN, (a.M + kGM - 1) / kGM, batch);
  gemm_3xtf32_kernel<kBT><<<grid, kGThreads, kGSmem, st>>>(a, epi);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_gemm_launches[0];
  return err;
}

// the bfloat16 GEMM's [M, N] outputs of `a` for each of `batch` samples;
// the pointers and per-batch strides keep 16-byte alignment (K, N
// multiples of 8).
template <bool kBT, class Epi>
cudaError_t gemm_bf16(const GemmBf16Args& a, int batch, Epi epi,
                      cudaStream_t st) {
  const cudaError_t attr = cudaFuncSetAttribute(
      gemm_bf16_kernel<kBT, Epi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kBSmem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.N + kGN - 1) / kGN, (a.M + kGM - 1) / kGM, batch);
  gemm_bf16_kernel<kBT><<<grid, kGThreads, kBSmem, st>>>(a, epi);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_gemm_launches[2];
  return err;
}

// sum over the pairs (w[p], t[p]) of the [I, I] bfloat16 weight @ the
// sample's [I, H*W] bfloat16 activations, for each sample: the product of
// the bfloat16 mode, with a float32 operand as its hi and lo pairs
template <class Epi>
cudaError_t mat_wide(const Geometry& g, const __nv_bfloat16* w,
                     const __nv_bfloat16* t, Epi epi, cudaStream_t st,
                     const __nv_bfloat16* t_lo = nullptr) {
  const GemmBf16Args a{{w, w, nullptr}, {t, t_lo, nullptr}, t_lo ? 2 : 1, 0,
                       static_cast<int64_t>(g.I) * g.H * g.W, g.I, g.H * g.W,
                       g.I};
  return gemm_bf16<false>(a, g.B, epi, st);
}

template <class Epi>
cudaError_t product(const Geometry& g, const __nv_bfloat16* w,
                    const __nv_bfloat16* t, Epi epi, cudaStream_t st) {
  return mat_wide(g, w, t, epi, st);
}

// [I, I] weight @ the sample's [I, H*W] activations, for each sample
template <class Epi>
cudaError_t mat_wide(const Geometry& g, const float* w, const float* t,
                     Epi epi, cudaStream_t st) {
  const GemmArgs a{{w, nullptr}, {t, nullptr}, 1, 0,
                   static_cast<int64_t>(g.I) * g.H * g.W, g.I, g.H * g.W,
                   g.I};
  return gemm<false>(a, g.B, epi, st);
}

// the net's product with a float32 weight: gemm_3xtf32_kernel. The
// forward's split weights (lipnet_wgmma.cuh's SplitWeight) take the
// `wgmma` GEMM through their own overload.
template <class Epi>
cudaError_t product(const Geometry& g, const float* w, const float* t,
                    Epi epi, cudaStream_t st) {
  return mat_wide(g, w, t, epi, st);
}

// J^T v: t1 = D_out * conv(v, W2^T); t2 = D_mid * (W1^T t1); then
// out_epi(conv(t2, W0^T)) (the epilogue applies D_in where there is one).
// w_mid: W1^T as float32, split (`product`) or bfloat16; T, the storage
// type of v, the diagonals and the temporaries: float, or bfloat16 in the
// bfloat16 mode.
template <int C, class T, class Mid, class OutEpi>
cudaError_t launch_jt(const Geometry& g, const T* v, const T* w_in,
                      const T* d_out, const Mid& w_mid, const T* d_mid,
                      const T* w_out, OutEpi out_epi, T* t1, T* t2,
                      cudaStream_t st) {
  cudaError_t err;
  if ((err = conv_in<C>(g, v, w_in, DMulT<T>{d_out, t1}, st)) != cudaSuccess)
    return err;
  if ((err = product(g, w_mid, t1, DMulT<T>{d_mid, t2}, st)) != cudaSuccess)
    return err;
  return conv_out<C>(g, t2, w_out, out_epi, st);
}

// acc = sum_k coeffs[k] (J^T)^(k+1) vareps; v, t1, t2 are scratch. acc is
// float32 in either mode.
template <int C, class T, class Mid>
cudaError_t run_chain(const Geometry& g, const T* vareps, const T* d_out,
                      const T* d_mid, const T* d_in, const T* w_in,
                      const Mid& w_mid, const T* w_out, const float* coeffs,
                      int n_terms, float* acc, T* v, T* t1, T* t2,
                      cudaStream_t st) {
  const size_t vbytes =
      static_cast<size_t>(g.B) * C * g.H * g.W * sizeof(float);
  cudaError_t err = cudaMemsetAsync(acc, 0, vbytes, st);
  if (err != cudaSuccess) return err;
  for (int k = 0; k < n_terms; ++k) {
    err = launch_jt<C>(g, k == 0 ? vareps : v, w_in, d_out, w_mid, d_mid,
                       w_out, ChainOutT<T>{d_in, v, acc, coeffs[k]}, t1, t2,
                       st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace lipnet

// This library's launches of gemm_3xtf32_kernel (which = 0), of
// wgmma_3xtf32_kernel (which = 1) or of gemm_bf16_kernel (which = 2)
// since it was loaded.
extern "C" int64_t indm_gemm_launches(int which) {
  return lipnet::g_gemm_launches[which == 1 || which == 2 ? which : 0];
}
