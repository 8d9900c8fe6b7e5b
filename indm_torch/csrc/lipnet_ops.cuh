// Device code of the iResBlock's Lipschitz net for Hopper (sm_90a), NCHW,
// float32 or bfloat16: the three layers of the 3-1-3 net, each with an
// epilogue functor, shared by the Neumann chain (neumann_chain.cu), the
// fused iResBlock pair and stacks (fused_block.cu, fused_stack.cu), the
// fully fused chain (fused_chain.cu) and the narrow-channel conv
// (narrow_conv.cu). They replace the in-VMEM layers of TPU kernels 3-8 and
// 10: `_apply_packed` "narrow_in", "mat" and "narrow_out"
// (indm_tpu/ops/neumann_pallas.py:60-111) and `_wgrad`
// (indm_tpu/ops/fused_block.py:165).
//
// With C = 3, 12 or 48 image channels (48: CelebA's second flow scale,
// kernel 7, in float32 and bfloat16) and I the width (512 at full width):
//   conv_in:  s[b, o, p] = sum_{c, tap} w[o, c, tap] v[b, c, p + tap]
//             (a 3x3 SAME conv C -> I, w [I, C, 3, 3]) as an implicit GEMM
//             on the tensor cores (K = 9 C padded to 32 or 112; at C = 48
//             six groups of 8 channels, K = 72 each): a block owns a
//             128-pixel tile of one sample and every output channel,
//             builds the tile's im2col rows in shared memory and walks the
//             channels in chunks of 64 (bfloat16 `mma.sync`, or 3xTF32 in
//             float32; the note at conv_in_kernel). Bound by the bytes of
//             its outputs.
//   gemm:     s[b] = A[b] @ B[b] (+ A'[b] @ B'[b]) on the tensor cores in
//             3xTF32 (`mma.sync`, float32 accumulation, the float32
//             contract kept), 128x128 tiles fed by a 4-stage ring of
//             `cp.async` copies in dynamic shared memory. A is [M, K]
//             row-major, B is [K, N] row-major or, with kBT, [N, K]
//             row-major (the weight gradient of a 1x1 conv, which
//             contracts over pixels). A per-batch stride of 0 shares an
//             operand (a weight) across the batch. It is bound by the
//             tensor cores' operations (the note at gemm_3xtf32_kernel).
//             It runs the float32 backwards' products (kernels 4 and 6).
//             Every float32 product with a weight fixed for the call (the
//             forwards of kernels 3 and 5, the chains of kernels 7 and 8
//             and kernel 8's layer 1) runs lipnet_wgmma.cuh's `wgmma` GEMM
//             on the weight split once a call, and every bfloat16 product
//             lipnet_wgmma_bf16.cuh's (`wgmma` with both operands through
//             TMA).
//   conv_out: s[b, c, p] = sum_{i, tap} w[c, i, tap] t[b, i, p + tap]
//             (a 3x3 SAME conv I -> C, w [C, I, 3, 3]). A block owns a band
//             of rows of one sample (its full width up to 32 columns,
//             strips of 32 beyond), up to 12 of the C outputs (C = 48 takes
//             four blocks a band) and all I input channels, split in 8
//             runs, one per warp. Each warp streams its run through a stage
//             of its own in shared memory with the next channel's loads in
//             flight; each lane keeps R rows of two columns for all C
//             outputs in registers; the warps' partial sums are added in
//             warp order before the epilogue (the note at conv_out_kernel).
// conv_in and conv_out load their operands as float or bfloat16 (T; conv_out
// its weight as Tw); the sums are float32 either way.
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

#include <type_traits>
#include <utility>

namespace lipnet {

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

// whether the functor takes four consecutive outputs as a float4
template <class Epi, class = void>
struct HasVec : std::false_type {};
template <class Epi>
struct HasVec<Epi, decltype(std::declval<const Epi&>()(int64_t(), 0, 0,
                                                        float4()),
                            void())> : std::true_type {};

// epi(idx, b, o, s) for a functor that takes a float4 (HasVec), else
// nothing (never called: the caller checks HasVec)
template <class Epi>
__device__ __forceinline__ void epi_vec(const Epi& epi, int64_t idx, int b,
                                        int o, float4 s) {
  if constexpr (HasVec<Epi>::value) epi(idx, b, o, s);
}

// epi.prefetch(idx) where the functor has one (it starts the loads that
// epi(idx, ...) will make), else nothing
template <class Epi>
__device__ __forceinline__ auto prefetch_if(const Epi& epi, int64_t idx, int)
    -> decltype(epi.prefetch(idx)) {
  epi.prefetch(idx);
}
template <class Epi>
__device__ __forceinline__ void prefetch_if(const Epi&, int64_t, long) {}
template <class Epi>
__device__ __forceinline__ void maybe_prefetch(const Epi& epi, int64_t idx) {
  prefetch_if(epi, idx, 0);
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
// takes TF32 operands from shared memory only K-major (bfloat16 ones
// either way: lipnet_wgmma_bf16.cuh reads the activations MN-major), and
// the activation operand of `mat_wide` is [K = I, N = H*W] with N
// contiguous (NCHW); TMA cannot transpose it, so `wgmma` needs the
// activations as the register operand (lipnet_wgmma.cuh: the forwards'
// and the chains' products, whose weight is fixed for the call), a
// transposing stage or a channels-last layout: later work for the
// backward's products, the only ones left here. `mma.sync` takes its
// fragments from plain 32-bit shared loads in either layout.
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

// 4 bytes from global to shared memory, or 4 zero bytes when !in
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0));
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

// conv_in: epi(idx, b, o, sum_{c, tap} w[o, c, tap] v[b, c, p + tap]) for a
// 3x3 SAME conv C -> I, w [I, C, 3, 3], as an implicit GEMM on the tensor
// cores: out[o, p] = sum_{k < 9C} W[o, k] col[k, p] with k = c * 9 + tap
// (the port's weight layout; a free sum order), K padded with zeros to KP
// (32 at C = 3, 112 at C = 12). The TPU computes the same layer as one
// im2col matmul with K = 9 C (`narrow_in`, indm_tpu/ops/neumann_pallas.py:
// 97-111, packing at :60-65).
//
// A block owns a tile of kConvPixels pixels (4x32, 8x16 or 16x8) of one
// sample and every output channel. It loads the C-channel halo tile once,
// builds the im2col tile col[p][k] from it in shared memory (zero columns
// past 9C), and walks the I channels in chunks of kOcChunk: each chunk's
// weights W[o][k] come to shared memory (the next chunk's loads in flight
// in registers while the tensor cores run), 8 warps of 32 channels x 32
// pixels take the product, and each warp hands its outputs through a
// staging tile of its own, so that its 32 lanes give the functor 32
// consecutive pixels of one channel and the stores and the diagonal's
// reads (prefetched a row group ahead where the functor has prefetch)
// stay coalesced.
//
// K in groups (C = 48). The whole im2col tile of 48 channels would take
// 2 x 128 x 436 floats (446 KB) in float32, twice an SM's shared memory,
// and one chunk's weights 223 KB. So K is walked in kGroups groups of CG
// = 8 channels (K = 72 each; in bfloat16 padded to the mma's 80): the
// halo tile of all 48 channels stays in shared memory for the block's
// life (39 KB, beside the staging), and for each chunk of output channels
// the block builds the im2col tile of one group (78 KB in TF32 planes,
// 22 KB in bfloat16) and takes that group's weights (39 KB, or 11 KB)
// through registers, each group's product added to the chunk's
// accumulators. The im2col tile is built kGroups times a chunk, 48 times
// a block, from shared memory; the pad columns of bfloat16's rows are
// zeroed once. The bfloat16 mode takes the same geometry as float32 (the
// chain route under flow.logdet_bf16 or flow.mixed_precision at CelebA's
// second scale): 108 KB of shared memory a block. With C = 3 or 12 there
// is one group: the tile is built once and the halo aliases the staging.
//
// Arithmetic. bfloat16: `mma.sync.m16n8k16` on bfloat16 operands from
// `ldmatrix`, exact products, float32 sums. float32: 3xTF32
// `mma.sync.m16n8k8`, the float32 contract of gemm_3xtf32_kernel: each
// weight is split once a block as its chunk lands, each im2col element
// once as the tile is built, into TF32 hi and lo planes in shared memory,
// and each product is a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms
// first. Either way each 32 of K sums into a fresh accumulator, added to
// the total in float32 (round to nearest): the tensor core's accumulate
// truncates. The sum order depends on (C, T) only, never on the tile, the
// batch or the caller.
//
// Bound at the chain's shapes (B = 128, I = 512): 2 B H W 9 C I = 3.62
// GFLOP at both scales, 0.004 ms of bfloat16 and 0.022 ms of three TF32
// passes on the tensor cores, against the outputs written once: 268 MB in
// float32 at scale 0 (0.080 ms at 3.35 TB/s), 67 MB at scale 1 (0.020 ms;
// half of each in bfloat16). So conv_in is bound by the bytes it writes
// (and, with a diagonal, reads), but for float32 alone at scale 1, where
// its three TF32 passes just outweigh them. The design keeps the
// operations off the critical path: the weight chunk's loads overlap the
// product, the im2col tile is built once per pixel tile, and the epilogue
// streams.
constexpr int kConvThreads = 256;  // 8 warps
constexpr int kConvPixels = 128;   // pixels of a block's tile
constexpr int kOcChunk = 64;       // output channels of a chunk
constexpr int kMaxHalo = 6 * 34;   // (th + 2) * (tw + 2), the widest tile
constexpr int kConvStgRow = kConvPixels + 8;  // a staging row (a channel)
constexpr int kConvStaging = kOcChunk * kConvStgRow * 4;  // bytes

// the im2col and weight tiles of conv_in for C channels stored as T: rows
// of S elements (KP and a pad, so that no fragment load conflicts), one
// plane in bfloat16, TF32 hi and lo planes in float32. kAsync (bfloat16
// rows of an even length in one group, C = 12): two weight tiles, filled
// by 4-byte `cp.async` copies a chunk ahead, which asks for a weight on a
// 4-byte boundary (conv_in refuses another); else one, filled from
// registers.
// The tiles hold one group of CG channels (all C but at C = 48, where
// kGroups = 6 groups of 8 take turns: the note at conv_in_kernel); KC is
// a group's K, KW the weight row's (9 C). KP rounds KC up to the mma's k
// (16 in bfloat16, 8 in float32: 32 and 112 at C = 3 and 12 either way).
template <int C, class T>
struct InTile {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int CG = C > 12 ? 8 : C;
  static constexpr int kGroups = C / CG;
  static constexpr int KW = 9 * C;
  static constexpr int KC = 9 * CG;
  static constexpr int KP = kBf16 ? (KC + 15) / 16 * 16 : (KC + 7) / 8 * 8;
  static constexpr int S = kBf16 ? KP + 8 : KP + 4;
  static constexpr int kPlanes = kBf16 ? 1 : 2;
  static constexpr int kElem = kBf16 ? 2 : 4;
  static constexpr int kColPlane = kConvPixels * S;  // elements
  static constexpr int kWPlane = kOcChunk * S;
  static constexpr int kColBytes = kPlanes * kColPlane * kElem;
  static constexpr int kWBytes = kPlanes * kWPlane * kElem;
  // the halo tile: aliases the staging with one group, else its own
  static constexpr int kHaloBytes = C * kMaxHalo * 4;
  static constexpr bool kAsync = kBf16 && KC % 2 == 0 && kGroups == 1;
  static constexpr int kWBufs = kAsync ? 2 : 1;
  static constexpr int kSmem =
      kColBytes + kWBufs * kWBytes +
      (kGroups > 1 ? kConvStaging + kHaloBytes
                   : (kConvStaging > kHaloBytes ? kConvStaging : kHaloBytes));
  static constexpr int kWWords = kOcChunk * KC / 2;  // a chunk, cp.async
  static constexpr int kWLoads =  // a thread's weight elements a chunk
      (kOcChunk * KC + kConvThreads - 1) / kConvThreads;
  static_assert(kGroups == 1 || (kOcChunk * 4 == kConvThreads && KC % 4 == 0),
                "with several groups a thread loads a quarter of a row");
  // blocks an SM: two where their shared memory fits and 128 registers a
  // thread hold the chunk loop without spills (C = 3: 7 weight loads in
  // flight a thread; at C = 12, 27 of them through registers in float32,
  // where one block's shared memory fills the SM anyway, and none in
  // bfloat16, where they go by cp.async; at C = 48, 18 a group through
  // registers in either type, one block of 186 KB an SM in float32 and of
  // 108 KB in bfloat16)
  static constexpr int kMinBlocks =
      2 * (kSmem + 1024) <= 232448 && (kAsync || kWLoads <= 8) ? 2 : 1;
  // ldmatrix rows of 16 bytes on distinct bank groups (bfloat16);
  // 4-byte fragment loads of rows g = 0..7 at column t = 0..3 on 32
  // distinct banks (float32)
  static_assert(kBf16 ? (S * 2) % 16 == 0 && (S * 2 / 16) % 2 == 1
                      : S % 32 % 8 == 4,
                "padded rows");
  static_assert(kSmem <= 232448, "fits an SM's shared memory");
  static_assert(C % CG == 0 && (kGroups == 1 || CG % 2 == 0),
                "groups of K: two halves of whole channels a pixel");
};
static_assert(kConvStgRow % 32 == 8, "conflict-free staging stores");

// four 8x8 bfloat16 matrices from shared memory, one row address a lane
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
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

// x into element e of a tile: as it is (bfloat16), or split into its TF32
// hi and lo planes `plane` elements apart (float32)
__device__ __forceinline__ void put_tile(__nv_bfloat16* t, int e, int,
                                         float x) {
  t[e] = __float2bfloat16_rn(x);  // exact: x is a bfloat16 value
}
__device__ __forceinline__ void put_tile(uint32_t* t, int e, int plane,
                                         float x) {
  split_tf32(x, t[e], t[plane + e]);
}

// the product of one chunk: acc[mt][j] = W[32 wo + 16 mt ..][:] @
// col[32 wp + 8 j ..][:]^T for this warp's 32 channels x 32 pixels
template <int C>
__device__ __forceinline__ void conv_in_mma(const __nv_bfloat16* col,
                                            const __nv_bfloat16* ws,
                                            float (&acc)[2][4][4], int wo,
                                            int wp, int lane) {
  using Tile = InTile<C, __nv_bfloat16>;
  constexpr int KP = Tile::KP, S = Tile::S;
#pragma unroll
  for (int kb = 0; kb < KP; kb += 32) {
    float part[2][4][4] = {};
#pragma unroll
    for (int k16 = kb; k16 < kb + 32 && k16 < KP; k16 += 16) {
      uint32_t bf[4][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int n = 32 * wp + 16 * jj + (lane & 7) + (lane >> 4) * 8;
        const int k = k16 + ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        ldsm_x4(r, smem_addr(col + n * S + k));
        bf[2 * jj][0] = r[0];
        bf[2 * jj][1] = r[1];
        bf[2 * jj + 1][0] = r[2];
        bf[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t af[4];
        ldsm_x4(af, smem_addr(ws + (32 * wo + 16 * mt + (lane & 15)) * S +
                              k16 + (lane >> 4) * 8));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(part[mt][j], af, bf[j][0], bf[j][1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
  }
}

template <int C>
__device__ __forceinline__ void conv_in_mma(const uint32_t* col,
                                            const uint32_t* ws,
                                            float (&acc)[2][4][4], int wo,
                                            int wp, int lane) {
  using Tile = InTile<C, float>;
  constexpr int KP = Tile::KP, S = Tile::S;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t* col_lo = col + Tile::kColPlane;
  const uint32_t* ws_lo = ws + Tile::kWPlane;
#pragma unroll
  for (int kb = 0; kb < KP; kb += 32) {
    float part[2][4][4] = {};
#pragma unroll
    for (int k8 = kb; k8 < kb + 32 && k8 < KP; k8 += 8) {
      // b0: k tig, b1: k tig + 4; pixel gid of each 8
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = (32 * wp + 8 * j + gid) * S + k8 + tig;
        bh[j][0] = col[e];
        bh[j][1] = col[e + 4];
        bl[j][0] = col_lo[e];
        bl[j][1] = col_lo[e + 4];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // a0, a2: channel gid, k tig and tig + 4; a1, a3: channel gid + 8
        const int e = (32 * wo + 16 * mt + gid) * S + k8 + tig;
        const uint32_t ah[4] = {ws[e], ws[e + 8 * S], ws[e + 4],
                                ws[e + 8 * S + 4]};
        const uint32_t al[4] = {ws_lo[e], ws_lo[e + 8 * S], ws_lo[e + 4],
                                ws_lo[e + 8 * S + 4]};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(part[mt][j], al, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(part[mt][j], ah, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_tf32(part[mt][j], ah, bh[j][0], bh[j][1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
  }
}

template <int C, class Epi, class T>
__global__ void __launch_bounds__(kConvThreads, (InTile<C, T>::kMinBlocks))
    conv_in_kernel(const T* __restrict__ v, const T* __restrict__ w,
                   Epi epi, int I, int H, int W, int tw, int th) {
  using Tile = InTile<C, T>;
  constexpr bool kAsync = Tile::kAsync;
  using E = typename std::conditional<Tile::kBf16, __nv_bfloat16,
                                      uint32_t>::type;
  constexpr int KC = Tile::KC, KP = Tile::KP, S = Tile::S, KW = Tile::KW;
  constexpr int kGroups = Tile::kGroups;
  extern __shared__ __align__(16) uint8_t csm[];
  E* col = reinterpret_cast<E*>(csm);
  E* ws = reinterpret_cast<E*>(csm + Tile::kColBytes);
  float* stg = reinterpret_cast<float*>(csm + Tile::kColBytes +
                                        Tile::kWBufs * Tile::kWBytes);
  // the halo tile: with one group until the staging takes its place, with
  // several (C = 48) beside it for the block's life
  float* halo = kGroups > 1 ? stg + kConvStaging / 4 : stg;

  const int b = blockIdx.y;
  const int tiles_x = (W + tw - 1) / tw;
  const int x0 = (blockIdx.x % tiles_x) * tw;
  const int y0 = (blockIdx.x / tiles_x) * th;
  const int hw2 = (th + 2) * (tw + 2);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* vb = v + static_cast<int64_t>(b) * C * H * W;

  for (int i = tid; i < C * hw2; i += kConvThreads) {
    const int c = i / hw2, r = i % hw2;
    const int yy = y0 - 1 + r / (tw + 2), xx = x0 - 1 + r % (tw + 2);
    halo[i] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                  ? to_f32(vb[(static_cast<int64_t>(c) * H + yy) * W + xx])
                  : 0.f;
  }
  // the weight rows' pad columns, never written again
  for (int i = tid; i < Tile::kWBufs * kOcChunk * (KP - KC);
       i += kConvThreads) {
    const int r = i / (KP - KC);  // a row of either tile
    put_tile(ws + r / kOcChunk * (Tile::kWBytes / sizeof(E)),
             r % kOcChunk * S + KC + i % (KP - KC), Tile::kWPlane, 0.f);
  }
  // with several groups (bfloat16 at C = 48) the im2col rows' pad columns
  // too: build_col writes a group's KC columns only
  if constexpr (kGroups > 1 && KP > KC) {
    for (int i = tid; i < kConvPixels * (KP - KC); i += kConvThreads)
      put_tile(col, i / (KP - KC) * S + KC + i % (KP - KC), Tile::kColPlane,
               0.f);
  }
  // kAsync: chunk o0 into weight tile `buf` as 4-byte words (zeros past I)
  auto issue_w = [&](int o0, int buf) {
    const int n = min(kOcChunk, I - o0) * KC / 2;
    const T* src = w + static_cast<int64_t>(o0) * KC;
    const uint32_t dst = smem_addr(ws + buf * (Tile::kWBytes / sizeof(E)));
    for (int q = tid; q < Tile::kWWords; q += kConvThreads) {
      const int r = q / (KC / 2), c2 = q % (KC / 2);
      cp_async4(dst + (r * S + 2 * c2) * 2, q < n ? src + 2 * q : src,
                q < n);
    }
    cp_async_commit();
  };

  // group g of a chunk's weights: its kOcChunk rows of KW hold it at KC
  // contiguous elements from g * KC. One group: the chunk's rows are
  // contiguous, and thread t takes elements t + 256 j. Several: thread t
  // takes a quarter of row t / 4 (fixed offsets from one address).
  float wr[Tile::kWLoads];
  const int wrow = tid / 4, wcol = tid % 4 * (KC / 4);
  auto load_w = [&](int o0, int g) {
    const int rows = min(kOcChunk, I - o0);
    const T* src = w + static_cast<int64_t>(o0) * KW + g * KC;
    if constexpr (kGroups > 1) {
      src += wrow * KW + wcol;
#pragma unroll
      for (int j = 0; j < Tile::kWLoads; ++j)
        wr[j] = wrow < rows ? to_f32(src[j]) : 0.f;
    } else {
#pragma unroll
      for (int j = 0; j < Tile::kWLoads; ++j) {
        const int e = tid + kConvThreads * j;
        wr[j] = e < rows * KC ? to_f32(src[e]) : 0.f;
      }
    }
  };
  auto store_w = [&]() {
#pragma unroll
    for (int j = 0; j < Tile::kWLoads; ++j) {
      if constexpr (kGroups > 1) {
        put_tile(ws, wrow * S + wcol + j, Tile::kWPlane, wr[j]);
      } else {
        const int e = tid + kConvThreads * j;
        if (e < kOcChunk * KC)
          put_tile(ws, e / KC * S + e % KC, Tile::kWPlane, wr[j]);
      }
    }
  };
  // im2col of group g: col[p][k] = halo[g CG + c][py + dy][px + dx],
  // k = c * 9 + dy * 3 + dx; a thread takes one pixel and half of its row
  // (with several groups, half of the group's channels, one at a time)
  auto build_col = [&](int g) {
    static_assert(kConvThreads == 2 * kConvPixels, "two threads a pixel");
    const int p = tid % kConvPixels, half = tid / kConvPixels;
    const float* hp =
        halo + g * Tile::CG * hw2 + p / tw * (tw + 2) + p % tw;
    if constexpr (kGroups > 1) {
      constexpr int kHalfC = Tile::CG / 2;
      const int row = tw + 2;
#pragma unroll 1
      for (int c = half * kHalfC; c < (half + 1) * kHalfC; ++c) {
        const float* hc = hp + c * hw2;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          put_tile(col, p * S + c * 9 + tap, Tile::kColPlane,
                   hc[tap / 3 * row + tap % 3]);
      }
    } else {
      constexpr int kHalf = KP / 2;
      const int k0 = half * kHalf;
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        const int k = k0 + j, c = k / 9, tap = k % 9;
        put_tile(col, p * S + k, Tile::kColPlane,
                 k < KC ? hp[c * hw2 + tap / 3 * (tw + 2) + tap % 3] : 0.f);
      }
    }
  };
  if constexpr (kAsync)
    issue_w(0, 0);
  else
    load_w(0, 0);
  __syncthreads();  // the halo tile is in
  build_col(0);
  if constexpr (!kAsync) store_w();
  __syncthreads();  // col (and the first chunk) are in; with one group the
                    // halo is read

  const int wo = warp / 4, wp = warp % 4;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t hw = static_cast<int64_t>(H) * W;
  // The epilogue: warp w hands over channels o0 + 8 w + r, r < 8, of each
  // chunk. A functor with a float4 overload (DMulT, StoreT, TangentT) gets
  // pixels 4 lane .. 4 lane + 3 of the tile in one call where the rows
  // hold them whole (W a multiple of 4), the others pixel 32 j + lane in
  // four calls.
  constexpr bool kVec = HasVec<Epi>::value;
  const bool vec = kVec && W % 4 == 0;
  int64_t pix[4];
  bool pin[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = vec ? 4 * lane : 32 * j + lane;
    const int x = x0 + p % tw, y = y0 + p / tw;
    pin[j] = x < W && y < H;
    pix[j] = static_cast<int64_t>(y) * W + x;
  }
  constexpr int kRows = kOcChunk / 8;
  for (int o0 = 0, c = 0; o0 < I; o0 += kOcChunk, ++c) {
    const bool next = o0 + kOcChunk < I;
    const E* cur = ws;
    if constexpr (kAsync) {
      // the other tile was read by the last chunk's product, which every
      // warp finished before the staging's barrier
      if (next) issue_w(o0 + kOcChunk, (c + 1) & 1);
      if (next)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // the chunk is in; the staging has been read
      cur = ws + (c & 1) * (Tile::kWBytes / sizeof(E));
    }
    float acc[2][4][4] = {};
    // the chunk's groups of K (one but at C = 48), each group's product
    // added to acc; the next group's (or chunk's) weights in flight
#pragma unroll 1
    for (int g = 0; g < kGroups; ++g) {
      const bool last = g + 1 == kGroups, more = !last || next;
      if constexpr (!kAsync) {
        if (more) load_w(last ? o0 + kOcChunk : o0, last ? 0 : g + 1);
      }
      conv_in_mma<C>(col, cur, acc, wo, wp, lane);
      if constexpr (!kAsync) {
        __syncthreads();  // every warp has read the tiles and the staging
        if (more) store_w();
        if (kGroups > 1 && more) build_col(last ? 0 : g + 1);
        if (!last) __syncthreads();  // the next group's tiles are in
      }
    }
    // acc[mt][j][e]: channel 32 wo + 16 mt + gid (+8 for e >= 2), pixel
    // 32 wp + 8 j + 2 tig + (e & 1); staged [channel][pixel]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          *reinterpret_cast<float2*>(
              stg + (32 * wo + 16 * mt + gid + (e >> 1) * 8) * kConvStgRow +
              32 * wp + 8 * j + 2 * tig) =
              make_float2(acc[mt][j][e], acc[mt][j][e + 1]);
    __syncthreads();  // the staging is whole; the next chunk is in
    const int oc = 8 * warp, on = max(0, min(kRows, I - o0 - oc));
    if (vec) {
      if (pin[0]) {
        for (int r = 0; r < on; ++r)
          maybe_prefetch(
              epi, (static_cast<int64_t>(b) * I + o0 + oc + r) * hw + pix[0]);
        for (int r = 0; r < on; ++r)
          epi_vec(epi,
                  (static_cast<int64_t>(b) * I + o0 + oc + r) * hw + pix[0],
                  b, o0 + oc + r,
                  *reinterpret_cast<const float4*>(
                      stg + (oc + r) * kConvStgRow + 4 * lane));
      }
    } else {
      for (int r = 0; r < on; ++r) {
        const int64_t base = (static_cast<int64_t>(b) * I + o0 + oc + r) * hw;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (pin[j])
            epi(base + pix[j], b, o0 + oc + r,
                stg[(oc + r) * kConvStgRow + 32 * j + lane]);
      }
    }
  }
}

// conv_out: epi(idx, b, c, sum_{i, tap} w[c, i, tap] t[b, i, p + tap]).
// A block owns a band of TH rows and TW columns of one sample, CB of the C
// outputs (all C up to 12; at C = 48, blockIdx.y picks one of four groups
// of 12) and all I input channels, split in kOutWarps contiguous runs,
// one per warp. Lane l
// of each warp owns the two columns 2 (l % (TW / 2)) + {0, 1} and the R
// rows (l / (TW / 2)) * R + [0, R) of the band, for its CB outputs: per
// channel it reads the 4 x (R + 2) inputs around its columns as float2
// pairs and each filter as float4 broadcasts, for 2 * R * 9 * CB FMAs. A
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
// operations). A lane does 18 * R * CB FMAs a channel for 2 * (R + 2) tile
// reads and 3 * CB filter reads (216 for 21 at C = 3, R = 4; 432 for 44 at
// C = 12, R = 2). Words of 4 bytes keep a bfloat16 load request as full as
// a float32 one. At C = 48 (CelebA's second flow scale, 16x16) all 48
// outputs a lane would take 192 accumulators, past the 128 registers of
// two blocks an SM, so the outputs are split across blocks in groups of
// 12, each group a C = 12 tile: each block reads the band's I channels
// again (4 x 67 MB at batch 128, from L2 in part), and the 14.5 GFLOP of
// FMAs (0.22 ms at 67 TFLOP/s) bound it. No tensor cores here:
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
  static constexpr int CB = C > 12 ? 12 : C;   // outputs a block
  static constexpr int kOutGroups = C / CB;    // blocks a band
  static constexpr int kLanes = TW / 2;      // lanes of a row group
  static constexpr int kGroups = 32 / kLanes;  // row groups of a warp
  static constexpr int R = (C == 3 && TW == 32) ? 4 : 2;  // rows a lane
  static constexpr int TH = kGroups * R;                   // rows of a band
  static constexpr int kRows = TH + 2;                     // with the halo
  static constexpr int RS = out_row_stride(TW, R);
  // one channel's halo tile and a spare cell, then the block's CB filters
  // (taps padded to 12), in float4-aligned runs: a warp's stage
  static constexpr int kSpare = kRows * RS;
  static constexpr int kTile = (kSpare + 1 + 3) / 4 * 4;
  static constexpr int kStage = kTile + CB * 12;
  static constexpr int kFiltLoads = (CB * 9 + 31) / 32;
  static constexpr int kRedC = 3;  // outputs reduced in one pass
  static constexpr int kRed = kOutWarps * kRedC * TH * TW;
  static constexpr int kSmem =
      kOutWarps * kStage > kRed ? kOutWarps * kStage : kRed;
  static_assert(CB % kRedC == 0 && C % CB == 0,
                "CB must be a multiple of kRedC and divide C");
};

template <int C, int TW, class Epi, class T, class Tw>
__global__ void __launch_bounds__(kOutThreads, 2)
    conv_out_kernel(const T* __restrict__ t, const Tw* __restrict__ w,
                    Epi epi, int I, int H, int W) {
  using Tile = OutTile<C, TW>;
  constexpr int R = Tile::R, TH = Tile::TH, RS = Tile::RS, CB = Tile::CB;
  constexpr int kRows = Tile::kRows, kFiltLoads = Tile::kFiltLoads;
  __shared__ __align__(16) float smem[Tile::kSmem];
  // this block's outputs: c0g .. c0g + CB - 1 (w [C, I, 3, 3] holds their
  // filters from c0g * I * 9); 0 .. C - 1 with one group, a constant
  const int c0g = Tile::kOutGroups > 1 ? blockIdx.y * CB : 0;
  if constexpr (Tile::kOutGroups > 1) w += static_cast<int64_t>(c0g) * I * 9;

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
  // channel's filters (c < CB, from the block's first output), or -1 past
  // them
  int fsrc[kFiltLoads];
#pragma unroll
  for (int k = 0; k < kFiltLoads; ++k) {
    const int e = lane + 32 * k;
    fsrc[k] = e < CB * 9 ? (e / 9) * I * 9 + e % 9 : -1;
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
      if (e < CB * 9) filt[(e / 9) * 12 + e % 9] = pf[k];
    }
  };

  float acc[R][2][CB];  // rows grp * R + r, columns 2 pair and 2 pair + 1
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[r][j][c] = 0.f;

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
    for (int c = 0; c < CB; ++c) {
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
  for (int c0 = 0; c0 < CB; c0 += Tile::kRedC) {
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
        epi((static_cast<int64_t>(b) * C + c0g + c0 + cc) * hw +
                static_cast<int64_t>(y) * W + x,
            b, c0g + c0 + cc, s);
    }
    if (c0 + Tile::kRedC < CB) __syncthreads();
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
    th = kConvPixels / tw;
    tiles = ((W + tw - 1) / tw) * ((H + th - 1) / th);
  }
  dim3 grid_in() const { return dim3(tiles, B); }
};

// The launches of conv_in_kernel (0) and conv_out_kernel (1) by this
// library, counted on the host as g_gemm_launches (below) counts the GEMMs'
// and read through the entry point indm_conv_launches.
static int64_t g_conv_launches[2] = {0, 0};

template <int C, class Epi, class T>
cudaError_t conv_in(const Geometry& g, const T* v, const T* w, Epi epi,
                    cudaStream_t st) {
  using Tile = InTile<C, T>;
  // the weight chunk's cp.async copies are 4-byte words
  if (Tile::kAsync && reinterpret_cast<uintptr_t>(w) % 4 != 0)
    return cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory: set at every launch, as for
  // gemm_3xtf32_kernel
  const cudaError_t attr = cudaFuncSetAttribute(
      conv_in_kernel<C, Epi, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile::kSmem);
  if (attr != cudaSuccess) return attr;
  conv_in_kernel<C, Epi, T><<<g.grid_in(), kConvThreads, Tile::kSmem, st>>>(
      v, w, epi, g.I, g.H, g.W, g.tw, g.th);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_conv_launches[0];
  return err;
}

template <int C, int TW, class Epi, class T, class Tw>
cudaError_t conv_out_tw(const Geometry& g, const T* t, const Tw* w, Epi epi,
                        cudaStream_t st) {
  const dim3 grid(((g.W + TW - 1) / TW) *
                      ((g.H + OutTile<C, TW>::TH - 1) / OutTile<C, TW>::TH),
                  OutTile<C, TW>::kOutGroups, g.B);
  conv_out_kernel<C, TW><<<grid, kOutThreads, 0, st>>>(t, w, epi, g.I, g.H,
                                                       g.W);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_conv_launches[1];
  return err;
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
// launches the kernel (gemm_3xtf32_kernel here, wgmma_3xtf32_kernel in
// lipnet_wgmma.cuh, wgmma_bf16_kernel in lipnet_wgmma_bf16.cuh): internal linkage, so every
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

// [I, I] weight @ the sample's [I, H*W] activations, for each sample, on
// gemm_3xtf32_kernel: the float32 backwards' products
template <class Epi>
cudaError_t mat_wide(const Geometry& g, const float* w, const float* t,
                     Epi epi, cudaStream_t st) {
  const GemmArgs a{{w, nullptr}, {t, nullptr}, 1, 0,
                   static_cast<int64_t>(g.I) * g.H * g.W, g.I, g.H * g.W,
                   g.I};
  return gemm<false>(a, g.B, epi, st);
}

// J^T v: t1 = D_out * conv(v, W2^T); t2 = D_mid * (W1^T t1); then
// out_epi(conv(t2, W0^T)) (the epilogue applies D_in where there is one).
// w_mid: W1^T split once a call into TF32 planes (lipnet_wgmma.cuh's
// SplitWeight: the `wgmma` GEMM) or bfloat16 (lipnet_wgmma_bf16.cuh), each
// through its overload of `product`; there is none for a float32 pointer,
// so gemm_3xtf32_kernel is reached only by the backwards' direct calls of
// mat_wide and gemm<true>. T, the storage type of v, the diagonals and the
// temporaries: float, or bfloat16 in the bfloat16 mode.
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
// wgmma_3xtf32_kernel (which = 1) or of wgmma_bf16_kernel (which = 2)
// since it was loaded.
extern "C" int64_t indm_gemm_launches(int which) {
  return lipnet::g_gemm_launches[which == 1 || which == 2 ? which : 0];
}

// This library's launches of conv_in_kernel (which = 0) or of
// conv_out_kernel (which = 1) since it was loaded.
extern "C" int64_t indm_conv_launches(int which) {
  return lipnet::g_conv_launches[which == 1 ? 1 : 0];
}
