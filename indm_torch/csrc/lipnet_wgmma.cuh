// The Lipschitz net's 512-wide product on Hopper's warpgroup tensor cores
// (`wgmma`, sm_90a), float32 by contract (3xTF32): every float32 product
// whose weight is fixed for the call. That is the training forward
// (kernel 3's and kernel 5's `fused_ops::fwd<C>`: layer 1, each chain
// term's W1^T and J^T u's W1^T), the Neumann chain's W1^T in every term
// (kernel 7, neumann_chain.cu) and kernel 8's layer 1 and chain
// (fused_chain.cu).
//
//   out[b][m][p] = sum_k W[m][k] act[b][k][p]
//
// for NCHW activations act [B, K, N] (N = H*W pixels, contiguous) and a
// weight W [M, K] shared by every sample (M = K = I in the net), each
// output handed to an epilogue functor as a float4 of four consecutive
// pixels (lipnet_ops.cuh's Store and DMul, fused_block_ops.cuh's Layer1,
// fused_chain.cu's D2T).
//
// Replaces, with `lipnet::gemm_3xtf32_kernel` for the float32 backwards,
// the in-VMEM `_apply_packed(kind="mat")` (indm_tpu/ops/neumann_pallas.py:
// 74-76) inside TPU kernels 3, 5, 7 and 8. The bfloat16 products run its
// sibling in lipnet_wgmma_bf16.cuh, which reuses this file's barrier, TMA
// and descriptor helpers; there both operands come through TMA.
//
// Why the activations are the register operand. `wgmma` reads B from shared
// memory, and A from shared memory or registers; a TF32 operand in shared
// memory must be K-major. The weight's rows [m][k] are K-major already; the
// activations [k][p] are pixel-contiguous, which TMA cannot transpose. So
// the kernel computes the transposed product
//   D[p, m] = sum_k A[p, k] B[k, m],  A = act[b]^T (pixels as rows), B = W^T
// with A loaded by each thread from a pixel-contiguous shared tile into the
// registers of its fragment (whose layout is free) and B read by `wgmma`
// from the weight's K-major tile. No NCHW tensor changes layout.
//
// Arithmetic: 3xTF32, the float32 contract of kernels 3-8 (the note at
// lipnet::gemm_3xtf32_kernel). Each element x is split into
// hi = tf32(x) and lo = tf32(x - hi) (nearest, ties away: lipnet::rna_tf32),
// and each k-step of 8 is three products, the small ones first:
// a_lo b_hi, a_hi b_lo, a_hi b_hi. The weight is fixed for the call, so it
// is split once per call into TF32 hi and lo planes (split_planes_kernel);
// the activations are split in registers, once per consumer warpgroup. The
// tensor core's float32 accumulate rounds toward zero, so each k-tile of 32
// sums into a fresh accumulator (`scale-d` = 0 on its first `wgmma`), which
// is added to the total in float32 (round to nearest), as gemm_3xtf32_kernel
// does. Each output's sum order depends on K only: k-tiles in order, twelve
// `wgmma`s a k-tile in a fixed order, no split-K, no atomic. Every caller,
// every batch size and every tile schedule give the same bits.
//
// Bank conflicts: a thread's A fragment is (pixel g, k index t) and (g,
// t + 4) for g = lane / 4 (+ 8), t = lane % 4. Within each group of 8 k the
// planes store the weight permuted, column t holding the weight's k = 2t and
// column t + 4 its k = 2t + 1, and the thread reads the activation rows 2t
// and 2t + 1 to match (a product's k order is free): with TMA's 128-byte
// swizzle, the 32 lanes of one fragment load then hit 32 banks.
//
// Schedule: persistent blocks of three warpgroups, one block an SM. Warp 0
// of the producer warpgroup issues the TMA copies (A: four 32-pixel boxes of
// a k-tile, B: the hi and lo planes' 128 x 32 tiles) into a ring of kWStages
// stages in dynamic shared memory, each guarded by a full and an empty
// `mbarrier`; it gives up its registers (`setmaxnreg`) to the two consumer
// warpgroups. A block tile is 128 pixels x 128 output channels of one
// sample; each consumer owns 64 pixels x 128 channels (m64n128k8, 64
// float32 accumulators a thread, 64 more for the k-tile's part, 32 for the
// split A fragments), both read the same B tiles. Tiles are walked with the
// channel tile fastest (the four readers of an activation tile run
// together, in L2) and assigned to blocks round robin. A tile's outputs
// go through a padded staging tile in shared memory, so that each thread
// hands the functor float4 rows of pixels and the stores and the
// diagonal's reads stay coalesced. The consumers hand them over a few rows
// a k-tile while the next tile's `wgmma`s run, each row's loads started a
// k-tile ahead (the functor's prefetch), so the epilogue's memory traffic
// overlaps the tensor cores; the producer keeps the ring filled
// meanwhile.
//
// Shapes: any M, N and K that are multiples of 4 (N of them: 16-byte TMA
// rows), K padded to 8 in the planes; ragged tiles are zero-filled by TMA
// past the tensor's edges and masked in the epilogue, so the chains' N =
// H*W of 1024 and 256, and widths that are not multiples of 128 (the card
// tests'), need nothing of their own.
//
// Bound at the forward's and the chains' products (B = 128, I = 512):
// 2 B H W I^2 = 68.7 GFLOP at scale 0 (H*W = 1024) and 17.2 at scale 1
// (256); three TF32 passes at 495 TFLOP/s (dense) take 0.416 and 0.104
// ms, against 0.16 and 0.04 ms for the activations read and the output
// written once at 3.35 TB/s: bound by operations.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

#include "lipnet_ops.cuh"

namespace lipnet {

constexpr int kWM = 128;      // pixels of a block tile
constexpr int kWN = 128;      // output channels of a block tile
constexpr int kWK = 32;       // a k-tile: 128 bytes of float32
constexpr int kWStages = 3;   // the TMA ring
constexpr int kWThreads = 384;  // producer warpgroup + 2 consumers
constexpr int kWBox = 32 * 32;  // an A box: 32 k rows x 32 pixels
constexpr int kWABytes = 4 * kWBox * 4;    // 4 boxes: 128 pixels
constexpr int kWBBytes = kWN * kWK * 4;    // one plane's tile
constexpr int kWStageBytes = kWABytes + 2 * kWBBytes;  // 48 KB
constexpr int kWStageRow = 64 + 4;  // staging row (channel) in floats
constexpr int kWStaging = kWN * kWStageRow * 4;  // a consumer's, bytes
constexpr int kWEpiRows = kWN * 64 / 4 / 128;    // float4s a thread a tile
constexpr size_t kWSmem = 1024 + kWStages * kWStageBytes + 2 * kWStaging +
                          2 * kWStages * 8;
static_assert(kWSmem <= 232448, "fits an SM's shared memory");
static_assert(kWStageRow * 2 % 32 == 8, "conflict-free staging stores");

// The weight planes of one [M, K] weight: TF32 hi then lo, each [M, Kp]
// with Kp = K rounded up to 8 and the k order permuted in groups of 8.
struct SplitWeight {
  const float* planes;
  int M, K;
};

__host__ __device__ constexpr int padded_k(int K) { return (K + 7) / 8 * 8; }

// Floats of one weight's planes
inline int64_t split_floats(int M, int K) {
  return 2 * static_cast<int64_t>(M) * padded_k(K);
}

// planes_i = (hi, lo) of w_i = w + i * w_stride, at planes + i * p_stride:
// hi[m][8g + t] = tf32(w[m][8g + s(t)]), s(t) = 2t (t < 4) or 2t - 7;
// zero where 8g + s(t) >= K.
__global__ void split_planes_kernel(const float* __restrict__ w,
                                    int64_t w_stride, float* planes,
                                    int64_t p_stride, int count, int M,
                                    int K) {
  const int kp = padded_k(K);
  const int64_t per = static_cast<int64_t>(M) * kp, n = count * per;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = e / per, r = e % per;
    const int m = static_cast<int>(r / kp), j = static_cast<int>(r % kp);
    const int t = j & 7, k = (j & ~7) + (t < 4 ? 2 * t : 2 * t - 7);
    const float x = k < K ? w[i * w_stride + static_cast<int64_t>(m) * K + k]
                          : 0.f;
    uint32_t hi, lo;
    split_tf32(x, hi, lo);
    float* out = planes + i * p_stride;
    out[r] = __uint_as_float(hi);
    out[per + r] = __uint_as_float(lo);
  }
}

inline cudaError_t split_weights(const float* w, int64_t w_stride,
                                 float* planes, int64_t p_stride, int count,
                                 int M, int K, cudaStream_t st) {
  const int64_t n = count * static_cast<int64_t>(M) * padded_k(K);
  const int64_t blocks = (n + 255) / 256;
  split_planes_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256,
                        0, st>>>(w, w_stride, planes, p_stride, count, M, K);
  return cudaGetLastError();
}

// ---- device helpers: mbarriers, TMA, wgmma ----

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// a 3-D TMA box at (c0, c1, c2) into shared memory, reported to `bar`
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// the descriptor of a K-major tile with 128-byte swizzle (rows of 128 bytes,
// 8-row groups 1024 bytes apart) starting at shared address `addr`
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |           // LBO (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) |   // SBO
         (static_cast<uint64_t>(1) << 62);            // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of d across the asynchronous
// `wgmma`s (they read and write the registers after the instruction issues)
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keeps the A fragments' registers live, so unreused, until the `wgmma`s
// that read them have completed
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[s][r])::"memory");
}

// d (+)= a @ b for a 64 x 128 x 8 TF32 step: a from registers, b from the
// shared tile of `desc`; kScaleD = 0 overwrites d
template <int kScaleD>
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(kScaleD));
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

struct WTiles {
  int M, N, K;
  int tiles_m, tiles_p, tiles;  // channel tiles, pixel tiles, all
};

// epi(idx, b, m, 4 sums from pixel p) over out [B, M, N], idx = (b M + m) N
// + p: the note at the top of this file.
template <class Epi>
__global__ void __launch_bounds__(kWThreads, 1)
    wgmma_3xtf32_kernel(const __grid_constant__ CUtensorMap act_map,
                        const __grid_constant__ CUtensorMap w_map, Epi epi,
                        WTiles g) {
  extern __shared__ uint8_t wsm_raw[];
  const uint32_t raw = smem_addr(wsm_raw);
  uint8_t* wsm = wsm_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_addr(wsm);  // 1024-aligned: the swizzle's atom
  const uint32_t bars = base + kWStages * kWStageBytes + 2 * kWStaging;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kWStages + s); };
  const int ktiles = (g.K + kWK - 1) / kWK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        const int m0 = t % g.tiles_m * kWN;
        const int p0 = t / g.tiles_m % g.tiles_p * kWM;
        const int b = t / (g.tiles_m * g.tiles_p);
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect(full(stage), kWStageBytes);
          const uint32_t dst = base + stage * kWStageBytes;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_load3(dst + j * kWBox * 4, &act_map, full(stage), p0 + 32 * j,
                      kt * kWK, b);
          tma_load3(dst + kWABytes, &w_map, full(stage), kt * kWK, m0, 0);
          tma_load3(dst + kWABytes + kWBBytes, &w_map, full(stage), kt * kWK,
                    m0, 1);
          if (++stage == kWStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128 - 1, tw = threadIdx.x % 128;
    const int wi = tw / 32, lane = tw % 32, gid = lane / 4, tig = lane % 4;
    // this thread's A words in a stage: box 2 wg + wi / 2, pixel columns
    // col and col + 8 of it, rows 2 tig and 2 tig + 1 of each k-step
    // (+1024 bytes a step), through the 128-byte swizzle (16-byte chunk c
    // of row r at c ^ (r % 8))
    const int col = 16 * (wi % 2) + gid, ch = col / 4, e4 = (col % 4) * 4;
    const int box = (2 * wg + wi / 2) * kWBox * 4;
    const int r0 = 2 * tig, r1 = 2 * tig + 1;
    const int off[4] = {box + r0 * 128 + ((ch ^ r0) << 4) + e4,
                        box + r0 * 128 + (((ch + 2) ^ r0) << 4) + e4,
                        box + r1 * 128 + ((ch ^ r1) << 4) + e4,
                        box + r1 * 128 + (((ch + 2) ^ r1) << 4) + e4};
    float* stg = reinterpret_cast<float*>(wsm + kWStages * kWStageBytes +
                                          wg * kWStaging);
    // the last tile's epilogue: kWEpiRows float4 rows of pixels a thread
    // from the staging tile, a few inside each k-tile of the next tile
    // while its `wgmma`s run; `pend` is the next row (kWEpiRows: none)
    int pend = kWEpiRows, pb = 0, pm0 = 0, ppw = 0;
    auto epi_row = [&](int it, bool call) {
      const int i = tw + 128 * it, m = i / 16, p = i % 16 * 4;
      if (pm0 + m < g.M && ppw + p < g.N) {
        const int64_t idx =
            (static_cast<int64_t>(pb) * g.M + pm0 + m) * g.N + ppw + p;
        if (call)
          epi(idx, pb, pm0 + m,
              *reinterpret_cast<const float4*>(stg + m * kWStageRow + p));
        else
          epi.prefetch(idx);
      }
    };
    const int rows_per_ktile = (kWEpiRows + ktiles - 1) / ktiles;
    int stage = 0, phase = 0;
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      const int m0 = t % g.tiles_m * kWN;
      const int p0 = t / g.tiles_m % g.tiles_p * kWM;
      const int b = t / (g.tiles_m * g.tiles_p);
      float acc[64], part[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(full(stage), phase);
        const uint8_t* as = wsm + stage * kWStageBytes;
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split_tf32(*reinterpret_cast<const float*>(as + off[r] + 1024 * s),
                       ah[s][r], al[s][r]);
        const uint32_t bh = base + stage * kWStageBytes + kWABytes;
        const uint64_t dh = sw128_desc(bh), dl = sw128_desc(bh + kWBBytes);
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          // +32 bytes a k-step: 2 in the descriptor's 16-byte units
          if (s == 0)
            wgmma_m64n128k8<0>(part, al[s], dh);
          else
            wgmma_m64n128k8<1>(part, al[s], dh + 2 * s);
          wgmma_m64n128k8<1>(part, ah[s], dl + 2 * s);
          wgmma_m64n128k8<1>(part, ah[s], dh + 2 * s);
        }
        wgmma_commit();
        for (int r = 0; r < rows_per_ktile && pend < kWEpiRows; ++r)
          epi_row(pend++, true);
        for (int r = 0; r < rows_per_ktile && pend + r < kWEpiRows; ++r)
          epi_row(pend + r, false);  // the next k-tile's rows
        wgmma_wait_all();
        fence_regs(part);
        fence_regs(ah);
        fence_regs(al);
        if (lane == 0) mbar_arrive(empty(stage));
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
        if (++stage == kWStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      while (pend < kWEpiRows) epi_row(pend++, true);
      // acc[4 j + e]: pixel row 16 wi + gid (+8 for e >= 2), channel
      // 8 j + 2 tig + (e & 1); staged as [channel][pixel]
      named_sync(1 + wg);  // the last tile's staging is read
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          stg[(8 * j + 2 * tig + (e & 1)) * kWStageRow + 16 * wi + gid +
              (e >> 1) * 8] = acc[4 * j + e];
      named_sync(1 + wg);
      pend = 0;
      pb = b;
      pm0 = m0;
      ppw = p0 + 64 * wg;
      for (int r = 0; r < rows_per_ktile; ++r) epi_row(r, false);
    }
    while (pend < kWEpiRows) epi_row(pend++, true);
  }
}

// ---- host side ----

namespace wgmma_host {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a float32 or bfloat16 3-D tensor {d0, d1, d2} (d0 contiguous; d2 samples
// `bs` elements apart, d0 * d1 when 0) cut in boxes of {b0, b1, 1},
// 128-byte swizzle, zeros past its edges
template <class T>
static bool map3(CUtensorMap* map, const T* ptr, uint64_t d0, uint64_t d1,
                 uint64_t d2, uint32_t b0, uint32_t b1, int64_t bs = 0) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 2, "float32 or bfloat16");
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {
      d0 * sizeof(T), (bs ? static_cast<uint64_t>(bs) : d0 * d1) * sizeof(T)};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map,
            sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<T*>(ptr), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wgmma_host

// out[b] = W @ act[b] for `batch` samples of act [batch, K, N] with W's
// planes `w` (split_weights), each output through `epi`. act 16-byte
// aligned, K and N multiples of 4.
template <class Epi>
cudaError_t wgmma_gemm(const SplitWeight& w, const float* act, int batch,
                       int N, Epi epi, cudaStream_t st) {
  CUtensorMap act_map, w_map;
  if (!wgmma_host::map3(&act_map, act, N, w.K, batch, 32, kWK) ||
      !wgmma_host::map3(&w_map, w.planes, padded_k(w.K), w.M, 2, kWK, kWN))
    return cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // set at every launch, as for gemm_3xtf32_kernel
  err = cudaFuncSetAttribute(wgmma_3xtf32_kernel<Epi>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kWSmem));
  if (err != cudaSuccess) return err;
  WTiles g;
  g.M = w.M;
  g.N = N;
  g.K = w.K;
  g.tiles_m = (w.M + kWN - 1) / kWN;
  g.tiles_p = (N + kWM - 1) / kWM;
  g.tiles = batch * g.tiles_m * g.tiles_p;
  const int grid = g.tiles < sms ? g.tiles : sms;
  wgmma_3xtf32_kernel<Epi><<<grid, kWThreads, kWSmem, st>>>(act_map, w_map,
                                                            epi, g);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_gemm_launches[1];
  return err;
}

// the net's product on the sample's [I, H*W] activations with a weight
// split once a call: lipnet::product's float32 overload (launch_jt and
// run_chain, fused_ops::fwd, kernel 8's layer 1; the bfloat16 one is in
// lipnet_wgmma_bf16.cuh)
template <class Epi>
cudaError_t product(const Geometry& g, const SplitWeight& w, const float* t,
                    Epi epi, cudaStream_t st) {
  return wgmma_gemm(w, t, g.B, g.H * g.W, epi, st);
}

}  // namespace lipnet
