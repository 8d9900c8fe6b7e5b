// The Lipschitz net's 512-wide products in bfloat16 on Hopper's warpgroup
// tensor cores (`wgmma`, sm_90a): every product of the bfloat16 mode of
// kernels 3-8 (`fwd<C, __nv_bfloat16>`, `bwd`, the chains of kernels 7 and
// 8 in bfloat16), and the entry point `indm_lipnet_gemm_bf16`.
//
//   out[b][m][n] = sum_pairs sum_k A[b][m][k] B[b][k][n]     (mat_wide)
//   out[b][m][n] = sum_pairs sum_k A[b][m][k] B[b][n][k]     (kBT)
//
// A [M, K] is K-major, a weight shared by the batch (a per-batch stride of
// 0) or per sample; B is the NCHW activations [K, N = H*W], N-major, or,
// with kBT, [N, K] K-major (the w1 gradient, contracted over the pixels).
// One to kMaxPairs pairs (a float32 operand enters as its bfloat16 hi and
// lo pairs, the caller splits it); each output goes to an epilogue functor
// as a float4 of four consecutive n (lipnet_ops.cuh's StoreT and DMulT,
// fused_block_ops.cuh's Layer1T and TangentT, fused_chain.cu's D2T).
//
// Replaces, in the bfloat16 mode, the in-VMEM `_apply_packed(kind="mat")`
// (indm_tpu/ops/neumann_pallas.py:74-76) and `_wgrad`
// (indm_tpu/ops/fused_block.py:165-168) of TPU kernels 3-8, where the MXU
// takes bfloat16 operands and `preferred_element_type` float32.
//
// Operands. Both come from shared memory through TMA with the 128-byte
// swizzle, as they lie in device memory: no register operand, no split.
// Unlike a TF32 operand, a bfloat16 one may be MN-major in shared memory
// (the descriptor's transpose bit), so the pixel-contiguous activations of
// mat_wide need no transposing stage. A stage holds 64 of K (128 bytes a
// row): A as one 128 x 64 box (rows m), B as one 128 x 64 box (kBT, rows
// n) or two 64 x 64 boxes (64 k rows of 64 n each, 8 KB apart: the
// descriptor's leading byte offset).
//
// Arithmetic: `wgmma.m64n128k16.f32.bf16.bf16`: the bfloat16 products are
// exact in float32 and accumulate in float32, the contract of the TPU
// kernels' bfloat16 dots. The tensor core's float32 accumulate truncates,
// so each k-tile of 32 (two `wgmma`s) sums into a fresh accumulator
// (`scale-d` = 0 on its first), added to the total in float32 (round to
// nearest), as gemm_3xtf32_kernel does. The k-tiles are walked in order,
// pair after pair; the sum order depends on (M, N, K, pairs) only: no
// split-K, no atomic, the same bits for every caller, batch size and tile
// schedule.
//
// Schedule: wgmma_3xtf32_kernel's (lipnet_wgmma.cuh). Persistent blocks of
// three warpgroups, one block an SM. Warp 0 of the producer warpgroup
// issues the TMA copies into a ring of kXStages stages, each guarded by a
// full and an empty `mbarrier`, and gives up its registers (`setmaxnreg`)
// to the two consumer warpgroups. A block tile is 128 output rows m x 128
// columns n of one sample; each consumer owns 64 rows (m64n128k16, 64
// float32 accumulators a thread and a part of 64 for each of a stage's two
// k-tiles, whose four `wgmma`s run as one group), both read the same B
// tile. Tiles are walked with the m tile fastest (the readers
// of one activation tile run together, in L2) and dealt to the blocks
// round robin. A tile's outputs go through a padded staging tile, so each
// thread hands the functor float4 rows of n and the stores and the
// diagonal's reads stay coalesced; the consumers hand them over a few
// rows a stage while the next tile's `wgmma`s run, each row's loads
// started a stage ahead (the functor's prefetch, where it has one).
//
// Bound at the main path's six products (B = 128, I = 512; chip_smoke.py
// phase 6e): 515 GFLOP, 0.52 ms at 989 TFLOP/s (dense bfloat16), against
// 0.73 ms for the bfloat16 operands read and the float32 outputs written
// once at 3.35 TB/s: bound by bytes, mat_wide by far (0.12 ms of bytes to
// 0.07 of operations at scale 0), the three-pair w1 gradient by a little.
// So the design keeps the loads in flight (TMA, a ring of four stages)
// and the output stores beside the tensor cores (the staging tile drained
// during the next tile) rather than raising the tensor-core rate.

#pragma once

#include <cuda_bf16.h>

#include "lipnet_wgmma.cuh"

namespace lipnet {

constexpr int kMaxPairs = 3;
constexpr int kXM = 128;     // output rows m of a block tile: two consumers
constexpr int kXN = 128;     // output columns n of a block tile
constexpr int kXK = 64;      // k of a stage: 128 bytes of bfloat16
constexpr int kXKTile = 32;  // k of a fresh accumulator
constexpr int kXStages = 4;  // the TMA ring
constexpr int kXThreads = 384;  // producer warpgroup + 2 consumers
constexpr int kXABytes = kXM * kXK * 2;  // 16 KB
constexpr int kXBBytes = kXN * kXK * 2;  // 16 KB
constexpr int kXStageBytes = kXABytes + kXBBytes;
constexpr int kXStageRow = kXN + 8;  // staging row (m) in floats
constexpr int kXStaging = 64 * kXStageRow * 4;   // a consumer's, bytes
constexpr int kXEpiRows = 64 * kXN / 4 / 128;    // float4s a thread a tile
constexpr size_t kXSmem = 1024 + kXStages * kXStageBytes + 2 * kXStaging +
                          2 * kXStages * 8;
static_assert(kXSmem <= 232448, "fits an SM's shared memory");
static_assert(kXStageRow % 32 == 8, "conflict-free staging stores");
static_assert(kXK == 2 * kXKTile, "two k-tiles a stage");

struct GemmBf16Args {
  const __nv_bfloat16* a[kMaxPairs];
  const __nv_bfloat16* b[kMaxPairs];
  int pairs;
  int64_t a_bs, b_bs;  // per-batch strides in elements; 0 shares the operand
  int M, N, K;
};

// the A box, the B boxes and their tensor maps, one pair each
struct XMaps {
  CUtensorMap a[kMaxPairs];
  CUtensorMap b[kMaxPairs];
};

struct XTiles {
  int M, N, K, pairs;
  int kstages;                  // stages of one pair
  int tiles_m, tiles_n, tiles;  // m tiles, n tiles, all
  int a_shared, b_shared;       // the operand's batch coordinate is 0
};

// the descriptor of an MN-major tile with 128-byte swizzle (8 k rows of 128
// bytes an atom, 8-row groups 1024 bytes apart) whose 64-element runs of
// MN are `lbo` bytes apart
__device__ __forceinline__ uint64_t sw128_desc_mn(uint32_t addr,
                                                  uint32_t lbo) {
  return (sw128_desc(addr) & ~(static_cast<uint64_t>(0x3FFF) << 16)) |
         (static_cast<uint64_t>(lbo >> 4) << 16);
}

// d (+)= a @ b for a 64 x 128 x 16 bfloat16 step, both from shared memory;
// kScaleD = 0 overwrites d; kTransB = 1 reads b MN-major
template <int kScaleD, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64],
                                                      uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
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
      : "l"(da), "l"(db), "r"(kScaleD), "n"(kTransB));
}

__device__ __forceinline__ const CUtensorMap* pick(const CUtensorMap (&m)[3],
                                                   int p) {
  return p == 0 ? &m[0] : (p == 1 ? &m[1] : &m[2]);
}

// epi(idx, b, m, 4 sums from column n) over out [B, M, N], idx = (b M + m)
// N + n: the note at the top of this file.
template <bool kBT, class Epi>
__global__ void __launch_bounds__(kXThreads, 1)
    wgmma_bf16_kernel(const __grid_constant__ XMaps maps, Epi epi,
                      XTiles g) {
  extern __shared__ uint8_t xsm_raw[];
  const uint32_t raw = smem_addr(xsm_raw);
  uint8_t* xsm = xsm_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_addr(xsm);  // 1024-aligned: the swizzle's atom
  const uint32_t bars = base + kXStages * kXStageBytes + 2 * kXStaging;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kXStages + s); };
  const int steps = g.pairs * g.kstages;  // stages a tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < kXStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        const int m0 = t % g.tiles_m * kXM;
        const int n0 = t / g.tiles_m % g.tiles_n * kXN;
        const int b = t / (g.tiles_m * g.tiles_n);
        const int ba = g.a_shared ? 0 : b, bb = g.b_shared ? 0 : b;
        for (int i = 0; i < steps; ++i) {
          const int p = i / g.kstages, k0 = i % g.kstages * kXK;
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect(full(stage), kXStageBytes);
          const uint32_t dst = base + stage * kXStageBytes;
          tma_load3(dst, pick(maps.a, p), full(stage), k0, m0, ba);
          if (kBT) {
            tma_load3(dst + kXABytes, pick(maps.b, p), full(stage), k0, n0,
                      bb);
          } else {
#pragma unroll
            for (int j = 0; j < 2; ++j)
              tma_load3(dst + kXABytes + j * (kXBBytes / 2), pick(maps.b, p),
                        full(stage), n0 + 64 * j, k0, bb);
          }
          if (++stage == kXStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128 - 1, tw = threadIdx.x % 128;
    const int wi = tw / 32, lane = tw % 32, gid = lane / 4, tig = lane % 4;
    float* stg = reinterpret_cast<float*>(xsm + kXStages * kXStageBytes +
                                          wg * kXStaging);
    // the last tile's epilogue: kXEpiRows float4 rows of n a thread from
    // the staging tile, a few inside each stage of the next tile while its
    // `wgmma`s run; `pend` is the next row (kXEpiRows: none)
    int pend = kXEpiRows, pb = 0, pm0 = 0, pn0 = 0;
    auto epi_row = [&](int it, bool call) {
      const int i = tw + 128 * it, m = i / (kXN / 4), n = i % (kXN / 4) * 4;
      if (pm0 + m < g.M && pn0 + n < g.N) {
        const int64_t idx =
            (static_cast<int64_t>(pb) * g.M + pm0 + m) * g.N + pn0 + n;
        if (call)
          epi(idx, pb, pm0 + m,
              *reinterpret_cast<const float4*>(stg + m * kXStageRow + n));
        else
          maybe_prefetch(epi, idx);
      }
    };
    const int rows_per_step = (kXEpiRows + steps - 1) / steps;
    // one k-tile of 32 (two `wgmma`s) into a fresh part: the stage's
    // first (h = 0) or second (all zeros past K: TMA's fill)
    auto ktile = [&](float(&part)[64], uint64_t da, uint64_t db, int h) {
      // A: +32 bytes a k16 step (2 in the descriptor's 16-byte units); B:
      // the same K-major, 16 rows of 128 bytes (128) MN-major
      const int k0 = 2 * h, k1 = 2 * h + 1;
      wgmma_m64n128k16_bf16<0, kBT ? 0 : 1>(
          part, da + 2 * k0, kBT ? db + 2 * k0 : db + 128 * k0);
      wgmma_m64n128k16_bf16<1, kBT ? 0 : 1>(
          part, da + 2 * k1, kBT ? db + 2 * k1 : db + 128 * k1);
    };
    int stage = 0, phase = 0;
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      const int m0 = t % g.tiles_m * kXM;
      const int n0 = t / g.tiles_m % g.tiles_n * kXN;
      const int b = t / (g.tiles_m * g.tiles_n);
      float acc[64], part_a[64], part_b[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      // A stage's two k-tiles in flight together, each into its own part:
      // no register of a `wgmma` in flight is read (ptxas would serialise
      // the `wgmma`s), and both parts are added to acc, in k order, once
      // the stage's group has completed; the other consumer's `wgmma`s keep
      // the tensor cores busy meanwhile.
      for (int i = 0; i < steps; ++i) {
        mbar_wait(full(stage), phase);
        const uint32_t sa = base + stage * kXStageBytes;
        const uint64_t da = sw128_desc(sa + wg * 64 * 128);
        const uint64_t db = kBT ? sw128_desc(sa + kXABytes)
                                : sw128_desc_mn(sa + kXABytes, kXBBytes / 2);
        fence_regs(part_a);
        fence_regs(part_b);
        wgmma_fence();
        ktile(part_a, da, db, 0);
        ktile(part_b, da, db, 1);
        wgmma_commit();
        for (int r = 0; r < rows_per_step && pend < kXEpiRows; ++r)
          epi_row(pend++, true);
        for (int r = 0; r < rows_per_step && pend + r < kXEpiRows; ++r)
          epi_row(pend + r, false);  // the next stage's rows
        wgmma_wait_all();
        fence_regs(part_a);
        fence_regs(part_b);
        if (lane == 0) mbar_arrive(empty(stage));
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] += part_a[e];
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] += part_b[e];
        if (++stage == kXStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      while (pend < kXEpiRows) epi_row(pend++, true);
      // acc[4 j + e]: row m = 16 wi + gid (+8 for e >= 2), column
      // n = 8 j + 2 tig + (e & 1); staged as [m][n]
      named_sync(1 + wg);  // the last tile's staging is read
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          *reinterpret_cast<float2*>(
              stg + (16 * wi + gid + (e >> 1) * 8) * kXStageRow + 8 * j +
              2 * tig) = make_float2(acc[4 * j + e], acc[4 * j + e + 1]);
      named_sync(1 + wg);
      pend = 0;
      pb = b;
      pm0 = m0 + 64 * wg;
      pn0 = n0;
      for (int r = 0; r < rows_per_step; ++r) epi_row(r, false);
    }
    while (pend < kXEpiRows) epi_row(pend++, true);
  }
}

// ---- host side ----

// the bfloat16 GEMM's [M, N] outputs of `a` for each of `batch` samples.
// The pointers 16-byte aligned, K and N multiples of 8 and the per-batch
// strides multiples of 8 (TMA's 16-byte strides), checked by the callers.
template <bool kBT, class Epi>
cudaError_t gemm_bf16(const GemmBf16Args& a, int batch, Epi epi,
                      cudaStream_t st) {
  if (a.pairs < 1 || a.pairs > kMaxPairs) return cudaErrorInvalidValue;
  XMaps maps;
  const uint64_t ab = a.a_bs ? batch : 1, bb = a.b_bs ? batch : 1;
  for (int p = 0; p < a.pairs; ++p) {
    bool ok = wgmma_host::map3(&maps.a[p], a.a[p], a.K, a.M, ab, kXK, kXM,
                               a.a_bs);
    ok = ok && (kBT ? wgmma_host::map3(&maps.b[p], a.b[p], a.K, a.N, bb, kXK,
                                       kXN, a.b_bs)
                    : wgmma_host::map3(&maps.b[p], a.b[p], a.N, a.K, bb, 64,
                                       kXK, a.b_bs));
    if (!ok) return cudaErrorInvalidValue;
  }
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // set at every launch, as for gemm_3xtf32_kernel
  err = cudaFuncSetAttribute(wgmma_bf16_kernel<kBT, Epi>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kXSmem));
  if (err != cudaSuccess) return err;
  XTiles g;
  g.M = a.M;
  g.N = a.N;
  g.K = a.K;
  g.pairs = a.pairs;
  g.kstages = (a.K + kXK - 1) / kXK;
  g.tiles_m = (a.M + kXM - 1) / kXM;
  g.tiles_n = (a.N + kXN - 1) / kXN;
  g.tiles = batch * g.tiles_m * g.tiles_n;
  g.a_shared = a.a_bs == 0;
  g.b_shared = a.b_bs == 0;
  const int grid = g.tiles < sms ? g.tiles : sms;
  wgmma_bf16_kernel<kBT, Epi><<<grid, kXThreads, kXSmem, st>>>(maps, epi, g);
  err = cudaGetLastError();
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

}  // namespace lipnet
