// The fused-stack kernel pair for Hopper (sm_90a), NCHW, in float32 or in
// bfloat16 (kernel 3's and 4's bfloat16 mode on each block, fused_block.cu):
// every pre-activated iResBlock of one scale of the residual flow in one
// call per direction. The training forward walks the blocks with their log-det
// estimators; the backward walks them in reverse with the complete
// backward of (y, logdet), second-order terms included.
//
// Replaces the TPU kernels of `indm_tpu/ops/fused_stack.py`:
//   indm_fused_stack_fwd  <- fused_stack_fwd_pallas (kernel 5)
//   indm_fused_stack_bwd  <- fused_stack_bwd_pallas (kernel 6)
// whose custom VJP is `fused_stack_apply` and whose oracle is
// `fused_stack_reference` (same file): `fused_block_reference` looped over
// the stacked blocks.
//
// What they compute. Block j of n has the normalised weights w0s[j],
// w1s[j], w2s[j], the biases, hp_all[j] (or none), the noise vareps_all[j]
// and the host's Russian-roulette draw n_all[j]. The forward runs kernel
// 3's sequence (fused_block_ops.cuh: fwd<C>) on each block in order: the
// input of block j is xs_all[j] (x for j = 0), its output is the input of
// block j + 1 and, for the last block, y; its Neumann vector goes to
// u_all[j] and its per-sample log-det to ld_all[j]. The backward runs
// kernel 4's sequence (bwd<C>) from block n - 1 down to block 0, each on
// its saved input xs_all[j] and u_all[j], with the cotangent of its output
// (ybar for the last block, the previous step's xbar otherwise) and the
// same log-det cotangent lbar for every block (the cotangent of the sum of
// the log-dets). Its gradients land at block j's place, in forward order,
// as `fused_stack.py:346-348` returns them.
//
// Design. The TPU kernels kept the carry in a VMEM output window and
// walked the blocks as the inner grid dimension of one launch. Here:
//   * The carry stays in device memory: block j reads xs_all[j] and writes
//     its output straight into xs_all[j + 1], which is block j + 1's input
//     and the backward's residual, so no copy is made and nothing that a
//     later block or the backward reads is overwritten. The backward's
//     cotangent alternates between xbar and one scratch buffer, chosen so
//     that block 0 writes xbar.
//   * The transposed (VJP) convs of all n blocks are made once per call by
//     one device kernel each (transpose_stack_kernel), not by three tensor
//     ops per block in the wrapper; the forward also splits every block's
//     W1 and W1^T into TF32 hi and lo planes once per call (make_planes),
//     which its `wgmma` products read.
//   * Each block's signed chain coefficients come from n_all and the
//     coefficient table inside the call, as `neumann.chain_coeffs`
//     computes them (float32, the same bits).
//   * One scratch buffer, allocated once per call by the wrapper, serves
//     every block.
//   * The weight and bias gradients stay per-sample partials summed in
//     sample order (kernel 4's batch_sum_kernel): no atomics, and two runs
//     give the same bits. Each block runs the same launches on the same
//     inputs as kernels 3 and 4 would, so the stack gives the same bits as
//     kernels 3 and 4 looped over its blocks.
//   * The whole stack is one ctypes call per scale and direction: no Python
//     and no tensor op per block.
//
// Why not one persistent kernel. One block's 512-wide intermediates are
// [B, I, H, W] float32 tensors of 268 MB each at scale 0 (B = 128, 32x32,
// I = 512), against 227 KB of shared memory on an SM and 50 MB of L2. So
// each block's work spans the whole card, and block j + 1 may start only
// when every SM has finished block j: a card-wide barrier, which a kernel
// boundary gives for free. A cooperative persistent kernel (grid-wide
// syncs between the layers) or a CUDA graph of the launches is later
// speed work, and only where a trace shows gaps between the launches.
//
// Bound. With A the flops of one application of the net,
// 2*B*H*W*(9*C*I + I*I + 9*I*C) (A0 = 76.0 GFLOP at scale 0, A1 = 24.4 at
// scale 1, C = 12, 16x16), and N = 2*B*H*W*9*I*C a narrow 3x3 conv, the
// forward is sum_j (n_j + offset + 2) A and the backward, for
// pre-activated blocks, n (6 A - 2 N) (kernel 3's and kernel 4's counts,
// fused_block.cu). With the 1x1 products as three TF32 passes at 495
// TFLOP/s and the narrow convs at 67 TFLOP/s of float32 on an H100 SXM, A0
// is at least 0.52 ms: the 15 blocks of scale 0 at n = 2 are 47 ms
// forward. The bytes (each input read once, each output written once:
// x, the stacked noise, weights and residuals) are far below: 0.1 GB at
// scale 0, 0.03 ms. So both calls are bound by operations, 90 % of them
// the 1x1 products, and the design does for the bound what kernels 3 and
// 4 do: 3xTF32 tensor-core products with each sin/cos in an epilogue.
// The stack removes the per-block host work around them.
//
// Interface: plain C, loaded with ctypes (indm_torch/ops/fused_stack.py).
// The caller allocates every output and one scratch buffer of the size in
// the entry point's comment. All launches go on the caller's stream; each
// entry point returns the first CUDA error (0 on success) and never
// synchronises.

#include <vector>

#include "fused_block_ops.cuh"

namespace {

using bf16 = __nv_bfloat16;
using fused_ops::bad_geometry;
using fused_ops::kBf16;
using lipnet::Geometry;

// wt[j, i, o, t] = w[j, o, i, taps - 1 - t]: the transposed (VJP) conv of
// each block's [O, Ic, k, k] weight (spatial flip, in/out swap; taps = k*k),
// as `neumann.transpose_conv_weight` computes it
template <class T>
__global__ void transpose_stack_kernel(const T* __restrict__ w, T* wt,
                                       int64_t n, int O, int Ic, int taps) {
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int t = static_cast<int>(e % taps);
    int64_t r = e / taps;
    const int o = static_cast<int>(r % O);
    r /= O;
    const int i = static_cast<int>(r % Ic);
    const int64_t j = r / Ic;
    wt[e] = w[((j * O + o) * Ic + i) * taps + taps - 1 - t];
  }
}

// The stacked weights (in T) and their transposed convs, made once per
// call at the front of the scratch buffer.
template <class T>
struct Stack {
  const T *w0, *w1, *w2;  // [n, I, C, 3, 3], [n, I, I], [n, C, I, 3, 3]
  T *w2t, *w1t, *w0t;     // [n, I, C, 3, 3], [n, I, I], [n, C, I, 3, 3]
  int64_t n0, n1;         // elements per block: I*C*9 and I*I
};

inline int64_t transposed_elems(int nb, int C, int I) {
  return static_cast<int64_t>(nb) *
         (2 * I * C * 9 + static_cast<int64_t>(I) * I);
}

template <int C, class T>
cudaError_t make_stack(const Geometry& g, int nb, const T* w0s, const T* w1s,
                       const T* w2s, T* scratch, Stack<T>* s,
                       cudaStream_t st) {
  s->w0 = w0s;
  s->w1 = w1s;
  s->w2 = w2s;
  s->n0 = static_cast<int64_t>(g.I) * C * 9;
  s->n1 = static_cast<int64_t>(g.I) * g.I;
  s->w2t = scratch;
  s->w1t = s->w2t + nb * s->n0;
  s->w0t = s->w1t + nb * s->n1;
  const struct {
    const T* w;
    T* wt;
    int64_t n;
    int O, Ic, taps;
  } jobs[] = {{w2s, s->w2t, nb * s->n0, C, g.I, 9},
              {w1s, s->w1t, nb * s->n1, g.I, g.I, 1},
              {w0s, s->w0t, nb * s->n0, g.I, C, 9}};
  for (const auto& j : jobs) {
    transpose_stack_kernel<<<fused_ops::grid_1d(j.n), 256, 0, st>>>(
        j.w, j.wt, j.n, j.O, j.Ic, j.taps);
    RETURN_IF(cudaGetLastError());
  }
  return cudaSuccess;
}

// (-1)^k coeff(k) for k = 1..n+offset, coeff(k) = 1{n >= k - offset} /
// table[min(k, len - 1)], in float32 as `neumann.chain_coeffs` computes them
void chain_coeffs(int n, int offset, const float* table, int table_len,
                  std::vector<float>* out) {
  out->resize(n + offset);
  for (int k = 1; k <= n + offset; ++k) {
    const float ind = n >= k - offset ? 1.f : 0.f;
    const float c = ind / table[k < table_len - 1 ? k : table_len - 1];
    (*out)[k - 1] = k % 2 == 1 ? -c : c;
  }
}

// the scratch of stack_fwd in bytes: the transposed convs, in float every
// block's W1 and W1^T planes, then fwd's temporaries
template <class T>
int64_t stack_fwd_bytes(const Geometry& g, int nb, int C) {
  return static_cast<int64_t>(sizeof(T)) * transposed_elems(nb, C, g.I) +
         (kBf16<T> ? 0 : 4 * nb * fused_ops::plane_floats(g.I)) +
         fused_ops::fwd_scratch_bytes<T>(g, C);
}

// the scratch of stack_bwd in bytes: the transposed convs, the carry, then
// bwd's scratch
template <class T>
int64_t stack_bwd_bytes(const Geometry& g, int nb, int C) {
  return static_cast<int64_t>(sizeof(T)) * transposed_elems(nb, C, g.I) +
         4 * static_cast<int64_t>(g.B) * C * g.H * g.W +
         fused_ops::bwd_scratch_bytes<T>(g, C);
}

template <int C, class T>
cudaError_t stack_fwd(const Geometry& g, int nb, const float* x,
                      const float* eps_all, const int* n_all,
                      const float* table, int table_len, int offset,
                      const T* w0s, const T* w1s, const T* w2s,
                      const T* b0s, const T* b1s, const T* b2s,
                      const T* hp_all, bool preact, float* y,
                      float* ld_all, float* u_all, float* xs_all,
                      void* scratch, cudaStream_t st) {
  const int64_t nn = static_cast<int64_t>(g.B) * C * g.H * g.W;
  const int64_t bi = static_cast<int64_t>(g.B) * g.I;
  Stack<T> s;
  RETURN_IF(make_stack<C>(g, nb, w0s, w1s, w2s, static_cast<T*>(scratch), &s,
                          st));
  char* rest = static_cast<char*>(scratch) +
               sizeof(T) * transposed_elems(nb, C, g.I);
  float* planes = reinterpret_cast<float*>(rest);
  const int64_t np = fused_ops::plane_floats(g.I);
  void* block_scratch = rest;
  if constexpr (!kBf16<T>) {
    RETURN_IF(fused_ops::make_planes(w1s, s.w1t, nb, g.I, planes, st));
    block_scratch = planes + nb * np;
  }
  RETURN_IF(cudaMemcpyAsync(xs_all, x, nn * sizeof(float),
                            cudaMemcpyDeviceToDevice, st));
  std::vector<float> coeffs;
  for (int j = 0; j < nb; ++j) {
    chain_coeffs(n_all[j], offset, table, table_len, &coeffs);
    float* out = j + 1 < nb ? xs_all + (j + 1) * nn : y;
    const T* hp = hp_all ? hp_all + j * bi : nullptr;
    if constexpr (kBf16<T>) {
      RETURN_IF(fused_ops::fwd<C>(
          g, xs_all + j * nn, eps_all + j * nn, s.w0 + j * s.n0,
          s.w1 + j * s.n1, static_cast<const T*>(s.w1t + j * s.n1),
          s.w2 + j * s.n0, s.w2t + j * s.n0, s.w0t + j * s.n0,
          b0s + j * g.I, b1s + j * g.I, b2s + j * C, hp, coeffs.data(),
          static_cast<int>(coeffs.size()), preact, out, u_all + j * nn,
          ld_all + static_cast<int64_t>(j) * g.B, block_scratch, st));
    } else {
      const float* pj = planes + j * np;
      const lipnet::SplitWeight w1{pj, g.I, g.I};
      const lipnet::SplitWeight w1t{pj + lipnet::split_floats(g.I, g.I), g.I,
                                    g.I};
      RETURN_IF(fused_ops::fwd<C>(
          g, xs_all + j * nn, eps_all + j * nn, s.w0 + j * s.n0, w1, w1t,
          s.w2 + j * s.n0, s.w2t + j * s.n0, s.w0t + j * s.n0,
          b0s + j * g.I, b1s + j * g.I, b2s + j * C, hp, coeffs.data(),
          static_cast<int>(coeffs.size()), preact, out, u_all + j * nn,
          ld_all + static_cast<int64_t>(j) * g.B, block_scratch, st));
    }
  }
  return cudaSuccess;
}

template <int C, class T>
cudaError_t stack_bwd(const Geometry& g, int nb, const float* xs_all,
                      const float* eps_all, const float* u_all,
                      const float* ybar, const float* lbar, const T* w0s,
                      const T* w1s, const T* w2s, const T* b0s,
                      const T* b1s, const T* hp_all, bool preact,
                      float* xbar, float* w0g, float* w1g, float* w2g,
                      float* b0g, float* b1g, float* b2g, float* hbar,
                      void* scratch, cudaStream_t st) {
  const int64_t nn = static_cast<int64_t>(g.B) * C * g.H * g.W;
  const int64_t bi = static_cast<int64_t>(g.B) * g.I;
  Stack<T> s;
  RETURN_IF(make_stack<C>(g, nb, w0s, w1s, w2s, static_cast<T*>(scratch), &s,
                          st));
  float* carry = reinterpret_cast<float*>(
      static_cast<char*>(scratch) + sizeof(T) * transposed_elems(nb, C, g.I));
  float* block_scratch = carry + nn;
  const float* cot = ybar;  // the cotangent of block j's output
  for (int j = nb - 1; j >= 0; --j) {
    float* out = j % 2 == 0 ? xbar : carry;  // never the buffer cot reads
    RETURN_IF(fused_ops::bwd<C>(
        g, xs_all + j * nn, eps_all + j * nn, u_all + j * nn, cot, lbar,
        s.w0 + j * s.n0, s.w1 + j * s.n1, static_cast<const T*>(
            s.w2t + j * s.n0),
        static_cast<const T*>(s.w1t + j * s.n1),
        static_cast<const T*>(s.w0t + j * s.n0), b0s + j * g.I,
        b1s + j * g.I, hp_all ? hp_all + j * bi : nullptr, preact, out,
        w0g + j * s.n0, w1g + j * s.n1, w2g + j * s.n0, b0g + j * g.I,
        b1g + j * g.I, b2g + j * C, hbar ? hbar + j * bi : nullptr,
        block_scratch, st));
    cot = out;
  }
  return cudaSuccess;
}

bool bad_stack(int nb, const int* n_all, int offset, int table_len) {
  if (nb <= 0 || offset < 0 || table_len <= 0) return true;
  for (int j = 0; j < nb; ++j)
    if (n_all[j] < 0) return true;
  return false;
}

template <class T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}
float* out(void* p) { return static_cast<float*>(p); }

template <int C, class T>
cudaError_t stack_fwd_v(const Geometry& g, int nb, const void* x,
                        const void* eps_all, const int* n_all,
                        const float* table, int table_len, int offset,
                        const void* w0s, const void* w1s, const void* w2s,
                        const void* b0s, const void* b1s, const void* b2s,
                        const void* hp_all, bool preact, void* y,
                        void* ld_all, void* u_all, void* xs_all,
                        void* scratch, cudaStream_t st) {
  return stack_fwd<C>(g, nb, in<float>(x), in<float>(eps_all), n_all, table,
                      table_len, offset, in<T>(w0s), in<T>(w1s), in<T>(w2s),
                      in<T>(b0s), in<T>(b1s), in<T>(b2s), in<T>(hp_all),
                      preact, out(y), out(ld_all), out(u_all), out(xs_all),
                      scratch, st);
}

template <int C, class T>
cudaError_t stack_bwd_v(const Geometry& g, int nb, const void* xs_all,
                        const void* eps_all, const void* u_all,
                        const void* ybar, const void* lbar, const void* w0s,
                        const void* w1s, const void* w2s, const void* b0s,
                        const void* b1s, const void* hp_all, bool preact,
                        void* xbar, void* w0g, void* w1g, void* w2g,
                        void* b0g, void* b1g, void* b2g, void* hbar,
                        void* scratch, cudaStream_t st) {
  return stack_bwd<C>(g, nb, in<float>(xs_all), in<float>(eps_all),
                      in<float>(u_all), in<float>(ybar), in<float>(lbar),
                      in<T>(w0s), in<T>(w1s), in<T>(w2s), in<T>(b0s),
                      in<T>(b1s), in<T>(hp_all), preact, out(xbar), out(w0g),
                      out(w1g), out(w2g), out(b0g), out(b1g), out(b2g),
                      out(hbar), scratch, st);
}

}  // namespace

extern "C" {

// Kernel 5. x, y: [B, C, H, W]; eps_all, u_all, xs_all: [n, B, C, H, W];
// ld_all [n, B]; all float32. w0s [n, I, C, 3, 3], w1s [n, I, I],
// w2s [n, C, I, 3, 3]; b0s, b1s [n, I], b2s [n, C]; hp_all [n, B, I] or
// null: float32, or bfloat16 with bf16 != 0 (kernel 3's bfloat16 mode on
// every block). All contiguous, on the card. n_all: n host ints (each
// block's draw); table: table_len host floats (the coefficient table).
// scratch: scratch_bytes bytes; in float32 scratch: at least
// n*(18*I*C + I*I + 4*I*I8) + 4*B*I*H*W + 5*B*C*H*W floats, I8 = I rounded
// up to a multiple of 8: the transposed convs, every block's W1 and W1^T
// planes, then fwd's temporaries; in bfloat16 stack_fwd_bytes. Geometry as
// kernel 3.
int indm_fused_stack_fwd(const void* x, const void* eps_all, const int* n_all,
                         int nb, const float* table, int table_len,
                         int offset, const void* w0s, const void* w1s,
                         const void* w2s, const void* b0s, const void* b1s,
                         const void* b2s, const void* hp_all, int preact,
                         int bf16_mode, void* y, void* ld_all, void* u_all,
                         void* xs_all, void* scratch, int64_t scratch_bytes,
                         int B, int C, int H, int W, int I, void* stream) {
  if (bad_geometry(B, C, H, W, I, bf16_mode != 0) ||
      bad_stack(nb, n_all, offset, table_len))
    return cudaErrorInvalidValue;
  const Geometry g(B, H, W, I);
  if (scratch_bytes < (bf16_mode ? stack_fwd_bytes<bf16>(g, nb, C)
                                 : stack_fwd_bytes<float>(g, nb, C)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = bf16_mode ? (C == 3 ? stack_fwd_v<3, bf16> : stack_fwd_v<12, bf16>)
                       : (C == 3 ? stack_fwd_v<3, float>
                                 : stack_fwd_v<12, float>);
  return run(g, nb, x, eps_all, n_all, table, table_len, offset, w0s, w1s,
             w2s, b0s, b1s, b2s, hp_all, preact != 0, y, ld_all, u_all,
             xs_all, scratch, st);
}

// Kernel 6. xs_all, eps_all, u_all: [n, B, C, H, W] (kernel 5's residuals);
// ybar, xbar: [B, C, H, W]; lbar [B]; all float32. The weights, b0s, b1s
// and hp_all as for kernel 5, in float32 or (bf16 != 0) bfloat16; outputs,
// float32, block j at index j: w0g [n, I, C, 3, 3], w1g [n, I, I],
// w2g [n, C, I, 3, 3], b0g, b1g [n, I], b2g [n, C], hbar [n, B, I]
// (written when hp_all is given). scratch: scratch_bytes bytes; in
// float32 scratch: at least n*(18*I*C + I*I) + B*C*H*W plus kernel 4's
// 11*B*I*H*W + 6*B*C*H*W + B*I*I + 18*B*I*C + 2*B*I + B*C floats; in
// bfloat16 stack_bwd_bytes. Geometry as kernel 3.
int indm_fused_stack_bwd(const void* xs_all, const void* eps_all,
                         const void* u_all, const void* ybar,
                         const void* lbar, int nb, const void* w0s,
                         const void* w1s, const void* w2s, const void* b0s,
                         const void* b1s, const void* hp_all, int preact,
                         int bf16_mode, void* xbar, void* w0g, void* w1g,
                         void* w2g, void* b0g, void* b1g, void* b2g,
                         void* hbar, void* scratch, int64_t scratch_bytes,
                         int B, int C, int H, int W, int I, void* stream) {
  if (bad_geometry(B, C, H, W, I, bf16_mode != 0) || nb <= 0)
    return cudaErrorInvalidValue;
  const Geometry g(B, H, W, I);
  if (scratch_bytes < (bf16_mode ? stack_bwd_bytes<bf16>(g, nb, C)
                                 : stack_bwd_bytes<float>(g, nb, C)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = bf16_mode ? (C == 3 ? stack_bwd_v<3, bf16> : stack_bwd_v<12, bf16>)
                       : (C == 3 ? stack_bwd_v<3, float>
                                 : stack_bwd_v<12, float>);
  return run(g, nb, xs_all, eps_all, u_all, ybar, lbar, w0s, w1s, w2s, b0s,
             b1s, hp_all, preact != 0, xbar, w0g, w1g, w2g, b0g, b1g, b2g,
             hbar, scratch, st);
}

}  // extern "C"
