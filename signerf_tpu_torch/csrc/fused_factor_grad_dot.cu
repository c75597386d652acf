// The factor-grid encode's spatial derivative contracted with a feature
// cotangent (K5), and its backward (K6), for Hopper (sm_90a).
//
// K5 replaces the TPU kernel `fused_factor_grad_dot_tpu` and K6
// `fused_factor_grad_dot_bwd_tpu` (its "tables" and "coords_g"
// pallas_calls) in signerf_tpu/ops/fused_factor_pallas.py. The gradient
// normals need only d density / d pos01, so the [N, 3, L F] derivative of
// the features is never formed: with K1's taps (fused_factor_density.cu),
// per sample n, level l and axis a (b, c the other two),
//
//   f_a = (1 - w_a) line[i_a] + w_a line[i_a + 1],  d_a = (line[i_a + 1] - line[i_a]) s_a
//   K5:  s[n, a] = sum_l sum_F d_a f_b f_c g_l                            [N, 3]
//
// where s_a = R_l - 1 off the knots and 0 at an exact knot (u (R - 1) an
// integer, u = 0 and u = 1 included): the rule of both JAX versions
// (dhat_matrix's sign(0) = 0 and |diff| < 1; the Pallas taps). Given the
// cotangent ct [N, 3] of s, K6 takes
//
//   G_hat_a  = ct_b g d_b f_c + ct_c g d_c f_b      (f_a's place in s_b, s_c)
//   G_dhat_a = ct_a g f_b f_c                       (d_a's place in s_a)
//   tables: dline_a[i_a]     += (1 - w_a) G_hat_a - s_a G_dhat_a
//           dline_a[i_a + 1] +=       w_a G_hat_a + s_a G_dhat_a
//           grad_g[n, l F + k] = sum_a ct_a d_a f_b f_c                   [N, L F]
//   coords: du_a = sum_l sum_F G_hat_a d_a  (d d_a / du = 0 almost everywhere)
//
// All in f32: bf16 tables, f32 tap weights, slopes, products and sums (the
// Pallas kernel rounds hat, dhat and its GEMM operands to bf16; that only
// fed the TPU's matrix unit). grad_g is written by every tables launch,
// since the base MLP's weights get their orientation-loss gradient through
// g. The coords half is its own launch, made only when x01 needs a
// gradient (camera optimisation), so a normal step does not pay for it;
// the Pallas kernel bundled coords with grad_g.
//
// What bounds them on an H100, at the base field's schedule (8 levels,
// F = 16, tables in L2): K5 reads g, N x 512 bytes (about 100 MB per
// signerf micro-batch), and writes 12 bytes a sample, so it is a read of
// g; K6's tables half reads g, writes grad_g (another 100 MB) and makes
// 2 x 3 x 8 x 16 scattered f32 additions per sample, which bound it unless
// runs of lanes share them.
//
// The design of K5 is K3's (fused_factor_encode.cu) mirrored for a read:
// persistent blocks of 256 threads walk over tiles of 32 samples, three
// blocks an SM. Each tile's g (32 x 512 bytes for the base field) comes
// into shared memory by one bulk copy of the Tensor Memory Accelerator
// (cp.async.bulk) that completes on an mbarrier; g and the coordinates are
// double-buffered, so the next tile's arrive while the block gathers this
// one, and one __syncthreads a tile orders every buffer. A tile's parts
// are K3's, 8 features of one level of one sample, level-major (a warp's
// lanes on 16 consecutive samples at one level, the two parts of a level
// on neighbouring lanes, so that they read each 32-byte row whole and
// samples in ray order meet on few cache lines), each thread keeping one
// sample and part and walking over the levels of its group of threads (2
// of 8 for the base field). factor_grid::part8_dot forms a part's three
// sums, f = r0 + w (r1 - r0) sharing the difference with the slope, and
// the slope factor s applied once to each sum, so an axis at a knot of
// every level gives exactly 0. Levels 0 to 3 (23 KB of the base field's
// tables) are read from a copy in shared memory made once per block, which
// leaves L1 to the finer levels. The threads that hold one sample's parts
// reduce their three sums (shuffles between the two parts of a level,
// shared memory between the groups), and the tile writes one [32, 3]
// block. On the H100 this is faster than the first design (one thread per
// (sample, level) item) at every layout; tiles of 64 samples (two blocks
// an SM), rows of g padded against bank conflicts (one bulk copy a row),
// plain 16-byte loads of g from device memory, and samples on consecutive
// lanes at one part were slower (PERF.md).
//
// K6's coords half reads what K5 reads, plus ct [N, 3], and writes [N, 3]:
// it is K5's tile loop with each tile's ct staged beside its coordinates
// and a part's sums those of G_hat (factor_grid::part8_dot_ct) under the
// same knot rule. The tile loop, and what sharing it bought, is described
// in grad_dot_tiles.cuh; K4's coords half (fused_factor_encode.cu) runs on
// it too.
//
// K6's tables half is K2's scatter (fused_factor_density_bwd.cu), as K4's:
// one thread per sample and the levels in a loop, so a warp's lanes are 32
// consecutive samples, which a train step lays out ray by ray (48 a ray),
// and at the coarse levels fall on one or two runs of the same row. Per
// level and axis each lane forms its two rows' values, (1 - w) G_hat -
// s G_dhat and w G_hat + s G_dhat, factor_grid::scatter_two_rows sums them
// over each run of lanes on one row with shuffles (warp_run_sum) and the
// run's first lane adds the sums into device memory with 16-byte vector
// reductions (red_add_row, resolved in L2). No shared memory and no scalar
// atomics (the first design's shared f32 atomicAdd was a compare-and-swap
// loop on sm_90a, on which a ray's lanes serialized). A thread reads its
// sample's g row of each level and writes its grad_g row (64 bytes each,
// two whole sectors) at a 512-byte stride from its neighbours'. A thread
// holds fa[3][F], da[3][F], g[F] and the two rows' values v[2 F] of one
// level: ptxas gives the base field's kernel 194 registers and no spills
// (two 4-warp blocks an SM), so it takes K2's mapping, one code shape for
// K2, K4 and K6, over a warp per level (32 samples of one level a warp).
//
// Determinism: K5 and the coords half are deterministic; the tables
// half's line grads are reproducible to f32 rounding only (the L2
// reductions add in an order that changes from run to run); grad_g is
// deterministic.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (signerf_tpu_torch/ops/fused_factor_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "factor_grid_common.cuh"
#include "grad_dot_tiles.cuh"

namespace {

using factor_grid::interp;
using factor_grid::Schedule;

constexpr int kThreads = 128;  // K6's tables half

// K5 (see the header; ct unused).
template <int F, int L, int kMinBlocks = factor_grid::dot_min_blocks<F, L>()>
__global__ void __launch_bounds__(factor_grid::kDotThreads, kMinBlocks)
grad_dot_kernel(const float* __restrict__ coords, const float* __restrict__ grad, const float* __restrict__ ct,
                int n, const __nv_bfloat16* __restrict__ tables, Schedule s, int n_shared, int shared_elems,
                float* __restrict__ out) {  // [N, 3]
  factor_grid::grad_dot_tiles<F, L, false>(coords, grad, nullptr, n, tables, s, n_shared, shared_elems, out);
}

// K6's coords half: K5's tiles, with ct staged beside the coordinates.
template <int F, int L, int kMinBlocks = factor_grid::dot_min_blocks<F, L>()>
__global__ void __launch_bounds__(factor_grid::kDotThreads, kMinBlocks)
grad_dot_bwd_coords_kernel(const float* __restrict__ coords, const float* __restrict__ grad,
                           const float* __restrict__ ct, int n, const __nv_bfloat16* __restrict__ tables, Schedule s,
                           int n_shared, int shared_elems, float* __restrict__ g_coords) {  // [N, 3]
  factor_grid::grad_dot_tiles<F, L, true>(coords, grad, ct, n, tables, s, n_shared, shared_elems, g_coords);
}

// K6's tables half and grad_g: one thread per sample, the levels in a loop
// (K2's mapping, see the header); every level's line grads through
// scatter_two_rows.
template <int F, int L>
__global__ void __launch_bounds__(kThreads)
grad_dot_bwd_tables_kernel(const float* __restrict__ coords, const float* __restrict__ grad,
                           const float* __restrict__ ct, int n, const __nv_bfloat16* __restrict__ tables,
                           Schedule s,
                           float* __restrict__ g_tables,  // packed like `tables`
                           float* __restrict__ g_g) {     // [N, L F]
  const int64_t sample = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool valid = sample < n;
  // Past the last sample: u = 0, ct = 0 and row -1 (every lane scatters).
  float u[3], cv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    u[a] = valid ? fminf(fmaxf(coords[sample * 3 + a], 0.f), 1.f) : 0.f;
    cv[a] = valid ? ct[sample * 3 + a] : 0.f;
  }
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    float fa[3][F], da[3][F], wa[3], sa[3], gv[F];
    int ia[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      interp<F, true>(tables + s.offset[l][a], u[a], s.res[l], ia[a], wa[a], sa[a], fa[a], da[a]);
    const int64_t item = sample * L + l;
    if (valid) {
      factor_grid::load_row_f32<F>(grad + item * F, gv);
      float4* out = reinterpret_cast<float4*>(g_g + item * F);
#pragma unroll
      for (int q = 0; q < F / 4; ++q) {
        float gg[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * q + e;
          gg[e] = cv[0] * da[0][k] * fa[1][k] * fa[2][k] + cv[1] * fa[0][k] * da[1][k] * fa[2][k] +
                  cv[2] * fa[0][k] * fa[1][k] * da[2][k];
        }
        out[q] = make_float4(gg[0], gg[1], gg[2], gg[3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < F; ++k) gv[k] = 0.f;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int b = (a + 1) % 3, c = (a + 2) % 3;
      const float w = wa[a], sl = sa[a];
      float v[2 * F];  // row i's value, then row i + 1's
#pragma unroll
      for (int k = 0; k < F; ++k) {
        const float g_hat = cv[b] * gv[k] * da[b][k] * fa[c][k] + cv[c] * gv[k] * da[c][k] * fa[b][k];
        const float g_dhat = cv[a] * gv[k] * fa[b][k] * fa[c][k];
        v[k] = (1.f - w) * g_hat - sl * g_dhat;
        v[F + k] = w * g_hat + sl * g_dhat;
      }
      // g_tables comes from torch.zeros (aligned), offsets are multiples of F.
      factor_grid::scatter_two_rows<F>(g_tables + s.offset[l][a], valid ? ia[a] : -1, v);
    }
  }
}

// K5 (ct null) or K6's coords half on K5's tiles.
template <int F, int L, bool kCt>
int launch_tiles(const float* c, const float* g, const float* ct, int n, const __nv_bfloat16* t, const Schedule& s,
                 float* out, cudaStream_t stream) {
  if constexpr (kCt)
    return factor_grid::launch_dot_tiles<F, L, true>(grad_dot_bwd_coords_kernel<F, L>, c, g, ct, n, t, s, out, stream);
  return factor_grid::launch_dot_tiles<F, L, false>(grad_dot_kernel<F, L>, c, g, nullptr, n, t, s, out, stream);
}

template <int F, int L>
int launch_tables(const float* c, const float* g, const float* ct, int n, const __nv_bfloat16* t,
                  const Schedule& s, float* gt, float* gg, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  grad_dot_bwd_tables_kernel<F, L><<<blocks, kThreads, 0, stream>>>(c, g, ct, n, t, s, gt, gg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K5: writes s [N, 3] f32 from g [N, L F] f32. Returns 0 (cudaSuccess) on a
// good launch, the CUDA error code otherwise, and cudaErrorInvalidValue for
// a schedule this library does not take. `resolutions` is a host array of
// `num_levels` ints; the tables are packed level-major, then axis, each
// [R_l, feat] bf16 row-major.
extern "C" int fused_factor_grad_dot_forward(const void* coords, const void* grad, int n,
                                             const void* tables, const int* resolutions,
                                             int num_levels, int feat, void* out, void* stream) {
  Schedule s;
  if (n < 0 || !factor_grid::make_schedule(resolutions, num_levels, feat, s))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto* c = static_cast<const float*>(coords);
  const auto* g = static_cast<const float*>(grad);
  const auto* t = static_cast<const __nv_bfloat16*>(tables);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (feat == 16 && num_levels == 8) return launch_tiles<16, 8, false>(c, g, nullptr, n, t, s, o, st);  // base field
  return cudaErrorInvalidValue;
}

// K6, given g [N, L F] and ct [N, 3] f32. mode 0 ("tables"): adds the line
// grads into g_tables (packed like `tables`, f32, zeroed by the caller) and
// writes g_g [N, L F]. mode 1 ("coords"): writes g_coords [N, 3]. Returns as
// the forward does.
extern "C" int fused_factor_grad_dot_backward(const void* coords, const void* grad, const void* ct,
                                              int n, const void* tables, const int* resolutions,
                                              int num_levels, int feat, void* g_tables, void* g_g,
                                              void* g_coords, int mode, void* stream) {
  Schedule s;
  if (n < 0 || (mode != 0 && mode != 1) ||
      !factor_grid::make_schedule(resolutions, num_levels, feat, s))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto* c = static_cast<const float*>(coords);
  const auto* g = static_cast<const float*>(grad);
  const auto* k = static_cast<const float*>(ct);
  const auto* t = static_cast<const __nv_bfloat16*>(tables);
  auto* gt = static_cast<float*>(g_tables);
  auto* gg = static_cast<float*>(g_g);
  auto* gc = static_cast<float*>(g_coords);
  auto st = static_cast<cudaStream_t>(stream);
  if (feat == 16 && num_levels == 8) {  // base field
    if (mode == 0) return launch_tables<16, 8>(c, g, k, n, t, s, gt, gg, st);
    return launch_tiles<16, 8, true>(c, g, k, n, t, s, gc, st);
  }
  return cudaErrorInvalidValue;
}
