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
// K6's coords half: one thread per (sample, level) item, item = n L + l,
// reading its 64 contiguous bytes of g; a sample's L items are
// neighbouring lanes, summed with warp shuffles (no atomics).
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

namespace {

using factor_grid::interp;
using factor_grid::Schedule;

constexpr int kThreads = 128;  // K6's tables half
constexpr int kBwdThreads = 256;
// K5: persistent blocks of kDotThreads threads, tiles of kDotTile samples;
// the coarse levels, up to kDotSharedLevels of them whose tables fit
// kDotSharedBytes (levels 0 to 3 of the base field, 23 KB), read their
// tables from a copy in shared memory.
constexpr int kDotThreads = 256;
constexpr int kDotTile = 32;
constexpr int kDotSharedLevels = 4;
constexpr int kDotSharedBytes = 24 * 1024;

template <int F>
__device__ __forceinline__ void interp3(const __nv_bfloat16* __restrict__ tables, const Schedule& s,
                                        int l, const float* __restrict__ coords, int64_t sample,
                                        int* ia, float* wa, float* sa, float (*fa)[F], float (*da)[F]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float u = fminf(fmaxf(coords[sample * 3 + a], 0.f), 1.f);
    interp<F, true>(tables + s.offset[l][a], u, s.res[l], ia[a], wa[a], sa[a], fa[a], da[a]);
  }
}

// K5: persistent blocks of kDotThreads threads walk over tiles of kDotTile
// samples (see the header). Shared memory: g [2][kDotTile][L F] f32, the
// tiles' coordinates [2][kDotTile][3], the groups' sums
// [2][G][kDotTile][3], two mbarriers, each level's resolution and three
// table offsets [L][4] (read with a level index that differs between
// warps, the schedule would otherwise be copied to local memory), then the
// coarse levels' tables (shared_elems bf16, levels [0, n_shared)). Each
// buffer serves every other tile, so one __syncthreads a tile orders them
// all.
template <int F>
__host__ __device__ constexpr int dot_groups() { return kDotThreads / (kDotTile * (F / 8)); }

template <int F, int L>
constexpr int dot_smem_bytes(int shared_table_bytes) {
  return (2 * kDotTile * L * F + 2 * kDotTile * 3 + 2 * dot_groups<F>() * kDotTile * 3) * 4 + 2 * 8 + L * 16 +
         shared_table_bytes;
}

// Tile `tile` of g [N, L F] into `dst`, completing on `bar` (one thread).
template <int D>
__device__ __forceinline__ void load_g_tile(float* dst, const float* __restrict__ grad, int tile, int n,
                                            uint64_t* bar) {
  const int64_t s0 = static_cast<int64_t>(tile) * kDotTile;
  const int rows = n - s0 < kDotTile ? static_cast<int>(n - s0) : kDotTile;
  const uint32_t bytes = static_cast<uint32_t>(rows) * D * 4;
  factor_grid::mbar_expect_tx(bar, bytes);
  factor_grid::bulk_load(dst, grad + s0 * D, bytes, bar);
}

template <int F, int L>
__global__ void __launch_bounds__(kDotThreads, 3)
grad_dot_kernel(const float* __restrict__ coords, const float* __restrict__ grad, int n,
                const __nv_bfloat16* __restrict__ tables, Schedule s, int n_shared, int shared_elems,
                float* __restrict__ out) {  // [N, 3]
  constexpr int D = L * F;
  constexpr int P = F / 8;            // parts of a level
  constexpr int G = dot_groups<F>();  // groups of threads, each on every G-th level
  static_assert(F % 8 == 0 && G * kDotTile * P == kDotThreads && L % G == 0, "a whole number of levels a thread");
  static_assert(kDotTile * 3 <= kDotThreads, "a thread a coordinate");
  extern __shared__ __align__(128) uint8_t smem[];
  float* s_g = reinterpret_cast<float*>(smem);  // [2][kDotTile][D]
  float* s_u = s_g + 2 * kDotTile * D;          // [2][kDotTile][3]
  float* s_sum = s_u + 2 * kDotTile * 3;        // [2][G][kDotTile][3]
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_sum + 2 * G * kDotTile * 3);  // [2]
  int* s_lv = reinterpret_cast<int*>(bar + 2);  // [L][4]
  __nv_bfloat16* s_tab = reinterpret_cast<__nv_bfloat16*>(s_lv + 4 * L);
  const int t = threadIdx.x;
  const int h = t % P, smp = t / P % kDotTile, grp = t / (kDotTile * P);
  const int num_tiles = (n + kDotTile - 1) / kDotTile;
  for (int i = t; i < shared_elems / 8; i += kDotThreads) factor_grid::cp_async16(s_tab + 8 * i, tables + 8 * i);
  if (t == 0) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      s_lv[4 * l] = s.res[l];
      s_lv[4 * l + 1] = s.offset[l][0];
      s_lv[4 * l + 2] = s.offset[l][1];
      s_lv[4 * l + 3] = s.offset[l][2];
    }
    factor_grid::mbar_init(bar, 1);
    factor_grid::mbar_init(bar + 1, 1);
    factor_grid::fence_mbar_init();
    load_g_tile<D>(s_g, grad, blockIdx.x, n, bar);  // the grid has at most num_tiles blocks
  }
  factor_grid::stage_coords<kDotTile, kDotThreads>(s_u, coords, static_cast<int64_t>(blockIdx.x) * kDotTile, n);
  factor_grid::cp_async_wait_all();
  __syncthreads();  // barriers, tables and the first tile's coordinates ready
  int it = 0;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x, ++it) {
    const int buf = it & 1;
    const int next = tile + gridDim.x;
    const int64_t s0 = static_cast<int64_t>(tile) * kDotTile;
    // The next tile's g and coordinates come in while this one is gathered:
    // g into the other buffer (last read before the previous tile's
    // __syncthreads), the coordinates into a register until then.
    if (t == 0 && next < num_tiles) load_g_tile<D>(s_g + (buf ^ 1) * kDotTile * D, grad, next, n, bar + (buf ^ 1));
    const int64_t u_at = static_cast<int64_t>(next) * kDotTile * 3 + t;
    const float u_next = t < kDotTile * 3 && next < num_tiles && u_at < static_cast<int64_t>(n) * 3
                             ? fminf(fmaxf(__ldg(coords + u_at), 0.f), 1.f)
                             : 0.f;
    const float* tu = s_u + buf * kDotTile * 3 + 3 * smp;
    const float u[3] = {tu[0], tu[1], tu[2]};
    factor_grid::mbar_wait(bar + buf, (it >> 1) & 1);
    const float* g_row = s_g + (buf * kDotTile + smp) * D;
    float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < L / G; ++j) {
      const int l = j * G + grp;
      const float4* src = reinterpret_cast<const float4*>(g_row + l * F + 8 * h);
      const float4 lo = src[0], hi = src[1];
      const float gv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      // l >= j G: past the shared levels for every thread once j G is.
      const int4 lv = reinterpret_cast<const int4*>(s_lv)[l];
      if (j * G < kDotSharedLevels && l < n_shared) {
        const __nv_bfloat16* const line[3] = {s_tab + lv.y, s_tab + lv.z, s_tab + lv.w};
        factor_grid::part8_dot<F, false>(line, lv.x, 8 * h, u, gv, acc);
      } else {
        const __nv_bfloat16* const line[3] = {tables + lv.y, tables + lv.z, tables + lv.w};
        factor_grid::part8_dot<F, true>(line, lv.x, 8 * h, u, gv, acc);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int o = P / 2; o > 0; o >>= 1) acc[a] += __shfl_xor_sync(0xffffffffu, acc[a], o);
    }
    float* sums = s_sum + buf * G * kDotTile * 3;
    if (h == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) sums[(grp * kDotTile + smp) * 3 + a] = acc[a];
    }
    if (t < kDotTile * 3) s_u[(buf ^ 1) * kDotTile * 3 + t] = u_next;
    __syncthreads();  // this tile's sums and the next tile's coordinates are in
    if (t < kDotTile * 3 && s0 * 3 + t < static_cast<int64_t>(n) * 3) {
      float v = sums[t];
#pragma unroll
      for (int q = 1; q < G; ++q) v += sums[q * kDotTile * 3 + t];
      out[s0 * 3 + t] = v;
    }
  }
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

// K6's coords half: one thread per (sample, level) item, blocks walking
// over tiles; a sample's levels summed with shuffles.
template <int F, int L>
__global__ void __launch_bounds__(kBwdThreads)
grad_dot_bwd_coords_kernel(const float* __restrict__ coords, const float* __restrict__ grad,
                           const float* __restrict__ ct, int n, const __nv_bfloat16* __restrict__ tables,
                           Schedule s,
                           float* __restrict__ g_coords) {  // [N, 3]
  static_assert(kBwdThreads % L == 0, "a thread keeps its level across tiles");
  const int t = threadIdx.x;
  const int l = t % L;
  const int64_t n_items = static_cast<int64_t>(n) * L;
  const int64_t num_tiles = (n_items + kBwdThreads - 1) / kBwdThreads;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t item = tile * kBwdThreads + t;
    const bool valid = item < n_items;
    const int64_t sample = item / L;
    float fa[3][F], da[3][F], wa[3], sa[3], gv[F], cv[3] = {0.f, 0.f, 0.f};
    int ia[3];
    if (valid) {
      interp3<F>(tables, s, l, coords, sample, ia, wa, sa, fa, da);
      factor_grid::load_row_f32<F>(grad + item * F, gv);
#pragma unroll
      for (int a = 0; a < 3; ++a) cv[a] = ct[sample * 3 + a];
    }
    float gu[3] = {0.f, 0.f, 0.f};
    if (valid) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int b = (a + 1) % 3, c = (a + 2) % 3;
#pragma unroll
        for (int k = 0; k < F; ++k) {
          const float g_hat = cv[b] * gv[k] * da[b][k] * fa[c][k] + cv[c] * gv[k] * da[c][k] * fa[b][k];
          gu[a] = fmaf(g_hat, da[a][k], gu[a]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) gu[a] = factor_grid::sum_levels<L>(gu[a]);
    if (valid && l == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) g_coords[sample * 3 + a] = gu[a];
    }
  }
}

template <int F, int L>
int launch_forward(const float* c, const float* g, int n, const __nv_bfloat16* t, const Schedule& s,
                   float* out, cudaStream_t stream) {
  auto kernel = grad_dot_kernel<F, L>;
  int n_shared = 0, shared_elems = 0;  // levels [0, n_shared) and their packed tables
  while (n_shared < kDotSharedLevels && n_shared < L &&
         (shared_elems + 3 * s.res[n_shared] * F) * 2 <= kDotSharedBytes)
    shared_elems += 3 * s.res[n_shared++] * F;
  const int smem = dot_smem_bytes<F, L>(shared_elems * 2);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  if ((err = factor_grid::resident_blocks(kernel, kDotThreads, smem, resident)) != cudaSuccess)
    return static_cast<int>(err);
  const int tiles = (n + kDotTile - 1) / kDotTile;
  kernel<<<tiles < resident ? tiles : resident, kDotThreads, smem, stream>>>(c, g, n, t, s, n_shared, shared_elems,
                                                                             out);
  return static_cast<int>(cudaGetLastError());
}

template <int F, int L>
int launch_tables(const float* c, const float* g, const float* ct, int n, const __nv_bfloat16* t,
                  const Schedule& s, float* gt, float* gg, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  grad_dot_bwd_tables_kernel<F, L><<<blocks, kThreads, 0, stream>>>(c, g, ct, n, t, s, gt, gg);
  return static_cast<int>(cudaGetLastError());
}

template <int F, int L>
int launch_coords(const float* c, const float* g, const float* ct, int n, const __nv_bfloat16* t,
                  const Schedule& s, float* gc, cudaStream_t stream) {
  auto kernel = grad_dot_bwd_coords_kernel<F, L>;
  int resident = 0;
  const cudaError_t err = factor_grid::resident_blocks(kernel, kBwdThreads, 0, resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (static_cast<int64_t>(n) * L + kBwdThreads - 1) / kBwdThreads;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  kernel<<<grid, kBwdThreads, 0, stream>>>(c, g, ct, n, t, s, gc);
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
  if (feat == 16 && num_levels == 8) return launch_forward<16, 8>(c, g, n, t, s, o, st);  // base field
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
    return launch_coords<16, 8>(c, g, k, n, t, s, gc, st);
  }
  return cudaErrorInvalidValue;
}
