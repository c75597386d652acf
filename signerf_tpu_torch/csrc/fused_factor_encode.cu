// The factor-grid CP encode (K3), its backward (K4) and the early
// dense-hat encode (K10) for Hopper (sm_90a).
//
// K3 replaces the TPU kernel `fused_factor_encode_tpu` and K4
// `fused_factor_encode_bwd_tpu` (its "tables" and "coords" pallas_calls) in
// signerf_tpu/ops/fused_factor_pallas.py. With F features per level and
// K1's taps (fused_factor_density.cu), for each sample n and level l:
//
//   K3:  f_a  = (1 - w_a) line_{l,a}[i_a] + w_a line_{l,a}[i_a + 1]    (f32, each product rounded)
//        feat[n, l F : (l + 1) F] = (f_x f_y) f_z                       (f32)
//   K4, given g = d loss / d feat [N, L F] f32, for axis a and the other
//   axes b, c:
//        G_a = g_l f_b f_c                                               (f32)
//        tables: dline_{l,a}[i_a] += (1 - w_a) G_a, [i_a + 1] += w_a G_a
//        coords: du_a += sum_l sum_F G_a d_a,  d_a = (line[i + 1] - line[i]) s
//
// with s = R_l - 1 off the knots and 0 at an exact knot (u (R - 1) an
// integer): the Pallas kernel's rule, and the rule of K5 and K6. (K2's
// coords half takes the slope of the cell K1 reads instead.) All sums f32.
//
// What bounds them on an H100, at the base field's schedule (8 levels,
// F = 16, tables of 391 KB that stay in L2): K3 writes N x 512 bytes (about
// 100 MB for one signerf micro-batch of 196,608 samples) and reads little,
// so the write is the bound; K4's tables half reads g (the same 100 MB) and
// makes 2 x 3 x 8 x 16 scattered f32 additions per sample, which bound it
// unless runs of lanes share them; K4's coords half is a read of g.
//
// The design of K3 (and K10): persistent blocks of 256 threads walk over
// tiles of 64 samples (the proposal schedule's K10: 128 threads, 128
// samples). The shared encode routine (factor_grid::encode_tile, as K1
// takes it) gathers a tile's features into an f32 stage [64][L F] in shared
// memory, 8 features a part, level-major (a warp's lanes on consecutive
// samples at one level, so that samples in ray order and the coarse levels
// meet on few cache lines). The stage's rows are the output's rows, so one
// bulk copy by the Tensor Memory Accelerator (cp.async.bulk, 32 KB for a
// full base-field tile) writes the tile to device memory; the stage is
// double-buffered, so that store runs while the block gathers the next
// tile. Levels 0 to 3 (23 KB of the base field's tables) are read from a
// copy in shared memory made once per block, which leaves L1 to the finer
// levels: 89 KB a block, two blocks an SM. On the H100 these choices beat
// one 512-thread block an SM with 128-sample tiles at uniform and
// ray-ordered coordinates, and the shared levels cost nothing ray-ordered
// (PERF.md has the times). The lerps are rounded as in K1, so K3's
// features are the plain twin's bit for bit.
//
// K4's coords half: one thread per (sample, level)
// item, item = n L + l, so a thread gathers two 32-byte rows per axis and
// reads the 64 contiguous bytes of g at item * F (four 16-byte loads);
// consecutive threads cover consecutive bytes. It sums a sample's levels
// with warp shuffles (the L items of a sample are L neighbouring lanes).
//
// K4's tables half is K2's scatter (fused_factor_density_bwd.cu): one
// thread per sample, the levels in a loop, so the lanes of a warp are 32
// consecutive samples. A train step lays its samples out ray by ray (48 a
// ray in the base field), so at the coarse levels a warp's lanes fall on
// one or two runs of the same row. Per level and axis each lane forms
// (1 - w) G and w G, factor_grid::scatter_two_rows sums them over each run
// of lanes on one row with shuffles (warp_run_sum), and the run's first
// lane adds the sums into device memory with 16-byte vector reductions
// (red_add_row, resolved in L2; the line grads, 0.8 MB for the base field,
// stay there). No shared memory and no scalar atomics: the shared f32
// atomicAdd of the first design compiled to a compare-and-swap loop on
// sm_90a, on which the lanes of a ray serialized. A thread reads its
// sample's g row of each level (64 bytes, two whole sectors) at a 512-byte
// stride from its neighbours'. ptxas gives it 125 registers (base field)
// and 72 (proposal fields), no spills, so it takes K2's mapping, one code
// shape for K2, K4 and K6, over a warp per level (32 samples of one level
// a warp).
//
// Determinism: the tables half's reductions add in an order that changes
// from run to run (f32 rounding, not bitwise); K3 and the coords half are
// deterministic.
//
// K10, the early dense-hat encode, replaces the TPU kernel
// `factor_encode_pallas` (`_forward`) in
// signerf_tpu/ops/pallas/factor_grid_kernel.py. It is K3's kernel with that
// kernel's contract in place of K1's taps: the two nonzero hat weights
// h_i = 1 - |x - i| and h_{i+1} = 1 - |x - (i + 1)| are rounded to bf16
// before their products with the bf16 rows (as the Pallas kernel feeds
// them to its matrix unit), the two products are summed in f32 (exact
// products, one rounding) and the axes multiplied in f32. Its bound is
// K3's. K10's backward is K4 (signerf_tpu_torch/ops/factor_grid_kernel.py).
//
// K3 is instantiated for the base field (F = 16, 8 levels); K10 and K4 for
// the base field and the proposal fields (F = 8, 5 levels; K4's tables half
// takes them through the same code). With 5 levels a sample's items do not
// tile a warp, so K4's coords half adds its levels with device-memory
// atomics into zeroed coords grads instead of shuffles.
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

constexpr int kThreads = 128;  // K4's tables half
constexpr int kBwdThreads = 256;

// K3 and K10: persistent blocks of enc_threads threads walk over tiles of
// enc_tile samples, with a double-buffered f32 stage of [tile][L F]; the
// tile's parts (factor_grid::encode_tile) are a whole number a thread.
constexpr int enc_threads(int f, int l) { return f * l > 64 ? 256 : 128; }
constexpr int enc_tile(int f, int l) { return f * l > 64 ? 64 : 128; }
// The coarse levels, up to kEncSharedLevels of them whose tables fit
// kEncSharedBytes (levels 0 to 3 of the base field, 23 KB), read their
// tables from a copy in shared memory staged once per block.
constexpr int kEncSharedLevels = 4;
constexpr int kEncSharedBytes = 24 * 1024;

template <int F, int L>
constexpr int encode_smem_bytes(int shared_table_bytes) {
  return 2 * enc_tile(F, L) * L * F * 4 + enc_tile(F, L) * 3 * 4 + shared_table_bytes;
}

template <int F, int L, bool kDenseHat, int kEncThreads = enc_threads(F, L), int kEncTile = enc_tile(F, L)>
__global__ void __launch_bounds__(kEncThreads, 1)
encode_kernel(const float* __restrict__ coords, int n, const __nv_bfloat16* __restrict__ tables, Schedule s,
              int n_shared, int shared_elems, float* __restrict__ out) {  // [N, L F]
  constexpr int D = L * F;
  extern __shared__ __align__(128) uint8_t smem[];
  float* stage = reinterpret_cast<float*>(smem);  // [2][kEncTile][D]
  float* s_u = stage + 2 * kEncTile * D;          // [kEncTile][3]
  __nv_bfloat16* s_tab = reinterpret_cast<__nv_bfloat16*>(s_u + kEncTile * 3);
  const int t = threadIdx.x;
  for (int i = t; i < shared_elems / 8; i += kEncThreads) factor_grid::cp_async16(s_tab + 8 * i, tables + 8 * i);
  factor_grid::cp_async_wait_all();
  const int num_tiles = (n + kEncTile - 1) / kEncTile;
  int buf = 0;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x, buf ^= 1) {
    const int64_t s0 = static_cast<int64_t>(tile) * kEncTile;
    if (t == 0) factor_grid::bulk_wait_read<1>();  // the store that last read this buffer is done reading
    factor_grid::stage_coords<kEncTile, kEncThreads>(s_u, coords, s0, n);
    __syncthreads();
    float* st = stage + buf * kEncTile * D;
    factor_grid::encode_tile<F, L, kEncTile, kEncThreads, kDenseHat, true>(
        s_u, tables, s_tab, n_shared, s, [&](int smp, int l, int h, const float (&v)[8]) {
          // The two 16-byte halves in an order that alternates with the
          // sample, so that neighbouring lanes' stores meet on fewer banks.
          float4* dst = reinterpret_cast<float4*>(st + smp * D + l * F + 8 * h);
          const float4 lo = make_float4(v[0], v[1], v[2], v[3]), hi = make_float4(v[4], v[5], v[6], v[7]);
          const int odd = smp & 1;
          dst[odd] = odd ? hi : lo;
          dst[1 - odd] = odd ? lo : hi;
        });
    factor_grid::fence_proxy_async();
    __syncthreads();  // the stage is complete (and s_u free)
    if (t == 0) {
      const int64_t rows = n - s0 < kEncTile ? n - s0 : kEncTile;
      factor_grid::bulk_store(out + s0 * D, st, static_cast<int>(rows) * D * 4);
      factor_grid::bulk_commit();
    }
  }
  if (t == 0) factor_grid::bulk_wait_all();
}

// K4's tables half: one thread per sample, the levels in a loop (K2's
// mapping, see the header); every level's line grads through
// scatter_two_rows.
template <int F, int L>
__global__ void __launch_bounds__(kThreads)
encode_bwd_tables_kernel(const float* __restrict__ coords, const float* __restrict__ grad, int n,
                         const __nv_bfloat16* __restrict__ tables, Schedule s,
                         float* __restrict__ g_tables) {  // packed like `tables`
  const int64_t sample = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool valid = sample < n;
  // Past the last sample: u = 0, g = 0 and row -1 (every lane scatters).
  float u[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) u[a] = valid ? fminf(fmaxf(coords[sample * 3 + a], 0.f), 1.f) : 0.f;
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    float fa[3][F], wa[3];
    int ia[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float sl;
      interp<F, false>(tables + s.offset[l][a], u[a], s.res[l], ia[a], wa[a], sl, fa[a], nullptr);
    }
    float gv[F];
    if (valid) {
      factor_grid::load_row_f32<F>(grad + (sample * L + l) * F, gv);
    } else {
#pragma unroll
      for (int k = 0; k < F; ++k) gv[k] = 0.f;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int b = (a + 1) % 3, c = (a + 2) % 3;
      const float w = wa[a];
      float v[2 * F];  // (1 - w) G for row i, then w G for row i + 1
#pragma unroll
      for (int k = 0; k < F; ++k) {
        const float G = gv[k] * fa[b][k] * fa[c][k];
        v[k] = (1.f - w) * G;
        v[F + k] = w * G;
      }
      // g_tables comes from torch.zeros (aligned), offsets are multiples of F.
      factor_grid::scatter_two_rows<F>(g_tables + s.offset[l][a], valid ? ia[a] : -1, v);
    }
  }
}

// K4's coords half: one thread per (sample, level) item, blocks walking
// over tiles.
template <int F, int L>
__global__ void __launch_bounds__(kBwdThreads)
encode_bwd_coords_kernel(const float* __restrict__ coords, const float* __restrict__ grad, int n,
                         const __nv_bfloat16* __restrict__ tables, Schedule s,
                         float* __restrict__ g_coords) {  // [N, 3]
  // With L | 32 a sample's L items are neighbouring lanes of one warp.
  constexpr bool kShuffle = 32 % L == 0;
  const int t = threadIdx.x;
  const int64_t n_items = static_cast<int64_t>(n) * L;
  const int64_t num_tiles = (n_items + kBwdThreads - 1) / kBwdThreads;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t item = tile * kBwdThreads + t;
    const bool valid = item < n_items;
    const int64_t sample = item / L;
    const int l = static_cast<int>(item % L);
    const int res = s.res[l];
    float gu[3] = {0.f, 0.f, 0.f};
    if (valid) {
      float fa[3][F], da[3][F], wa[3], sa[3];
      int ia[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float u = fminf(fmaxf(coords[sample * 3 + a], 0.f), 1.f);
        interp<F, true>(tables + s.offset[l][a], u, res, ia[a], wa[a], sa[a], fa[a], da[a]);
      }
      float gv[F];
      factor_grid::load_row_f32<F>(grad + item * F, gv);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int b = (a + 1) % 3, c = (a + 2) % 3;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < F; ++k) acc = fmaf(gv[k] * fa[b][k] * fa[c][k], da[a][k], acc);
        gu[a] = acc;
      }
    }
    if constexpr (kShuffle) {
#pragma unroll
      for (int a = 0; a < 3; ++a) gu[a] = factor_grid::sum_levels<L>(gu[a]);
      if (valid && l == 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a) g_coords[sample * 3 + a] = gu[a];
      }
    } else {  // g_coords zeroed by the caller
      if (valid) {
#pragma unroll
        for (int a = 0; a < 3; ++a) atomicAdd(g_coords + sample * 3 + a, gu[a]);
      }
    }
  }
}

template <int F, int L, bool kDenseHat>
int launch_forward(const float* c, int n, const __nv_bfloat16* t, const Schedule& s, float* out,
                   cudaStream_t stream) {
  auto kernel = encode_kernel<F, L, kDenseHat>;
  int n_shared = 0, shared_elems = 0;  // levels [0, n_shared) and their packed tables
  while (n_shared < kEncSharedLevels && n_shared < L &&
         (shared_elems + 3 * s.res[n_shared] * F) * 2 <= kEncSharedBytes)
    shared_elems += 3 * s.res[n_shared++] * F;
  const int smem = encode_smem_bytes<F, L>(shared_elems * 2);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  constexpr int kEncThreads = enc_threads(F, L), kEncTile = enc_tile(F, L);
  if ((err = factor_grid::resident_blocks(kernel, kEncThreads, smem, resident)) != cudaSuccess)
    return static_cast<int>(err);
  const int tiles = (n + kEncTile - 1) / kEncTile;
  kernel<<<tiles < resident ? tiles : resident, kEncThreads, smem, stream>>>(c, n, t, s, n_shared, shared_elems, out);
  return static_cast<int>(cudaGetLastError());
}

template <int F, int L>
int launch_tables(const float* c, const float* g, int n, const __nv_bfloat16* t, const Schedule& s, float* gt,
                  cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  encode_bwd_tables_kernel<F, L><<<blocks, kThreads, 0, stream>>>(c, g, n, t, s, gt);
  return static_cast<int>(cudaGetLastError());
}

template <int F, int L>
int launch_coords(const float* c, const float* g, int n, const __nv_bfloat16* t, const Schedule& s, float* gc,
                  cudaStream_t stream) {
  auto kernel = encode_bwd_coords_kernel<F, L>;
  int resident = 0;
  const cudaError_t err = factor_grid::resident_blocks(kernel, kBwdThreads, 0, resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (static_cast<int64_t>(n) * L + kBwdThreads - 1) / kBwdThreads;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  kernel<<<grid, kBwdThreads, 0, stream>>>(c, g, n, t, s, gc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3: writes feat [N, L F] f32. Returns 0 (cudaSuccess) on a good launch,
// the CUDA error code otherwise, and cudaErrorInvalidValue for a schedule
// this library does not take. `resolutions` is a host array of
// `num_levels` ints; the tables are packed level-major, then axis, each
// [R_l, feat] bf16 row-major.
extern "C" int fused_factor_encode_forward(const void* coords, int n, const void* tables,
                                           const int* resolutions, int num_levels, int feat,
                                           void* out, void* stream) {
  Schedule s;
  if (n < 0 || !factor_grid::make_schedule(resolutions, num_levels, feat, s))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto* c = static_cast<const float*>(coords);
  const auto* t = static_cast<const __nv_bfloat16*>(tables);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (feat == 16 && num_levels == 8) return launch_forward<16, 8, false>(c, n, t, s, o, st);  // base field
  return cudaErrorInvalidValue;
}

// K10: writes feat [N, L F] f32 under the dense-hat contract. Returns and
// takes as K3 does.
extern "C" int factor_dense_encode_forward(const void* coords, int n, const void* tables,
                                           const int* resolutions, int num_levels, int feat,
                                           void* out, void* stream) {
  Schedule s;
  if (n < 0 || !factor_grid::make_schedule(resolutions, num_levels, feat, s))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto* c = static_cast<const float*>(coords);
  const auto* t = static_cast<const __nv_bfloat16*>(tables);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (feat == 16 && num_levels == 8) return launch_forward<16, 8, true>(c, n, t, s, o, st);  // base field
  if (feat == 8 && num_levels == 5) return launch_forward<8, 5, true>(c, n, t, s, o, st);  // proposal fields
  return cudaErrorInvalidValue;
}

// K4, given g [N, L F] f32. mode 0 ("tables"): adds the line grads into
// g_tables (packed like `tables`, f32, zeroed by the caller). mode 1
// ("coords"): writes g_coords [N, 3] (f32, zeroed by the caller). Returns as
// the forward does.
extern "C" int fused_factor_encode_backward(const void* coords, const void* grad, int n,
                                            const void* tables, const int* resolutions,
                                            int num_levels, int feat, void* g_tables,
                                            void* g_coords, int mode, void* stream) {
  Schedule s;
  if (n < 0 || (mode != 0 && mode != 1) ||
      !factor_grid::make_schedule(resolutions, num_levels, feat, s))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto* c = static_cast<const float*>(coords);
  const auto* g = static_cast<const float*>(grad);
  const auto* t = static_cast<const __nv_bfloat16*>(tables);
  auto* gt = static_cast<float*>(g_tables);
  auto* gc = static_cast<float*>(g_coords);
  auto st = static_cast<cudaStream_t>(stream);
  if (feat == 16 && num_levels == 8) {  // base field
    if (mode == 0) return launch_tables<16, 8>(c, g, n, t, s, gt, st);
    return launch_coords<16, 8>(c, g, n, t, s, gc, st);
  }
  if (feat == 8 && num_levels == 5) {  // proposal fields (K10's backward)
    if (mode == 0) return launch_tables<8, 5>(c, g, n, t, s, gt, st);
    return launch_coords<8, 5>(c, g, n, t, s, gc, st);
  }
  return cudaErrorInvalidValue;
}
