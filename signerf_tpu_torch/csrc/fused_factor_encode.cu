// The factor-grid CP encode (K3) and its backward (K4) for Hopper (sm_90a).
//
// K3 replaces the TPU kernel `fused_factor_encode_tpu` and K4
// `fused_factor_encode_bwd_tpu` (its "tables" and "coords" pallas_calls) in
// signerf_tpu/ops/fused_factor_pallas.py. With F features per level and
// K1's taps (fused_factor_density.cu), for each sample n and level l:
//
//   K3:  f_a  = (1 - w_a) line_{l,a}[i_a] + w_a line_{l,a}[i_a + 1]    (f32)
//        feat[n, l F : (l + 1) F] = f_x f_y f_z                         (f32)
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
// makes 2 x 3 x 8 x 16 scattered f32 additions per sample, and those
// atomics are its bound; K4's coords half is a read of g.
//
// The design: one thread per (sample, level) item, item = n L + l, so a
// thread gathers two 32-byte rows per axis and owns the 64 contiguous bytes
// of feat or g at item * F; consecutive threads cover consecutive bytes.
// K3 stores each warp's 2 KB span cooperatively through shared memory
// (factor_grid::warp_store), so every store instruction writes 512
// contiguous bytes. K4 reads g the same way (four 16-byte loads per
// thread). K4's tables half keeps K2's scheme: line grads of the first
// levels, as many as fit 48 KB (the base field's levels up to res 128),
// are summed with shared-memory atomics by blocks that walk over tiles and
// flush once; the larger levels add straight into device memory. Its
// coords half sums a sample's levels with warp shuffles (the L items of a
// sample are L neighbouring lanes) and has no atomics.
//
// Determinism: the tables half's atomics add in an order that changes from
// run to run (f32 rounding, not bitwise); K3 and the coords half are
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

constexpr int kThreads = 128;
constexpr int kBwdThreads = 256;
constexpr int kSmallBytes = 48 * 1024;

template <int F, int L>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const float* __restrict__ coords, int n, const __nv_bfloat16* __restrict__ tables,
              Schedule s, float* __restrict__ out) {  // [N, L F]
  __shared__ __align__(16) float stage[kThreads / 32][32 * (F + 4)];
  const int64_t n_items = static_cast<int64_t>(n) * L;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  float feat[F];
#pragma unroll
  for (int k = 0; k < F; ++k) feat[k] = 1.f;
  if (item < n_items) {
    const int64_t sample = item / L;
    const int l = static_cast<int>(item % L);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float u = fminf(fmaxf(coords[sample * 3 + a], 0.f), 1.f);
      int i;
      float w, sl, f[F];
      interp<F, false>(tables + s.offset[l][a], u, s.res[l], i, w, sl, f, nullptr);
#pragma unroll
      for (int k = 0; k < F; ++k) feat[k] *= f[k];
    }
  }
  factor_grid::warp_store<F>(stage[threadIdx.x / 32], feat, out, item - (threadIdx.x & 31), n_items);
}

template <int F, int L, bool kTables>
__global__ void __launch_bounds__(kBwdThreads)
encode_bwd_kernel(const float* __restrict__ coords, const float* __restrict__ grad, int n,
                  const __nv_bfloat16* __restrict__ tables, Schedule s,
                  float* __restrict__ g_tables,   // packed like `tables`
                  float* __restrict__ g_coords) { // [N, 3]
  static_assert(kBwdThreads % L == 0, "a thread keeps its level across tiles");
  extern __shared__ __align__(16) float s_small[];
  const int t = threadIdx.x;
  if constexpr (kTables) {
    for (int e = t; e < s.small_elems; e += kBwdThreads) s_small[e] = 0.f;
    __syncthreads();
  }
  const int l = t % L;
  const int res = s.res[l];
  const bool small = l < s.n_small;
  const int64_t n_items = static_cast<int64_t>(n) * L;
  const int64_t num_tiles = (n_items + kBwdThreads - 1) / kBwdThreads;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t item = tile * kBwdThreads + t;
    const bool valid = item < n_items;
    const int64_t sample = item / L;
    float gu[3] = {0.f, 0.f, 0.f};
    if (valid) {
      float fa[3][F], da[3][F], wa[3], sa[3];
      int ia[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float u = fminf(fmaxf(coords[sample * 3 + a], 0.f), 1.f);
        interp<F, !kTables>(tables + s.offset[l][a], u, res, ia[a], wa[a], sa[a], fa[a], da[a]);
      }
      float gv[F];
      const float4* g4 = reinterpret_cast<const float4*>(grad + item * F);
#pragma unroll
      for (int q = 0; q < F / 4; ++q) {
        const float4 v = g4[q];
        gv[4 * q] = v.x;
        gv[4 * q + 1] = v.y;
        gv[4 * q + 2] = v.z;
        gv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int b = (a + 1) % 3, c = (a + 2) % 3;
        if constexpr (kTables) {
          const int off = s.offset[l][a] + ia[a] * F;
          float* dst = small ? s_small + off : g_tables + off;
          const float w = wa[a];
#pragma unroll
          for (int k = 0; k < F; ++k) {
            const float G = gv[k] * fa[b][k] * fa[c][k];
            atomicAdd(dst + k, (1.f - w) * G);
            atomicAdd(dst + F + k, w * G);
          }
        } else {
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < F; ++k) acc = fmaf(gv[k] * fa[b][k] * fa[c][k], da[a][k], acc);
          gu[a] = acc;
        }
      }
    }
    if constexpr (!kTables) {
#pragma unroll
      for (int a = 0; a < 3; ++a) gu[a] = factor_grid::sum_levels<L>(gu[a]);
      if (valid && l == 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a) g_coords[sample * 3 + a] = gu[a];
      }
    }
  }
  if constexpr (kTables) {
    __syncthreads();
    for (int e = t; e < s.small_elems; e += kBwdThreads) atomicAdd(g_tables + e, s_small[e]);
  }
}

template <int F, int L>
int launch_forward(const float* c, int n, const __nv_bfloat16* t, const Schedule& s, float* out,
                   cudaStream_t stream) {
  const int64_t items = static_cast<int64_t>(n) * L;
  const int blocks = static_cast<int>((items + kThreads - 1) / kThreads);
  encode_kernel<F, L><<<blocks, kThreads, 0, stream>>>(c, n, t, s, out);
  return static_cast<int>(cudaGetLastError());
}

template <int F, int L, bool kTables>
int launch_backward(const float* c, const float* g, int n, const __nv_bfloat16* t,
                    const Schedule& s, float* gt, float* gc, cudaStream_t stream) {
  auto kernel = encode_bwd_kernel<F, L, kTables>;
  const size_t bytes = kTables ? static_cast<size_t>(s.small_elems) * sizeof(float) : 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  if ((err = factor_grid::resident_blocks(kernel, kBwdThreads, bytes, resident)) != cudaSuccess)
    return static_cast<int>(err);
  const int64_t tiles = (static_cast<int64_t>(n) * L + kBwdThreads - 1) / kBwdThreads;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  kernel<<<grid, kBwdThreads, bytes, stream>>>(c, g, n, t, s, gt, gc);
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
  if (n < 0 || !factor_grid::make_schedule(resolutions, num_levels, feat, kSmallBytes, s))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto* c = static_cast<const float*>(coords);
  const auto* t = static_cast<const __nv_bfloat16*>(tables);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (feat == 16 && num_levels == 8) return launch_forward<16, 8>(c, n, t, s, o, st);  // base field
  return cudaErrorInvalidValue;
}

// K4, given g [N, L F] f32. mode 0 ("tables"): adds the line grads into
// g_tables (packed like `tables`, f32, zeroed by the caller). mode 1
// ("coords"): writes g_coords [N, 3]. Returns as the forward does.
extern "C" int fused_factor_encode_backward(const void* coords, const void* grad, int n,
                                            const void* tables, const int* resolutions,
                                            int num_levels, int feat, void* g_tables,
                                            void* g_coords, int mode, void* stream) {
  Schedule s;
  if (n < 0 || (mode != 0 && mode != 1) ||
      !factor_grid::make_schedule(resolutions, num_levels, feat, kSmallBytes, s))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto* c = static_cast<const float*>(coords);
  const auto* g = static_cast<const float*>(grad);
  const auto* t = static_cast<const __nv_bfloat16*>(tables);
  auto* gt = static_cast<float*>(g_tables);
  auto* gc = static_cast<float*>(g_coords);
  auto st = static_cast<cudaStream_t>(stream);
  if (feat == 16 && num_levels == 8) {  // base field
    if (mode == 0) return launch_backward<16, 8, true>(c, g, n, t, s, gt, gc, st);
    return launch_backward<16, 8, false>(c, g, n, t, s, gt, gc, st);
  }
  return cudaErrorInvalidValue;
}
