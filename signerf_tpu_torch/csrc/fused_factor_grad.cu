// The factor-grid encode's uncontracted spatial derivative (K8) and its
// backward (K9), for Hopper (sm_90a).
//
// K8 replaces the TPU kernel `fused_factor_grad_tpu` (`_fused_factor_grad_impl`)
// and K9 `fused_factor_grad_bwd_tpu` (its "tables" and "coords"
// pallas_calls) in signerf_tpu/ops/fused_factor_pallas.py. With K1's taps
// (fused_factor_density.cu), per sample n, level l and axis a (b, c the
// other two, b = a + 1, c = a + 2 mod 3),
//
//   f_a = (1 - w_a) line[i_a] + w_a line[i_a + 1],  d_a = (line[i_a + 1] - line[i_a]) s_a
//   K8:  out[n, a, l F + k] = d_a f_b f_c                           [N, 3, L F] f32
//
// where s_a = R_l - 1 off the knots and 0 at an exact knot (u (R - 1) an
// integer, u = 0 and u = 1 included): the rule of K5 and of both JAX
// versions (dhat_matrix's sign(0) = 0 and |diff| < 1). Given the
// cotangent ct [N, 3, L F] of out, K9 takes
//
//   G_hat_a  = ct_b d_b f_c + ct_c d_c f_b        (f_a's place in out_b, out_c)
//   G_dhat_a = ct_a f_b f_c                       (d_a's place in out_a)
//   tables: dline_a[i_a]     += (1 - w_a) G_hat_a - s_a G_dhat_a
//           dline_a[i_a + 1] +=       w_a G_hat_a + s_a G_dhat_a
//   coords: du_a = sum_l sum_F G_hat_a d_a
//
// The coords half is d/du_b of d_a f_b f_c: d_a d_b f_c for b != a and 0
// for b = a, since the hat is piecewise linear (its slope is piecewise
// constant). This is K5 and K6 with the contraction against g taken out:
// K8 is K5 with g = one-hot, K9 is K6 with ct_a g replaced by ct[n, a].
//
// All in f32: bf16 tables, f32 tap weights, slopes, products and sums (the
// Pallas kernels round hat, dhat and their GEMM operands to bf16; that only
// fed the TPU's matrix unit). The coords half is its own launch, made only
// when x01 needs a gradient.
//
// What bounds them on an H100, at the base field's schedule (8 levels,
// F = 16, tables of 391 KB that stay in L2): K8 writes N x 3 x 512 bytes
// (302 MB for one signerf micro-batch of 196,608 samples) and reads 12
// bytes a sample, so it is all stores; K9 reads the same 302 MB cotangent,
// and its tables half makes 2 x 3 x 8 x 16 scattered f32 additions per
// sample on top.
//
// The design is K3 and K6's (fused_factor_encode.cu, fused_factor_grad_dot.cu):
// one thread per (sample, level) item, item = n L + l, gathering two 32-byte
// rows per axis. K8 stores each axis through shared memory per warp, so a
// store instruction writes 512 contiguous bytes (one sample's D floats of
// one axis); the TPU kernel's one-hot GEMM and transposed [3D, N] layout
// stood in for a gather and are gone. K9 reads its three 64-byte cotangent
// rows per item (neighbouring lanes read neighbouring rows), sums the small
// levels' line grads (up to 48 KB) with shared-memory atomics in blocks that
// walk over tiles and flush once, the large levels' straight into device
// memory, and sums the coords half's levels with warp shuffles.
//
// Determinism: K8 and the coords half are deterministic; the tables half's
// line grads are reproducible to f32 rounding only (atomics).
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

// Row `row` of F f32 values.
template <int F>
__device__ __forceinline__ void load_f32(const float* __restrict__ src, int64_t row, float* v) {
  const float4* p = reinterpret_cast<const float4*>(src + row * F);
#pragma unroll
  for (int q = 0; q < F / 4; ++q) {
    const float4 x = p[q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

// The row of item (sample, l) for axis a in an [N, 3, L, F] array, in units
// of F floats: (sample 3 + a) L + l = item + (2 sample + a) L.
template <int L>
__device__ __forceinline__ int64_t axis_row(int64_t item, int a) {
  return item + (2 * (item / L) + a) * L;
}

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

// The warp's 32 items' F values of axis a into out [N, 3, L F]: each lane
// parks its row in `stage` (32 x (F + 4) floats), then the lanes write
// consecutive 16-byte pieces, so one sample's L rows of one axis (L F
// contiguous floats) go out together. Items at or past n_items are not
// written. Every lane of the warp must call it.
template <int F, int L>
__device__ __forceinline__ void axis_store(float* stage, const float* v, float* __restrict__ out,
                                           int64_t warp_item0, int64_t n_items, int a) {
  static_assert(F % 4 == 0, "16-byte pieces");
  constexpr int S = F + 4;
  constexpr int Q = F / 4;
  const int lane = threadIdx.x & 31;
  float4* mine = reinterpret_cast<float4*>(stage + lane * S);
#pragma unroll
  for (int q = 0; q < Q; ++q) mine[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int j = k * 32 + lane;
    const int src = j / Q;
    const int64_t item = warp_item0 + src;
    if (item < n_items) {
      reinterpret_cast<float4*>(out + axis_row<L>(item, a) * F)[j % Q] =
          reinterpret_cast<const float4*>(stage + src * S)[j % Q];
    }
  }
  __syncwarp();
}

template <int F, int L>
__global__ void __launch_bounds__(kThreads)
grad_kernel(const float* __restrict__ coords, int n, const __nv_bfloat16* __restrict__ tables,
            Schedule s, float* __restrict__ out) {  // [N, 3, L F]
  __shared__ __align__(16) float stage[kThreads / 32][32 * (F + 4)];
  const int64_t n_items = static_cast<int64_t>(n) * L;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  float fa[3][F], da[3][F], wa[3], sa[3];
  int ia[3];
  if (item < n_items) {
    interp3<F>(tables, s, static_cast<int>(item % L), coords, item / L, ia, wa, sa, fa, da);
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int k = 0; k < F; ++k) fa[a][k] = da[a][k] = 0.f;
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int b = (a + 1) % 3, c = (a + 2) % 3;
    float v[F];
#pragma unroll
    for (int k = 0; k < F; ++k) v[k] = da[a][k] * fa[b][k] * fa[c][k];
    axis_store<F, L>(stage[threadIdx.x / 32], v, out, item - (threadIdx.x & 31), n_items, a);
  }
}

template <int F, int L, bool kTables>
__global__ void __launch_bounds__(kBwdThreads)
grad_bwd_kernel(const float* __restrict__ coords, const float* __restrict__ ct, int n,
                const __nv_bfloat16* __restrict__ tables, Schedule s,
                float* __restrict__ g_tables,   // packed like `tables`
                float* __restrict__ g_coords) { // [N, 3]
  static_assert(kBwdThreads % L == 0, "a thread keeps its level across tiles");
  static_assert(32 % L == 0, "a sample's levels are neighbouring lanes of one warp");
  extern __shared__ __align__(16) float s_small[];
  const int t = threadIdx.x;
  if constexpr (kTables) {
    for (int e = t; e < s.small_elems; e += kBwdThreads) s_small[e] = 0.f;
    __syncthreads();
  }
  const int l = t % L;
  const bool small = l < s.n_small;
  const int64_t n_items = static_cast<int64_t>(n) * L;
  const int64_t num_tiles = (n_items + kBwdThreads - 1) / kBwdThreads;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t item = tile * kBwdThreads + t;
    const bool valid = item < n_items;
    const int64_t sample = item / L;
    float gu[3] = {0.f, 0.f, 0.f};
    if (valid) {
      float fa[3][F], da[3][F], wa[3], sa[3], cv[3][F];
      int ia[3];
      interp3<F>(tables, s, l, coords, sample, ia, wa, sa, fa, da);
#pragma unroll
      for (int a = 0; a < 3; ++a) load_f32<F>(ct, axis_row<L>(item, a), cv[a]);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int b = (a + 1) % 3, c = (a + 2) % 3;
        if constexpr (kTables) {
          const int off = s.offset[l][a] + ia[a] * F;
          float* dst = small ? s_small + off : g_tables + off;
          const float w = wa[a], sl = sa[a];
#pragma unroll
          for (int k = 0; k < F; ++k) {
            const float g_hat = cv[b][k] * da[b][k] * fa[c][k] + cv[c][k] * da[c][k] * fa[b][k];
            const float g_dhat = cv[a][k] * fa[b][k] * fa[c][k];
            atomicAdd(dst + k, (1.f - w) * g_hat - sl * g_dhat);
            atomicAdd(dst + F + k, w * g_hat + sl * g_dhat);
          }
        } else {
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < F; ++k) {
            const float g_hat = cv[b][k] * da[b][k] * fa[c][k] + cv[c][k] * da[c][k] * fa[b][k];
            acc = fmaf(g_hat, da[a][k], acc);
          }
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
  grad_kernel<F, L><<<blocks, kThreads, 0, stream>>>(c, n, t, s, out);
  return static_cast<int>(cudaGetLastError());
}

template <int F, int L, bool kTables>
int launch_backward(const float* c, const float* ct, int n, const __nv_bfloat16* t, const Schedule& s,
                    float* gt, float* gc, cudaStream_t stream) {
  auto kernel = grad_bwd_kernel<F, L, kTables>;
  const size_t bytes = kTables ? static_cast<size_t>(s.small_elems) * sizeof(float) : 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  if ((err = factor_grid::resident_blocks(kernel, kBwdThreads, bytes, resident)) != cudaSuccess)
    return static_cast<int>(err);
  const int64_t tiles = (static_cast<int64_t>(n) * L + kBwdThreads - 1) / kBwdThreads;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  kernel<<<grid, kBwdThreads, bytes, stream>>>(c, ct, n, t, s, gt, gc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8: writes out [N, 3, L F] f32. Returns 0 (cudaSuccess) on a good launch,
// the CUDA error code otherwise, and cudaErrorInvalidValue for a schedule
// this library does not take. `resolutions` is a host array of `num_levels`
// ints; the tables are packed level-major, then axis, each [R_l, feat] bf16
// row-major.
extern "C" int fused_factor_grad_forward(const void* coords, int n, const void* tables,
                                         const int* resolutions, int num_levels, int feat, void* out,
                                         void* stream) {
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

// K9, given ct [N, 3, L F] f32. mode 0 ("tables"): adds the line grads into
// g_tables (packed like `tables`, f32, zeroed by the caller). mode 1
// ("coords"): writes g_coords [N, 3]. Returns as the forward does.
extern "C" int fused_factor_grad_backward(const void* coords, const void* ct, int n, const void* tables,
                                          const int* resolutions, int num_levels, int feat,
                                          void* g_tables, void* g_coords, int mode, void* stream) {
  Schedule s;
  if (n < 0 || (mode != 0 && mode != 1) ||
      !factor_grid::make_schedule(resolutions, num_levels, feat, kSmallBytes, s))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const auto* c = static_cast<const float*>(coords);
  const auto* k = static_cast<const float*>(ct);
  const auto* t = static_cast<const __nv_bfloat16*>(tables);
  auto* gt = static_cast<float*>(g_tables);
  auto* gc = static_cast<float*>(g_coords);
  auto st = static_cast<cudaStream_t>(stream);
  if (feat == 16 && num_levels == 8) {  // base field
    if (mode == 0) return launch_backward<16, 8, true>(c, k, n, t, s, gt, gc, st);
    return launch_backward<16, 8, false>(c, k, n, t, s, gt, gc, st);
  }
  return cudaErrorInvalidValue;
}
