// Fused factor-grid encode + 2-layer density MLP for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_factor_density_tpu` in
// signerf_tpu/ops/fused_factor_pallas.py. Computes, for each sample n:
//
//   for level l (resolution R_l) and axis a:
//     x = u_a * (R_l - 1);  i = min(floor(x), R_l - 2);  w = x - i
//     f_a = (1 - w) * line_{l,a}[i] + w * line_{l,a}[i + 1]      (f32)
//   feat_l = f_x * f_y * f_z                                      (f32)
//   h   = relu(bf16(bf16(bf16(feat) @ W0) + b0))                  (f32 accumulation)
//   out = bf16(bf16(h @ W1) + b1)                                 -> [N, O] f32
//
// What bounds it on an H100: for the proposal fields (D = 40 -> 16 -> 1) the
// 30 dependent two-row gathers per sample and their latency; for the base
// field (D = 128 -> 64 -> 16) the 9,216 FMAs per sample while the MLP runs
// on the CUDA cores. The design: one thread per sample; each two-tap read is
// one or two 16-byte vector loads through the read-only path (all tables
// together are under 0.5 MB, so they stay in L2 and mostly in L1); the MLP
// weights sit in shared memory as f32 (exact, since they are bf16 values)
// and every thread reads the same row, so the reads broadcast; layer 0 is
// accumulated level by level, so the D features are never held at once and
// never spill. Tensor cores are left to a later version.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (signerf_tpu_torch/ops/fused_factor_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "factor_grid_common.cuh"

namespace {

using factor_grid::kMaxLevels;
using factor_grid::load_row;
using factor_grid::round_bf16;
using factor_grid::tap;

constexpr int kThreads = 128;

struct Levels {
  int res[kMaxLevels];
  int offset[kMaxLevels][3];  // element offset of each [R_l, F] table
};

template <int F, int H, int O, int L>
__global__ void __launch_bounds__(kThreads)
density_kernel(const float* __restrict__ coords, int n,
               const __nv_bfloat16* __restrict__ tables, Levels levels,
               const __nv_bfloat16* __restrict__ w0,  // [D, H]
               const __nv_bfloat16* __restrict__ b0,  // [H]
               const __nv_bfloat16* __restrict__ w1,  // [H, O]
               const __nv_bfloat16* __restrict__ b1,  // [O]
               float* __restrict__ out) {              // [N, O]
  constexpr int D = L * F;
  __shared__ __align__(16) float s_w0[D * H];
  __shared__ __align__(16) float s_w1[H * O];
  __shared__ float s_b0[H];
  __shared__ float s_b1[O];
  for (int i = threadIdx.x; i < D * H; i += kThreads) s_w0[i] = __bfloat162float(w0[i]);
  for (int i = threadIdx.x; i < H * O; i += kThreads) s_w1[i] = __bfloat162float(w1[i]);
  for (int i = threadIdx.x; i < H; i += kThreads) s_b0[i] = __bfloat162float(b0[i]);
  for (int i = threadIdx.x; i < O; i += kThreads) s_b1[i] = __bfloat162float(b1[i]);
  __syncthreads();

  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n) return;

  float u[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) u[a] = fminf(fmaxf(coords[idx * 3 + a], 0.f), 1.f);

  float acc[H];
#pragma unroll
  for (int h = 0; h < H; ++h) acc[h] = 0.f;

#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    const int res = levels.res[l];
    float feat[F];
#pragma unroll
    for (int f = 0; f < F; ++f) feat[f] = 1.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      int i;
      float w;
      tap(u[a], res, i, w);
      const __nv_bfloat16* row = tables + levels.offset[l][a] + i * F;
      float r0[F], r1[F];
      load_row<F>(row, r0);
      load_row<F>(row + F, r1);
#pragma unroll
      for (int f = 0; f < F; ++f) feat[f] *= (1.f - w) * r0[f] + w * r1[f];
    }
    // Layer 0, this level's F rows of W0: bf16 operands, f32 accumulation.
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float xf = round_bf16(feat[f]);
      const float4* wrow = reinterpret_cast<const float4*>(s_w0 + (l * F + f) * H);
#pragma unroll
      for (int q = 0; q < H / 4; ++q) {
        const float4 wv = wrow[q];
        acc[4 * q + 0] = fmaf(xf, wv.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(xf, wv.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(xf, wv.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(xf, wv.w, acc[4 * q + 3]);
      }
    }
  }

  // Layer 0 epilogue (bf16 round, bf16 bias add, ReLU), then layer 1.
  float o[O];
#pragma unroll
  for (int k = 0; k < O; ++k) o[k] = 0.f;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const float a = fmaxf(round_bf16(round_bf16(acc[h]) + s_b0[h]), 0.f);
#pragma unroll
    for (int k = 0; k < O; ++k) o[k] = fmaf(a, s_w1[h * O + k], o[k]);
  }
  float* dst = out + idx * O;
#pragma unroll
  for (int k = 0; k < O; ++k) dst[k] = round_bf16(round_bf16(o[k]) + s_b1[k]);
}

template <int F, int H, int O, int L>
void launch(const float* coords, int n, const __nv_bfloat16* tables, const Levels& levels,
            const __nv_bfloat16* w0, const __nv_bfloat16* b0, const __nv_bfloat16* w1,
            const __nv_bfloat16* b1, float* out, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  density_kernel<F, H, O, L><<<blocks, kThreads, 0, stream>>>(coords, n, tables, levels, w0,
                                                              b0, w1, b1, out);
}

}  // namespace

// Returns 0 (cudaSuccess) on a good launch, the cudaGetLastError() code on a
// failed one, and cudaErrorInvalidValue for a shape this library does not
// take. `resolutions` is a host array of `num_levels` ints; the tables are
// packed level-major, then axis, each [R_l, feat] bf16 row-major.
extern "C" int fused_factor_density_forward(const void* coords, int n, const void* tables,
                                            const int* resolutions, int num_levels, int feat,
                                            int hidden, int out_dim, const void* w0,
                                            const void* b0, const void* w1, const void* b1,
                                            void* out, void* stream) {
  if (n < 0 || num_levels < 1 || num_levels > kMaxLevels) return cudaErrorInvalidValue;
  Levels levels = {};
  int offset = 0;
  for (int l = 0; l < num_levels; ++l) {
    if (resolutions[l] < 2) return cudaErrorInvalidValue;
    levels.res[l] = resolutions[l];
    for (int a = 0; a < 3; ++a) {
      levels.offset[l][a] = offset;
      offset += resolutions[l] * feat;
    }
  }
  if (n == 0) return cudaSuccess;
  const auto* c = static_cast<const float*>(coords);
  const auto* t = static_cast<const __nv_bfloat16*>(tables);
  const auto* pw0 = static_cast<const __nv_bfloat16*>(w0);
  const auto* pb0 = static_cast<const __nv_bfloat16*>(b0);
  const auto* pw1 = static_cast<const __nv_bfloat16*>(w1);
  const auto* pb1 = static_cast<const __nv_bfloat16*>(b1);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (feat == 8 && hidden == 16 && out_dim == 1 && num_levels == 5) {
    launch<8, 16, 1, 5>(c, n, t, levels, pw0, pb0, pw1, pb1, o, s);  // proposal fields
  } else if (feat == 16 && hidden == 64 && out_dim == 16 && num_levels == 8) {
    launch<16, 64, 16, 8>(c, n, t, levels, pw0, pb0, pw1, pb1, o, s);  // base field
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
