// Helpers shared by the factor-grid kernels (K1 to K6, K8 to K10).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace factor_grid {

constexpr int kMaxLevels = 8;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One table row of F bf16 values (F * 2 bytes, a multiple of 16) -> f32.
template <int F>
__device__ __forceinline__ void load_row(const __nv_bfloat16* row, float* out) {
  const uint4* src = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int v = 0; v < F / 8; ++v) {
    const uint4 raw = __ldg(src + v);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // bf16 -> f32 is a 16-bit shift: low half first (little endian).
      out[v * 8 + 2 * k] = __uint_as_float(words[k] << 16);
      out[v * 8 + 2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
    }
  }
}

// The two taps of one level and axis: x = u * (R - 1), i = min(floor(x),
// R - 2), w = x - i, so u = 1 exactly reads the last row with w = 1. x is
// rounded before the subtraction (no FMA contraction), as the plain twins
// and the JAX versions take it, so an exact knot gives w = 0 exactly.
__device__ __forceinline__ void tap(float u, int res, int& i, float& w) {
  const float x = __fmul_rn(u, static_cast<float>(res - 1));
  i = max(0, min(static_cast<int>(floorf(x)), res - 2));
  w = x - static_cast<float>(i);
}

// The slope factor of the derivative d f / d u = (line[i + 1] - line[i]) * s
// under the knot rule of both JAX versions (dhat_matrix and the Pallas
// taps): s = 0 where u * (R - 1) is an integer (w = 0, or w = 1 at u = 1),
// s = R - 1 elsewhere.
__device__ __forceinline__ float slope_scale(float w, int res) {
  return (w == 0.f || w == 1.f) ? 0.f : static_cast<float>(res - 1);
}

// One level and axis of one sample: K1's taps, the interpolated value f
// and the slope d = d f / d u under the knot rule (only when kSlope).
template <int F, bool kSlope>
__device__ __forceinline__ void interp(const __nv_bfloat16* __restrict__ line, float u, int res,
                                       int& i, float& w, float& s, float* f, float* d) {
  tap(u, res, i, w);
  s = slope_scale(w, res);
  float r0[F], r1[F];
  load_row<F>(line + i * F, r0);
  load_row<F>(line + (i + 1) * F, r1);
#pragma unroll
  for (int k = 0; k < F; ++k) {
    f[k] = (1.f - w) * r0[k] + w * r1[k];
    if constexpr (kSlope) d[k] = (r1[k] - r0[k]) * s;
  }
}

// The packed tables' level schedule: resolutions and the element offset of
// each [R_l, F] table (level-major, then axis), and the prefix of levels
// whose line grads fit `small_bytes` of shared memory.
struct Schedule {
  int res[kMaxLevels];
  int offset[kMaxLevels][3];
  int n_small;      // levels [0, n_small) accumulate in shared memory
  int small_elems;  // their element count: a prefix of the packed grads
};

inline bool make_schedule(const int* resolutions, int num_levels, int feat, int small_bytes,
                          Schedule& s) {
  if (num_levels < 1 || num_levels > kMaxLevels) return false;
  s = {};
  int offset = 0;
  bool small = true;
  for (int l = 0; l < num_levels; ++l) {
    if (resolutions[l] < 2) return false;
    s.res[l] = resolutions[l];
    for (int a = 0; a < 3; ++a) {
      s.offset[l][a] = offset;
      offset += resolutions[l] * feat;
    }
    const int elems = 3 * resolutions[l] * feat;
    if (small && (s.small_elems + elems) * static_cast<int>(sizeof(float)) <= small_bytes) {
      s.small_elems += elems;
      s.n_small = l + 1;
    } else {
      small = false;
    }
  }
  return true;
}

// Work items are (sample, level) pairs, item = sample * L + level, one per
// thread, so the F values of an item sit at out[item * F] of an [N, L * F]
// row-major output and a warp's 32 items cover one contiguous span. The
// warp stores that span cooperatively: each lane parks its F values in
// `stage` (32 x (F + 4) floats of shared memory, rows padded so that the
// quarter-warps' 16-byte stores hit distinct banks), then every lane
// writes consecutive 16-byte pieces of the span, so each store
// instruction covers 512 contiguous bytes. Items at or past `n_items` are
// not written. Every lane of the warp must call it.
template <int F>
__device__ __forceinline__ void warp_store(float* stage, const float* v, float* __restrict__ out,
                                           int64_t warp_item0, int64_t n_items) {
  static_assert(F % 4 == 0, "16-byte pieces");
  constexpr int S = F + 4;
  constexpr int Q = F / 4;
  const int lane = threadIdx.x & 31;
  float4* mine = reinterpret_cast<float4*>(stage + lane * S);
#pragma unroll
  for (int q = 0; q < Q; ++q) mine[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  __syncwarp();
  float4* dst = reinterpret_cast<float4*>(out + warp_item0 * F);
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int j = k * 32 + lane;
    const int src = j / Q;
    if (warp_item0 + src < n_items) dst[j] = reinterpret_cast<const float4*>(stage + src * S)[j % Q];
  }
  __syncwarp();
}

// Sum over the L consecutive lanes that hold one sample's levels.
template <int L>
__device__ __forceinline__ float sum_levels(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Resident blocks of `kernel` on this device (at least one), for kernels
// whose blocks walk over tiles so that their shared-memory sums reach
// device memory once per block.
template <typename Kernel>
inline cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem_bytes, int& blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem_bytes)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  blocks = per_sm * sms;
  return cudaSuccess;
}

}  // namespace factor_grid
