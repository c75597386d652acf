// Helpers shared by the factor-grid kernels (K1 forward, K2 backward).
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
// R - 2), w = x - i, so u = 1 exactly reads the last row with w = 1.
__device__ __forceinline__ void tap(float u, int res, int& i, float& w) {
  const float x = u * static_cast<float>(res - 1);
  i = max(0, min(static_cast<int>(floorf(x)), res - 2));
  w = x - static_cast<float>(i);
}

}  // namespace factor_grid
