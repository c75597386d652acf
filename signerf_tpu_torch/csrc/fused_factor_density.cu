// Fused factor-grid encode + 2-layer density MLP for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_factor_density_tpu` in
// signerf_tpu/ops/fused_factor_pallas.py. Computes, for each sample n:
//
//   for level l (resolution R_l) and axis a:
//     x = u_a * (R_l - 1);  i = min(floor(x), R_l - 2);  w = x - i
//     f_a = (1 - w) * line_{l,a}[i] + w * line_{l,a}[i + 1]      (f32, each product rounded)
//   feat_l = (f_x * f_y) * f_z                                    (f32)
//   h   = relu(bf16(bf16(bf16(feat) @ W0) + b0))                  (f32 accumulation)
//   out = bf16(bf16(h @ W1) + b1)                                 -> [N, O] f32
//
// Instantiated for the proposal fields (F, H, O, L) = (8, 16, 1, 5), D = 40,
// and the base field (16, 64, 16, 8), D = 128.
//
// What bounds it on an H100: the encode's 6 L two-row gathers a sample
// (tables under 0.5 MB, in L2 and partly in L1): the load instructions and
// the cache lines each touches; and, for the base field, 9,216 multiply-adds
// a sample of MLP, which on the CUDA cores (the first design) took more time
// than everything else. The design:
//   - persistent blocks (grid = resident blocks) walk over tiles of 128
//     samples; W0, W1 (bf16, rows padded by 16 bytes) and the biases are
//     staged into shared memory once per block;
//   - the tile's features are gathered into a bf16 tile X [128][D] in shared
//     memory by the shared encode routine (factor_grid::encode_tile, parts
//     of 8 features, level-major: a warp's lanes take consecutive samples at
//     one level). The lerps are rounded as the plain twin rounds them and
//     the products run in its order, so bf16(feat) is the twin's, and K2's
//     recompute of it, bit for bit;
//   - layer 0 runs on the tensor cores, mma.sync.m16n8k16 bf16 x bf16 -> f32
//     over ldmatrix fragments of X and W0 (D padded with zero columns to a
//     multiple of 16), each warp on 16 samples (base field) or 32; the epilogue rounds at
//     flax's points in registers (bf16(acc), + b0 in bf16, bf16, ReLU);
//   - layer 1 takes h from the accumulators as A fragments (no shared
//     memory): one more MMA for O = 16, 16 FMAs a sample and a quad shuffle
//     for O = 1; the f32 outputs go straight to device memory.
// Every product on the tensor cores is exact (bf16 operands); only the order
// of the f32 sums differs from the twin's, which can flip a bf16 rounding of
// h or of the output (the gate's tolerance).
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (signerf_tpu_torch/ops/fused_factor_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "factor_grid_common.cuh"

namespace {

using factor_grid::load_a;
using factor_grid::load_b_kn;
using factor_grid::mma;
using factor_grid::pack_bf16;
using factor_grid::round_bf16;
using factor_grid::Schedule;
using bf16 = __nv_bfloat16;

constexpr int kTile = 128;  // samples a tile

constexpr int round16(int x) { return (x + 15) / 16 * 16; }
constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// Dynamic shared memory, in bytes. bf16 tiles with rows padded by 8 values
// (16 bytes), so that ldmatrix's 8 rows hit distinct banks.
template <int F, int H, int O, int L>
struct Layout {
  static constexpr int D = L * F, DP = round16(D), XS = DP + 8, HS = H + 8, OS = O + 8;
  static constexpr bool kMmaOut = O % 16 == 0;  // layer 1 on the MMA; else O = 1 on FMAs
  static constexpr int kW0 = 0;                                          // bf16 W0 [DP][HS]
  static constexpr int kW1 = kW0 + DP * HS * 2;                          // bf16 W1 [H][OS], or f32 [H]
  static constexpr int kB0 = kW1 + (kMmaOut ? H * OS * 2 : H * 4);       // f32 b0 [H]
  static constexpr int kB1 = kB0 + H * 4;                                // f32 b1 [O]
  static constexpr int kU = kB1 + round4(O) * 4;                         // f32 coords [kTile][3]
  static constexpr int kX = kU + kTile * 3 * 4;                          // bf16 features [kTile][XS]
  static constexpr int kBytes = kX + kTile * XS * 2;
  static_assert(kMmaOut || O == 1, "layer 1 takes O = 1 or a multiple of 16");
  static_assert(kW1 % 16 == 0 && kX % 16 == 0, "16-byte aligned tiles");
};

template <int F, int H, int O, int L, int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
density_kernel(const float* __restrict__ coords, int n, const bf16* __restrict__ tables, Schedule lv,
               const bf16* __restrict__ w0,  // [D, H]
               const bf16* __restrict__ b0,  // [H]
               const bf16* __restrict__ w1,  // [H, O]
               const bf16* __restrict__ b1,  // [O]
               float* __restrict__ out) {    // [N, O]
  using Lay = Layout<F, H, O, L>;
  constexpr int D = Lay::D, DP = Lay::DP, XS = Lay::XS, HS = Lay::HS, OS = Lay::OS;
  constexpr int kWarps = kThreads / 32;
  static_assert(H % 16 == 0 && kTile % (16 * kWarps) == 0, "MMA tiles");
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* s_w0 = reinterpret_cast<bf16*>(smem + Lay::kW0);
  bf16* s_w1 = reinterpret_cast<bf16*>(smem + Lay::kW1);
  float* s_w1f = reinterpret_cast<float*>(smem + Lay::kW1);
  float* s_b0 = reinterpret_cast<float*>(smem + Lay::kB0);
  float* s_b1 = reinterpret_cast<float*>(smem + Lay::kB1);
  float* s_u = reinterpret_cast<float*>(smem + Lay::kU);
  bf16* s_x = reinterpret_cast<bf16*>(smem + Lay::kX);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair

  // Once per block: W0 (zero rows past D), W1 and the biases; X's padding
  // columns [D, DP) stay zero for good (0 x garbage could be NaN).
  for (int i = t; i < DP * (H / 8); i += kThreads) {
    const int r = i / (H / 8), c = i % (H / 8) * 8;
    if (r < D) {
      factor_grid::cp_async16(s_w0 + r * HS + c, w0 + r * H + c);
    } else {
      *reinterpret_cast<uint4*>(s_w0 + r * HS + c) = make_uint4(0, 0, 0, 0);
    }
  }
  if constexpr (Lay::kMmaOut) {
    for (int i = t; i < H * (O / 8); i += kThreads) {
      const int r = i / (O / 8), c = i % (O / 8) * 8;
      factor_grid::cp_async16(s_w1 + r * OS + c, w1 + r * O + c);
    }
  } else {
    for (int i = t; i < H; i += kThreads) s_w1f[i] = __bfloat162float(w1[i]);
  }
  for (int i = t; i < H; i += kThreads) s_b0[i] = __bfloat162float(b0[i]);
  for (int i = t; i < O; i += kThreads) s_b1[i] = __bfloat162float(b1[i]);
  if constexpr (DP > D) {
    for (int i = t; i < kTile * (DP - D); i += kThreads) s_x[i / (DP - D) * XS + D + i % (DP - D)] = __float2bfloat16_rn(0.f);
  }
  factor_grid::cp_async_wait_all();

  const int num_tiles = (n + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t s0 = static_cast<int64_t>(tile) * kTile;
    // s_u was last read before the previous tile's second barrier.
    factor_grid::stage_coords<kTile, kThreads>(s_u, coords, s0, n);
    __syncthreads();  // coordinates (and, the first time, the weights) in; X free

    factor_grid::encode_tile<F, L, kTile, kThreads, false, false>(
        s_u, tables, nullptr, 0, lv, [&](int s, int l, int h, const float (&v)[8]) {
          *reinterpret_cast<uint4*>(s_x + s * XS + l * F + 8 * h) =
              make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
        });
    __syncthreads();  // X complete

#pragma unroll 1
    for (int mt = 0; mt < kTile / 16 / kWarps; ++mt) {
      const int m0 = warp * (kTile / kWarps) + mt * 16;
      // Layer 0: acc = bf16(feat) W0 over this warp's 16 rows.
      float acc[H / 8][4] = {};
      uint32_t a[4], b[4];
#pragma unroll
      for (int k0 = 0; k0 < DP; k0 += 16) {
        load_a(a, s_x, XS, m0, k0, lane);
#pragma unroll
        for (int n0 = 0; n0 < H; n0 += 16) {
          load_b_kn(b, s_w0, HS, k0, n0, lane);
          mma(acc[n0 / 8], a, b[0], b[1]);
          mma(acc[n0 / 8 + 1], a, b[2], b[3]);
        }
      }
      // h = relu(bf16(bf16(acc) + b0)), in place: rows g and g + 8, columns
      // nt * 8 + 2 t4 + {0, 1}.
#pragma unroll
      for (int nt = 0; nt < H / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[nt][e] = fmaxf(round_bf16(round_bf16(acc[nt][e]) + s_b0[nt * 8 + 2 * t4 + (e & 1)]), 0.f);
      }
      const int64_t r0 = s0 + m0 + g, r1 = r0 + 8;
      if constexpr (Lay::kMmaOut) {
        // Layer 1: the accumulators of n-tiles 2 kk and 2 kk + 1 are the A
        // fragment of k-step kk.
        float o[O / 8][4] = {};
#pragma unroll
        for (int kk = 0; kk < H / 16; ++kk) {
          const uint32_t ha[4] = {pack_bf16(acc[2 * kk][0], acc[2 * kk][1]), pack_bf16(acc[2 * kk][2], acc[2 * kk][3]),
                                  pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]),
                                  pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3])};
#pragma unroll
          for (int n0 = 0; n0 < O; n0 += 16) {
            load_b_kn(b, s_w1, OS, kk * 16, n0, lane);
            mma(o[n0 / 8], ha, b[0], b[1]);
            mma(o[n0 / 8 + 1], ha, b[2], b[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < O / 8; ++nt) {
          const int c = nt * 8 + 2 * t4;
          const float bb0 = s_b1[c], bb1 = s_b1[c + 1];
          if (r0 < n)
            *reinterpret_cast<float2*>(out + r0 * O + c) =
                make_float2(round_bf16(round_bf16(o[nt][0]) + bb0), round_bf16(round_bf16(o[nt][1]) + bb1));
          if (r1 < n)
            *reinterpret_cast<float2*>(out + r1 * O + c) =
                make_float2(round_bf16(round_bf16(o[nt][2]) + bb0), round_bf16(round_bf16(o[nt][3]) + bb1));
        }
      } else {
        // Layer 1 for O = 1: each lane's 2 x H / 4 products, summed over the
        // quad that holds a row.
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < H / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float wv = s_w1f[nt * 8 + 2 * t4 + e];
            p0 = fmaf(acc[nt][e], wv, p0);
            p1 = fmaf(acc[nt][2 + e], wv, p1);
          }
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          p0 += __shfl_xor_sync(0xffffffffu, p0, o);
          p1 += __shfl_xor_sync(0xffffffffu, p1, o);
        }
        if (t4 == 0) {
          if (r0 < n) out[r0] = round_bf16(round_bf16(p0) + s_b1[0]);
          if (r1 < n) out[r1] = round_bf16(round_bf16(p1) + s_b1[0]);
        }
      }
    }
  }
}

// Threads a block, and blocks an SM it must hold for the register budget:
// the base field takes 8 warps a block (one m-tile each; a little faster
// than 4 warps on the H100, PERF.md), two blocks of its ~58 KB an SM; the
// proposal fields 4 warps (five parts a thread), four blocks.
constexpr int block_threads(int d) { return d > 64 ? 256 : 128; }
constexpr int min_blocks(int d) { return d > 64 ? 2 : 4; }

template <int F, int H, int O, int L>
int launch(const float* coords, int n, const bf16* tables, const Schedule& lv, const bf16* w0, const bf16* b0,
           const bf16* w1, const bf16* b1, float* out, cudaStream_t stream) {
  constexpr int kThreads = block_threads(F * L);
  auto kernel = density_kernel<F, H, O, L, kThreads, min_blocks(F * L)>;
  constexpr int smem = Layout<F, H, O, L>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  if ((err = factor_grid::resident_blocks(kernel, kThreads, smem, resident)) != cudaSuccess)
    return static_cast<int>(err);
  const int tiles = (n + kTile - 1) / kTile;
  kernel<<<tiles < resident ? tiles : resident, kThreads, smem, stream>>>(coords, n, tables, lv, w0, b0, w1, b1, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 (cudaSuccess) on a good launch, the CUDA error code otherwise,
// and cudaErrorInvalidValue for a shape this library does not take.
// `resolutions` is a host array of `num_levels` ints; the tables are packed
// level-major, then axis, each [R_l, feat] bf16 row-major; w0 and w1 must be
// 16-byte aligned.
extern "C" int fused_factor_density_forward(const void* coords, int n, const void* tables,
                                            const int* resolutions, int num_levels, int feat,
                                            int hidden, int out_dim, const void* w0,
                                            const void* b0, const void* w1, const void* b1,
                                            void* out, void* stream) {
  Schedule lv;
  if (n < 0 || !factor_grid::make_schedule(resolutions, num_levels, feat, lv)) return cudaErrorInvalidValue;
  const auto* c = static_cast<const float*>(coords);
  const auto* t = static_cast<const bf16*>(tables);
  const auto* pw0 = static_cast<const bf16*>(w0);
  const auto* pb0 = static_cast<const bf16*>(b0);
  const auto* pw1 = static_cast<const bf16*>(w1);
  const auto* pb1 = static_cast<const bf16*>(b1);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (feat == 8 && hidden == 16 && out_dim == 1 && num_levels == 5) {  // proposal fields
    return n == 0 ? cudaSuccess : launch<8, 16, 1, 5>(c, n, t, lv, pw0, pb0, pw1, pb1, o, s);
  }
  if (feat == 16 && hidden == 64 && out_dim == 16 && num_levels == 8) {  // base field
    return n == 0 ? cudaSuccess : launch<16, 64, 16, 8>(c, n, t, lv, pw0, pb0, pw1, pb1, o, s);
  }
  return cudaErrorInvalidValue;
}
