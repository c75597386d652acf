// Backward of the fused factor-grid encode + 2-layer density MLP (K2) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_factor_density_bwd_tpu` in
// signerf_tpu/ops/fused_factor_pallas.py (body `_make_density_bwd_kernel`
// over `_make_bwd_kernel`). Given the cotangent g [N, O] of K1's output, it
// recomputes each sample's features and layer-0 output exactly as K1 does
// (fused_factor_density.cu) and takes the VJP at the Pallas kernel's
// rounding points:
//
//   g_o    = bf16(g)
//   g_h    = (W1 g_o) * 1{h > 0}                       (f32)
//   g_h_b  = bf16(g_h)
//   g_feat = bf16(W0 g_h_b)                            (f32 accumulation)
//   dW1 += g_o (x) h,  db1 += g_o,  dW0 += bf16(feat) (x) g_h_b,  db0 += g_h
//   for level l and axis a, with K1's taps (i, w) and the other axes o1, o2:
//     G_a = g_feat_l * f_o1 * f_o2                     (product rule, f32)
//     dline[i] += (1 - w) G_a,   dline[i + 1] += w G_a
//     du_a    += sum_F G_a * (line[i + 1] - line[i]) * (R - 1)
//
// Every sum is f32. The Pallas kernel rounds G (levels of res <= 64) or w G
// (larger levels) to bf16 before its GEMM; that rounding only fed the TPU's
// matrix unit, and this kernel keeps f32.
//
// Derivative at a knot: du_a is the slope of the cell K1 reads (i above),
// so at u * (R - 1) integer it is the slope of the cell to the right, and at
// u = 1 that of the last cell. (The Pallas kernel gives 0 at every knot; the
// XLA reference half the sum of both neighbours' slopes.)
//
// Two modes, two launches, as the TPU kernel has two pallas_calls: "tables"
// (line grads and dW0/db0/dW1/db1) and "coords" (du only). Training with
// camera optimisation off never asks for du, and then the coords launch is
// not made.
//
// What bounds the tables mode on an H100: per sample, 2 x 3 x L two-row
// gathers (the forward recompute and the product rule), 2 x 3 x L x F
// scattered line-grad additions, and for the base field (D = 128 -> 64 ->
// 16) about 3 x 8,192 multiply-adds of MLP VJP. The first design spent its
// time in the scatter: f32 atomicAdd into shared memory is a
// compare-and-swap loop on sm_90a (ATOMS.CAST.SPIN), a train step's samples
// lie in ray order (a warp holds 32 consecutive samples of one ray), so at
// the coarse levels the lanes of a warp add into the same few rows and
// serialize; and its 213 KB of shared memory left one 4-warp block an SM.
// This design:
//   - one thread per sample, blocks of 128 samples ("tiles"); a block walks
//     over tiles (grid = resident blocks), so dW and db reach device memory
//     once per block;
//   - the line grads: per level and axis the lanes' (1 - w) G and w G are
//     summed over each run of lanes on the same row with shuffles
//     (factor_grid::warp_run_sum), and the run's first lane adds the sums
//     into device memory with 16-byte vector reductions (float4 atomicAdd,
//     resolved in L2: F = 8 is 2 instructions a row, F = 16 is 4). All the
//     line grads sit in L2 (the base field's are 0.8 MB). Every level goes
//     this way: at ray-ordered samples a warp's lanes reach the coarse
//     levels as one or two runs. At uniform random samples every warp adds
//     into all 16 to 32 rows of the coarsest levels and their reductions
//     queue on a few L2 slices; summing those levels in shared memory would
//     win there but lose at the ray-ordered layout a train step gives
//     (PERF.md has the H100's times of both);
//   - the MLP products on the tensor cores, mma.sync.m16n8k16 bf16 x bf16
//     -> f32 over each tile: the layer-0 recompute bf16(feat) W0, g_h =
//     g_o W1^T, dW1 += h^T g_o, dW0 += bf16(feat)^T g_h_b and g_feat =
//     g_h_b W0^T. Every operand is an exact bf16 value (W0, W1, bf16(feat),
//     g_o, the bf16-rounded h, g_h_b), so every product is exact in f32 and
//     only the order of the sums changes. db0 and db1 stay f32 sums; dW0
//     and dW1 take each tile's products from the tensor cores and sum them
//     over the block's tiles in f32 registers, so no long sum stays in the
//     tensor cores' accumulator (their adds do not round to nearest);
//   - shared memory holds bf16 tiles: W0, W1, bf16(feat) (then g_feat), h,
//     g_h_b and g_o, rows padded by 16 bytes so that ldmatrix and the
//     fragment stores hit distinct banks: ~101 KB for the base field (two
//     blocks, 8 warps an SM), ~36 KB for the proposal fields (four blocks,
//     16 warps, as their registers allow);
//   - the features are K1's taps and products with every lerp rounded as the
//     plain twin rounds it (no FMA contraction), so bf16(feat) is the
//     twin's bit for bit: a contracted lerp flips the rounding of a feature
//     for every sample of a cell at once, which shows in dW0 and dW1.
// The coords mode is the first design's (one thread per sample, f32 weights
// in shared memory, no atomics): it runs only with camera optimisation.
//
// Determinism: the vector reductions and the per-block dW/db flushes add in
// an order that changes from run to run, so line grads and dW/db are
// reproducible to f32 rounding only, not bitwise. The coords mode is
// deterministic.
//
// Built with nvcc into a shared library with a plain C interface and bound
// with ctypes (signerf_tpu_torch/ops/fused_factor_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "factor_grid_common.cuh"

namespace {

using factor_grid::lerp;
using factor_grid::load_a;
using factor_grid::load_a_t;
using factor_grid::load_b_kn;
using factor_grid::load_b_nk;
using factor_grid::load_row;
using factor_grid::mma;
using factor_grid::pack_bf16;
using factor_grid::red_add_row;
using factor_grid::round_bf16;
using factor_grid::Schedule;
using factor_grid::tap;
using factor_grid::warp_run_sum;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // samples per tile, one thread each
constexpr int kWarps = kThreads / 32;

constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// The largest D x H whose layer 0 is recomputed per sample on f32 FMAs
// (the proposal fields' 640) rather than on the MMA (the base field's 8,192).
constexpr int kRowForwardMax = 1024;

// ---------------------------------------------------------------------------
// Tables mode.

// Dynamic shared memory of the tables mode, in bytes. bf16 tiles with rows
// padded by 8 values (16 bytes); D and O rounded up to the MMA's k = 16
// with zeros.
template <int F, int H, int O, int L>
struct TablesLayout {
  static constexpr int D = L * F, DP = round16(D), OP = round16(O);
  static constexpr int XS = DP + 8, HS = H + 8, OS = OP + 8;  // row strides, in values
  static constexpr int kW0 = 0;                              // W0 [DP][HS]
  static constexpr int kW1 = kW0 + DP * HS * 2;              // W1 [H][OS]
  static constexpr int kB0 = kW1 + H * OS * 2;               // b0 [H] f32
  static constexpr int kDb0 = kB0 + H * 4;                   // per-warp db0 sums [kWarps][H] f32
  static constexpr int kX = kDb0 + kWarps * H * 4;           // bf16(feat), then g_feat [T][XS]
  static constexpr int kH = kX + kThreads * XS * 2;          // bf16 h [T][HS]
  static constexpr int kGh = kH + kThreads * HS * 2;         // g_h_b [T][HS]
  static constexpr int kGo = kGh + kThreads * HS * 2;        // g_o [T][OS]
  static constexpr int kBytes = kGo + kThreads * OS * 2;
  static_assert(kX % 16 == 0 && kBytes % 16 == 0, "16-byte aligned tiles");
};

template <int F, int H, int O, int L, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
density_bwd_tables_kernel(const float* __restrict__ coords, const float* __restrict__ grad_out, int n,
                          const bf16* __restrict__ tables, Schedule lv,
                          const bf16* __restrict__ w0,  // [D, H]
                          const bf16* __restrict__ b0,  // [H]
                          const bf16* __restrict__ w1,  // [H, O]
                          float* __restrict__ g_tables,  // packed like `tables`
                          float* __restrict__ g_w0, float* __restrict__ g_b0, float* __restrict__ g_w1,
                          float* __restrict__ g_b1) {
  using Lay = TablesLayout<F, H, O, L>;
  constexpr int D = Lay::D, DP = Lay::DP, OP = Lay::OP, XS = Lay::XS, HS = Lay::HS, OS = Lay::OS;
  // dW0 [DP x H]: warp w owns the m-tiles w, w + 4, .. of 16 rows, all H / 8 n-tiles.
  constexpr int kW0Tiles = DP / 16, kMyW0 = (kW0Tiles + kWarps - 1) / kWarps;
  // dW1 [H x O]: m-tiles of 16 hidden rows, n-tiles of 8 outputs.
  constexpr int kW1Tiles = H / 16, kMyW1 = (kW1Tiles + kWarps - 1) / kWarps, kW1N = (O + 7) / 8;
  static_assert(H % 16 == 0 && F % 8 == 0, "MMA tiles and 16-byte table rows");
  // A small layer 0 (the proposal fields: D H = 640) is recomputed per
  // sample with f32 FMAs, which round to nearest; the tensor cores' adds do
  // not, flip more bf16 roundings of h, and with H = 16, O = 1 each flip
  // shows in dW1 (PERF.md has both errors). The base field's layer 0
  // (8,192 multiply-adds a sample) runs on the MMA.
  constexpr bool kRowForward = D * H <= kRowForwardMax;

  extern __shared__ __align__(16) uint8_t smem[];
  bf16* s_w0 = reinterpret_cast<bf16*>(smem + Lay::kW0);
  bf16* s_w1 = reinterpret_cast<bf16*>(smem + Lay::kW1);
  float* s_b0 = reinterpret_cast<float*>(smem + Lay::kB0);
  float* s_db0 = reinterpret_cast<float*>(smem + Lay::kDb0);
  bf16* s_x = reinterpret_cast<bf16*>(smem + Lay::kX);
  bf16* s_h = reinterpret_cast<bf16*>(smem + Lay::kH);
  bf16* s_gh = reinterpret_cast<bf16*>(smem + Lay::kGh);
  bf16* s_go = reinterpret_cast<bf16*>(smem + Lay::kGo);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair

  // Weights (zero in the padding), zeroed sums and tiles: the padding
  // columns of X and g_o stay zero for good.
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = t; i < DP * HS; i += kThreads) {
    const int r = i / HS, c = i % HS;
    s_w0[i] = r < D && c < H ? w0[r * H + c] : zero;
  }
  for (int i = t; i < H * OS; i += kThreads) {
    const int r = i / OS, c = i % OS;
    s_w1[i] = c < O ? w1[r * O + c] : zero;
  }
  for (int i = t; i < H; i += kThreads) s_b0[i] = __bfloat162float(b0[i]);
  for (int i = t; i < kWarps * H; i += kThreads) s_db0[i] = 0.f;
  for (int i = t; i < kThreads * XS; i += kThreads) s_x[i] = zero;
  for (int i = t; i < kThreads * OS; i += kThreads) s_go[i] = zero;
  float dw0[kMyW0][H / 8][4] = {};
  float dw1[kMyW1][kW1N][4] = {};
  float db1[O] = {};
  float db0[kRowForward ? H : 1] = {};
  __syncthreads();

  const int num_tiles = (n + kThreads - 1) / kThreads;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t idx = static_cast<int64_t>(tile) * kThreads + t;
    const bool valid = idx < n;
    // Past the end: u = 0 and g = 0, so every contribution is zero.
    float u[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) u[a] = valid ? fminf(fmaxf(coords[idx * 3 + a], 0.f), 1.f) : 0.f;

    // Phase 1: K1's features, bf16-rounded, into X; g_o into its tile.
    float acc0[kRowForward ? H : 1] = {};  // layer 0 of this sample (small layer 0 only)
#pragma unroll 1
    for (int l = 0; l < L; ++l) {
      const int res = lv.res[l];
      float feat[F];
#pragma unroll
      for (int f = 0; f < F; ++f) feat[f] = 1.f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        int i;
        float w;
        tap(u[a], res, i, w);
        float r0[F], r1[F];
        load_row<F>(tables + lv.offset[l][a] + i * F, r0);
        load_row<F>(tables + lv.offset[l][a] + (i + 1) * F, r1);
#pragma unroll
        for (int f = 0; f < F; ++f) feat[f] *= lerp(r0[f], r1[f], w);
      }
      uint4* dst = reinterpret_cast<uint4*>(s_x + t * XS + l * F);
#pragma unroll
      for (int q = 0; q < F / 8; ++q) {
        const float* v = feat + 8 * q;
        dst[q] = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                            pack_bf16(v[6], v[7]));
      }
      if constexpr (kRowForward) {
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float xf = round_bf16(feat[f]);
          const uint4* wrow = reinterpret_cast<const uint4*>(s_w0 + (l * F + f) * HS);
#pragma unroll
          for (int q = 0; q < H / 8; ++q) {
            const uint4 raw = wrow[q];
            const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              acc0[8 * q + 2 * k] = fmaf(xf, __uint_as_float(words[k] << 16), acc0[8 * q + 2 * k]);
              acc0[8 * q + 2 * k + 1] = fmaf(xf, __uint_as_float(words[k] & 0xffff0000u), acc0[8 * q + 2 * k + 1]);
            }
          }
        }
      }
    }
    float go[O];
#pragma unroll
    for (int o = 0; o < O; ++o) {
      go[o] = valid ? round_bf16(grad_out[idx * O + o]) : 0.f;
      db1[o] += go[o];
      s_go[t * OS + o] = __float2bfloat16_rn(go[o]);
    }
    if constexpr (kRowForward) {
      // h = relu(bf16(bf16(acc) + b0)), g_h = (W1 g_o) 1{h > 0} (f32, into
      // db0), and bf16 h and g_h_b into this sample's rows of their tiles.
      float hv[H], gh[H];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        hv[h] = fmaxf(round_bf16(round_bf16(acc0[h]) + s_b0[h]), 0.f);
        float s = 0.f;
#pragma unroll
        for (int o = 0; o < O; ++o) s = fmaf(__bfloat162float(s_w1[h * OS + o]), go[o], s);
        gh[h] = hv[h] > 0.f ? s : 0.f;
        db0[h] += gh[h];
      }
#pragma unroll
      for (int h = 0; h < H; h += 2) {
        *reinterpret_cast<uint32_t*>(s_h + t * HS + h) = pack_bf16(hv[h], hv[h + 1]);
        *reinterpret_cast<uint32_t*>(s_gh + t * HS + h) = pack_bf16(gh[h], gh[h + 1]);
      }
    }
    __syncthreads();

    // MMA 1 (the base field), per m-tile of this warp's 32 samples: acc =
    // bf16(feat) W0 and gac = g_o W1^T; then h = relu(bf16(bf16(acc) + b0)),
    // g_h = gac 1{h > 0} (f32, summed into db0), and bf16 h and g_h_b into
    // their tiles.
    if constexpr (!kRowForward) {
#pragma unroll 1
      for (int mt = 0; mt < 2; ++mt) {
        const int m0 = warp * 32 + mt * 16;
        float acc[H / 8][4] = {}, gac[H / 8][4] = {};
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
#pragma unroll
        for (int k0 = 0; k0 < OP; k0 += 16) {
          load_a(a, s_go, OS, m0, k0, lane);
#pragma unroll
          for (int n0 = 0; n0 < H; n0 += 16) {
            load_b_nk(b, s_w1, OS, k0, n0, lane);
            mma(gac[n0 / 8], a, b[0], b[1]);
            mma(gac[n0 / 8 + 1], a, b[2], b[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < H / 8; ++nt) {
          float hv[4], gh[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = nt * 8 + 2 * t4 + (e & 1);
            hv[e] = fmaxf(round_bf16(round_bf16(acc[nt][e]) + s_b0[c]), 0.f);
            gh[e] = hv[e] > 0.f ? gac[nt][e] : 0.f;
          }
          const int c = nt * 8 + 2 * t4, r = m0 + g;
          *reinterpret_cast<uint32_t*>(s_h + r * HS + c) = pack_bf16(hv[0], hv[1]);
          *reinterpret_cast<uint32_t*>(s_h + (r + 8) * HS + c) = pack_bf16(hv[2], hv[3]);
          *reinterpret_cast<uint32_t*>(s_gh + r * HS + c) = pack_bf16(gh[0], gh[1]);
          *reinterpret_cast<uint32_t*>(s_gh + (r + 8) * HS + c) = pack_bf16(gh[2], gh[3]);
          // db0: this thread's two rows, then the 8 row groups of the warp.
          float col[2] = {gh[0] + gh[2], gh[1] + gh[3]};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            col[e] += __shfl_xor_sync(0xffffffffu, col[e], 4);
            col[e] += __shfl_xor_sync(0xffffffffu, col[e], 8);
            col[e] += __shfl_xor_sync(0xffffffffu, col[e], 16);
          }
          if (g == 0) {
            s_db0[warp * H + c] += col[0];
            s_db0[warp * H + c + 1] += col[1];
          }
        }
      }
    }
    __syncthreads();

    // MMA 2 over the tile's 128 samples: dW1 += h^T g_o, dW0 += bf16(feat)^T g_h_b.
#pragma unroll 1
    for (int k0 = 0; k0 < kThreads; k0 += 16) {
      uint32_t a[4], b[4];
#pragma unroll
      for (int j = 0; j < kMyW1; ++j) {
        const int mt = warp + j * kWarps;
        if (mt < kW1Tiles) {
          load_a_t(a, s_h, HS, mt * 16, k0, lane);
          load_b_kn(b, s_go, OS, k0, 0, lane);
          mma(dw1[j][0], a, b[0], b[1]);
          if constexpr (kW1N > 1) mma(dw1[j][1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kMyW0; ++j) {
        const int mt = warp + j * kWarps;
        if (mt < kW0Tiles) {
          load_a_t(a, s_x, XS, mt * 16, k0, lane);
#pragma unroll
          for (int n0 = 0; n0 < H; n0 += 16) {
            load_b_kn(b, s_gh, HS, k0, n0, lane);
            mma(dw0[j][n0 / 8], a, b[0], b[1]);
            mma(dw0[j][n0 / 8 + 1], a, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();

    // MMA 3: g_feat = bf16(g_h_b W0^T) over X (bf16(feat) is spent).
#pragma unroll 1
    for (int mt = 0; mt < 2; ++mt) {
      const int m0 = warp * 32 + mt * 16;
      uint32_t a[H / 16][4];
#pragma unroll
      for (int k0 = 0; k0 < H; k0 += 16) load_a(a[k0 / 16], s_gh, HS, m0, k0, lane);
#pragma unroll
      for (int n0 = 0; n0 < DP; n0 += 16) {
        float c[2][4] = {};
#pragma unroll
        for (int k0 = 0; k0 < H; k0 += 16) {
          uint32_t b[4];
          load_b_nk(b, s_w0, HS, k0, n0, lane);
          mma(c[0], a[k0 / 16], b[0], b[1]);
          mma(c[1], a[k0 / 16], b[2], b[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + j * 8 + 2 * t4, r = m0 + g;
          *reinterpret_cast<uint32_t*>(s_x + r * XS + col) = pack_bf16(c[j][0], c[j][1]);
          *reinterpret_cast<uint32_t*>(s_x + (r + 8) * XS + col) = pack_bf16(c[j][2], c[j][3]);
        }
      }
    }
    __syncthreads();

    // Phase 2, per level: the taps again, g_feat from X, the product rule,
    // and the warp-aggregated two-row scatter.
#pragma unroll 1
    for (int l = 0; l < L; ++l) {
      const int res = lv.res[l];
      float fa[3][F];
      int ia[3];
      float wa[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        tap(u[a], res, ia[a], wa[a]);
        float r0[F], r1[F];
        load_row<F>(tables + lv.offset[l][a] + ia[a] * F, r0);
        load_row<F>(tables + lv.offset[l][a] + (ia[a] + 1) * F, r1);
#pragma unroll
        for (int f = 0; f < F; ++f) fa[a][f] = lerp(r0[f], r1[f], wa[a]);
      }
      float gf[F];
      {
        const uint4* src = reinterpret_cast<const uint4*>(s_x + t * XS + l * F);
#pragma unroll
        for (int q = 0; q < F / 8; ++q) {
          const uint4 raw = src[q];
          const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            gf[8 * q + 2 * k] = __uint_as_float(words[k] << 16);
            gf[8 * q + 2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int o1 = (a + 1) % 3, o2 = (a + 2) % 3;
        const float w = wa[a];
        float v[2 * F];  // (1 - w) G for row i, then w G for row i + 1
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float G = gf[f] * fa[o1][f] * fa[o2][f];
          v[f] = (1.f - w) * G;
          v[F + f] = w * G;
        }
        if (warp_run_sum(ia[a], v)) {
          float* dst = g_tables + lv.offset[l][a] + ia[a] * F;
          red_add_row<F>(dst, v);
          red_add_row<F>(dst + F, v + F);
        }
      }
    }
    __syncthreads();  // the next tile overwrites X
  }

  // The block's one flush of dW0, dW1, db0 and db1.
#pragma unroll
  for (int j = 0; j < kMyW0; ++j) {
    const int mt = warp + j * kWarps;
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt) {
      const int c = nt * 8 + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        if (mt < kW0Tiles && r < D)
          atomicAdd(reinterpret_cast<float2*>(g_w0 + r * H + c), make_float2(dw0[j][nt][2 * h], dw0[j][nt][2 * h + 1]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMyW1; ++j) {
    const int mt = warp + j * kWarps;
#pragma unroll
    for (int nt = 0; nt < kW1N; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 16 + g + 8 * (e >> 1), c = nt * 8 + 2 * t4 + (e & 1);
        if (mt < kW1Tiles && c < O) atomicAdd(g_w1 + r * O + c, dw1[j][nt][e]);
      }
    }
  }
#pragma unroll
  for (int o = 0; o < O; ++o) {
    float s = db1[o];
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) s += __shfl_xor_sync(0xffffffffu, s, k);
    if (lane == 0) atomicAdd(g_b1 + o, s);
  }
  if constexpr (kRowForward) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float s = db0[h];
#pragma unroll
      for (int k = 16; k > 0; k >>= 1) s += __shfl_xor_sync(0xffffffffu, s, k);
      if (lane == 0) s_db0[warp * H + h] = s;
    }
  }
  __syncthreads();
  for (int c = t; c < H; c += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_db0[w * H + c];
    atomicAdd(g_b0 + c, s);
  }
}

// ---------------------------------------------------------------------------
// Coords mode: one thread per sample, W0 and W1 as f32 in shared memory.

// Row stride (floats) of the staged [kThreads, width] g_h tile.
constexpr int stride(int width) { return width == 1 ? 1 : width + 4; }
constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// Dynamic shared memory of the coords mode, in floats.
template <int F, int H, int O, int L>
struct CoordsLayout {
  static constexpr int D = L * F;
  static constexpr int HS = stride(H);
  static constexpr int kW0 = 0;                    // [D][H]
  static constexpr int kW1 = kW0 + D * H;          // [H][O]
  static constexpr int kB0 = kW1 + round4(H * O);  // [H]
  static constexpr int kGh = kB0 + round4(H);      // [T][HS] g_h
  static constexpr int kFloats = kGh + kThreads * HS;
};

// W values from registers to a 16-byte-aligned shared row.
template <int W>
__device__ __forceinline__ void store_row(float* dst, const float* v) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      reinterpret_cast<float4*>(dst)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) dst[k] = v[k];
  }
}

template <int F, int H, int O, int L>
__global__ void __launch_bounds__(kThreads)
density_bwd_coords_kernel(const float* __restrict__ coords, const float* __restrict__ grad_out, int n,
                          const bf16* __restrict__ tables, Schedule lv,
                          const bf16* __restrict__ w0,  // [D, H]
                          const bf16* __restrict__ b0,  // [H]
                          const bf16* __restrict__ w1,  // [H, O]
                          float* __restrict__ g_coords) {  // [N, 3]
  using Lay = CoordsLayout<F, H, O, L>;
  constexpr int D = Lay::D, HS = Lay::HS;
  static_assert(H % 4 == 0 && F % 8 == 0, "float4 rows and 16-byte table rows");

  extern __shared__ __align__(16) float smem_f[];
  float* s_w0 = smem_f + Lay::kW0;
  float* s_w1 = smem_f + Lay::kW1;
  float* s_b0 = smem_f + Lay::kB0;
  float* s_gh = smem_f + Lay::kGh;
  const int t = threadIdx.x;

  for (int i = t; i < D * H; i += kThreads) s_w0[i] = __bfloat162float(w0[i]);
  for (int i = t; i < H * O; i += kThreads) s_w1[i] = __bfloat162float(w1[i]);
  for (int i = t; i < H; i += kThreads) s_b0[i] = __bfloat162float(b0[i]);
  __syncthreads();

  const int num_tiles = (n + kThreads - 1) / kThreads;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t idx = static_cast<int64_t>(tile) * kThreads + t;
    if (idx >= n) continue;
    float u[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) u[a] = fminf(fmaxf(coords[idx * 3 + a], 0.f), 1.f);

    // K1's forward to the layer-0 output h, then g_h_b = bf16((W1 g_o) 1{h > 0}).
    {
      float acc[H];
#pragma unroll
      for (int h = 0; h < H; ++h) acc[h] = 0.f;
#pragma unroll 1
      for (int l = 0; l < L; ++l) {
        const int res = lv.res[l];
        float feat[F];
#pragma unroll
        for (int f = 0; f < F; ++f) feat[f] = 1.f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          int i;
          float w;
          tap(u[a], res, i, w);
          const bf16* row = tables + lv.offset[l][a] + i * F;
          float r0[F], r1[F];
          load_row<F>(row, r0);
          load_row<F>(row + F, r1);
#pragma unroll
          for (int f = 0; f < F; ++f) feat[f] *= (1.f - w) * r0[f] + w * r1[f];
        }
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
      float go[O];
#pragma unroll
      for (int o = 0; o < O; ++o) go[o] = round_bf16(grad_out[idx * O + o]);
      float gh[H];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float hv = fmaxf(round_bf16(round_bf16(acc[h]) + s_b0[h]), 0.f);
        float s = 0.f;
#pragma unroll
        for (int o = 0; o < O; ++o) s = fmaf(s_w1[h * O + o], go[o], s);
        gh[h] = hv > 0.f ? round_bf16(s) : 0.f;
      }
      store_row<H>(s_gh + t * HS, gh);
    }

    // Per level: the taps again, g_feat = bf16(W0 g_h_b), the product rule
    // and the coordinate sum.
    float gu[3] = {0.f, 0.f, 0.f};
    const float4* gh4 = reinterpret_cast<const float4*>(s_gh + t * HS);
#pragma unroll 1
    for (int l = 0; l < L; ++l) {
      const int res = lv.res[l];
      const float scale = static_cast<float>(res - 1);
      float fa[3][F], da[3][F];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        int i;
        float w;
        tap(u[a], res, i, w);
        const bf16* row = tables + lv.offset[l][a] + i * F;
        float r0[F], r1[F];
        load_row<F>(row, r0);
        load_row<F>(row + F, r1);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          fa[a][f] = (1.f - w) * r0[f] + w * r1[f];
          da[a][f] = r1[f] - r0[f];
        }
      }
      float gf[F];
#pragma unroll
      for (int f = 0; f < F; ++f) gf[f] = 0.f;
#pragma unroll
      for (int q = 0; q < H / 4; ++q) {
        const float4 g4 = gh4[q];
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float4 wv = reinterpret_cast<const float4*>(s_w0 + (l * F + f) * H)[q];
          gf[f] = fmaf(wv.x, g4.x, gf[f]);
          gf[f] = fmaf(wv.y, g4.y, gf[f]);
          gf[f] = fmaf(wv.z, g4.z, gf[f]);
          gf[f] = fmaf(wv.w, g4.w, gf[f]);
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int o1 = (a + 1) % 3, o2 = (a + 2) % 3;
        float s = 0.f;
#pragma unroll
        for (int f = 0; f < F; ++f) s = fmaf(round_bf16(gf[f]) * fa[o1][f] * fa[o2][f], da[a][f], s);
        gu[a] = fmaf(s, scale, gu[a]);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) g_coords[idx * 3 + a] = gu[a];
  }
}

// ---------------------------------------------------------------------------
// Launch.

// Blocks an SM must hold, for the register budget: two for the base field
// (its dW0 stays in 64 accumulator registers a thread), four for the
// proposal fields.
constexpr int min_blocks(int d) { return d > 64 ? 2 : 4; }

// The kernel of `mode` and its dynamic shared memory, in bytes.
template <int F, int H, int O, int L>
void pick(int mode, const void*& kernel, int& smem_bytes) {
  if (mode == 0) {
    kernel = reinterpret_cast<const void*>(density_bwd_tables_kernel<F, H, O, L, min_blocks(F * L)>);
    smem_bytes = TablesLayout<F, H, O, L>::kBytes;
  } else {
    kernel = reinterpret_cast<const void*>(density_bwd_coords_kernel<F, H, O, L>);
    smem_bytes = CoordsLayout<F, H, O, L>::kFloats * static_cast<int>(sizeof(float));
  }
}

// The kernel for (feat, hidden, out_dim, levels), or false.
bool pick_any(int feat, int hidden, int out_dim, int levels, int mode, const void*& kernel, int& smem_bytes) {
  if (feat == 8 && hidden == 16 && out_dim == 1 && levels == 5) {  // proposal fields
    pick<8, 16, 1, 5>(mode, kernel, smem_bytes);
    return true;
  }
  if (feat == 16 && hidden == 64 && out_dim == 16 && levels == 8) {  // base field
    pick<16, 64, 16, 8>(mode, kernel, smem_bytes);
    return true;
  }
  return false;
}

// Opt in to the shared memory and count the blocks an SM holds.
cudaError_t prepare(const void* kernel, int smem_bytes, int& per_sm, int& sms) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes)) != cudaSuccess)
    return err;
  return per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

}  // namespace

// mode 0 ("tables"): adds the line grads into g_tables (packed like
// `tables`, f32) and dW0 [D, H], db0 [H], dW1 [H, O], db1 [O] into g_w0 ..
// g_b1; all must be zeroed by the caller. mode 1 ("coords"): writes
// g_coords [N, 3]. Returns 0 (cudaSuccess) on a good launch, the CUDA error
// code otherwise, and cudaErrorInvalidValue for a shape this library does
// not take. `resolutions` is a host array of `num_levels` ints.
extern "C" int fused_factor_density_backward(const void* coords, const void* grad_out, int n,
                                             const void* tables, const int* resolutions,
                                             int num_levels, int feat, int hidden, int out_dim,
                                             const void* w0, const void* b0, const void* w1,
                                             void* g_tables, void* g_w0, void* g_b0, void* g_w1,
                                             void* g_b1, void* g_coords, int mode, void* stream) {
  Schedule lv;
  const void* kernel = nullptr;
  int smem_bytes = 0;
  if (n < 0 || (mode != 0 && mode != 1) ||
      !factor_grid::make_schedule(resolutions, num_levels, feat, lv) ||
      !pick_any(feat, hidden, out_dim, num_levels, mode, kernel, smem_bytes))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int per_sm = 0, sms = 0;
  cudaError_t err = prepare(kernel, smem_bytes, per_sm, sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_tiles = (n + kThreads - 1) / kThreads;
  const int grid = num_tiles < per_sm * sms ? num_tiles : per_sm * sms;
  void* args_tables[] = {&coords, &grad_out, &n, &tables, &lv, &w0, &b0, &w1, &g_tables, &g_w0, &g_b0, &g_w1, &g_b1};
  void* args_coords[] = {&coords, &grad_out, &n, &tables, &lv, &w0, &b0, &w1, &g_coords};
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(kThreads), mode == 0 ? args_tables : args_coords,
                         static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory (bytes) of `mode`'s kernel for this field and
// the blocks of it an SM holds, for reports. Returns a CUDA error code.
extern "C" int fused_factor_density_backward_occupancy(const int* resolutions, int num_levels, int feat, int hidden,
                                                       int out_dim, int mode, int* smem_bytes, int* blocks_per_sm) {
  Schedule lv;
  const void* kernel = nullptr;
  if ((mode != 0 && mode != 1) ||
      !factor_grid::make_schedule(resolutions, num_levels, feat, lv) ||
      !pick_any(feat, hidden, out_dim, num_levels, mode, kernel, *smem_bytes))
    return cudaErrorInvalidValue;
  int sms = 0;
  return static_cast<int>(prepare(kernel, *smem_bytes, *blocks_per_sm, sms));
}
