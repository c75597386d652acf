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
// What bounds it on an H100: per sample, 2 x 3 x L two-row gathers (twice:
// the forward recompute and the product rule), 2 x 3 x L x F scattered
// line-grad additions, and for the base field (D = 128 -> 64 -> 16) about
// 3 x 8,192 FMAs of MLP VJP on the CUDA cores. The design:
//   - one thread per sample, blocks of 128 samples ("tiles"); a block walks
//     over tiles (grid = resident blocks), so its reductions cross tiles in
//     shared memory and reach device memory once;
//   - W0 and W1 in shared memory as f32 (exact: bf16 values), rows read as
//     broadcast float4;
//   - the tile's h, g_o, g_h (then rounded to bf16) and bf16(feat) are staged
//     in shared memory (rows padded by 4 floats, so a quarter-warp's float4
//     stores hit distinct banks); the block's threads then form dW1 and dW0
//     by looping over the tile's samples, each thread owning its entries, so
//     no atomic touches the weights until the block's one flush;
//   - line grads of the first levels, as many as fit 48 KB (all five levels
//     of both proposal fields, the base field's levels up to res 128), are
//     summed with shared-memory atomics and flushed once per block; the
//     larger levels add straight into device memory with atomics. On
//     sm_90a a shared f32 atomicAdd is a compare-and-swap loop
//     (ATOMS.CAST.SPIN), so lanes adding into the same row serialize: this
//     scatter, not the gathers or the MLP, is what the tables half spends
//     its time on, and clustered samples make it slower.
// The base field's tables mode takes ~213 KB of dynamic shared memory (one
// block per SM), the proposals' ~85 KB.
//
// Determinism: the atomics add in an order that changes from run to run, so
// line grads and dW/db are reproducible to f32 rounding only, not bitwise.
// The coords mode has no atomics and is deterministic.
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

constexpr int kThreads = 128;            // samples per tile, one thread each
constexpr int kSmallBytes = 48 * 1024;   // shared line-grad accumulator budget

struct BwdLevels {
  int res[kMaxLevels];
  int offset[kMaxLevels][3];  // element offset of each [R_l, F] table and its grad
  int n_small;                // levels [0, n_small) accumulate in shared memory
  int small_elems;            // their element count: a prefix of the packed grads
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int round4(int x) { return (x + 3) / 4 * 4; }
// Row stride (floats) of a staged [kThreads, width] tile.
constexpr int stride(int width) { return width == 1 ? 1 : width + 4; }

// Dynamic shared memory, in floats.
template <int F, int H, int O, int L>
struct Layout {
  static constexpr int D = L * F;
  static constexpr int HS = stride(H), OS = stride(O), FS = stride(D);
  static constexpr int kW0 = 0;                                  // [D][H]
  static constexpr int kW1 = kW0 + D * H;                        // [H][O]
  static constexpr int kB0 = kW1 + round4(H * O);                // [H]
  static constexpr int kGh = kB0 + round4(H);                    // [T][HS] g_h
  static constexpr int kUnion = kGh + kThreads * HS;             // h [T][HS], g_o [T][OS]
  static constexpr int kGo = kUnion + kThreads * HS;             //   later bf16(feat) [T][FS]
  static constexpr int kDw0 = kUnion + cmax(kThreads * (HS + OS), kThreads * FS);  // [D][H]
  static constexpr int kSmall = kDw0 + D * H;                    // small-level line grads
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

template <int F, int H, int O, int L, bool kTables>
__global__ void __launch_bounds__(kThreads)
density_bwd_kernel(const float* __restrict__ coords, const float* __restrict__ grad_out, int n,
                   const __nv_bfloat16* __restrict__ tables, BwdLevels lv,
                   const __nv_bfloat16* __restrict__ w0,  // [D, H]
                   const __nv_bfloat16* __restrict__ b0,  // [H]
                   const __nv_bfloat16* __restrict__ w1,  // [H, O]
                   float* __restrict__ g_tables,          // packed like `tables`
                   float* __restrict__ g_w0, float* __restrict__ g_b0,
                   float* __restrict__ g_w1, float* __restrict__ g_b1,
                   float* __restrict__ g_coords) {        // [N, 3]
  using Lay = Layout<F, H, O, L>;
  constexpr int D = Lay::D;
  constexpr int HS = Lay::HS, OS = Lay::OS, FS = Lay::FS;
  constexpr int kW1PerThread = (H * O + kThreads - 1) / kThreads;
  constexpr int kW0PerThread = D * H / kThreads;
  static_assert(D * H % kThreads == 0, "dW0 entries must split evenly over the threads");
  static_assert(H % 4 == 0 && F % 8 == 0, "float4 rows and 16-byte table rows");

  extern __shared__ __align__(16) float smem[];
  float* s_w0 = smem + Lay::kW0;
  float* s_w1 = smem + Lay::kW1;
  float* s_b0 = smem + Lay::kB0;
  float* s_gh = smem + Lay::kGh;
  float* s_h = smem + Lay::kUnion;
  float* s_go = smem + Lay::kGo;
  float* s_feat = smem + Lay::kUnion;
  float* s_dw0 = smem + Lay::kDw0;
  float* s_small = smem + Lay::kSmall;
  const int t = threadIdx.x;

  for (int i = t; i < D * H; i += kThreads) s_w0[i] = __bfloat162float(w0[i]);
  for (int i = t; i < H * O; i += kThreads) s_w1[i] = __bfloat162float(w1[i]);
  for (int i = t; i < H; i += kThreads) s_b0[i] = __bfloat162float(b0[i]);
  if constexpr (kTables) {
    for (int i = t; i < D * H; i += kThreads) s_dw0[i] = 0.f;
    for (int i = t; i < lv.small_elems; i += kThreads) s_small[i] = 0.f;
  }
  float acc_w1[kW1PerThread];
#pragma unroll
  for (int j = 0; j < kW1PerThread; ++j) acc_w1[j] = 0.f;
  float acc_b0 = 0.f, acc_b1 = 0.f;
  __syncthreads();

  const int num_tiles = (n + kThreads - 1) / kThreads;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t idx = static_cast<int64_t>(tile) * kThreads + t;
    const bool valid = idx < n;
    // Past the end: u = 0 and g = 0, so every staged value is finite and
    // every contribution is zero (the thread still takes part in the syncs).
    float u[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) u[a] = valid ? fminf(fmaxf(coords[idx * 3 + a], 0.f), 1.f) : 0.f;

    // Phase 1: K1's forward to the layer-0 output h, then g_o and g_h.
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
          const __nv_bfloat16* row = tables + lv.offset[l][a] + i * F;
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
      for (int o = 0; o < O; ++o) go[o] = valid ? round_bf16(grad_out[idx * O + o]) : 0.f;
      float gh[H];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float hv = fmaxf(round_bf16(round_bf16(acc[h]) + s_b0[h]), 0.f);
        float s = 0.f;
#pragma unroll
        for (int o = 0; o < O; ++o) s = fmaf(s_w1[h * O + o], go[o], s);
        acc[h] = hv;
        // g_h: f32 in tables mode (db0 needs it; reduce A rounds it), bf16 now in coords mode
        gh[h] = hv > 0.f ? (kTables ? s : round_bf16(s)) : 0.f;
      }
      store_row<H>(s_gh + t * HS, gh);
      if constexpr (kTables) {
        store_row<H>(s_h + t * HS, acc);
        store_row<O>(s_go + t * OS, go);
      }
    }

    if constexpr (kTables) {
      __syncthreads();
      // Reduce A over the tile: dW1, db1, db0; then g_h -> bf16 in place.
#pragma unroll
      for (int j = 0; j < kW1PerThread; ++j) {
        const int e = t + j * kThreads;
        if (e < H * O) {
          const int k = e / O, o = e % O;
          float s = 0.f;
          for (int m = 0; m < kThreads; ++m) s = fmaf(s_go[m * OS + o], s_h[m * HS + k], s);
          acc_w1[j] += s;
        }
      }
      if (t < O) {
        float s = 0.f;
        for (int m = 0; m < kThreads; ++m) s += s_go[m * OS + t];
        acc_b1 += s;
      }
      if (t < H) {
        float s = 0.f;
        for (int m = 0; m < kThreads; ++m) {
          const float v = s_gh[m * HS + t];
          s += v;
          s_gh[m * HS + t] = round_bf16(v);
        }
        acc_b0 += s;
      }
      __syncthreads();  // h and g_o are overwritten by the feature tile below
    }

    // Phase 2: per level, the taps again, g_feat = bf16(W0 g_h_b), the
    // product rule, and the scatter (tables) or the coordinate sum (coords).
    float gu[3] = {0.f, 0.f, 0.f};
    if (kTables || valid) {
      const float4* gh4 = reinterpret_cast<const float4*>(s_gh + t * HS);
#pragma unroll 1
      for (int l = 0; l < L; ++l) {
        const int res = lv.res[l];
        const float scale = static_cast<float>(res - 1);
        float fa[3][F];
        float da[3][F];
        int ia[3];
        float wa[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          tap(u[a], res, ia[a], wa[a]);
          const __nv_bfloat16* row = tables + lv.offset[l][a] + ia[a] * F;
          float r0[F], r1[F];
          load_row<F>(row, r0);
          load_row<F>(row + F, r1);
#pragma unroll
          for (int f = 0; f < F; ++f) {
            fa[a][f] = (1.f - wa[a]) * r0[f] + wa[a] * r1[f];
            if constexpr (!kTables) da[a][f] = r1[f] - r0[f];
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
        for (int f = 0; f < F; ++f) gf[f] = round_bf16(gf[f]);
        if constexpr (kTables) {
          float fb[F];
#pragma unroll
          for (int f = 0; f < F; ++f) fb[f] = round_bf16(fa[0][f] * fa[1][f] * fa[2][f]);
          store_row<F>(s_feat + t * FS + l * F, fb);
        }
        if (!valid) continue;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int o1 = (a + 1) % 3, o2 = (a + 2) % 3;
          if constexpr (kTables) {
            const float w = wa[a];
            const int off = lv.offset[l][a] + ia[a] * F;
            if (l < lv.n_small) {
              float* dst = s_small + off;
#pragma unroll
              for (int f = 0; f < F; ++f) {
                const float G = gf[f] * fa[o1][f] * fa[o2][f];
                atomicAdd(dst + f, (1.f - w) * G);
                atomicAdd(dst + F + f, w * G);
              }
            } else {
              float* dst = g_tables + off;
#pragma unroll
              for (int f = 0; f < F; ++f) {
                const float G = gf[f] * fa[o1][f] * fa[o2][f];
                atomicAdd(dst + f, (1.f - w) * G);
                atomicAdd(dst + F + f, w * G);
              }
            }
          } else {
            float s = 0.f;
#pragma unroll
            for (int f = 0; f < F; ++f) s = fmaf(gf[f] * fa[o1][f] * fa[o2][f], da[a][f], s);
            gu[a] = fmaf(s, scale, gu[a]);
          }
        }
      }
    }

    if constexpr (kTables) {
      __syncthreads();
      // Reduce B: dW0[d][h] += sum over the tile of bf16(feat)[d] * g_h_b[h];
      // thread t owns entries [t * E, (t + 1) * E) of the [D][H] layout.
      const int e0 = t * kW0PerThread;
      float acc[kW0PerThread];
#pragma unroll
      for (int j = 0; j < kW0PerThread; ++j) acc[j] = 0.f;
      if constexpr (kW0PerThread % 4 == 0 && H % kW0PerThread == 0) {
        // One feature d, consecutive h (the base field: E = H = 64, d = t).
        const int d = e0 / H, h0 = e0 % H;
        for (int m = 0; m < kThreads; ++m) {
          const float fv = s_feat[m * FS + d];
          const float4* g4 = reinterpret_cast<const float4*>(s_gh + m * HS + h0);
#pragma unroll
          for (int q = 0; q < kW0PerThread / 4; ++q) {
            const float4 gv = g4[q];
            acc[4 * q + 0] = fmaf(fv, gv.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(fv, gv.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(fv, gv.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(fv, gv.w, acc[4 * q + 3]);
          }
        }
      } else {
        for (int m = 0; m < kThreads; ++m) {
#pragma unroll
          for (int j = 0; j < kW0PerThread; ++j) {
            const int e = e0 + j;
            acc[j] = fmaf(s_feat[m * FS + e / H], s_gh[m * HS + e % H], acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kW0PerThread; ++j) s_dw0[e0 + j] += acc[j];
      __syncthreads();  // the next tile overwrites the staged tiles
    } else if (valid) {
#pragma unroll
      for (int a = 0; a < 3; ++a) g_coords[idx * 3 + a] = gu[a];
    }
  }

  if constexpr (kTables) {
    // The block's one flush: a device-memory atomic per entry.
    __syncthreads();
    for (int i = t; i < D * H; i += kThreads) atomicAdd(g_w0 + i, s_dw0[i]);
#pragma unroll
    for (int j = 0; j < kW1PerThread; ++j) {
      const int e = t + j * kThreads;
      if (e < H * O) atomicAdd(g_w1 + e, acc_w1[j]);
    }
    if (t < H) atomicAdd(g_b0 + t, acc_b0);
    if (t < O) atomicAdd(g_b1 + t, acc_b1);
    for (int i = t; i < lv.small_elems; i += kThreads) atomicAdd(g_tables + i, s_small[i]);
  }
}

template <int F, int H, int O, int L, bool kTables>
int launch(const float* coords, const float* grad_out, int n, const __nv_bfloat16* tables,
           const BwdLevels& lv, const __nv_bfloat16* w0, const __nv_bfloat16* b0,
           const __nv_bfloat16* w1, float* g_tables, float* g_w0, float* g_b0, float* g_w1,
           float* g_b1, float* g_coords, cudaStream_t stream) {
  using Lay = Layout<F, H, O, L>;
  auto kernel = density_bwd_kernel<F, H, O, L, kTables>;
  const int floats = kTables ? Lay::kSmall + lv.small_elems : Lay::kUnion;
  const size_t bytes = static_cast<size_t>(floats) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int num_tiles = (n + kThreads - 1) / kThreads;
  const int grid = num_tiles < per_sm * sms ? num_tiles : per_sm * sms;
  kernel<<<grid, kThreads, bytes, stream>>>(coords, grad_out, n, tables, lv, w0, b0, w1, g_tables,
                                            g_w0, g_b0, g_w1, g_b1, g_coords);
  return static_cast<int>(cudaGetLastError());
}

template <int F, int H, int O, int L>
int launch_mode(int mode, const float* c, const float* g, int n, const __nv_bfloat16* t,
                const BwdLevels& lv, const __nv_bfloat16* w0, const __nv_bfloat16* b0,
                const __nv_bfloat16* w1, float* gt, float* gw0, float* gb0, float* gw1,
                float* gb1, float* gc, cudaStream_t s) {
  if (mode == 0) return launch<F, H, O, L, true>(c, g, n, t, lv, w0, b0, w1, gt, gw0, gb0, gw1, gb1, gc, s);
  return launch<F, H, O, L, false>(c, g, n, t, lv, w0, b0, w1, gt, gw0, gb0, gw1, gb1, gc, s);
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
  if (n < 0 || num_levels < 1 || num_levels > kMaxLevels || (mode != 0 && mode != 1))
    return cudaErrorInvalidValue;
  BwdLevels lv = {};
  int offset = 0;
  lv.n_small = 0;
  lv.small_elems = 0;
  bool small = true;
  for (int l = 0; l < num_levels; ++l) {
    if (resolutions[l] < 2) return cudaErrorInvalidValue;
    lv.res[l] = resolutions[l];
    for (int a = 0; a < 3; ++a) {
      lv.offset[l][a] = offset;
      offset += resolutions[l] * feat;
    }
    const int elems = 3 * resolutions[l] * feat;
    if (small && (lv.small_elems + elems) * static_cast<int>(sizeof(float)) <= kSmallBytes) {
      lv.small_elems += elems;
      lv.n_small = l + 1;
    } else {
      small = false;
    }
  }
  if (n == 0) return cudaSuccess;
  const auto* c = static_cast<const float*>(coords);
  const auto* g = static_cast<const float*>(grad_out);
  const auto* t = static_cast<const __nv_bfloat16*>(tables);
  const auto* pw0 = static_cast<const __nv_bfloat16*>(w0);
  const auto* pb0 = static_cast<const __nv_bfloat16*>(b0);
  const auto* pw1 = static_cast<const __nv_bfloat16*>(w1);
  auto* gt = static_cast<float*>(g_tables);
  auto* gw0 = static_cast<float*>(g_w0);
  auto* gb0 = static_cast<float*>(g_b0);
  auto* gw1 = static_cast<float*>(g_w1);
  auto* gb1 = static_cast<float*>(g_b1);
  auto* gc = static_cast<float*>(g_coords);
  auto s = static_cast<cudaStream_t>(stream);
  if (feat == 8 && hidden == 16 && out_dim == 1 && num_levels == 5) {  // proposal fields
    return launch_mode<8, 16, 1, 5>(mode, c, g, n, t, lv, pw0, pb0, pw1, gt, gw0, gb0, gw1, gb1, gc, s);
  }
  if (feat == 16 && hidden == 64 && out_dim == 16 && num_levels == 8) {  // base field
    return launch_mode<16, 64, 16, 8>(mode, c, g, n, t, lv, pw0, pb0, pw1, gt, gw0, gb0, gw1, gb1, gc, s);
  }
  return cudaErrorInvalidValue;
}
