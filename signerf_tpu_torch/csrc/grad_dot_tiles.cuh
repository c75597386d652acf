// K5's tile loop (fused_factor_grad_dot.cu), shared by K5, K6's coords half
// (fused_factor_grad_dot.cu) and K4's coords half (fused_factor_encode.cu).
//
// All three read g [N, L F] f32 once and write [N, 3] f32, with K1's taps:
//   K5 and K4's coords half:  out[n, a] = sum_l sum_F d_a f_b f_c g_l
//   K6's coords half:          out[n, a] = sum_l sum_F G_hat_a d_a
// (K4's du_a = sum g f_b f_c d_a is K5's s_a on K4's cotangent: the same
// function under the same knot rule.) Persistent blocks of 256 threads walk
// over tiles of samples. Each tile's g comes into shared memory by one bulk
// copy of the Tensor Memory Accelerator (cp.async.bulk) that completes on
// an mbarrier; g and the coordinates (with kCt also the cotangents ct
// [N, 3]) are double-buffered, so the next tile's arrive while the block
// gathers this one, and one __syncthreads a tile orders every buffer. A
// tile's parts are 8 features of one level of one sample, level-major;
// each thread keeps one sample and part and walks over the levels of its
// group of threads. factor_grid::part8_dot (or part8_dot_ct) forms a part's
// three sums with the slope factor applied once to each sum, so an axis at
// a knot of every level gives exactly 0. The threads that hold one sample's
// parts reduce their sums (shuffles between the parts of a level, shared
// memory between the groups) and the tile writes one [tile, 3] block:
// every output row is written once, nothing is accumulated in device
// memory.
//
// Two tile shapes, by (F, L):
// - the base field (F = 16, L = 8): tiles of 32 samples, 4 groups of 32
//   samples x 2 parts, each thread on 2 levels; levels 0 to 3 (23 KB of
//   tables) in shared memory. K5's design, three blocks an SM;
// - the proposal schedule (F = 8, L = 5; K4's coords half, the backward of
//   K10): 8 groups of 32 threads would not divide 5 levels, so one group on
//   tiles of 256 samples, each thread walking all 5 levels of its sample
//   (40 KB bulk copies of g a tile, two blocks an SM), and the levels'
//   tables in shared memory (all 5 at max_res 128, 14 KB). Its
//   g rows are 160 bytes apart, so a quarter-warp's 16-byte reads of g meet
//   on each bank twice.
//
// On an H100 80GB HBM3 at 700 W (PERF.md), N = 2,097,152 at the proposal
// schedule: these tiles take 0.141 ms (81% of the byte bound) at every
// layout; 160-thread blocks of 32-sample tiles, a warp a level, took 0.164
// ms (70%), and the one-thread-per-(sample, level) design with
// device-memory atomicAdds that K4's coords half had before, 0.37 ms.
// Written with checks t + q 256 < 768 that the compiler cannot drop (it
// does not take t < 256 from __launch_bounds__), the staging wrapped the
// next tile's loads in divergent regions and took 0.18 to 0.20 ms, so
// in_tile decides them at compile time. At the base field K4's coords half
// is K5's instantiation, bit for bit and at K5's ~0.060 ms (the item
// design: 0.078 to 0.081 ms); K6's coords half on this loop was 1.6x
// faster than that design too.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "factor_grid_common.cuh"

namespace factor_grid {

constexpr int kDotThreads = 256;

// Groups of threads a block, each on every G-th level of its tile's
// samples: 8 / P groups of 32 samples' P parts where they divide the levels
// (the base field: 4), else one group that walks every level (the proposal
// schedule).
template <int F, int L>
__host__ __device__ constexpr int dot_groups() {
  return L % (kDotThreads / (32 * (F / 8))) == 0 ? kDotThreads / (32 * (F / 8)) : 1;
}
// Samples a tile: 32 at the base field, 256 at the proposal schedule.
template <int F, int L>
__host__ __device__ constexpr int dot_tile() { return kDotThreads / ((F / 8) * dot_groups<F, L>()); }
// Blocks an SM for __launch_bounds__: three (K5's 80-register cap) on
// 32-sample tiles; two, all that the shared memory of 256-sample tiles
// holds, otherwise.
template <int F, int L>
__host__ __device__ constexpr int dot_min_blocks() { return dot_groups<F, L>() == 1 ? 2 : 3; }
// The coarse levels whose tables may sit in shared memory: those of a
// thread's first loop step (levels 0 to 3 of the base field; the finer
// levels then compile without the shared branch), or every level where one
// group walks them all.
template <int F, int L>
__host__ __device__ constexpr int dot_shared_levels() { return dot_groups<F, L>() == 1 ? L : dot_groups<F, L>(); }
// ... up to this many bytes of them: 24 KB on 32-sample tiles (levels 0 to
// 3 of the base field, 23 KB); 20 KB beside the 94 KB of 256-sample tiles,
// so that two blocks fit an SM's 228 KB (every level of the proposal field
// at max_res 128, 14 KB; levels 0 to 3 at max_res 256).
template <int F, int L>
__host__ __device__ constexpr int dot_shared_bytes() { return dot_groups<F, L>() == 1 ? 20 * 1024 : 24 * 1024; }

// Shared memory: g [2][tile][L F] f32, the tiles' coordinates [2][tile][3]
// (and with kCt the cotangents ct [2][tile][3]), the groups' sums
// [2][G][tile][3], two mbarriers, each level's resolution and three table
// offsets [L][4] (read with a level index that differs between warps, the
// schedule would otherwise be copied to local memory), then the coarse
// levels' tables (shared_elems bf16, levels [0, n_shared)). Each buffer
// serves every other tile.
template <int F, int L, bool kCt>
constexpr int dot_smem_bytes(int shared_table_bytes) {
  constexpr int kTile = dot_tile<F, L>();
  return (2 * kTile * L * F + (kCt ? 4 : 2) * kTile * 3 + 2 * dot_groups<F, L>() * kTile * 3) * 4 + 2 * 8 +
         L * 16 + shared_table_bytes;
}

// Tile `tile` of kTile rows of g [N, D] into `dst`, completing on `bar` (one
// thread).
template <int D, int kTile>
__device__ __forceinline__ void load_g_tile(float* dst, const float* __restrict__ grad, int tile, int n,
                                            uint64_t* bar) {
  const int64_t s0 = static_cast<int64_t>(tile) * kTile;
  const int rows = n - s0 < kTile ? static_cast<int>(n - s0) : kTile;
  const uint32_t bytes = static_cast<uint32_t>(rows) * D * 4;
  mbar_expect_tx(bar, bytes);
  bulk_load(dst, grad + s0 * D, bytes, bar);
}

// Writes out [N, 3]: sum_l sum_F d_a f_b f_c g (part8_dot) or, with kCt,
// sum_l sum_F G_hat_a d_a (part8_dot_ct). Launched by launch_dot_tiles.
template <int F, int L, bool kCt>
__device__ __forceinline__ void grad_dot_tiles(const float* __restrict__ coords, const float* __restrict__ grad,
                                               const float* __restrict__ ct, int n,
                                               const __nv_bfloat16* __restrict__ tables, const Schedule& s,
                                               int n_shared, int shared_elems, float* __restrict__ out) {
  constexpr int D = L * F;
  constexpr int P = F / 8;                // parts of a level
  constexpr int G = dot_groups<F, L>();   // groups of threads, each on every G-th level
  constexpr int kTile = dot_tile<F, L>();
  constexpr int kTile3 = kTile * 3;
  // Values a thread stages a tile: the coordinates, and with kCt the cotangents.
  constexpr int kStage = ((kCt ? 2 : 1) * kTile3 + kDotThreads - 1) / kDotThreads;
  constexpr int kOut = (kTile3 + kDotThreads - 1) / kDotThreads;  // output values a thread writes a tile
  static_assert(F % 8 == 0 && G * kTile * P == kDotThreads && L % G == 0, "a whole number of levels a thread");
  extern __shared__ __align__(128) uint8_t smem[];
  float* s_g = reinterpret_cast<float*>(smem);  // [2][kTile][D]
  float* s_u = s_g + 2 * kTile * D;             // [2][kTile][3]
  float* s_ct = s_u + 2 * kTile3;               // [2][kTile][3], kCt only
  float* s_sum = s_ct + (kCt ? 2 * kTile3 : 0);  // [2][G][kTile][3]
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_sum + 2 * G * kTile3);  // [2]
  int* s_lv = reinterpret_cast<int*>(bar + 2);  // [L][4]
  __nv_bfloat16* s_tab = reinterpret_cast<__nv_bfloat16*>(s_lv + 4 * L);
  const int t = threadIdx.x;
  // With one group (kTile P = kDotThreads) every thread walks levels 0 to
  // L - 1: grp is the constant 0, so each level's offsets are constants of
  // the unrolled loop.
  const int h = t % P, smp = G == 1 ? t / P : t / P % kTile, grp = G == 1 ? 0 : t / (kTile * P);
  const int num_tiles = (n + kTile - 1) / kTile;
  // Value v = t + q kDotThreads of a tile's [kTile][3] coordinates (clamped
  // to [0, 1]), then with kCt of its cotangents. in_tile(q, m): value q is
  // below m for every thread (known at compile time, so that the 256-sample
  // tiles take no branch), or for this one.
  const auto in_tile = [&](int q, int m) { return (q + 1) * kDotThreads <= m || t + q * kDotThreads < m; };
  const auto is_ct = [&](int q) { return kCt && !in_tile(q, kTile3) && in_tile(q, 2 * kTile3); };
  const auto is_stager = [&](int q) { return in_tile(q, kTile3) || is_ct(q); };
  const auto staged = [&](int tile, int q) {
    const int j3 = t + q * kDotThreads - (is_ct(q) ? kTile3 : 0);
    const int64_t at = static_cast<int64_t>(tile) * kTile3 + j3;
    if (tile >= num_tiles || at >= static_cast<int64_t>(n) * 3) return 0.f;
    return is_ct(q) ? __ldg(ct + at) : fminf(fmaxf(__ldg(coords + at), 0.f), 1.f);
  };
  const auto stage_at = [&](int buf, int q) {  // where value q of a thread goes in buffer buf
    const int j3 = t + q * kDotThreads - (is_ct(q) ? kTile3 : 0);
    return (is_ct(q) ? s_ct : s_u) + buf * kTile3 + j3;
  };
  for (int i = t; i < shared_elems / 8; i += kDotThreads) cp_async16(s_tab + 8 * i, tables + 8 * i);
  if (t == 0) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      s_lv[4 * l] = s.res[l];
      s_lv[4 * l + 1] = s.offset[l][0];
      s_lv[4 * l + 2] = s.offset[l][1];
      s_lv[4 * l + 3] = s.offset[l][2];
    }
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    fence_mbar_init();
    load_g_tile<D, kTile>(s_g, grad, blockIdx.x, n, bar);  // the grid has at most num_tiles blocks
  }
#pragma unroll
  for (int q = 0; q < kStage; ++q)
    if (is_stager(q)) *stage_at(0, q) = staged(blockIdx.x, q);
  cp_async_wait_all();
  __syncthreads();  // barriers, tables and the first tile's coordinates ready
  int it = 0;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x, ++it) {
    const int buf = it & 1;
    const int next = tile + gridDim.x;
    const int64_t s0 = static_cast<int64_t>(tile) * kTile;
    // The next tile's g, coordinates and cotangents come in while this one
    // is gathered: g into the other buffer (last read before the previous
    // tile's __syncthreads), the others into registers until then.
    if (t == 0 && next < num_tiles)
      load_g_tile<D, kTile>(s_g + (buf ^ 1) * kTile * D, grad, next, n, bar + (buf ^ 1));
    float in_next[kStage];
#pragma unroll
    for (int q = 0; q < kStage; ++q) in_next[q] = is_stager(q) ? staged(next, q) : 0.f;
    const float* tu = s_u + buf * kTile3 + 3 * smp;
    const float u[3] = {tu[0], tu[1], tu[2]};
    float cv[3] = {0.f, 0.f, 0.f};
    if constexpr (kCt) {
      const float* tc = s_ct + buf * kTile3 + 3 * smp;
      cv[0] = tc[0], cv[1] = tc[1], cv[2] = tc[2];
    }
    mbar_wait(bar + buf, (it >> 1) & 1);
    const float* g_row = s_g + (buf * kTile + smp) * D;
    float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < L / G; ++j) {
      const int l = j * G + grp;
      const float4* src = reinterpret_cast<const float4*>(g_row + l * F + 8 * h);
      const float4 lo = src[0], hi = src[1];
      const float gv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const int4 lv = reinterpret_cast<const int4*>(s_lv)[l];
      // l >= j G: past the shared levels for every thread once j G is.
      if (j * G < dot_shared_levels<F, L>() && l < n_shared) {
        const __nv_bfloat16* const line[3] = {s_tab + lv.y, s_tab + lv.z, s_tab + lv.w};
        if constexpr (kCt) {
          part8_dot_ct<F, false>(line, lv.x, 8 * h, u, cv, gv, acc);
        } else {
          part8_dot<F, false>(line, lv.x, 8 * h, u, gv, acc);
        }
      } else {
        const __nv_bfloat16* const line[3] = {tables + lv.y, tables + lv.z, tables + lv.w};
        if constexpr (kCt) {
          part8_dot_ct<F, true>(line, lv.x, 8 * h, u, cv, gv, acc);
        } else {
          part8_dot<F, true>(line, lv.x, 8 * h, u, gv, acc);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int o = P / 2; o > 0; o >>= 1) acc[a] += __shfl_xor_sync(0xffffffffu, acc[a], o);
    }
    float* sums = s_sum + buf * G * kTile3;
    if (h == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) sums[(grp * kTile + smp) * 3 + a] = acc[a];
    }
#pragma unroll
    for (int q = 0; q < kStage; ++q)
      if (is_stager(q)) *stage_at(buf ^ 1, q) = in_next[q];
    __syncthreads();  // this tile's sums and the next tile's coordinates are in
#pragma unroll
    for (int q = 0; q < kOut; ++q) {
      const int v = t + q * kDotThreads;
      if (in_tile(q, kTile3) && s0 * 3 + v < static_cast<int64_t>(n) * 3) {
        float r = sums[v];
#pragma unroll
        for (int p = 1; p < G; ++p) r += sums[p * kTile3 + v];
        out[s0 * 3 + v] = r;
      }
    }
  }
}

// Launches `kernel`, a __global__ wrapper of grad_dot_tiles<F, L, kCt> that
// takes (coords, grad, ct, n, tables, s, n_shared, shared_elems, out), with
// the coarse levels (dot_shared_levels) whose tables fit dot_shared_bytes
// in shared memory and one block a tile up to the resident blocks. Returns the
// launch's error.
template <int F, int L, bool kCt, typename Kernel>
int launch_dot_tiles(Kernel kernel, const float* c, const float* g, const float* ct, int n,
                     const __nv_bfloat16* t, const Schedule& s, float* out, cudaStream_t stream) {
  int n_shared = 0, shared_elems = 0;  // levels [0, n_shared) and their packed tables
  while (n_shared < dot_shared_levels<F, L>() &&
         (shared_elems + 3 * s.res[n_shared] * F) * 2 <= dot_shared_bytes<F, L>())
    shared_elems += 3 * s.res[n_shared++] * F;
  const int smem = dot_smem_bytes<F, L, kCt>(shared_elems * 2);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  if ((err = resident_blocks(kernel, kDotThreads, smem, resident)) != cudaSuccess) return static_cast<int>(err);
  constexpr int kTile = dot_tile<F, L>();
  const int tiles = (n + kTile - 1) / kTile;
  kernel<<<tiles < resident ? tiles : resident, kDotThreads, smem, stream>>>(c, g, ct, n, t, s, n_shared,
                                                                              shared_elems, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace factor_grid
