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

// One table row of F bf16 values (F * 2 bytes, a multiple of 16) -> f32,
// through the read-only path (kGlobal) or from shared memory.
template <int F, bool kGlobal = true>
__device__ __forceinline__ void load_row(const __nv_bfloat16* row, float* out) {
  const uint4* src = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int v = 0; v < F / 8; ++v) {
    const uint4 raw = kGlobal ? __ldg(src + v) : src[v];
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

// (1 - w) r0 + w r1 with each product rounded, as the plain twin takes
// it: a contracted FMA rounds once, and that flips the bf16 rounding of
// some features against the twin's (one value for every sample of a cell).
// K1's features and K2's recompute of them take it, so bf16(feat) is the
// twin's bit for bit in both.
__device__ __forceinline__ float lerp(float r0, float r1, float w) {
  return __fadd_rn(__fmul_rn(1.f - w, r0), __fmul_rn(w, r1));
}

// ---------------------------------------------------------------------------
// Tensor-core helpers (K1, K2): mma.sync.m16n8k16 bf16 and its ldmatrix
// fragments, on bf16 tiles in shared memory.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a b: a 16x16 (row fragment), b 16x8 (column fragment), f32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kTrans>
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const __nv_bfloat16* p) {
  if constexpr (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
  }
}

// The A fragment of rows [m0, m0 + 16) x cols [k0, k0 + 16) of a matrix
// stored [m][k] (row stride `ld` values).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* s, int ld, int m0, int k0, int lane) {
  ldsm<false>(a, s + (m0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + k0 + (lane >> 4) * 8);
}
// ... of a matrix stored transposed, [k][m].
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const __nv_bfloat16* s, int ld, int m0, int k0, int lane) {
  ldsm<true>(a, s + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 + ((lane >> 3) & 1) * 8);
}
// The B fragments of k [k0, k0 + 16) x n [n0, n0 + 16) (two n-tiles of 8:
// b[0], b[1] for n0 and b[2], b[3] for n0 + 8) of a matrix stored [k][n].
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* s, int ld, int k0, int n0, int lane) {
  ldsm<true>(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}
// ... of a matrix stored [n][k].
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* s, int ld, int k0, int n0, int lane) {
  ldsm<false>(b, s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// The packed tables' level schedule: resolutions and the element offset of
// each [R_l, F] table (level-major, then axis).
struct Schedule {
  int res[kMaxLevels];
  int offset[kMaxLevels][3];
};

inline bool make_schedule(const int* resolutions, int num_levels, int feat, Schedule& s) {
  if (num_levels < 1 || num_levels > kMaxLevels) return false;
  s = {};
  int offset = 0;
  for (int l = 0; l < num_levels; ++l) {
    if (resolutions[l] < 2) return false;
    s.res[l] = resolutions[l];
    for (int a = 0; a < 3; ++a) {
      s.offset[l][a] = offset;
      offset += resolutions[l] * feat;
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// The encode tile (K1, K3, K10): the features of kTile samples, computed by
// kThreads threads into a tile in shared memory.

// Eight features of one level and axis: columns [c, c + 8) of rows i and
// i + 1 of `line` ([R, F] bf16), one 16-byte load each, at K1's taps. K1
// and K3 take the rounded lerp; K10 (kDenseHat) the dense-hat contract, its
// two hat weights rounded to bf16 and the exact products summed in f32.
template <bool kDenseHat, bool kGlobal>
__device__ __forceinline__ void axis8(const __nv_bfloat16* line, int feat, int c, float u, int res,
                                      float (&f)[8]) {
  int i;
  float w;
  tap(u, res, i, w);
  float r0[8], r1[8];
  load_row<8, kGlobal>(line + i * feat + c, r0);
  load_row<8, kGlobal>(line + (i + 1) * feat + c, r1);
  if constexpr (kDenseHat) {
    const float x = __fmul_rn(u, static_cast<float>(res - 1));
    const float h0 = round_bf16(1.f - fabsf(x - static_cast<float>(i)));
    const float h1 = round_bf16(1.f - fabsf(x - static_cast<float>(i + 1)));
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = fmaf(h0, r0[k], h1 * r1[k]);  // exact products
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = lerp(r0[k], r1[k], w);
  }
}

// Features [c, c + 8) of level l at coordinates u[0, 3): the three axes'
// values multiplied in the twin's order, (f_x f_y) f_z. `tab` is packed as
// the tables are, in device memory (kGlobal) or shared memory.
template <int F, bool kDenseHat, bool kGlobal>
__device__ __forceinline__ void part8(const __nv_bfloat16* tab, const Schedule& sc, int l, int c, const float* u,
                                      float (&v)[8]) {
  const int res = sc.res[l];
  axis8<kDenseHat, kGlobal>(tab + sc.offset[l][0], F, c, u[0], res, v);
#pragma unroll
  for (int a = 1; a < 3; ++a) {
    float f[8];
    axis8<kDenseHat, kGlobal>(tab + sc.offset[l][a], F, c, u[a], res, f);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] *= f[k];
  }
}

// Eight features of one level and axis and their differences (K5, K9):
// K1's taps (i, w), the slope factor s under the knot rule, and from
// columns [c, c + 8) of rows i and i + 1 the difference r1 - r0 and the
// value f = r0 + w (r1 - r0) (a few ulps from the rounded lerp K1 and K3
// take). The slope is d = (r1 - r0) s, exactly 0 at a knot.
template <bool kGlobal>
__device__ __forceinline__ void axis8_diff(const __nv_bfloat16* line, int feat, int c, float u, int res, int& i,
                                           float& w, float& s, float (&f)[8], float (&diff)[8]) {
  tap(u, res, i, w);
  s = slope_scale(w, res);
  float r0[8], r1[8];
  load_row<8, kGlobal>(line + i * feat + c, r0);
  load_row<8, kGlobal>(line + (i + 1) * feat + c, r1);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    diff[k] = r1[k] - r0[k];
    f[k] = fmaf(w, diff[k], r0[k]);
  }
}

// K5's part: acc[a] += s_a sum_k (r1 - r0)_a f_b f_c g[k] = sum_k d_a f_b
// f_c g[k] over features [c, c + 8) of one level at coordinates u[0, 3),
// from the level's three [R, F] tables `line` (in device memory when
// kGlobal, else in shared memory). The slope factor multiplies the part's
// sum once, so an axis at a knot (s = 0) adds exactly nothing.
template <int F, bool kGlobal>
__device__ __forceinline__ void part8_dot(const __nv_bfloat16* const (&line)[3], int res, int c, const float* u,
                                          const float (&g)[8], float (&acc)[3]) {
  float f[3][8], diff[3][8], s[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    int i;
    float w;
    axis8_diff<kGlobal>(line[a], F, c, u[a], res, i, w, s[a], f[a], diff[a]);
  }
  float q[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float f0g = f[0][k] * g[k], f1g = f[1][k] * g[k];
    q[0] = fmaf(diff[0][k], f[2][k] * f1g, q[0]);
    q[1] = fmaf(diff[1][k], f[2][k] * f0g, q[1]);
    q[2] = fmaf(diff[2][k], f[1][k] * f0g, q[2]);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) acc[a] = fmaf(s[a], q[a], acc[a]);
}

// The features of the kTile samples whose clamped coordinates are in
// s_u [kTile][3], in parts of eight: part (s, l, h) is features
// [8 h, 8 h + 8) of level l of sample s, so each of its six rows (two per
// axis) is one 16-byte load, and the two parts of an F = 16 level read each
// 32-byte row (one sector) whole from neighbouring lanes. The parts are
// level-major: the lanes of a warp take consecutive samples at one level,
// so samples in ray order, and every sample at the coarse levels, meet on a
// few rows (fewer cache lines a load instruction). Each thread keeps one
// sample and part and walks over the levels of its group of threads (all
// levels when the block has one thread a part of a level, so that each
// level's schedule entries are constants of the unrolled loop).
// `store(s, l, h, v)` puts part (s, l, h) away as 8 f32 values v. With
// kShared, levels [0, n_shared) read their tables from `s_tab` (shared
// memory, packed as `tables`); without, that branch is not compiled
// (compiled in, it slowed K1 on the H100; PERF.md).
template <int F, int L, int kTile, int kThreads, bool kDenseHat, bool kShared, typename Store>
__device__ __forceinline__ void encode_tile(const float* s_u, const __nv_bfloat16* __restrict__ tables,
                                            const __nv_bfloat16* s_tab, int n_shared, const Schedule& sc,
                                            Store&& store) {
  static_assert(F % 8 == 0, "parts of 8 features");
  constexpr int P = F / 8;                  // parts of a level
  constexpr int G = kThreads / (kTile * P);  // groups of threads, each on every G-th level
  static_assert(G * kTile * P == kThreads && L % G == 0, "a whole number of levels a thread");
  const int t = threadIdx.x;
  const int h = t % P, s = t / P % kTile, g = t / (kTile * P);
  const float u[3] = {s_u[3 * s], s_u[3 * s + 1], s_u[3 * s + 2]};
#pragma unroll
  for (int j = 0; j < L / G; ++j) {
    const int l = j * G + g;
    float v[8];
    if (kShared && l < n_shared) {
      part8<F, kDenseHat, false>(s_tab, sc, l, 8 * h, u, v);
    } else {
      part8<F, kDenseHat, true>(tables, sc, l, 8 * h, u, v);
    }
    store(s, l, h, v);
  }
}

// Coordinates of samples [s0, s0 + kTile) of coords [n, 3], clamped to
// [0, 1], into s_u [kTile][3] (one coalesced pass); samples past n get 0.
template <int kTile, int kThreads>
__device__ __forceinline__ void stage_coords(float* s_u, const float* __restrict__ coords, int64_t s0, int n) {
  const int64_t base = s0 * 3, end = static_cast<int64_t>(n) * 3;
  for (int j = threadIdx.x; j < kTile * 3; j += kThreads)
    s_u[j] = base + j < end ? fminf(fmaxf(__ldg(coords + base + j), 0.f), 1.f) : 0.f;
}

// ---------------------------------------------------------------------------
// Asynchronous copies (sm_90).

// 16 bytes global -> shared, bypassing L1 (cp.async; both 16-byte aligned).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Make this thread's writes to shared memory visible to the bulk copies
// (the async proxy) that a later barrier releases.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One bulk copy shared -> global of `bytes` (a multiple of 16, both ends
// 16-byte aligned) by the Tensor Memory Accelerator, in this thread's
// current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Wait until all of this thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// mbarriers (one phase per use) and bulk copies global -> shared that
// complete on one.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
// Make the barriers' initialisation visible to the async proxy and the block
// (a __syncthreads must follow before other threads wait on them).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Arrive once and expect `bytes` more of transactions on `bar`.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) global -> shared
// by the Tensor Memory Accelerator, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Warp-aggregated sums for a scatter whose lanes often hit the same row:
// every run of consecutive lanes holding the same `key` gets v summed over
// the run, element by element, into the run's first lane, which returns
// true; the other lanes return false with v spent. Samples in ray order
// put a ray's samples on consecutive lanes, so at the coarse levels a
// warp's 32 lanes form one or two runs. A segmented suffix scan: round k
// adds the value 2^k lanes down where that lane is still in the run, and
// the rounds stop once no run is longer than 2^k (none when every lane's
// key differs from its neighbours'). Every lane of the warp must call it.
template <int N>
__device__ __forceinline__ bool warp_run_sum(int key, float (&v)[N]) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int up = __shfl_up_sync(kFull, key, 1);  // every lane takes part
  const bool head = lane == 0 || up != key;
  const unsigned later_heads = __ballot_sync(kFull, head) & ~((2u << lane) - 1u);
  const int end = later_heads ? __ffs(later_heads) - 1 : 32;  // this run is [.., end)
  for (int off = 1; off < 32 && __any_sync(kFull, lane + off < end); off <<= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float x = __shfl_down_sync(kFull, v[i], off);
      if (lane + off < end) v[i] += x;
    }
  }
  return head;
}

// dst[0, F) += v[0, F) in device memory as 16-byte vector reductions
// (sm_90: resolved in L2, no compare-and-swap loop); dst 16-byte aligned.
template <int F>
__device__ __forceinline__ void red_add_row(float* dst, const float* v) {
  static_assert(F % 4 == 0, "16-byte pieces");
#pragma unroll
  for (int q = 0; q < F / 4; ++q)
    atomicAdd(reinterpret_cast<float4*>(dst) + q, make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
}

// One level and axis of a line-grad scatter (the tables halves of K4, K6
// and K9): v[0, W) goes to row `row` of `line_grad` (rows of F floats) and
// v[W, 2W) to row `row` + 1, summed first over each run of lanes on the
// same row (warp_run_sum), then added by the run's first lane with vector
// reductions. W = F scatters whole rows; W < F a part of each, from the
// column `line_grad` is offset by. A lane with nothing to add (past the
// last sample) passes row -1 and zeros: no valid lane uses that key, so its
// run is its own and is not written. line_grad + row F must be 16-byte
// aligned: with F in {8, 16} and a column a multiple of 4 it is whenever
// the packed grads are. Every lane of the warp must call it.
template <int W, int F = W>
__device__ __forceinline__ void scatter_two_rows(float* __restrict__ line_grad, int row, float (&v)[2 * W]) {
  if (warp_run_sum(row, v) && row >= 0) {
    float* dst = line_grad + row * F;
    red_add_row<W>(dst, v);
    red_add_row<W>(dst + F, v + W);
  }
}

// F f32 values from a 16-byte-aligned row.
template <int F>
__device__ __forceinline__ void load_row_f32(const float* __restrict__ row, float* out) {
  const float4* src = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < F / 4; ++q) {
    const float4 x = src[q];
    out[4 * q] = x.x;
    out[4 * q + 1] = x.y;
    out[4 * q + 2] = x.z;
    out[4 * q + 3] = x.w;
  }
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
