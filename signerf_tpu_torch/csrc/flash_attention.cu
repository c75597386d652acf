// K7: flash self-attention, forward only, head_dim 64, bf16 in and out.
//
// Replaces the Pallas TPU kernel that `_flash_self_attention`
// (signerf_tpu/diffusion/unet.py:216-268) calls: the library kernel
// `jax.experimental.pallas.ops.tpu.flash_attention`, which the JAX package
// runs in every UNet and ControlNet self-attention (`attn1`) of the SDXL
// inpaint. Per batch row b and head h it computes
//
//     out[b, :, h*64:(h+1)*64] = softmax(q[b, :, h] k[b, :, h]^T * scale) v[b, :, h]
//
// from q, k, v [B, S, H, 64] bf16 (read through their strides, last axis
// contiguous) into out [B, S, H*64] bf16, contiguous. Scores in f32; an
// online softmax with exp2 and the scale folded into log2(e); P rounded to
// bf16 for the PV product; the output divided by the row sum in f32 before
// the bf16 store. Any S >= 1: the ragged tail is masked in the kernel,
// nothing is allocated, and the launch goes on the caller's stream.
//
// What bounds it on an H100: the operations. At the sheet inpaint's shapes
// (S = 9216, H = 10 and S = 2304, H = 20) a call does 4*S*S*64*H flops on
// 4*S*H*64*2 bytes of inputs and output: ~2,300 flops a byte, eight times
// the card's bf16 ridge (~295 flops a byte), so the bound is the tensor
// cores (0.22 ms and 0.027 ms at 989 TFLOP/s). At head_dim 64 the softmax
// is as large as the products: a 128-key tile costs a CTA as many MUFU
// exp2 cycles as tensor-core cycles, so the exponentials have to run while
// the tensor cores work.
//
// What the design does about it (FlashAttention-3's forward, for sm_90a):
//   - one CTA per SM, persistent: it walks the (b, h, 192-query tile)
//     triples in order, query tile fastest, so CTAs that run together share
//     their K/V in L2, and one tile's epilogue overlaps the next one's loads;
//   - four warpgroups: a producer (one thread issues every load) and three
//     consumers of 64 query rows each. `setmaxnreg` gives the producer 24
//     registers and the consumers 160, which hold S (64), O (32) and P (32)
//     without spilling. Three consumers hide the softmax's dependency chain
//     better than two (PERF.md has the H100's times of both). Taking part of the exponentials off the MUFU
//     onto an FMA polynomial, and FA3's ping-pong of the consumers on named
//     barriers, did not make it faster and are not kept: the softmax waits
//     on its dependency chain, not on the MUFU's throughput;
//   - Q, K and V arrive by TMA (`cp.async.bulk.tensor.4d`) over the
//     [B, S, H, 64] views, described from their strides by tensor maps
//     built on the host (cuTensorMapEncodeTiled through
//     cudaGetDriverEntryPoint, so nothing links libcuda). A head-dim row is
//     128 bytes, one 128-byte swizzle row, so every tile lands swizzled and
//     the wgmma descriptors read it without bank conflicts. Rows past S
//     arrive zero-filled; keys past S are masked to -inf and query rows
//     past S are not stored;
//   - K/V tiles of 128 keys in a ring of 4 stages (176 KB of shared memory
//     with Q), each with a "full" mbarrier (TMA transaction bytes) and an
//     "empty" one (one arrival per consumer warp once the wgmmas that read
//     it have been waited for); Q double-buffered the same way, so the next
//     tile's Q loads under this one's last products;
//   - S = Q K^T is wgmma.m64n128k16 with both operands in shared memory
//     (K-major); O += P V is wgmma.m64n64k16 with P from registers (the S
//     accumulator is, register for register, the A fragment) and V from
//     shared memory, MN-major (transpose flag);
//   - per key tile j a consumer issues S_j = Q K_j^T and O += P_{j-1} V_{j-1}
//     together, waits for S_j only, runs the softmax of S_j in place while
//     the PV product runs, then waits for it, rescales O and rounds P to
//     bf16. Nothing writes a register that an in-flight wgmma reads (else
//     ptxas serializes the wgmmas, C7513), so the descriptors are built
//     before each wgmma.fence and P is packed after the wait. The
//     consumers' softmaxes and products interleave on the SM's schedulers
//     by themselves.
// Not done: the backward (inference only).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 3;                  // consumer warpgroups of 64 query rows
constexpr int kD = 64;                         // head dim
constexpr int kBM = 64 * kConsumers;           // queries per tile
constexpr int kBN = 128;                       // keys per stage
constexpr int kStages = 4;                     // K/V ring depth
constexpr int kThreads = (kConsumers + 1) * 128;  // consumer warpgroups first, then the producer
constexpr int kTileBytes = kBN * kD * 2;       // one K or V tile: 16 KB
constexpr int kQBytes = kBM * kD * 2;          // one Q tile
// The consumers' share of the SM's 65,536 registers once the producer
// keeps 24, rounded down to 8 and at most 240: 160 for three consumers.
constexpr int kRegShare = (65536 - 128 * 24) / (128 * kConsumers) / 8 * 8;
constexpr int kConsumerRegs = kRegShare < 240 ? kRegShare : 240;

struct alignas(1024) Smem {
  __nv_bfloat16 q[2][kBM * kD];
  __nv_bfloat16 k[kStages][kBN * kD];
  __nv_bfloat16 v[kStages][kBN * kD];
  uint64_t q_full[2], q_empty[2], kv_full[kStages], kv_empty[kStages];
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;  // slack to align the base to 1024 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Spin until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// One [1, rows, 1, 64] box of a [B, S, H, 64] view (coordinates innermost
// first: d, h, s, b) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int h, int s, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(h), "r"(s), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor of a tile of 128-byte rows in the
// 128-byte swizzle (base 1024-byte aligned): start address, leading and
// stride byte offsets, layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(sbo_bytes >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an in-flight wgmma reads or writes: the compiler may
// neither move their uses across this point nor reuse them before it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] B[128 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] (registers) B[16 x 64], B MN-major in shared memory.
__device__ __forceinline__ void wgmma_pv(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// S = Q K^T for one key tile: 4 k-steps of 16 along d (32 bytes inside
// each swizzled row, so the descriptors advance by 2 units of 16 bytes).
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_qk(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
}

// O += P V for one key tile: 8 k-steps of 16 keys (V's rows advance 2 KB,
// 128 units, a step).
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[32], uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_pv(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], dv + 128 * kk);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 -> one register of two bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A ring position: stage index and the parity of its current use.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  template <int N>
  __device__ __forceinline__ void advance() {
    if (++stage == N) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Online softmax of one 64 x 128 score tile, in place (this thread: rows g
// and g + 8 of its warp's 16, 32 columns each). Keys at or past `valid` are
// masked. Leaves exp2(scale (s - m)) in s, the rescale factors in alpha and
// this thread's share of the new row sums in rs; updates the running max m.
__device__ __forceinline__ void softmax_tile(float (&s)[64], int valid, int t, float scale_log2, float (&m)[2],
                                             float (&alpha)[2], float (&rs)[2]) {
  if (valid < kBN) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (8 * (i >> 2) + 2 * t + (i & 1) >= valid) s[i] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2((m[r] - mx[r]) * scale_log2);  // 0 on the first tile
    m[r] = mx[r];
    ms[r] = mx[r] * scale_log2;
    rs[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = ex2(fmaf(s[i], scale_log2, -ms[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += s[i];
  }
}

// P as the PV product's A fragments: the accumulator of S is, register for
// register, the A fragment of P (16 keys a k-step: columns 8c..8c+7 pack
// rows g and g + 8 into p[2c] and p[2c + 1]).
__device__ __forceinline__ void to_bf16(const float (&s)[64], uint32_t (&p)[32]) {
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    p[2 * c] = pack_bf16(s[4 * c], s[4 * c + 1]);
    p[2 * c + 1] = pack_bf16(s[4 * c + 2], s[4 * c + 3]);
  }
}


__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, int S, int H, int n_qtiles, int n_tiles,
                       float scale_log2, __nv_bfloat16* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128;
  const int n_kv = (S + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.q_full[i], 1);
      mbar_init(&sm.q_empty[i], 4 * kConsumers);  // one arrival per consumer warp
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.kv_full[i], 1);
      mbar_init(&sm.kv_empty[i], 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one thread keeps the rings full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      Ring qr, kv;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int bh = tile / n_qtiles, q0 = (tile % n_qtiles) * kBM;
        const int b = bh / H, h = bh % H;
        mbar_wait(&sm.q_empty[qr.stage], qr.phase ^ 1);
        mbar_expect_tx(&sm.q_full[qr.stage], kQBytes);
        tma_load(sm.q[qr.stage], &tq, h, q0, b, &sm.q_full[qr.stage]);
        qr.advance<2>();
        for (int j = 0; j < n_kv; ++j) {
          mbar_wait(&sm.kv_empty[kv.stage], kv.phase ^ 1);
          mbar_expect_tx(&sm.kv_full[kv.stage], 2 * kTileBytes);
          tma_load(sm.k[kv.stage], &tk, h, j * kBN, b, &sm.kv_full[kv.stage]);
          tma_load(sm.v[kv.stage], &tv, h, j * kBN, b, &sm.kv_full[kv.stage]);
          kv.advance<kStages>();
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of a tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
    const bool arrives = lane == 0;
    Ring qr, kv;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int bh = tile / n_qtiles, q0 = (tile % n_qtiles) * kBM;
      const int b = bh / H, h = bh % H;
      mbar_wait(&sm.q_full[qr.stage], qr.phase);
      const uint64_t dq = sw128_desc(smem_u32(sm.q[qr.stage] + wg * 64 * kD), 16, 1024);

      float s[64], o[32];
      uint32_t p[32];
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;

      // Key tile 0.
      mbar_wait(&sm.kv_full[kv.stage], kv.phase);
      uint64_t dk = sw128_desc(smem_u32(sm.k[kv.stage]), 16, 1024);
      pin(s);
      wg_fence();
      issue_qk(s, dq, dk);
      wg_commit();
      wg_wait<0>();
      pin(s);
      {
        float alpha[2];
        softmax_tile(s, S, t, scale_log2, m, alpha, l);
      }
      to_bf16(s, p);
      int prev = kv.stage;
      kv.advance<kStages>();

      // Key tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} issued together;
      // the softmax of S_j runs while the PV product does.
      for (int j = 1; j < n_kv; ++j) {
        mbar_wait(&sm.kv_full[kv.stage], kv.phase);
        dk = sw128_desc(smem_u32(sm.k[kv.stage]), 16, 1024);
        const uint64_t dv = sw128_desc(smem_u32(sm.v[prev]), 16, 1024);
          pin(s);
        pin(o);
        pin(p);
        wg_fence();
        issue_qk(s, dq, dk);
        wg_commit();
        issue_pv(o, p, dv);
        wg_commit();
          wg_wait<1>();
        pin(s);
        float alpha[2], rs[2];
        softmax_tile(s, S - j * kBN, t, scale_log2, m, alpha, rs);
        wg_wait<0>();
        pin(o);
        pin(p);
        if (arrives) mbar_arrive(&sm.kv_empty[prev]);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          o[4 * c] *= alpha[0];
          o[4 * c + 1] *= alpha[0];
          o[4 * c + 2] *= alpha[1];
          o[4 * c + 3] *= alpha[1];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
        to_bf16(s, p);
        prev = kv.stage;
        kv.advance<kStages>();
      }

      const uint64_t dv = sw128_desc(smem_u32(sm.v[prev]), 16, 1024);
      pin(o);
      pin(p);
      wg_fence();
      issue_pv(o, p, dv);
      wg_commit();
      wg_wait<0>();
      pin(o);
      pin(p);
      if (arrives) {
        mbar_arrive(&sm.kv_empty[prev]);
        mbar_arrive(&sm.q_empty[qr.stage]);
      }
      qr.advance<2>();

      // Full row sums, then out = O / l in f32, stored as bf16 into [B, S, H*64].
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
      const long long row_stride = static_cast<long long>(H) * kD;
      __nv_bfloat16* out0 = out + (static_cast<long long>(b) * S + r0) * row_stride + h * kD + 2 * t;
      __nv_bfloat16* out1 = out0 + 8 * row_stride;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (r0 < S) *reinterpret_cast<uint32_t*>(out0 + 8 * c) = pack_bf16(o[4 * c] / l[0], o[4 * c + 1] / l[0]);
        if (r1 < S)
          *reinterpret_cast<uint32_t*>(out1 + 8 * c) = pack_bf16(o[4 * c + 2] / l[1], o[4 * c + 3] / l[1]);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found at run time through the CUDA runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A tensor map over a [B, S, H, 64] bf16 view with element strides (sb, ss,
// sh), dimensions innermost first (d, h, s, b), boxes of [1, rows, 1, 64]
// in the 128-byte swizzle; rows out of range read as zeros. A size-1 dimension
// gets the packed stride (TMA wants every stride non-zero).
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int B, int S, int H, long long sb,
              long long ss, long long sh, int rows) {
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(S),
                        static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3];
  strides[0] = H > 1 ? static_cast<cuuint64_t>(sh) * 2 : kD * 2;
  strides[1] = S > 1 ? static_cast<cuuint64_t>(ss) * 2 : strides[0] * H;
  strides[2] = B > 1 ? static_cast<cuuint64_t>(sb) * 2 : strides[1] * S;
  const cuuint32_t box[4] = {kD, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

}  // namespace

// strides: q's (batch, sequence, head) element strides, then k's, then v's.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, const long long* strides,
                                       int B, int S, int H, float scale, void* out, void* stream) {
  if (B < 1 || S < 1 || H < 1) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, B, S, H, strides[0], strides[1], strides[2], kBM) ||
      !make_map(encode, &tk, k, B, S, H, strides[3], strides[4], strides[5], kBN) ||
      !make_map(encode, &tv, v, B, S, H, strides[6], strides[7], strides[8], kBN))
    return cudaErrorInvalidValue;
  // Per device, once: the shared-memory opt-in and the SM count.
  static int sms[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    err = cudaFuncSetAttribute(flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[device] = count;
  }
  const int n_qtiles = (S + kBM - 1) / kBM;
  const long long n_tiles = static_cast<long long>(B) * H * n_qtiles;
  if (n_tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  const int grid = n_tiles < sms[device] ? static_cast<int>(n_tiles) : sms[device];
  flash_attention_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, S, H, n_qtiles, static_cast<int>(n_tiles), scale * 1.4426950408889634f,
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
