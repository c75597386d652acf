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
// contiguous) into out [B, S, H*64] bf16, contiguous.
//
// What bounds it on an H100: the operations. At the sheet inpaint's shapes
// (S = 9216, H = 10 and S = 2304, H = 20) a call does 4*S*S*64*H flops on
// 4*S*H*64*2 bytes of inputs and output: ~2,300 flops a byte, eight times
// the card's bf16 ridge (~295 flops a byte), so the bound is the tensor
// cores (0.22 ms and 0.027 ms at 989 TFLOP/s). A version that writes the
// S x S scores to device memory would be bound by those bytes instead
// (3.4 GB a call at S = 9216).
//
// What the design does about it: the FlashAttention-2 forward. One block of
// four warps takes 64 queries of one (b, h); each warp owns 16 query rows
// and keeps its Q fragment, its output accumulator and its softmax state in
// registers. The block walks over the keys in tiles of 64, double-buffered
// in shared memory by cp.async (rows padded to 72 values, so the fragment
// loads hit 32 distinct banks). S = Q K^T and O += P V run on the tensor
// cores as mma.sync.m16n8k16 bf16 x bf16 -> f32; the accumulator fragment
// of S is, register for register, the A fragment of P, so P never leaves
// registers; V's B fragments come through ldmatrix.trans. The softmax is
// online: a running max and sum per row in f32, exp2 with the scale folded
// into log2(e), P rounded to bf16 for the PV product, and the output divided
// by the sum in f32 before the bf16 store. No score ever reaches device
// memory. Keys past S are zero-filled by cp.async and masked to -inf; query
// rows past S are computed from zeros and not stored, so any S >= 1 works
// without padding. The kernel allocates nothing and launches on the
// caller's stream. Not done yet: wgmma, TMA, warp specialisation, a
// persistent schedule, and the backward (inference only).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBM = 64;       // queries per block
constexpr int kBN = 64;       // keys per tile
constexpr int kWarps = 4;     // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;  // padded shared-memory row, in bf16 values (144 bytes)

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a b, a 16x16 (row-major fragment), b 16x8 (column-major fragment).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Two f32 -> one register of two bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, Strides st, int S, int H, float scale_log2,
                       __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 ks[2][kBN][kLds];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kBN][kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* kbase = k + b * st.kb + h * st.kh;
  const __nv_bfloat16* vbase = v + b * st.vb + h * st.vh;

  auto load_tile = [&](int stage, int kv0) {
#pragma unroll
    for (int i = 0; i < kBN * kD / 8 / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int row = c >> 3, col = (c & 7) * 8;
      const bool valid = kv0 + row < S;
      const long long key = valid ? kv0 + row : 0;
      cp_async16(&ks[stage][row][col], kbase + key * st.ks + col, valid);
      cp_async16(&vs[stage][row][col], vbase + key * st.vs + col, valid);
    }
    cp_async_commit();
  };

  const int ntiles = (S + kBN - 1) / kBN;
  load_tile(0, 0);

  // This warp's 16 query rows as A fragments, one per 16 values of d.
  const int r0 = blockIdx.x * kBM + warp * 16 + g, r1 = r0 + 8;
  const __nv_bfloat16* qbase = q + b * st.qb + h * st.qh;
  auto q32 = [&](int row, int d) -> uint32_t {
    return row < S ? *reinterpret_cast<const uint32_t*>(qbase + row * st.qs + d) : 0u;
  };
  uint32_t qa[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int d = kc * 16 + 2 * t;
    qa[kc][0] = q32(r0, d);
    qa[kc][1] = q32(r1, d);
    qa[kc][2] = q32(r0, d + 8);
    qa[kc][3] = q32(r1, d + 8);
  }

  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores, rows g and g + 8
  float l[2] = {0.f, 0.f};              // running sum, this thread's columns only

  for (int j = 0; j < ntiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < ntiles) {
      load_tile(stage ^ 1, (j + 1) * kBN);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = &ks[stage][nt * 8 + g][2 * t];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kc * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kc * 16 + 8);
        mma_bf16(s[nt], qa[kc], b0, b1);
      }
    }
    const int kv0 = j * kBN;
    if (kv0 + kBN > S) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + nt * 8 + 2 * t + (e & 1) >= S) s[nt][e] = -INFINITY;
    }

    // Online softmax: new row max over the quad of threads sharing a row.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);  // 0 on the first tile
      m[r] = mx[r];
    }

    // P = exp(scale (S - m)), as bf16 A fragments of 16 keys each.
    uint32_t pa[4][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = exp2f((s[nt][0] - m[0]) * scale_log2);
      const float p1 = exp2f((s[nt][1] - m[0]) * scale_log2);
      const float p2 = exp2f((s[nt][2] - m[1]) * scale_log2);
      const float p3 = exp2f((s[nt][3] - m[1]) * scale_log2);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V: per 16 keys, ldmatrix.trans gives V's B fragments for 16 d.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &vs[stage][kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8][dp * 16 + (lane >> 4) * 8]);
        mma_bf16(o[2 * dp], pa[kc], vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa[kc], vb[2], vb[3]);
      }
    }
    __syncthreads();  // the next iteration's load overwrites this stage's partner
  }

  // Full row sums, then out = O / l in f32, stored as bf16 into [B, S, H*64].
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const long long row_stride = static_cast<long long>(H) * kD;
  __nv_bfloat16* out0 = out + (static_cast<long long>(b) * S + r0) * row_stride + h * kD + 2 * t;
  __nv_bfloat16* out1 = out0 + 8 * row_stride;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out0 + dt * 8) = pack_bf16(o[dt][0] / l[0], o[dt][1] / l[0]);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(out1 + dt * 8) = pack_bf16(o[dt][2] / l[1], o[dt][3] / l[1]);
  }
}

}  // namespace

// strides: q's (batch, sequence, head) element strides, then k's, then v's.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, const long long* strides,
                                       int B, int S, int H, float scale, void* out, void* stream) {
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8]};
  const dim3 grid((S + kBM - 1) / kBM, H, B);
  flash_attention_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), st, S, H, scale * 1.4426950408889634f,
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
