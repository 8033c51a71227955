// Small device helpers shared by the attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace repro {

constexpr float NEG_INF = -1e30f;   // the reference kernels' mask value

// dtype codes passed from the Python wrappers
enum DType : int { F32 = 0, BF16 = 1, FP8_E4M3 = 2, INT8 = 3 };

// Host side: let `kernel` take `bytes` of dynamic shared memory.  The
// attribute belongs to the function, so it is set once per kernel
// instantiation and raised only when a launch needs more than before;
// `allowed` is the caller's static for that instantiation.  A launch
// then costs no cudaFuncSetAttribute, and a launch under CUDA graph
// capture (after a warm-up call) makes none.  One card per process: the
// attribute is per device.
inline cudaError_t allow_smem(const void* kernel, size_t bytes, std::atomic<size_t>& allowed) {
  if (bytes <= allowed.load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed.store(bytes, std::memory_order_relaxed);
  return err;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
// 1-byte payloads: exact (every e4m3 and int8 value is an f32 value)
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Elements in one 16-byte load.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// 1-byte K/V types are quantized payloads: each stored (head, position)
// vector comes with an f32 scale, value = payload * scale.
template <typename T> struct Quantized { static constexpr bool value = sizeof(T) == 1; };

// One 16-byte load, widened to f32.  The caller guarantees alignment.
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 16 fp8-e4m3fn payloads widened to f32.  The conversion operator is
// exact (every e4m3 value is an f32 value; NaN stays NaN, there is no inf).
__device__ __forceinline__ void load16(const __nv_fp8_e4m3* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_fp8_e4m3* e = reinterpret_cast<const __nv_fp8_e4m3*>(&x);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(e[i]);
}
// 16 int8 payloads widened (sign-extended) to f32.
__device__ __forceinline__ void load16(const int8_t* p, float* f) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&x);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(e[i]);
}

__device__ __forceinline__ float warp_max(float v, int width) {
  for (int o = width / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v, int width) {
  for (int o = width / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Merge n partial softmax states of one output element over disjoint key
// sets: partial i holds its max m_i, its denominator l_i = sum exp(s - m_i)
// and its unnormalized output o_i = sum exp(s - m_i) v.  Returns the merged
// unnormalized output and writes the merged max and denominator; the
// caller divides by max(L, 1e-30), so n empty partials (m = NEG_INF, l = 0,
// o = 0) give 0, not NaN.  m_i and l_i lie `ml_stride` floats apart, o_i
// `o_stride` apart.  The one log-sum-exp combine of the split kernels.
__device__ __forceinline__ float lse_combine(const float* m, const float* l, int ml_stride,
                                             const float* o, int o_stride, int n,
                                             float& M, float& L) {
  M = NEG_INF;
  for (int i = 0; i < n; ++i) M = fmaxf(M, m[i * ml_stride]);
  float O = 0.f;
  L = 0.f;
  for (int i = 0; i < n; ++i) {
    const float w = expf(m[i * ml_stride] - M);
    L += l[i * ml_stride] * w;
    O += o[i * o_stride] * w;
  }
  return O;
}

// Merge the n_split f32 partials of each (b, h) that a split decode kernel
// wrote to ws: o (B, Hkv, n_split, G, D) unnormalized, then (m, l) as
// (B, Hkv, n_split, 2, G); an empty span is m = NEG_INF, l = 0, o = 0.
// Writes out = O / max(L, 1e-30) in TQ and, when lse is not null, lse (B,
// Hkv, G) = M + log(max(L, 1e-30)): a row whose spans are all empty gives
// out 0 and lse <= -1e30, never NaN.  One CTA of COMBINE_THREADS per (KV
// head, batch row).
constexpr int COMBINE_THREADS = 128;
template <typename TQ>
__global__ void __launch_bounds__(COMBINE_THREADS)
span_combine_kernel(const float* __restrict__ ws, TQ* __restrict__ out, float* __restrict__ lse,
                    int Hkv, int G, int D, int n_split) {
  const long long row = (long long)blockIdx.y * Hkv + blockIdx.x;
  const int GD = G * D;
  const float* o = ws + row * n_split * GD;
  const float* ml = ws + (long long)gridDim.y * Hkv * n_split * GD + row * n_split * 2 * G;
  for (int e = threadIdx.x; e < GD; e += COMBINE_THREADS) {
    const int g = e / D;
    float M, L;
    const float O = lse_combine(ml + g, ml + G + g, 2 * G, o + e, GD, n_split, M, L);
    out[row * GD + e] = from_float<TQ>(O / fmaxf(L, 1e-30f));
    if (lse != nullptr && e - g * D == 0) lse[row * G + g] = M + logf(fmaxf(L, 1e-30f));
  }
}

// ---- Ampere/Hopper warp-level building blocks (cp.async, ldmatrix, mma) ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; src_bytes < 16 fills the rest
// with zeros (0: a row past the end becomes zeros, nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.  Register j holds matrix j's element
// (lane / 4, 2 * (lane % 4) + {0, 1}), or its transpose with .trans.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major) on
// the tensor cores.  Fragments (g = lane / 4, t = lane % 4): a {(g, 2t..),
// (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}; b {(k 2t.., n g), (k 2t+8.., n
// g)}; c {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 as one bf16x2 register, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- one warp's flash-attention step on the tensor cores ----------------
// A warp owns 16 query rows against a tile of 64 keys held in shared
// memory as bf16 rows of stride LD (the contraction padded with zeros to
// DP = 16 * KSTEPS, a multiple of 16).  Score and output fragments follow
// mma_bf16_16816's c layout: s[j] covers keys 8j..8j+7, o[dn] columns
// 8dn..8dn+7; a thread holds rows g and g + 8.

// s (16 x 64) = Q K^T; qf: the warp's Q as A fragments, one per k-step.
template <int KSTEPS, int LD>
__device__ __forceinline__ void warp_qk(float s[8][4], const uint32_t (*qf)[4],
                                        const __nv_bfloat16* kt, int lane, int D) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    if (kk * 16 >= D) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {            // key tiles 2j, 2j + 1
      uint32_t bk[4];
      ldmatrix_x4(bk, kt + (j * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16_16816(s[2 * j], qf[kk], bk[0], bk[1]);
      mma_bf16_16816(s[2 * j + 1], qf[kk], bk[2], bk[3]);
    }
  }
}

// Online softmax over one tile.  s holds the scores in the log2 domain,
// NEG_INF where masked; on return it holds p = exp2(s - m) (0 where
// masked), m_r and the quad-partial denominators l_r are updated and o is
// rescaled.  A row's 64 scores lie in one quad: two shuffles per max.
template <int DN>
__device__ __forceinline__ void warp_softmax(float s[8][4], float m_r[2], float l_r[2],
                                             float o[DN][4]) {
  float mx[2] = {NEG_INF, NEG_INF}, corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float mn = fmaxf(m_r[i], mx[i]);
    corr[i] = exp2f(m_r[i] - mn);
    m_r[i] = mn;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = s[j][e] > 0.5f * NEG_INF ? exp2f(s[j][e] - m_r[e >> 1]) : 0.f;
      s[j][e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * corr[i] + rs[i];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    o[dn][0] *= corr[0];
    o[dn][1] *= corr[0];
    o[dn][2] *= corr[1];
    o[dn][3] *= corr[1];
  }
}

// o (16 x DP) += P V, P (in s) rounded to bf16 as the A operand.  HILO:
// P also enters as its bf16 rounding error, a second product, so the sum
// keeps ~16 bits of P (for values of P scaled by a V dequantization scale).
template <int DN, int LD, bool HILO>
__device__ __forceinline__ void warp_pv(float o[DN][4], const float s[8][4],
                                        const __nv_bfloat16* vt, int lane, int D) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {           // 16 keys per k-step
    const float* p0 = s[2 * kk];
    const float* p1 = s[2 * kk + 1];
    const uint32_t pa[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                            pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
    uint32_t pl[4];
    if constexpr (HILO) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pa[i]));
        const float* pp = i < 2 ? p0 : p1;
        const int e = 2 * (i & 1);
        pl[i] = pack_bf16(pp[e] - hi.x, pp[e + 1] - hi.y);
      }
    }
#pragma unroll
    for (int dn = 0; dn < DN / 2; ++dn) {    // output tiles 2dn, 2dn + 1
      if (dn * 16 >= D) break;
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                dn * 16 + (lane >> 4) * 8);
      mma_bf16_16816(o[2 * dn], pa, bv[0], bv[1]);
      mma_bf16_16816(o[2 * dn + 1], pa, bv[2], bv[3]);
      if constexpr (HILO) {
        mma_bf16_16816(o[2 * dn], pl, bv[0], bv[1]);
        mma_bf16_16816(o[2 * dn + 1], pl, bv[2], bv[3]);
      }
    }
  }
}

}  // namespace repro
