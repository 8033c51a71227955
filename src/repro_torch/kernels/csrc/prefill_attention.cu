// Causal flash attention for Hopper (sm_90a): the prefill path.
//
// Replaces: src/repro/kernels/prefill_attention.py:flash_attention_pallas
// (the TPU kernel behind ops.flash_attention), run in every layer of
// every prefill.
//
// What bounds it on the H100: operations.  A causal prompt of length S
// does ~2 * S^2 * Hq * D flops of QK^T and PV against ~(Hq + 2 Hkv) * S * D
// * 2 bytes, hundreds of flops per byte at prompt lengths in the hundreds.
// This first version computes in f32 FMA on the CUDA cores (67 TFLOP/s
// peak), not on the tensor cores: chosen because it is simple to get right.
// mma.sync/wgmma bf16 is the next step for speed.
//
// Design:
//  * one CTA of 128 threads per (64-row query tile, query head, batch);
//    a loop over 64-key tiles inside the CTA takes the place of the TPU's
//    sequential grid axis, carrying the online-softmax state in registers
//    (f32 max, denominator and accumulator per row);
//  * GQA by indexing kv head h / G: no copy of K/V per query head;
//  * q_offset is a runtime argument placing q[0] at an absolute position;
//    with causal masking the key loop stops after the tile holding key
//    q_offset + last query row, so fully-future tiles are never loaded;
//  * the ragged edges of Sq and Sk are masked here (any length works; the
//    TPU wrapper instead halves its blocks until they divide Sq and Sk);
//  * a row with no visible key gives 0, not NaN (max(l, 1e-30) guard);
//  * templated on the query/output type and the K/V type: the chunked
//    prefill of the reference's float32 mode attends f32 queries against
//    the bf16 cache;
//  * int8/fp8 K/V (the TPU kernel's `quantized` variant): K/V are 1-byte
//    payloads with f32 scales k_scale/v_scale in the model layout
//    (B, Sk, Hkv), read through their strides (no transposed copy).  Each
//    K/V row is widened to f32 and multiplied by its scale right after
//    its load, before the shared-memory store, as the TPU kernel
//    dequantizes right after its VMEM load; everything after the load is
//    the unscaled kernel's.  Unscaled calls pass null scales and run the
//    unscaled template unchanged;
//  * Q, K, V tiles and the probability tile live in shared memory as f32,
//    rows padded by one word against bank conflicts.  Each thread owns a
//    4 x 8 block of scores and a 4 x D/8 block of the output.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 128;
constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 64;           // keys per tile
constexpr int MAX_D = 128;
constexpr int RQ = 4;            // query rows per thread
constexpr int CK = 8;            // key columns per thread (tx + 8 * j)
constexpr int MAX_DC = MAX_D / 8;  // output columns per thread

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) +
                          (size_t)BK * D + (size_t)BQ * (BK + 1));
}

// TQ: query/output type, TKV: key/value type (a 1-byte TKV is a quantized
// payload read with k_scale/v_scale; scale of key s of kv head h of batch b
// at b * ss_b + s * ss_s + h * ss_h).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                     const TKV* __restrict__ v, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, long long ss_b, long long ss_s,
                     long long ss_h, TQ* __restrict__ out, int Sq, int Sk, int Hq, int Hkv,
                     int D, int q_offset, int causal, float scale) {
  extern __shared__ float smem[];
  const int QS = D + 1;
  const int PS = BK + 1;
  float* q_s = smem;                 // BQ x QS
  float* k_s = q_s + BQ * QS;        // BK x QS
  float* v_s = k_s + BK * QS;        // BK x D
  float* p_s = v_s + BK * D;         // BQ x PS

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 7;            // key / output column group
  const int ty = tid >> 3;           // rows ty*4 .. ty*4+3
  constexpr int VQ = Vec<TQ>::N;
  constexpr int VN = Vec<TKV>::N;
  const int q_chunks = D / VQ;
  const int row_chunks = D / VN;
  const int DC = D / 8;

  // Q tile (rows past Sq are zero and fully masked below)
  for (int c = tid; c < BQ * q_chunks; c += THREADS) {
    const int r = c / q_chunks;
    const int d0 = (c % q_chunks) * VQ;
    float f[VQ];
    if (q0 + r < Sq) {
      load16(q + (((long long)b * Sq + q0 + r) * Hq + h) * D + d0, f);
    } else {
#pragma unroll
      for (int e = 0; e < VQ; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VQ; ++e) q_s[r * QS + d0 + e] = f[e];
  }

  float m[RQ], l[RQ], o[RQ][MAX_DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < MAX_DC; ++dd) o[i][dd] = 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_offset + q_last + 1) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                         // previous tile consumed, Q visible
    for (int c = tid; c < BK * row_chunks; c += THREADS) {
      const int r = c / row_chunks;
      const int d0 = (c % row_chunks) * VN;
      float fk[VN], fv[VN];
      if (k0 + r < Sk) {
        const long long off = (((long long)b * Sk + k0 + r) * Hkv + hk) * D + d0;
        load16(k + off, fk);
        load16(v + off, fv);
        if constexpr (Quantized<TKV>::value) {    // dequantize right after the load
          const long long at = b * ss_b + (long long)(k0 + r) * ss_s + hk * ss_h;
          const float ks = k_scale[at], vs = v_scale[at];
#pragma unroll
          for (int e = 0; e < VN; ++e) {
            fk[e] *= ks;
            fv[e] *= vs;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) fk[e] = fv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        k_s[r * QS + d0 + e] = fk[e];
        v_s[r * D + d0 + e] = fv[e];
      }
    }
    __syncthreads();

    // S (4 x 8 per thread) = Q K^T
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[RQ], kb[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qa[i] = q_s[(ty * RQ + i) * QS + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kb[j] = k_s[(tx + 8 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] += qa[i] * kb[j];
    }

    // mask, online softmax per row (the 8 threads of a row are adjacent lanes)
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
      const int q_pos = q_offset + q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kp = k0 + tx + 8 * j;
        const bool ok = kp < Sk && q0 + r < Sq && (!causal || q_pos >= kp);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = warp_max(mx, 8);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = s[i][j] > 0.5f * NEG_INF ? expf(s[i][j] - m_new) : 0.f;
        p_s[r * PS + tx + 8 * j] = p;
        sum += p;
      }
      sum = warp_sum(sum, 8);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < MAX_DC; ++dd) o[i][dd] *= corr;
    }
    __syncthreads();

    // O (4 x D/8 per thread) += P V
    const int n = min(BK, Sk - k0);
    for (int c = 0; c < n; ++c) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = p_s[(ty * RQ + i) * PS + c];
#pragma unroll
      for (int dd = 0; dd < MAX_DC; ++dd) {
        if (dd < DC) {
          const float vb = v_s[c * D + tx + 8 * dd];
#pragma unroll
          for (int i = 0; i < RQ; ++i) o[i][dd] += pv[i] * vb;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty * RQ + i;
    if (r < Sq) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      TQ* orow = out + (((long long)b * Sq + r) * Hq + h) * D;
#pragma unroll
      for (int dd = 0; dd < MAX_DC; ++dd)
        if (dd < DC) orow[tx + 8 * dd] = from_float<TQ>(o[i][dd] * inv);
    }
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, long long ss_b, long long ss_s, long long ss_h, void* out,
           int B, int Sq, int Sk, int Hq, int Hkv, int D, int q_offset, int causal,
           float scale, cudaStream_t st) {
  if (D % Vec<TQ>::N || D % Vec<TKV>::N) return (int)cudaErrorInvalidValue;
  // scales exactly when K/V are quantized
  if (Quantized<TKV>::value != (k_scale != nullptr) || (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<TQ, TKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_prefill_kernel<TQ, TKV><<<grid, THREADS, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), ss_b, ss_s,
      ss_h, static_cast<TQ*>(out), Sq, Sk, Hq, Hkv, D, q_offset, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), out (B, Sq, Hq, D) of q's type, all
// contiguous (the model layout).  k_scale/v_scale: f32 (B, Sk, Hkv) with
// element strides ss_b, ss_s, ss_h (the same for both) for int8/fp8 K/V,
// else null.  Launches on `stream`, returns cudaGetLastError().
extern "C" int prefill_attention_launch(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        long long ss_b, long long ss_s, long long ss_h,
                                        void* out, int B, int Sq, int Sk, int Hq,
                                        int Hkv, int D, int q_offset, int causal,
                                        float scale, int q_dtype, int kv_dtype,
                                        void* stream) {
  if (D < 8 || D > MAX_D || D % 8 || Hkv < 1 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  if (Sq < 1 || Sk < 1) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(TQ, TKV) \
  launch<TQ, TKV>(q, k, v, k_scale, v_scale, ss_b, ss_s, ss_h, out, B, Sq, Sk, Hq, Hkv, D, \
                  q_offset, causal, scale, st)
  if (q_dtype == BF16 && kv_dtype == BF16) return REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == F32 && kv_dtype == BF16) return REPRO_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == F32 && kv_dtype == F32) return REPRO_LAUNCH(float, float);
  if (q_dtype == BF16 && kv_dtype == F32) return REPRO_LAUNCH(__nv_bfloat16, float);
  if (q_dtype == BF16 && kv_dtype == FP8_E4M3) return REPRO_LAUNCH(__nv_bfloat16, __nv_fp8_e4m3);
  if (q_dtype == F32 && kv_dtype == FP8_E4M3) return REPRO_LAUNCH(float, __nv_fp8_e4m3);
  if (q_dtype == BF16 && kv_dtype == INT8) return REPRO_LAUNCH(__nv_bfloat16, int8_t);
  if (q_dtype == F32 && kv_dtype == INT8) return REPRO_LAUNCH(float, int8_t);
#undef REPRO_LAUNCH
  return (int)cudaErrorInvalidValue;
}
