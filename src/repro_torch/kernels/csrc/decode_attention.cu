// Flash-decode attention for Hopper (sm_90a): one query token per
// (batch, KV head) against the model-layout KV cache.
//
// Replaces: src/repro/kernels/decode_attention.py:decode_attention_pallas
// (the TPU kernel behind ops.decode_attention) — the paper's HPU
// operation, run in every layer of every decode step.
//
// What bounds it on the H100: bytes.  Each step reads K and V of every
// live position once, 2 * sum_b min(len_b, S) * Hkv * D * 2 bytes in
// bf16, against ~2 * G flops per byte (G = 4 for llama3.2-1b): far below
// the ~295 flop/byte at which the tensor cores would be the limit.
//
// Design:
//  * one CTA of 128 threads per (kv head, batch row); the G query heads
//    of the GQA group are the rows of the tile, so each K/V row loaded
//    from device memory serves all G queries;
//  * the cache is read in its model layout (B, S, Hkv, D) through its
//    batch and sequence strides: no transpose and no padding of S, which
//    on the card would copy the whole cache in every layer of every step;
//  * the loop over S runs inside the CTA (the TPU's sequential grid axis)
//    and stops at min(lengths[b], S); the ragged last tile is masked here;
//  * K/V tiles stream through shared memory with 16-byte coalesced loads;
//    the running max, denominator and G x D accumulator stay in f32, with
//    the reference's max(l, 1e-30) guard (an empty row gives 0).
// Not yet done (later work): splitting S across CTAs with a log-sum-exp
// combine (B * Hkv = 128 CTAs at 16 slots is under the card's 132 SMs),
// and cp.async/TMA double buffering of the tiles.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 128;
constexpr int MAX_G = 8;
constexpr int MAX_D = 128;
constexpr int MAX_T = 64;                    // positions per tile (D <= 64)
constexpr int ACC_PER_THREAD = MAX_G * MAX_D / THREADS;

// TQ: query/output type, TKV: cache type (f32 activations may read a bf16
// cache, as the reference engine does in float32 mode).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v, const int* __restrict__ lengths,
                        TQ* __restrict__ out, int S, int Hkv, int G, int D,
                        long long k_sb, long long k_ss, long long v_sb,
                        long long v_ss, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int TS = D <= 64 ? MAX_T : MAX_T / 2;  // tile positions, TS * D <= 4096
  const int KS = D + 1;                        // padded K row: no bank conflicts
  constexpr int VN = Vec<TKV>::N;
  const int row_chunks = D / VN;

  __shared__ float q_s[MAX_G * MAX_D];
  __shared__ float k_s[MAX_T * (64 + 1)];      // >= TS * (D + 1) for every D <= 128
  __shared__ float v_s[MAX_T * 64];
  __shared__ float p_s[MAX_G * MAX_T];
  __shared__ float m_s[MAX_G], l_s[MAX_G], c_s[MAX_G];

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);     // clamp: idle slots may run past S

  const long long q_base = ((long long)b * Hkv + h) * G * D;  // q is (B, Hkv*G, D)
  for (int i = tid; i < G * D; i += THREADS) q_s[i] = to_float(q[q_base + i]);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[ACC_PER_THREAD];
#pragma unroll
  for (int j = 0; j < ACC_PER_THREAD; ++j) acc[j] = 0.f;

  const TKV* kb = k + (long long)b * k_sb + (long long)h * D;
  const TKV* vb = v + (long long)b * v_sb + (long long)h * D;

  for (int t0 = 0; t0 < len; t0 += TS) {
    const int n = min(TS, len - t0);
    __syncthreads();                           // previous tile fully consumed
    for (int c = tid; c < n * row_chunks; c += THREADS) {
      const int r = c / row_chunks;
      const int d0 = (c % row_chunks) * VN;
      float f[VN];
      load16(kb + (long long)(t0 + r) * k_ss + d0, f);
#pragma unroll
      for (int e = 0; e < VN; ++e) k_s[r * KS + d0 + e] = f[e];
      load16(vb + (long long)(t0 + r) * v_ss + d0, f);
#pragma unroll
      for (int e = 0; e < VN; ++e) v_s[r * D + d0 + e] = f[e];
    }
    __syncthreads();
    // scores (G x TS): rows are the GQA group, columns the tile's positions
    for (int i = tid; i < G * TS; i += THREADS) {
      const int g = i / TS;
      const int s = i - g * TS;
      float a = NEG_INF;
      if (s < n) {
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += q_s[g * D + d] * k_s[s * KS + d];
        a = dot * scale;
      }
      p_s[i] = a;
    }
    __syncthreads();
    // online softmax, one warp per group row
    for (int g = warp; g < G; g += THREADS / 32) {
      float mx = NEG_INF;
      for (int s = lane; s < TS; s += 32) mx = fmaxf(mx, p_s[g * TS + s]);
      mx = warp_max(mx, 32);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = lane; s < TS; s += 32) {
        const float e = s < n ? expf(p_s[g * TS + s] - m_new) : 0.f;
        p_s[g * TS + s] = e;
        sum += e;
      }
      sum = warp_sum(sum, 32);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    // acc (G x D) = acc * corr + P (G x n) @ V (n x D)
#pragma unroll
    for (int j = 0; j < ACC_PER_THREAD; ++j) {
      const int e = tid + j * THREADS;
      if (e < G * D) {
        const int g = e / D;
        const int d = e - g * D;
        float a = acc[j] * c_s[g];
        for (int s = 0; s < n; ++s) a += p_s[g * TS + s] * v_s[s * D + d];
        acc[j] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ACC_PER_THREAD; ++j) {
    const int e = tid + j * THREADS;
    if (e < G * D) {
      const int g = e / D;
      out[q_base + e] = from_float<TQ>(acc[j] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
           int B, int S, int Hkv, int G, int D, long long k_sb, long long k_ss,
           long long v_sb, long long v_ss, float scale, cudaStream_t st) {
  if (D % Vec<TKV>::N) return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B);
  decode_attention_kernel<TQ, TKV><<<grid, THREADS, 0, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int*>(lengths), static_cast<TQ*>(out), S, Hkv, G, D, k_sb, k_ss,
      v_sb, v_ss, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hkv*G, D) contiguous; k/v (B, S, Hkv, D) with unit stride in D and
// stride D between heads, batch/sequence strides given in elements;
// lengths (B,) int32; out (B, Hkv*G, D) contiguous, of q's type.  Launches
// on `stream` and returns cudaGetLastError().
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, int B, int S,
                                       int Hkv, int G, int D, long long k_sb,
                                       long long k_ss, long long v_sb, long long v_ss,
                                       float scale, int q_dtype, int kv_dtype,
                                       void* stream) {
  if (G < 1 || G > MAX_G || D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(TQ, TKV) \
  launch<TQ, TKV>(q, k, v, lengths, out, B, S, Hkv, G, D, k_sb, k_ss, v_sb, v_ss, scale, st)
  if (q_dtype == BF16 && kv_dtype == BF16) return REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == F32 && kv_dtype == BF16) return REPRO_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == F32 && kv_dtype == F32) return REPRO_LAUNCH(float, float);
  if (q_dtype == BF16 && kv_dtype == F32) return REPRO_LAUNCH(__nv_bfloat16, float);
#undef REPRO_LAUNCH
  return (int)cudaErrorInvalidValue;
}
