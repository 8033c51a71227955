// Paged flash-decode attention for Hopper (sm_90a): one query token per
// (batch, KV head) against a pool of fixed-size KV blocks reached through
// per-sequence block tables.
//
// Replaces: src/repro/kernels/paged_decode_attention.py:
// paged_decode_attention_pallas (the TPU kernel behind
// ops.paged_decode_attention) — the decode attention of the paged cache,
// run in every layer of every decode step of `--cache paged`.
//
// What bounds it on the H100: bytes.  Each call reads K and V of every
// live position once, 2 * sum_b (min(len_b, MB*bs) - start_b) * Hkv * D
// * 2 bytes in bf16 (1 byte in fp8/int8, plus one f32 scale per vector),
// plus the tables, against ~2 * G flops per byte (G = 4 for
// llama3.2-1b): far below the ~295 flop/byte where the tensor cores
// would be the limit.
//
// Design:
//  * one CTA of 128 threads per (kv head, batch row); the G query heads
//    of the GQA group are the rows of the tile, so each K/V row loaded
//    from device memory serves all G queries;
//  * the pool is kernel-native, (N, Hkv, bs, D): one head's bs x D tile of
//    a physical block is contiguous.  A tile of the loop covers TS logical
//    positions; each row's physical address comes from tables[b, p / bs]
//    (read once per row from global memory, it stays in L1), so any block
//    size works and rows stream with 16-byte coalesced loads;
//  * the loop starts at the block holding starts[b] (blocks wholly below
//    it are skipped) and stops at min(lengths[b], MB * bs), so idle slots
//    whose lengths ran past the table and the null block's garbage beyond
//    lengths[b] are never read; positions below starts[b] are masked;
//  * fp8-e4m3 and int8 pools (tiered KV) come with f32 scale pools
//    (N, Hkv, bs), one scale per stored (head, position) vector.  As in
//    the TPU kernel, a tile is dequantized right after its load: each
//    row's two scales go to shared memory once per tile, and the row's
//    payload is widened to f32 and multiplied by its scale before the
//    shared-memory store, so K and V stream at 1 byte per element and
//    the rest of the kernel is the bf16 kernel's.  A zero vector has
//    payload 0 and scale 0 and dequantizes to exactly 0;
//  * the running max, denominator and G x D accumulator stay in f32, with
//    the reference's max(l, 1e-30) guard: an empty window gives output 0
//    and lse = m + log(1e-30) <= -1e30, never NaN.  The lse is written
//    when the caller passes a buffer for it.
// Not yet done (later work): splitting the sequence across CTAs with a
// log-sum-exp combine (B * Hkv = 128 CTAs at 16 slots is under the card's
// 132 SMs), and cp.async/TMA prefetch of the next blocks driven by the
// row's table held in shared memory.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 128;
constexpr int MAX_G = 8;
constexpr int MAX_D = 128;
constexpr int MAX_BS = 64;
constexpr int MAX_T = 64;                    // positions per tile (D <= 64)
constexpr int ACC_PER_THREAD = MAX_G * MAX_D / THREADS;

// TQ: query/output type, TKV: pool type (f32 activations may read a bf16
// pool, as the reference engine does in float32 mode; a 1-byte TKV is a
// quantized pool read with k_scale/v_scale).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
paged_decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                              const TKV* __restrict__ v,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ tables,
                              const int* __restrict__ lengths,
                              const int* __restrict__ starts, TQ* __restrict__ out,
                              float* __restrict__ lse, int MB, int Hkv, int bs, int G,
                              int D, float scale) {
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
  __shared__ float ks_s[MAX_T], vs_s[MAX_T];   // the tile rows' scales (quantized)

  const int cap = MB * bs;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > cap ? cap : len);  // idle slots may run past the table
  int start = starts == nullptr ? 0 : starts[b];
  start = start < 0 ? 0 : start;
  const int first = (start / bs) * bs;         // skip blocks wholly below start

  const long long q_base = ((long long)b * Hkv + h) * G * D;  // q is (B, Hkv*G, D)
  for (int i = tid; i < G * D; i += THREADS) q_s[i] = to_float(q[q_base + i]);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[ACC_PER_THREAD];
#pragma unroll
  for (int j = 0; j < ACC_PER_THREAD; ++j) acc[j] = 0.f;

  const int* table = tables + (long long)b * MB;
  const long long head_off = (long long)h * bs * D;          // within one block
  const long long block_stride = (long long)Hkv * bs * D;

  for (int t0 = first; t0 < len; t0 += TS) {
    const int n = min(TS, len - t0);
    __syncthreads();                           // previous tile fully consumed
    if constexpr (Quantized<TKV>::value) {
      for (int r = tid; r < n; r += THREADS) {   // one scale pair per row
        const int p = t0 + r;
        const long long at = ((long long)table[p / bs] * Hkv + h) * bs + p % bs;
        ks_s[r] = k_scale[at];
        vs_s[r] = v_scale[at];
      }
      __syncthreads();
    }
    for (int c = tid; c < n * row_chunks; c += THREADS) {
      const int r = c / row_chunks;
      const int d0 = (c % row_chunks) * VN;
      const int p = t0 + r;
      const long long row = (long long)table[p / bs] * block_stride + head_off +
                            (long long)(p % bs) * D + d0;
      const float ks = Quantized<TKV>::value ? ks_s[r] : 1.f;
      const float vs = Quantized<TKV>::value ? vs_s[r] : 1.f;
      float f[VN];
      load16(k + row, f);
#pragma unroll
      for (int e = 0; e < VN; ++e) k_s[r * KS + d0 + e] = Quantized<TKV>::value ? f[e] * ks : f[e];
      load16(v + row, f);
#pragma unroll
      for (int e = 0; e < VN; ++e) v_s[r * D + d0 + e] = Quantized<TKV>::value ? f[e] * vs : f[e];
    }
    __syncthreads();
    // scores (G x TS): rows are the GQA group, columns the tile's positions
    for (int i = tid; i < G * TS; i += THREADS) {
      const int g = i / TS;
      const int s = i - g * TS;
      float a = NEG_INF;
      if (s < n && t0 + s >= start) {
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
        const bool valid = s < n && t0 + s >= start;
        const float e = valid ? expf(p_s[g * TS + s] - m_new) : 0.f;
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
  if (lse != nullptr && tid < G) {               // lse is (B, Hkv, G)
    lse[((long long)b * Hkv + h) * G + tid] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* tables, const void* lengths,
           const void* starts, void* out, void* lse, int B, int MB, int Hkv, int bs,
           int G, int D, float scale, cudaStream_t st) {
  if (D % Vec<TKV>::N) return (int)cudaErrorInvalidValue;
  // scales exactly when the pool is quantized
  if (Quantized<TKV>::value != (k_scale != nullptr) || (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B);
  paged_decode_attention_kernel<TQ, TKV><<<grid, THREADS, 0, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<const int*>(starts), static_cast<TQ*>(out), static_cast<float*>(lse),
      MB, Hkv, bs, G, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hkv*G, D) contiguous; k/v pools (N, Hkv, bs, D) contiguous;
// k_scale/v_scale (N, Hkv, bs) f32 contiguous for an fp8/int8 pool, else
// null; tables (B, MB) int32 contiguous, entries in [0, N); lengths (B,) int32;
// starts (B,) int32 or null (0); out (B, Hkv*G, D) contiguous, of q's
// type; lse (B, Hkv, G) f32 or null (not written).  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int paged_decode_attention_launch(const void* q, const void* k, const void* v,
                                             const void* k_scale, const void* v_scale,
                                             const void* tables, const void* lengths,
                                             const void* starts, void* out, void* lse,
                                             int B, int MB, int Hkv, int bs, int G, int D,
                                             float scale, int q_dtype, int kv_dtype,
                                             void* stream) {
  if (G < 1 || G > MAX_G || D < 1 || D > MAX_D || bs < 1 || bs > MAX_BS || MB < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(TQ, TKV)                                                          \
  launch<TQ, TKV>(q, k, v, k_scale, v_scale, tables, lengths, starts, out, lse, B, MB, \
                  Hkv, bs, G, D, scale, st)
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
