// Causal flash attention backward for Hopper (sm_90a): the training path.
//
// Replaces no TPU kernel: the reference has no Pallas backward.  Its train
// step differentiates src/repro/models/attention.py:chunked_attention with
// XLA's autodiff; this computes the same three gradients from what the
// forward kernel (prefill_attention.cu, with its optional lse output)
// saved: q, k, v, o and the row log-sum-exp lse.
//
//   P  = exp(scale * Q K^T - lse)          (causal: key <= query)
//   dV = P^T dO
//   dP = dO V^T,  delta = rowsum(dO * O)
//   dS = P * (dP - delta)
//   dQ = scale * dS K,  dK = scale * dS^T Q
//
// What bounds it on the H100: operations.  At llama3.2-1b's training shape
// (B 8, S 1024, Hq 32, Hkv 8, D 64) the five products of the visible
// (query, key) pairs are ~8.6e10 flop, ~0.087 ms at the bf16 tensor-core
// peak, against ~0.05 ms of traffic at 3.35 TB/s.
//
// Three kernels, one stream, no float atomics (a rerun gives the same
// bits, which the trainer's bit-equal resume relies on):
//  * bwd_delta_kernel: delta (B, Hq, S) f32, one warp per (row, head);
//  * dK/dV: one CTA per (batch, KV head, 64-key block); it loops over the
//    G query heads of its group and over the 64-query blocks at or after
//    its key block, so the group's sum stays inside the CTA;
//  * dQ: one CTA per (batch, query head, 64-query block), looping over the
//    key blocks up to its diagonal.
// bf16 runs on the tensor cores (mma.sync m16n8k16 through the forward's
// warp helpers: a warp owns 16 rows, P and dS are rounded to bf16 as the
// A operand of their products, every sum is f32); f32 (float32 mode) on
// f32 FMA with the forward FMA kernel's 4 x 8 thread tiles.  This first
// design has no pipelining: each tile is loaded with cp.async (or plain
// loads for f32), waited for, and used.  Rows past S are zero-filled and
// masked; masked entries of P are 0, never exp of a mask value, so a
// row's fully masked block gives no NaN.
#include "common.cuh"

namespace {

using namespace repro;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int BLK = 64;                    // queries or keys per tile
constexpr int MAX_D = 128;
constexpr int MAX_G = 8;
constexpr float LOG2E = 1.4426950408889634f;

// ----------------------------------------------------------------- delta
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                 int S, int Hq, int D, long long rows) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;                 // row = (b * S + s) * Hq + h
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_float(o[row * D + d]) * to_float(dout[row * D + d]);
  acc = warp_sum(acc, 32);
  if (lane == 0) {
    const int h = (int)(row % Hq);
    const long long bs = row / Hq;
    delta[(bs / S * Hq + h) * S + bs % S] = acc;
  }
}

// ------------------------------------------------ tensor-core kernels (bf16)
// s (16 x 64) = A B^T with A the warp's 16 rows (stride LD, in shared
// memory) and B a tile of 64 rows: warp_qk with the A fragments loaded per
// k-step instead of held in registers.
template <int KSTEPS, int LD>
__device__ __forceinline__ void warp_abt(float s[8][4], const bf16* a, const bf16* bt, int lane,
                                         int D) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    if (kk * 16 >= D) break;
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bk[4];
      ldmatrix_x4(bk, bt + (j * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16_16816(s[2 * j], af, bk[0], bk[1]);
      mma_bf16_16816(s[2 * j + 1], af, bk[2], bk[3]);
    }
  }
}

// One 64-row tile of head `h` (rows r0.., head stride Hn heads of D) into
// shared memory with 16-byte cp.async; rows past S are zero-filled.
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src, int b, int r0, int h,
                                           int S, int Hn, int D, int LD, int tid) {
  const int dchunks = D / 8;
  for (int c = tid; c < BLK * dchunks; c += THREADS) {
    const int r = c / dchunks, d0 = (c % dchunks) * 8;
    const bool ok = r0 + r < S;
    const long long off = ok ? (((long long)b * S + r0 + r) * Hn + h) * D + d0 : 0;
    cp_async16(dst + r * LD + d0, src + off, ok ? 16 : 0);
  }
}

// lse (as log2) and delta of the 64 query rows q0.. of head h
__device__ __forceinline__ void rows_stats(float* lse_s, float* dl_s, const float* lse,
                                           const float* delta, long long bh, int q0, int S,
                                           int tid) {
  if (tid < BLK) {
    const bool ok = q0 + tid < S;
    lse_s[tid] = ok ? lse[bh * S + q0 + tid] * LOG2E : 0.f;
    dl_s[tid] = ok ? delta[bh * S + q0 + tid] : 0.f;
  }
}

__device__ __forceinline__ void zero_pad(bf16* base, int n_rows, int D, int DP, int LD,
                                         int tid) {
  if (D < DP) {                            // cp.async never writes columns [D, DP)
    const int pad = DP - D;
    for (int i = tid; i < n_rows * pad; i += THREADS)
      base[(i / pad) * LD + D + i % pad] = __float2bfloat16(0.f);
  }
}

template <int DN>
__device__ __forceinline__ void store_rows(bf16* dst, const float (*acc)[4], float mul, int b,
                                           int row0, int h, int S, int Hn, int D, int gid,
                                           int tig) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + gid + 8 * i;
    if (r >= S) continue;
    bf16* out = dst + (((long long)b * S + r) * Hn + h) * D;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const int d = dn * 8 + tig * 2;
      if (d < D)
        *reinterpret_cast<uint32_t*>(out + d) =
            pack_bf16(acc[dn][2 * i] * mul, acc[dn][2 * i + 1] * mul);
    }
  }
}

template <int DP>
size_t mma_smem_bytes() {
  return sizeof(bf16) * 4 * BLK * (DP + 8) + sizeof(float) * 2 * BLK;
}

// dK, dV of 64 keys of KV head hk: the warp's 16 keys are the A rows.
template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int Hq, int Hkv,
                          int D, float scale) {
  constexpr int LD = DP + 8, KSTEPS = DP / 16, DN = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);   // 4 tiles of BLK x LD
  bf16* v_s = k_s + BLK * LD;
  bf16* q_s = v_s + BLK * LD;
  bf16* do_s = q_s + BLK * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + BLK * LD);
  float* dl_s = lse_s + BLK;
  const int G = Hq / Hkv;
  const int k0 = blockIdx.x * BLK, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int key_lo = k0 + warp * 16;
  const float sl2 = scale * LOG2E;

  zero_pad(k_s, 4 * BLK, D, DP, LD, tid);
  tile_async(k_s, k, b, k0, hk, S, Hkv, D, LD, tid);
  tile_async(v_s, v, b, k0, hk, S, Hkv, D, LD, tid);
  cp_async_commit();

  float dk_acc[DN][4], dv_acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dn][e] = dv_acc[dn][e] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = k0; q0 < S; q0 += BLK) {
      __syncthreads();                     // the previous Q/dO tiles are consumed
      tile_async(q_s, q, b, q0, h, S, Hq, D, LD, tid);
      tile_async(do_s, dout, b, q0, h, S, Hq, D, LD, tid);
      cp_async_commit();
      rows_stats(lse_s, dl_s, lse, delta, (long long)b * Hq + h, q0, S, tid);
      cp_async_wait<0>();
      __syncthreads();

      float p[8][4];                       // P^T: 16 keys x 64 queries
      warp_abt<KSTEPS, LD>(p, k_s + warp * 16 * LD, q_s, lane, D);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + tig * 2 + (e & 1), qp = q0 + c;
          const bool ok = qp < S && qp >= key_lo + gid + 8 * (e >> 1);
          p[j][e] = ok ? exp2f(p[j][e] * sl2 - lse_s[c]) : 0.f;
        }
      warp_pv<DN, LD, false>(dv_acc, p, do_s, lane, D);        // dV += P^T dO
      float ds[8][4];                      // dP^T = V dO^T, then dS^T
      warp_abt<KSTEPS, LD>(ds, v_s + warp * 16 * LD, do_s, lane, D);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - dl_s[j * 8 + tig * 2 + (e & 1)]);
      warp_pv<DN, LD, false>(dk_acc, ds, q_s, lane, D);        // dK += dS^T Q
    }
  }
  store_rows<DN>(dk, dk_acc, scale, b, key_lo, hk, S, Hkv, D, gid, tig);
  store_rows<DN>(dv, dv_acc, 1.f, b, key_lo, hk, S, Hkv, D, gid, tig);
}

// dQ of 64 queries of head h: the warp's 16 queries are the A rows.
template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int S, int Hq, int Hkv, int D, float scale) {
  constexpr int LD = DP + 8, KSTEPS = DP / 16, DN = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + BLK * LD;
  bf16* k_s = do_s + BLK * LD;
  bf16* v_s = k_s + BLK * LD;
  float* lse_s = reinterpret_cast<float*>(v_s + BLK * LD);
  float* dl_s = lse_s + BLK;
  const int q0 = blockIdx.x * BLK, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int row_lo = q0 + warp * 16;
  const float sl2 = scale * LOG2E;

  zero_pad(q_s, 4 * BLK, D, DP, LD, tid);
  tile_async(q_s, q, b, q0, h, S, Hq, D, LD, tid);
  tile_async(do_s, dout, b, q0, h, S, Hq, D, LD, tid);
  cp_async_commit();
  rows_stats(lse_s, dl_s, lse, delta, (long long)b * Hq + h, q0, S, tid);

  float dq_acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) dq_acc[dn][0] = dq_acc[dn][1] = dq_acc[dn][2] = dq_acc[dn][3] = 0.f;

  const int k_end = min(S, q0 + BLK);
  for (int kk0 = 0; kk0 < k_end; kk0 += BLK) {
    __syncthreads();                       // the previous K/V tiles are consumed
    tile_async(k_s, k, b, kk0, hk, S, Hkv, D, LD, tid);
    tile_async(v_s, v, b, kk0, hk, S, Hkv, D, LD, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float p[8][4];                         // P: 16 queries x 64 keys
    warp_abt<KSTEPS, LD>(p, q_s + warp * 16 * LD, k_s, lane, D);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp * 16 + gid + 8 * (e >> 1), qp = q0 + r;
        const bool ok = qp < S && kk0 + j * 8 + tig * 2 + (e & 1) <= qp;
        p[j][e] = ok ? exp2f(p[j][e] * sl2 - lse_s[r]) : 0.f;
      }
    float ds[8][4];                        // dP = dO V^T, then dS
    warp_abt<KSTEPS, LD>(ds, do_s + warp * 16 * LD, v_s, lane, D);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - dl_s[warp * 16 + gid + 8 * (e >> 1)]);
    warp_pv<DN, LD, false>(dq_acc, ds, k_s, lane, D);          // dQ += dS K
  }
  store_rows<DN>(dq, dq_acc, scale, b, row_lo, h, S, Hq, D, gid, tig);
}

// ---------------------------------------------------- f32 FMA kernels (f32)
constexpr int RQ = 4;                      // tile rows per thread (ty * 4 + i)
constexpr int CK = 8;                      // tile columns per thread (tx + 8 * j)
constexpr int MAX_DC = MAX_D / 8;          // output columns per thread

size_t fma_smem_bytes(int D) {
  return sizeof(float) * (4 * (size_t)BLK * (D + 1) + 2 * (size_t)BLK * (BLK + 1));
}

// One 64-row f32 tile of head h into shared memory (row stride D + 1).
__device__ __forceinline__ void tile_f32(float* dst, const float* src, int b, int r0, int h,
                                         int S, int Hn, int D, int tid) {
  const int QS = D + 1, chunks = D / 4;
  for (int c = tid; c < BLK * chunks; c += THREADS) {
    const int r = c / chunks, d0 = (c % chunks) * 4;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < S) load16(src + (((long long)b * S + r0 + r) * Hn + h) * D + d0, f);
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[r * QS + d0 + e] = f[e];
  }
}

// a (4 x 8 per thread) = A B^T and c = C E^T over the tiles' D columns
__device__ __forceinline__ void fma_two_products(float a[RQ][CK], float c[RQ][CK],
                                                 const float* A, const float* Bt,
                                                 const float* C, const float* Et, int D,
                                                 int tx, int ty) {
  const int QS = D + 1;
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) a[i][j] = c[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float ra[RQ], rc[RQ], rb[CK], re[CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      ra[i] = A[(ty * RQ + i) * QS + d];
      rc[i] = C[(ty * RQ + i) * QS + d];
    }
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      rb[j] = Bt[(tx + 8 * j) * QS + d];
      re[j] = Et[(tx + 8 * j) * QS + d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        a[i][j] += ra[i] * rb[j];
        c[i][j] += rc[i] * re[j];
      }
  }
}

// acc (4 x D/8 per thread) += P (64 x 64, stride BLK + 1) X (64 x D, stride D + 1)
__device__ __forceinline__ void fma_px(float acc[RQ][MAX_DC], const float* P, const float* X,
                                       int D, int tx, int ty) {
  const int QS = D + 1, PS = BLK + 1, DC = D / 8;
  for (int c = 0; c < BLK; ++c) {
    float pv[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) pv[i] = P[(ty * RQ + i) * PS + c];
#pragma unroll
    for (int dd = 0; dd < MAX_DC; ++dd)
      if (dd < DC) {
        const float x = X[c * QS + tx + 8 * dd];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][dd] += pv[i] * x;
      }
  }
}

__device__ __forceinline__ void store_f32(float* dst, const float acc[RQ][MAX_DC], float mul,
                                          int b, int r0, int h, int S, int Hn, int D, int tx,
                                          int ty) {
  const int DC = D / 8;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = r0 + ty * RQ + i;
    if (r >= S) continue;
    float* out = dst + (((long long)b * S + r) * Hn + h) * D;
#pragma unroll
    for (int dd = 0; dd < MAX_DC; ++dd)
      if (dd < DC) out[tx + 8 * dd] = acc[i][dd] * mul;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int S, int Hq, int Hkv,
                          int D, float scale) {
  extern __shared__ float smem[];
  const int QS = D + 1, PS = BLK + 1;
  float* k_s = smem;
  float* v_s = k_s + BLK * QS;
  float* q_s = v_s + BLK * QS;
  float* do_s = q_s + BLK * QS;
  float* p_s = do_s + BLK * QS;            // P^T and dS^T, BLK x PS each
  float* ds_s = p_s + BLK * PS;
  __shared__ float lse_s[BLK], dl_s[BLK];
  const int G = Hq / Hkv;
  const int k0 = blockIdx.x * BLK, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;

  tile_f32(k_s, k, b, k0, hk, S, Hkv, D, tid);
  tile_f32(v_s, v, b, k0, hk, S, Hkv, D, tid);
  float acc_k[RQ][MAX_DC], acc_v[RQ][MAX_DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int dd = 0; dd < MAX_DC; ++dd) acc_k[i][dd] = acc_v[i][dd] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = k0; q0 < S; q0 += BLK) {
      __syncthreads();
      tile_f32(q_s, q, b, q0, h, S, Hq, D, tid);
      tile_f32(do_s, dout, b, q0, h, S, Hq, D, tid);
      if (tid < BLK) {
        const bool ok = q0 + tid < S;
        lse_s[tid] = ok ? lse[((long long)b * Hq + h) * S + q0 + tid] : 0.f;
        dl_s[tid] = ok ? delta[((long long)b * Hq + h) * S + q0 + tid] : 0.f;
      }
      __syncthreads();
      float st[RQ][CK], dpt[RQ][CK];       // key rows x query columns
      fma_two_products(st, dpt, k_s, q_s, v_s, do_s, D, tx, ty);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          const int r = ty * RQ + i, c = tx + 8 * j, qp = q0 + c;
          const bool ok = qp < S && qp >= k0 + r;
          const float p = ok ? expf(st[i][j] * scale - lse_s[c]) : 0.f;
          p_s[r * PS + c] = p;
          ds_s[r * PS + c] = p * (dpt[i][j] - dl_s[c]);
        }
      __syncthreads();
      fma_px(acc_v, p_s, do_s, D, tx, ty);
      fma_px(acc_k, ds_s, q_s, D, tx, ty);
    }
  }
  store_f32(dk, acc_k, scale, b, k0, hk, S, Hkv, D, tx, ty);
  store_f32(dv, acc_v, 1.f, b, k0, hk, S, Hkv, D, tx, ty);
}

__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int Hq, int Hkv, int D, float scale) {
  extern __shared__ float smem[];
  const int QS = D + 1, PS = BLK + 1;
  float* q_s = smem;
  float* do_s = q_s + BLK * QS;
  float* k_s = do_s + BLK * QS;
  float* v_s = k_s + BLK * QS;
  float* ds_s = v_s + BLK * QS;
  const int q0 = blockIdx.x * BLK, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;

  tile_f32(q_s, q, b, q0, h, S, Hq, D, tid);
  tile_f32(do_s, dout, b, q0, h, S, Hq, D, tid);
  float lse_r[RQ], dl_r[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty * RQ + i;
    lse_r[i] = qp < S ? lse[((long long)b * Hq + h) * S + qp] : 0.f;
    dl_r[i] = qp < S ? delta[((long long)b * Hq + h) * S + qp] : 0.f;
  }
  float acc[RQ][MAX_DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int dd = 0; dd < MAX_DC; ++dd) acc[i][dd] = 0.f;

  const int k_end = min(S, q0 + BLK);
  for (int kk0 = 0; kk0 < k_end; kk0 += BLK) {
    __syncthreads();
    tile_f32(k_s, k, b, kk0, hk, S, Hkv, D, tid);
    tile_f32(v_s, v, b, kk0, hk, S, Hkv, D, tid);
    __syncthreads();
    float s[RQ][CK], dp[RQ][CK];           // query rows x key columns
    fma_two_products(s, dp, q_s, k_s, do_s, v_s, D, tx, ty);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int r = ty * RQ + i, c = tx + 8 * j, qp = q0 + r;
        const bool ok = qp < S && kk0 + c <= qp;
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds_s[r * PS + c] = p * (dp[i][j] - dl_r[i]);
      }
    __syncthreads();
    fma_px(acc, ds_s, k_s, D, tx, ty);
  }
  store_f32(dq, acc, scale, b, q0, h, S, Hq, D, tx, ty);
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dq, void* dk, void* dv, int B, int S, int Hq, int Hkv,
               int D, float scale, cudaStream_t st) {
  const size_t smem = mma_smem_bytes<DP>();
  static std::atomic<size_t> allowed_kv{0}, allowed_q{0};
  cudaError_t err = allow_smem((const void*)flash_bwd_dkdv_mma_kernel<DP>, smem, allowed_kv);
  if (err == cudaSuccess)
    err = allow_smem((const void*)flash_bwd_dq_mma_kernel<DP>, smem, allowed_q);
  if (err != cudaSuccess) return (int)err;
  const int nb = (S + BLK - 1) / BLK;
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* db = static_cast<const bf16*>(dout);
  flash_bwd_dkdv_mma_kernel<DP><<<dim3(nb, Hkv, B), THREADS, smem, st>>>(
      qb, kb, vb, db, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, Hq, Hkv, D,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_mma_kernel<DP><<<dim3(nb, Hq, B), THREADS, smem, st>>>(
      qb, kb, vb, db, lse, delta, static_cast<bf16*>(dq), S, Hq, Hkv, D, scale);
  return (int)cudaGetLastError();
}

int launch_fma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dq, void* dk, void* dv, int B, int S, int Hq, int Hkv,
               int D, float scale, cudaStream_t st) {
  const size_t smem_kv = fma_smem_bytes(D);
  const size_t smem_q = sizeof(float) * (4 * (size_t)BLK * (D + 1) + (size_t)BLK * (BLK + 1));
  static std::atomic<size_t> allowed_kv{0}, allowed_q{0};
  cudaError_t err = allow_smem((const void*)flash_bwd_dkdv_fma_kernel, smem_kv, allowed_kv);
  if (err == cudaSuccess) err = allow_smem((const void*)flash_bwd_dq_fma_kernel, smem_q, allowed_q);
  if (err != cudaSuccess) return (int)err;
  const int nb = (S + BLK - 1) / BLK;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* df = static_cast<const float*>(dout);
  flash_bwd_dkdv_fma_kernel<<<dim3(nb, Hkv, B), THREADS, smem_kv, st>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), S, Hq, Hkv,
      D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_fma_kernel<<<dim3(nb, Hq, B), THREADS, smem_q, st>>>(
      qf, kf, vf, df, lse, delta, static_cast<float*>(dq), S, Hq, Hkv, D, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B, int S, int Hq, int D,
                 cudaStream_t st) {
  const long long rows = (long long)B * S * Hq;
  const int per = THREADS / 32;
  bwd_delta_kernel<T><<<(unsigned)((rows + per - 1) / per), THREADS, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, S, Hq, D, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Causal (q_offset 0, Sq == Sk == S) attention backward.  q, o, dout, dq
// (B, S, Hq, D); k, v, dk, dv (B, S, Hkv, D): all contiguous, of one type
// (dtype 1 bf16 or 0 f32).  lse (B, Hq, S) f32, the forward's natural-log
// row log-sum-exp of scale * q.k; delta: f32 scratch of B * Hq * S.
// G = Hq / Hkv <= 8, D <= 128 and D % 8 == 0.  Launches the delta, dK/dV
// and dQ kernels in that order on `stream`; returns the first CUDA error.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int B,
                                          int S, int Hq, int Hkv, int D, float scale,
                                          int dtype, void* stream) {
  if (D < 8 || D > MAX_D || D % 8 || Hkv < 1 || Hq % Hkv || Hq / Hkv > MAX_G)
    return (int)cudaErrorInvalidValue;
  if (B < 1 || S < 1) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* lsef = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  if (dtype == F32) {
    int err = launch_delta<float>(o, dout, dl, B, S, Hq, D, st);
    if (err) return err;
    return launch_fma(q, k, v, dout, lsef, dl, dq, dk, dv, B, S, Hq, Hkv, D, scale, st);
  }
  if (dtype != BF16) return (int)cudaErrorInvalidValue;
  int err = launch_delta<bf16>(o, dout, dl, B, S, Hq, D, st);
  if (err) return err;
#define REPRO_MMA(DP) \
  launch_mma<DP>(q, k, v, dout, lsef, dl, dq, dk, dv, B, S, Hq, Hkv, D, scale, st)
  if (D <= 32) return REPRO_MMA(32);
  if (D <= 64) return REPRO_MMA(64);
  return REPRO_MMA(128);
#undef REPRO_MMA
}
