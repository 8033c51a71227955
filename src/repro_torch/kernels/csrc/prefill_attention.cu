// Causal flash attention for Hopper (sm_90a): the prefill path.
//
// Replaces: src/repro/kernels/prefill_attention.py:flash_attention_pallas
// (the TPU kernel behind ops.flash_attention), run in every layer of
// every prefill.
//
// What bounds it on the H100: at the serving shapes, latency.  A causal
// prompt of length S does ~2 * S^2 * Hq * D flops of QK^T and PV against
// ~(Hq + 2 Hkv) * S * D * 2 bytes; at llama3.2-1b's S = 509 that is 1.1 us
// at the bf16 tensor-core peak and 1.6 us at the memory rate, and a hybrid
// chunk (Sq <= 32 queries at a q_offset against the staging stripe) a
// tenth of that.  What sets the time is how many warps are in flight to
// hide each tile's chain of load, barrier, products and softmax: ~1000
// warps of 16 rows for 132 SMs at S = 509, and the key tiles the last
// CTAs walk in sequence.
//
// Two kernels, chosen by the query type in prefill_attention_launch:
//
// flash_prefill_mma_kernel (bf16 queries, every serving path):
//  * FlashAttention-2 on the tensor cores: mma.sync m16n8k16 bf16 -> f32.
//    A CTA of 4 warps owns a 64-row M tile, each warp 16 rows.  Q, K and
//    V fragments come from shared memory through ldmatrix (.trans for V);
//    the score fragment and the O accumulator stay in registers, the
//    online softmax (row max, denominator, rescale) runs in registers with
//    quad shuffles, and P is rounded to bf16 in registers and used as the
//    A operand of PV directly: no shared-memory round trip;
//  * GQA packing: a CTA serves one KV head, and its M rows are (query
//    position, head of the group) pairs, row r = q * G + g, so every K/V
//    tile loaded serves all G heads; the causal mask is per row,
//    q_offset + q >= k.  A hybrid chunk of 32 queries at G = 4 fills 128
//    rows of one KV head instead of 32 half-empty 64-row tiles;
//  * K/V tiles of 64 keys are double-buffered in shared memory with
//    16-byte cp.async (commit/wait groups): tile i + 1 is in flight while
//    tile i's two products run.  Rows are padded by 16 bytes, which puts
//    the 8 rows of every ldmatrix phase in distinct banks.  Tiles that
//    lie wholly in the future of the CTA's last row are never loaded, and
//    a warp skips the products of a tile wholly in its own rows' future;
//  * the contraction is padded with zeros in shared memory to DP in {32,
//    64, 128} (a multiple of the mma's 16), so every D the wrapper takes
//    (a multiple of 8 up to 128) runs; rows past Sk are zero-filled by
//    cp.async and masked, rows past Sq * G are zero and never written;
//  * K/V of another type than bf16 (f32, or the int8/fp8 payloads of the
//    scaled variant with their (B, Sk, Hkv) f32 scales read through their
//    strides) are staged raw by the same cp.async pipeline (scales by
//    4-byte cp.async), then each tile is widened and stored as a bf16
//    tile.  An int8 or e4m3 payload is exact in bf16, so the scales stay
//    in f32: k_scale multiplies the f32 scores, v_scale multiplies P, and
//    P * v_scale enters PV as a bf16 pair hi + lo (two products).  Scaling
//    the payload into bf16 tiles instead, the dequantized values (up to
//    ~10 in the tests) lost 2^-9 of their size, and outputs near 0 missed
//    the 2e-2 tolerance of tests/test_torch_cuda_kernels.py by up to 0.066
//    (NVIDIA H100 80GB HBM3, 700 W).  A zero vector (payload 0, scale 0)
//    gives exactly 0.
//
// flash_prefill_fma_kernel (f32 queries: the reference's float32 mode,
// held to 2e-6 / 1e-5, which bf16 or TF32 operands cannot meet): the
// first port's kernel, unchanged.  f32 FMA on the CUDA cores, one CTA per
// (64-row query tile, query head, batch), GQA by indexing kv head h / G,
// Q/K/V/P tiles in shared memory as f32, 4 x 8 scores per thread.
//
// Both: q_offset places q[0] at an absolute position, a kernel argument or,
// when q_offset_dev is not null, an int32 read from device memory at the
// kernel's start (the TPU kernel's scalar prefetch; a CUDA graph captures
// one launch for every offset); ragged Sq and Sk are masked here (any
// length works); a row with no visible key gives 0, not NaN (the
// max(l, 1e-30) guard).  For training, both can also write each row's
// log-sum-exp (an optional f32 output read by flash_attention_bwd.cu);
// with no lse pointer the launch computes and writes what it did before.
#include <type_traits>

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

// ------------------------------------------------- f32 FMA kernel (f32 q)
// TQ: query/output type, TKV: key/value type (a 1-byte TKV is a quantized
// payload read with k_scale/v_scale; scale of key s of kv head h of batch b
// at b * ss_b + s * ss_s + h * ss_h).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
flash_prefill_fma_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                     const TKV* __restrict__ v, const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale, long long ss_b, long long ss_s,
                     long long ss_h, TQ* __restrict__ out, float* __restrict__ lse, int Sq,
                     int Sk, int Hq, int Hkv, int D, int q_offset,
                     const int* __restrict__ q_offset_dev, int causal, float scale) {
  if (q_offset_dev != nullptr) q_offset = *q_offset_dev;
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
      if (lse != nullptr && tx == 0)
        lse[((long long)b * Hq + h) * Sq + r] = m[i] + logf(fmaxf(l[i], 1e-30f));
      TQ* orow = out + (((long long)b * Sq + r) * Hq + h) * D;
#pragma unroll
      for (int dd = 0; dd < MAX_DC; ++dd)
        if (dd < DC) orow[tx + 8 * dd] = from_float<TQ>(o[i][dd] * inv);
    }
  }
}

// ------------------------------------------- tensor-core kernel (bf16 q)
constexpr int MROWS = 64;        // packed (query, head) rows per CTA, 16 per warp
constexpr int NKEYS = 64;        // keys per K/V tile

// K/V of another type than bf16 are staged raw, then converted to bf16.
template <typename TKV> struct Staged {
  static constexpr bool value = !std::is_same<TKV, __nv_bfloat16>::value;
};

template <typename TKV>
size_t mma_smem_bytes(int DP, int D) {
  size_t bytes = sizeof(__nv_bfloat16) * (DP + 8) * (MROWS + 4 * NKEYS);  // Q, K[2], V[2]
  if (Staged<TKV>::value) {
    bytes += sizeof(TKV) * 4 * NKEYS * (size_t)D;                       // raw K[2], V[2]
    if (Quantized<TKV>::value) bytes += sizeof(float) * 4 * NKEYS;      // scales
  }
  return bytes;
}

// TKV: key/value type (bf16, or staged: f32, fp8-e4m3/int8 with scales);
// DP: the contraction width, D padded with zeros to 32, 64 or 128.
template <typename TKV, int DP>
__global__ void __launch_bounds__(THREADS)
flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q, const TKV* __restrict__ k,
                         const TKV* __restrict__ v, const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale, long long ss_b, long long ss_s,
                         long long ss_h, __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv, int D,
                         int q_offset,
                         const int* __restrict__ q_offset_dev, int causal, float scale) {
  if (q_offset_dev != nullptr) q_offset = *q_offset_dev;
  using bf16 = __nv_bfloat16;
  constexpr int LD = DP + 8;                 // bf16 row stride: 16-byte pad
  constexpr int KSTEPS = DP / 16;            // k-steps of Q K^T
  constexpr int DN = DP / 8;                 // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);             // MROWS x LD
  bf16* k_s = q_s + MROWS * LD;                              // 2 stages of NKEYS x LD
  bf16* v_s = k_s + 2 * NKEYS * LD;
  TKV* kr_s = reinterpret_cast<TKV*>(v_s + 2 * NKEYS * LD);  // staged: 2 x NKEYS x D
  TKV* vr_s = kr_s + 2 * NKEYS * D;
  float* ks_s = reinterpret_cast<float*>(vr_s + 2 * NKEYS * D);   // quantized: 2 x NKEYS
  float* vs_s = ks_s + 2 * NKEYS;

  const int G = Hq / Hkv;
  const int rows = Sq * G;                   // packed rows r = query * G + head
  const int m0 = blockIdx.x * MROWS;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int dchunks = D / 8;                 // 16-byte chunks of a bf16 row

  // keys past the position of the CTA's last row are never loaded
  const int last_q = (min(m0 + MROWS, rows) - 1) / G;
  const int k_end = causal ? min(Sk, q_offset + last_q + 1) : Sk;
  const int n_tiles = (k_end + NKEYS - 1) / NKEYS;

  // visible keys [0, klim) of this thread's two rows, and of the warp's
  // rows: a tile at or past wmax is skipped, one below wmin needs no mask
  auto visible = [&](int R) {
    return R >= rows ? 0 : (causal ? min(Sk, q_offset + R / G + 1) : Sk);
  };
  const int w0 = m0 + warp * 16;
  const int klim[2] = {visible(w0 + gid), visible(w0 + gid + 8)};
  const int wmax = visible(min(w0 + 15, rows - 1));
  const int wmin = w0 + 15 < rows ? visible(w0) : 0;

  // zero the padded columns [D, DP) once: cp.async never writes them
  if (D < DP) {
    const int pad = DP - D;
    for (int i = tid; i < (MROWS + 4 * NKEYS) * pad; i += THREADS)
      q_s[(i / pad) * LD + D + i % pad] = __float2bfloat16(0.f);
  }

  // Q tile; rows past Sq * G are zero-filled
  for (int c = tid; c < MROWS * dchunks; c += THREADS) {
    const int r = c / dchunks, d0 = (c % dchunks) * 8, R = m0 + r;
    const bool ok = R < rows;
    const long long off = ok ? (((long long)b * Sq + R / G) * Hq + hk * G + R % G) * D + d0 : 0;
    cp_async16(q_s + r * LD + d0, q + off, ok ? 16 : 0);
  }

  // K/V tile t into stage st (rows past Sk zero-filled)
  auto issue = [&](int t, int st) {
    const int k0 = t * NKEYS;
    if constexpr (!Staged<TKV>::value) {
      bf16* kd = k_s + st * NKEYS * LD;
      bf16* vd = v_s + st * NKEYS * LD;
      for (int c = tid; c < NKEYS * dchunks; c += THREADS) {
        const int r = c / dchunks, d0 = (c % dchunks) * 8;
        const bool ok = k0 + r < Sk;
        const long long off = ok ? (((long long)b * Sk + k0 + r) * Hkv + hk) * D + d0 : 0;
        cp_async16(kd + r * LD + d0, k + off, ok ? 16 : 0);
        cp_async16(vd + r * LD + d0, v + off, ok ? 16 : 0);
      }
    } else {
      constexpr int VN = Vec<TKV>::N;
      const int rc = D / VN;
      TKV* kd = kr_s + st * NKEYS * D;
      TKV* vd = vr_s + st * NKEYS * D;
      for (int c = tid; c < NKEYS * rc; c += THREADS) {
        const int r = c / rc, d0 = (c % rc) * VN;
        const bool ok = k0 + r < Sk;
        const long long off = ok ? (((long long)b * Sk + k0 + r) * Hkv + hk) * D + d0 : 0;
        cp_async16(kd + r * D + d0, k + off, ok ? 16 : 0);
        cp_async16(vd + r * D + d0, v + off, ok ? 16 : 0);
      }
      if constexpr (Quantized<TKV>::value) {
        if (tid < NKEYS) {
          const bool ok = k0 + tid < Sk;
          const long long at = ok ? b * ss_b + (long long)(k0 + tid) * ss_s + hk * ss_h : 0;
          cp_async4(ks_s + st * NKEYS + tid, k_scale + at, ok ? 4 : 0);
          cp_async4(vs_s + st * NKEYS + tid, v_scale + at, ok ? 4 : 0);
        }
      }
    }
  };

  // staged K/V: widen stage st and store it as bf16.  An int8 or e4m3
  // payload is exact in bf16; its scales stay in f32 (applied to the
  // scores and to P below)
  auto convert = [&](int st) {
    constexpr int VN = Vec<TKV>::N;
    const int rc = D / VN;
    for (int c = tid; c < NKEYS * rc; c += THREADS) {
      const int r = c / rc, d0 = (c % rc) * VN;
      float fk[VN], fv[VN];
      load16(kr_s + (st * NKEYS + r) * D + d0, fk);
      load16(vr_s + (st * NKEYS + r) * D + d0, fv);
      uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + (st * NKEYS + r) * LD + d0);
      uint32_t* vd = reinterpret_cast<uint32_t*>(v_s + (st * NKEYS + r) * LD + d0);
#pragma unroll
      for (int e = 0; e < VN; e += 2) {
        kd[e / 2] = pack_bf16(fk[e], fk[e + 1]);
        vd[e / 2] = pack_bf16(fv[e], fv[e + 1]);
      }
    }
  };

  issue(0, 0);                               // one group: Q and the first tile
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[KSTEPS][4];                    // this warp's 16 rows of Q, as A fragments
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  const float sl2 = scale * 1.4426950408889634f;   // scores in the log2 domain
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t > 0) __syncthreads();              // tile t - 1 consumed: its stage is free
    if (t + 1 < n_tiles) issue(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                      // tile t landed; t + 1 may be in flight
    __syncthreads();
    if constexpr (Staged<TKV>::value) {
      convert(st);
      __syncthreads();
    }
    const int k0 = t * NKEYS;
    if (k0 >= wmax) continue;                // wholly in this warp's future (or no rows)
    const bf16* kt = k_s + st * NKEYS * LD;
    const bf16* vt = v_s + st * NKEYS * LD;

    float s[8][4];                           // S (16 x 64 per warp) = Q K^T
    warp_qk<KSTEPS, LD>(s, qf, kt, lane, D);
    if constexpr (Quantized<TKV>::value) {     // q . (payload * k_scale)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= ks_s[st * NKEYS + j * 8 + tig * 2 + (e & 1)];
    }
    const bool masked = k0 + NKEYS > wmin;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = masked && k0 + j * 8 + tig * 2 + (e & 1) >= klim[e >> 1] ? NEG_INF
                                                                          : s[j][e] * sl2;
    warp_softmax<DN>(s, m_r, l_r, o);
    // quantized V: P * v_scale, entered as a bf16 pair hi + lo so the
    // dequantized values lose nothing to bf16 rounding
    if constexpr (Quantized<TKV>::value) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= vs_s[st * NKEYS + j * 8 + tig * 2 + (e & 1)];
    }
    warp_pv<DN, LD, Quantized<TKV>::value>(o, s, vt, lane, D);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int R = w0 + gid + 8 * i;
    if (R < rows) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      // natural-log lse of the scaled scores: m_r is in the log2 domain
      if (lse != nullptr && tig == 0)
        lse[((long long)b * Hq + hk * G + R % G) * Sq + R / G] =
            (m_r[i] + log2f(fmaxf(l, 1e-30f))) * 0.6931471805599453f;
      bf16* orow = out + (((long long)b * Sq + R / G) * Hq + hk * G + R % G) * D;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const int d = dn * 8 + tig * 2;
        if (d < D)
          *reinterpret_cast<uint32_t*>(orow + d) =
              pack_bf16(o[dn][2 * i] * inv, o[dn][2 * i + 1] * inv);
      }
    }
  }
}

template <typename TKV, int DP>
int launch_mma(const void* q, const void* k, const void* v, const void* k_scale,
               const void* v_scale, long long ss_b, long long ss_s, long long ss_h,
               void* out, float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int D,
               int q_offset, const int* q_offset_dev, int causal, float scale,
               cudaStream_t st) {
  const size_t smem = mma_smem_bytes<TKV>(DP, D);
  static std::atomic<size_t> allowed{0};
  const cudaError_t err =
      allow_smem((const void*)flash_prefill_mma_kernel<TKV, DP>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq * (Hq / Hkv) + MROWS - 1) / MROWS, Hkv, B);
  flash_prefill_mma_kernel<TKV, DP><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), ss_b, ss_s, ss_h,
      static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, Hq, Hkv, D, q_offset, q_offset_dev,
      causal, scale);
  return (int)cudaGetLastError();
}

// Checks, then the kernel for the query type: bf16 -> tensor cores,
// f32 -> f32 FMA.
template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, long long ss_b, long long ss_s, long long ss_h, void* out,
           float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int D, int q_offset,
           const int* q_offset_dev, int causal, float scale, cudaStream_t st) {
  if (D % Vec<TQ>::N || D % Vec<TKV>::N) return (int)cudaErrorInvalidValue;
  // scales exactly when K/V are quantized
  if (Quantized<TKV>::value != (k_scale != nullptr) || (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value) {
#define REPRO_MMA(DP) \
  launch_mma<TKV, DP>(q, k, v, k_scale, v_scale, ss_b, ss_s, ss_h, out, lse, B, Sq, Sk, Hq, \
                      Hkv, D, q_offset, q_offset_dev, causal, scale, st)
    if (D <= 32) return REPRO_MMA(32);
    if (D <= 64) return REPRO_MMA(64);
    return REPRO_MMA(128);
#undef REPRO_MMA
  } else {
    const size_t smem = smem_bytes(D);
    static std::atomic<size_t> allowed{0};
    const cudaError_t err =
        allow_smem((const void*)flash_prefill_fma_kernel<TQ, TKV>, smem, allowed);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
    flash_prefill_fma_kernel<TQ, TKV><<<grid, THREADS, smem, st>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
        static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), ss_b, ss_s,
        ss_h, static_cast<TQ*>(out), lse, Sq, Sk, Hq, Hkv, D, q_offset, q_offset_dev, causal,
        scale);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), out (B, Sq, Hq, D) of q's type, all
// contiguous (the model layout).  lse: null, or f32 (B, Hq, Sq) that
// receives each row's log-sum-exp of its scaled scores, log(sum_k exp(scale
// * q.k)) in the natural log whatever the kernel's own domain (the flash
// backward recomputes P = exp(scale * q.k - lse) from it); a row with no
// visible key gets <= -1e29.  k_scale/v_scale: f32 (B, Sk, Hkv) with
// element strides ss_b, ss_s, ss_h (the same for both) for int8/fp8 K/V,
// else null.  q_offset_dev: null, or one int32 in device memory that the
// kernels read in place of q_offset (a captured CUDA graph's launch then
// serves every offset; the grid depends on Sq, Sk and the heads only).
// Launches on `stream`, returns cudaGetLastError().
extern "C" int prefill_attention_launch(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        long long ss_b, long long ss_s, long long ss_h,
                                        void* out, void* lse, int B, int Sq, int Sk,
                                        int Hq, int Hkv, int D, int q_offset,
                                        const void* q_offset_dev, int causal, float scale,
                                        int q_dtype, int kv_dtype, void* stream) {
  if (D < 8 || D > MAX_D || D % 8 || Hkv < 1 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  if (Sq < 1 || Sk < 1) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(TQ, TKV) \
  launch<TQ, TKV>(q, k, v, k_scale, v_scale, ss_b, ss_s, ss_h, out, static_cast<float*>(lse), \
                  B, Sq, Sk, Hq, Hkv, D, q_offset, static_cast<const int*>(q_offset_dev), causal, \
                  scale, st)
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
