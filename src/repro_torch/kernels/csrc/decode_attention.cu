// Flash-decode attention for Hopper (sm_90a): one query token per
// (batch, KV head) against the model-layout KV cache, the sequence split
// across CTAs and the partials merged by log-sum-exp.
//
// Replaces: src/repro/kernels/decode_attention.py:decode_attention_pallas
// (the TPU kernel behind ops.decode_attention) — the paper's HPU
// operation, run in every layer of every decode step.
//
// What bounds it on the H100: bytes.  Each step reads K and V of every
// live position once, 2 * sum_b min(len_b, S) * Hkv * D * 2 bytes in
// bf16, against ~2 * G flops per byte (G = 4 for llama3.2-1b): far below
// the ~295 flop/byte at which the tensor cores would be the limit.  To
// reach the memory rate the reads have to be spread over every SM and
// kept in flight, and the arithmetic per byte has to cost few issue
// slots.  The first port ran one CTA per (KV head, batch row): 128 CTAs on
// 132 SMs at 16 slots, the longest row's 16 tiles in sequence while most
// CTAs had long finished (0.077 ms at the serve shape, 15x its bound; NVIDIA
// H100 80GB HBM3, 700 W, scripts/torch_kernel_ab.py).
//
// Design (both kernels below):
//  * the sequence is split across CTAs: the grid is (Hkv, B, n_split) and
//    CTA z takes positions [z * split, (z + 1) * split) clamped to
//    min(lengths[b], S).  The wrapper plans split and n_split from S and
//    B * Hkv alone (no host sync on lengths): 256 positions, halved while
//    the grid would hold fewer than two CTAs per SM.  A span that is
//    empty writes m = -1e30, l = 0, o = 0 at once;
//  * the G query heads of the GQA group share every K/V row loaded, and
//    the cache is read in its model layout (B, S, Hkv, D) through its
//    batch and sequence strides: no transpose and no padding of S;
//  * each warp works alone, with no CTA barrier until the end: it loads
//    its own slabs of positions with 16-byte cp.async and keeps its own
//    online softmax; the four warps' states are merged once, through
//    shared memory, and the CTA writes its f32 partial (o unnormalized,
//    m, l) to the workspace the wrapper allocates.  span_combine_kernel
//    (common.cuh, shared with the paged kernel) merges the n_split
//    partials of each (b, h) and divides by max(l, 1e-30), so a row of
//    length 0 gives 0.  Both merges are common.cuh's lse_combine.  With
//    n_split = 1 the CTA writes the output itself;
//  * on request the row's log-sum-exp, lse = M + log(max(L, 1e-30)) of
//    the natural-log maximum M and the denominator L, goes to lse (B, Hkv,
//    G) f32, written by the merge or, with n_split = 1, by the CTA: the
//    sequence placement policies run the kernel over each rank's window of
//    positions and merge the windows by it.  A row whose window is empty
//    gives out 0 and lse <= -1e30 (weight 0 in that merge), never NaN.
//
// decode_split_mma_kernel (bf16 queries over a bf16 cache: every serving
// path): the G heads are the rows of an mma.sync m16n8k16 tile (zero rows
// up to 16), so a warp's slab of 64 positions costs 32 tensor-core
// products for Q K^T and 32 for P V, with K and V fragments from shared
// memory through ldmatrix (.trans for V), scores and output in registers,
// the softmax in the log2 domain with quad shuffles and P rounded to
// bf16.  A warp's slab is one span's quarter at the planned 256-position
// split; its K and V are two cp.async groups, so V lands while Q K^T and
// the softmax run.  With the CUDA-core kernel below on this path (a dot
// product over D per lane and position, a shuffle per position for P V)
// a launch took 26.5 us of device time in the dense serve profile
// (chip_smoke.py, H100 80GB HBM3, 700 W): latency-bound at the few warps
// per SM the ragged rows leave, not bandwidth-bound.
//
// decode_split_fma_kernel (f32 queries or an f32 cache: float32 mode,
// held to 2e-6 / 1e-5, which bf16 operands cannot meet): f32 on the CUDA
// cores.  Each warp streams slabs of PW positions through a two-stage
// cp.async ring; a lane takes one position (PW = 32; two lanes and a
// shuffle when a K row is over 128 bytes, PW = 16) and dots it with the G
// queries in shared memory; K rows are padded by 16 bytes so the 16-byte
// reads are free of bank conflicts; for P V each lane owns D / 32 output
// columns and takes p by shuffle.
#include <type_traits>

#include "common.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;
constexpr int MAX_D = 128;
constexpr int MAX_DPL = MAX_D / 32;          // output columns per lane

// Positions of a warp's slab: one per lane while a K row is at most 128
// bytes, else 16 (two lanes per position).
template <typename TKV> int slab_positions(int D) {
  return D * (int)sizeof(TKV) <= 128 ? 32 : 16;
}

// Row stride of a shared K slab, in elements: 16 bytes of padding.
template <typename TKV> __host__ __device__ int k_stride(int D) {
  return D + 16 / (int)sizeof(TKV);
}

// q (G x D), the warps' outputs (WARPS x G x D), maxima and denominators
// (WARPS x G) in f32, then each warp's two-stage ring of K and V slabs.
template <typename TKV> size_t smem_bytes(int G, int D, int PW) {
  return sizeof(float) * ((size_t)G * D * (1 + WARPS) + 2 * WARPS * G) +
         sizeof(TKV) * (size_t)WARPS * 2 * PW * (k_stride<TKV>(D) + D);
}

// TQ: query/output type, TKV: cache type (f32 activations may read a bf16
// cache, as the reference engine does in float32 mode); PW: slab positions.
// ws: n_split > 1: partials o (B, Hkv, n_split, G, D), then (m, l) as
// (B, Hkv, n_split, 2, G).
template <typename TQ, typename TKV, int PW>
__global__ void __launch_bounds__(THREADS)
decode_split_fma_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v, const int* __restrict__ lengths,
                        TQ* __restrict__ out, float* __restrict__ lse, float* __restrict__ ws,
                        int S, int Hkv, int G, int D, long long k_sb, long long k_ss,
                        long long v_sb, long long v_ss, float scale, int split, int n_split) {
  constexpr int LPP = 32 / PW;               // lanes per position in the score pass
  constexpr int VN = Vec<TKV>::N;
  constexpr int T = WARPS * PW;              // positions per tile of the CTA
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GD = G * D;
  const long long row = (long long)b * Hkv + h;
  float* ws_o = ws + (row * n_split + sp) * GD;
  float* ws_ml = ws + (long long)gridDim.y * Hkv * n_split * GD + (row * n_split + sp) * 2 * G;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);   // clamp: idle slots may run past S
  const int start = sp * split;
  const int end = min(start + split, len);
  if (end <= start) {                        // empty span
    for (int e = tid; e < GD; e += THREADS) {
      if (n_split == 1) {
        out[row * GD + e] = from_float<TQ>(0.f);
        if (lse != nullptr && e < G) lse[row * G + e] = NEG_INF + logf(1e-30f);
      } else {
        ws_o[e] = 0.f;
        if (e < G) {
          ws_ml[e] = NEG_INF;
          ws_ml[G + e] = 0.f;
        }
      }
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* wo = q_s + GD;
  float* wm = wo + WARPS * GD;
  float* wl = wm + WARPS * G;
  const int KS = k_stride<TKV>(D);
  TKV* ring = reinterpret_cast<TKV*>(wl + WARPS * G) + (size_t)warp * 2 * PW * (KS + D);

  for (int i = tid; i < GD; i += THREADS) q_s[i] = to_float(q[row * GD + i]);

  const TKV* kb = k + (long long)b * k_sb + (long long)h * D;
  const TKV* vb = v + (long long)b * v_sb + (long long)h * D;
  const int rc = D / VN;                     // 16-byte chunks of a row

  // this warp's slab i: positions p0 .. p0 + n - 1 of the span
  auto slab_start = [&](int i) { return start + i * T + warp * PW; };
  auto slab_n = [&](int i) { return max(0, min(PW, end - slab_start(i))); };
  auto issue = [&](int i, int st) {
    const int p0 = slab_start(i), n = slab_n(i);
    TKV* ks = ring + st * PW * (KS + D);
    TKV* vs = ks + PW * KS;
    for (int c = lane; c < n * rc; c += 32) {
      const int r = c / rc, d0 = (c % rc) * VN;
      cp_async16(ks + r * KS + d0, kb + (long long)(p0 + r) * k_ss + d0, 16);
      cp_async16(vs + r * D + d0, vb + (long long)(p0 + r) * v_ss + d0, 16);
    }
  };

  float m[MAX_G], l[MAX_G], acc[MAX_G][MAX_DPL];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int dd = 0; dd < MAX_DPL; ++dd) acc[g][dd] = 0.f;
  }
  issue(0, 0);
  cp_async_commit();
  __syncthreads();                           // q_s visible

  const int j = lane % PW;                   // the lane's position in a slab
  const int dh = lane / PW;                  // and its share of the row's chunks
  for (int i = 0;; ++i) {
    const int n = slab_n(i);
    if (n == 0) break;
    const int st = i & 1;
    if (slab_n(i + 1) > 0) issue(i + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                      // slab i landed; i + 1 may be in flight
    __syncwarp();
    const TKV* ks = ring + st * PW * (KS + D);
    const TKV* vs = ks + PW * KS;

    float s[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) s[g] = 0.f;
    if (j < n) {
      for (int c = dh; c < rc; c += LPP) {
        float f[VN];
        load16(ks + j * KS + c * VN, f);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
            const float* qg = q_s + g * D + c * VN;
#pragma unroll
            for (int e = 0; e < VN; ++e) s[g] += qg[e] * f[e];
          }
        }
      }
    }
    float p[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        if constexpr (LPP == 2) s[g] += __shfl_xor_sync(0xffffffffu, s[g], 16);
        const float x = j < n ? s[g] * scale : NEG_INF;
        const float mn = fmaxf(m[g], warp_max(x, 32));
        const float corr = expf(m[g] - mn);
        p[g] = j < n ? expf(x - mn) : 0.f;
        l[g] = l[g] * corr + (dh == 0 ? p[g] : 0.f);     // lane-partial denominators
#pragma unroll
        for (int dd = 0; dd < MAX_DPL; ++dd) acc[g][dd] *= corr;
        m[g] = mn;
      }
    }
    for (int r = 0; r < n; ++r) {
      float vr[MAX_DPL];
#pragma unroll
      for (int dd = 0; dd < MAX_DPL; ++dd) {
        const int d = lane + 32 * dd;
        vr[dd] = d < D ? to_float(vs[r * D + d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          const float pr = __shfl_sync(0xffffffffu, p[g], r);
#pragma unroll
          for (int dd = 0; dd < MAX_DPL; ++dd) acc[g][dd] += pr * vr[dd];
        }
      }
    }
    __syncwarp();                            // slab read: its stage may be refilled
  }
  cp_async_wait<0>();

  // merge the four warps' states, then write the partial (or the output)
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      const float lw = warp_sum(l[g], 32);
      if (lane == 0) {
        wm[warp * G + g] = m[g];
        wl[warp * G + g] = lw;
      }
#pragma unroll
      for (int dd = 0; dd < MAX_DPL; ++dd) {
        const int d = lane + 32 * dd;
        if (d < D) wo[warp * GD + g * D + d] = acc[g][dd];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < GD; e += THREADS) {
    const int g = e / D;
    float M, L;
    const float O = lse_combine(wm + g, wl + g, G, wo + e, GD, WARPS, M, L);
    if (n_split == 1) {
      out[row * GD + e] = from_float<TQ>(O / fmaxf(L, 1e-30f));
      if (lse != nullptr && e - g * D == 0) lse[row * G + g] = M + logf(fmaxf(L, 1e-30f));
    } else {
      ws_o[e] = O;
      if (e - g * D == 0) {
        ws_ml[g] = M;
        ws_ml[G + g] = L;
      }
    }
  }
}

// ------------------------------ tensor-core kernel (bf16 q over a bf16 cache)
constexpr int NK = 64;                       // keys per warp slab
constexpr int QROWS = 16;                    // mma rows: the G heads, zero-padded

// q (16 rows), each warp's K and V slab (bf16, rows padded by 16 bytes),
// then the warps' maxima and denominators.
size_t mma_smem_bytes(int DP) {
  return sizeof(__nv_bfloat16) * (size_t)(DP + 8) * (QROWS + WARPS * 2 * NK) +
         sizeof(float) * 2 * WARPS * MAX_G;
}

// DP: the contraction width, D padded with zeros to 32, 64 or 128.
template <int DP>
__global__ void __launch_bounds__(THREADS)
decode_split_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                        float* __restrict__ ws, int S, int Hkv, int G, int D, long long k_sb,
                        long long k_ss, long long v_sb, long long v_ss, float scale, int split,
                        int n_split) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = DP + 8;
  constexpr int KSTEPS = DP / 16;
  constexpr int DN = DP / 8;
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int GD = G * D;
  const long long row = (long long)b * Hkv + h;
  float* ws_o = ws + (row * n_split + sp) * GD;
  float* ws_ml = ws + (long long)gridDim.y * Hkv * n_split * GD + (row * n_split + sp) * 2 * G;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);   // clamp: idle slots may run past S
  const int start = sp * split;
  const int end = min(start + split, len);
  if (end <= start) {                        // empty span
    for (int e = tid; e < GD; e += THREADS) {
      if (n_split == 1) {
        out[row * GD + e] = __float2bfloat16(0.f);
        if (lse != nullptr && e < G) lse[row * G + e] = NEG_INF + logf(1e-30f);
      } else {
        ws_o[e] = 0.f;
        if (e < G) {
          ws_ml[e] = NEG_INF;
          ws_ml[G + e] = 0.f;
        }
      }
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* kt = q_s + QROWS * LD + warp * 2 * NK * LD;   // this warp's K slab, V after it
  bf16* vt = kt + NK * LD;
  float* wm = reinterpret_cast<float*>(q_s + QROWS * LD + WARPS * 2 * NK * LD);
  float* wl = wm + WARPS * MAX_G;

  // Q: rows >= G and columns >= D zero; K/V: columns >= D zero (cp.async
  // never writes them)
  for (int i = tid; i < QROWS * LD; i += THREADS) q_s[i] = __float2bfloat16(0.f);
  if (D < DP)
    for (int i = lane; i < 2 * NK * (DP - D); i += 32)
      kt[(i / (DP - D)) * LD + D + i % (DP - D)] = __float2bfloat16(0.f);
  __syncthreads();
  const int dchunks = D / 8;
  for (int i = tid; i < GD; i += THREADS) q_s[(i / D) * LD + i % D] = q[row * GD + i];
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], q_s + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);

  const bf16* kb = k + (long long)b * k_sb + (long long)h * D;
  const bf16* vb = v + (long long)b * v_sb + (long long)h * D;
  const float sl2 = scale * 1.4426950408889634f;     // scores in the log2 domain
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

  // warp w takes the slabs of NK positions at start + (i * WARPS + w) * NK
  for (int p0 = start + warp * NK; p0 < end; p0 += WARPS * NK) {
    const int n = min(NK, end - p0);
    // K and V as two groups: V lands while Q K^T and the softmax run;
    // rows past n are zero-filled (nothing read)
    for (int c = lane; c < NK * dchunks; c += 32) {
      const int r = c / dchunks, d0 = (c % dchunks) * 8;
      cp_async16(kt + r * LD + d0, kb + (r < n ? (long long)(p0 + r) * k_ss + d0 : 0),
                 r < n ? 16 : 0);
    }
    cp_async_commit();
    for (int c = lane; c < NK * dchunks; c += 32) {
      const int r = c / dchunks, d0 = (c % dchunks) * 8;
      cp_async16(vt + r * LD + d0, vb + (r < n ? (long long)(p0 + r) * v_ss + d0 : 0),
                 r < n ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();

    float s[8][4];                           // S (16 x 64: the G heads x the slab)
    warp_qk<KSTEPS, LD>(s, qf, kt, lane, D);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = j * 8 + tig * 2 + (e & 1) < n ? s[j][e] * sl2 : NEG_INF;
    warp_softmax<DN>(s, m_r, l_r, o);
    cp_async_wait<0>();                      // V landed
    __syncwarp();
    warp_pv<DN, LD, false>(o, s, vt, lane, D);
    __syncwarp();                            // slab read before the next one lands
  }

  // this warp's state of rows g = gid < G (max back to the natural log),
  // its output in its own slab space; then the four warps merged
  float l = l_r[0];
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* wo = reinterpret_cast<float*>(kt);
  if (gid < G) {
    if (tig == 0) {
      wm[warp * MAX_G + gid] = m_r[0] * 0.6931471805599453f;
      wl[warp * MAX_G + gid] = l;
    }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      const int d = dn * 8 + tig * 2;
      if (d < D) {
        wo[gid * D + d] = o[dn][0];
        wo[gid * D + d + 1] = o[dn][1];
      }
    }
  }
  __syncthreads();
  const float* wo0 = reinterpret_cast<const float*>(q_s + QROWS * LD);
  for (int e = tid; e < GD; e += THREADS) {
    const int g = e / D;
    float M, L;
    const float O = lse_combine(wm + g, wl + g, MAX_G, wo0 + e, NK * LD, WARPS, M, L);
    if (n_split == 1) {
      out[row * GD + e] = __float2bfloat16(O / fmaxf(L, 1e-30f));
      if (lse != nullptr && e - g * D == 0) lse[row * G + g] = M + logf(fmaxf(L, 1e-30f));
    } else {
      ws_o[e] = O;
      if (e - g * D == 0) {
        ws_ml[g] = M;
        ws_ml[G + g] = L;
      }
    }
  }
}

template <typename TQ, typename TKV, int PW>
int launch_split(const void* q, const void* k, const void* v, const void* lengths,
                 void* out, float* lse, void* ws, int B, int S, int Hkv, int G, int D,
                 long long k_sb, long long k_ss, long long v_sb, long long v_ss, float scale,
                 int split, int n_split, cudaStream_t st) {
  const size_t smem = smem_bytes<TKV>(G, D, PW);
  static std::atomic<size_t> allowed{0};
  const cudaError_t err = allow_smem(
      (const void*)decode_split_fma_kernel<TQ, TKV, PW>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  decode_split_fma_kernel<TQ, TKV, PW><<<dim3(Hkv, B, n_split), THREADS, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int*>(lengths), static_cast<TQ*>(out), lse, static_cast<float*>(ws),
      S, Hkv, G, D, k_sb, k_ss, v_sb, v_ss, scale, split, n_split);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, const void* lengths, void* out,
               float* lse, void* ws, int B, int S, int Hkv, int G, int D, long long k_sb,
               long long k_ss, long long v_sb, long long v_ss, float scale, int split,
               int n_split, cudaStream_t st) {
  const size_t smem = mma_smem_bytes(DP);
  static std::atomic<size_t> allowed{0};
  const cudaError_t err =
      allow_smem((const void*)decode_split_mma_kernel<DP>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  decode_split_mma_kernel<DP><<<dim3(Hkv, B, n_split), THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), lse, static_cast<float*>(ws), S, Hkv, G, D, k_sb,
      k_ss, v_sb, v_ss, scale, split, n_split);
  return (int)cudaGetLastError();
}

// The kernel for the types (bf16 over bf16 -> tensor cores, else CUDA
// cores), then the merge of the partials when there are several spans.
template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
           float* lse, void* ws, int B, int S, int Hkv, int G, int D, long long k_sb,
           long long k_ss, long long v_sb, long long v_ss, float scale, int split, int n_split,
           cudaStream_t st) {
  if (D % Vec<TKV>::N || split < 1 || n_split < 1 || (n_split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  int err;
  if constexpr (std::is_same<TQ, __nv_bfloat16>::value &&
                std::is_same<TKV, __nv_bfloat16>::value) {
#define REPRO_MMA(DP)                                                                     \
  launch_mma<DP>(q, k, v, lengths, out, lse, ws, B, S, Hkv, G, D, k_sb, k_ss, v_sb, v_ss, \
                 scale, split, n_split, st)
    err = D <= 32 ? REPRO_MMA(32) : D <= 64 ? REPRO_MMA(64) : REPRO_MMA(128);
#undef REPRO_MMA
  } else {
    err = slab_positions<TKV>(D) == 32
        ? launch_split<TQ, TKV, 32>(q, k, v, lengths, out, lse, ws, B, S, Hkv, G, D, k_sb,
                                    k_ss, v_sb, v_ss, scale, split, n_split, st)
        : launch_split<TQ, TKV, 16>(q, k, v, lengths, out, lse, ws, B, S, Hkv, G, D, k_sb,
                                    k_ss, v_sb, v_ss, scale, split, n_split, st);
  }
  if (err != (int)cudaSuccess || n_split == 1) return err;
  span_combine_kernel<TQ><<<dim3(Hkv, B), COMBINE_THREADS, 0, st>>>(
      static_cast<const float*>(ws), static_cast<TQ*>(out), lse, Hkv, G, D, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hkv*G, D) contiguous; k/v (B, S, Hkv, D) with unit stride in D and
// stride D between heads, batch/sequence strides given in elements;
// lengths (B,) int32; out (B, Hkv*G, D) contiguous, of q's type; lse (B,
// Hkv, G) f32 or null (not written).  CTA z of a row takes positions
// [z * split, (z + 1) * split); with n_split > 1, ws holds B * Hkv *
// n_split * G * (D + 2) f32 and a second kernel merges the partials (and
// writes lse).  Launches on `stream` and returns cudaGetLastError().
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* out, void* lse, void* ws,
                                       int B,
                                       int S, int Hkv, int G, int D, long long k_sb,
                                       long long k_ss, long long v_sb, long long v_ss,
                                       float scale, int split, int n_split, int q_dtype,
                                       int kv_dtype, void* stream) {
  if (G < 1 || G > MAX_G || D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  if (B < 1 || Hkv < 1) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(TQ, TKV)                                                              \
  launch<TQ, TKV>(q, k, v, lengths, out, static_cast<float*>(lse), ws, B, S, Hkv, G, D, k_sb, \
                  k_ss, v_sb, v_ss, scale, split, n_split, st)
  if (q_dtype == BF16 && kv_dtype == BF16) return REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == F32 && kv_dtype == BF16) return REPRO_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == F32 && kv_dtype == F32) return REPRO_LAUNCH(float, float);
  if (q_dtype == BF16 && kv_dtype == F32) return REPRO_LAUNCH(__nv_bfloat16, float);
#undef REPRO_LAUNCH
  return (int)cudaErrorInvalidValue;
}
