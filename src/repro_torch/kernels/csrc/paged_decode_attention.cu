// Paged flash-decode attention for Hopper (sm_90a): one query token per
// (batch, KV head) against a pool of fixed-size KV blocks reached through
// per-sequence block tables, the sequence split across CTAs and the
// partials merged by log-sum-exp.
//
// Replaces: src/repro/kernels/paged_decode_attention.py:
// paged_decode_attention_pallas (the TPU kernel behind
// ops.paged_decode_attention) — the decode attention of the paged cache,
// run in every layer of every decode step of `--cache paged`, and twice
// on the tiered paths: the hot window [cold_len, len) of the device pool
// and the cold prefix in the host pool, merged by their lse.
//
// What bounds it on the H100: bytes.  Each call reads K and V of every
// live position once, 2 * sum_b (min(len_b, MB*bs) - start_b) * Hkv * D
// * 2 bytes in bf16 (1 byte in fp8/int8, plus one f32 scale per vector),
// plus the tables, against ~2 * G flops per byte (G = 4 for
// llama3.2-1b): far below the ~295 flop/byte where the tensor cores
// would be the limit.  To reach the memory rate the reads have to be
// spread over every SM and kept in flight, and the arithmetic per byte
// has to cost few issue slots.  The first port ran one CTA per (KV head,
// batch row) on the CUDA cores, through shared memory with four CTA
// barriers per 64-position tile: 128 CTAs on 132 SMs at 16 slots, the
// longest row's tiles in sequence, 19x its bound in bf16 and 35x in
// fp8/int8 at the serve shape (NVIDIA H100 80GB HBM3, 700 W,
// scripts/torch_kernel_ab.py).
//
// Design (both kernels below):
//  * the sequence is split across CTAs: the grid is (Hkv, B, n_split) and
//    CTA z takes the positions [z * split, (z + 1) * split) that lie in
//    the row's window [starts[b], min(lengths[b], MB * bs)).  The wrapper
//    plans split and n_split from MB * bs and B * Hkv alone
//    (decode_attention.plan_split; no host sync on lengths).  A span that
//    is empty — past the row's length, wholly below starts[b], or any
//    span of the cold launch of a slot with nothing spilled — writes m =
//    -1e30, l = 0, o = 0 at once and reads nothing else;
//  * the pool is kernel-native, (N, Hkv, bs, D): one head's bs x D tile of
//    a physical block is contiguous.  The span's slice of tables[b] (at
//    most min(split, split / bs + 1) <= MAX_SPLIT entries, never past the
//    row's last live block) goes to shared memory once, and each
//    position's row is found through it: table[p / bs] * Hkv*bs*D +
//    h*bs*D + (p % bs)*D, so any block size works (a block larger than a
//    span or a warp's slab only means fewer table entries per span) and
//    every 16 bytes of a row are one cp.async.  A warp works out
//    its slab's row addresses once, into shared memory, for K, V and the
//    scales alike;
//  * the G query heads of the GQA group share every K/V row loaded;
//  * each warp works alone, with no CTA barrier until the end: it streams
//    its own slabs of the span (from its first live position, so nothing
//    below starts[b] is loaded or masked) with 16-byte cp.async and keeps
//    its own online softmax.  Rows past the window are zero-filled
//    (cp.async with src-size 0) or never read, so whatever null block 0 or
//    the tail of a live block holds — an fp8 NaN included — never enters
//    a product;
//  * the four warps' states merge once, through shared memory, and the
//    CTA writes its f32 partial (o unnormalized, m, l) to the workspace the
//    wrapper allocates; span_combine_kernel (common.cuh, shared with the
//    dense decode) merges the n_split partials of each (b, h): out = O /
//    max(L, 1e-30) and lse = M + log(max(L, 1e-30)), so an empty window
//    gives out 0 and lse <= -1e30, never NaN, and keeps weight 0 in the
//    caller's hot/cold merge.  With n_split = 1 the CTA writes out and lse
//    itself.
//
// paged_split_mma_kernel (bf16 queries over a bf16, fp8-e4m3 or int8
// pool: every serving path): the G heads are the rows of an mma.sync
// m16n8k16 tile (zero rows up to 16), the contraction padded with zeros
// to DP in {32, 64, 128}; Q is staged in warp 0's V slab until its
// fragments are in registers, so a bf16 pool at D <= 64 fits three CTAs
// per SM.  A warp's slab is 64 positions, a quarter of a span at the
// planned 256-position split; its K and V rows land in shared
// memory as two cp.async groups, so V is in flight while Q K^T and the
// softmax run (common.cuh's warp_qk, warp_softmax in the log2 domain and
// warp_pv, fragments through ldmatrix, .trans for V).  An fp8/int8 pool is
// staged raw, 1 byte per element, with its row scales by 4-byte cp.async;
// the payload is widened to bf16 tiles, which is exact, and the scales
// stay in f32: k_scale multiplies the score column, v_scale multiplies P.
// Scaling the payload into bf16 tiles instead loses 2^-9 of each
// dequantized value, which missed the 2e-2 tolerance of the scaled flash
// tests by up to 0.066 (NVIDIA H100 80GB HBM3, 700 W).  For every pool P
// (times v_scale) enters P V as a bf16 pair hi + lo, two products that
// keep ~16 bits of P: with P rounded to bf16, outputs of the bf16 pool sat
// a bf16 ulp from the plain version's (1.6e-2 at the serve shape against
// the 2e-2 tolerance, 4.9e-4 with hi + lo) for 2.5% less device time
// (NVIDIA H100 80GB HBM3, 700 W, scripts/torch_kernel_ab.py).
//
// paged_split_fma_kernel (f32 queries or an f32 pool: float32 mode, held
// to 2e-6 / 1e-5, which bf16 operands cannot meet): f32 on the CUDA cores.
// Each warp streams slabs of PW positions through a two-stage cp.async
// ring; a lane takes one position (PW = 32; two lanes and a shuffle when a
// K row is over 128 bytes, PW = 16) and dots it with the G queries in
// shared memory; for P V each lane owns D / 32 output columns and takes p
// by shuffle.  An fp8/int8 payload is widened to f32 with k_scale on the
// score and v_scale on p.
#include <type_traits>

#include "common.cuh"

namespace {

using namespace repro;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;
constexpr int MAX_D = 128;
constexpr int MAX_SPLIT = 256;               // positions per span at most: the table slice
constexpr int MAX_DPL = MAX_D / 32;          // output columns per lane (CUDA-core kernel)
constexpr float LN2 = 0.6931471805599453f;

// Everything a launch passes to the kernels.  k_scale/v_scale: f32 (N,
// Hkv, bs) for a 1-byte pool, else null; starts and lse may be null; ws
// (n_split > 1): o (B, Hkv, n_split, G, D), then (m, l) as (B, Hkv,
// n_split, 2, G).
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* lengths;
  const int* starts;
  void* out;
  float* lse;
  float* ws;
  int B, MB, Hkv, bs, G, D;
  float scale;
  int split, n_split;
};

// Where this CTA's span ends up: its slot of the workspace, or (n_split
// = 1) the output and lse themselves.
template <typename TQ>
struct Sink {
  TQ* out;
  float* lse;
  float* o;                                  // n_split > 1: the partial
  float* ml;
  long long row;                             // b * Hkv + h
  int G, D, n_split;

  __device__ Sink(const Args& a) {
    row = (long long)blockIdx.y * a.Hkv + blockIdx.x;
    out = static_cast<TQ*>(a.out);
    lse = a.lse;
    G = a.G;
    D = a.D;
    n_split = a.n_split;
    const int GD = G * D;
    const long long slot = row * n_split + blockIdx.z;
    o = n_split == 1 ? nullptr : a.ws + slot * GD;
    ml = n_split == 1 ? nullptr
                      : a.ws + (long long)gridDim.y * a.Hkv * n_split * GD + slot * 2 * G;
  }

  // An empty span: m = -1e30, l = 0, o = 0 (out 0 and lse <= -1e30).
  __device__ void empty() const {
    const int GD = G * D;
    for (int e = threadIdx.x; e < GD; e += THREADS) {
      if (n_split == 1) {
        out[row * GD + e] = from_float<TQ>(0.f);
        if (lse != nullptr && e < G) lse[row * G + e] = NEG_INF + logf(1e-30f);
      } else {
        o[e] = 0.f;
        if (e < G) {
          ml[e] = NEG_INF;
          ml[G + e] = 0.f;
        }
      }
    }
  }

  // Merge the warps' states — maxima and denominators (WARPS x MAX_G),
  // outputs G x D each, o_stride floats apart — and write the span.
  __device__ void write(const float* wm, const float* wl, const float* wo, int o_stride) const {
    const int GD = G * D;
    for (int e = threadIdx.x; e < GD; e += THREADS) {
      const int g = e / D;
      const bool first = e - g * D == 0;
      float M, L;
      const float O = lse_combine(wm + g, wl + g, MAX_G, wo + e, o_stride, WARPS, M, L);
      if (n_split == 1) {
        out[row * GD + e] = from_float<TQ>(O / fmaxf(L, 1e-30f));
        if (lse != nullptr && first) lse[row * G + g] = M + logf(fmaxf(L, 1e-30f));
      } else {
        o[e] = O;
        if (first) {
          ml[g] = M;
          ml[G + g] = L;
        }
      }
    }
  }
};

// The window of this CTA: positions [lo, end) of row b, its span cut to
// [starts[b], min(lengths[b], MB * bs)) (idle slots' lengths may run past
// the table).  Empty when end <= lo.
__device__ __forceinline__ void span_window(const Args& a, int& lo, int& end) {
  const int b = blockIdx.y;
  lo = blockIdx.z * a.split;
  end = min(min(lo + a.split, a.MB * a.bs), a.lengths[b]);
  if (a.starts != nullptr) lo = max(lo, a.starts[b]);
}

// The span's slice of tables[b] — blocks lo / bs .. (end - 1) / bs — into
// tab_s; the caller synchronizes.
__device__ __forceinline__ void load_table(const Args& a, int lo, int end, int* tab_s) {
  const int j0 = lo / a.bs;
  const int* table = a.tables + (long long)blockIdx.y * a.MB + j0;
  for (int i = threadIdx.x; i <= (end - 1) / a.bs - j0; i += THREADS) tab_s[i] = table[i];
}

// Position p's stored vector (tab_s: the table slice from block j0): its
// index into (N, Hkv, bs), which is its scale's offset and, times D, its
// row's.  The wrapper keeps N * Hkv * bs below 2^31.
struct Rows {
  const int* tab_s;
  int j0, bs, h, Hkv;
  __device__ int index(int p) const { return (tab_s[p / bs - j0] * Hkv + h) * bs + p % bs; }
};

// ------------------------- tensor-core kernel (bf16 q over bf16/fp8/int8)
constexpr int NK = 64;                       // positions per warp slab
constexpr int QROWS = 16;                    // mma rows: the G heads, zero-padded

// One warp's shared memory: bf16 tiles of NK rows of DP + 8 (a 16-byte
// pad: the 8 rows of an ldmatrix phase in distinct banks) — a bf16 pool's
// K and V slabs land there; a 1-byte pool's K, then its V, are widened
// into one tile — then the slab rows' vector indices and, for a 1-byte
// pool, the raw K and V payloads (rows of DP bytes) and their scales.
template <typename TKV, int DP>
struct MmaWarp {
  static constexpr int LD = DP + 8;
  static constexpr bool QUANT = Quantized<TKV>::value;
  static constexpr int TILES = QUANT ? 1 : 2;
  static constexpr size_t BYTES = sizeof(bf16) * TILES * NK * LD + sizeof(int) * NK +
                                  (QUANT ? 2 * NK * DP + sizeof(float) * 2 * NK : 0);
};

// The warps' maxima and denominators, the table slice, then each warp's
// slabs; Q (16 rows) lives in warp 0's first tile until its fragments are
// in registers.  At D <= 64 a bf16 pool takes 76,032 bytes and a 1-byte
// pool 73,984: three CTAs per SM.
template <typename TKV, int DP>
constexpr size_t mma_smem_bytes() {
  return sizeof(float) * 2 * WARPS * MAX_G + sizeof(int) * MAX_SPLIT +
         WARPS * MmaWarp<TKV, DP>::BYTES;
}

// A slab of 1-byte payloads (NK rows of DP bytes, D used) widened into
// bf16 rows of DP + 8: exact for every int8 and every e4m3 value.
template <int DP, typename TKV>
__device__ __forceinline__ void widen(const TKV* raw, bf16* tile, int D, int lane) {
  constexpr int LD = DP + 8;
  const int rc = D / 16;
  for (int c = lane; c < NK * rc; c += 32) {
    const int r = c / rc, d0 = (c % rc) * 16;
    float f[16];
    load16(raw + r * DP + d0, f);
    uint4* dst = reinterpret_cast<uint4*>(tile + r * LD + d0);
    dst[0] = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                        pack_bf16(f[6], f[7]));
    dst[1] = make_uint4(pack_bf16(f[8], f[9]), pack_bf16(f[10], f[11]),
                        pack_bf16(f[12], f[13]), pack_bf16(f[14], f[15]));
  }
}

// TKV: pool type (bf16, or 1-byte payloads with f32 scales); DP: the
// contraction width, D padded with zeros to 32, 64 or 128.
template <typename TKV, int DP>
__global__ void __launch_bounds__(THREADS) paged_split_mma_kernel(const Args a) {
  using W = MmaWarp<TKV, DP>;
  constexpr bool QUANT = W::QUANT;
  constexpr int LD = W::LD;
  constexpr int KSTEPS = DP / 16;
  constexpr int DN = DP / 8;
  constexpr int VN = Vec<TKV>::N;            // elements per 16-byte chunk of a row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = a.G, D = a.D;
  const Sink<bf16> sink(a);

  int lo, end;
  span_window(a, lo, end);
  if (end <= lo) {
    sink.empty();
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* wm = reinterpret_cast<float*>(smem_raw);
  float* wl = wm + WARPS * MAX_G;
  int* tab_s = reinterpret_cast<int*>(wl + WARPS * MAX_G);
  unsigned char* slabs = reinterpret_cast<unsigned char*>(tab_s + MAX_SPLIT);
  unsigned char* mine = slabs + warp * W::BYTES;
  bf16* kt = reinterpret_cast<bf16*>(mine);  // this warp's K tile
  bf16* vt = kt + (W::TILES - 1) * NK * LD;  // and V tile (K's, for a 1-byte pool)
  int* rix = reinterpret_cast<int*>(kt + W::TILES * NK * LD);   // the slab rows' vectors
  TKV* kr = reinterpret_cast<TKV*>(rix + NK);                // 1-byte pools: raw K, V
  TKV* vr = kr + NK * DP;
  float* ksc = reinterpret_cast<float*>(vr + NK * DP);       // and their scales
  float* vsc = ksc + NK;
  bf16* q_s = reinterpret_cast<bf16*>(slabs);                // warp 0's K tile

  // Q: rows >= G and columns >= D zero; K/V slabs: columns >= D zero
  // (nothing else writes them; Q's are zero too); the table slice
  const bf16* q = static_cast<const bf16*>(a.q) + sink.row * G * D;
  for (int i = tid; i < QROWS * LD; i += THREADS) {
    const int r = i / LD, c = i % LD;
    q_s[i] = r < G && c < D ? q[r * D + c] : __float2bfloat16(0.f);
  }
  if (D < DP)
    for (int i = lane; i < W::TILES * NK * (DP - D); i += 32)
      kt[(i / (DP - D)) * LD + D + i % (DP - D)] = __float2bfloat16(0.f);
  load_table(a, lo, end, tab_s);
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], q_s + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
  __syncthreads();                           // Q read: warp 0 may fill its K tile

  const Rows rows{tab_s, lo / a.bs, a.bs, (int)blockIdx.x, a.Hkv};
  const TKV* k = static_cast<const TKV*>(a.k);
  const TKV* v = static_cast<const TKV*>(a.v);
  const int rc = D / VN;                     // 16-byte chunks of a row
  const float sl2 = a.scale * 1.4426950408889634f;   // scores in the log2 domain
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

  // One cp.async group: the slab's n rows of a pool (and their scales);
  // rows past n are zero-filled and read nothing.
  auto issue = [&](int n, const TKV* pool, bf16* tile, TKV* raw, const float* spool,
                   float* sc) {
    for (int c = lane; c < NK * rc; c += 32) {
      const int r = c / rc, d0 = (c % rc) * VN;
      const bool ok = r < n;
      const TKV* src = ok ? pool + (long long)rix[r] * D + d0 : pool;
      if constexpr (QUANT)
        cp_async16(raw + r * DP + d0, src, ok ? 16 : 0);
      else
        cp_async16(tile + r * LD + d0, src, ok ? 16 : 0);
    }
    if constexpr (QUANT) {
      for (int r = lane; r < NK; r += 32) {
        const bool ok = r < n;
        cp_async4(sc + r, ok ? spool + rix[r] : spool, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  // warp w takes the slabs of NK positions at lo + (i * WARPS + w) * NK
  for (int p0 = lo + warp * NK; p0 < end; p0 += WARPS * NK) {
    const int n = min(NK, end - p0);
    for (int r = lane; r < n; r += 32) rix[r] = rows.index(p0 + r);
    __syncwarp();
    issue(n, k, kt, kr, a.k_scale, ksc);       // K, then V: V lands during Q K^T
    issue(n, v, vt, vr, a.v_scale, vsc);
    cp_async_wait<1>();
    __syncwarp();
    if constexpr (QUANT) {
      widen<DP>(kr, kt, D, lane);
      __syncwarp();
    }

    float s[8][4];                           // S (16 x 64: the G heads x the slab)
    warp_qk<KSTEPS, LD>(s, qf, kt, lane, D);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + tig * 2 + (e & 1);
        float x = s[j][e] * sl2;
        if constexpr (QUANT) x *= ksc[col];  // q . payload * k_scale
        s[j][e] = col < n ? x : NEG_INF;
      }
    warp_softmax<DN>(s, m_r, l_r, o);
    cp_async_wait<0>();                      // V landed
    __syncwarp();
    if constexpr (QUANT) {
      widen<DP>(vr, vt, D, lane);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= vsc[j * 8 + tig * 2 + (e & 1)];
    }
    // P (times a quantized V's scale) enters as bf16 hi + lo
    warp_pv<DN, LD, true>(o, s, vt, lane, D);
    __syncwarp();                            // slab read before the next one lands
  }

  // this warp's state of rows g = gid < G (max back to the natural log),
  // its output over its own slabs; then the four warps merged
  float l = l_r[0];
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* wo = reinterpret_cast<float*>(mine);
  if (gid < G) {
    if (tig == 0) {
      wm[warp * MAX_G + gid] = m_r[0] * LN2;
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
  sink.write(wm, wl, reinterpret_cast<const float*>(slabs), (int)(W::BYTES / sizeof(float)));
}

// ------------------------------- CUDA-core kernel (f32 q, or an f32 pool)
// Positions of a warp's slab: one per lane while a K row is at most 128
// bytes, else 16 (two lanes per position).
template <typename TKV>
int slab_positions(int D) {
  return D * (int)sizeof(TKV) <= 128 ? 32 : 16;
}

// Row stride of a shared K slab, in elements: 16 bytes of padding.
template <typename TKV>
__host__ __device__ int k_stride(int D) {
  return D + 16 / (int)sizeof(TKV);
}

// One stage of a warp's ring: PW K rows (padded), PW V rows and, for a
// 1-byte pool, their 2 * PW scales (K's, then V's).
template <typename TKV>
__host__ __device__ size_t fma_stage_bytes(int D, int PW) {
  return sizeof(TKV) * (size_t)PW * (k_stride<TKV>(D) + D) +
         (Quantized<TKV>::value ? sizeof(float) * 2 * PW : 0);
}

// q (G x D), the warps' outputs (WARPS x G x D) in f32, their maxima and
// denominators, the table slice, then each warp's two-stage ring.
template <typename TKV>
size_t fma_smem_bytes(int G, int D, int PW) {
  return sizeof(float) * ((size_t)G * D * (1 + WARPS) + 2 * WARPS * MAX_G) +
         sizeof(int) * MAX_SPLIT + WARPS * 2 * fma_stage_bytes<TKV>(D, PW);
}

// TQ: query/output type, TKV: pool type (f32 activations may read a bf16
// pool, as the reference engine does in float32 mode; 1-byte payloads
// come with f32 scales); PW: slab positions.
template <typename TQ, typename TKV, int PW>
__global__ void __launch_bounds__(THREADS) paged_split_fma_kernel(const Args a) {
  constexpr bool QUANT = Quantized<TKV>::value;
  constexpr int LPP = 32 / PW;               // lanes per position in the score pass
  constexpr int VN = Vec<TKV>::N;
  constexpr int T = WARPS * PW;              // positions per round of the CTA's warps
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.G, D = a.D, GD = G * D;
  const Sink<TQ> sink(a);

  int lo, end;
  span_window(a, lo, end);
  if (end <= lo) {
    sink.empty();
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* wo = q_s + GD;
  float* wm = wo + WARPS * GD;
  float* wl = wm + WARPS * MAX_G;
  int* tab_s = reinterpret_cast<int*>(wl + WARPS * MAX_G);
  const int KS = k_stride<TKV>(D);
  const size_t stage = fma_stage_bytes<TKV>(D, PW);
  unsigned char* ring = reinterpret_cast<unsigned char*>(tab_s + MAX_SPLIT) + warp * 2 * stage;

  const TQ* q = static_cast<const TQ*>(a.q) + sink.row * GD;
  for (int i = tid; i < GD; i += THREADS) q_s[i] = to_float(q[i]);
  load_table(a, lo, end, tab_s);
  __syncthreads();                           // q_s and the table slice visible

  const Rows rows{tab_s, lo / a.bs, a.bs, (int)blockIdx.x, a.Hkv};
  const TKV* k = static_cast<const TKV*>(a.k);
  const TKV* v = static_cast<const TKV*>(a.v);
  const int rc = D / VN;                     // 16-byte chunks of a row

  // this warp's slab i: positions p0 .. p0 + n - 1 of the window
  auto slab_start = [&](int i) { return lo + i * T + warp * PW; };
  auto slab_n = [&](int i) { return max(0, min(PW, end - slab_start(i))); };
  auto k_slab = [&](int st) { return reinterpret_cast<TKV*>(ring + st * stage); };
  auto issue = [&](int i, int st) {
    const int p0 = slab_start(i), n = slab_n(i);
    TKV* ks = k_slab(st);
    TKV* vs = ks + PW * KS;
    for (int c = lane; c < n * rc; c += 32) {
      const int r = c / rc, d0 = (c % rc) * VN;
      const long long at = (long long)rows.index(p0 + r) * D + d0;
      cp_async16(ks + r * KS + d0, k + at, 16);
      cp_async16(vs + r * D + d0, v + at, 16);
    }
    if constexpr (QUANT) {
      float* sc = reinterpret_cast<float*>(vs + PW * D);
      for (int r = lane; r < n; r += 32) {
        const int at = rows.index(p0 + r);
        cp_async4(sc + r, a.k_scale + at, 4);
        cp_async4(sc + PW + r, a.v_scale + at, 4);
      }
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
    const TKV* ks = k_slab(st);
    const TKV* vs = ks + PW * KS;
    const float* sc = reinterpret_cast<const float*>(vs + PW * D);   // 1-byte pools

    // rows at or past n hold an earlier slab's rows or nothing: never read
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
    float kq = 1.f, vq = 1.f;                // the lane's row scales
    if constexpr (QUANT) {
      if (j < n) {
        kq = sc[j];
        vq = sc[PW + j];
      }
    }
    float p[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        if constexpr (LPP == 2) s[g] += __shfl_xor_sync(0xffffffffu, s[g], 16);
        const float x = j < n ? s[g] * kq * a.scale : NEG_INF;
        const float mn = fmaxf(m[g], warp_max(x, 32));
        const float corr = expf(m[g] - mn);
        p[g] = j < n ? expf(x - mn) : 0.f;
        l[g] = l[g] * corr + (dh == 0 ? p[g] : 0.f);     // lane-partial denominators
#pragma unroll
        for (int dd = 0; dd < MAX_DPL; ++dd) acc[g][dd] *= corr;
        m[g] = mn;
        p[g] *= vq;                          // a quantized V's scale rides on p
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

  // merge the four warps' states, then write the span
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      const float lw = warp_sum(l[g], 32);
      if (lane == 0) {
        wm[warp * MAX_G + g] = m[g];
        wl[warp * MAX_G + g] = lw;
      }
#pragma unroll
      for (int dd = 0; dd < MAX_DPL; ++dd) {
        const int d = lane + 32 * dd;
        if (d < D) wo[warp * GD + g * D + d] = acc[g][dd];
      }
    }
  }
  __syncthreads();
  sink.write(wm, wl, wo, GD);
}

template <typename TKV, int DP>
int launch_mma(const Args& a, cudaStream_t st) {
  constexpr size_t smem = mma_smem_bytes<TKV, DP>();
  static std::atomic<size_t> allowed{0};
  const cudaError_t err =
      allow_smem((const void*)paged_split_mma_kernel<TKV, DP>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  paged_split_mma_kernel<TKV, DP><<<dim3(a.Hkv, a.B, a.n_split), THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int PW>
int launch_fma(const Args& a, cudaStream_t st) {
  const size_t smem = fma_smem_bytes<TKV>(a.G, a.D, PW);
  static std::atomic<size_t> allowed{0};
  const cudaError_t err = allow_smem(
      (const void*)paged_split_fma_kernel<TQ, TKV, PW>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  paged_split_fma_kernel<TQ, TKV, PW><<<dim3(a.Hkv, a.B, a.n_split), THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The kernel for the types (bf16 q over a bf16/fp8/int8 pool -> tensor
// cores, else CUDA cores), then the merge of the partials when there are
// several spans.
template <typename TQ, typename TKV>
int launch(const Args& a, cudaStream_t st) {
  if (a.D % Vec<TKV>::N) return (int)cudaErrorInvalidValue;
  // scales exactly when the pool is quantized
  if (Quantized<TKV>::value != (a.k_scale != nullptr) ||
      (a.k_scale == nullptr) != (a.v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  int err;
  if constexpr (std::is_same<TQ, bf16>::value && !std::is_same<TKV, float>::value) {
    err = a.D <= 32 ? launch_mma<TKV, 32>(a, st)
        : a.D <= 64 ? launch_mma<TKV, 64>(a, st) : launch_mma<TKV, 128>(a, st);
  } else {
    err = slab_positions<TKV>(a.D) == 32 ? launch_fma<TQ, TKV, 32>(a, st)
                                         : launch_fma<TQ, TKV, 16>(a, st);
  }
  if (err != (int)cudaSuccess || a.n_split == 1) return err;
  span_combine_kernel<TQ><<<dim3(a.Hkv, a.B), COMBINE_THREADS, 0, st>>>(
      a.ws, static_cast<TQ*>(a.out), a.lse, a.Hkv, a.G, a.D, a.n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hkv*G, D) contiguous; k/v pools (N, Hkv, bs, D) contiguous;
// k_scale/v_scale (N, Hkv, bs) f32 contiguous for an fp8/int8 pool, else
// null; tables (B, MB) int32 contiguous, entries in [0, N); lengths (B,) int32;
// starts (B,) int32 or null (0); out (B, Hkv*G, D) contiguous, of q's
// type; lse (B, Hkv, G) f32 or null (not written).  CTA z of a row takes
// positions [z * split, (z + 1) * split), split <= 256; with n_split > 1,
// ws holds B * Hkv * n_split * G * (D + 2) f32 and a second kernel merges
// the partials.  Launches on `stream` and returns cudaGetLastError().
extern "C" int paged_decode_attention_launch(const void* q, const void* k, const void* v,
                                             const void* k_scale, const void* v_scale,
                                             const void* tables, const void* lengths,
                                             const void* starts, void* out, void* lse,
                                             void* ws, int B, int MB, int Hkv, int bs, int G,
                                             int D, float scale, int split, int n_split,
                                             int q_dtype, int kv_dtype, void* stream) {
  if (G < 1 || G > MAX_G || D < 1 || D > MAX_D || bs < 1 || MB < 1 ||
      split < 1 || split > MAX_SPLIT || n_split < 1 || (n_split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B < 1 || Hkv < 1) return (int)cudaSuccess;
  const Args a{q, k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
               static_cast<const int*>(tables), static_cast<const int*>(lengths),
               static_cast<const int*>(starts), out, static_cast<float*>(lse),
               static_cast<float*>(ws), B, MB, Hkv, bs, G, D, scale, split, n_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == BF16 && kv_dtype == BF16) return launch<bf16, bf16>(a, st);
  if (q_dtype == F32 && kv_dtype == BF16) return launch<float, bf16>(a, st);
  if (q_dtype == F32 && kv_dtype == F32) return launch<float, float>(a, st);
  if (q_dtype == BF16 && kv_dtype == F32) return launch<bf16, float>(a, st);
  if (q_dtype == BF16 && kv_dtype == FP8_E4M3) return launch<bf16, __nv_fp8_e4m3>(a, st);
  if (q_dtype == F32 && kv_dtype == FP8_E4M3) return launch<float, __nv_fp8_e4m3>(a, st);
  if (q_dtype == BF16 && kv_dtype == INT8) return launch<bf16, int8_t>(a, st);
  if (q_dtype == F32 && kv_dtype == INT8) return launch<float, int8_t>(a, st);
  return (int)cudaErrorInvalidValue;
}
