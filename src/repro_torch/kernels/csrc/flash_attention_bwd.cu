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
// peak, against ~0.05 ms of traffic at 3.35 TB/s.  Without atomics the two
// kernels below recompute S and dP: seven products for the bound's five.
// On mma.sync what holds them back is issue and latency (8 warps an SM,
// each running products and the elementwise in turn) and shared-memory
// operand reads, so the design aims at those:
//  * 32-row warp tiles: each B fragment read from shared memory feeds two
//    m16n8k16 products, half the reads per product of 16-row warps;
//  * the next fragment loads while the current ones multiply, and both
//    score products (S and dP) issue before the elementwise pass (the mma
//    asm keeps program order, so the source order is the issue order);
//  * the streamed tiles go through a ring of cp.async stages, the next
//    tile loading while one is used; two CTAs of 4 warps an SM;
//  * a warp skips a step whose columns its rows cannot see; only steps on
//    the diagonal or at S are masked; exp2 is one MUFU.EX2 (ftz).
//
// bf16 (the train path) runs on the tensor cores, two kernels on one
// stream, no float atomics (a rerun gives the same bits, which the
// trainer's bit-equal resume relies on):
//  * dQ first: one CTA per (query block of 128, batch, head), the last
//    query block (the most key tiles) launched first.  Its prologue
//    computes delta = rowsum(dO * O) of its rows from the dO and O tiles
//    and writes it for dK/dV, so there is no delta pass.  Each warp holds
//    its 32 rows of Q and dO as mma A fragments, and their lse and delta,
//    in registers; 64-key tiles of K and V stream through the ring up to
//    the diagonal, 16 keys a step.
//  * dK/dV: one CTA per (key block of 128, batch, KV head), key block 0
//    (every query tile of the G heads) first.  The (query head, 64-query
//    tile) pairs at or after the block are one flat loop, so the ring of
//    Q, dO, lse and delta tiles runs across head boundaries and the
//    group's sum stays in the CTA; 16 queries a step.  K and V are read
//    from shared memory: as fragments beside the two 32-row f32
//    accumulators they would spill.
// At D 128 the accumulators alone take 64 to 128 registers a thread: 8
// warps of 16 rows per CTA (Tile below).  Numerics are the forward's: P
// and dS rounded to bf16 as A operands, every sum f32, P recomputed as
// exp2(s * scale * log2e - lse * log2e), masked entries exactly 0 (never
// exp of a mask value, so a fully masked row gives no NaN).  Rows past S
// are zero-filled.
//
// f32 (float32 mode, reduced checks only) runs a delta pass and two f32 FMA
// kernels with 4 x 8 thread tiles over 64-row tiles, loaded and used
// without pipelining.
#include "common.cuh"

namespace {

using namespace repro;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;               // the f32 kernels
constexpr int BLK = 64;                    // f32: queries or keys per tile
constexpr int MAX_D = 128;
constexpr int MAX_G = 8;
constexpr float LOG2E = 1.4426950408889634f;

// --------------------------------------------------------- delta (f32)
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
constexpr int TILE = 64;                   // rows of a streamed tile (one ring stage)
// The warp tiles.  A CTA is WARPS warps; a warp owns MT x 16 rows (keys in
// dK/dV, queries in dQ) and takes a streamed tile NJ x 16 columns at a
// time.  dQ holds its fixed A operands (Q, dO) as fragments in registers;
// dK/dV reads K and V from shared memory (beside two f32 accumulators its
// fragments would spill).  Up to DP 64: 4 warps of 32 rows, two CTAs an SM
// (ptxas at DP 64: 218 registers dQ, 242 dK/dV, no spills); at DP 128 the
// accumulators take 64 to 128 registers a 16-row warp: 8 warps of 16 rows,
// one CTA an SM.  Chosen on the H100 at llama3.2-1b's and minicpm-2b's
// training shapes (PERF.md).
constexpr int RING = 2;                    // stages of streamed tiles

template <int DP>
struct Tile {
  static constexpr bool SMALL_D = DP <= 64;
  static constexpr int WARPS = SMALL_D ? 4 : 8;
  static constexpr int MT = SMALL_D ? 2 : 1;
  static constexpr int NJ = SMALL_D ? 1 : 2;
  static constexpr int MIN_BLOCKS = SMALL_D ? 2 : 1;       // CTAs an SM must hold
  static constexpr int ROWS = WARPS * MT * 16;     // keys or queries of a CTA
  static constexpr int LD = DP + 8;        // shared row stride: ldmatrix without bank conflicts
  static constexpr int KSTEPS = DP / 16, DN = DP / 8;
};

// 2^x, flushing a subnormal result to 0 (one MUFU.EX2).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The A fragments of 16 rows a (stride LD), one per k-step.
template <int KSTEPS, int LD>
__device__ __forceinline__ void load_a(uint32_t (*af)[4], const bf16* a, int lane) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(af[kk], a + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
}

// s (MT x 16 rows by NJ x 16 columns, mma c layout: s[m][j] covers columns
// 8j..8j+7) = A B^T over the DP columns (past D both are zero).  A: the
// warp's rows, as fragments af[m][kk] (REGS; a unused) or from shared
// memory a (stride LD; af unused); B: 16 NJ rows bt.  Each B fragment feeds MT products, and
// the next fragments load while the current ones multiply (the asm keeps
// program order).
template <int MT, int NJ, bool REGS, int KSTEPS, int LD, typename AF>
__device__ __forceinline__ void mma_abt(float (&s)[MT][2 * NJ][4], const AF& af, const bf16* a,
                                        const bf16* bt, int lane) {
  const bf16* b_lane = bt + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  const bf16* a_lane = REGS ? a : a + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j) s[m][j][0] = s[m][j][1] = s[m][j][2] = s[m][j][3] = 0.f;
  uint32_t bk[2][4], am[2][MT][4];
  ldmatrix_x4(bk[0], b_lane);
  if constexpr (!REGS) {
#pragma unroll
    for (int m = 0; m < MT; ++m) ldmatrix_x4(am[0][m], a_lane + m * 16 * LD);
  }
#pragma unroll
  for (int t = 0; t < KSTEPS * NJ; ++t) {
    const int kk = t / NJ, j = t % NJ, tn = t + 1;
    if (tn < KSTEPS * NJ) {
      ldmatrix_x4(bk[tn & 1], b_lane + (tn % NJ) * 16 * LD + (tn / NJ) * 16);
      if constexpr (!REGS) {
        if (tn % NJ == 0) {
#pragma unroll
          for (int m = 0; m < MT; ++m)
            ldmatrix_x4(am[(tn / NJ) & 1][m], a_lane + m * 16 * LD + (tn / NJ) * 16);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const uint32_t* fa;
      if constexpr (REGS)
        fa = af[m][kk];
      else
        fa = am[kk & 1][m];
      mma_bf16_16816(s[m][2 * j], fa, bk[t & 1][0], bk[t & 1][1]);
      mma_bf16_16816(s[m][2 * j + 1], fa, bk[t & 1][2], bk[t & 1][3]);
    }
  }
}

// o (MT x 16 rows by DP) += P X: P in s (as mma_abt leaves it) rounded to
// bf16 as the A operand, X 16 NJ rows xt by DP (stride LD).  Each B
// fragment feeds MT products; the next one loads while they run.
template <int MT, int NJ, int DN, int LD>
__device__ __forceinline__ void mma_px(float (&o)[MT][DN][4], const float (&s)[MT][2 * NJ][4],
                                       const bf16* xt, int lane) {
  constexpr int NDN = DN / 2;              // pairs of output tiles
  const bf16* x_lane = xt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
  uint32_t bv[2][4], pa[MT][4];
  ldmatrix_x4_trans(bv[0], x_lane);
#pragma unroll
  for (int t = 0; t < NJ * NDN; ++t) {
    const int kk = t / NDN, dn = t % NDN, tn = t + 1;   // 16 rows of X per k-step
    if (dn == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* p0 = s[m][2 * kk];
        const float* p1 = s[m][2 * kk + 1];
        pa[m][0] = pack_bf16(p0[0], p0[1]);
        pa[m][1] = pack_bf16(p0[2], p0[3]);
        pa[m][2] = pack_bf16(p1[0], p1[1]);
        pa[m][3] = pack_bf16(p1[2], p1[3]);
      }
    }
    if (tn < NJ * NDN)
      ldmatrix_x4_trans(bv[tn & 1], x_lane + (tn / NDN) * 16 * LD + (tn % NDN) * 16);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      mma_bf16_16816(o[m][2 * dn], pa[m], bv[t & 1][0], bv[t & 1][1]);
      mma_bf16_16816(o[m][2 * dn + 1], pa[m], bv[t & 1][2], bv[t & 1][3]);
    }
  }
}

// NR rows of head h (rows r0.., global row stride Hn heads of D) into
// shared memory with 16-byte cp.async by NT threads; rows past S are
// zero-filled.
template <int NR, int NT>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src, int b, int r0, int h,
                                           int S, int Hn, int D, int LD, int tid) {
  const int dchunks = D / 8;
  for (int c = tid; c < NR * dchunks; c += NT) {
    const int r = c / dchunks, d0 = (c % dchunks) * 8;
    const bool ok = r0 + r < S;
    const long long off = ok ? (((long long)b * S + r0 + r) * Hn + h) * D + d0 : 0;
    cp_async16(dst + r * LD + d0, src + off, ok ? 16 : 0);
  }
}

// lse and delta of the TILE query rows q0.. of (batch, head) bh, by
// threads [0, 2 TILE) with 4-byte cp.async; rows past S read 0.
__device__ __forceinline__ void stats_async(float* lse_s, float* dl_s, const float* lse,
                                            const float* delta, long long bh, int q0, int S,
                                            int tid) {
  if (tid < 2 * TILE) {
    const int r = tid % TILE;
    const bool ok = q0 + r < S;
    const long long off = ok ? bh * S + q0 + r : 0;
    if (tid < TILE)
      cp_async4(lse_s + r, lse + off, ok ? 4 : 0);
    else
      cp_async4(dl_s + r, delta + off, ok ? 4 : 0);
  }
}

template <int NT>
__device__ __forceinline__ void zero_pad(bf16* base, int n_rows, int D, int DP, int LD,
                                         int tid) {
  if (D < DP) {                            // cp.async never writes columns [D, DP)
    const int pad = DP - D;
    for (int i = tid; i < n_rows * pad; i += NT)
      base[(i / pad) * LD + D + i % pad] = __float2bfloat16(0.f);
  }
}

// 16 rows of a warp's accumulator (c layout) times mul, as bf16.
template <int DN>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[DN][4], float mul,
                                           int b, int row0, int h, int S, int Hn, int D,
                                           int gid, int tig) {
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
constexpr size_t dkdv_smem_bytes() {
  using T = Tile<DP>;
  return sizeof(bf16) * (2 * T::ROWS + RING * 2 * TILE) * T::LD +
         sizeof(float) * RING * 2 * TILE;
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  using T = Tile<DP>;
  return sizeof(bf16) * (2 * T::ROWS + RING * 2 * TILE) * T::LD;
}

// dK, dV of a block of keys of KV head hk: the warp's MT x 16 keys are the
// A rows of S^T = K Q^T and dP^T = V dO^T.  Reads the delta dQ wrote.
template <int DP>
__global__ void __launch_bounds__(Tile<DP>::WARPS * 32, Tile<DP>::MIN_BLOCKS)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int S, int Hq,
                          int Hkv, int D, float scale) {
  using T = Tile<DP>;
  constexpr int LD = T::LD, KSTEPS = T::KSTEPS, DN = T::DN, MT = T::MT, NJ = T::NJ;
  constexpr int NT = T::WARPS * 32, BK = T::ROWS, WR = 16 * MT, STEP = 16 * NJ;
  static_assert(NT >= 2 * TILE, "stats_async loads with 2 TILE threads");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + BK * LD;
  bf16* ring = v_s + BK * LD;              // stage st: Q at ring + 2 st TILE LD, dO after it
  float* stats = reinterpret_cast<float*>(ring + RING * 2 * TILE * LD);   // st: lse, delta
  const int G = Hq / Hkv;
  int idx = blockIdx.x;                    // (key block, batch, KV head), key block 0 first
  const int hk = idx % Hkv;
  idx /= Hkv;
  const int b = idx % B, k0 = idx / B * BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int key_lo = k0 + warp * WR;
  const float sl2 = scale * LOG2E;
  const int nq = (S - k0 + TILE - 1) / TILE, n = G * nq;   // flat (query head, query tile)

  zero_pad<NT>(k_s, 2 * BK + RING * 2 * TILE, D, DP, LD, tid);
  tile_async<BK, NT>(k_s, k, b, k0, hk, S, Hkv, D, LD, tid);
  tile_async<BK, NT>(v_s, v, b, k0, hk, S, Hkv, D, LD, tid);
  cp_async_commit();
  auto load = [&](int i) {
    if (i < n) {
      const int g = i / nq, q0 = k0 + (i - g * nq) * TILE, st = i % RING;
      const long long bh = (long long)b * Hq + hk * G + g;
      bf16* q_st = ring + st * 2 * TILE * LD;
      tile_async<TILE, NT>(q_st, q, b, q0, hk * G + g, S, Hq, D, LD, tid);
      tile_async<TILE, NT>(q_st + TILE * LD, dout, b, q0, hk * G + g, S, Hq, D, LD, tid);
      stats_async(stats + st * 2 * TILE, stats + st * 2 * TILE + TILE, lse, delta, bh, q0, S,
                  tid);
    }
    cp_async_commit();                     // empty past the end: one group per iteration
  };
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) load(i);
  cp_async_wait<RING - 1>();               // the K, V group
  __syncthreads();
  float dk_acc[MT][DN][4], dv_acc[MT][DN][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[m][dn][e] = dv_acc[m][dn][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<RING - 2>();
    __syncthreads();                       // tile i landed; stage (i - 1) % RING is consumed
    load(i + RING - 1);
    const int g = i / nq, q0 = k0 + (i - g * nq) * TILE, st = i % RING;
    const bf16* q_st = ring + st * 2 * TILE * LD;
    const bf16* do_st = q_st + TILE * LD;
    const float* lse_st = stats + st * 2 * TILE;
    const float* dl_st = lse_st + TILE;
#pragma unroll
    for (int cs = 0; cs < TILE; cs += STEP) {
      const int qc = q0 + cs;
      if (key_lo > qc + STEP - 1 || key_lo >= S || qc >= S) continue;  // nothing visible
      const bool edge = key_lo + WR - 1 > qc || qc + STEP > S;
      float p[MT][2 * NJ][4], ds[MT][2 * NJ][4];   // S^T, dP^T: the warp's keys x STEP queries
      mma_abt<MT, NJ, false, KSTEPS, LD>(p, nullptr, k_s + warp * WR * LD, q_st + cs * LD, lane);
      mma_abt<MT, NJ, false, KSTEPS, LD>(ds, nullptr, v_s + warp * WR * LD, do_st + cs * LD,
                                         lane);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = cs + j * 8 + tig * 2 + (e & 1);
            float x = exp2_ftz(p[m][j][e] * sl2 - lse_st[c] * LOG2E);
            if (edge) {
              const int qp = q0 + c;
              x = qp < S && qp >= key_lo + m * 16 + gid + 8 * (e >> 1) ? x : 0.f;
            }
            p[m][j][e] = x;
            ds[m][j][e] = x * (ds[m][j][e] - dl_st[c]);
          }
      mma_px<MT, NJ, DN, LD>(dv_acc, p, do_st + cs * LD, lane);            // dV += P^T dO
      mma_px<MT, NJ, DN, LD>(dk_acc, ds, q_st + cs * LD, lane);          // dK += dS^T Q
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    store_rows<DN>(dk, dk_acc[m], scale, b, key_lo + m * 16, hk, S, Hkv, D, gid, tig);
    store_rows<DN>(dv, dv_acc[m], 1.f, b, key_lo + m * 16, hk, S, Hkv, D, gid, tig);
  }
}

// dQ of a block of queries of head h, and delta = rowsum(dO * O) of those
// rows for the dK/dV kernel: the warp's MT x 16 queries are the A rows of
// S = Q K^T and dP = dO V^T.
template <int DP>
__global__ void __launch_bounds__(Tile<DP>::WARPS * 32, Tile<DP>::MIN_BLOCKS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, bf16* __restrict__ dq, int B, int S, int Hq,
                        int Hkv, int D, float scale) {
  using T = Tile<DP>;
  constexpr int LD = T::LD, KSTEPS = T::KSTEPS, DN = T::DN, MT = T::MT, NJ = T::NJ;
  constexpr int NT = T::WARPS * 32, BQ = T::ROWS, WR = 16 * MT, STEP = 16 * NJ;
  constexpr int LPR = 32 / WR;             // lanes per row of the delta sums
  static_assert(BQ <= 2 * TILE, "the O tile borrows the last ring stage");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + BQ * LD;
  bf16* ring = do_s + BQ * LD;             // stage st: K at ring + 2 st TILE LD, V after it
  // O is read once, before the loop: it borrows the last stage, which the
  // first iteration fills after its barrier.
  bf16* o_s = ring + (RING - 1) * 2 * TILE * LD;
  const int nqb = (S + BQ - 1) / BQ;
  int idx = blockIdx.x;                    // (query block, batch, head), the last block first
  const int h = idx % Hq;
  idx /= Hq;
  const int b = idx % B, q0 = (nqb - 1 - idx / B) * BQ;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int row_lo = q0 + warp * WR;
  const float sl2 = scale * LOG2E;
  const long long bh = (long long)b * Hq + h;
  const int n = (min(S, q0 + BQ) + TILE - 1) / TILE;      // key tiles up to the diagonal

  zero_pad<NT>(q_s, 2 * BQ + RING * 2 * TILE, D, DP, LD, tid);
  tile_async<BQ, NT>(q_s, q, b, q0, h, S, Hq, D, LD, tid);
  tile_async<BQ, NT>(do_s, dout, b, q0, h, S, Hq, D, LD, tid);
  tile_async<BQ, NT>(o_s, o, b, q0, h, S, Hq, D, LD, tid);
  cp_async_commit();
  auto load = [&](int i) {
    if (i < n) {
      bf16* k_st = ring + (i % RING) * 2 * TILE * LD;
      tile_async<TILE, NT>(k_st, k, b, i * TILE, hk, S, Hkv, D, LD, tid);
      tile_async<TILE, NT>(k_st + TILE * LD, v, b, i * TILE, hk, S, Hkv, D, LD, tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) load(i);
  float lse2[MT][2], dl[MT][2];            // rows m * 16 + gid (+ 8) of the warp
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row_lo + m * 16 + gid + 8 * i;
      lse2[m][i] = r < S ? lse[bh * S + r] * LOG2E : 0.f;
    }
  cp_async_wait<RING - 1>();               // the Q, dO, O group
  __syncthreads();
  {                                        // delta: LPR lanes sum parts of row lane / LPR
    const int r = lane / LPR, c0 = (lane % LPR) * (DP / LPR);
    const bf16* dr = do_s + (warp * WR + r) * LD + c0;
    const bf16* orow = o_s + (warp * WR + r) * LD + c0;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < DP / LPR; c += 8) {
      float x[8], y[8];
      load16(dr + c, x);
      load16(orow + c, y);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += x[e] * y[e];
    }
    if constexpr (LPR == 2) acc += __shfl_xor_sync(0xffffffffu, acc, 1);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        dl[m][i] = __shfl_sync(0xffffffffu, acc, (m * 16 + gid + 8 * i) * LPR);
    if (lane % LPR == 0 && row_lo + r < S) delta[bh * S + row_lo + r] = acc;
  }
  uint32_t qf[MT][KSTEPS][4], dof[MT][KSTEPS][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    load_a<KSTEPS, LD>(qf[m], q_s + (warp * WR + m * 16) * LD, lane);
    load_a<KSTEPS, LD>(dof[m], do_s + (warp * WR + m * 16) * LD, lane);
  }
  float dq_acc[MT][DN][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq_acc[m][dn][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<RING - 2>();
    __syncthreads();                       // tile i landed; stage (i - 1) % RING is consumed
    load(i + RING - 1);
    const bf16* k_st = ring + (i % RING) * 2 * TILE * LD;
    const bf16* v_st = k_st + TILE * LD;
#pragma unroll
    for (int ks = 0; ks < TILE; ks += STEP) {
      const int kc = i * TILE + ks;
      if (kc > row_lo + WR - 1 || row_lo >= S || kc >= S) continue;      // nothing visible
      const bool edge = kc + STEP - 1 > row_lo || row_lo + WR > S;
      float p[MT][2 * NJ][4], ds[MT][2 * NJ][4];   // P and dP = dO V^T: rows x STEP keys
      mma_abt<MT, NJ, true, KSTEPS, LD>(p, qf, nullptr, k_st + ks * LD, lane);
      mma_abt<MT, NJ, true, KSTEPS, LD>(ds, dof, nullptr, v_st + ks * LD, lane);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = exp2_ftz(p[m][j][e] * sl2 - lse2[m][e >> 1]);
            if (edge) {
              const int qp = row_lo + m * 16 + gid + 8 * (e >> 1);
              x = qp < S && kc + j * 8 + tig * 2 + (e & 1) <= qp ? x : 0.f;
            }
            ds[m][j][e] = x * (ds[m][j][e] - dl[m][e >> 1]);
          }
      mma_px<MT, NJ, DN, LD>(dq_acc, ds, k_st + ks * LD, lane);          // dQ += dS K
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
    store_rows<DN>(dq, dq_acc[m], scale, b, row_lo + m * 16, h, S, Hq, D, gid, tig);
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
int launch_mma(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S,
               int Hq, int Hkv, int D, float scale, cudaStream_t st) {
  using T = Tile<DP>;
  constexpr size_t smem_kv = dkdv_smem_bytes<DP>(), smem_q = dq_smem_bytes<DP>();
  static std::atomic<size_t> allowed_kv{0}, allowed_q{0};
  cudaError_t err = allow_smem((const void*)flash_bwd_dkdv_mma_kernel<DP>, smem_kv, allowed_kv);
  if (err == cudaSuccess)
    err = allow_smem((const void*)flash_bwd_dq_mma_kernel<DP>, smem_q, allowed_q);
  if (err != cudaSuccess) return (int)err;
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* db = static_cast<const bf16*>(dout);
  const long long q_blocks = (long long)((S + T::ROWS - 1) / T::ROWS) * B * Hq;
  const long long kv_blocks = (long long)((S + T::ROWS - 1) / T::ROWS) * B * Hkv;
  if (q_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_bwd_dq_mma_kernel<DP><<<(unsigned)q_blocks, T::WARPS * 32, smem_q, st>>>(
      qb, kb, vb, static_cast<const bf16*>(o), db, lse, delta, static_cast<bf16*>(dq), B, S,
      Hq, Hkv, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_mma_kernel<DP><<<(unsigned)kv_blocks, T::WARPS * 32, smem_kv, st>>>(
      qb, kb, vb, db, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, S, Hq, Hkv,
      D, scale);
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
// G = Hq / Hkv <= 8, D <= 128 and D % 8 == 0.  Launches on `stream` the
// dQ kernel (which writes delta) and then the dK/dV kernel for bf16; the
// delta, dK/dV and dQ kernels for f32.  Returns the first CUDA error.
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
#define REPRO_MMA(DP) \
  launch_mma<DP>(q, k, v, o, dout, lsef, dl, dq, dk, dv, B, S, Hq, Hkv, D, scale, st)
  if (D <= 32) return REPRO_MMA(32);
  if (D <= 64) return REPRO_MMA(64);
  return REPRO_MMA(128);
#undef REPRO_MMA
}
