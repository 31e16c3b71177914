// K2: fused cosine score + streaming top-k over the vector lane.
//
// Replaces libsplinter_tpu/ops/similarity.py `_fused_topk_kernel`
// (reached through `_fused_topk_fn` / `topk_program`, k <= 128).  On
// the TPU the running top-k lives in an output block that every
// SEQUENTIAL grid step revisits.  CUDA blocks run concurrently and in
// no order, so the work splits in two passes:
//
//   1. partial: each block walks a strided set of TN-row tiles, scores
//      a tile against its TQ queries with the register-blocked f32
//      tile of topk_tile.cuh (cp.async ring of whole 128-byte lines,
//      float4 operands, up to 8 x 16 accumulators a thread), and keeps
//      one sorted top-k list per query: in its slice of the (nq, nblk,
//      k) candidate arrays, which the merge pass reads.  Selection
//      starts in registers: a thread keeps only the scores that beat
//      both its query's k-th list entry and the query's published
//      bound (below), and pushes those survivors into a buffer of 32
//      per query in shared memory.  Only a buffer that fills stops the
//      block: one warp per query then loads the list into registers
//      (four entries a lane), finds each survivor's place by a binary
//      search over the registers (shuffles), shifts the entries and
//      writes the new list back, all in one step.
//   2. merge: one block per query repeatedly takes the best head of
//      the blocks' sorted lists.
//
// The published bounds: a block whose list holds k / 8 real entries
// publishes its (k / 8)-th score to slot (block % 8) of the query's
// eight slots in gslot (an atomic max).  Eight slots are eight distinct
// blocks, each with k / 8 rows scoring at least its value, so k rows of
// the lane score at least the smallest slot, and so does the final
// k-th score: a row scoring below that bound cannot be in the answer,
// and every block may drop it.  Rows that EQUAL it may still be (ties
// go to the smaller row), so the test is strict.  A block reads the
// bounds back when it merges; after its first tiles its survivors are
// the rows that beat the whole lane's running top k / 8, not its own
// top k, and its buffers seldom fill.
//
// Survivors arrive in no row order, so every comparison is on the
// pair (score, row): an equal score with a smaller row displaces the
// k-th entry, and a masked score (NEG_INF) never beats the list's
// (NEG_INF, -1) filler, so no filler slot takes a real row.  Both
// passes order by (score desc, global row asc) — lax.top_k's order,
// ties and all — and a list slot never filled is the filler
// (NEG_INF, -1).  Masked and zero-norm rows score NEG_INF in the tile
// and never enter a list.
//
// Bound on an H100: the lane read (3.2 GB at 1M x 768 f32) for small
// q; f32 FMA for q = 256 (2 * n * d * q FLOPs over 67 TFLOP/s).  The
// narrow tiles (8, 32 queries) are a streaming problem: 16-byte copies
// of whole lines, enough bytes in flight an SM.  The wide one (256
// queries) is a GEMM: 8 x 16 accumulators a thread, float4 operands
// from conflict-free shared memory.  The lists live
// outside shared memory, so a block holds 256 queries at any k and
// q = 256 reads the lane once.
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "topk_tile.cuh"

namespace {

using namespace tk;

constexpr unsigned FULL = 0xffffffffu;
constexpr int KMAX = 128;  // list length limit (the reference's FUSED_K_MAX)
constexpr int LW = KMAX / 32;  // list entries a lane holds in a merge
constexpr int CAP = 32;    // survivors buffered per query (one a lane)
constexpr int GSLOTS = 8;  // published bounds per query (k / 8 deep)
constexpr int SMEM_MAX = 232448;  // a block's shared memory on sm_90

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// atomic max of a float in global memory (no NaN reaches it)
__device__ __forceinline__ void atomic_max_f32(float* p, float v) {
  if (v >= 0.f)
    atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
}

// Merge c <= 32 candidates (cs, ci; distinct rows, any order) into one
// sorted list (Lg scores, Ig rows, length k) in global memory, by
// (score desc, row asc); those that land at or past k fall away.  Lane
// l holds entries l, l + 32, ...  A candidate's new slot is the entries
// better than it (a binary search over the warp's registers) plus the
// candidates better than it; an entry's is its slot plus the
// candidates better than it, i.e. those whose search stopped at or
// before it.  Returns the new k-th entry in (th, tr) and the new
// (k / 8)-th in (bs, br).
__device__ __forceinline__ void warp_merge(float* Lg, int* Ig, int k,
                                           const float* cs, const int* ci,
                                           int c, int lane, float& th,
                                           int& tr, float& bs, int& br) {
  float es[LW];
  int ei[LW];
#pragma unroll
  for (int e = 0; e < LW; ++e) {
    const int p = lane + 32 * e;
    es[e] = p < k ? __ldcg(Lg + p) : NEG_INF;
    ei[e] = p < k ? __ldcg(Ig + p) : -1;
  }
  const bool has = lane < c;
  const float sv = has ? cs[lane] : NEG_INF;
  const int gi = has ? ci[lane] : -1;
  int lo = 0, hi = k;
#pragma unroll
  for (int step = 0; step < 8; ++step) {  // 2^8 > KMAX
    const int mid = (lo + hi) >> 1, m = min(mid, k - 1);
    float x = 0.f;
    int xi = 0;
#pragma unroll
    for (int e = 0; e < LW; ++e) {  // entry m: lane m % 32, word m / 32
      const float v = __shfl_sync(FULL, es[e], m & 31);
      const int vi = __shfl_sync(FULL, ei[e], m & 31);
      if (e == m >> 5) {
        x = v;
        xi = vi;
      }
    }
    if (lo < hi) {
      if (better(x, xi, sv, gi))
        lo = mid + 1;
      else
        hi = mid;
    }
  }
  if (!has) lo = k;
  int rank = 0;
  int shift[LW] = {};
  for (int o = 0; o < c; ++o) {
    const float os = __shfl_sync(FULL, sv, o);
    const int oi = __shfl_sync(FULL, gi, o);
    const int olo = __shfl_sync(FULL, lo, o);
    rank += better(os, oi, sv, gi);
#pragma unroll
    for (int e = 0; e < LW; ++e) shift[e] += olo <= lane + 32 * e;
  }
#pragma unroll
  for (int e = 0; e < LW; ++e) {
    const int p = lane + 32 * e, to = p + shift[e];
    if (p < k && to < k && shift[e]) {
      Lg[to] = es[e];
      Ig[to] = ei[e];
    }
  }
  if (has && lo + rank < k) {
    Lg[lo + rank] = sv;
    Ig[lo + rank] = gi;
  }
  // the new list's entries k - 1 and k / 8 - 1, from the registers
  auto entry = [&](int m, float& s, int& r) {
    float ms = 0.f;
    int mr = 0;
    bool mine = has && lo + rank == m;
    if (mine) {
      ms = sv;
      mr = gi;
    }
#pragma unroll
    for (int e = 0; e < LW; ++e) {
      const int p = lane + 32 * e;
      if (p < k && p + shift[e] == m) {
        ms = es[e];
        mr = ei[e];
        mine = true;
      }
    }
    const int src = __ffs(__ballot_sync(FULL, mine)) - 1;
    s = __shfl_sync(FULL, ms, src);
    r = __shfl_sync(FULL, mr, src);
  };
  entry(k - 1, th, tr);
  entry(k / GSLOTS - 1, bs, br);
}

template <int TQ>
constexpr int partial_smem_bytes() {
  return 4 * (STAGES * Tile<TQ>::STAGE + 2 * TQ * CAP + 5 * TQ);
}

// two blocks an SM for the 32-query f32 tile (at most 128 registers,
// 90 KB of shared memory each); one for the others, whose ring alone
// takes 108-143 KB (the bf16 arm's roundings need more registers)
template <int TQ, bool BF16>
__global__ void __launch_bounds__(NT, TQ == 32 && !BF16 ? 2 : 1)
    topk_partial_kernel(const float* __restrict__ vec, long long n, int d,
                        const float* __restrict__ qry, int nq,
                        const float* __restrict__ qnorm,
                        const float* __restrict__ mask, int k,
                        long long ntiles, bool vec16, bool qry16,
                        float* __restrict__ gslot,
                        float* __restrict__ cand_s,
                        int* __restrict__ cand_i) {
  using G = Tile<TQ>;
  constexpr int RN = G::RN, QN = G::QN;
  constexpr int PW = (RN * QN + 63) / 64;  // survivor bit words
  // loads of the published bounds per lane: a warp owns TQ / 8 queries
  constexpr int GLOADS = ((TQ + 7) / 8 + 3) / 4;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                           // STAGES x (TN + TQ, LD)
  float* cs = ring + STAGES * G::STAGE;         // (TQ, CAP) pushed
  int* ci = reinterpret_cast<int*>(cs + TQ * CAP);       // their rows
  float* thr = reinterpret_cast<float*>(ci + TQ * CAP);  // k-th score
  int* thi = reinterpret_cast<int*>(thr + TQ);           // k-th row
  int* cnt = thi + TQ;                                   // pushed count
  float* gth = reinterpret_cast<float*>(cnt + TQ);       // bound read
  float* qns = gth + TQ;                                 // query norms

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int q0 = blockIdx.y * TQ;
  const int nql = min(TQ, nq - q0);
  const int qg = t % G::QG, rg = t / G::QG;
  const int nblk = gridDim.x;
  auto list = [&](int ql) {  // this block's list of query q0 + ql
    return ((long long)(q0 + ql) * nblk + blockIdx.x) * k;
  };

  for (int e = t; e < nql * k; e += NT) {
    const long long o = list(e / k) + e % k;
    cand_s[o] = NEG_INF;
    cand_i[o] = -1;
  }
  for (int e = t; e < TQ; e += NT) {
    thr[e] = NEG_INF;
    thi[e] = -1;
    cnt[e] = 0;
    gth[e] = NEG_INF;
    qns[e] = e < nql ? qnorm[q0 + e] : 0.f;
  }

  // Merge the buffers of this warp's queries (warp + 8 u) that hold at
  // least `least` survivors, publish their bounds, and read the
  // published bounds back (lane l reads slot l % 8 of query
  // u = l / 8 + 4 v; the loads fly while the warp merges).
  auto merge_buffers = [&](int least) {
    float gv[GLOADS];
#pragma unroll
    for (int v = 0; v < GLOADS; ++v) {
      const int ql = warp + (NT / 32) * (lane / GSLOTS + 4 * v);
      gv[v] = ql < nql ? __ldcg(gslot + (long long)(q0 + ql) * GSLOTS +
                                lane % GSLOTS)
                       : INFINITY;
    }
    for (int ql = warp; ql < nql; ql += NT / 32) {
      const int c = min(cnt[ql], CAP);
      if (c < least || c == 0) continue;
      float th, bs;
      int tr, br;
      warp_merge(cand_s + list(ql), cand_i + list(ql), k, cs + ql * CAP,
                 ci + ql * CAP, c, lane, th, tr, bs, br);
      if (lane == 0) {
        thr[ql] = th;
        thi[ql] = tr;
        cnt[ql] = 0;
        if (br >= 0)
          atomic_max_f32(gslot + (long long)(q0 + ql) * GSLOTS +
                             blockIdx.x % GSLOTS,
                         bs);
      }
    }
#pragma unroll
    for (int v = 0; v < GLOADS; ++v) {
#pragma unroll
      for (int o = 1; o < GSLOTS; o <<= 1)
        gv[v] = fminf(gv[v], __shfl_xor_sync(FULL, gv[v], o));
      const int ql = warp + (NT / 32) * (lane / GSLOTS + 4 * v);
      if (lane % GSLOTS == 0 && ql < nql) gth[ql] = gv[v];
    }
  };

  // chunk s of this block is column chunk s % nck of its (s / nck)-th
  // tile; the load of chunk s + 1 runs while chunk s is multiplied, and
  // both walk (tile, chunk) with counters rather than divisions
  const int nck = (d + G::DK - 1) / G::DK;
  const long long my_tiles =
      (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long total = my_tiles * nck;
  const long long row_step = (long long)gridDim.x * G::TN;
  const float* qbase = qry + (long long)q0 * d;
  long long lrow0 = (long long)blockIdx.x * G::TN;
  int lkc = 0;
  auto load = [&](long long s) {  // chunk s into stage s % 2
    float* st = ring + (int)(s & 1) * G::STAGE;
    load_chunk<G::TN, G::DK>(st, vec, lrow0, n, d, lkc * G::DK, vec16);
    load_chunk<TQ, G::DK>(st + G::TN * G::LD, qbase, 0, nql, d,
                          lkc * G::DK, qry16);
    cp_commit();
    if (++lkc == nck) {
      lkc = 0;
      lrow0 += row_step;
    }
  };

  load(0);
  float acc[RN][QN], nrm[RN];
#pragma unroll
  for (int i = 0; i < RN; ++i) {
    nrm[i] = 0.f;
#pragma unroll
    for (int j = 0; j < QN; ++j) acc[i][j] = 0.f;
  }
  long long row0 = (long long)blockIdx.x * G::TN;
  int kc = 0;

  for (long long s = 0; s < total; ++s) {
    cp_wait_all();
    __syncthreads();  // chunk s landed; every thread is done with s - 1
    if (s + 1 < total) load(s + 1);
    const float* st = ring + (int)(s & 1) * G::STAGE;
    chunk_mma<TQ, BF16>(st, st + G::TN * G::LD, rg, qg, acc, nrm);
    if (++kc < nck) continue;
    kc = 0;

    // ---- the tile's epilogue: scores, then the survivors ----
    // row norms (0: masked, empty or past n)
    float mk[RN];
#pragma unroll
    for (int i = 0; i < RN; ++i)  // every load issued before any use
      mk[i] = mask == nullptr
                  ? 1.f
                  : __ldg(mask + min(row0 + rg + G::RG * i, n - 1));
#pragma unroll
    for (int i = 0; i < RN; ++i) {
      const float v = sqrtf(nrm[i]);
      nrm[i] = row0 + rg + G::RG * i < n && v > 0.f && mk[i] > 0.f ? v
                                                                   : 0.f;
    }
    // A score s = acc / den (den = max(|v| |q|, 1e-12)) that reaches
    // lim = max(bound, k-th score) has acc >= lim (1 - 2^-24) den, so
    // testing acc against lim (1 - 2^-20) den, a margin far above the
    // rounding of both products, passes every survivor; only what
    // passes is divided and tested exactly, and its score replaces its
    // sum.
    uint64_t pend[PW];
#pragma unroll
    for (int w = 0; w < PW; ++w) pend[w] = 0;
#pragma unroll
    for (int j = 0; j < QN; ++j) {
      const int ql = qg + G::QG * j;
      if (ql >= nql) continue;
      const float qn = qns[ql];
      const float gq = gth[ql];  // the bound, as last read
      const float th = thr[ql];
      const int tr = thi[ql];
      const float lim = fmaxf(gq, th);
      const float lim_lo = lim - fabsf(lim) * 0x1p-20f;
#pragma unroll
      for (int i = 0; i < RN; ++i) {
        const float den = fmaxf(nrm[i] * qn, 1e-12f);
        if (!(nrm[i] > 0.f) || acc[i][j] < lim_lo * den) continue;
        const float sc = acc[i][j] / den;
        const int b = i * QN + j;
        if (sc >= gq && better(sc, (int)(row0 + rg + G::RG * i), th, tr)) {
          acc[i][j] = sc;
          pend[b / 64] |= 1ull << (b % 64);
        }
      }
    }
    // push the survivors; while any buffer is full, merge the fuller
    // half and push the rest against the raised k-th entries
    while (true) {
      bool left = false;
#pragma unroll
      for (int i = 0; i < RN; ++i)
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          const int b = i * QN + j;
          const uint64_t bit = 1ull << (b % 64);
          if (!(pend[b / 64] & bit)) continue;
          const int ql = qg + G::QG * j;
          const int slot = atomicAdd(&cnt[ql], 1);
          if (slot < CAP) {
            cs[ql * CAP + slot] = acc[i][j];
            ci[ql * CAP + slot] = (int)(row0 + rg + G::RG * i);
            pend[b / 64] &= ~bit;
          } else {
            left = true;
          }
        }
      if (!__syncthreads_or(left)) break;
      merge_buffers(CAP / 2);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < QN; ++j) {
        const int ql = qg + G::QG * j;
        if (ql >= nql) continue;
        const float th = thr[ql];
        const int tr = thi[ql];
#pragma unroll
        for (int i = 0; i < RN; ++i) {  // pending bits hold scores
          const int b = i * QN + j;
          if (!better(acc[i][j], (int)(row0 + rg + G::RG * i), th, tr))
            pend[b / 64] &= ~(1ull << (b % 64));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RN; ++i) {
      nrm[i] = 0.f;
#pragma unroll
      for (int j = 0; j < QN; ++j) acc[i][j] = 0.f;
    }
    row0 += row_step;
  }
  __syncthreads();
  merge_buffers(1);  // what the buffers still hold
}

// One block per query: kout rounds of "take the best list head".
__global__ void __launch_bounds__(NT)
    topk_merge_kernel(const float* __restrict__ cand_s,
                      const int* __restrict__ cand_i, int nblk, int k,
                      int kout, float* __restrict__ out_s,
                      int* __restrict__ out_i) {
  extern __shared__ int head[];          // (nblk,) next entry per list
  __shared__ float ws[NT / 32];
  __shared__ int wi[NT / 32], wl[NT / 32];
  const int q = blockIdx.x, t = threadIdx.x, lane = t % 32, warp = t / 32;
  const float* S = cand_s + (long long)q * nblk * k;
  const int* I = cand_i + (long long)q * nblk * k;
  for (int l = t; l < nblk; l += NT) head[l] = 0;
  __syncthreads();
  for (int r = 0; r < kout; ++r) {
    float bs = -INFINITY;
    int bi = INT_MAX, bl = -1;
    for (int l = t; l < nblk; l += NT) {
      const int h = head[l];
      if (h < k) {
        const float s = S[(long long)l * k + h];
        const int i = I[(long long)l * k + h];
        if (better(s, i, bs, bi)) {
          bs = s;
          bi = i;
          bl = l;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_xor_sync(FULL, bs, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      const int ol = __shfl_xor_sync(FULL, bl, off);
      if (better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
        bl = ol;
      }
    }
    if (lane == 0) {
      ws[warp] = bs;
      wi[warp] = bi;
      wl[warp] = bl;
    }
    __syncthreads();
    if (t == 0) {
      for (int w = 1; w < NT / 32; ++w)
        if (better(ws[w], wi[w], bs, bi)) {
          bs = ws[w];
          bi = wi[w];
          bl = wl[w];
        }
      const bool real = bs > NEG_INF;
      out_s[(long long)q * kout + r] = real ? bs : NEG_INF;
      out_i[(long long)q * kout + r] = real ? bi : -1;
      if (bl >= 0) head[bl] += 1;
    }
    __syncthreads();
  }
}




template <int TQ, bool BF16>
int launch_partial(const float* vec, long long n, int d, const float* qry,
                   int nq, const float* qnorm, const float* mask, int k,
                   int nblk, float* gslot, float* cand_s, int* cand_i,
                   cudaStream_t s) {
  using G = Tile<TQ>;
  constexpr int smem = partial_smem_bytes<TQ>();
  static_assert(smem <= SMEM_MAX, "tile too large for a block");
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel<TQ, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (n + G::TN - 1) / G::TN;
  if (nblk > ntiles) return (int)cudaErrorInvalidValue;
  // 16-byte copies need 16-byte rows and bases
  const bool vec16 =
      d % 4 == 0 && (reinterpret_cast<uintptr_t>(vec) & 15) == 0;
  const bool qry16 =
      d % 4 == 0 && (reinterpret_cast<uintptr_t>(qry) & 15) == 0;
  dim3 grid((unsigned)nblk, (nq + TQ - 1) / TQ);
  topk_partial_kernel<TQ, BF16><<<grid, NT, smem, s>>>(
      vec, n, d, qry, nq, qnorm, mask, k, ntiles, vec16, qry16, gslot,
      cand_s, cand_i);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch_partial(int tq, const float* vec, long long n, int d,
                     const float* qry, int nq, const float* qnorm,
                     const float* mask, int k, int nblk, float* gslot,
                     float* cs, int* ci, cudaStream_t s) {
  switch (tq) {
    case 8:
      return launch_partial<8, BF16>(vec, n, d, qry, nq, qnorm, mask, k,
                                     nblk, gslot, cs, ci, s);
    case 32:
      return launch_partial<32, BF16>(vec, n, d, qry, nq, qnorm, mask, k,
                                      nblk, gslot, cs, ci, s);
    case 256:
      return launch_partial<256, BF16>(vec, n, d, qry, nq, qnorm, mask, k,
                                       nblk, gslot, cs, ci, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// vec (n, d) f32, qry (nq, d) f32, qnorm (nq,) f32, mask (n,) f32 or
// null; k: list length (a multiple of 8, <= 128); kout <= k: results
// kept per query; tq: query tile (8, 32, 256); nblk: partial blocks per
// query tile (<= the tile count of n); gslot: (nq, 8) f32 scratch
// holding -1e30 (the published bounds); cand_s / cand_i: (nq, nblk, k)
// scratch, the blocks' lists; out_s/out_i: (nq, kout).  Any d and any
// base: rows that are not 16-byte aligned load by 4-byte copies.
// Returns the CUDA error code (0 = both passes launched).
extern "C" int sptk_fused_topk(const float* vec, long long n, int d,
                               const float* qry, int nq, const float* qnorm,
                               const float* mask, int k, int kout, int tq,
                               int nblk, float* gslot, float* cand_s,
                               int* cand_i, float* out_s, int* out_i,
                               int bf16, void* stream) {
  if (n <= 0 || d <= 0 || nq <= 0 || k <= 0 || k > KMAX || k % 8 ||
      kout <= 0 || kout > k || nblk <= 0 || n > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = bf16 ? dispatch_partial<true>(tq, vec, n, d, qry, nq, qnorm,
                                          mask, k, nblk, gslot, cand_s,
                                          cand_i, s)
                 : dispatch_partial<false>(tq, vec, n, d, qry, nq, qnorm,
                                           mask, k, nblk, gslot, cand_s,
                                           cand_i, s);
  if (err) return err;
  const int msmem = nblk * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, msmem);
  if (e != cudaSuccess) return (int)e;
  topk_merge_kernel<<<nq, NT, msmem, s>>>(cand_s, cand_i, nblk, k, kout,
                                          out_s, out_i);
  return (int)cudaGetLastError();
}
