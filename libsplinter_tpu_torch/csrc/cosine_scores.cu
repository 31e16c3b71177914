// K3: the (n, q) cosine score matrix over the vector lane.
//
// Replaces libsplinter_tpu/ops/similarity.py `_scores_kernel` (reached
// through `_cosine_scores_pallas`).  Bound on an H100: the lane read
// and the n * q f32 scores written for small q (3.2 GB in, 32 MB out at
// 1M x 768 x 8), f32 FMA for q = 256 (2 * n * d * q FLOPs over 67
// TFLOP/s; the output alone is then 1 GiB).
//
// The score tile is K2's (topk_tile.cuh): each block walks a strided
// set of TN-row tiles, every chunk of rows and queries arrives by
// cp.async (whole 128-byte lines, 4-byte copies when d % 4 != 0) into
// a 2-stage ring that runs on across row tiles, and each thread keeps
// an RN x QN block of f32 accumulators fed by float4 operands, with
// the row norms summed from the same registers.  The query tiles are
// K2's: 8, 32 and 256 (ops/similarity.py TOPK_TILES), and so is the
// grid (`_topk_plan`): as many blocks per query tile as the SMs hold.
//
// The epilogue: a score is dot / max(|v| |q|, 1e-12), or the finite
// -1e30 for masked rows, zero rows and rows past n.  Each thread's
// scores go through the ring stage it has just multiplied (free until
// the next load into it, a barrier later), a row-major (rows, TQ) tile
// with padded rows, so that the copy out is whole rows of the (n, q)
// output: 16-byte stores when q % 4 == 0, 4-byte ones otherwise.  The
// 256-query tile copies out 32 rows a pass.
#include <cstdint>

#include "common.cuh"
#include "topk_tile.cuh"

namespace {

using namespace tk;

// the scores' staging: LDS floats a row (the scatter from the
// accumulators is free of bank conflicts), ROWS rows a pass (a multiple
// of the row groups that divides TN and fits one ring stage)
template <int TQ>
constexpr int score_lds() {
  return TQ + (TQ >= 128 ? 16 : 4);
}

template <int TQ>
constexpr int score_rows() {
  using G = Tile<TQ>;
  int r = G::TN;
  while (r > G::RG && (r * score_lds<TQ>() > G::STAGE || G::TN % r))
    r -= G::RG;
  return r;
}

template <int TQ>
struct ScoreOut {
  using G = Tile<TQ>;
  static constexpr int LDS = score_lds<TQ>();
  static constexpr int ROWS = score_rows<TQ>();
  static_assert(ROWS * LDS <= G::STAGE && G::TN % ROWS == 0 &&
                    ROWS % G::RG == 0,
                "score staging");
};

template <int TQ, bool BF16>
__global__ void __launch_bounds__(NT, TQ == 32 && !BF16 ? 2 : 1)
    cosine_scores_kernel(const float* __restrict__ vec, long long n, int d,
                         const float* __restrict__ qry, int nq,
                         const float* __restrict__ qnorm,
                         const float* __restrict__ mask, long long ntiles,
                         bool vec16, bool qry16, bool out16,
                         float* __restrict__ out) {
  using G = Tile<TQ>;
  using O = ScoreOut<TQ>;
  constexpr int RN = G::RN, QN = G::QN;
  constexpr int PI = O::ROWS / G::RG;  // each thread's rows a pass
  extern __shared__ __align__(16) float ring[];  // STAGES x (TN + TQ, LD)

  const int t = threadIdx.x;
  const int q0 = blockIdx.y * TQ;
  const int nql = min(TQ, nq - q0);
  const int qg = t % G::QG, rg = t / G::QG;

  // chunk s of this block is column chunk s % nck of its (s / nck)-th
  // tile; the load of chunk s + 1 runs while chunk s is multiplied
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
    float* st = ring + (int)(s & 1) * G::STAGE;
    chunk_mma<TQ, BF16>(st, st + G::TN * G::LD, rg, qg, acc, nrm);
    if (++kc < nck) continue;
    kc = 0;

    // ---- the tile's epilogue: scores, staged in stage s % 2 ----
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
#pragma unroll
    for (int j = 0; j < QN; ++j) {
      const int ql = qg + G::QG * j;
      const float qn = ql < nql ? __ldg(qnorm + q0 + ql) : 0.f;
#pragma unroll
      for (int i = 0; i < RN; ++i)
        acc[i][j] = nrm[i] > 0.f ? acc[i][j] / fmaxf(nrm[i] * qn, 1e-12f)
                                 : NEG_INF;
    }
#pragma unroll
    for (int p = 0; p < G::TN / O::ROWS; ++p) {
      __syncthreads();  // the stage is free: multiplied, or copied out
#pragma unroll
      for (int ii = 0; ii < PI; ++ii) {
        const int i = p * PI + ii;
        float* dst = st + (rg + G::RG * ii) * O::LDS;
        if constexpr (G::QG == 1) {  // this thread's queries are a row
#pragma unroll
          for (int j = 0; j < QN; j += 4)
            *reinterpret_cast<float4*>(dst + j) = make_float4(
                acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < QN; ++j) dst[qg + G::QG * j] = acc[i][j];
        }
      }
      __syncthreads();
      const long long prow = row0 + p * O::ROWS;
      if (out16) {
        const int n4 = nql / 4;
        for (int e = t; e < O::ROWS * n4; e += NT) {
          const int r = e / n4, c = 4 * (e % n4);
          if (prow + r < n)
            *reinterpret_cast<float4*>(out + (prow + r) * nq + q0 + c) =
                *reinterpret_cast<const float4*>(st + r * O::LDS + c);
        }
      } else {
        for (int e = t; e < O::ROWS * nql; e += NT) {
          const int r = e / nql, c = e % nql;
          if (prow + r < n) out[(prow + r) * nq + q0 + c] = st[r * O::LDS + c];
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
}

template <int TQ, bool BF16>
int launch(const float* vec, long long n, int d, const float* qry, int nq,
           const float* qnorm, const float* mask, float* out, int nblk,
           cudaStream_t stream) {
  using G = Tile<TQ>;
  constexpr int smem = STAGES * G::STAGE * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cosine_scores_kernel<TQ, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = (n + G::TN - 1) / G::TN;
  if (nblk > ntiles) return (int)cudaErrorInvalidValue;
  // 16-byte copies need 16-byte rows and bases
  const bool vec16 =
      d % 4 == 0 && (reinterpret_cast<uintptr_t>(vec) & 15) == 0;
  const bool qry16 =
      d % 4 == 0 && (reinterpret_cast<uintptr_t>(qry) & 15) == 0;
  const bool out16 =
      nq % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  dim3 grid((unsigned)nblk, (nq + TQ - 1) / TQ);
  cosine_scores_kernel<TQ, BF16><<<grid, NT, smem, stream>>>(
      vec, n, d, qry, nq, qnorm, mask, ntiles, vec16, qry16, out16, out);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch(int tq, const float* vec, long long n, int d, const float* qry,
             int nq, const float* qnorm, const float* mask, float* out,
             int nblk, cudaStream_t s) {
  switch (tq) {
    case 8:
      return launch<8, BF16>(vec, n, d, qry, nq, qnorm, mask, out, nblk, s);
    case 32:
      return launch<32, BF16>(vec, n, d, qry, nq, qnorm, mask, out, nblk, s);
    case 256:
      return launch<256, BF16>(vec, n, d, qry, nq, qnorm, mask, out, nblk,
                               s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// vec (n, d) f32, qry (nq, d) f32, qnorm (nq,) f32, mask (n,) f32 or
// null, out (n, nq) f32; all contiguous.  tq: the query tile (8, 32 or
// 256); nblk: blocks per query tile (<= the tile count of n).  Any d
// and any base: rows that are not 16-byte aligned load by 4-byte
// copies.  Returns the CUDA error code (0 = launched).
extern "C" int sptk_cosine_scores(const float* vec, long long n, int d,
                                  const float* qry, int nq,
                                  const float* qnorm, const float* mask,
                                  float* out, int tq, int nblk, int bf16,
                                  void* stream) {
  if (n <= 0 || d <= 0 || nq <= 0 || nblk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<true>(tq, vec, n, d, qry, nq, qnorm, mask, out,
                               nblk, s)
              : dispatch<false>(tq, vec, n, d, qry, nq, qnorm, mask, out,
                                nblk, s);
}
