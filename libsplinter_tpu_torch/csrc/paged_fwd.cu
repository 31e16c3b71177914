// K5: ragged paged attention over a block-paged KV pool, forward only.
//
// Replaces libsplinter_tpu/ops/paged_attention.py `_paged_kernel`
// (reached through `_pallas_call` -> `_paged_pallas` /
// `_paged_pallas_quant` and the public `paged_attention`).  Row b's
// K/V live in pool blocks named by its block table; query token t of
// the row attends keys j < lengths[b] + t (t = 0 for a decode step,
// t < S for the multi-query stack of a suffix prefill).  GQA: query
// head h reads kv head h / rep.
//
// The TPU kernel runs a sequential (row, kv head, page) grid whose
// scratch carries the online softmax from page to page.  Here one
// block of 128 threads owns (row b, kv head g, a tile of RT of the
// R = S * rep query rows) and loops over the row's keys itself:
//   - the row's table slice (and, for quantized pools, its per-page
//     scales) is read into shared memory once;
//   - only keys below lengths[b] + (the tile's last token) are
//     streamed — in tiles of 64 key positions, each position mapped
//     through the table to (block, in-page slot), so any page size
//     works and a page of 128 is two tiles — dequantized (int8 codes,
//     or int4 nibbles with offset 8, times the page's scale) into f32
//     rows of shared memory with 16-byte loads;
//   - Q.K^T per tile (thread = key), an online f32 softmax per query
//     row (warp = row), then P.V (thread = output column), all f32 FMA;
//   - a query row that saw no key (l = 0: a dead row, lengths = 0)
//     gets exact zeros, as the reference kernel writes.
// Bound on an H100: the bytes of each row's visible K/V (decode is a
// few FLOPs per byte); this first version keeps the FLOPs on f32 FMA
// and issues one tile at a time — mma, TMA and split-K across long
// rows are later work.
//
// Semantics kept from the reference kernel: logits in f32 (scale
// 1/sqrt(D)) with the finite -1e30 for masked keys and a running max
// that starts at -1e30 (a tile whose keys are all masked for a row
// leaves its state untouched); probabilities are rounded to the float
// pool's dtype before P.V (quantized pools: the dequantized f32 values,
// the V scale folded in); int8 and int4 K scales fold into the
// dequantized keys (the reference folds them into the logits: the
// same product, rounded once elsewhere).
#include <cstdint>

#include "attention.cuh"
#include "common.cuh"

namespace {

using attn::from_f;
using attn::to_f;

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int BK = 64;       // key positions per streamed tile
constexpr int UNROLL = 4;    // 16-byte loads in flight per thread

enum Kind { KV_F32 = 0, KV_BF16 = 1, KV_I8 = 2, KV_I4 = 3 };

// one (key, kv head) row of a pool: D values in BYTES bytes
template <int KIND, int D>
struct KvRow {
  static constexpr int BYTES = KIND == KV_F32    ? D * 4
                               : KIND == KV_BF16 ? D * 2
                               : KIND == KV_I8   ? D
                                                 : D / 2;
  static constexpr int CHUNKS = BYTES / 16;
  static_assert(BYTES % 16 == 0, "pool rows must be whole 16-byte chunks");

  // decode 16-byte chunk `ch` of a row into dst (D floats), quantized
  // codes times `scale`
  __device__ __forceinline__ static void put(const uint4& raw, int ch,
                                             float scale, float* dst) {
    if constexpr (KIND == KV_F32) {
      const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[ch * 4 + i] = f[i];
    } else if constexpr (KIND == KV_BF16) {
      const __nv_bfloat16* f = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[ch * 8 + i] = __bfloat162float(f[i]);
    } else if constexpr (KIND == KV_I8) {
      const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int i = 0; i < 16; ++i) dst[ch * 16 + i] = (float)c[i] * scale;
    } else {
      const uint8_t* c = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int pc = ch * 16 + i;  // byte j: element j, element j + D/2
        dst[pc] = (float)((int)(c[i] & 0xF) - 8) * scale;
        dst[pc + D / 2] = (float)((int)(c[i] >> 4) - 8) * scale;
      }
    }
  }
};

// the probability as P.V sees it: rounded to a bf16 pool's dtype
template <int KIND>
__device__ __forceinline__ float pv_round(float p) {
  if constexpr (KIND == KV_BF16)
    return __bfloat162float(__float2bfloat16(p));
  else
    return p;
}

// stream keys [j0, j0 + nk) of one pool into dst rows of LD floats;
// rows nk..BK-1 are zeroed
template <int KIND, int D, int LD>
__device__ __forceinline__ void load_tile(
    float* dst, const uint8_t* pool, const int* tab_s, const float* sc_s,
    int j0, int nk, int page, long long head_off, long long block_stride) {
  using Row = KvRow<KIND, D>;
  constexpr int TOTAL = BK * Row::CHUNKS;
  for (int e0 = 0; e0 < TOTAL; e0 += NT * UNROLL) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + u * NT + threadIdx.x;
      const int key = e / Row::CHUNKS, ch = e % Row::CHUNKS;
      raw[u] = make_uint4(0, 0, 0, 0);
      if (e < TOTAL && key < nk) {
        const int j = j0 + key, p = j / page;
        const long long off = (long long)tab_s[p] * block_stride + head_off +
                              (long long)(j - p * page) * Row::BYTES +
                              ch * 16;
        raw[u] = __ldg(reinterpret_cast<const uint4*>(pool + off));
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + u * NT + threadIdx.x;
      if (e >= TOTAL) continue;
      const int key = e / Row::CHUNKS, ch = e % Row::CHUNKS;
      float* row = dst + key * LD;
      if (key < nk) {
        const float scale = sc_s ? sc_s[(j0 + key) / page] : 1.f;
        Row::put(raw[u], ch, scale, row);
      } else {
        // a key past the tile's end: zero (no garbage reaches Q.K^T)
        constexpr int PER = D / Row::CHUNKS;
#pragma unroll
        for (int i = 0; i < PER; ++i) row[ch * PER + i] = 0.f;
      }
    }
  }
}

template <typename T, int KIND, int D, int RT>
__global__ void __launch_bounds__(NT) paged_fwd_kernel(
    const T* __restrict__ q, const uint8_t* __restrict__ kpool,
    const uint8_t* __restrict__ vpool, const float* __restrict__ kscales,
    const float* __restrict__ vscales, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int S, int KH,
    int rep, int page, int P, long long qb, long long qs, long long qh,
    long long ob, long long os, long long oh, float scale) {
  constexpr bool QUANT = KIND >= KV_I8;
  constexpr int LDK = D + 1;    // padded K rows: Q.K^T reads down a column
  constexpr int G = NT / D;     // P.V: row groups of D threads
  constexpr int RQ = RT / 2;    // Q.K^T rows per thread (2 row groups)
  constexpr int RS = RT / NW;   // softmax rows per warp
  constexpr int RV = RT / G;    // P.V rows per thread
  static_assert(RT % 2 == 0 && RT % NW == 0 && RT % G == 0, "row tile");
  using Row = KvRow<KIND, D>;

  extern __shared__ float smem[];
  float* Qs = smem;                  // (RT, D)
  float* Ks = Qs + RT * D;           // (BK, D + 1)
  float* Vs = Ks + BK * LDK;         // (BK, D)
  float* Ps = Vs + BK * D;           // (RT, BK) logits, then probabilities
  float* alpha_s = Ps + RT * BK;     // (RT,) rescale of the tile
  float* l_s = alpha_s + RT;         // (RT,) final softmax sums
  int* tab_s = reinterpret_cast<int*>(l_s + RT);       // (P,)
  float* ks_s = reinterpret_cast<float*>(tab_s + P);   // (P,) quantized
  float* vs_s = ks_s + P;                              // (P,)

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.z, g = blockIdx.y, r0 = blockIdx.x * RT;
  const int R = S * rep;
  const int len = max(lengths[b], 0);
  const int r_last = min(r0 + RT, R) - 1;
  // the tile's last query token sees keys j < len + t_last
  const int kv_end = min(len + r_last / rep, P * page);
  const int n_pages = (kv_end + page - 1) / page;

  for (int p = tid; p < n_pages; p += NT) {
    const int bid = tables[(long long)b * P + p];
    tab_s[p] = bid;
    if constexpr (QUANT) {
      ks_s[p] = kscales[(long long)bid * KH + g];
      vs_s[p] = vscales[(long long)bid * KH + g];
    }
  }
  for (int e = tid; e < RT * D; e += NT) {
    const int row = e / D, c = e % D, r = r0 + row;
    float v = 0.f;
    if (r < R) {
      const int t = r / rep, h = g * rep + r % rep;
      v = to_f(q[b * qb + t * qs + h * qh + c]);
    }
    Qs[e] = v;
  }

  // softmax state: warp `warp` owns rows warp + NW * i
  float m[RS], l[RS];
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  float acc[RV];
#pragma unroll
  for (int i = 0; i < RV; ++i) acc[i] = 0.f;

  const long long block_stride = (long long)KH * page * Row::BYTES;
  const long long head_off = (long long)g * page * Row::BYTES;
  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    const int nk = min(BK, kv_end - j0);
    __syncthreads();  // tables/Q written; the last tile's P.V reads done
    load_tile<KIND, D, LDK>(Ks, kpool, tab_s, QUANT ? ks_s : nullptr, j0,
                            nk, page, head_off, block_stride);
    load_tile<KIND, D, D>(Vs, vpool, tab_s, QUANT ? vs_s : nullptr, j0, nk,
                          page, head_off, block_stride);
    __syncthreads();

    {  // Q.K^T: thread = key kk, rows rg + 2 i
      const int kk = tid % BK, rg = tid / BK;
      float s[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) s[i] = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        const float kv = Ks[kk * LDK + c];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
          s[i] = fmaf(Qs[(rg + 2 * i) * D + c], kv, s[i]);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) Ps[(rg + 2 * i) * BK + kk] = s[i];
    }
    __syncthreads();

    // online softmax: warp = row, lane = keys lane and lane + 32
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      const int row = warp + NW * i;
      // keys j < limit (never past the table's P pages)
      const int limit = min(len + (r0 + row) / rep, kv_end);
      const bool v0 = j0 + lane < limit, v1 = j0 + lane + 32 < limit;
      const float x0 = v0 ? Ps[row * BK + lane] * scale : NEG_INF;
      const float x1 = v1 ? Ps[row * BK + lane + 32] * scale : NEG_INF;
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mnew = fmaxf(m[i], mx);
      const float p0 = v0 ? expf(x0 - mnew) : 0.f;
      const float p1 = v1 ? expf(x1 - mnew) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - mnew);
      l[i] = l[i] * corr + sum;
      m[i] = mnew;
      Ps[row * BK + lane] = pv_round<KIND>(p0);
      Ps[row * BK + lane + 32] = pv_round<KIND>(p1);
      if (lane == 0) alpha_s[row] = corr;
    }
    __syncthreads();

    {  // P.V: thread = output column c, rows rg + G i
      const int c = tid % D, rg = tid / D;
#pragma unroll
      for (int i = 0; i < RV; ++i) acc[i] *= alpha_s[rg + G * i];
      for (int k = 0; k < nk; ++k) {
        const float vv = Vs[k * D + c];
#pragma unroll
        for (int i = 0; i < RV; ++i)
          acc[i] = fmaf(Ps[(rg + G * i) * BK + k], vv, acc[i]);
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RS; ++i) l_s[warp + NW * i] = l[i];
  }
  __syncthreads();
  const int c = tid % D, rg = tid / D;
#pragma unroll
  for (int i = 0; i < RV; ++i) {
    const int row = rg + G * i, r = r0 + row;
    if (r >= R) continue;
    const float lsum = l_s[row];
    const float v = lsum > 0.f ? acc[i] / fmaxf(lsum, 1e-30f) : 0.f;
    const int t = r / rep, h = g * rep + r % rep;
    out[b * ob + t * os + h * oh + c] = from_f<T>(v);
  }
}

struct Args {
  const void *q, *kpool, *vpool;
  const float *kscales, *vscales;
  const int *tables, *lengths;
  void* out;
  int B, S, H, KH, D, page, P;
  long long qb, qs, qh, ob, os, oh;
  float scale;
  cudaStream_t stream;
};

template <typename T, int KIND, int D, int RT>
int launch(const Args& a) {
  const int rep = a.H / a.KH;
  const int smem =
      (RT * D + BK * (D + 1) + BK * D + RT * BK + 2 * RT + 3 * a.P) *
      (int)sizeof(float);
  auto kernel = paged_fwd_kernel<T, KIND, D, RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long R = (long long)a.S * rep;
  dim3 grid((unsigned)((R + RT - 1) / RT), a.KH, a.B);
  kernel<<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const uint8_t*)a.kpool, (const uint8_t*)a.vpool,
      a.kscales, a.vscales, a.tables, a.lengths, (T*)a.out, a.S, a.KH, rep,
      a.page, a.P, a.qb, a.qs, a.qh, a.ob, a.os, a.oh, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int KIND, int D>
int by_rows(const Args& a) {
  // decode steps carry rep rows per (row, kv head): a small tile; the
  // multi-query stack tiles its S * rep rows by 16
  return (long long)a.S * (a.H / a.KH) <= 4 ? launch<T, KIND, D, 4>(a)
                                             : launch<T, KIND, D, 16>(a);
}

template <typename T, int KIND>
int by_dim(const Args& a) {
  switch (a.D) {
    case 32:
      return by_rows<T, KIND, 32>(a);
    case 64:
      return by_rows<T, KIND, 64>(a);
    case 128:
      return by_rows<T, KIND, 128>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_kind(const Args& a, int kind) {
  switch (kind) {
    case KV_F32:
      return by_dim<T, KV_F32>(a);
    case KV_BF16:
      return by_dim<T, KV_BF16>(a);
    case KV_I8:
      return by_dim<T, KV_I8>(a);
    case KV_I4:
      return by_dim<T, KV_I4>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/out: (B, S, H, D) views with D contiguous, element strides given
// (batch, token, head); f32 (bf16 = 0) or bf16 (bf16 = 1).  Pools:
// contiguous (n_blocks, KH, page, D) of kind 0 f32, 1 bf16, 2 int8, or
// (n_blocks, KH, page, D/2) uint8 of kind 3 (int4 packed); kinds 2 and
// 3 need (n_blocks, KH) f32 scales.  tables: (B, P) int32 block ids;
// lengths: (B,) int32.  D is 32, 64 or 128.  Returns the CUDA error
// code (0 = launched).
extern "C" int sptk_paged_fwd(const void* q, const void* kpool,
                              const void* vpool, const float* kscales,
                              const float* vscales, const int* tables,
                              const int* lengths, void* out, int B, int S,
                              int H, int KH, int D, int page, int P, int bf16,
                              int kind, long long qb, long long qs,
                              long long qh, long long ob, long long os,
                              long long oh, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH || page <= 0 ||
      P <= 0 || B > 65535 || KH > 65535 || kind < 0 || kind > 3 ||
      (kind >= KV_I8 && (kscales == nullptr || vscales == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{q,  kpool, vpool, kscales, vscales, tables, lengths,
               out, B,    S,     H,       KH,      D,      page,
               P,   qb,   qs,    qh,      ob,      os,     oh,
               scale, (cudaStream_t)stream};
  return bf16 ? by_kind<__nv_bfloat16>(a, kind) : by_kind<float>(a, kind);
}
