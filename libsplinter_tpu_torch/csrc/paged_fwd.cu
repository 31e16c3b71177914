// K5: ragged paged attention over a block-paged KV pool, forward only.
//
// Replaces libsplinter_tpu/ops/paged_attention.py `_paged_kernel`
// (reached through `_pallas_call` -> `_paged_pallas` /
// `_paged_pallas_quant` and the public `paged_attention`).  Row b's
// K/V live in pool blocks named by its block table; query token t of
// the row attends keys j < lengths[b] + t (t = 0 for a decode step,
// t < S for the multi-query stack of a suffix prefill), and never a
// key past the table's P pages.  GQA: query head h reads kv head
// h / rep.
//
// Bound on an H100: the bytes of each row's visible K/V.  Decode is a
// GEMV over the cache (a few FLOPs per byte), and the rows are ragged,
// so the design is split-K ("flash-decoding"):
//
//   - one block of 4 warps owns (row b, kv head g, a tile of RT of the
//     R = S * rep query rows, split s): the keys of `pps` consecutive
//     table pages (the plan, ops/paged_attention.py `_paged_plan`,
//     picks pps from the shapes alone, so the launch never reads
//     lengths on the host).  A long row is spread over many blocks and
//     the card fills however ragged the lengths are; a split past the
//     tile's last visible key exits at once.  All rows of the tile
//     share every K/V load;
//   - no staging of keys in shared memory: a key's row is C 16-byte
//     chunks (8 for bf16 at D = 64, 4 for int8, 2 for int4, 16 for
//     f32), read by a group of C lanes with ld.global.nc, so a warp
//     reads 32 / C whole keys a load, and each thread keeps 4 K and 4 V
//     loads in flight.  Codes are dequantized in registers;
//   - q sits in registers split the same way (each lane the E = D / C
//     columns of its chunk, every row of the tile); the dot products end
//     in a shuffle reduction within the lane group.  Each lane group
//     keeps its own online softmax per row and P.V accumulator for its
//     chunk's columns, rescaled once per 4 keys;
//   - at the end of the split the lane groups merge by shuffles, the
//     warps in shared memory.  With one split the block writes the
//     output; otherwise it writes (m, l, acc) in f32 to scratch, and
//     `paged_combine_kernel` merges the splits in split order
//     (out = sum e^(m_s - M) acc_s / sum e^(m_s - M) l_s, no atomics).
//     The combine reads each row's live split count from lengths on the
//     device, so it never reads a split that no block wrote.
//
// Semantics kept from the reference kernel: f32 logits scaled by
// 1/sqrt(D); masked keys get p = 0 and a running max that starts at
// -1e30; int8 and int4 K scales fold into the logit once per page
// (dot(q, codes) * (scale * k_scale), as the reference does), V scales
// into P.V; probabilities are rounded to bf16 before P.V over bf16
// pools.  Split- and group-local maxima move where that rounding
// happens (p relative to a local max, rescaled after rounding): each
// p_j still moves by at most 2^-8 p_j, the term of the bf16 limit
// that already bounds it.  A row that sees no key (l = 0: a dead row,
// or a whole batch of them) gets exact zeros.
#include <cstdint>

#include "attention.cuh"
#include "common.cuh"

namespace {

using attn::from_f;
using attn::to_f;

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int UNROLL = 4;    // K and V loads in flight per thread

enum Kind { KV_F32 = 0, KV_BF16 = 1, KV_I8 = 2, KV_I4 = 3 };

// one (key, kv head) row of a pool: D values in BYTES bytes, read as C
// 16-byte chunks of E values each
template <int KIND, int D>
struct KvRow {
  static constexpr int BYTES = KIND == KV_F32    ? D * 4
                               : KIND == KV_BF16 ? D * 2
                               : KIND == KV_I8   ? D
                                                 : D / 2;
  static constexpr int C = BYTES / 16;  // lanes a key
  static constexpr int KPW = 32 / C;    // keys a warp reads a load
  static constexpr int E = D / C;       // values a lane
  // the wide row tile: q and the accumulator take 32 registers each
  static constexpr int W = 32 / E;
  static_assert(BYTES % 16 == 0 && C <= 32, "rows of whole 16-byte chunks");

  // the column of value e of chunk ch (int4: byte i holds value i in
  // its low nibble and value i + D/2 in its high one)
  __device__ __forceinline__ static int col(int ch, int e) {
    if constexpr (KIND == KV_I4)
      return e < E / 2 ? ch * (E / 2) + e : D / 2 + ch * (E / 2) + e - E / 2;
    else
      return ch * E + e;
  }

  // value e of a chunk as f32 (quantized pools: the code)
  __device__ __forceinline__ static float get(const uint4& raw, int e) {
    if constexpr (KIND == KV_F32) {
      return reinterpret_cast<const float*>(&raw)[e];
    } else if constexpr (KIND == KV_BF16) {
      return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&raw)[e]);
    } else if constexpr (KIND == KV_I8) {
      return (float)reinterpret_cast<const int8_t*>(&raw)[e];
    } else {
      const uint8_t c = reinterpret_cast<const uint8_t*>(&raw)[e % (E / 2)];
      return (float)((int)(e < E / 2 ? c & 0xF : c >> 4) - 8);
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

__device__ __forceinline__ uint4 load_nc(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T, int KIND, int D, int RT>
__global__ void __launch_bounds__(NT) paged_fwd_kernel(
    const T* __restrict__ q, const uint8_t* __restrict__ kpool,
    const uint8_t* __restrict__ vpool, const float* __restrict__ kscales,
    const float* __restrict__ vscales, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc, int S,
    int KH, int rep, int page, int page_shift, int P, int pps, int nsplit,
    long long qb, long long qs, long long qh, long long ob, long long os,
    long long oh, float scale) {
  using Row = KvRow<KIND, D>;
  constexpr int C = Row::C, E = Row::E, KPW = Row::KPW;
  constexpr bool QUANT = KIND >= KV_I8;
  constexpr int KI = UNROLL * NW * KPW;  // keys a block reads a step
  __shared__ float red_acc[NW][RT][D];   // the warps' accumulators
  __shared__ float red_ml[NW][RT][2];    // and their (m, l)
  extern __shared__ float dyn[];         // the split's pages:
  int* tab_s = reinterpret_cast<int*>(dyn);  // block ids,
  float* ks_s = dyn + pps;                   // scale * K scales,
  float* vs_s = ks_s + pps;                  // V scales

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ch = lane % C, slot = lane / C;
  const int b = blockIdx.z, g = blockIdx.y;
  const int split = blockIdx.x % nsplit, r0 = blockIdx.x / nsplit * RT;
  const int R = S * rep, nr = min(RT, R - r0);
  const int len = max(lengths[b], 0), cap = P * page;
  // the tile's last row sees the most keys: j < len + its token
  const int kv_end = min(len + (r0 + nr - 1) / rep, cap);
  const int k0 = split * pps * page;
  const int k1 = min(k0 + pps * page, kv_end);

  auto out_row = [&](int i) {
    const int r = r0 + i, t = r / rep, h = g * rep + r % rep;
    return out + b * ob + t * os + h * oh;
  };
  if (k0 >= k1) {
    // no key of this split is visible to the tile: the combine never
    // reads it; a lone split owns the output, which is exact zeros
    if (nsplit == 1)
      for (int e = tid; e < nr * D; e += NT)
        out_row(e / D)[e % D] = from_f<T>(0.f);
    return;
  }

  const int p0 = split * pps;
  const int np = (k1 - k0 + page - 1) / page;
  for (int i = tid; i < np; i += NT) {
    const int bid = tables[(long long)b * P + p0 + i];
    tab_s[i] = bid;
    if constexpr (QUANT) {
      ks_s[i] = scale * kscales[(long long)bid * KH + g];
      vs_s[i] = vscales[(long long)bid * KH + g];
    }
  }

  // q of the tile's rows (0 past R), this lane's columns; each row's
  // visible keys of this split: j < lim[i]
  float qv[RT][E];
  int lim[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = r0 + i;
    lim[i] = 0;
    if (i < nr) {
      const int t = r / rep, h = g * rep + r % rep;
      const T* qr = q + b * qb + t * qs + h * qh;
#pragma unroll
      for (int e = 0; e < E; ++e) qv[i][e] = to_f(qr[Row::col(ch, e)]);
      lim[i] = min(min(len + t, cap), k1);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qv[i][e] = 0.f;
    }
  }
  float m[RT], l[RT], acc[RT][E];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }
  __syncthreads();  // the split's pages are staged

  const long long bstride = (long long)KH * page * Row::BYTES;
  const long long hoff = (long long)g * page * Row::BYTES + ch * 16;
  for (int j0 = k0; j0 < k1; j0 += KI) {
    uint4 kr[UNROLL], vr[UNROLL];
    int jj[UNROLL];
    float ksc[UNROLL], vsc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + (u * NW + warp) * KPW + slot;
      jj[u] = j;
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      ksc[u] = scale;
      vsc[u] = 1.f;
      if (j < k1) {
        const int jr = j - k0;
        const int pl = page_shift >= 0 ? jr >> page_shift : jr / page;
        const long long off = (long long)tab_s[pl] * bstride + hoff +
                              (long long)(jr - pl * page) * Row::BYTES;
        kr[u] = load_nc(kpool + off);
        vr[u] = load_nc(vpool + off);
        if constexpr (QUANT) {
          ksc[u] = ks_s[pl];
          vsc[u] = vs_s[pl];
        }
      }
    }

    // Q.K: the lane's share, then the sum over the key's C lanes
    float x[UNROLL][RT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float dot[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) dot[i] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float kv = Row::get(kr[u], e);
#pragma unroll
        for (int i = 0; i < RT; ++i) dot[i] = fmaf(qv[i][e], kv, dot[i]);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int off = C / 2; off > 0; off >>= 1)
          dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], off);
        x[u][i] = jj[u] < lim[i] ? dot[i] * ksc[u] : NEG_INF;
      }
    }

    // online softmax per row over these UNROLL keys
    float pq[UNROLL][RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float mb = NEG_INF;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) mb = fmaxf(mb, x[u][i]);
      const float mn = fmaxf(m[i], mb);
      const float corr = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float p = jj[u] < lim[i] ? expf(x[u][i] - mn) : 0.f;
        sum += p;
        pq[u][i] = pv_round<KIND>(p) * vsc[u];
      }
      l[i] = l[i] * corr + sum;
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
    }
    // P.V on this lane's columns
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float vv = Row::get(vr[u], e);
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i][e] = fmaf(pq[u][i], vv, acc[i][e]);
      }
    }
  }

  // merge the warp's lane groups (lanes ch, ch + C, ...), then the warps
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    float mw = m[i];
#pragma unroll
    for (int off = C; off < 32; off <<= 1)
      mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, off));
    const float f = expf(m[i] - mw);
    float lw = l[i] * f;
#pragma unroll
    for (int off = C; off < 32; off <<= 1)
      lw += __shfl_xor_sync(0xffffffffu, lw, off);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float a = acc[i][e] * f;
#pragma unroll
      for (int off = C; off < 32; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (slot == 0) red_acc[warp][i][Row::col(ch, e)] = a;
    }
    if (lane == 0) {
      red_ml[warp][i][0] = mw;
      red_ml[warp][i][1] = lw;
    }
  }
  __syncthreads();

  for (int e = tid; e < nr * D; e += NT) {
    const int i = e / D, c = e % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, red_ml[w][i][0]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(red_ml[w][i][0] - mx);
      ls = fmaf(f, red_ml[w][i][1], ls);
      a = fmaf(f, red_acc[w][i][c], a);
    }
    if (nsplit == 1) {
      out_row(i)[c] = from_f<T>(ls > 0.f ? a / fmaxf(ls, 1e-30f) : 0.f);
    } else {
      const long long pi =
          (((long long)b * KH + g) * R + r0 + i) * nsplit + split;
      part_acc[pi * D + c] = a;
      if (c == 0) {
        part_ml[pi * 2] = mx;
        part_ml[pi * 2 + 1] = ls;
      }
    }
  }
}

// One warp per output row (b, t, h): merge the row's live splits in
// split order.  A row's live splits are those holding one of its keys,
// j < min(lengths[b] + t, P * page); a row with none is exact zeros.
template <typename T>
__global__ void __launch_bounds__(NT) paged_combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    const int* __restrict__ lengths, T* __restrict__ out, int B, int S,
    int H, int KH, int D, int cap, int split_keys, int nsplit, long long ob,
    long long os, long long oh) {
  const long long w = ((long long)blockIdx.x * NT + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (long long)B * S * H) return;
  const int h = (int)(w % H), t = (int)(w / H % S), b = (int)(w / H / S);
  const int rep = H / KH, g = h / rep, r = t * rep + h % rep;
  const int kv = min(max(lengths[b], 0) + t, cap);
  const int live = (kv + split_keys - 1) / split_keys;
  const long long base = (((long long)b * KH + g) * S * rep + r) * nsplit;
  float mx = NEG_INF;
  for (int s = 0; s < live; ++s) mx = fmaxf(mx, part_ml[(base + s) * 2]);
  T* o = out + b * ob + t * os + h * oh;
  for (int c = lane; c < D; c += 32) {
    float ls = 0.f, a = 0.f;
    for (int s = 0; s < live; ++s) {
      const float f = expf(part_ml[(base + s) * 2] - mx);
      ls = fmaf(f, part_ml[(base + s) * 2 + 1], ls);
      a = fmaf(f, part_acc[(base + s) * D + c], a);
    }
    o[c] = from_f<T>(ls > 0.f ? a / fmaxf(ls, 1e-30f) : 0.f);
  }
}

struct Args {
  const void *q, *kpool, *vpool;
  const float *kscales, *vscales;
  const int *tables, *lengths;
  void* out;
  float *part_ml, *part_acc;
  int B, S, H, KH, D, page, P, pps;
  long long qb, qs, qh, ob, os, oh;
  float scale;
  cudaStream_t stream;
};

template <typename T, int KIND, int D, int RT>
int launch(const Args& a) {
  const int rep = a.H / a.KH;
  const int nsplit = (a.P + a.pps - 1) / a.pps;
  const long long R = (long long)a.S * rep;
  const long long nx = (R + RT - 1) / RT * nsplit;
  if (nx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int shift = -1;
  if ((a.page & (a.page - 1)) == 0) shift = __builtin_ctz(a.page);
  const int smem = 3 * a.pps * (int)sizeof(float);
  dim3 grid((unsigned)nx, a.KH, a.B);
  paged_fwd_kernel<T, KIND, D, RT><<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, (const uint8_t*)a.kpool, (const uint8_t*)a.vpool,
      a.kscales, a.vscales, a.tables, a.lengths, (T*)a.out, a.part_ml,
      a.part_acc, a.S, a.KH, rep, a.page, shift, a.P, a.pps, nsplit, a.qb,
      a.qs, a.qh, a.ob, a.os, a.oh, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  const long long rows = (long long)a.B * a.S * a.H;
  paged_combine_kernel<T><<<(unsigned)((rows * 32 + NT - 1) / NT), NT, 0,
                            a.stream>>>(
      a.part_ml, a.part_acc, a.lengths, (T*)a.out, a.B, a.S, a.H, a.KH, a.D,
      a.P * a.page, a.pps * a.page, nsplit, a.ob, a.os, a.oh);
  return (int)cudaGetLastError();
}

template <typename T, int KIND, int D>
int by_rows(const Args& a) {
  // a decode step without GQA has one row per (row, kv head); the rest
  // (GQA, the multi-query stack) tile their rows by the wide tile
  constexpr int W = KvRow<KIND, D>::W;
  if ((long long)a.S * (a.H / a.KH) == 1) return launch<T, KIND, D, 1>(a);
  return launch<T, KIND, D, W>(a);
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
// contiguous, 16-byte aligned (n_blocks, KH, page, D) of kind 0 f32,
// 1 bf16, 2 int8, or (n_blocks, KH, page, D/2) uint8 of kind 3 (int4
// packed); kinds 2 and 3 need (n_blocks, KH) f32 scales.  tables:
// (B, P) int32 block ids; lengths: (B,) int32.  D is 32, 64 or 128.
// pps: table pages a split covers; with ceil(P / pps) > 1 splits,
// part_ml (B, KH, S * H / KH, splits, 2) and part_acc (..., splits, D)
// are f32 scratch (any contents).  Returns the CUDA error code (0 =
// launched).
extern "C" int sptk_paged_fwd(const void* q, const void* kpool,
                              const void* vpool, const float* kscales,
                              const float* vscales, const int* tables,
                              const int* lengths, void* out, float* part_ml,
                              float* part_acc, int B, int S, int H, int KH,
                              int D, int page, int P, int pps, int bf16,
                              int kind, long long qb, long long qs,
                              long long qh, long long ob, long long os,
                              long long oh, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH || page <= 0 ||
      P <= 0 || pps <= 0 || pps > P || B > 65535 || KH > 65535 ||
      kind < 0 || kind > 3 ||
      (kind >= KV_I8 && (kscales == nullptr || vscales == nullptr)) ||
      (pps < P && (part_ml == nullptr || part_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{q,        kpool, vpool, kscales, vscales, tables, lengths,
               out,      part_ml, part_acc, B,  S,       H,      KH,
               D,        page,  P,     pps,     qb,      qs,     qh,
               ob,       os,    oh,    scale,   (cudaStream_t)stream};
  return bf16 ? by_kind<__nv_bfloat16>(a, kind) : by_kind<float>(a, kind);
}
