// K4: decoder-prefill causal attention over the KV cache, forward only.
//
// Replaces libsplinter_tpu/ops/flash_attention.py `_causal_kernel`
// (reached through `_causal_flash_pallas` / `causal_flash_attention`).
// The query at cache slot pos + i sees keys start[b] <= j <= pos + i
// (slot-causal plus a per-row left-pad offset).  The TPU kernel keeps
// the whole (T, D) K/V of one (batch, kv head) resident in VMEM (256 KB
// of bf16 K+V at T = 2048, more than a Hopper block's 227 KB), so this
// kernel streams K/V in 64-row tiles under an online f32 softmax and
// never materialises the (S, T) logits.  Query head h reads kv head
// h / rep through the strides: the repeated cache never exists.
//
// One block per (64-query tile, head, batch row).  Bound on an H100:
// the visible work, 4 * D FLOPs per (query, visible key) pair, plus the
// bytes of q, the visible K/V and the output; this first version runs
// the FLOPs as f32 FMA from shared memory (attention.cuh), far under
// the bf16 tensor-core roof — mma/wgmma with TMA is later work.
//
// Work is cut to what the mask lets through: a block streams only the
// key tiles from the one holding start[b] to the one holding the last
// slot its queries can see (pos + last row), not all T slots.
//
// Semantics kept from the reference kernel:
//   - logits in f32 (scale 1/sqrt(D)); masked keys get the FINITE
//     -1e30.  A row with no visible key (a left-pad query,
//     pos + i < start[b], which includes every query of a batch-pad
//     row) is therefore the uniform average of V over ALL T cache
//     slots.  Skipped tiles would change that average, so a block with
//     such rows computes the column mean of V over T separately and
//     writes it to them: finite, never NaN (a NaN here would be written
//     into the next layer's pad K/V and poison real rows through
//     0 * NaN in P.V);
//   - the running max starts at -inf, so a tile whose keys are all
//     masked for a row only counts until a visible key arrives: its
//     rescale factor exp(-1e30 - m) is exactly 0;
//   - probabilities are rounded to V's dtype before P.V (f32 sums).
#include "attention.cuh"
#include "common.cuh"

using namespace attn;

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    causal_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ start,
                      T* __restrict__ out, int S, int T_len, int pos, int rep,
                      Strides sq, Strides sk, Strides sv, Strides so,
                      float scale) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                  // (BQ, D + 1)
  float* Ks = Qs + BQ * LD;          // (BK, D + 1)
  float* Vs = Ks + BK * LD;          // (BK, D + 1)
  float* Ps = Vs + BK * LD;          // (BQ, BK + 1)
  float* Vmean = Ps + BQ * (BK + 1);  // (D,) mean of V over all T slots

  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int b = blockIdx.z, h = blockIdx.y, qt0 = blockIdx.x * BQ;
  const int kvh = h / rep;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  const int st0 = max(start[b], 0);  // j >= a negative start: all j
  const int q_last = min(qt0 + BQ, S) - 1;  // last real query of the tile
  // rows form a prefix without keys (pos + i < st0), then rows with keys
  const bool some_empty = pos + qt0 < st0;
  const bool some_keys = pos + q_last >= st0;

  if (some_empty) {
    // NT / D partial sums per column, reduced through Ps
    float sum = 0.f;
    for (int j = t / D; j < T_len; j += NT / D)
      sum += to_f(vb[j * sv.s + t % D]);
    Ps[t] = sum;
    __syncthreads();
    if (t < D) {
      float total = 0.f;
      for (int g = 0; g < NT / D; ++g) total += Ps[g * D + t];
      Vmean[t] = total / (float)T_len;
    }
    __syncthreads();
  }

  RowState<D> st;
  st.init();
  if (some_keys) {
    load_rows<T, D>(Qs, q + b * sq.b + h * sq.h, sq.s, qt0, BQ, S);
    // the caller guarantees pos + S <= T_len
    const int k_hi = pos + q_last;
    for (int k0 = (st0 / BK) * BK; k0 <= k_hi; k0 += BK) {
      __syncthreads();  // previous tile's Ps/Vs reads are done
      load_rows<T, D>(Ks, kb, sk.s, k0, BK, T_len);
      load_rows<T, D>(Vs, vb, sv.s, k0, BK, T_len);
      __syncthreads();

      float s[4][4];
      qk_tile<D>(Qs, Ks, ty, tx, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int slot = pos + qt0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          float x = s[i][j] * scale;
          if (key < st0 || key > slot) x = NEG_INF;
          if (key >= T_len) x = -INFINITY;  // past the cache: not a key
          s[i][j] = x;
        }
      }
      softmax_tile<T, D>(s, Ps, st, ty, tx);
      __syncthreads();
      pv_tile<D>(Ps, Vs, st, ty, tx);
    }
  }

  T* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt0 + ty + 16 * i;
    if (row >= S) continue;
    const bool empty = pos + row < st0;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const int c = tx + 16 * j;
      ob[row * so.s + c] =
          from_f<T>(empty ? Vmean[c] : st.acc[i][j] / st.l[i]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* start,
           void* out, int B, int S, int H, int T_len, int pos, int rep,
           Strides sq, Strides sk, Strides sv, Strides so, float scale,
           cudaStream_t stream) {
  const int smem = tile_floats<D>(D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      causal_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  causal_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, start, (T*)out, S, T_len, pos,
      rep, sq, sk, sv, so, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const int* start, void* out, int B, int S, int H, int T_len,
             int pos, int rep, Strides sq, Strides sk, Strides sv, Strides so,
             float scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, start, out, B, S, H, T_len, pos, rep, sq,
                           sk, sv, so, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, start, out, B, S, H, T_len, pos, rep, sq,
                           sk, sv, so, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, start, out, B, S, H, T_len, pos, rep, sq,
                           sk, sv, so, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, start, out, B, S, H, T_len, pos, rep,
                            sq, sk, sv, so, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/out: (B, S, H, D) and k/v: (B, T, KH, D) views with D contiguous,
// element strides given per tensor (batch, seq, head); H = KH * rep.
// f32 (bf16 = 0) or bf16 (bf16 = 1).  start: (B,) int32 left-pad
// offsets on the device.  Queries sit at cache slots pos..pos+S-1, and
// pos + S <= T.  D is 16, 32, 64 or 128.  Returns the CUDA error code
// (0 = launched).
extern "C" int sptk_causal_fwd(const void* q, const void* k, const void* v,
                               const int* start, void* out, int B, int S,
                               int H, int D, int T_len, int pos, int rep,
                               int bf16, long long qb, long long qs,
                               long long qh, long long kb, long long ks,
                               long long kh, long long vb, long long vs,
                               long long vh, long long ob, long long os,
                               long long oh, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || H > 65535 || B > 65535 || rep <= 0 ||
      H % rep || pos < 0 || pos + S > T_len)
    return (int)cudaErrorInvalidValue;
  const Strides sq{qb, qs, qh}, sk{kb, ks, kh}, sv{vb, vs, vh},
      so{ob, os, oh};
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, start, out, B, S, H,
                                        T_len, pos, rep, sq, sk, sv, so,
                                        scale, s)
              : dispatch<float>(D, q, k, v, start, out, B, S, H, T_len, pos,
                                rep, sq, sk, sv, so, scale, s);
}
