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
// Bound on an H100: the visible work, 4 * D FLOPs per (query, visible
// key) pair, against the bytes of q, the visible K/V and the output.
// Two hand-written kernels, chosen by the inputs' dtype, as K1's:
//   - bf16 (`causal_fwd_mma_kernel`, the serving path): the
//     tensor-core tile of attention_mma.cuh.  One block of 4 warps per
//     (64-query tile, head, batch row); each warp owns 16 query rows
//     and keeps their online softmax in registers.  K/V tiles of 64
//     keys arrive by cp.async into a 2-stage ring; Q.K^T and P.V are
//     mma.sync m16n8k16 bf16 products with f32 sums; P is rounded to
//     bf16 in registers and used as the A operand of P.V.  A warp skips
//     the key tiles that lie wholly above its last slot (the block
//     still loads them for its later warps), and the q-tiles launch
//     with the most keys first, so the longest blocks start in the
//     first wave.
//   - f32 (`causal_fwd_kernel`, the exact arm): the f32-FMA tile of
//     attention.cuh.
//
// Work is cut to what the mask lets through: a block streams only the
// key tiles from the one holding start[b] to the one holding the last
// slot its queries can see (pos + last row), not all T slots.
//
// Semantics kept from the reference kernel (both arms):
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
//     rescale factor exp(-1e30 - m) is exactly 0 (and a tile a warp
//     skips holds no key visible to its rows);
//   - probabilities are rounded to V's dtype before P.V (f32 sums).
#include "attention.cuh"
#include "attention_mma.cuh"
#include "common.cuh"

using namespace attn;

namespace {

// ---- bf16: tensor cores ------------------------------------------------------

constexpr int MMA_BQ = 64;  // queries per block: 4 warps of 16 rows
constexpr int MMA_NT = 128;
constexpr int STAGES = 2;

template <int D>
constexpr int mma_smem_bytes() {
  return (MMA_BQ * D + STAGES * 2 * amma::TILE * D) * 2 +
         (MMA_NT / 32 + 1) * D * 4;
}

// four blocks (16 warps) per SM up to D = 64: at most 128 registers
template <int D>
__global__ void __launch_bounds__(MMA_NT, D <= 64 ? 4 : 2)
    causal_fwd_mma_kernel(const amma::bf16* __restrict__ q,
                          const amma::bf16* __restrict__ k,
                          const amma::bf16* __restrict__ v,
                          const int* __restrict__ start,
                          amma::bf16* __restrict__ out, int S, int T_len,
                          int pos, int rep, Strides sq, Strides sk,
                          Strides sv, Strides so, float scale) {
  using namespace amma;
  constexpr int BK = TILE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // (BQ, D)
  bf16* Ks = Qs + MMA_BQ * D;                    // STAGES x (BK, D)
  bf16* Vs = Ks + STAGES * BK * D;               // STAGES x (BK, D)
  float* Red = reinterpret_cast<float*>(Vs + STAGES * BK * D);  // (4, D)
  float* Vmean = Red + (MMA_NT / 32) * D;  // (D,) mean of V over T

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_BQ;  // most keys 1st
  const int kvh = h / rep;
  const bf16* kb = k + b * sk.b + kvh * sk.h;
  const bf16* vb = v + b * sv.b + kvh * sv.h;
  const int st0 = max(start[b], 0);  // j >= a negative start: all j
  const int q_last = min(q0 + MMA_BQ, S) - 1;  // last real query
  // rows form a prefix without keys (pos + i < st0), then rows with keys
  const bool some_empty = pos + q0 < st0;
  const bool some_keys = pos + q_last >= st0;
  const int r0 = q0 + 16 * warp;  // the warp's first row
  // the slot of its last row, or -1 when none of its rows sees a key
  const int w_hi =
      r0 < S && pos + min(r0 + 15, S - 1) >= st0 ? pos + min(r0 + 15, S - 1)
                                                 : -1;

  if (some_empty) {
    // column sums of V over T: 16-byte loads, CPR threads a row, then
    // over the lanes of a warp that share columns, then over the warps
    constexpr int CPR = D / 8, RPP = MMA_NT / CPR;
    const int c = threadIdx.x % CPR;
    float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int j = threadIdx.x / CPR; j < T_len; j += RPP) {
      const uint4 x =
          *reinterpret_cast<const uint4*>(vb + j * sv.s + 8 * c);
      const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int u = 0; u < 8; ++u) sum[u] += __bfloat162float(e[u]);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int o = CPR; o < 32; o <<= 1)
        sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], o);
      if (lane < CPR) Red[warp * D + 8 * c + u] = sum[u];
    }
    __syncthreads();
    if (threadIdx.x < D) {
      float total = 0.f;
      for (int w = 0; w < MMA_NT / 32; ++w)
        total += Red[w * D + threadIdx.x];
      Vmean[threadIdx.x] = total / (float)T_len;
    }
    __syncthreads();
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero(acc);
  if (some_keys) {
    load_tile<D, MMA_BQ, MMA_NT>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
    // the caller guarantees pos + S <= T_len
    const int k_hi = pos + q_last;
    int k0 = (st0 / BK) * BK, st = 0;
    load_tile<D, BK, MMA_NT>(Ks, kb, sk.s, k0, T_len);
    load_tile<D, BK, MMA_NT>(Vs, vb, sv.s, k0, T_len);
    cp_commit();
    for (; k0 <= k_hi; k0 += BK, st ^= 1) {
      if (k0 + BK <= k_hi) {  // into the other stage, freed at the end
        const int nxt = (st ^ 1) * BK * D;  // of the previous iteration
        load_tile<D, BK, MMA_NT>(Ks + nxt, kb, sk.s, k0 + BK, T_len);
        load_tile<D, BK, MMA_NT>(Vs + nxt, vb, sv.s, k0 + BK, T_len);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      if (k0 <= w_hi) {  // else no key here is visible to any row of
        float s[8][4];   // this warp (w_hi is -1 when it has none)
        qk_mma<D>(s, Qs, 16 * warp, Ks + st * BK * D);
        // column c = 8 j + (e & 1) of this thread's tile is key
        // k0 + 2 t + c: visible to row i when lo <= c <= hi[i], a key
        // at all when c < end
        const int base = k0 + 2 * t;
        const int lo = st0 - base, end = T_len - base;
        const int hi[2] = {pos + r0 + g - base, pos + r0 + g + 8 - base};
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + (e & 1);
            float x = s[j][e] * scale;
            if (c < lo || c > hi[e >> 1]) x = NEG_INF;
            if (c >= end) x = -INFINITY;  // past the cache: not a key
            s[j][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float mnew = fmaxf(m[i], quad_max(mx[i]));  // finite: k0
          alpha[i] = ex2((m[i] - mnew) * LOG2E);  // is a key below T
          m[i] = mnew;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2((s[j][e] - m[e >> 1]) * LOG2E);
            sum[e >> 1] += p;
            s[j][e] = p;
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
        pv_mma<D, D / 8>(acc, s, Vs + st * BK * D, 0);
      }
      __syncthreads();  // this stage is refilled in the next iteration
    }
  }

  bf16* ob = out + b * so.b + h * so.h;
  const int first = max(start[b], 0) - pos;  // rows below it see no key
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    const float inv = 1.f / quad_sum(l[i]);
    if (row >= S) continue;
    const bool empty = row < first;  // its l is 0 or counts masks
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float x0 = empty ? Vmean[c] : acc[j][2 * i] * inv;
      const float x1 = empty ? Vmean[c + 1] : acc[j][2 * i + 1] * inv;
      *reinterpret_cast<__nv_bfloat162*>(ob + row * so.s + c) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

// ---- f32: the FMA tile of attention.cuh --------------------------------------

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
  const int b = blockIdx.z, h = blockIdx.y;
  const int qt0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // most keys first
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

struct Args {
  const void *q, *k, *v;
  const int* start;
  void* out;
  int B, S, H, T_len, pos, rep;
  Strides sq, sk, sv, so;
  float scale;
};

template <int D>
int launch_mma(const Args& a, cudaStream_t stream) {
  const int smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      causal_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + MMA_BQ - 1) / MMA_BQ, a.H, a.B);
  causal_fwd_mma_kernel<D><<<grid, MMA_NT, smem, stream>>>(
      (const amma::bf16*)a.q, (const amma::bf16*)a.k,
      (const amma::bf16*)a.v, a.start, (amma::bf16*)a.out, a.S, a.T_len,
      a.pos, a.rep, a.sq, a.sk, a.sv, a.so, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  const int smem = tile_floats<D>(D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      causal_fwd_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  causal_fwd_kernel<float, D><<<grid, NT, smem, stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, a.start,
      (float*)a.out, a.S, a.T_len, a.pos, a.rep, a.sq, a.sk, a.sv, a.so,
      a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Args& a, bool bf16, cudaStream_t s) {
  return bf16 ? launch_mma<D>(a, s) : launch_f32<D>(a, s);
}

// cp.async and the mean's loads move 16-byte chunks: every base and
// row stride of the bf16 views must be a multiple of 16 bytes
bool aligned16(const void* p, const Strides& st) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && st.b % 8 == 0 &&
         st.s % 8 == 0 && st.h % 8 == 0;
}

}  // namespace

// q/out: (B, S, H, D) and k/v: (B, T, KH, D) views with D contiguous,
// element strides given per tensor (batch, seq, head); H = KH * rep.
// f32 (bf16 = 0) or bf16 (bf16 = 1).  start: (B,) int32 left-pad
// offsets on the device.  Queries sit at cache slots pos..pos+S-1, and
// pos + S <= T.  D is 16, 32, 64 or 128; bf16 views need 16-byte
// aligned bases and strides.  Returns the CUDA error code (0 =
// launched).
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
  const Args a{q, k, v, start, out, B, S, H, T_len, pos, rep,
               {qb, qs, qh}, {kb, ks, kh}, {vb, vs, vh}, {ob, os, oh},
               scale};
  if (bf16 && !(aligned16(q, a.sq) && aligned16(k, a.sk) &&
                aligned16(v, a.sv) && aligned16(out, a.so)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch<16>(a, bf16, s);
    case 32:
      return launch<32>(a, bf16, s);
    case 64:
      return launch<64>(a, bf16, s);
    case 128:
      return launch<128>(a, bf16, s);
  }
  return (int)cudaErrorInvalidValue;
}
