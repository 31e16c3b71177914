// K1: bidirectional masked multi-head attention, forward only.
//
// Replaces libsplinter_tpu/ops/flash_attention.py `_mha_kernel`
// (reached through `_flash_pallas` / `flash_attention`).  The TPU
// kernel keeps all of K/V for a (batch, head) resident in VMEM (1 MB
// at S = 2048); a Hopper block has 227 KB of shared memory, so this
// kernel streams K/V in BK-row tiles with an online softmax in f32 and
// never materialises the (S, S) logits.
//
// One block per (64-query tile, head, batch row).  Bound on an H100:
// 4 * B * H * S^2 * D FLOPs; this first version runs them as f32 FMA
// from shared memory (not tensor cores), so it sits under the f32
// roof, far from the bf16 one — wgmma/TMA is later work.
//
// Semantics kept from the reference kernel:
//   - logits in f32 (scale 1/sqrt(D)), masked keys get the FINITE
//     -1e30, never -inf: a fully-masked row is the uniform average over
//     all S keys (S is the caller's padded length), where stock flash
//     kernels emit 0 or NaN;
//   - the running max starts at -inf, so a tile whose keys are all
//     masked only counts until a tile with a real key arrives: its
//     rescale factor exp(-1e30 - m) is exactly 0;
//   - probabilities are rounded to V's dtype before P.V (f32 sums).
#include "attention.cuh"
#include "common.cuh"

using namespace attn;

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, int S, Strides sq, Strides sk,
                     Strides sv, Strides so, float scale) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                 // (BQ, D + 1)
  float* Ks = Qs + BQ * LD;         // (BK, D + 1)
  float* Vs = Ks + BK * LD;         // (BK, D + 1)
  float* Ps = Vs + BK * LD;         // (BQ, BK + 1)
  float* Ms = Ps + BQ * (BK + 1);   // (BK,) key mask

  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int b = blockIdx.z, h = blockIdx.y, qt0 = blockIdx.x * BQ;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* mb = mask + (long long)b * S;

  load_rows<T, D>(Qs, q + b * sq.b + h * sq.h, sq.s, qt0, BQ, S);
  RowState<D> st;
  st.init();

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // previous tile's Ps/Vs reads are done
    load_rows<T, D>(Ks, kb, sk.s, k0, BK, S);
    load_rows<T, D>(Vs, vb, sv.s, k0, BK, S);
    for (int e = t; e < BK; e += NT) Ms[e] = k0 + e < S ? mb[k0 + e] : 0.f;
    __syncthreads();

    float s[4][4];
    qk_tile<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float x = s[i][j] * scale;
        if (!(Ms[c] > 0.f)) x = NEG_INF;
        if (k0 + c >= S) x = -INFINITY;  // past the end: not a key at all
        s[i][j] = x;
      }
    softmax_tile<T, D>(s, Ps, st, ty, tx);
    __syncthreads();
    pv_tile<D>(Ps, Vs, st, ty, tx);
  }

  T* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      ob[row * so.s + tx + 16 * j] = from_f<T>(st.acc[i][j] / st.l[i]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* mask,
           void* out, int B, int S, int H, Strides sq, Strides sk, Strides sv,
           Strides so, float scale, cudaStream_t stream) {
  const int smem = tile_floats<D>(BK) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, (T*)out, S, sq, sk, sv, so,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const float* mask, void* out, int B, int S, int H, Strides sq,
             Strides sk, Strides sv, Strides so, float scale,
             cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, mask, out, B, S, H, sq, sk, sv, so,
                           scale, s);
    case 32:
      return launch<T, 32>(q, k, v, mask, out, B, S, H, sq, sk, sv, so,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, mask, out, B, S, H, sq, sk, sv, so,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, mask, out, B, S, H, sq, sk, sv, so,
                            scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k/v/out: (B, S, H, D) views with D contiguous, element strides
// given per tensor (batch, seq, head); f32 (bf16 = 0) or bf16
// (bf16 = 1).  mask: (B, S) f32 key validity, contiguous.  D is 16,
// 32, 64 or 128.  Returns the CUDA error code (0 = launched).
extern "C" int sptk_flash_fwd(const void* q, const void* k, const void* v,
                              const float* mask, void* out, int B, int S,
                              int H, int D, int bf16, long long qb,
                              long long qs, long long qh, long long kb,
                              long long ks, long long kh, long long vb,
                              long long vs, long long vh, long long ob,
                              long long os, long long oh, float scale,
                              void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides sq{qb, qs, qh}, sk{kb, ks, kh}, sv{vb, vs, vh},
      so{ob, os, oh};
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(D, q, k, v, mask, out, B, S, H, sq,
                                        sk, sv, so, scale, s)
              : dispatch<float>(D, q, k, v, mask, out, B, S, H, sq, sk, sv,
                                so, scale, s);
}
