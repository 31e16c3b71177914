// K1: bidirectional masked multi-head attention, forward.
//
// Replaces libsplinter_tpu/ops/flash_attention.py `_mha_kernel`
// (reached through `_flash_pallas` / `flash_attention`).  The TPU
// kernel keeps all of K/V for a (batch, head) resident in VMEM (1 MB
// at S = 2048); a Hopper block has 227 KB of shared memory, so this
// kernel streams K/V in 64-row tiles with an online softmax in f32 and
// never materialises the (S, S) logits.
//
// Bound on an H100: 4 * B * H * S^2 * D FLOPs (two S x S x D
// products), against the tensor cores' 989 TFLOP/s in bf16.  Two
// hand-written kernels, chosen by the inputs' dtype:
//   - bf16 (`flash_fwd_mma_kernel`, the serving and training path):
//     the tensor-core tile of attention_mma.cuh.  One block of 8 warps
//     per (128-query tile, head, batch row); each warp owns 16 query
//     rows and keeps the online softmax of its rows in registers (max
//     and sum reduced over a quad; at most 128 registers up to D = 64,
//     so two blocks share an SM).  K/V
//     tiles of 64 keys arrive by cp.async into a 2-stage ring, so the
//     next tile loads while this one computes.  Q.K^T and P.V are
//     mma.sync m16n8k16 bf16 products with f32 sums; P is rounded to
//     bf16 in registers and used as the A operand of P.V directly.
//   - f32 (`flash_fwd_kernel`, the exact arm, the counterpart of the
//     JAX kernel at Precision.HIGHEST): the f32-FMA tile of
//     attention.cuh, full f32 products.
//
// Semantics kept from the reference kernel (both arms):
//   - logits in f32 (scale 1/sqrt(D)), masked keys get the FINITE
//     -1e30, never -inf: a fully-masked row is the uniform average over
//     all S keys (S is the caller's padded length), where stock flash
//     kernels emit 0 or NaN; keys past S get -inf (not keys at all);
//   - the running max starts at -inf, so a tile whose keys are all
//     masked only counts until a tile with a real key arrives: its
//     rescale factor exp(-1e30 - m) is exactly 0;
//   - probabilities are rounded to V's dtype before P.V (f32 sums);
//   - the output is acc / l (bf16: acc times 1 / l).
// For the backward (K6) the caller may pass `stats`: each row's final
// max m and sum l, f32, into a (2, B, H, S) array.  Both are kept, not
// their log-sum-exp: for a fully-masked row m = -1e30 and l = S, and
// -1e30 + log S rounds to -1e30 in f32, which would rebuild P = 1
// instead of 1/S.  Writing them changes nothing else: the output is
// the same bit for bit with and without `stats`.
#include "attention.cuh"
#include "attention_mma.cuh"
#include "common.cuh"

using namespace attn;

namespace {

// ---- bf16: tensor cores ------------------------------------------------------

constexpr int MMA_BQ = 128;  // queries per block: 8 warps of 16 rows
constexpr int MMA_NT = 256;
constexpr int STAGES = 2;

template <int D>
constexpr int mma_smem_bytes() {
  return (MMA_BQ * D + STAGES * 2 * amma::TILE * D) * 2 +
         STAGES * amma::TILE * 4;
}

// two blocks (16 warps) per SM up to D = 64: at most 128 registers
template <int D>
__global__ void __launch_bounds__(MMA_NT, D <= 64 ? 2 : 1)
    flash_fwd_mma_kernel(const amma::bf16* __restrict__ q,
                         const amma::bf16* __restrict__ k,
                         const amma::bf16* __restrict__ v,
                         const float* __restrict__ mask,
                         amma::bf16* __restrict__ out,
                         float* __restrict__ stats, int S, int H, Strides sq,
                         Strides sk, Strides sv, Strides so, float scale) {
  using namespace amma;
  constexpr int BK = TILE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // (BQ, D)
  bf16* Ks = Qs + MMA_BQ * D;                    // STAGES x (BK, D)
  bf16* Vs = Ks + STAGES * BK * D;               // STAGES x (BK, D)
  float* Ms = reinterpret_cast<float*>(Vs + STAGES * BK * D);  // x (BK,)

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * MMA_BQ;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const float* mb = mask + (long long)b * S;

  auto load_kv = [&](int stage, int k0) {
    load_tile<D, BK, MMA_NT>(Ks + stage * BK * D, kb, sk.s, k0, S);
    load_tile<D, BK, MMA_NT>(Vs + stage * BK * D, vb, sv.s, k0, S);
    load_vec<BK, MMA_NT>(Ms + stage * BK, mb, k0, S);
  };

  load_tile<D, MMA_BQ, MMA_NT>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_kv(0, 0);
  cp_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
  zero(acc);

  const int n_tiles = (S + BK - 1) / BK;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES, k0 = it * BK;
    if (it + 1 < n_tiles) {  // the stage it + 1 uses was freed at the
      load_kv((it + 1) % STAGES, k0 + BK);  // end of iteration it - 1
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    const bf16* Kt = Ks + st * BK * D;
    const float* Mt = Ms + st * BK;
    float s[8][4];
    qk_mma<D>(s, Qs, 16 * warp, Kt);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c0 = 8 * j + 2 * t;  // key columns c0 and c0 + 1
      const float2 km = *reinterpret_cast<const float2*>(Mt + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + (e & 1);
        float x = s[j][e] * scale;
        if (!((e & 1 ? km.y : km.x) > 0.f)) x = NEG_INF;
        if (k0 + c >= S) x = -INFINITY;  // past the end: not a key at all
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mnew = fmaxf(m[i], quad_max(mx[i]));  // finite: the
      alpha[i] = ex2((m[i] - mnew) * LOG2E);  // tile holds a key < S
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
    __syncthreads();  // this stage is refilled in iteration it + 1
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = 1.f / l[i];
  }
  const int row0 = q0 + 16 * warp;
  store_rows<D / 8>(out + b * so.b + h * so.h, so.s, acc, inv, row0, 0, S);
  if (stats != nullptr && t == 0) {
    float* row_m = stats + ((long long)b * H + h) * S;
    float* row_l = row_m + (long long)gridDim.z * H * S;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + g + 8 * i;
      if (row < S) {
        row_m[row] = m[i];
        row_l[row] = l[i];
      }
    }
  }
}

// ---- f32: the FMA tile of attention.cuh --------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ stats, int S,
                     int H, Strides sq, Strides sk, Strides sv, Strides so,
                     float scale) {
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
  if (stats != nullptr && tx == 0) {  // m and l agree over the 16 tx
    float* row_m = stats + ((long long)b * H + h) * S;
    float* row_l = row_m + (long long)gridDim.z * H * S;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qt0 + ty + 16 * i;
      if (row < S) {
        row_m[row] = st.m[i];
        row_l[row] = st.l[i];
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const float* mask;
  void* out;
  float* stats;
  int B, S, H;
  Strides sq, sk, sv, so;
  float scale;
};

template <int D>
int launch_mma(const Args& a, cudaStream_t stream) {
  const int smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + MMA_BQ - 1) / MMA_BQ, a.H, a.B);
  flash_fwd_mma_kernel<D><<<grid, MMA_NT, smem, stream>>>(
      (const amma::bf16*)a.q, (const amma::bf16*)a.k,
      (const amma::bf16*)a.v, a.mask, (amma::bf16*)a.out, a.stats, a.S, a.H,
      a.sq, a.sk, a.sv, a.so, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  const int smem = tile_floats<D>(BK) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<float, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  flash_fwd_kernel<float, D><<<grid, NT, smem, stream>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v, a.mask,
      (float*)a.out, a.stats, a.S, a.H, a.sq, a.sk, a.sv, a.so, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Args& a, bool bf16, cudaStream_t s) {
  return bf16 ? launch_mma<D>(a, s) : launch_f32<D>(a, s);
}

// cp.async moves 16-byte chunks: every base and row stride of the
// bf16 views must be a multiple of 16 bytes
bool aligned16(const void* p, const Strides& st) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && st.b % 8 == 0 &&
         st.s % 8 == 0 && st.h % 8 == 0;
}

}  // namespace

// q/k/v/out: (B, S, H, D) views with D contiguous, element strides
// given per tensor (batch, seq, head); f32 (bf16 = 0) or bf16
// (bf16 = 1).  mask: (B, S) f32 key validity, contiguous.  stats: NULL,
// or a (2, B, H, S) f32 array that receives each row's max and sum.
// D is 16, 32, 64 or 128; bf16 views need 16-byte aligned bases and
// strides.  Returns the CUDA error code (0 = launched).
extern "C" int sptk_flash_fwd(const void* q, const void* k, const void* v,
                              const float* mask, void* out, float* stats,
                              int B, int S, int H, int D, int bf16,
                              long long qb, long long qs, long long qh,
                              long long kb, long long ks, long long kh,
                              long long vb, long long vs, long long vh,
                              long long ob, long long os, long long oh,
                              float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, mask, out, stats, B, S, H, {qb, qs, qh},
               {kb, ks, kh}, {vb, vs, vh}, {ob, os, oh}, scale};
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
