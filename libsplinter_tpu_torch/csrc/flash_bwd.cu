// K6: the backward of K1's bidirectional masked multi-head attention.
//
// Replaces libsplinter_tpu/ops/flash_attention.py `_mha_bwd_kernel`
// (reached through `_flash_bwd_pallas`, the custom VJP of
// `flash_attention`).  With P = softmax(mask(Q K^T * scale)) and
// D_i = rowsum(dO_i * O_i):
//     dV = P^T dO,   dS = P * (dO V^T - D) * scale,
//     dQ = dS K,     dK = dS^T Q.
//
// The TPU kernel runs one program per (batch, head) with all of Q, K,
// V, O and dO (S, D) resident in VMEM (2.5 MB at S = 2048), recomputes
// each (block_q, S) probability tile with its own max and sum, and
// carries dK/dV across query blocks.  A Hopper block has 227 KB of
// shared memory and no order between blocks, so this port splits the
// work into three kernels on one stream, none of them with atomics
// (the result is deterministic, so a resumed training step repeats
// bit for bit):
//   1. stats: per query row the max m and sum l of its masked logits
//      (online over 64-key tiles) and D_i, all f32, into a (3, B, H, S)
//      scratch the wrapper allocates;
//   2. dK/dV: one block per 64-key tile loops over 64-query tiles,
//      recomputes P^T = exp(s - m) / l and dS^T for the tile and
//      accumulates dV += P^T dO and dK += dS^T Q in registers;
//   3. dQ: one block per 64-query tile loops over 64-key tiles and
//      accumulates dQ += dS K.
// Bound on an H100: the JAX kernel's 10 * B * H * S^2 * D FLOPs (five
// S x S x D products).  These kernels do 16 (QK^T three times, dO V^T
// twice) as f32 FMA from shared memory on the thread tile K1 uses, so
// they sit under the f32 roof, far from the bf16 one — wgmma/TMA is
// later work.
//
// Semantics kept from the reference kernel:
//   - masked logits are the FINITE -1e30 after the scale, so a
//     fully-masked row has m = -1e30 and l = S: P is uniform over all
//     S keys (S is the caller's padded length).  No tile is skipped for
//     being fully masked; keys past S are not keys at all (-inf, P 0);
//   - P and dS stay f32 (never rounded to the input dtype), and every
//     product is an f32 product of the widened inputs;
//   - dq, dk and dv are written in the inputs' dtype.
#include "attention.cuh"
#include "common.cuh"

using namespace attn;

namespace {

// acc[i][j] += A (64 x 64, row-major with ld 65) . X (64 x D, ld D + 1)
// for this thread's rows ty + 16 i and columns tx + 16 j
template <int D>
__device__ __forceinline__ void acc_tile(const float* A, const float* X,
                                         float acc[4][D / 16], int ty,
                                         int tx) {
  constexpr int LD = D + 1;
#pragma unroll 8
  for (int c = 0; c < 64; ++c) {
    float a[4], x[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * 65 + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) x[j] = X[c * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(a[i], x[j], acc[i][j]);
  }
}

// the masked, scaled logit of one (query, key) pair as the reference
// computes it: -1e30 for a masked key
__device__ __forceinline__ float masked_logit(float dot, float scale,
                                              float key_mask) {
  const float x = dot * scale;
  return key_mask > 0.f ? x : NEG_INF;
}

// 64 x D rows of a strided (rows, D) slice to global memory, in T
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, long long stride,
                                           const float acc[4][D / 16],
                                           int row0, int limit, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= limit) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dst[row * stride + tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

// ---- pass 1: row statistics ----------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ o, const T* __restrict__ dout,
                     const float* __restrict__ mask,
                     float* __restrict__ stats, int S, int H, Strides sq,
                     Strides sk, Strides so, Strides sd, float scale) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;              // (BQ, D + 1)
  float* Ks = Qs + BQ * LD;      // (BK, D + 1)
  float* Ms = Ks + BK * LD;      // (BK,)

  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const T* kb = k + b * sk.b + h * sk.h;
  const float* mb = mask + (long long)b * S;
  const long long plane = (long long)gridDim.z * H * S;
  float* row_m = stats + ((long long)b * H + h) * S;
  float* row_l = row_m + plane;
  float* row_d = row_l + plane;

  load_rows<T, D>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, BQ, S);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // previous tile's Ks reads are done
    load_rows<T, D>(Ks, kb, sk.s, k0, BK, S);
    for (int e = t; e < BK; e += NT) Ms[e] = k0 + e < S ? mb[k0 + e] : 0.f;
    __syncthreads();
    float s[4][4];
    qk_tile<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x[4], mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        x[j] = k0 + c < S ? masked_logit(s[i][j], scale, Ms[c]) : -INFINITY;
        mx = fmaxf(mx, x[j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mnew = fmaxf(m[i], mx);  // finite: the tile has a key
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(x[j] - mnew);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * expf(m[i] - mnew) + sum;
      m[i] = mnew;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row < S) {
        row_m[row] = m[i];
        row_l[row] = l[i];
      }
    }
  }
  // D_i = rowsum(dO * O) in f32: one warp per row
  const int warp = t / 32, lane = t % 32;
  const T* ob = o + b * so.b + h * so.h;
  const T* db = dout + b * sd.b + h * sd.h;
  for (int r = warp; r < BQ; r += NT / 32) {
    const int row = q0 + r;
    if (row >= S) break;
    float acc = 0.f;
    for (int c = lane; c < D; c += 32)
      acc = fmaf(to_f(db[row * sd.s + c]), to_f(ob[row * so.s + c]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) row_d[row] = acc;
  }
}

// ---- pass 2: dK and dV per key tile --------------------------------------

template <int D>
constexpr int dkdv_floats() {
  return (2 * BK + 2 * BQ) * (D + 1) + 2 * BK * 65 + BK + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ mask,
                    const float* __restrict__ stats, T* __restrict__ dk,
                    T* __restrict__ dv, int S, int H, Strides sq, Strides sk,
                    Strides sv, Strides sd, Strides sdk, Strides sdv,
                    float scale) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Ks = smem;               // (BK, D + 1)
  float* Vs = Ks + BK * LD;       // (BK, D + 1)
  float* Qs = Vs + BK * LD;       // (BQ, D + 1)
  float* Ds = Qs + BQ * LD;       // (BQ, D + 1) dO
  float* Pt = Ds + BQ * LD;       // (BK, BQ + 1) P^T
  float* St = Pt + BK * 65;       // (BK, BQ + 1) dS^T
  float* Ms = St + BK * 65;       // (BK,) key mask
  float* Rm = Ms + BK;            // (BQ,) row max
  float* Rl = Rm + BQ;            // (BQ,) row sum
  float* Rd = Rl + BQ;            // (BQ,) D_i

  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BK;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* db = dout + b * sd.b + h * sd.h;
  const float* mb = mask + (long long)b * S;
  const long long plane = (long long)gridDim.z * H * S;
  const float* row_m = stats + ((long long)b * H + h) * S;
  const float* row_l = row_m + plane;
  const float* row_d = row_l + plane;

  load_rows<T, D>(Ks, k + b * sk.b + h * sk.h, sk.s, k0, BK, S);
  load_rows<T, D>(Vs, v + b * sv.b + h * sv.h, sv.s, k0, BK, S);
  for (int e = t; e < BK; e += NT) Ms[e] = k0 + e < S ? mb[k0 + e] : 0.f;

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < S; q0 += BQ) {
    __syncthreads();  // previous tile's Qs/Ds/Pt/St reads are done
    load_rows<T, D>(Qs, qb, sq.s, q0, BQ, S);
    load_rows<T, D>(Ds, db, sd.s, q0, BQ, S);
    for (int e = t; e < BQ; e += NT) {
      const bool in = q0 + e < S;
      Rm[e] = in ? row_m[q0 + e] : 0.f;
      Rl[e] = in ? row_l[q0 + e] : 1.f;
      Rd[e] = in ? row_d[q0 + e] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    qk_tile<D>(Ks, Qs, ty, tx, s);   // [key ty + 16 i][query tx + 16 j]
    qk_tile<D>(Vs, Ds, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = ty + 16 * i;
      const bool key_in = k0 + kr < S;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = tx + 16 * j;
        float p = 0.f;
        if (key_in && q0 + qr < S)
          p = expf(masked_logit(s[i][j], scale, Ms[kr]) - Rm[qr]) / Rl[qr];
        Pt[kr * 65 + qr] = p;
        St[kr * 65 + qr] = p * (dp[i][j] - Rd[qr]) * scale;
      }
    }
    __syncthreads();
    acc_tile<D>(Pt, Ds, dv_acc, ty, tx);
    acc_tile<D>(St, Qs, dk_acc, ty, tx);
  }
  store_rows<T, D>(dk + b * sdk.b + h * sdk.h, sdk.s, dk_acc, k0, S, ty, tx);
  store_rows<T, D>(dv + b * sdv.b + h * sdv.h, sdv.s, dv_acc, k0, S, ty, tx);
}

// ---- pass 3: dQ per query tile --------------------------------------------

template <int D>
constexpr int dq_floats() {
  return (2 * BQ + 2 * BK) * (D + 1) + BQ * 65 + BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ mask,
                  const float* __restrict__ stats, T* __restrict__ dq, int S,
                  int H, Strides sq, Strides sk, Strides sv, Strides sd,
                  Strides sdq, float scale) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;               // (BQ, D + 1)
  float* Ds = Qs + BQ * LD;       // (BQ, D + 1) dO
  float* Ks = Ds + BQ * LD;       // (BK, D + 1)
  float* Vs = Ks + BK * LD;       // (BK, D + 1)
  float* Ss = Vs + BK * LD;       // (BQ, BK + 1) dS
  float* Ms = Ss + BQ * 65;       // (BK,) key mask

  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* mb = mask + (long long)b * S;
  const long long plane = (long long)gridDim.z * H * S;
  const float* row_m = stats + ((long long)b * H + h) * S;
  const float* row_l = row_m + plane;
  const float* row_d = row_l + plane;

  load_rows<T, D>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, BQ, S);
  load_rows<T, D>(Ds, dout + b * sd.b + h * sd.h, sd.s, q0, BQ, S);
  float m[4], l[4], dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool in = row < S;
    m[i] = in ? row_m[row] : 0.f;
    l[i] = in ? row_l[row] : 1.f;
    dd[i] = in ? row_d[row] : 0.f;
  }
  float dq_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dq_acc[i][j] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // previous tile's Ks/Ss reads are done
    load_rows<T, D>(Ks, kb, sk.s, k0, BK, S);
    load_rows<T, D>(Vs, vb, sv.s, k0, BK, S);
    for (int e = t; e < BK; e += NT) Ms[e] = k0 + e < S ? mb[k0 + e] : 0.f;
    __syncthreads();
    float s[4][4], dp[4][4];
    qk_tile<D>(Qs, Ks, ty, tx, s);   // [query ty + 16 i][key tx + 16 j]
    qk_tile<D>(Ds, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool row_in = q0 + ty + 16 * i < S;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float p = 0.f;
        if (row_in && k0 + c < S)
          p = expf(masked_logit(s[i][j], scale, Ms[c]) - m[i]) / l[i];
        Ss[(ty + 16 * i) * 65 + c] = p * (dp[i][j] - dd[i]) * scale;
      }
    }
    __syncthreads();
    acc_tile<D>(Ss, Ks, dq_acc, ty, tx);
  }
  store_rows<T, D>(dq + b * sdq.b + h * sdq.h, sdq.s, dq_acc, q0, S, ty, tx);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* mask;
  float* stats;
  void *dq, *dk, *dv;
  int B, S, H;
  Strides sq, sk, sv, so, sd, sdq, sdk, sdv;
  float scale;
};

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  const int stats_smem = ((BQ + BK) * (D + 1) + BK) * (int)sizeof(float);
  const int dkdv_smem = dkdv_floats<D>() * (int)sizeof(float);
  const int dq_smem = dq_floats<D>() * (int)sizeof(float);
  cudaError_t err = allow_smem(bwd_stats_kernel<T, D>, stats_smem);
  if (err == cudaSuccess) err = allow_smem(bwd_dkdv_kernel<T, D>, dkdv_smem);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_kernel<T, D>, dq_smem);
  if (err != cudaSuccess) return (int)err;
  const T *q = (const T*)a.q, *k = (const T*)a.k, *v = (const T*)a.v;
  const T *o = (const T*)a.o, *dout = (const T*)a.dout;
  const dim3 qgrid((a.S + BQ - 1) / BQ, a.H, a.B);
  const dim3 kgrid((a.S + BK - 1) / BK, a.H, a.B);
  bwd_stats_kernel<T, D><<<qgrid, NT, stats_smem, stream>>>(
      q, k, o, dout, a.mask, a.stats, a.S, a.H, a.sq, a.sk, a.so, a.sd,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_kernel<T, D><<<kgrid, NT, dkdv_smem, stream>>>(
      q, k, v, dout, a.mask, a.stats, (T*)a.dk, (T*)a.dv, a.S, a.H, a.sq,
      a.sk, a.sv, a.sd, a.sdk, a.sdv, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_kernel<T, D><<<qgrid, NT, dq_smem, stream>>>(
      q, k, v, dout, a.mask, a.stats, (T*)a.dq, a.S, a.H, a.sq, a.sk, a.sv,
      a.sd, a.sdq, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(a, s);
    case 32:
      return launch<T, 32>(a, s);
    case 64:
      return launch<T, 64>(a, s);
    case 128:
      return launch<T, 128>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k/v/o/dout and dq/dk/dv: (B, S, H, D) views with D contiguous,
// element strides given per tensor as (batch, seq, head) triples in
// that order; f32 (bf16 = 0) or bf16 (bf16 = 1), all alike.  mask:
// (B, S) f32 key validity, contiguous.  stats: (3, B, H, S) f32
// scratch.  D is 16, 32, 64 or 128.  Launches the three passes on
// `stream`; returns the CUDA error code (0 = launched).
extern "C" int sptk_flash_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* mask, float* stats, void* dq,
                              void* dk, void* dv, int B, int S, int H, int D,
                              int bf16, const long long* strides,
                              float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long* st = strides;
  auto take = [&st]() {
    const Strides s{st[0], st[1], st[2]};
    st += 3;
    return s;
  };
  // braced initialisers evaluate left to right: the triples in order
  const Args a{q,      k,      v,      o,      dout,   mask,   stats,
               dq,     dk,     dv,     B,      S,      H,      take(),
               take(), take(), take(), take(), take(), take(), take(),
               scale};
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(D, a, s) : dispatch<float>(D, a, s);
}
