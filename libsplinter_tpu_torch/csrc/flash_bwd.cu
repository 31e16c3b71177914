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
// shared memory and no order between blocks, so this port takes each
// row's max m and sum l from K1 (its `stats` output, (2, B, H, S) f32)
// and splits the rest into three kernels on one stream, none of them
// with atomics (the result is deterministic, so a resumed training step
// repeats bit for bit):
//   1. rowsum: D_i = rowsum(dO * O) in f32, and log2 l_i, into a
//      (2, B, H, S) scratch the wrapper allocates (memory-bound: O and
//      dO read once);
//   2. dK/dV: one block per 64-key tile loops over 64-query tiles,
//      recomputes P^T = exp(S^T * scale masked - m) / l and
//      dS^T = P^T * (dP^T - D) * scale for the tile and accumulates
//      dV += P^T dO and dK += dS^T Q in registers;
//   3. dQ: one block per 64-query tile loops over 64-key tiles and
//      accumulates dQ += dS K.
// Bound on an H100: the JAX kernel's 10 * B * H * S^2 * D FLOPs (five
// S x S x D products).  These kernels do 14 (Q K^T and dO V^T in both
// the dK/dV and the dQ kernel, then the three accumulating products):
// the price of a split with no atomics.
//
// Two hand-written arms, chosen by the inputs' dtype:
//   - bf16 (`bwd_dkdv_mma_kernel`, `bwd_dq_mma_kernel`, the training
//     path): the tensor-core tile of attention_mma.cuh.  Each warp owns
//     16 rows (keys in dK/dV, queries in dQ); the streamed tiles arrive
//     by cp.async into a 2-stage ring; S^T = K Q^T and dP^T = V dO^T
//     are mma.sync bf16 products; P = 2^((x - m) log2 e - log2 l) (no
//     division; x - m is exact, so a dead row's P is 2^-log2 S); the
//     P^T and dS^T / scale tiles are
//     rounded to bf16 in registers and reused as the A operands of
//     dV += P^T dO and dK += dS^T Q (Q and dO through ldmatrix.trans).
//     At D = 128 the dK/dV accumulators do not fit one warp's registers:
//     two warps share 16 key rows, each accumulating half of D (both
//     compute the logit tile).  P and dS are rounded to bf16 before
//     their products, as the TPU kernel's default-precision dots round
//     their f32 inputs: each term moves by at most 2^-8 of itself.
//   - f32 (`bwd_dkdv_kernel`, `bwd_dq_kernel`, the exact arm, the
//     counterpart of the JAX kernel at Precision.HIGHEST): the f32-FMA
//     thread tile of attention.cuh; P and dS stay f32 and every product
//     is an f32 product.
//
// Semantics kept from the reference kernel:
//   - masked logits are the FINITE -1e30 after the scale, so a
//     fully-masked row has m = -1e30 and l = S: P is uniform over all
//     S keys (S is the caller's padded length).  No tile is skipped for
//     being fully masked; keys past S are not keys at all (P 0);
//   - dq, dk and dv are written in the inputs' dtype.
#include "attention.cuh"
#include "attention_mma.cuh"
#include "common.cuh"

using namespace attn;

namespace {

// the masked, scaled logit of one (query, key) pair as the reference
// computes it: -1e30 for a masked key
__device__ __forceinline__ float masked_logit(float dot, float scale,
                                              float key_mask) {
  const float x = dot * scale;
  return key_mask > 0.f ? x : NEG_INF;
}

// ---- pass 1: D_i = rowsum(dO * O) --------------------------------------------

constexpr int ROWSUM_NT = 256;

// G = D * sizeof(T) / 16 threads per row, each reading 16 bytes of O
// and of dO; rows are numbered (b * H + h) * S + s.  Writes D_i into
// delta[0] and log2(l_i) (K1's row sum) into delta[1], which the
// tensor-core passes fold into the exponent instead of dividing by l
template <typename T, int D>
__global__ void __launch_bounds__(ROWSUM_NT)
    bwd_rowsum_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      const float* __restrict__ stats,
                      float* __restrict__ delta, int S, int H, long long rows,
                      Strides so, Strides sd) {
  constexpr int V = 16 / (int)sizeof(T), G = D / V;
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "row group");
  const long long r =
      (long long)blockIdx.x * (ROWSUM_NT / G) + threadIdx.x / G;
  const int c = (threadIdx.x % G) * V;
  float acc = 0.f;
  if (r < rows) {
    const int s = (int)(r % S);
    const long long bh = r / S;
    const int h = (int)(bh % H), b = (int)(bh / H);
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * so.b + h * so.h + s * so.s + c);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        dout + b * sd.b + h * sd.h + s * sd.s + c);
    const T* oe = reinterpret_cast<const T*>(&ov);
    const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int i = 0; i < V; ++i) acc = fmaf(to_f(de[i]), to_f(oe[i]), acc);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && threadIdx.x % G == 0) {
    delta[r] = acc;
    delta[rows + r] = log2f(stats[rows + r]);
  }
}

// ---- bf16 passes 2 and 3: tensor cores ---------------------------------------

constexpr int STAGES = 2;

template <int D>
struct MmaShape {
  static constexpr int DW = D < 64 ? D : 64;  // dK/dV columns per warp
  static constexpr int NS = D / DW;           // warps per 16 key rows
  static constexpr int DKDV_NT = 4 * 32 * NS;
  static constexpr int DQ_NT = 128;           // 4 warps x 16 query rows
};

template <int D>
constexpr int dkdv_mma_smem() {  // K, V; per stage Q, dO, m, l, D_i
  return 2 * amma::TILE * D * 2 +
         STAGES * (2 * amma::TILE * D * 2 + 3 * amma::TILE * 4);
}

template <int D>
constexpr int dq_mma_smem() {  // Q, dO; per stage K, V, key mask
  return 2 * amma::TILE * D * 2 +
         STAGES * (2 * amma::TILE * D * 2 + amma::TILE * 4);
}

template <int D>
__global__ void __launch_bounds__(MmaShape<D>::DKDV_NT)
    bwd_dkdv_mma_kernel(const amma::bf16* __restrict__ q,
                        const amma::bf16* __restrict__ k,
                        const amma::bf16* __restrict__ v,
                        const amma::bf16* __restrict__ dout,
                        const float* __restrict__ mask,
                        const float* __restrict__ stats,
                        const float* __restrict__ delta,
                        amma::bf16* __restrict__ dk,
                        amma::bf16* __restrict__ dv, int S, int H,
                        Strides sq, Strides sk, Strides sv, Strides sd,
                        Strides sdk, Strides sdv, float scale) {
  using namespace amma;
  constexpr int T64 = TILE, DW = MmaShape<D>::DW;
  constexpr int NT = MmaShape<D>::DKDV_NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // (64, D)
  bf16* Vs = Ks + T64 * D;                       // (64, D)
  bf16* Qs = Vs + T64 * D;                       // STAGES x (64, D)
  bf16* Ds = Qs + STAGES * T64 * D;              // STAGES x (64, D) dO
  float* Rs = reinterpret_cast<float*>(Ds + STAGES * T64 * D);
  // Rs: STAGES x (m, log2 l, D_i) of 64 queries each

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr0 = 16 * (warp % 4), dc0 = DW * (warp / 4);
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * T64;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* db = dout + b * sd.b + h * sd.h;
  const long long bh = (long long)b * H + h;
  const long long plane = (long long)gridDim.z * H * S;
  const float* row_m = stats + bh * S;
  const float* row_d = delta + bh * S;
  const float* row_l = row_d + plane;   // log2 l

  auto load_q = [&](int stage, int q0) {
    load_tile<D, T64, NT>(Qs + stage * T64 * D, qb, sq.s, q0, S);
    load_tile<D, T64, NT>(Ds + stage * T64 * D, db, sd.s, q0, S);
    float* r = Rs + stage * 3 * T64;
    load_vec<T64, NT>(r, row_m, q0, S);
    load_vec<T64, NT>(r + T64, row_l, q0, S);
    load_vec<T64, NT>(r + 2 * T64, row_d, q0, S);
  };

  load_tile<D, T64, NT>(Ks, k + b * sk.b + h * sk.h, sk.s, k0, S);
  load_tile<D, T64, NT>(Vs, v + b * sv.b + h * sv.h, sv.s, k0, S);
  load_q(0, 0);
  cp_commit();

  // this thread's two key rows: in range, and their mask
  bool key_in[2];
  float key_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kr0 + g + 8 * i;
    key_in[i] = key < S;
    key_m[i] = key_in[i] ? mask[(long long)b * S + key] : 0.f;
  }

  float dk_acc[DW / 8][4], dv_acc[DW / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  const int n_tiles = (S + T64 - 1) / T64;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES, q0 = it * T64;
    if (it + 1 < n_tiles) {
      load_q((it + 1) % STAGES, q0 + T64);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + st * T64 * D;
    const bf16* Dt = Ds + st * T64 * D;
    const float* Rm = Rs + st * 3 * T64;
    const float* Rl = Rm + T64;
    const float* Rd = Rl + T64;

    float pt[8][4], dpt[8][4];   // [key][query] tiles of this warp
    qk_mma<D>(pt, Ks, kr0, Qt);   // S^T = K Q^T
    qk_mma<D>(dpt, Vs, kr0, Dt);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // this thread's query columns 8 j + 2 t and + 1, as pairs
      const int qc = 8 * j + 2 * t;
      const float2 rm = *reinterpret_cast<const float2*>(Rm + qc);
      const float2 rl = *reinterpret_cast<const float2*>(Rl + qc);
      const float2 rd = *reinterpret_cast<const float2*>(Rd + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int odd = e & 1, i = e >> 1;
        float p = 0.f;
        if (key_in[i] && q0 + qc + odd < S)  // exp(x - m) / l
          p = ex2(fmaf(masked_logit(pt[j][e], scale, key_m[i]) -
                           (odd ? rm.y : rm.x),
                       LOG2E, -(odd ? rl.y : rl.x)));
        pt[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - (odd ? rd.y : rd.x));  // dS^T / scale
      }
    }
    pv_mma<D, DW / 8>(dv_acc, pt, Dt, dc0);   // dV += P^T dO
    pv_mma<D, DW / 8>(dk_acc, dpt, Qt, dc0);  // dK += dS^T Q
    __syncthreads();  // this stage is refilled in iteration it + 1
  }
  const float one[2] = {1.f, 1.f}, sc[2] = {scale, scale};
  amma::store_rows<DW / 8>(dk + b * sdk.b + h * sdk.h, sdk.s, dk_acc, sc,
                           k0 + kr0, dc0, S);
  amma::store_rows<DW / 8>(dv + b * sdv.b + h * sdv.h, sdv.s, dv_acc, one,
                           k0 + kr0, dc0, S);
}

template <int D>
__global__ void __launch_bounds__(MmaShape<D>::DQ_NT)
    bwd_dq_mma_kernel(const amma::bf16* __restrict__ q,
                      const amma::bf16* __restrict__ k,
                      const amma::bf16* __restrict__ v,
                      const amma::bf16* __restrict__ dout,
                      const float* __restrict__ mask,
                      const float* __restrict__ stats,
                      const float* __restrict__ delta,
                      amma::bf16* __restrict__ dq, int S, int H, Strides sq,
                      Strides sk, Strides sv, Strides sd, Strides sdq,
                      float scale) {
  using namespace amma;
  constexpr int T64 = TILE, NT = MmaShape<D>::DQ_NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // (64, D)
  bf16* Ds = Qs + T64 * D;                       // (64, D) dO
  bf16* Ks = Ds + T64 * D;                       // STAGES x (64, D)
  bf16* Vs = Ks + STAGES * T64 * D;              // STAGES x (64, D)
  float* Ms = reinterpret_cast<float*>(Vs + STAGES * T64 * D);  // x (64,)

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * T64;
  const int qr0 = 16 * warp;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const float* mb = mask + (long long)b * S;

  auto load_kv = [&](int stage, int k0) {
    load_tile<D, T64, NT>(Ks + stage * T64 * D, kb, sk.s, k0, S);
    load_tile<D, T64, NT>(Vs + stage * T64 * D, vb, sv.s, k0, S);
    load_vec<T64, NT>(Ms + stage * T64, mb, k0, S);
  };

  load_tile<D, T64, NT>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_tile<D, T64, NT>(Ds, dout + b * sd.b + h * sd.h, sd.s, q0, S);
  load_kv(0, 0);
  cp_commit();

  // this thread's two query rows: m, log2 l and D_i
  const long long bh = (long long)b * H + h;
  const long long plane = (long long)gridDim.z * H * S;
  bool row_in[2];
  float m[2], l2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + qr0 + g + 8 * i;
    row_in[i] = row < S;
    m[i] = row_in[i] ? stats[bh * S + row] : 0.f;
    dd[i] = row_in[i] ? delta[bh * S + row] : 0.f;
    l2[i] = row_in[i] ? delta[plane + bh * S + row] : 0.f;
  }

  float dq_acc[D / 8][4];
  zero(dq_acc);

  const int n_tiles = (S + T64 - 1) / T64;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES, k0 = it * T64;
    if (it + 1 < n_tiles) {
      load_kv((it + 1) % STAGES, k0 + T64);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + st * T64 * D;
    const float* Mt = Ms + st * T64;

    float s[8][4], dp[8][4];     // [query][key] tiles of this warp
    qk_mma<D>(s, Qs, qr0, Kt);                  // S = Q K^T
    qk_mma<D>(dp, Ds, qr0, Vs + st * T64 * D);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;  // key columns c and c + 1
      const float2 km = *reinterpret_cast<const float2*>(Mt + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int odd = e & 1, i = e >> 1;
        float p = 0.f;
        if (row_in[i] && k0 + c + odd < S)  // exp(x - m) / l
          p = ex2(fmaf(masked_logit(s[j][e], scale, odd ? km.y : km.x) -
                           m[i],
                       LOG2E, -l2[i]));
        dp[j][e] = p * (dp[j][e] - dd[i]);  // dS / scale
      }
    }
    pv_mma<D, D / 8>(dq_acc, dp, Kt, 0);  // dQ += dS K
    __syncthreads();  // this stage is refilled in iteration it + 1
  }
  const float sc[2] = {scale, scale};
  amma::store_rows<D / 8>(dq + b * sdq.b + h * sdq.h, sdq.s, dq_acc, sc,
                          q0 + qr0, 0, S);
}

// ---- f32 passes 2 and 3: the FMA tile of attention.cuh -----------------------

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

template <int D>
constexpr int dkdv_floats() {
  return (2 * BK + 2 * BQ) * (D + 1) + 2 * BK * 65 + BK + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ mask,
                    const float* __restrict__ stats,
                    const float* __restrict__ delta, T* __restrict__ dk,
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
  const long long bh = (long long)b * H + h;
  const float* row_m = stats + bh * S;
  const float* row_l = row_m + (long long)gridDim.z * H * S;
  const float* row_d = delta + bh * S;

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

template <int D>
constexpr int dq_floats() {
  return (2 * BQ + 2 * BK) * (D + 1) + BQ * 65 + BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ mask,
                  const float* __restrict__ stats,
                  const float* __restrict__ delta, T* __restrict__ dq, int S,
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
  const long long bh = (long long)b * H + h;
  const float* row_m = stats + bh * S;
  const float* row_l = row_m + (long long)gridDim.z * H * S;
  const float* row_d = delta + bh * S;

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

// ---- host side -----------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float *mask, *stats;
  float* delta;
  void *dq, *dk, *dv;
  int B, S, H;
  Strides sq, sk, sv, so, sd, sdq, sdk, sdv;
  float scale;
};

template <typename T, int D>
int launch_rowsum(const Args& a, cudaStream_t stream) {
  constexpr int G = D * (int)sizeof(T) / 16;
  const long long rows = (long long)a.B * a.H * a.S;
  const long long blocks = (rows + ROWSUM_NT / G - 1) / (ROWSUM_NT / G);
  bwd_rowsum_kernel<T, D><<<(unsigned)blocks, ROWSUM_NT, 0, stream>>>(
      (const T*)a.o, (const T*)a.dout, a.stats, a.delta, a.S, a.H, rows,
      a.so, a.sd);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const Args& a, cudaStream_t stream) {
  using amma::bf16;
  using Sh = MmaShape<D>;
  const int dkdv_smem = dkdv_mma_smem<D>(), dq_smem = dq_mma_smem<D>();
  cudaError_t err = allow_smem(bwd_dkdv_mma_kernel<D>, dkdv_smem);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_mma_kernel<D>, dq_smem);
  if (err != cudaSuccess) return (int)err;
  const bf16 *q = (const bf16*)a.q, *k = (const bf16*)a.k;
  const bf16 *v = (const bf16*)a.v, *dout = (const bf16*)a.dout;
  const dim3 grid((a.S + amma::TILE - 1) / amma::TILE, a.H, a.B);
  bwd_dkdv_mma_kernel<D><<<grid, Sh::DKDV_NT, dkdv_smem, stream>>>(
      q, k, v, dout, a.mask, a.stats, a.delta, (bf16*)a.dk, (bf16*)a.dv,
      a.S, a.H, a.sq, a.sk, a.sv, a.sd, a.sdk, a.sdv, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_mma_kernel<D><<<grid, Sh::DQ_NT, dq_smem, stream>>>(
      q, k, v, dout, a.mask, a.stats, a.delta, (bf16*)a.dq, a.S, a.H, a.sq,
      a.sk, a.sv, a.sd, a.sdq, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  const int dkdv_smem = dkdv_floats<D>() * (int)sizeof(float);
  const int dq_smem = dq_floats<D>() * (int)sizeof(float);
  cudaError_t err = allow_smem(bwd_dkdv_kernel<float, D>, dkdv_smem);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_kernel<float, D>, dq_smem);
  if (err != cudaSuccess) return (int)err;
  const float *q = (const float*)a.q, *k = (const float*)a.k;
  const float *v = (const float*)a.v, *dout = (const float*)a.dout;
  const dim3 kgrid((a.S + BK - 1) / BK, a.H, a.B);
  const dim3 qgrid((a.S + BQ - 1) / BQ, a.H, a.B);
  bwd_dkdv_kernel<float, D><<<kgrid, NT, dkdv_smem, stream>>>(
      q, k, v, dout, a.mask, a.stats, a.delta, (float*)a.dk, (float*)a.dv,
      a.S, a.H, a.sq, a.sk, a.sv, a.sd, a.sdk, a.sdv, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_kernel<float, D><<<qgrid, NT, dq_smem, stream>>>(
      q, k, v, dout, a.mask, a.stats, a.delta, (float*)a.dq, a.S, a.H, a.sq,
      a.sk, a.sv, a.sd, a.sdq, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Args& a, bool bf16, cudaStream_t s) {
  const int err = bf16 ? launch_rowsum<amma::bf16, D>(a, s)
                       : launch_rowsum<float, D>(a, s);
  if (err != 0) return err;
  return bf16 ? launch_mma<D>(a, s) : launch_f32<D>(a, s);
}

// every base and row stride a multiple of 16 bytes: cp.async and the
// rowsum's vector loads move 16-byte chunks
bool aligned16(const void* p, const Strides& st, int elt) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
         (st.b * elt) % 16 == 0 && (st.s * elt) % 16 == 0 &&
         (st.h * elt) % 16 == 0;
}

}  // namespace

// q/k/v/o/dout and dq/dk/dv: (B, S, H, D) views with D contiguous,
// element strides given per tensor as (batch, seq, head) triples in
// that order, bases and strides multiples of 16 bytes; f32 (bf16 = 0)
// or bf16 (bf16 = 1), all alike.  mask: (B, S) f32 key validity,
// contiguous.  stats: K1's (2, B, H, S) f32 row max and sum of this
// forward.  delta: (2, B, H, S) f32 scratch.  D is 16, 32, 64 or 128.
// Launches the three passes on `stream`; returns the CUDA error code
// (0 = launched).
extern "C" int sptk_flash_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* mask, const float* stats,
                              float* delta, void* dq, void* dk, void* dv,
                              int B, int S, int H, int D, int bf16,
                              const long long* strides, float scale,
                              void* stream) {
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
               delta,  dq,     dk,     dv,     B,      S,      H,
               take(), take(), take(), take(), take(), take(), take(),
               take(), scale};
  const int elt = bf16 ? 2 : 4;
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  const Strides* strs[8] = {&a.sq, &a.sk, &a.sv, &a.so,
                            &a.sd, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 8; ++i)
    if (!aligned16(ptrs[i], *strs[i], elt))
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
