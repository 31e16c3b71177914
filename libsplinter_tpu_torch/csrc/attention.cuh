// The attention tile shared by K1 (flash_fwd.cu) and K4 (causal_fwd.cu):
// a block of NT = 256 threads owns BQ = 64 query rows, streams K/V in
// BK = 64-row tiles through shared memory, and keeps an online f32
// softmax per row.  Thread (ty, tx) = (t / 16, t % 16) owns query rows
// ty + 16 i (i < 4), logit columns tx + 16 j (j < 4) of each tile and
// output columns tx + 16 j (j < D / 16).  Operands are f32 in shared
// memory (rows padded to D + 1 floats against bank conflicts); the
// products are f32 FMA, not tensor cores.
//
// The kernels differ only in which keys a query sees; each writes the
// finite NEG_INF into masked logits (a row with no visible key then
// averages V uniformly, as the reference kernels do) and -INFINITY
// into keys past the end of K (not keys at all).
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per streamed tile
constexpr int NT = 256;  // 16 x 16 threads

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

struct Strides {  // element strides of a (B, S, H, D) view, D contiguous
  long long b, s, h;
};

// floats of shared memory for Q, K, V and P tiles; `extra` more follow
template <int D>
constexpr int tile_floats(int extra) {
  return (BQ + 2 * BK) * (D + 1) + BQ * (BK + 1) + extra;
}

// rows row0.. of a strided (rows, D) slice into dst (n_rows, D + 1);
// rows at or past `limit` read as 0
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride, int row0,
                                          int n_rows, int limit) {
  for (int e = threadIdx.x; e < n_rows * D; e += NT) {
    const int r = e / D, c = e % D, row = row0 + r;
    dst[r * (D + 1) + c] = row < limit ? to_f(src[row * stride + c]) : 0.f;
  }
}

// online-softmax state of one thread
template <int D>
struct RowState {
  float m[4], l[4], acc[4][D / 16];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;  // so an all-NEG_INF tile counts only until a
      l[i] = 0.f;        // real key arrives: exp(NEG_INF - m) is then 0
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
    }
  }
};

// s[i][j] = Q row (ty + 16 i) . K row (tx + 16 j), unscaled
template <int D>
__device__ __forceinline__ void qk_tile(const float* Qs, const float* Ks,
                                        int ty, int tx, float s[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = Ks[(tx + 16 * j) * LD + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
  }
}

// Fold one tile of masked, scaled logits into the running max/sum and
// rescale the accumulator; probabilities go to Ps rounded to T (the
// reference rounds them to V's dtype before P.V).
template <typename T, int D>
__device__ __forceinline__ void softmax_tile(const float s[4][4], float* Ps,
                                             RowState<D>& st, int ty,
                                             int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mnew = fmaxf(st.m[i], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = expf(s[i][j] - mnew);
      sum += p;
      Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = to_f(from_f<T>(p));
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float alpha = expf(st.m[i] - mnew);
    st.l[i] = st.l[i] * alpha + sum;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) st.acc[i][j] *= alpha;
    st.m[i] = mnew;
  }
}

// acc += P (BQ, BK) . V (BK, D)
template <int D>
__device__ __forceinline__ void pv_tile(const float* Ps, const float* Vs,
                                        RowState<D>& st, int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll 8
  for (int c = 0; c < BK; ++c) {
    float p[4], vv[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) vv[j] = Vs[c * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        st.acc[i][j] = fmaf(p[i], vv[j], st.acc[i][j]);
  }
}

}  // namespace attn
