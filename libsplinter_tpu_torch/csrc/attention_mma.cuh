// The tensor-core attention tile shared by K1 (flash_fwd.cu) and K6
// (flash_bwd.cu) for bf16 inputs.
//
//   - Operands stay bf16 in shared memory, in (rows, D) tiles whose
//     16-byte chunks are XOR-swizzled by row (`swz`), so that the eight
//     row addresses of one `ldmatrix` phase (eight rows, one chunk
//     column) fall on eight distinct bank groups, with or without
//     `.trans`.
//   - Products are `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`:
//     bf16 inputs, f32 sums.  Each warp owns 16 rows of the output
//     tile; a (16, 64) logit tile is 8 n8 tiles of 4 f32 per thread.
//   - Tiles arrive by 16-byte `cp.async` copies (`load_tile`) into a
//     ring of stages in shared memory, so the next tile loads while
//     this one computes; rows past the end are zero-filled through the
//     copy's src-size operand.
//   - A probability tile in the accumulator layout is rounded to bf16
//     pairs in registers and reused as the A operand of the next
//     product (`pv_mma`): it never goes through shared memory.
//
// Accumulator layout (PTX ISA, m16n8k16): thread lane = 4 g + t holds
// c[e] at row g + 8 (e >> 1), column 2 t + (e & 1) of its n8 tile.  A
// row's values live in the 4 threads of a quad (`quad_max`, `quad_sum`).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention.cuh"

namespace amma {

using bf16 = __nv_bfloat16;
using attn::NEG_INF;
using attn::Strides;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILE = 64;  // rows of a streamed tile, keys or queries

// element offset of 16-byte chunk c of row r in a swizzled (rows, D)
// bf16 tile: the chunk index is XORed with a function of the row that
// takes 8 distinct values mod 128 bytes over any 8 consecutive rows
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CPR = D / 8;  // chunks per row
  int f;
  if constexpr (CPR >= 8) {
    f = r & 7;
  } else {
    f = (r / (8 / CPR)) & (CPR - 1);
  }
  return r * D + ((c ^ f) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows row0.. of a strided (rows, D) bf16 slice into a swizzled
// (NROWS, D) tile; rows at or past `limit` are zero-filled
template <int D, int NROWS, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int limit) {
  constexpr int CPR = D / 8;
  for (int e = threadIdx.x; e < NROWS * CPR; e += NT) {
    const int r = e / CPR, c = e % CPR, row = row0 + r;
    const bool ok = row < limit;
    cp_async16(dst + swz<D>(r, c), src + (ok ? row : 0) * stride + c * 8,
               ok);
  }
}

// n f32 values src[i0..] into dst[0..n); those at or past `limit` are 0
template <int N, int NT>
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int i0, int limit) {
  for (int e = threadIdx.x; e < N; e += NT) {
    const bool ok = i0 + e < limit;
    cp_async4(dst + e, src + (ok ? i0 + e : 0), ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A fragment: rows r0..r0+15, columns k0..k0+15 of a swizzled tile
template <int D>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + swz<D>(r0 + (lane & 15), (k0 >> 3) + (lane >> 4)));
}

// B fragments of the n8 tiles n0 and n0 + 8 at depth k0..k0+15, from a
// tile stored [n][k] (K for Q.K^T): b[0..1] tile n0, b[2..3] n0 + 8
template <int D>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* tile,
                                       int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                           (k0 >> 3) + ((lane >> 3) & 1)));
}

// the same from a tile stored [k][n] (V for P.V), through .trans
template <int D>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const bf16* tile,
                                        int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, tile + swz<D>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                             (n0 >> 3) + (lane >> 4)));
}

__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the SFU (relative error ~2^-22; -inf gives +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// s (16 x 64) = A . B^T over the full depth D: A rows r0..r0+15 of a
// swizzled (rows, D) tile, read one 16-column step at a time; B rows
// 0..63 of a swizzled (64, D) tile
template <int D>
__device__ __forceinline__ void qk_mma(float (&s)[8][4], const bf16* A,
                                       int r0, const bf16* B) {
  zero(s);
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    frag_a<D>(a, A, r0, 16 * kc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[4];
      frag_b<D>(b, B, 16 * j, 16 * kc);
      mma16816(s[2 * j], a, b[0], b[1]);
      mma16816(s[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x 8 NC, columns c0..) += bf16(P) (16 x 64, accumulator layout)
// . X (rows 0..63, columns c0..c0 + 8 NC of a swizzled (64, D) tile)
template <int D, int NC>
__device__ __forceinline__ void pv_mma(float (&acc)[NC][4],
                                       const float (&p)[8][4], const bf16* X,
                                       int c0) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint32_t a[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                           pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                           pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                           pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int dn = 0; dn < NC / 2; ++dn) {
      uint32_t b[4];
      frag_bt<D>(b, X, 16 * kc, c0 + 16 * dn);
      mma16816(acc[2 * dn], a, b[0], b[1]);
      mma16816(acc[2 * dn + 1], a, b[2], b[3]);
    }
  }
}

// rows row0 + g, row0 + g + 8 of acc (16 x 8 NC, columns c0..) * mul[i]
// to a strided (rows, D) bf16 slice; rows at or past `limit` skipped
template <int NC>
__device__ __forceinline__ void store_rows(bf16* dst, long long stride,
                                           const float (&acc)[NC][4],
                                           const float (&mul)[2], int row0,
                                           int c0, int limit) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= limit) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + row * stride + c0 + 8 * j +
                                         2 * t) =
          __floats2bfloat162_rn(acc[j][2 * i] * mul[i],
                                acc[j][2 * i + 1] * mul[i]);
  }
}

}  // namespace amma
