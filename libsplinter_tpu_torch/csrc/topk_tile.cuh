// The register-blocked f32 score tile of the fused top-k kernel (K2).
//
// One block of NT = 256 threads scores a tile of TN lane rows against
// TQ queries, walking d in DK-deep chunks (whole 128-byte lines of each
// row; the tile shapes are below).  Each chunk of rows and queries
// arrives by cp.async into a 2-stage ring in shared memory, so the
// copy of the next chunk runs while this one is multiplied; the ring
// runs on across row tiles, so a tile's epilogue (norms, scores,
// selection) overlaps the next tile's first load.
//
//   - Thread t owns RN rows (rg + RG i) and QN queries (qg + QG j),
//     qg = t % QG, rg = t / QG: an RN x QN block of f32 accumulators.
//     Per 4-deep step it reads its rows and queries as float4s
//     (RN + QN 16-byte shared loads for 4 RN QN FMAs).
//   - Rows and queries sit in shared memory row-major with LD = DK + 4
//     floats a row (LD = 4 mod 32): eight consecutive rows fall on eight
//     distinct 16-byte bank groups, so the float4 reads of a quarter
//     warp (eight rows or eight queries, or one broadcast) never
//     conflict, and every row start stays 16-byte aligned for cp.async.
//   - A lane whose rows are not 16-byte aligned (d % 4 != 0, or a base
//     off 16 bytes) loads through 4-byte cp.async copies instead, in
//     the same kernel; columns past d are zero-filled either way.
//   - Row norms come out of the same pass: each thread sums the
//     squares of its own rows from the operands it already holds, in
//     d order (no shared-memory pass of their own).
//
// Plain f32 FMA: the exact path must not use TF32.  With BF16 set,
// both operands of every product are rounded to bfloat16 in registers
// (f32 sums), the reference's mxu_bf16 arithmetic; the norms stay f32.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tk {

constexpr float NEG_INF = -1e30f;  // the reference's finite mask value
constexpr int NT = 256;            // threads per block
constexpr int STAGES = 2;          // ring depth: chunk s + 1 loads while
                                   // chunk s is multiplied

// The shape of each query tile: TN rows a tile, QN queries a thread,
// DK floats of depth a staged chunk (whole 128-byte lines of each
// row).  The narrow tiles (lane-read bound) give each thread one row
// (8 queries) or four (32); the 32-query one stages 32-deep chunks so
// two blocks share an SM.  The wide one gives each thread 8 rows x 16
// queries: 128 accumulators are the most FMAs per shared load that
// fit the registers.
template <int TQ> struct TileShape;
template <> struct TileShape<8> {
  static constexpr int TN = 256, QN = 8, DK = 64;
};
template <> struct TileShape<32> {
  static constexpr int TN = 256, QN = 8, DK = 32;
};
template <> struct TileShape<256> {
  static constexpr int TN = 128, QN = 16, DK = 32;
};

template <int TQ> struct Tile {
  static constexpr int TN = TileShape<TQ>::TN;
  static constexpr int QN = TileShape<TQ>::QN;
  static constexpr int DK = TileShape<TQ>::DK;
  static constexpr int LD = DK + 4;         // floats a staged row
  static constexpr int QG = TQ / QN;        // query groups
  static constexpr int RG = NT / QG;        // row groups
  static constexpr int RN = TN / RG;        // rows per thread
  static constexpr int STAGE = (TN + TQ) * LD;  // floats per stage
  static_assert(RN >= 1 && TN % RG == 0 && RN * QN <= 128, "tile");
  static_assert(DK % 32 == 0, "depth: whole 128-byte lines");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

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

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float4 bf16_round(float4 x) {
  return make_float4(bf16_round(x.x), bf16_round(x.y), bf16_round(x.z),
                     bf16_round(x.w));
}

// rows row0.. (NROWS of them) of a (limit, d) f32 matrix, columns
// d0..d0 + DK, into dst (NROWS, DK + 4); rows at or past `limit` and
// columns at or past d are zero-filled.  vec16: 16-byte copies (d % 4
// == 0 and a 16-byte aligned base), else 4-byte ones.
template <int NROWS, int DK>
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           long long row0, long long limit,
                                           int d, int d0, bool vec16) {
  constexpr int CPR = DK / 4, LD = DK + 4;  // 16-byte pieces per row
  for (int e = threadIdx.x; e < NROWS * CPR; e += NT) {
    const int r = e / CPR, c = e % CPR, col = d0 + 4 * c;
    const long long row = row0 + r;
    const bool in = row < limit;
    const float* s = src + (in ? row : 0) * (long long)d;
    float* o = dst + r * LD + 4 * c;
    if (vec16) {
      const bool ok = in && col < d;
      cp_async16(o, s + (ok ? col : 0), ok);
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const bool ok = in && col + x < d;
        cp_async4(o + x, s + (ok ? col + x : 0), ok);
      }
    }
  }
}

// acc[i][j] += row (rg + RG i) . query (qg + QG j) over one staged
// chunk, and nrm[i] += the squares of row (rg + RG i): the rows are in
// registers already, so the norms cost 4 RN FMAs a step and no shared
// load (the threads of one row group each sum them; their sums are
// equal); vs/qs: the chunk's rows and queries, (TN, LD) and (TQ, LD)
template <int TQ, bool BF16>
__device__ __forceinline__ void chunk_mma(
    const float* __restrict__ vs, const float* __restrict__ qs, int rg,
    int qg, float (&acc)[Tile<TQ>::RN][Tile<TQ>::QN],
    float (&nrm)[Tile<TQ>::RN]) {
  using G = Tile<TQ>;
#pragma unroll
  for (int c = 0; c < G::DK; c += 4) {
    float4 a[G::RN];
#pragma unroll
    for (int i = 0; i < G::RN; ++i) {
      a[i] = *reinterpret_cast<const float4*>(
          vs + (rg + G::RG * i) * G::LD + c);
      nrm[i] = fmaf(a[i].x, a[i].x, nrm[i]);
      nrm[i] = fmaf(a[i].y, a[i].y, nrm[i]);
      nrm[i] = fmaf(a[i].z, a[i].z, nrm[i]);
      nrm[i] = fmaf(a[i].w, a[i].w, nrm[i]);
      if (BF16) a[i] = bf16_round(a[i]);
    }
#pragma unroll
    for (int j = 0; j < G::QN; ++j) {
      float4 b = *reinterpret_cast<const float4*>(
          qs + (qg + G::QG * j) * G::LD + c);
      if (BF16) b = bf16_round(b);
#pragma unroll
      for (int i = 0; i < G::RN; ++i) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b.x, s);
        s = fmaf(a[i].y, b.y, s);
        s = fmaf(a[i].z, b.z, s);
        s = fmaf(a[i].w, b.w, s);
        acc[i][j] = s;
      }
    }
  }
}

}  // namespace tk
