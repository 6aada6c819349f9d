// Shared pieces of the flash-attention kernels (csrc/flash_attention_fwd.cu
// and csrc/flash_attention_bwd.cu): the swizzled shared-memory tiles, the
// cp.async copies that fill them, and the 3xTF32 and bf16 mma.sync products
// that read them.
//
// Products.  mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, made
// float32-accurate by 3xTF32: each operand x is split in registers, as it
// is read from shared memory (or as a score tile is formed), into big = x
// rounded to TF32 and small = x - big, and acc += a_small b_big + a_big
// b_small + a_big b_big (small terms first, a_small b_small dropped), each
// pass issued over all of a warp's independent tiles before the next.
// One TF32 pass misses the kernels' 2e-5 tolerance by 10-30x through
// exp(·) (tests/test_torch_flash_attention.py and
// tests/test_torch_flash_backward.py emulate both).  The tensor core's
// float32 accumulation is not rounded to nearest (csrc/vocab_ce.cu's
// probe), so no tensor-core accumulator holds more than one tile's
// product: a depth of D for a score tile, one streamed tile's rows for a
// tile_product; each partial sum is added to float32 registers with an
// ordinary addition.
//
// Fragments.  The m16n8k8 .tf32 fragments (g = lane >> 2, t = lane & 3,
// as vocab_ce.cu checked them on the card): A a0 (g, t), a1 (g+8, t), a2
// (g, t+4), a3 (g+8, t+4); B b0 (k = t, n = g), b1 (k = t+4, n = g); C
// c0, c1 (g, 2t / 2t+1), c2, c3 (g+8, 2t / 2t+1).  A score tile leaves
// tile_scores as C fragments and enters tile_product as A fragments
// without any exchange between lanes: the product's k index is permuted
// within each 8-step (slot t is row 2t, slot t+4 row 2t+1), so a0..a3 are
// c0, c2, c1, c3 of the same lane, and the B rows are read as 2t and
// 2t+1.
//
// Tiles.  Every tile is [row][D] in shared memory with its column index
// XOR-swizzled by the row (row bit 0 to column bit 2, row bits 1-2 to
// column bits 3-4; D >= 32): tile_scores reads its operands as 8 rows x
// 4 columns, tile_product reads rows 2t or 2t+1 x 8 columns, and both hit
// 32 distinct banks, with 16-byte chunks kept whole.  The copies are 16
// bytes, so every row must start 16-byte aligned (rows_aligned); rows at
// or past a limit are zero-filled, so undefined memory never meets an
// accumulator.
//
// bf16 operands.  The bf16 paths keep bf16 tiles and multiply on the bf16
// tensor cores: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (mma_bf16), whose fragments hold two bf16 values a register, the lower
// index in the low half (g = lane >> 2, t = lane & 3): A a0 (g,
// 2t..2t+1), a1 (g+8, 2t..2t+1), a2 (g, 2t+8..2t+9), a3 (g+8,
// 2t+8..2t+9); B b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g); C
// as for the m16n8k8 product.  So the C fragments of two neighbouring
// 8-column score tiles, rounded to bf16 in pairs (pack_bf16), are the A
// fragment of a 16-deep product as they stand.  bf16 tiles are [row][D]
// with 16-byte chunks (8 values) XOR-swizzled by the row (at16): a 32-bit
// fragment load of 8 rows x 4 columns and an ldmatrix of 8 rows both hit
// distinct banks at D >= 64 (two rows a bank at D = 32).  From such a
// tile ldmatrix_x4 gives the A fragment of 16 of its rows, or the B
// fragments of a product by its transpose (8 rows a column of B), and
// ldmatrix_x4_trans the B fragments of a product by the tile itself.  A
// product of bf16 values is exact, so a bf16 operand staged as it is
// takes one pass (tile_scores_bf16).  A float32 operand (the backward's
// p and ds) rounded to bf16 would carry 2^-9 relative error into each
// term; split into hi = bf16(x) and lo = bf16(x - hi) (split_bf16) it
// keeps 16 bits, and the product takes two passes, lo first
// (tile_product_bf16): tests/test_torch_flash_backward.py emulates both
// against chip_smoke.py's bf16 gradient gate.  The one-tile-an-
// accumulator rule holds here too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

// Element (r, c) of a swizzled [rows][D] tile.
template <int D>
__device__ __forceinline__ int at(int r, int c) {
  return r * D + (c ^ ((((r >> 1) & 3) << 3) | ((r & 1) << 2)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (cp.async.cg, around L1), or zeros when !ok
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes, or zeros when !ok
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows [row0, row0 + n_rows) of one head of a strided float32
// operand into a swizzled [n_rows][D] tile through cp.async; rows at or
// past `limit` become zeros.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int64_t row_stride, int row0,
                                           int limit, int n_rows,
                                           int n_threads) {
  constexpr int kChunks = D / 4;
  for (int c = threadIdx.x; c < n_rows * kChunks; c += n_threads) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    const int row = row0 + r;
    const bool ok = row < limit;
    float* d = dst + at<D>(r, col);
    const float* s = src + static_cast<int64_t>(row) * row_stride + col;
    cp16(d, ok ? s : src, ok);
  }
}

// Element (r, c) of a swizzled bf16 [rows][D] tile: 16-byte chunks of 8
// values, the chunk index XOR-ed with the row's low bits.
template <int D>
__device__ __forceinline__ int at16(int r, int c) {
  constexpr int kMask = D / 8 < 8 ? D / 8 - 1 : 7;
  return r * D + ((((c >> 3) ^ (r & kMask)) << 3) | (c & 7));
}

// Copy rows [row0, row0 + n_rows) of one head of a strided bf16 operand
// into a swizzled bf16 [n_rows][D] tile through cp.async; rows at or
// past `limit` become zeros.
template <int D>
__device__ __forceinline__ void stage_rows16(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             int64_t row_stride, int row0,
                                             int limit, int n_rows,
                                             int n_threads) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < n_rows * kChunks; c += n_threads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int row = row0 + r;
    const bool ok = row < limit;
    const __nv_bfloat16* s =
        src + static_cast<int64_t>(row) * row_stride + col;
    cp16(dst + at16<D>(r, col), ok ? s : src, ok);
  }
}

// Two bf16 values of a tile as one fragment register (c even)
template <int D>
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* tile,
                                            int r, int c) {
  return *reinterpret_cast<const uint32_t*>(tile + at16<D>(r, c));
}

// lo and hi rounded to nearest even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8 x 8 bf16 matrices, transposed: lanes 8i..8i+7 give the row
// addresses of matrix i, and register i receives, in each lane (g, t),
// rows 2t and 2t+1 of column g of matrix i (a B fragment half).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// Four 8 x 8 bf16 matrices: lanes 8i..8i+7 give the row addresses of
// matrix i, and register i receives, in each lane (g, t), columns 2t and
// 2t+1 of row g of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// c += a b over one m16n8k16 tile, bf16 operands, float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8*NT) = a[m0:m0+16] . b[0:8*NT]^T over the depth D, bf16
// operands, one pass: a warp's rows of a score tile; a and b are
// swizzled bf16 [rows][D] tiles.  A fragments by ldmatrix_x4 of a's 16
// rows, B fragments by ldmatrix_x4 of 16 of b's rows (two n-tiles a
// call).  One accumulator per tile over a depth of D.
template <int D, int NT>
__device__ __forceinline__ void tile_scores_bf16(float (&c)[NT][4],
                                                 const __nv_bfloat16* a,
                                                 int m0,
                                                 const __nv_bfloat16* b,
                                                 int lane) {
  static_assert(NT % 2 == 0, "n-tiles in pairs");
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[j][r] = 0.f;
  const int a_row = m0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t af[4];
    ldmatrix_x4(af, a + at16<D>(a_row, kk + a_col));
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + at16<D>(16 * jp + b_row, kk + b_col));
      mma_bf16(c[2 * jp], af, bf[0], bf[1]);
      mma_bf16(c[2 * jp + 1], af, bf[2], bf[3]);
    }
  }
}

// The C fragments of 16 x 16*KS float32 values (2*KS score tiles) as the
// A fragments of a 16*KS-deep product, split x = hi + lo: hi = x rounded
// to nearest even bf16, lo = x - hi (exact in float32) rounded the same.
template <int KS>
__device__ __forceinline__ void split_bf16(const float (&c)[2 * KS][4],
                                           uint32_t (&hi)[KS][4],
                                           uint32_t (&lo)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* x = &c[2 * ks + (i >> 1)][2 * (i & 1)];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[0], x[1]);
      const float2 hf = __bfloat1622float2(h);
      const __nv_bfloat162 l = __floats2bfloat162_rn(x[0] - hf.x,
                                                     x[1] - hf.y);
      hi[ks][i] = *reinterpret_cast<const uint32_t*>(&h);
      lo[ks][i] = *reinterpret_cast<const uint32_t*>(&l);
    }
}

// acc (16 x NC) += (hi + lo) (16 x 16*KS, A fragments from split_bf16)
// . b[0:16*KS, c0:c0+NC] (a swizzled bf16 [row][D] tile, B fragments by
// ldmatrix_x4_trans, two n-tiles a call): the lo pass, then the hi pass.
// Each group of G columns sums the 16*KS rows in its own accumulators,
// then adds them to acc in float32.
template <int D, int KS, int NC, int G>
__device__ __forceinline__ void tile_product_bf16(
    float (&acc)[NC / 8][4], const uint32_t (&hi)[KS][4],
    const uint32_t (&lo)[KS][4], const __nv_bfloat16* b, int c0,
    int lane) {
  static_assert(NC % G == 0 && G % 16 == 0, "column groups of n-tile pairs");
  const int b_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const int b_col = c0 + (lane >> 4) * 8;
#pragma unroll
  for (int ng = 0; ng < NC / G; ++ng) {
    float part[G / 8][4];
#pragma unroll
    for (int nn = 0; nn < G / 8; ++nn)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[nn][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bf[G / 16][4];
#pragma unroll
      for (int np = 0; np < G / 16; ++np)
        ldmatrix_x4_trans(bf[np], b + at16<D>(16 * ks + b_row,
                                              b_col + ng * G + 16 * np));
#pragma unroll
      for (int np = 0; np < G / 16; ++np) {
        mma_bf16(part[2 * np], lo[ks], bf[np][0], bf[np][1]);
        mma_bf16(part[2 * np + 1], lo[ks], bf[np][2], bf[np][3]);
      }
#pragma unroll
      for (int np = 0; np < G / 16; ++np) {
        mma_bf16(part[2 * np], hi[ks], bf[np][0], bf[np][1]);
        mma_bf16(part[2 * np + 1], hi[ks], bf[np][2], bf[np][3]);
      }
    }
#pragma unroll
    for (int nn = 0; nn < G / 8; ++nn)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[ng * G / 8 + nn][r] += part[nn][r];
  }
}

// acc + sum of a[i] * b[i] over the 8 bf16 values of a 16-byte chunk of
// two tiles, widened exactly, float32 FMAs in column order
__device__ __forceinline__ float dot8(const __nv_bfloat16* a,
                                     const __nv_bfloat16* b, float acc) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(xs[i] << 16), __uint_as_float(ys[i] << 16),
               acc);
    acc = fmaf(__uint_as_float(xs[i] & 0xffff0000u),
               __uint_as_float(ys[i] & 0xffff0000u), acc);
  }
  return acc;
}

// Copy n floats src[i0 + i] (i0 + i < limit) into dst, zeros past `limit`
// or when src is NULL; threads [t0, t0 + n) issue them.  `any` is some
// valid global address for the copies that read nothing.
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          int i0, int limit, int n, int t0,
                                          const float* any) {
  const int i = threadIdx.x - t0;
  if (i < 0 || i >= n) return;
  const bool ok = src != nullptr && i0 + i < limit;
  cp4(dst + i, ok ? src + i0 + i : any, ok);
}

// x = big + small: big is x rounded to nearest (ties away from zero) at
// TF32's 10 mantissa bits, as cvt.rna.tf32.f32 rounds, with the low 13
// bits clear; small = x - big is exact in float32, and the tensor core
// reads its top 19 bits.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a b over one m16n8k8 tile, TF32 operands, float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c (16 x 8*NT) = own[m0:m0+16] . str[0:8*NT]^T over the depth D: the
// warp's rows of a score tile, NT m16n8 tiles; own and str are swizzled
// [rows][D] tiles.  One accumulator per tile over a depth of D.
template <int D, int NT>
__device__ __forceinline__ void tile_scores(float (&c)[NT][4],
                                            const float* own, int m0,
                                            const float* str, int gq,
                                            int tq) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[j][r] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 8) {
    uint32_t ab[4], as[4];
    split(own[at<D>(m0 + gq, kk + tq)], ab[0], as[0]);
    split(own[at<D>(m0 + gq + 8, kk + tq)], ab[1], as[1]);
    split(own[at<D>(m0 + gq, kk + tq + 4)], ab[2], as[2]);
    split(own[at<D>(m0 + gq + 8, kk + tq + 4)], ab[3], as[3]);
    uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split(str[at<D>(8 * j + gq, kk + tq)], bb[j][0], bs[j][0]);
      split(str[at<D>(8 * j + gq, kk + tq + 4)], bb[j][1], bs[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(c[j], as, bb[j]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(c[j], ab, bs[j]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(c[j], ab, bb[j]);
  }
}

// acc (16 x NC) += a (16 x 8*KT, C fragments of a score tile) .
// str[0:8*KT, c0:c0+NC] (a swizzled [row][D] tile).  The k index is
// permuted within each 8-step (slot t = row 2t, slot t+4 = row 2t+1), so
// a's C fragment is the A fragment as it stands.  Each group of 4 n-tiles
// sums the 8*KT rows in its own accumulators, then adds them to acc in
// float32.
template <int D, int KT, int NC>
__device__ __forceinline__ void tile_product(float (&acc)[NC / 8][4],
                                             const float (&a)[KT][4],
                                             const float* str, int c0,
                                             int gq, int tq) {
  static_assert(NC % 32 == 0, "column groups of 4 n-tiles");
#pragma unroll
  for (int ng = 0; ng < NC / 32; ++ng) {
    float part[4][4];
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[nn][r] = 0.f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      uint32_t ab[4], as[4];
      split(a[j][0], ab[0], as[0]);
      split(a[j][2], ab[1], as[1]);
      split(a[j][1], ab[2], as[2]);
      split(a[j][3], ab[3], as[3]);
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const int col = c0 + ng * 32 + nn * 8 + gq;
        split(str[at<D>(8 * j + 2 * tq, col)], bb[nn][0], bs[nn][0]);
        split(str[at<D>(8 * j + 2 * tq + 1, col)], bb[nn][1], bs[nn][1]);
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) mma_tf32(part[nn], as, bb[nn]);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) mma_tf32(part[nn], ab, bs[nn]);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) mma_tf32(part[nn], ab, bb[nn]);
    }
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[ng * 4 + nn][r] += part[nn][r];
  }
}

// Write a warp's 16 x NC accumulator rows, row i times mul[i >= 8], to
// rows [row0, row0 + 16) and columns [c0, c0 + NC) of a strided float32
// output, the rows before `limit`.
template <int NC>
__device__ __forceinline__ void store_rows(float* dst, int64_t row_stride,
                                           const float (&acc)[NC / 8][4],
                                           const float (&mul)[2], int row0,
                                           int c0, int limit, int gq,
                                           int tq) {
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + gq + 8 * (r >> 1);
      if (row < limit)
        dst[static_cast<int64_t>(row) * row_stride + c0 + nt * 8 + 2 * tq +
            (r & 1)] = acc[nt][r] * mul[r >> 1];
    }
}

// The same into a bf16 output, each value rounded to nearest even once,
// two neighbouring columns a 32-bit store (row strides even, the output
// 4-byte aligned).
template <int NC>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           int64_t row_stride,
                                           const float (&acc)[NC / 8][4],
                                           float mul, int row0, int c0,
                                           int limit, int gq, int tq) {
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + gq + 8 * i;
      if (row < limit)
        *reinterpret_cast<uint32_t*>(
            dst + static_cast<int64_t>(row) * row_stride + c0 + nt * 8 +
            2 * tq) = pack_bf16(acc[nt][2 * i] * mul,
                                acc[nt][2 * i + 1] * mul);
    }
}

// The 16-byte copies need every row of an operand to start 16-byte
// aligned: its data pointer and its batch, head and row strides (in
// elements of `elem` bytes: multiples of 4 floats or 8 bf16 values).
inline bool rows_aligned(const void* const* ptrs, int n_ptrs,
                         const int64_t* strides, int n_strides,
                         int elem = 4) {
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < n_strides; ++i)
    if (strides[i] * elem % 16 != 0) return false;
  return true;
}

}  // namespace flash
