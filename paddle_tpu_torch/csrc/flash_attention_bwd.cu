// Flash-attention backward kernels for Hopper (sm_90a): dK/dV (+ the key
// bias gradient) and dQ, on the tensor cores.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py
// _bwd_dkv_kernel (:402, called at :611) and _bwd_dq_kernel (:458, called
// at :639), the custom-VJP backward of pallas_flash_attention.  Given the
// forward's O and per-row logsumexp, and the output cotangent dO (plus an
// optional lse cotangent dlse), they recompute the probabilities instead
// of reading a (Tq, Tk) matrix from device memory:
//
//   s  = scale * q.k + bias_k          p  = exp(s - lse)   (0 where masked)
//   dp = dO.v                          ds = p * (dp - delta)
//   delta = rowsum(dO * O) - dlse
//   dV = sum_q p dO     dK = scale * sum_q ds q     dbias_k = sum_q ds
//   dQ = scale * sum_k ds k
//
// Layouts.  Every operand comes with its own batch, head and row strides
// in elements (the column stride is 1), so the head-grouped "nthd"
// (N, T, H*D) layout, the "nhtd" (N, H, T, D) layout, and a transposed
// view of either, run without a copy.  The key-padding bias is (N, Tk),
// one row per batch element.  lse and dlse are (N*H, Tq) f32; the bias
// gradient is written per (batch*head, key) and summed over heads by the
// caller, as the reference sums it outside its kernel.
//
// What bounds them on the H100: operations.  At the training shape
// N=64, H=8, T=256, D=64 (f32) dK/dV does 8*D flops of matrix products
// per visible (q, k) pair and dQ 6*D: 12.9 and 9.7 GFLOP for the mean of
// the causal and the non-causal case, 0.19 and 0.14 ms at the float32
// CUDA-core peak of 67 TFLOP/s, against ~0.07 and ~0.06 ms for their
// 236 and 202 MB at 3.35 TB/s.  So both run their four products each on
// the tensor cores, through mma.sync.aligned.m16n8k8.row.col.f32.tf32.
// tf32.f32, made float32-accurate by 3xTF32 as csrc/vocab_ce.cu's
// backward is: each operand x is split in registers, as it is read from
// shared memory (p and ds as they are formed), into big = x rounded to
// TF32 and small = x - big, and acc += a_small b_big + a_big b_small +
// a_big b_big (small terms first, a_small b_small dropped), each pass
// issued over all of a warp's independent tiles before the next.  The
// least time is then the larger of the bytes and 3 x the product flops
// at the 495 TFLOP/s TF32 peak (0.078 and 0.059 ms for the products
// alone), which only wgmma reaches.  One TF32 pass would
// miss chip_smoke's 2e-5 by 10-30x through exp(s - lse)
// (tests/test_torch_flash_backward.py emulates both).  The tensor core's
// float32 accumulation is not rounded to nearest (vocab_ce.cu's probe),
// so no tensor-core accumulator holds more than one tile's product (a
// depth of D for s and dp, 64 rows for dV, dK and dQ); each partial sum
// is added to float32 registers with an ordinary addition.
//
// Design.  Warps own 16 rows each; tiles of the streamed operand are 64
// rows.  Per warp, every step is a 16 x 64 score tile and a 16 x D
// product:
//  - dK/dV: one block per (128-key tile, batch*head), 8 warps, K and V
//    resident in shared memory.  The block walks the q tiles from the
//    first one not wholly above the causal diagonal, and per tile forms
//    the scores transposed, so its own keys are the M rows:
//      s^T = K Q^T, p^T (masked), dp^T = V dO^T, ds^T = p^T (dp^T - delta)
//      dV += p^T dO,  dK += ds^T Q,  dbias_k += rowsum(ds^T)
//    and scales dK once at the end.  delta is formed per staged q tile
//    from its dO and O rows (4 threads a row, float32 FMA).  128 keys a
//    block, not 64: two 64-key blocks of 4 warps would each hold K, V
//    and two stages of Q, dO and O (130 KB at D = 64), one block an SM;
//    one 128-key block holds 161 KB for 8 warps and stages each q tile
//    once for twice the keys.
//  - dQ: one block per (64-query tile, batch*head), 4 warps, its Q and
//    dO rows resident; delta is formed once from the O tile; the block
//    walks the K/V tiles up to the causal diagonal:
//      s = Q K^T, p, dp = dO V^T, ds = p (dp - delta),  dQ += ds K
//    and scales dQ once at the end.  97 KB a block: two blocks an SM.
//  Registers (ptxas -v, D = 64): dQ 241 a thread, so two blocks fit;
//  dK/dV holds dK, dV, p and ds (128 floats) across a q tile and takes
//  all 255 with a few words spilled.
//  The m16n8k8 .tf32 fragments (g = lane >> 2, t = lane & 3, as
//  vocab_ce.cu checked them on the card): A a0 (g, t), a1 (g+8, t),
//  a2 (g, t+4), a3 (g+8, t+4); B b0 (k = t, n = g), b1 (k = t+4, n = g);
//  C c0, c1 (g, 2t / 2t+1), c2, c3 (g+8, 2t / 2t+1).  p and ds come out
//  as C fragments and feed the next product as A fragments without any
//  exchange between lanes: the product's k index is permuted within
//  each 8-step (slot t is row 2t, slot t+4 row 2t+1), so a0..a3 are c0,
//  c2, c1, c3 of the same lane, and the B rows are read as 2t and 2t+1.
//  Every tile is [row][D] in shared memory with its column index
//  XOR-swizzled by the row (row bit 0 to column bit 2, row bits 1-2 to
//  column bits 3-4): the score products read Q, dO, K and V as
//  8 rows x 4 columns, the dV/dK/dQ products read dO, Q and K as rows
//  2t or 2t+1 x 8 columns, and both hit 32 distinct banks, with 16-byte
//  chunks kept whole.
//  Copies: cp.async into a double-buffered ring of the streamed tiles (Q,
//  dO, O, lse and dlse for dK/dV; K, V and the bias row for dQ), so the
//  next tile lands while this one computes.  The copies are 16 bytes, so
//  every row of q, k, v, O and dO must start 16-byte aligned: the entry
//  points return cudaErrorMisalignedAddress otherwise, and the wrapper
//  (ops/kernels/flash_attention.py) hands them a contiguous copy of any
//  operand that is not.  Rows past Tq or Tk are zero-filled by the
//  copies and their pairs masked, so undefined memory never meets an
//  accumulator.  Each block owns its output rows over the whole sum: no
//  atomics, and two runs give the same bits.
//
// Masking matches the TPU kernel: a pair is visible when the key is
// before Tk, the query before Tq, and, under causal, q_off + q_pos >=
// k_off + k_pos.  p and ds are exactly 0 elsewhere.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;           // rows of a streamed tile
constexpr int kDkvWarps = 8;        // dK/dV: 16 keys a warp, 128 a block
constexpr int kDkvKeys = 16 * kDkvWarps;
constexpr int kDqWarps = 4;         // dQ: 16 queries a warp, 64 a block
static_assert(16 * kDqWarps == kTile, "a dQ block owns one tile");

struct RowStrides {
  int64_t b, h, r;            // batch, head, row strides in elements
};

// q, k, v, o, dO, dQ, dK, dV
struct BwdStrides {
  RowStrides q, k, v, o, dout, dq, dk, dv;
};

// Element (r, c) of a [rows][D] tile: the column XOR-swizzled by the row
// (see the design notes).
template <int D>
__device__ __forceinline__ int at(int r, int c) {
  return r * D + (c ^ ((((r >> 1) & 3) << 3) | ((r & 1) << 2)));
}

template <int D>
__host__ __device__ constexpr int dkv_stage_floats() {
  return 3 * kTile * D + 2 * kTile;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V (resident) + 2 x (Q, dO, O tiles, lse, dlse rows) + delta row
  return sizeof(float) *
         (2 * kDkvKeys * D + 2 * dkv_stage_floats<D>() + kTile);
}

template <int D>
__host__ __device__ constexpr int dq_stage_floats() {
  return 2 * kTile * D + kTile;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO (resident) + 2 x (K, V tiles, bias row) + delta row
  return sizeof(float) * (2 * kTile * D + 2 * dq_stage_floats<D>() + kTile);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (cp.async.cg, around L1), or zeros when !ok
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
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

// Copy rows [row0, row0 + n_rows) of one head of a strided operand into a
// swizzled [n_rows][D] tile; rows at or past `limit` become zeros.
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

// Copy kTile floats src[i0 + i] (i0 + i < limit) into dst, zeros past
// `limit` or when src is NULL; threads [t0, t0 + kTile) issue them.
// `any` is some valid global address for the copies that read nothing.
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          int i0, int limit, int t0,
                                          const float* any) {
  const int i = threadIdx.x - t0;
  if (i < 0 || i >= kTile) return;
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

// c (16 x 64) = own[m0:m0+16] . str^T over the depth D: the warp's rows
// of a score tile, 8 m16n8 tiles; own and str are swizzled [rows][D]
// tiles.  One accumulator per tile over a depth of D.
template <int D>
__device__ __forceinline__ void tile_scores(float (&c)[8][4],
                                            const float* own, int m0,
                                            const float* str, int gq,
                                            int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[j][r] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 8) {
    uint32_t ab[4], as[4];
    split(own[at<D>(m0 + gq, kk + tq)], ab[0], as[0]);
    split(own[at<D>(m0 + gq + 8, kk + tq)], ab[1], as[1]);
    split(own[at<D>(m0 + gq, kk + tq + 4)], ab[2], as[2]);
    split(own[at<D>(m0 + gq + 8, kk + tq + 4)], ab[3], as[3]);
    uint32_t bb[8][2], bs[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      split(str[at<D>(8 * j + gq, kk + tq)], bb[j][0], bs[j][0]);
      split(str[at<D>(8 * j + gq, kk + tq + 4)], bb[j][1], bs[j][1]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(c[j], as, bb[j]);
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(c[j], ab, bs[j]);
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(c[j], ab, bb[j]);
  }
}

// acc (16 x D) += a (16 x 64, C fragments of a score tile) . str (64 x D,
// a swizzled [row][D] tile).  The k index is permuted within each 8-step
// (slot t = row 2t, slot t+4 = row 2t+1), so a's C fragment is the A
// fragment as it stands.  Each group of 4 n-tiles sums the 64 rows in
// its own accumulators, then adds them to acc in float32.
template <int D>
__device__ __forceinline__ void tile_product(float (&acc)[D / 8][4],
                                             const float (&a)[8][4],
                                             const float* str, int gq,
                                             int tq) {
#pragma unroll
  for (int ng = 0; ng < D / 32; ++ng) {
    float part[4][4];
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int r = 0; r < 4; ++r) part[nn][r] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t ab[4], as[4];
      split(a[j][0], ab[0], as[0]);
      split(a[j][2], ab[1], as[1]);
      split(a[j][1], ab[2], as[2]);
      split(a[j][3], ab[3], as[3]);
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const int col = ng * 32 + nn * 8 + gq;
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

// Write the warp's 16 x D accumulator rows (times `mul`) to rows
// [row0 + m0, ...) of a strided output, those before `limit`.
template <int D>
__device__ __forceinline__ void store_rows(float* dst, int64_t row_stride,
                                           const float (&acc)[D / 8][4],
                                           float mul, int row0, int limit,
                                           int gq, int tq) {
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + gq + 8 * (r >> 1);
      if (row < limit)
        dst[static_cast<int64_t>(row) * row_stride + nt * 8 + 2 * tq +
            (r & 1)] = acc[nt][r] * mul;
    }
}

template <int D>
__global__ void __launch_bounds__(32 * kDkvWarps, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ o,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dlse,
                     const float* __restrict__ bias, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ dbias,
                     int n_head, int t_q, int t_k, BwdStrides st, float scale,
                     int causal, int q_off, int k_off) {
  constexpr int kThreads = 32 * kDkvWarps;
  constexpr int kStage = dkv_stage_floats<D>();
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // kDkvKeys x D
  float* vs = ks + kDkvKeys * D;                 // kDkvKeys x D
  float* ring = vs + kDkvKeys * D;               // 2 stages
  float* delta_s = ring + 2 * kStage;            // kTile

  const int g = blockIdx.y;
  const int n = g / n_head;
  const int h = g % n_head;
  const int k0 = blockIdx.x * kDkvKeys;
  const int tid = threadIdx.x, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = (tid >> 5) * 16;                // the warp's keys

  const float* qg = q + n * st.q.b + h * st.q.h;
  const float* og = o + n * st.o.b + h * st.o.h;
  const float* dog = dout + n * st.dout.b + h * st.dout.h;
  const float* lseg = lse + static_cast<int64_t>(g) * t_q;
  const float* dlseg =
      dlse != nullptr ? dlse + static_cast<int64_t>(g) * t_q : nullptr;

  // causal: q tiles before qb_first lie wholly above the diagonal
  const int n_qt = (t_q + kTile - 1) / kTile;
  int qb_first = 0;
  if (causal) {
    const int x = k_off + k0 - q_off;
    qb_first = x <= 0 ? 0 : x / kTile;
  }
  auto issue_q = [&](int qb, float* stage) {
    const int q0 = qb * kTile;
    stage_rows<D>(stage, qg, st.q.r, q0, t_q, kTile, kThreads);
    stage_rows<D>(stage + kTile * D, dog, st.dout.r, q0, t_q, kTile,
                       kThreads);
    stage_rows<D>(stage + 2 * kTile * D, og, st.o.r, q0, t_q, kTile,
                       kThreads);
    stage_row(stage + 3 * kTile * D, lseg, q0, t_q, 0, lse);
    stage_row(stage + 3 * kTile * D + kTile, dlseg, q0, t_q, kTile, lse);
  };

  // no q tile visible: nothing is staged, and dK, dV, dbias stay zero
  if (qb_first < n_qt) {
    stage_rows<D>(ks, k + n * st.k.b + h * st.k.h, st.k.r, k0, t_k,
                  kDkvKeys, kThreads);
    stage_rows<D>(vs, v + n * st.v.b + h * st.v.h, st.v.r, k0, t_k,
                  kDkvKeys, kThreads);
    issue_q(qb_first, ring);
  }
  cp_commit();

  float bias_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + m0 + gq + 8 * r;
    bias_r[r] = (bias != nullptr && key < t_k)
                    ? bias[static_cast<int64_t>(n) * t_k + key]
                    : 0.f;
  }
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk_acc[nt][r] = dv_acc[nt][r] = 0.f;
  float db[2] = {0.f, 0.f};

  for (int qb = qb_first, i = 0; qb < n_qt; ++qb, ++i) {
    cp_wait_all();
    __syncthreads();        // tile qb is in; the other stage is free
    if (qb + 1 < n_qt) issue_q(qb + 1, ring + ((i + 1) & 1) * kStage);
    cp_commit();
    const float* qs = ring + (i & 1) * kStage;
    const float* dos = qs + kTile * D;
    const float* os = dos + kTile * D;
    const float* lse_s = os + kTile * D;
    const float* dlse_s = lse_s + kTile;
    const int q0 = qb * kTile;
    {  // delta of each query row: 4 threads a row
      const int row = tid >> 2, part = tid & 3;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const int col = part * (D / 4) + c;
        acc = fmaf(dos[at<D>(row, col)], os[at<D>(row, col)], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) delta_s[row] = acc - dlse_s[row];
    }
    __syncthreads();

    float p[8][4], ds[8][4];
    tile_scores<D>(p, ks, m0, qs, gq, tq);           // s^T = K Q^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = k0 + m0 + gq + 8 * (r >> 1);
        const int qc = 8 * j + 2 * tq + (r & 1);
        const int qp = q0 + qc;
        const bool valid = key < t_k && qp < t_q &&
                           (!causal || q_off + qp >= k_off + key);
        p[j][r] = valid ? expf(p[j][r] * scale + bias_r[r >> 1] -
                               lse_s[qc])
                        : 0.f;
      }
    tile_scores<D>(ds, vs, m0, dos, gq, tq);         // dp^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ds[j][r] = p[j][r] * (ds[j][r] - delta_s[8 * j + 2 * tq + (r & 1)]);
        db[r >> 1] += ds[j][r];
      }
    tile_product<D>(dv_acc, p, dos, gq, tq);         // dV += p^T dO
    tile_product<D>(dk_acc, ds, qs, gq, tq);         // dK += ds^T Q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
    const int key = k0 + m0 + gq + 8 * r;
    if (dbias != nullptr && tq == 0 && key < t_k)
      dbias[static_cast<int64_t>(g) * t_k + key] = db[r];
  }
  store_rows<D>(dk + n * st.dk.b + h * st.dk.h, st.dk.r, dk_acc, scale,
                k0 + m0, t_k, gq, tq);
  store_rows<D>(dv + n * st.dv.b + h * st.dv.h, st.dv.r, dv_acc, 1.f,
                k0 + m0, t_k, gq, tq);
}

template <int D>
__global__ void __launch_bounds__(32 * kDqWarps, 2)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dlse,
                    const float* __restrict__ bias, float* __restrict__ dq,
                    int n_head, int t_q, int t_k, BwdStrides st, float scale,
                    int causal, int q_off, int k_off) {
  constexpr int kThreads = 32 * kDqWarps;
  constexpr int kStage = dq_stage_floats<D>();
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // kTile x D
  float* dos = qs + kTile * D;                   // kTile x D
  float* ring = dos + kTile * D;                 // 2 stages
  float* delta_s = ring + 2 * kStage;            // kTile

  const int g = blockIdx.y;
  const int n = g / n_head;
  const int h = g % n_head;
  const int q0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = (tid >> 5) * 16;                // the warp's queries

  const float* kg = k + n * st.k.b + h * st.k.h;
  const float* vg = v + n * st.v.b + h * st.v.h;
  const float* bg = bias != nullptr ? bias + static_cast<int64_t>(n) * t_k
                                    : nullptr;

  // causal: K tiles from n_kt on lie wholly above the diagonal
  int n_kt = (t_k + kTile - 1) / kTile;
  if (causal) {
    const int x = q_off + q0 + kTile - k_off;
    n_kt = x <= 0 ? 0 : min(n_kt, (x + kTile - 1) / kTile);
  }
  auto issue_kv = [&](int kb, float* stage) {
    const int kk0 = kb * kTile;
    stage_rows<D>(stage, kg, st.k.r, kk0, t_k, kTile, kThreads);
    stage_rows<D>(stage + kTile * D, vg, st.v.r, kk0, t_k, kTile,
                       kThreads);
    stage_row(stage + 2 * kTile * D, bg, kk0, t_k, 0, lse);
  };

  // Q, dO and (in the second stage, free until tile 1) O, with tile 0
  stage_rows<D>(qs, q + n * st.q.b + h * st.q.h, st.q.r, q0, t_q,
                     kTile, kThreads);
  stage_rows<D>(dos, dout + n * st.dout.b + h * st.dout.h, st.dout.r,
                     q0, t_q, kTile, kThreads);
  stage_rows<D>(ring + kStage, o + n * st.o.b + h * st.o.h, st.o.r,
                     q0, t_q, kTile, kThreads);
  if (n_kt > 0) issue_kv(0, ring);
  cp_commit();
  float lse_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + m0 + gq + 8 * r;
    lse_r[r] = qp < t_q ? lse[static_cast<int64_t>(g) * t_q + qp] : 0.f;
  }
  cp_wait_all();
  __syncthreads();
  {  // delta of each query row: 2 threads a row
    const float* os = ring + kStage;
    const int row = tid >> 1, part = tid & 1;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) {
      const int col = part * (D / 2) + c;
      acc = fmaf(dos[at<D>(row, col)], os[at<D>(row, col)], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    const int qp = q0 + row;
    if (part == 0)
      delta_s[row] =
          acc - ((dlse != nullptr && qp < t_q)
                     ? dlse[static_cast<int64_t>(g) * t_q + qp]
                     : 0.f);
  }
  __syncthreads();
  const float delta_r[2] = {delta_s[m0 + gq], delta_s[m0 + gq + 8]};

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;

  for (int kb = 0; kb < n_kt; ++kb) {
    cp_wait_all();
    __syncthreads();        // tile kb is in; the other stage is free
    if (kb + 1 < n_kt) issue_kv(kb + 1, ring + ((kb + 1) & 1) * kStage);
    cp_commit();
    const float* kts = ring + (kb & 1) * kStage;
    const float* vts = kts + kTile * D;
    const float* bias_s = vts + kTile * D;
    const int kk0 = kb * kTile;

    float p[8][4], ds[8][4];
    tile_scores<D>(p, qs, m0, kts, gq, tq);          // s = Q K^T
    tile_scores<D>(ds, dos, m0, vts, gq, tq);        // dp = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qp = q0 + m0 + gq + 8 * (r >> 1);
        const int kc = 8 * j + 2 * tq + (r & 1);
        const int kp = kk0 + kc;
        const bool valid = qp < t_q && kp < t_k &&
                           (!causal || q_off + qp >= k_off + kp);
        p[j][r] = valid ? expf(p[j][r] * scale + bias_s[kc] -
                               lse_r[r >> 1])
                        : 0.f;
        ds[j][r] = p[j][r] * (ds[j][r] - delta_r[r >> 1]);
      }
    tile_product<D>(acc, ds, kts, gq, tq);           // dQ += ds K
  }

  store_rows<D>(dq + n * st.dq.b + h * st.dq.h, st.dq.r, acc, scale,
                q0 + m0, t_q, gq, tq);
}

BwdStrides unpack(const int64_t* s) {
  // host array: (batch, head, row) for q, k, v, o, dO, dQ, dK, dV
  BwdStrides st;
  RowStrides* f[8] = {&st.q, &st.k, &st.v, &st.o, &st.dout, &st.dq, &st.dk,
                      &st.dv};
  for (int t = 0; t < 8; ++t) *f[t] = {s[3 * t], s[3 * t + 1], s[3 * t + 2]};
  return st;
}

// The 16-byte copies need every row of q, k, v, o and dO to start 16-byte
// aligned: their data pointers and their batch, head and row strides.
bool rows_aligned(const void* const (&ptrs)[5], const int64_t* strides) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 15; ++i)
    if (strides[i] % 4 != 0) return false;
  return true;
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* o, const float* dout, const float* lse,
               const float* dlse, const float* bias, float* dk, float* dv,
               float* dbias, int n_batch, int n_head, int t_q, int t_k,
               const BwdStrides& st, float scale, int causal, int q_off,
               int k_off, cudaStream_t stream) {
  auto kernel = &flash_bwd_dkv_kernel<D>;
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_k + kDkvKeys - 1) / kDkvKeys, n_batch * n_head);
  kernel<<<grid, 32 * kDkvWarps, smem, stream>>>(
      q, k, v, o, dout, lse, dlse, bias, dk, dv, dbias, n_head, t_q, t_k, st,
      scale, causal, q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* o, const float* dout, const float* lse,
              const float* dlse, const float* bias, float* dq, int n_batch,
              int n_head, int t_q, int t_k, const BwdStrides& st,
              float scale, int causal, int q_off, int k_off,
              cudaStream_t stream) {
  auto kernel = &flash_bwd_dq_kernel<D>;
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_q + kTile - 1) / kTile, n_batch * n_head);
  kernel<<<grid, 32 * kDqWarps, smem, stream>>>(
      q, k, v, o, dout, lse, dlse, bias, dq, n_head, t_q, t_k, st, scale,
      causal, q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define BWD_INPUTS                                                        \
  static_cast<const float*>(q), static_cast<const float*>(k),             \
      static_cast<const float*>(v), static_cast<const float*>(o),         \
      static_cast<const float*>(dout), static_cast<const float*>(lse),    \
      static_cast<const float*>(dlse), static_cast<const float*>(bias)

// dK, dV and (when dbias is not NULL) the per-(batch*head, key) bias
// gradient.  strides: host array of 24 int64 (batch, head, row) for q, k,
// v, o, dO, dQ, dK, dV.  dlse and bias may be NULL.  Returns the
// cudaError_t of the launch (0 = success), or cudaErrorMisalignedAddress
// when a row of q, k, v, o or dO does not start 16-byte aligned.
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* dlse, const void* bias,
    void* dk, void* dv, void* dbias, int n_batch, int n_head, int d,
    int t_q, int t_k, const int64_t* strides, float scale, int causal,
    int q_off, int k_off, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_batch == 0 || t_k == 0) return 0;
  const BwdStrides st = unpack(strides);
  const void* const rows[5] = {q, k, v, o, dout};
  if (!rows_aligned(rows, strides))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  float* dbf = static_cast<float*>(dbias);
  switch (d) {
    case 32:
      return launch_dkv<32>(BWD_INPUTS, dkf, dvf, dbf, n_batch, n_head,
                            t_q, t_k, st, scale, causal, q_off, k_off, s);
    case 64:
      return launch_dkv<64>(BWD_INPUTS, dkf, dvf, dbf, n_batch, n_head,
                            t_q, t_k, st, scale, causal, q_off, k_off, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dQ.  Same arguments as the dK/dV entry point, without the outputs it
// writes.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* dlse, const void* bias,
    void* dq, int n_batch, int n_head, int d, int t_q, int t_k,
    const int64_t* strides, float scale, int causal, int q_off, int k_off,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_batch == 0 || t_q == 0) return 0;
  const BwdStrides st = unpack(strides);
  const void* const rows[5] = {q, k, v, o, dout};
  if (!rows_aligned(rows, strides))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dqf = static_cast<float*>(dq);
  switch (d) {
    case 32:
      return launch_dq<32>(BWD_INPUTS, dqf, n_batch, n_head, t_q, t_k,
                           st, scale, causal, q_off, k_off, s);
    case 64:
      return launch_dq<64>(BWD_INPUTS, dqf, n_batch, n_head, t_q, t_k,
                           st, scale, causal, q_off, k_off, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
