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
// the tensor cores as 3xTF32 mma.sync (csrc/flash_mma.cuh: the split, the
// fragments, the swizzle, the one-tile-a-accumulator rule).  The least
// time is then the larger of the bytes and 3 x the product flops at the
// 495 TFLOP/s TF32 peak (0.078 and 0.059 ms for the products alone),
// which only wgmma reaches.
//
// Design.  Warps own 16 rows each.  Per warp, every step is a 16-row
// score tile against the streamed tile and a 16-row product:
//  - dK/dV: one block per (key tile, batch*head), 8 warps, the block's K
//    and V resident in shared memory.  The block walks the q tiles from
//    the first one not wholly above the causal diagonal, and per tile
//    forms the scores transposed, so its own keys are the M rows:
//      s^T = K Q^T, p^T (masked), dp^T = V dO^T, ds^T = p^T (dp^T - delta)
//      dV += p^T dO,  dK += ds^T Q,  dbias_k += rowsum(ds^T)
//    and scales dK once at the end.  delta is formed per staged q tile
//    from its dO and O rows (8 or 4 threads a row, float32 FMA).
//    D <= 64: 128 keys a block, 16 a warp, 64-row q tiles (161 KB): two
//    64-key blocks of 4 warps would each hold K, V and two stages of Q,
//    dO and O (130 KB at D = 64), one block an SM; one 128-key block
//    stages each q tile once for twice the keys.
//    D = 128: 64 keys a block, and the two warps of each 16-key group
//    each own 64 of the 128 columns of dK and dV; both form the group's
//    16 x 32 s^T and dp^T (the score products done twice, no exchange
//    through shared memory), over 32-row q tiles (161 KB).  A warp then
//    holds the same 128 accumulator floats as at D = 64 (dK, dV, p, ds
//    over half the columns and half the rows), where one warp owning all
//    128 columns of 16 keys would need 128 for dK and dV alone.
//  - dQ: one block per (64-query tile, batch*head), 4 warps, its Q and
//    dO rows resident; delta is formed once from the O tile; the block
//    walks the K/V tiles (64 keys, 32 at D = 128) up to the causal
//    diagonal:
//      s = Q K^T, p, dp = dO V^T, ds = p (dp - delta),  dQ += ds K
//    and scales dQ once at the end.  97 KB a block at D = 64 (two blocks
//    an SM), 129 KB at D = 128 (one).
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
//
// The bf16 paths (flash_attention_bwd_dkv_bf16_launch and
// flash_attention_bwd_dq_bf16_launch; the AMP policy hands the flash op
// bf16 q, k, v and the forward stores a bf16 O): kernels of their own,
// flash_bwd_dkv_bf16_kernel and flash_bwd_dq_bf16_kernel, on the bf16
// tensor cores (mma.sync m16n8k16, csrc/flash_mma.cuh).  They compute
// what the float32 kernels compute, in float32 from the bf16 values, as
// the TPU kernels widen every operand, and round dK, dV and dQ to bf16
// once as they are stored.
//  - What bounds them on the H100: bytes.  At phase 6i's shape (N=64,
//    H=8, T=256, D=64, bf16, the mean of causal and not) dK/dV moves 118
//    MB and dQ 101 MB, 0.035 and 0.030 ms at 3.35 TB/s, against 0.013
//    and 0.010 ms for their 8*D and 6*D product flops a visible pair at
//    the 989 TFLOP/s bf16 peak (ops/kernels/flash_attention.py,
//    tensor_core_bound_ms_bwd).
//  - The products.  s (s^T) and dp (dp^T) multiply staged bf16 values:
//    exact products, one pass each (tile_scores_bf16).  p and ds are
//    float32; rounded once to bf16 before dV += p^T dO, dK += ds^T Q and
//    dQ += ds K they miss chip_smoke.py's bf16 gradient gate (2^-7
//    relative plus 2^-10 of max) in every case of
//    tests/test_torch_flash_backward.py's emulation at T = 256; split
//    into hi = bf16(x) and lo = bf16(x - hi), two passes
//    (tile_product_bf16), they meet it.  So dK/dV issues 6
//    bf16 passes a pair (12*D flops) and dQ 4 (8*D).  Each tile's
//    product has its own accumulator, added to float32 registers.
//  - Around the products.  A warp whose 16 rows see every pair of the
//    streamed tile (neither ragged nor crossed by the causal diagonal)
//    skips the mask's per-pair index tests, which cost as many issue
//    slots as the exp; at T >= 256 most tiles are such.  p = exp(...) is
//    exp2f of arguments scaled by log2(e) (prob), one FMA before the
//    ex2.
//  - Tiles, stages, occupancy.  bf16 tiles [row][D], 16-byte chunks
//    swizzled (at16), filled by cp.async (stage_rows16), the streamed
//    tiles through a double-buffered ring: the next lands while this one
//    computes.  Fragments by ldmatrix (A of a warp's 16 rows, B of a
//    score product) and ldmatrix.trans (B of a second product).  Both
//    stream 64-row tiles (kBf16Rows), the depth of each second product's
//    accumulators.  dK/dV: the float32 kernel's blocks (8 warps; 128
//    keys at D <= 64, 64 keys with two warps a 16-key group at D = 128),
//    K and V resident, Q, dO, O, lse and dlse streamed: 81 KB a block at
//    D = 64, 129 KB at D = 128, 41 KB at D = 32.  Two D = 64 blocks
//    would fit an SM's shared memory, but not its registers (a warp
//    holds dK and dV, 64 floats, beside p and ds, 64): one block an SM
//    (8 warps).  dQ: 64 queries a block, 4 warps, Q and dO resident, K,
//    V and the bias row streamed: 49 KB at D = 64, three blocks an SM;
//    97 KB at D = 128, two.  delta = rowsum(dO * O) - dlse is formed per
//    q tile from the staged bf16 rows in float32 FMAs.
//  Rows of q, k, v, O and dO must start 16-byte aligned (strides
//  multiples of 8 values), as for the float32 kernels.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_mma.cuh"

namespace {

using namespace flash;

constexpr int kDkvWarps = 8;        // dK/dV: 8 warps a block
constexpr int kDqRows = 64;         // dQ: 64 queries a block,
constexpr int kDqWarps = 4;         //     16 a warp
static_assert(16 * kDqWarps == kDqRows, "a dQ warp owns 16 rows");

struct RowStrides {
  int64_t b, h, r;            // batch, head, row strides in elements
};

// q, k, v, o, dO, dQ, dK, dV
struct BwdStrides {
  RowStrides q, k, v, o, dout, dq, dk, dv;
};

// dK/dV: warps sharing a 16-key group (each owns D / split columns of dK
// and dV), keys a block, rows of a streamed q tile
template <int D>
__host__ __device__ constexpr int dkv_split() {
  return D > 64 ? 2 : 1;
}

template <int D>
__host__ __device__ constexpr int dkv_keys() {
  return 16 * kDkvWarps / dkv_split<D>();
}

template <int D>
__host__ __device__ constexpr int dkv_q_rows() {
  return D > 64 ? 32 : 64;
}

template <int D>
__host__ __device__ constexpr int dkv_stage_floats() {
  return 3 * dkv_q_rows<D>() * D + 2 * dkv_q_rows<D>();
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V (resident) + 2 x (Q, dO, O tiles, lse, dlse rows) + delta row
  return sizeof(float) * (2 * dkv_keys<D>() * D + 2 * dkv_stage_floats<D>() +
                          dkv_q_rows<D>());
}

// dQ: keys a streamed K/V tile
template <int D>
__host__ __device__ constexpr int dq_keys() {
  return D > 64 ? 32 : 64;
}

template <int D>
__host__ __device__ constexpr int dq_stage_floats() {
  return 2 * dq_keys<D>() * D + dq_keys<D>();
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO (resident) + 2 x (K, V tiles, bias row) + delta row
  return sizeof(float) *
         (2 * kDqRows * D + 2 * dq_stage_floats<D>() + kDqRows);
}

// bf16 paths: rows of a streamed tile (q rows for dK/dV, keys for dQ),
// the depth of each second product's accumulators
constexpr int kBf16Rows = 64;

template <int D>
constexpr size_t dkv_bf16_smem_bytes() {
  // K, V (resident) + 2 x (Q, dO, O tiles) in bf16; 2 x (lse, dlse rows)
  // + delta row in float32
  return 2 * (2 * dkv_keys<D>() * D + 2 * 3 * kBf16Rows * D) +
         sizeof(float) * (2 * 2 * kBf16Rows + kBf16Rows);
}

template <int D>
constexpr size_t dq_bf16_smem_bytes() {
  // Q, dO (resident) + 2 x (K, V tiles) in bf16; 2 x bias row + delta row
  // in float32
  return 2 * (2 * kDqRows * D + 2 * 2 * kBf16Rows * D) +
         sizeof(float) * (2 * kBf16Rows + kDqRows);
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
  constexpr int kSplit = dkv_split<D>();
  constexpr int kKeys = dkv_keys<D>();
  constexpr int kRows = dkv_q_rows<D>();          // of a q tile
  constexpr int kNq = kRows / 8;                  // n-tiles of a score tile
  constexpr int kCols = D / kSplit;               // a warp's dK/dV columns
  constexpr int kStage = dkv_stage_floats<D>();
  constexpr int kTpr = kThreads / kRows;          // delta: threads a row
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // kKeys x D
  float* vs = ks + kKeys * D;                    // kKeys x D
  float* ring = vs + kKeys * D;                  // 2 stages
  float* delta_s = ring + 2 * kStage;            // kRows

  const int g = blockIdx.y;
  const int n = g / n_head;
  const int h = g % n_head;
  const int k0 = blockIdx.x * kKeys;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = (warp / kSplit) * 16;           // the warp's keys
  const int c0 = (warp % kSplit) * kCols;        // and columns

  const float* qg = q + n * st.q.b + h * st.q.h;
  const float* og = o + n * st.o.b + h * st.o.h;
  const float* dog = dout + n * st.dout.b + h * st.dout.h;
  const float* lseg = lse + static_cast<int64_t>(g) * t_q;
  const float* dlseg =
      dlse != nullptr ? dlse + static_cast<int64_t>(g) * t_q : nullptr;

  // causal: q tiles before qb_first lie wholly above the diagonal
  const int n_qt = (t_q + kRows - 1) / kRows;
  int qb_first = 0;
  if (causal) {
    const int x = k_off + k0 - q_off;
    qb_first = x <= 0 ? 0 : x / kRows;
  }
  auto issue_q = [&](int qb, float* stage) {
    const int q0 = qb * kRows;
    stage_rows<D>(stage, qg, st.q.r, q0, t_q, kRows, kThreads);
    stage_rows<D>(stage + kRows * D, dog, st.dout.r, q0, t_q, kRows,
                  kThreads);
    stage_rows<D>(stage + 2 * kRows * D, og, st.o.r, q0, t_q, kRows,
                  kThreads);
    stage_row(stage + 3 * kRows * D, lseg, q0, t_q, kRows, 0, lse);
    stage_row(stage + 3 * kRows * D + kRows, dlseg, q0, t_q, kRows, kRows,
              lse);
  };

  // no q tile visible: nothing is staged, and dK, dV, dbias stay zero
  if (qb_first < n_qt) {
    stage_rows<D>(ks, k + n * st.k.b + h * st.k.h, st.k.r, k0, t_k, kKeys,
                  kThreads);
    stage_rows<D>(vs, v + n * st.v.b + h * st.v.h, st.v.r, k0, t_k, kKeys,
                  kThreads);
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
  float dk_acc[kCols / 8][4], dv_acc[kCols / 8][4];
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk_acc[nt][r] = dv_acc[nt][r] = 0.f;
  float db[2] = {0.f, 0.f};

  for (int qb = qb_first, i = 0; qb < n_qt; ++qb, ++i) {
    cp_wait_all();
    __syncthreads();        // tile qb is in; the other stage is free
    if (qb + 1 < n_qt) issue_q(qb + 1, ring + ((i + 1) & 1) * kStage);
    cp_commit();
    const float* qs = ring + (i & 1) * kStage;
    const float* dos = qs + kRows * D;
    const float* os = dos + kRows * D;
    const float* lse_s = os + kRows * D;
    const float* dlse_s = lse_s + kRows;
    const int q0 = qb * kRows;
    {  // delta of each query row: kTpr threads a row
      const int row = tid / kTpr, part = tid % kTpr;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < D / kTpr; ++c) {
        const int col = part * (D / kTpr) + c;
        acc = fmaf(dos[at<D>(row, col)], os[at<D>(row, col)], acc);
      }
#pragma unroll
      for (int off = 1; off < kTpr; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (part == 0) delta_s[row] = acc - dlse_s[row];
    }
    __syncthreads();

    float p[kNq][4], ds[kNq][4];
    tile_scores<D, kNq>(p, ks, m0, qs, gq, tq);      // s^T = K Q^T
#pragma unroll
    for (int j = 0; j < kNq; ++j)
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
    tile_scores<D, kNq>(ds, vs, m0, dos, gq, tq);    // dp^T = V dO^T
#pragma unroll
    for (int j = 0; j < kNq; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ds[j][r] = p[j][r] * (ds[j][r] - delta_s[8 * j + 2 * tq + (r & 1)]);
        db[r >> 1] += ds[j][r];
      }
    tile_product<D, kNq, kCols>(dv_acc, p, dos, c0, gq, tq);  // dV += p^T dO
    tile_product<D, kNq, kCols>(dk_acc, ds, qs, c0, gq, tq);  // dK += ds^T Q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
    const int key = k0 + m0 + gq + 8 * r;
    if (dbias != nullptr && c0 == 0 && tq == 0 && key < t_k)
      dbias[static_cast<int64_t>(g) * t_k + key] = db[r];
  }
  const float dk_mul[2] = {scale, scale}, dv_mul[2] = {1.f, 1.f};
  store_rows<kCols>(dk + n * st.dk.b + h * st.dk.h, st.dk.r, dk_acc, dk_mul,
                    k0 + m0, c0, t_k, gq, tq);
  store_rows<kCols>(dv + n * st.dv.b + h * st.dv.h, st.dv.r, dv_acc, dv_mul,
                    k0 + m0, c0, t_k, gq, tq);
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
  constexpr int kKeys = dq_keys<D>();
  constexpr int kNk = kKeys / 8;                 // n-tiles of a score tile
  constexpr int kStage = dq_stage_floats<D>();
  static_assert(kStage >= kDqRows * D, "the O tile fits one stage");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // kDqRows x D
  float* dos = qs + kDqRows * D;                 // kDqRows x D
  float* ring = dos + kDqRows * D;               // 2 stages
  float* delta_s = ring + 2 * kStage;            // kDqRows

  const int g = blockIdx.y;
  const int n = g / n_head;
  const int h = g % n_head;
  const int q0 = blockIdx.x * kDqRows;
  const int tid = threadIdx.x, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = (tid >> 5) * 16;                // the warp's queries

  const float* kg = k + n * st.k.b + h * st.k.h;
  const float* vg = v + n * st.v.b + h * st.v.h;
  const float* bg = bias != nullptr ? bias + static_cast<int64_t>(n) * t_k
                                    : nullptr;

  // causal: K tiles from n_kt on lie wholly above the diagonal
  int n_kt = (t_k + kKeys - 1) / kKeys;
  if (causal) {
    const int x = q_off + q0 + kDqRows - k_off;
    n_kt = x <= 0 ? 0 : min(n_kt, (x + kKeys - 1) / kKeys);
  }
  auto issue_kv = [&](int kb, float* stage) {
    const int kk0 = kb * kKeys;
    stage_rows<D>(stage, kg, st.k.r, kk0, t_k, kKeys, kThreads);
    stage_rows<D>(stage + kKeys * D, vg, st.v.r, kk0, t_k, kKeys, kThreads);
    stage_row(stage + 2 * kKeys * D, bg, kk0, t_k, kKeys, 0, lse);
  };

  // Q, dO and (in the second stage, free until tile 1) O, with tile 0
  stage_rows<D>(qs, q + n * st.q.b + h * st.q.h, st.q.r, q0, t_q, kDqRows,
                kThreads);
  stage_rows<D>(dos, dout + n * st.dout.b + h * st.dout.h, st.dout.r, q0,
                t_q, kDqRows, kThreads);
  stage_rows<D>(ring + kStage, o + n * st.o.b + h * st.o.h, st.o.r, q0, t_q,
                kDqRows, kThreads);
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
    const float* vts = kts + kKeys * D;
    const float* bias_s = vts + kKeys * D;
    const int kk0 = kb * kKeys;

    float p[kNk][4], ds[kNk][4];
    tile_scores<D, kNk>(p, qs, m0, kts, gq, tq);     // s = Q K^T
    tile_scores<D, kNk>(ds, dos, m0, vts, gq, tq);   // dp = dO V^T
#pragma unroll
    for (int j = 0; j < kNk; ++j)
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
    tile_product<D, kNk, D>(acc, ds, kts, 0, gq, tq);  // dQ += ds K
  }

  const float mul[2] = {scale, scale};
  store_rows<D>(dq + n * st.dq.b + h * st.dq.h, st.dq.r, acc, mul, q0 + m0,
                0, t_q, gq, tq);
}

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// p = exp(s * scale + b - l) as exp2f(s * scale_log2 + (b - l) log2(e)),
// scale_log2 = scale log2(e): one FMA and ex2 a probability
__device__ __forceinline__ float prob(float s, float scale_log2,
                                      float b_minus_l) {
  return exp2f(fmaf(s, scale_log2, b_minus_l * kLog2e));
}

// The bf16 dK/dV kernel: the float32 kernel's blocks and steps on bf16
// tiles, 64-row q tiles, the score products one bf16 pass, p^T and ds^T
// split hi + lo for the two passes of dV += p^T dO and dK += ds^T Q.
template <int D>
__global__ void __launch_bounds__(32 * kDkvWarps, 1)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ o,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dlse,
                          const float* __restrict__ bias,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* __restrict__ dbias, int n_head, int t_q,
                          int t_k, BwdStrides st, float scale, int causal,
                          int q_off, int k_off) {
  constexpr int kThreads = 32 * kDkvWarps;
  constexpr int kSplit = dkv_split<D>();
  constexpr int kKeys = dkv_keys<D>();
  constexpr int kRows = kBf16Rows;                // of a q tile
  constexpr int kNq = kRows / 8;                  // n-tiles of a score tile
  constexpr int kCols = D / kSplit;               // a warp's dK/dV columns
  constexpr int kStage = 3 * kRows * D;           // Q, dO, O tiles
  constexpr int kTpr = kThreads / kRows;          // delta: threads a row
  static_assert(D / kTpr % 8 == 0, "delta: whole 16-byte chunks a thread");
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);      // kKeys x D
  bf16* vs = ks + kKeys * D;                      // kKeys x D
  bf16* ring = vs + kKeys * D;                    // 2 stages
  float* stats = reinterpret_cast<float*>(ring + 2 * kStage);  // 2 x 2 rows
  float* delta_s = stats + 2 * 2 * kRows;         // kRows

  const int g = blockIdx.y;
  const int n = g / n_head;
  const int h = g % n_head;
  const int k0 = blockIdx.x * kKeys;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = (warp / kSplit) * 16;           // the warp's keys
  const int c0 = (warp % kSplit) * kCols;        // and columns
  const float scale_log2 = scale * kLog2e;

  const bf16* qg = q + n * st.q.b + h * st.q.h;
  const bf16* og = o + n * st.o.b + h * st.o.h;
  const bf16* dog = dout + n * st.dout.b + h * st.dout.h;
  const float* lseg = lse + static_cast<int64_t>(g) * t_q;
  const float* dlseg =
      dlse != nullptr ? dlse + static_cast<int64_t>(g) * t_q : nullptr;

  // causal: q tiles before qb_first lie wholly above the diagonal
  const int n_qt = (t_q + kRows - 1) / kRows;
  int qb_first = 0;
  if (causal) {
    const int x = k_off + k0 - q_off;
    qb_first = x <= 0 ? 0 : x / kRows;
  }
  auto issue_q = [&](int qb, int slot) {
    const int q0 = qb * kRows;
    bf16* stage = ring + slot * kStage;
    float* rows = stats + slot * 2 * kRows;
    stage_rows16<D>(stage, qg, st.q.r, q0, t_q, kRows, kThreads);
    stage_rows16<D>(stage + kRows * D, dog, st.dout.r, q0, t_q, kRows,
                    kThreads);
    stage_rows16<D>(stage + 2 * kRows * D, og, st.o.r, q0, t_q, kRows,
                    kThreads);
    stage_row(rows, lseg, q0, t_q, kRows, 0, lse);
    stage_row(rows + kRows, dlseg, q0, t_q, kRows, kRows, lse);
  };

  // no q tile visible: nothing is staged, and dK, dV, dbias stay zero
  if (qb_first < n_qt) {
    stage_rows16<D>(ks, k + n * st.k.b + h * st.k.h, st.k.r, k0, t_k, kKeys,
                    kThreads);
    stage_rows16<D>(vs, v + n * st.v.b + h * st.v.h, st.v.r, k0, t_k, kKeys,
                    kThreads);
    issue_q(qb_first, 0);
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
  float dk_acc[kCols / 8][4], dv_acc[kCols / 8][4];
#pragma unroll
  for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk_acc[nt][r] = dv_acc[nt][r] = 0.f;
  float db[2] = {0.f, 0.f};

  for (int qb = qb_first, i = 0; qb < n_qt; ++qb, ++i) {
    cp_wait_all();
    __syncthreads();        // tile qb is in; the other stage is free
    if (qb + 1 < n_qt) issue_q(qb + 1, (i + 1) & 1);
    cp_commit();
    const bf16* qs = ring + (i & 1) * kStage;
    const bf16* dos = qs + kRows * D;
    const bf16* os = dos + kRows * D;
    const float* lse_s = stats + (i & 1) * 2 * kRows;
    const float* dlse_s = lse_s + kRows;
    const int q0 = qb * kRows;
    {  // delta of each query row: kTpr threads a row
      const int row = tid / kTpr, part = tid % kTpr;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < D / kTpr; c += 8) {
        const int col = part * (D / kTpr) + c;
        acc = dot8(dos + at16<D>(row, col), os + at16<D>(row, col), acc);
      }
#pragma unroll
      for (int off = 1; off < kTpr; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (part == 0) delta_s[row] = acc - dlse_s[row];
    }
    __syncthreads();

    float p[kNq][4], ds[kNq][4];
    tile_scores_bf16<D, kNq>(p, ks, m0, qs, lane);     // s^T = K Q^T
    // every pair of the warp's 16 keys and the tile's queries visible:
    // no mask to form
    const bool dense = k0 + m0 + 16 <= t_k && q0 + kRows <= t_q &&
                       (!causal || q_off + q0 >= k_off + k0 + m0 + 15);
    if (dense) {
#pragma unroll
      for (int j = 0; j < kNq; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int qc = 8 * j + 2 * tq + (r & 1);
          p[j][r] = prob(p[j][r], scale_log2, bias_r[r >> 1] - lse_s[qc]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < kNq; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = k0 + m0 + gq + 8 * (r >> 1);
          const int qc = 8 * j + 2 * tq + (r & 1);
          const int qp = q0 + qc;
          const bool valid = key < t_k && qp < t_q &&
                             (!causal || q_off + qp >= k_off + key);
          p[j][r] = valid ? prob(p[j][r], scale_log2,
                                 bias_r[r >> 1] - lse_s[qc])
                          : 0.f;
        }
    }
    tile_scores_bf16<D, kNq>(ds, vs, m0, dos, lane);   // dp^T = V dO^T
#pragma unroll
    for (int j = 0; j < kNq; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ds[j][r] = p[j][r] * (ds[j][r] - delta_s[8 * j + 2 * tq + (r & 1)]);
        db[r >> 1] += ds[j][r];
      }
    uint32_t hi[kNq / 2][4], lo[kNq / 2][4];
    split_bf16<kNq / 2>(p, hi, lo);
    tile_product_bf16<D, kNq / 2, kCols, kCols>(dv_acc, hi, lo, dos, c0,
                                             lane);    // dV += p^T dO
    split_bf16<kNq / 2>(ds, hi, lo);
    tile_product_bf16<D, kNq / 2, kCols, kCols>(dk_acc, hi, lo, qs, c0,
                                             lane);    // dK += ds^T Q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 1);
    db[r] += __shfl_xor_sync(0xffffffffu, db[r], 2);
    const int key = k0 + m0 + gq + 8 * r;
    if (dbias != nullptr && c0 == 0 && tq == 0 && key < t_k)
      dbias[static_cast<int64_t>(g) * t_k + key] = db[r];
  }
  store_rows<kCols>(dk + n * st.dk.b + h * st.dk.h, st.dk.r, dk_acc, scale,
                    k0 + m0, c0, t_k, gq, tq);
  store_rows<kCols>(dv + n * st.dv.b + h * st.dv.h, st.dv.r, dv_acc, 1.f,
                    k0 + m0, c0, t_k, gq, tq);
}

// The bf16 dQ kernel: the float32 kernel's blocks and steps on bf16
// tiles, 64-key K/V tiles at every D, the score products one bf16 pass,
// ds split hi + lo for the two passes of dQ += ds K.  Three blocks an SM
// at D <= 64 (at most 168 registers, no spill), two at D = 128, where
// three would spill.
template <int D>
__global__ void __launch_bounds__(32 * kDqWarps, D > 64 ? 2 : 3)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ o,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dlse,
                         const float* __restrict__ bias,
                         bf16* __restrict__ dq, int n_head, int t_q,
                         int t_k, BwdStrides st, float scale, int causal,
                         int q_off, int k_off) {
  constexpr int kThreads = 32 * kDqWarps;
  constexpr int kKeys = kBf16Rows;
  constexpr int kNk = kKeys / 8;                 // n-tiles of a score tile
  constexpr int kStage = 2 * kKeys * D;          // K, V tiles
  constexpr int kGroup = D < 64 ? D : 64;        // dQ columns a part sum
  static_assert(kStage >= kDqRows * D, "the O tile fits one stage");
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);     // kDqRows x D
  bf16* dos = qs + kDqRows * D;                  // kDqRows x D
  bf16* ring = dos + kDqRows * D;                // 2 stages
  float* bias_ring = reinterpret_cast<float*>(ring + 2 * kStage);
  float* delta_s = bias_ring + 2 * kKeys;        // kDqRows

  const int g = blockIdx.y;
  const int n = g / n_head;
  const int h = g % n_head;
  const int q0 = blockIdx.x * kDqRows;
  const int tid = threadIdx.x, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = (tid >> 5) * 16;                // the warp's queries
  const float scale_log2 = scale * kLog2e;

  const bf16* kg = k + n * st.k.b + h * st.k.h;
  const bf16* vg = v + n * st.v.b + h * st.v.h;
  const float* bg = bias != nullptr ? bias + static_cast<int64_t>(n) * t_k
                                    : nullptr;

  // causal: K tiles from n_kt on lie wholly above the diagonal
  int n_kt = (t_k + kKeys - 1) / kKeys;
  if (causal) {
    const int x = q_off + q0 + kDqRows - k_off;
    n_kt = x <= 0 ? 0 : min(n_kt, (x + kKeys - 1) / kKeys);
  }
  auto issue_kv = [&](int kb, int slot) {
    const int kk0 = kb * kKeys;
    bf16* stage = ring + slot * kStage;
    stage_rows16<D>(stage, kg, st.k.r, kk0, t_k, kKeys, kThreads);
    stage_rows16<D>(stage + kKeys * D, vg, st.v.r, kk0, t_k, kKeys,
                    kThreads);
    stage_row(bias_ring + slot * kKeys, bg, kk0, t_k, kKeys, 0, lse);
  };

  // Q, dO and (in the second stage, free until tile 1) O, with tile 0
  stage_rows16<D>(qs, q + n * st.q.b + h * st.q.h, st.q.r, q0, t_q, kDqRows,
                  kThreads);
  stage_rows16<D>(dos, dout + n * st.dout.b + h * st.dout.h, st.dout.r, q0,
                  t_q, kDqRows, kThreads);
  stage_rows16<D>(ring + kStage, o + n * st.o.b + h * st.o.h, st.o.r, q0,
                  t_q, kDqRows, kThreads);
  if (n_kt > 0) issue_kv(0, 0);
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
    const bf16* os = ring + kStage;
    const int row = tid >> 1, part = tid & 1;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {
      const int col = part * (D / 2) + c;
      acc = dot8(dos + at16<D>(row, col), os + at16<D>(row, col), acc);
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
    if (kb + 1 < n_kt) issue_kv(kb + 1, (kb + 1) & 1);
    cp_commit();
    const bf16* kts = ring + (kb & 1) * kStage;
    const bf16* vts = kts + kKeys * D;
    const float* bias_s = bias_ring + (kb & 1) * kKeys;
    const int kk0 = kb * kKeys;

    float p[kNk][4], ds[kNk][4];
    tile_scores_bf16<D, kNk>(p, qs, m0, kts, lane);    // s = Q K^T
    tile_scores_bf16<D, kNk>(ds, dos, m0, vts, lane);  // dp = dO V^T
    // every pair of the warp's 16 queries and the tile's keys visible: no
    // mask to form
    const bool dense =
        q0 + m0 + 16 <= t_q && kk0 + kKeys <= t_k &&
        (!causal || q_off + q0 + m0 >= k_off + kk0 + kKeys - 1);
    if (dense) {
#pragma unroll
      for (int j = 0; j < kNk; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kc = 8 * j + 2 * tq + (r & 1);
          p[j][r] = prob(p[j][r], scale_log2, bias_s[kc] - lse_r[r >> 1]);
          ds[j][r] = p[j][r] * (ds[j][r] - delta_r[r >> 1]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < kNk; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int qp = q0 + m0 + gq + 8 * (r >> 1);
          const int kc = 8 * j + 2 * tq + (r & 1);
          const int kp = kk0 + kc;
          const bool valid = qp < t_q && kp < t_k &&
                             (!causal || q_off + qp >= k_off + kp);
          p[j][r] = valid ? prob(p[j][r], scale_log2,
                                 bias_s[kc] - lse_r[r >> 1])
                          : 0.f;
          ds[j][r] = p[j][r] * (ds[j][r] - delta_r[r >> 1]);
        }
    }
    uint32_t hi[kNk / 2][4], lo[kNk / 2][4];
    split_bf16<kNk / 2>(ds, hi, lo);
    tile_product_bf16<D, kNk / 2, D, kGroup>(acc, hi, lo, kts, 0,
                                             lane);    // dQ += ds K
  }

  store_rows<D>(dq + n * st.dq.b + h * st.dq.h, st.dq.r, acc, scale,
                q0 + m0, 0, t_q, gq, tq);
}

BwdStrides unpack(const int64_t* s) {
  // host array: (batch, head, row) for q, k, v, o, dO, dQ, dK, dV
  BwdStrides st;
  RowStrides* f[8] = {&st.q, &st.k, &st.v, &st.o, &st.dout, &st.dq, &st.dk,
                      &st.dv};
  for (int t = 0; t < 8; ++t) *f[t] = {s[3 * t], s[3 * t + 1], s[3 * t + 2]};
  return st;
}

// The kernels of an operand type: float32 (3xTF32) or bf16
template <int D>
auto dkv_kernel(const float*) {
  return &flash_bwd_dkv_kernel<D>;
}
template <int D>
auto dkv_kernel(const bf16*) {
  return &flash_bwd_dkv_bf16_kernel<D>;
}
template <int D>
auto dq_kernel(const float*) {
  return &flash_bwd_dq_kernel<D>;
}
template <int D>
auto dq_kernel(const bf16*) {
  return &flash_bwd_dq_bf16_kernel<D>;
}

template <int D, typename T>
int launch_dkv(const T* q, const T* k, const T* v, const T* o,
               const T* dout, const float* lse, const float* dlse,
               const float* bias, T* dk, T* dv, float* dbias, int n_batch,
               int n_head, int t_q, int t_k, const BwdStrides& st,
               float scale, int causal, int q_off, int k_off,
               cudaStream_t stream) {
  auto kernel = dkv_kernel<D>(q);
  const size_t smem = std::is_same<T, float>::value
                          ? dkv_smem_bytes<D>()
                          : dkv_bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_k + dkv_keys<D>() - 1) / dkv_keys<D>(),
                  n_batch * n_head);
  kernel<<<grid, 32 * kDkvWarps, smem, stream>>>(
      q, k, v, o, dout, lse, dlse, bias, dk, dv, dbias, n_head, t_q, t_k, st,
      scale, causal, q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int launch_dq(const T* q, const T* k, const T* v, const T* o,
              const T* dout, const float* lse, const float* dlse,
              const float* bias, T* dq, int n_batch, int n_head, int t_q,
              int t_k, const BwdStrides& st, float scale, int causal,
              int q_off, int k_off, cudaStream_t stream) {
  auto kernel = dq_kernel<D>(q);
  const size_t smem = std::is_same<T, float>::value
                          ? dq_smem_bytes<D>()
                          : dq_bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_q + kDqRows - 1) / kDqRows, n_batch * n_head);
  kernel<<<grid, 32 * kDqWarps, smem, stream>>>(
      q, k, v, o, dout, lse, dlse, bias, dq, n_head, t_q, t_k, st, scale,
      causal, q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte copies read q, k, v, o and dO: their pointers and their
// batch, head and row strides (the first 15 of the 24).
bool operands_aligned(const void* q, const void* k, const void* v,
                      const void* o, const void* dout,
                      const int64_t* strides, int elem) {
  const void* const rows[5] = {q, k, v, o, dout};
  return rows_aligned(rows, 5, strides, 15, elem);
}

#define BWD_INPUTS                                                         \
  static_cast<const T*>(q), static_cast<const T*>(k),                      \
      static_cast<const T*>(v), static_cast<const T*>(o),                  \
      static_cast<const T*>(dout), static_cast<const float*>(lse),         \
      static_cast<const float*>(dlse), static_cast<const float*>(bias)

// T = float or __nv_bfloat16: the type of q, k, v, o, dO and the outputs
template <typename T>
int dkv_entry(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, const void* dlse,
              const void* bias, void* dk, void* dv, void* dbias, int n_batch,
              int n_head, int d, int t_q, int t_k, const int64_t* strides,
              float scale, int causal, int q_off, int k_off, int device,
              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_batch == 0 || t_k == 0) return 0;
  const BwdStrides st = unpack(strides);
  if (!operands_aligned(q, k, v, o, dout, strides, sizeof(T)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  float* dbf = static_cast<float*>(dbias);
  switch (d) {
    case 32:
      return launch_dkv<32, T>(BWD_INPUTS, dkt, dvt, dbf, n_batch, n_head,
                               t_q, t_k, st, scale, causal, q_off, k_off, s);
    case 64:
      return launch_dkv<64, T>(BWD_INPUTS, dkt, dvt, dbf, n_batch, n_head,
                               t_q, t_k, st, scale, causal, q_off, k_off, s);
    case 128:
      return launch_dkv<128, T>(BWD_INPUTS, dkt, dvt, dbf, n_batch, n_head,
                                t_q, t_k, st, scale, causal, q_off, k_off,
                                s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dq_entry(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, const void* dlse,
             const void* bias, void* dq, int n_batch, int n_head, int d,
             int t_q, int t_k, const int64_t* strides, float scale,
             int causal, int q_off, int k_off, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_batch == 0 || t_q == 0) return 0;
  const BwdStrides st = unpack(strides);
  if (!operands_aligned(q, k, v, o, dout, strides, sizeof(T)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* dqt = static_cast<T*>(dq);
  switch (d) {
    case 32:
      return launch_dq<32, T>(BWD_INPUTS, dqt, n_batch, n_head, t_q, t_k,
                              st, scale, causal, q_off, k_off, s);
    case 64:
      return launch_dq<64, T>(BWD_INPUTS, dqt, n_batch, n_head, t_q, t_k,
                              st, scale, causal, q_off, k_off, s);
    case 128:
      return launch_dq<128, T>(BWD_INPUTS, dqt, n_batch, n_head, t_q, t_k,
                               st, scale, causal, q_off, k_off, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define DKV_ARGS                                                           \
  q, k, v, o, dout, lse, dlse, bias, dk, dv, dbias, n_batch, n_head, d,    \
      t_q, t_k, strides, scale, causal, q_off, k_off, device, stream
#define DQ_ARGS                                                            \
  q, k, v, o, dout, lse, dlse, bias, dq, n_batch, n_head, d, t_q, t_k,     \
      strides, scale, causal, q_off, k_off, device, stream

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
  return dkv_entry<float>(DKV_ARGS);
}

// dQ.  Same arguments as the dK/dV entry point, without the outputs it
// writes.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* dlse, const void* bias,
    void* dq, int n_batch, int n_head, int d, int t_q, int t_k,
    const int64_t* strides, float scale, int causal, int q_off, int k_off,
    int device, void* stream) {
  return dq_entry<float>(DQ_ARGS);
}

// The bf16 paths: q, k, v, o, dO, dK, dV and dQ bf16 (rows 16-byte
// aligned: strides multiples of 8 values); lse, dlse, the bias and the
// bias gradient float32.  Same arguments as the float32 entry points.
extern "C" int flash_attention_bwd_dkv_bf16_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* dlse, const void* bias,
    void* dk, void* dv, void* dbias, int n_batch, int n_head, int d,
    int t_q, int t_k, const int64_t* strides, float scale, int causal,
    int q_off, int k_off, int device, void* stream) {
  return dkv_entry<__nv_bfloat16>(DKV_ARGS);
}

extern "C" int flash_attention_bwd_dq_bf16_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* dlse, const void* bias,
    void* dq, int n_batch, int n_head, int d, int t_q, int t_k,
    const int64_t* strides, float scale, int causal, int q_off, int k_off,
    int device, void* stream) {
  return dq_entry<__nv_bfloat16>(DQ_ARGS);
}
