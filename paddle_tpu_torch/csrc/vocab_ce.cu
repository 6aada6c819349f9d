// Fused vocabulary projection + label-smoothed softmax cross-entropy for
// Hopper (sm_90a): the forward, dh and dW kernels.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/vocab_ce.py:
// _fwd_kernel (:146, called from _fwd at :274), _bwd_dh_kernel (:204,
// called at :311) and _bwd_dw_kernel (:235, called at :326), the
// custom-VJP pair behind fused_vocab_ce.  For N tokens h (N, D), the
// projection W (D, V) and int32 labels (a label outside [0, V) matches
// no column), with z = h W:
//
//   forward:  lse_t = logsumexp_v z_tv,  z_label_t = z_t,label_t,
//             z_sum_t = sum_v z_tv
//             (loss_t = lse_t - (1-eps) z_label_t - (eps/V) z_sum_t,
//             formed by the caller)
//   backward: dz_tv = g_t (exp(z_tv - lse_t) - (1-eps) [v == label_t]
//                          - eps/V)
//             dh = dz W^T,  dW = h^T dz
//
// z is never written to device memory: each kernel recomputes its tiles
// of z from h and W and reduces them in registers.
//
// Design.  256 threads (8 warps) per block, one block per SM; every
// kernel has one resident 64-row tile of an operand in shared memory and
// streams the other operand through K-slices.
//
// Forward (the tensor cores, as the backward below): a block owns 64
// tokens, whose h rows stay resident in shared memory for the whole
// launch ([t][d], pitch 512, swizzled as the dW kernel's resident tile),
// and streams W through the same 3-stage cp.async ring of 32-deep K-slices
// in 128-column tiles ([k][col], pitch 136 = 8 mod 32), one continuous
// stream of slices across the vocabulary so that no tile waits for its
// first slice (the Pallas grid's sequential vocab axis becomes this loop).
// W is read once per token tile, h once in all.  A tile of z (64 tokens x
// 128 columns) is 64 m16n8 tiles, 8 a warp (32 tokens x 32 columns).  Each
// z element is formed exactly as the dh kernel recomputes it: h is the A
// operand and W the B operand, each 32-deep slice summed in one tensor-
// core accumulator (the small-big, big-small, big-big passes per 8-deep
// step) and added to z in float32 slice after slice, so the lse the
// backward reads and the z it recomputes come from the same bits.  On the
// C fragments each lane keeps, for its 4 token rows and its 8 columns of
// every tile, a running max, sum of exponentials, sum of logits and the
// label logit; at the end the 4 lanes of a quad merge by xor-shuffles and
// the 4 column warps of a token through shared memory, in a fixed order,
// so two runs give the same bits.  64-token tiles give 256 blocks at
// N = 16384 (two waves on 132 SMs).
//
// Backward (dh and dW, one body): the tensor cores, through
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, made float32-
// accurate by 3xTF32: each operand x is split in registers, as it is
// loaded from shared memory (dz once, as it is formed), into
// big = x rounded to TF32 and
// small = x - big, and acc += a_small b_big + a_big b_small + a_big b_big
// (small terms first; a_small b_small, below 2^-22 of the product, is
// dropped); each pass is issued over all of a warp's independent tiles
// before the next, so consecutive mma do not wait on one another.  One
// TF32 pass would round both operands at 2^-11 and miss
// chip_smoke's 2e-5 through exp(z - lse); 3xTF32 errs by about 2^-21 a
// product (tests/test_torch_vocab_ce.py emulates both on the CPU).
//  - dh: a block owns 64 tokens (256 blocks at N = 16384) and walks the
//    vocabulary in 64-column tiles; per tile W[:, tile] is resident (as
//    it lies in memory, [d][v], pitch 64) and h[owned] is streamed.
//  - dW: a block owns 64 vocabulary columns (500 blocks at V = 32000) and
//    walks the tokens in 64-row tiles; per tile h[tile] is resident
//    ([t][d], pitch 512) and W[:, owned] is streamed.  Each block owns
//    its dW columns over all tokens: no second pass, no atomics, so two
//    runs give the same bits.
//  Per tile: z (64 owners x 64 inner, K = D) = 32 m16n8 tiles, 4 a warp
//  (16 owners x 32 inner); dz is formed in the z fragment's registers
//  (each lane holds rows g, g + 8 and columns 2t, 2t + 1, so lse, g and
//  the label come from per-row registers or the staged per-token stats),
//  split once and stored to shared memory as two planes, big and small,
//  [owner][inner] (pitch 68); then acc (64 owners x 512) += dz R over the
//  64 inner, 256 m16n8 tiles, 32 a warp (32 owners x 128 columns), 128
//  accumulators a thread held across all tiles.
//  The tensor core does not round its float32 accumulation to nearest:
//  the probe's 3xTF32 sum over K = 512 erred by 2.4e-4 where the CPU's
//  float32 product erred by 2.3e-5 (NVIDIA H100 80GB HBM3, 700 W), and
//  dh sums over 32000 terms.  So an accumulator of the tensor core only
//  ever holds one K-slice of z (12 mma) or one tile's product for a
//  group of 4 n-tiles (24 mma); each such partial sum is added to the
//  float32 registers of z or acc with an ordinary, rounded addition.  The m16n8k8 .tf32 fragments (PTX ISA, "Matrix
//  Fragments for mma.m16n8k8"; g = lane >> 2, t = lane & 3), checked on
//  the H100 with a one-warp probe against a float64 product before this
//  kernel was written:
//    A (16 x 8, row):  a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//    B (8 x 8, col):   b0 (k = t, n = g), b1 (k = t+4, n = g)
//    C (16 x 8):       c0, c1 (g, 2t / 2t+1), c2, c3 (g+8, 2t / 2t+1)
//  Shared memory without bank conflicts: an A fragment read from a
//  [row][k] array hits banks 4g + t when the pitch is 4 mod 32 (the h
//  slice, 36, and dz, 68), and a [k][row] array needs 8 mod 32 (the W
//  slice, 72).  The resident tile is read in both orientations (as B of
//  the z recompute with k = depth, as B of the product with k = inner),
//  so no pitch serves it: its column index is XOR-swizzled with the row
//  (row bits 0, 1, 2 to column bits 3, 4, 2), which makes both reads,
//  8 rows x 4 columns and 4 rows x 8 columns, hit 32 distinct banks and
//  keeps 16-byte chunks whole.
//  Copies: cp.async.cg (16 bytes) into a 3-stage ring of 32-deep
//  K-slices; each slice's group carries the streamed slice and the
//  resident tile's matching 32 depths, so the z recompute starts on the
//  first depths while the rest land (the resident tile cannot be double
//  buffered in 227 KB: the next tile's copies wait for this tile's
//  product).  Where D or V is not a multiple of 4 a row does not start
//  16-byte aligned, and 4-byte copies stage the same tiles.  Tokens >= N,
//  columns >= V and depths >= D are zero-filled by the copies (depths
//  past the last slice are zeroed once), and invalid columns get dz = 0,
//  so undefined memory never meets an accumulator (the 0 * NaN
//  poisoning the Pallas kernel guards against at vocab_ce.py:220-225
//  and :251-255).
//
// What bounds them on the H100 (3.35 TB/s): operations.  At N = 16384
// tokens (bench, 64 x 256, and long context, 2 x 8192), D = 512,
// V = 32000: forward 2NDV = 0.54 TFLOP, 8.0 ms at the float32 peak of
// 67 TFLOP/s, or 3 x 2NDV TF32 operations = 3.25 ms at the 495 TFLOP/s
// TF32 tensor-core peak, which only wgmma reaches; dh and dW each
// 4NDV = 1.07 TFLOP with the recompute, 16.0 ms in float32, or
// 3 x 4NDV TF32 operations = 6.51 ms on the tensor cores; the bytes
// (h 34 MB, W 66 MB) are under 0.1 ms.  wgmma with TMA, whose tf32
// operands must be K-major in shared memory (W in the recompute and h in
// dW are not), is the next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows of the resident tile, of z tiles
constexpr int kMaxD = 512;         // D is held whole
constexpr float kNeg = -1e30f;     // the reference's NEG

// ---- shared by the three kernels ------------------------------------------

constexpr int kBK = 32;                 // depth of a streamed K-slice
constexpr int kStages = 3;                 // cp.async ring of K-slices
constexpr int kPitchHS = kBK + 4;       // h slice as [row][k]: 36 = 4 mod 32
constexpr int kPitchWS = kTile + 8;        // W slice as [k][col]: 72 = 8 mod 32
constexpr int kStageFloats = kTile * kPitchHS;
static_assert(kTile * kPitchHS == kBK * kPitchWS, "one stage size");
constexpr int kDzPitch = kTile + 4;        // dz as [owner][inner]: 68 = 4 mod 32
constexpr int kResFloats = kTile * kMaxD;
constexpr size_t kBwdSmem =
    (static_cast<size_t>(kResFloats) + kStages * kStageFloats +
     2 * kTile * kDzPitch + 3 * kTile) * sizeof(float);

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

// 4 bytes, or zeros when !ok: rows that do not start 16-byte aligned
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// XOR swizzle of a resident row's 32-float bank group: row bits 0, 1 and 2
// go to column bits 3, 4 and 2.  It keeps 4-float chunks whole and makes
// both fragment reads of the tile conflict-free (see the design notes).
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }

// Resident element (inner row i, depth k): dh keeps W[:, tile] as [k][i]
// (pitch 64), dW keeps h[tile] as [i][k] (pitch 512), as they lie in
// memory, so 16-byte copies land whole.
template <bool DH>
__device__ __forceinline__ int res_at(int i, int k) {
  return DH ? k * kTile + (i ^ swz(k)) : i * kMaxD + (k ^ swz(i));
}

// Streamed element (owner row o, depth k within the slice): dh streams h
// rows as [o][k], dW streams W columns as [k][o].
template <bool DH>
__device__ __forceinline__ int slice_at(int o, int k) {
  return DH ? o * kPitchHS + k : k * kPitchWS + o;
}

// Issue the copies of K-slice kb..kb+31 of one inner tile: the streamed
// operand's slice into `stage` and the resident operand's depths into
// `res`.  The h-like operand (rows of h, contiguous in k) is 64 rows x 32
// depths, the W-like one (columns of W, contiguous in the column) 32
// depths x 64 columns: 512 four-float chunks each, two a thread.
// Outside the operands (token >= n, column >= v, depth >= d) the copies
// write zeros.
template <bool DH, bool VEC>
__device__ __forceinline__ void issue_slice(const float* __restrict__ h,
                                            const float* __restrict__ w,
                                            int n, int d, int v, int o0,
                                            int i0, int kb, float* res,
                                            float* stage) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int c = threadIdx.x + q * kThreads;
    {  // h-like: dh's streamed owner rows, dW's resident inner rows
      const int r = c >> 3, k = (c & 7) * 4;
      const int tok = (DH ? o0 : i0) + r;
      float* dst = DH ? stage + slice_at<true>(r, k)
                      : res + res_at<false>(r, kb + k);
      const float* src = h + static_cast<int64_t>(tok) * d + kb + k;
      if (VEC) {
        const bool ok = tok < n && kb + k < d;
        cp16(dst, ok ? src : h, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = tok < n && kb + k + e < d;
          cp4(dst + e, ok ? src + e : h, ok);
        }
      }
    }
    {  // W-like: dh's resident inner columns, dW's streamed owner columns
      const int k = c >> 4, cc = (c & 15) * 4;
      const int col = (DH ? i0 : o0) + cc;
      float* dst = DH ? res + res_at<true>(cc, kb + k)
                      : stage + slice_at<false>(cc, k);
      const float* src = w + static_cast<int64_t>(kb + k) * v + col;
      if (VEC) {
        const bool ok = kb + k < d && col < v;
        cp16(dst, ok ? src : w, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = kb + k < d && col + e < v;
          cp4(dst + e, ok ? src + e : w, ok);
        }
      }
    }
  }
}

// ---- forward: lse, z_label, z_sum on the tensor cores (3xTF32) --------

constexpr int kFwdCols = 128;              // vocabulary columns of a z tile
constexpr int kPitchFS = kFwdCols + 8;     // W slice [k][col]: 136 = 8 mod 32
constexpr int kFwdStageFloats = kBK * kPitchFS;
constexpr size_t kFwdSmem =
    (static_cast<size_t>(kResFloats) + kStages * kFwdStageFloats +
     4 * 4 * kTile) * sizeof(float);

// Issue the copies of K-slice kb..kb+31 of W[:, v0:v0+128] into `stage`
// ([k][col]): 1024 four-float chunks, four a thread; zeros past d and v.
template <bool VEC>
__device__ __forceinline__ void issue_fwd_slice(const float* __restrict__ w,
                                                int d, int v, int v0, int kb,
                                                float* stage) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = threadIdx.x + q * kThreads;
    const int k = c >> 5, cc = (c & 31) * 4;
    const int col = v0 + cc;
    float* dst = stage + k * kPitchFS + cc;
    const float* src = w + static_cast<int64_t>(kb + k) * v + col;
    if (VEC) {
      const bool ok = kb + k < d && col < v;
      cp16(dst, ok ? src : w, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = kb + k < d && col + e < v;
        cp4(dst + e, ok ? src + e : w, ok);
      }
    }
  }
}

// Fold z (one row, the lane's 8 columns of a tile; only `valid` ones) into
// the running state: max m, sum of exponentials s, sum of logits zs and
// the label logit zl.
__device__ __forceinline__ void fold_row(const float (&z)[8],
                                         const int (&col)[8], int v, int lbl,
                                         float& m, float& s, float& zs,
                                         float& zl) {
  float mx = m;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (col[e] < v) mx = fmaxf(mx, z[e]);
  float sum = s * expf(m - mx);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (col[e] < v) {
      sum += expf(z[e] - mx);
      zs += z[e];
      if (col[e] == lbl) zl = z[e];
    }
  }
  m = mx;
  s = sum;
}

// (m, s, zs, zl) merged with another partial state of the same token.
__device__ __forceinline__ void merge_state(float& m, float& s, float& zs,
                                            float& zl, float m2, float s2,
                                            float zs2, float zl2) {
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
  zs += zs2;
  zl = fmaxf(zl, zl2);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
vocab_ce_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ lse,
                    float* __restrict__ z_label, float* __restrict__ z_sum,
                    int n, int d, int v) {
  extern __shared__ float smem[];
  float* res = smem;                          // the block's h rows
  float* ring = res + kResFloats;          // W K-slices
  float* merge = ring + kStages * kFwdStageFloats;   // [4 stats][4 cw][64]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;    // fragment row / column
  const int rw = warp & 1, cw = warp >> 1;    // 32 tokens x 32 columns
  const int o0 = blockIdx.x * kTile;
  const int ns = (d + kBK - 1) / kBK;
  const int kd = ns * kBK;                 // staged depths, zero past d
  // the resident h rows, in a group of their own ahead of the slices
  for (int c = tid; c < kTile * (kd / 4); c += kThreads) {
    const int r = c / (kd / 4), k = (c % (kd / 4)) * 4;
    const int tok = o0 + r;
    float* dst = res + res_at<false>(r, k);
    const float* src = h + static_cast<int64_t>(tok) * d + k;
    if (VEC) {
      const bool ok = tok < n && k < d;
      cp16(dst, ok ? src : h, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = tok < n && k + e < d;
        cp4(dst + e, ok ? src + e : h, ok);
      }
    }
  }
  cp_commit();
  const int n_slices = (v + kFwdCols - 1) / kFwdCols * ns;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slices)
      issue_fwd_slice<VEC>(w, d, v, (s / ns) * kFwdCols, (s % ns) * kBK,
                           ring + s * kFwdStageFloats);
    cp_commit();
  }
  // the lane's 4 token rows: (m, h2) -> rw*32 + m*16 + gq + 8*h2
  int lbl[4];
  float st_m[4], st_s[4], st_zs[4], st_zl[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = o0 + rw * 32 + (r >> 1) * 16 + gq + 8 * (r & 1);
    lbl[r] = t < n ? labels[t] : -1;
    st_m[r] = kNeg;
    st_s[r] = 0.f;
    st_zs[r] = 0.f;
    st_zl[r] = kNeg;
  }
  float zf[2][4][4];
  for (int s = 0; s < n_slices; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();    // slice s is in; slice s-1's stage is free
    const int sn = s + kStages - 1;
    if (sn < n_slices)
      issue_fwd_slice<VEC>(w, d, v, (sn / ns) * kFwdCols, (sn % ns) * kBK,
                           ring + (sn % kStages) * kFwdStageFloats);
    cp_commit();
    const int j = s % ns;
    if (j == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2)
#pragma unroll
          for (int r = 0; r < 4; ++r) zf[m][j2][r] = 0.f;
    }
    const float* st = ring + (s % kStages) * kFwdStageFloats;
    const int kb = j * kBK;
    float zp[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2)
#pragma unroll
        for (int r = 0; r < 4; ++r) zp[m][j2][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int orow = rw * 32 + m * 16 + gq;
        split(res[res_at<false>(orow, kb + kk + tq)], ab[m][0], as[m][0]);
        split(res[res_at<false>(orow + 8, kb + kk + tq)], ab[m][1],
              as[m][1]);
        split(res[res_at<false>(orow, kb + kk + tq + 4)], ab[m][2],
              as[m][2]);
        split(res[res_at<false>(orow + 8, kb + kk + tq + 4)], ab[m][3],
              as[m][3]);
      }
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        const int col = cw * 32 + j2 * 8 + gq;
        split(st[(kk + tq) * kPitchFS + col], bb[j2][0], bs[j2][0]);
        split(st[(kk + tq + 4) * kPitchFS + col], bb[j2][1], bs[j2][1]);
      }
      // 3xTF32 in the dh kernel's order, pass by pass over 8 tiles
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2)
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_tf32(zp[m][j2], as[m], bb[j2]);
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2)
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_tf32(zp[m][j2], ab[m], bs[j2]);
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2)
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_tf32(zp[m][j2], ab[m], bb[j2]);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2)
#pragma unroll
        for (int r = 0; r < 4; ++r) zf[m][j2][r] += zp[m][j2][r];
    if (j != ns - 1) continue;
    // the tile is whole: fold it into the lane's running states
    const int v0 = (s / ns) * kFwdCols;
    int col[8];
#pragma unroll
    for (int j2 = 0; j2 < 4; ++j2)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        col[j2 * 2 + e] = v0 + cw * 32 + j2 * 8 + 2 * tq + e;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float z[8];
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          z[j2 * 2 + e] = zf[r >> 1][j2][2 * (r & 1) + e];
      fold_row(z, col, v, lbl[r], st_m[r], st_s[r], st_zs[r], st_zl[r]);
    }
  }
  // merge the 4 lanes of each quad (xor-shuffles: every lane ends with the
  // same bits), then the 4 column warps of each token in order
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1)
      merge_state(st_m[r], st_s[r], st_zs[r], st_zl[r],
                  __shfl_xor_sync(0xffffffffu, st_m[r], x),
                  __shfl_xor_sync(0xffffffffu, st_s[r], x),
                  __shfl_xor_sync(0xffffffffu, st_zs[r], x),
                  __shfl_xor_sync(0xffffffffu, st_zl[r], x));
    if (tq == 0) {
      const int row = rw * 32 + (r >> 1) * 16 + gq + 8 * (r & 1);
      merge[(0 * 4 + cw) * kTile + row] = st_m[r];
      merge[(1 * 4 + cw) * kTile + row] = st_s[r];
      merge[(2 * 4 + cw) * kTile + row] = st_zs[r];
      merge[(3 * 4 + cw) * kTile + row] = st_zl[r];
    }
  }
  __syncthreads();
  if (tid < kTile && o0 + tid < n) {
    float m = merge[tid], s = merge[4 * kTile + tid];
    float zs = merge[8 * kTile + tid], zl = merge[12 * kTile + tid];
    for (int c = 1; c < 4; ++c)
      merge_state(m, s, zs, zl, merge[c * kTile + tid],
                  merge[(4 + c) * kTile + tid], merge[(8 + c) * kTile + tid],
                  merge[(12 + c) * kTile + tid]);
    const int t = o0 + tid;
    lse[t] = m + logf(s);
    z_label[t] = zl;
    z_sum[t] = zs;
  }
}

// The dh (DH = true) and dW (DH = false) kernels: see the design notes.
template <bool DH, bool VEC>
__device__ __forceinline__ void bwd_body(
    const float* __restrict__ h, const float* __restrict__ w,
    const int* __restrict__ labels, const float* __restrict__ lse,
    const float* __restrict__ g, float* __restrict__ out, int n, int d,
    int v, float eps) {
  extern __shared__ float smem[];
  float* res = smem;                          // resident inner tile
  float* ring = res + kResFloats;          // streamed K-slices
  uint32_t* dzb = reinterpret_cast<uint32_t*>(ring + kStages * kStageFloats);
  uint32_t* dzs = dzb + kTile * kDzPitch;     // dz split, [owner][inner]
  float* sstat = reinterpret_cast<float*>(dzs + kTile * kDzPitch);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;    // fragment row / column
  const int mw = warp & 3, nh = warp >> 2;    // z: 16 owners x 32 inner
  const int mh = warp & 1, dq = warp >> 1;    // acc: 32 owners x 128 cols
  const int o0 = blockIdx.x * kTile;          // first owned token / column
  const float keep = 1.f - eps, spread = eps / v;
  // depths past the last slice are never staged: zero them once
  for (int idx = tid; idx < kResFloats; idx += kThreads) res[idx] = 0.f;
  __syncthreads();
  // dh: the stats of the owned tokens in this thread's z rows
  float o_lse[2] = {0.f, 0.f}, o_g[2] = {0.f, 0.f};
  int o_lbl[2] = {-1, -1};
  if (DH) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = o0 + mw * 16 + gq + 8 * r;
      if (t < n) {
        o_lse[r] = lse[t];
        o_g[r] = g[t];
        o_lbl[r] = labels[t];
      }
    }
  }
  // this warp's 32 owners x 128 output columns: 2 x 16 m16n8 tiles
  float acc[2][16][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][nt][r] = 0.f;
  const int ns = (d + kBK - 1) / kBK;
  const int n_inner = DH ? v : n;

  for (int i0 = 0; i0 < n_inner; i0 += kTile) {
    if (!DH && tid < 3 * kTile) {   // joins slice 0's group
      const int t = i0 + tid % kTile, which = tid / kTile;
      const void* src = which == 0   ? static_cast<const void*>(lse + t)
                        : which == 1 ? static_cast<const void*>(g + t)
                                     : static_cast<const void*>(labels + t);
      cp4(sstat + tid, t < n ? src : lse, t < n);
    }
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < ns)
        issue_slice<DH, VEC>(h, w, n, d, v, o0, i0, s * kBK, res,
                             ring + s * kStageFloats);
      cp_commit();
    }
    // z (64 owners x 64 inner) = S R^T over the depth, this warp's 16 x 32;
    // each slice's sum is added to z in float32
    float zf[4][4];
#pragma unroll
    for (int j2 = 0; j2 < 4; ++j2)
#pragma unroll
      for (int r = 0; r < 4; ++r) zf[j2][r] = 0.f;
    for (int j = 0; j < ns; ++j) {
      cp_wait<kStages - 2>();
      __syncthreads();    // slice j is in; slice j-1's stage is free
      const int jn = j + kStages - 1;
      if (jn < ns)
        issue_slice<DH, VEC>(h, w, n, d, v, o0, i0, jn * kBK, res,
                             ring + (jn % kStages) * kStageFloats);
      cp_commit();
      const float* st = ring + (j % kStages) * kStageFloats;
      const int kb = j * kBK;
      float zp[4][4];
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2)
#pragma unroll
        for (int r = 0; r < 4; ++r) zp[j2][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        const int orow = mw * 16 + gq;
        uint32_t ab[4], as[4];
        split(st[slice_at<DH>(orow, kk + tq)], ab[0], as[0]);
        split(st[slice_at<DH>(orow + 8, kk + tq)], ab[1], as[1]);
        split(st[slice_at<DH>(orow, kk + tq + 4)], ab[2], as[2]);
        split(st[slice_at<DH>(orow + 8, kk + tq + 4)], ab[3], as[3]);
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) {
          const int ni = nh * 32 + j2 * 8 + gq;
          split(res[res_at<DH>(ni, kb + kk + tq)], bb[j2][0], bs[j2][0]);
          split(res[res_at<DH>(ni, kb + kk + tq + 4)], bb[j2][1],
                bs[j2][1]);
        }
        // 3xTF32, pass by pass over the 4 independent tiles
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) mma_tf32(zp[j2], as, bb[j2]);
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) mma_tf32(zp[j2], ab, bs[j2]);
#pragma unroll
        for (int j2 = 0; j2 < 4; ++j2) mma_tf32(zp[j2], ab, bb[j2]);
      }
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2)
#pragma unroll
        for (int r = 0; r < 4; ++r) zf[j2][r] += zp[j2][r];
    }
    // dz in the z fragment's registers (rows gq, gq + 8; columns 2tq,
    // 2tq + 1 of each n-tile), split once and stored as two planes
#pragma unroll
    for (int j2 = 0; j2 < 4; ++j2) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int o = mw * 16 + gq + 8 * h2;
        const int i = nh * 32 + j2 * 8 + 2 * tq;
        uint32_t big[2], small[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = DH ? i0 + i + e : o0 + o;     // vocabulary
          const float t_lse = DH ? o_lse[h2] : sstat[i + e];
          const float t_g = DH ? o_g[h2] : sstat[kTile + i + e];
          const int t_lbl =
              DH ? o_lbl[h2] : __float_as_int(sstat[2 * kTile + i + e]);
          const bool valid = col < v;
          const float p = valid ? expf(zf[j2][2 * h2 + e] - t_lse) : 0.f;
          split(t_g * (p - (col == t_lbl ? keep : 0.f) -
                       (valid ? spread : 0.f)),
                big[e], small[e]);
        }
        *reinterpret_cast<uint2*>(&dzb[o * kDzPitch + i]) =
            make_uint2(big[0], big[1]);
        *reinterpret_cast<uint2*>(&dzs[o * kDzPitch + i]) =
            make_uint2(small[0], small[1]);
      }
    }
    __syncthreads();
    // acc += dz R over the 64 inner, in groups of 4 n-tiles (32 columns):
    // each group's sum over the tile is added to acc in float32
#pragma unroll
    for (int ng = 0; ng < 4; ++ng) {
      if (dq * 128 + ng * 32 >= d) continue;   // columns past D
      float part[2][4][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int r = 0; r < 4; ++r) part[m][nn][r] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < kTile; ks += 8) {
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int at = (mh * 32 + m * 16 + gq) * kDzPitch + ks + tq;
          ab[m][0] = dzb[at];
          ab[m][1] = dzb[at + 8 * kDzPitch];
          ab[m][2] = dzb[at + 4];
          ab[m][3] = dzb[at + 8 * kDzPitch + 4];
          as[m][0] = dzs[at];
          as[m][1] = dzs[at + 8 * kDzPitch];
          as[m][2] = dzs[at + 4];
          as[m][3] = dzs[at + 8 * kDzPitch + 4];
        }
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const int dc = dq * 128 + ng * 32 + nn * 8 + gq;
          split(res[res_at<DH>(ks + tq, dc)], bb[nn][0], bs[nn][0]);
          split(res[res_at<DH>(ks + tq + 4, dc)], bb[nn][1], bs[nn][1]);
        }
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_tf32(part[m][nn], as[m], bb[nn]);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_tf32(part[m][nn], ab[m], bs[nn]);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_tf32(part[m][nn], ab[m], bb[nn]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][ng * 4 + nn][r] += part[m][nn][r];
    }
    __syncthreads();      // the next tile's copies overwrite res
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int o = o0 + mh * 32 + m * 16 + gq + 8 * (r >> 1);
        const int dc = dq * 128 + nt * 8 + 2 * tq + (r & 1);
        if (dc >= d) continue;
        if (DH) {
          if (o < n) out[static_cast<int64_t>(o) * d + dc] = acc[m][nt][r];
        } else {
          if (o < v) out[static_cast<int64_t>(dc) * v + o] = acc[m][nt][r];
        }
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
vocab_ce_dh_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   const int* __restrict__ labels,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   float* __restrict__ dh, int n, int d, int v, float eps) {
  bwd_body<true, VEC>(h, w, labels, lse, g, dh, n, d, v, eps);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
vocab_ce_dw_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   const int* __restrict__ labels,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   float* __restrict__ dw, int n, int d, int v, float eps) {
  bwd_body<false, VEC>(h, w, labels, lse, g, dw, n, d, v, eps);
}

using BwdKernel = void (*)(const float*, const float*, const int*,
                           const float*, const float*, float*, int, int, int,
                           float);

// 16-byte copies where every row of h and W starts 16-byte aligned, else
// 4-byte copies.
bool vectorised(const void* h, const void* w, int d, int v) {
  return d % 4 == 0 && v % 4 == 0 &&
         reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

// One backward launch.
int bwd_launch(bool dh_kernel, const void* h, const void* w,
               const void* labels, const void* lse, const void* g, void* out,
               int n, int d, int v, float eps, void* stream) {
  const bool vec = vectorised(h, w, d, v);
  const BwdKernel k =
      dh_kernel
          ? (vec ? &vocab_ce_dh_kernel<true> : &vocab_ce_dh_kernel<false>)
          : (vec ? &vocab_ce_dw_kernel<true> : &vocab_ce_dw_kernel<false>);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBwdSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = ((dh_kernel ? n : v) + kTile - 1) / kTile;
  k<<<blocks, kThreads, kBwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<float*>(out), n, d, v, eps);
  return static_cast<int>(cudaGetLastError());
}

int check_dims(int n, int d, int v) {
  if (n < 0 || d < 1 || d > kMaxD || v < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// h (n, d) and w (d, v) row-major float32, labels (n,) int32 in [0, v),
// d <= 512.  Outputs (n,) float32.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int vocab_ce_fwd_launch(const void* h, const void* w,
                                   const void* labels, void* lse,
                                   void* z_label, void* z_sum, int n, int d,
                                   int v, int device, void* stream) {
  int rc = check_dims(n, d, v);
  if (rc) return rc;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  using FwdKernel = void (*)(const float*, const float*, const int*, float*,
                             float*, float*, int, int, int);
  const FwdKernel k = vectorised(h, w, d, v) ? &vocab_ce_fwd_kernel<true>
                                             : &vocab_ce_fwd_kernel<false>;
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kFwdSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  k<<<(n + kTile - 1) / kTile, kThreads, kFwdSmem,
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const int*>(labels), static_cast<float*>(lse),
      static_cast<float*>(z_label), static_cast<float*>(z_sum), n, d, v);
  return static_cast<int>(cudaGetLastError());
}

// As the forward, plus lse and the loss cotangent g, (n,) float32; dh is
// (n, d) float32.
extern "C" int vocab_ce_dh_launch(const void* h, const void* w,
                                  const void* labels, const void* lse,
                                  const void* g, void* dh, int n, int d,
                                  int v, float eps, int device,
                                  void* stream) {
  int rc = check_dims(n, d, v);
  if (rc) return rc;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  return bwd_launch(true, h, w, labels, lse, g, dh, n, d, v, eps, stream);
}

// As dh; dw is (d, v) float32.  With n == 0 the caller zero-fills dw.
extern "C" int vocab_ce_dw_launch(const void* h, const void* w,
                                  const void* labels, const void* lse,
                                  const void* g, void* dw, int n, int d,
                                  int v, float eps, int device,
                                  void* stream) {
  int rc = check_dims(n, d, v);
  if (rc) return rc;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  return bwd_launch(false, h, w, labels, lse, g, dw, n, d, v, eps, stream);
}
