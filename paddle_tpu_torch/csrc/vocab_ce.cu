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
// Forward (float32 on the CUDA cores): a block owns 64 tokens (resident:
// their h rows, 64 x 512 at a pitch of 513 floats) and walks the
// vocabulary in 64-column tiles (streamed: W, 16-deep slices prefetched
// through registers), computing each 64 x 64 tile of z with a 4 x 4
// micro-tile per thread and keeping per thread and token a running max,
// sum of exponentials, sum of logits and the label logit (the Pallas
// grid's sequential vocab axis becomes this loop).  The 16 partial states
// of a token are merged through shared memory at the end; the TPU's
// 8-sublane replication of the stats is a TPU layout device and is not
// carried over.  64-token tiles give 256 blocks at N = 16384 (two waves
// on 132 SMs), where 128-token tiles would leave 4 SMs idle in one wave.
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
// 67 TFLOP/s; dh and dW each 4NDV = 1.07 TFLOP with the recompute,
// 16.0 ms in float32, or 3 x 4NDV TF32 operations = 6.51 ms at the
// 495 TFLOP/s TF32 tensor-core peak, which only wgmma reaches; the bytes
// (h 34 MB, W 66 MB) are under 0.1 ms.  wgmma with TMA, whose tf32
// operands must be K-major in shared memory (W in the recompute and h in
// dW are not), is the next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows of the resident tile, of z tiles
constexpr int kBK = 16;            // depth of a streamed K-slice
constexpr int kAP = kTile + 4;     // pitch of the forward's W slice
constexpr int kMaxD = 512;         // D is held whole
constexpr int kRP = kMaxD + 1;     // pitch of the resident tile
constexpr float kNeg = -1e30f;     // the reference's NEG

constexpr size_t kResFloats = static_cast<size_t>(kTile) * kRP;
constexpr size_t kSliceFloats = static_cast<size_t>(kBK) * kAP;
constexpr size_t kFwdSmem =
    (kResFloats + kSliceFloats + 4 * 16 * kTile) * sizeof(float);

// The forward's streamed operand, W[:, v0:v0+64]: element (k, m),
// k < D, m < 64, at base[k * sk + m]; zero outside k < kmax, m < mmax.
struct Streamed {
  const float* base;
  int64_t sk;
  int kmax, mmax;
};

__device__ __forceinline__ void load_slice(const Streamed& a, int k0,
                                           float (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int k = k0 + idx / kTile, m = idx % kTile;
    r[i] = (k < a.kmax && m < a.mmax) ? a.base[k * a.sk + m] : 0.f;
  }
}

__device__ __forceinline__ void store_slice(float* as, const float (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    as[(idx / kTile) * kAP + idx % kTile] = r[i];
  }
}

// res[r][c] (r < 64, c < 512) = base[r * sr + c], zero outside r < rmax,
// c < cmax (the forward's h rows).  Threads walk c, so the global reads
// are coalesced; at pitch 513 a warp's writes hit distinct banks.
__device__ __forceinline__ void load_res(float* res, const float* base,
                                         int64_t sr, int rmax, int cmax) {
#pragma unroll 8
  for (int idx = threadIdx.x; idx < kTile * kMaxD; idx += kThreads) {
    const int r = idx / kMaxD, c = idx % kMaxD;
    res[r * kRP + c] = (r < rmax && c < cmax) ? base[r * sr + c] : 0.f;
  }
}

// z[i][j] = sum_{k < d} A(k, ty*4 + i) * res[tx + 16*j][k], with A
// streamed through `as`.  Starts with a barrier, so whatever was written
// into `res` or `as` before the call is visible, and reads of `as` from
// before the call are finished.
__device__ __forceinline__ void z_tile(const Streamed& a, float* as,
                                       const float* res, int d,
                                       float (&z)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) z[i][j] = 0.f;
  float r[4];
  load_slice(a, 0, r);
  for (int k0 = 0; k0 < d; k0 += kBK) {
    __syncthreads();
    store_slice(as, r);
    __syncthreads();
    if (k0 + kBK < d) load_slice(a, k0 + kBK, r);   // in flight meanwhile
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av =
          *reinterpret_cast<const float4*>(&as[kk * kAP + ty * 4]);
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = res[(tx + 16 * j) * kRP + k0 + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        z[0][j] = fmaf(av.x, b[j], z[0][j]);
        z[1][j] = fmaf(av.y, b[j], z[1][j]);
        z[2][j] = fmaf(av.z, b[j], z[2][j]);
        z[3][j] = fmaf(av.w, b[j], z[3][j]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
vocab_ce_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ lse,
                    float* __restrict__ z_label, float* __restrict__ z_sum,
                    int n, int d, int v) {
  extern __shared__ float smem[];
  float* res = smem;                       // the block's h rows
  float* as = res + kResFloats;            // W slices
  float* merge = as + kSliceFloats;        // [4][16 ty][64 tokens]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int t0 = blockIdx.x * kTile;
  load_res(res, h + static_cast<int64_t>(t0) * d, d, n - t0, d);
  // this thread's partial state for tokens t0 + tx + 16j over the
  // vocabulary rows ty*4 .. ty*4+3 of every tile
  int lbl[4];
  float m[4], s[4], zs[4], zl[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = t0 + tx + 16 * j;
    lbl[j] = t < n ? labels[t] : -1;
    m[j] = kNeg;
    s[j] = 0.f;
    zs[j] = 0.f;
    zl[j] = kNeg;
  }
  for (int v0 = 0; v0 < v; v0 += kTile) {
    const Streamed a{w + v0, v, d, v - v0};
    float z[4][4];
    z_tile(a, as, res, d, z);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float mx = m[j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (v0 + ty * 4 + i < v) mx = fmaxf(mx, z[i][j]);
      float sum = s[j] * expf(m[j] - mx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = v0 + ty * 4 + i;
        if (col < v) {
          sum += expf(z[i][j] - mx);
          zs[j] += z[i][j];
          if (col == lbl[j]) zl[j] = z[i][j];
        }
      }
      m[j] = mx;
      s[j] = sum;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = tx + 16 * j;
    merge[(0 * 16 + ty) * kTile + c] = m[j];
    merge[(1 * 16 + ty) * kTile + c] = s[j];
    merge[(2 * 16 + ty) * kTile + c] = zs[j];
    merge[(3 * 16 + ty) * kTile + c] = zl[j];
  }
  __syncthreads();
  if (threadIdx.x < kTile && t0 + threadIdx.x < n) {
    const int c = threadIdx.x;
    float mx = kNeg;
    for (int y = 0; y < 16; ++y) mx = fmaxf(mx, merge[y * kTile + c]);
    float sum = 0.f, zsum = 0.f, zlab = kNeg;
    for (int y = 0; y < 16; ++y) {
      sum += merge[(16 + y) * kTile + c] * expf(merge[y * kTile + c] - mx);
      zsum += merge[(32 + y) * kTile + c];
      zlab = fmaxf(zlab, merge[(48 + y) * kTile + c]);
    }
    const int t = t0 + c;
    lse[t] = mx + logf(sum);
    z_label[t] = zlab;
    z_sum[t] = zsum;
  }
}

// ---- backward: dh and dW on the tensor cores (3xTF32 mma.sync) ----------

constexpr int kBwdBK = 32;                 // depth of a streamed K-slice
constexpr int kStages = 3;                 // cp.async ring of K-slices
constexpr int kPitchHS = kBwdBK + 4;       // h slice as [row][k]: 36 = 4 mod 32
constexpr int kPitchWS = kTile + 8;        // W slice as [k][col]: 72 = 8 mod 32
constexpr int kStageFloats = kTile * kPitchHS;
static_assert(kTile * kPitchHS == kBwdBK * kPitchWS, "one stage size");
constexpr int kDzPitch = kTile + 4;        // dz as [owner][inner]: 68 = 4 mod 32
constexpr int kBwdResFloats = kTile * kMaxD;
constexpr size_t kBwdSmem =
    (static_cast<size_t>(kBwdResFloats) + kStages * kStageFloats +
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

// The dh (DH = true) and dW (DH = false) kernels: see the design notes.
template <bool DH, bool VEC>
__device__ __forceinline__ void bwd_body(
    const float* __restrict__ h, const float* __restrict__ w,
    const int* __restrict__ labels, const float* __restrict__ lse,
    const float* __restrict__ g, float* __restrict__ out, int n, int d,
    int v, float eps) {
  extern __shared__ float smem[];
  float* res = smem;                          // resident inner tile
  float* ring = res + kBwdResFloats;          // streamed K-slices
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
  for (int idx = tid; idx < kBwdResFloats; idx += kThreads) res[idx] = 0.f;
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
  const int ns = (d + kBwdBK - 1) / kBwdBK;
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
        issue_slice<DH, VEC>(h, w, n, d, v, o0, i0, s * kBwdBK, res,
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
        issue_slice<DH, VEC>(h, w, n, d, v, o0, i0, jn * kBwdBK, res,
                             ring + (jn % kStages) * kStageFloats);
      cp_commit();
      const float* st = ring + (j % kStages) * kStageFloats;
      const int kb = j * kBwdBK;
      float zp[4][4];
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2)
#pragma unroll
        for (int r = 0; r < 4; ++r) zp[j2][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBwdBK; kk += 8) {
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

// One backward launch: 16-byte copies where every row of h and W starts
// 16-byte aligned, else 4-byte copies.
int bwd_launch(bool dh_kernel, const void* h, const void* w,
               const void* labels, const void* lse, const void* g, void* out,
               int n, int d, int v, float eps, void* stream) {
  const bool vec = d % 4 == 0 && v % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
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
  err = cudaFuncSetAttribute(vocab_ce_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kFwdSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  vocab_ce_fwd_kernel<<<(n + kTile - 1) / kTile, kThreads, kFwdSmem,
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
