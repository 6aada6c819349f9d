// Flash-attention forward kernel for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py
// _flash_fwd -> _fwd_kernel (public entry pallas_flash_attention):
//   O = softmax(scale * Q K^T + key_bias [+ causal mask]) V,  plus the
//   per-row logsumexp, without materialising the (Tq, Tk) scores in
//   device memory.
//
// Layouts.  The kernel takes batch/head/row strides, so both of the
// reference's layouts run without a transpose: "nthd" (N, T, H*D)
// head-grouped is read with row stride H*D and column offset h*D; "nhtd"
// (N, H, T, D) with row stride D and head stride T*D; a transposed view
// of either too.  The key-padding bias is (N, Tk) — one row per batch
// element, read as row g / H and never repeated per head.  O has q's
// strides; lse is (N*H, Tq) f32.
//
// What bounds it on the H100: at the training shape N=64, H=8, T=256,
// D=64 (f32) its 134 MB take 0.040 ms at 3.35 TB/s, and its two products
// (4*D flops a visible pair, 6.45 GFLOP for the mean of the causal and
// the non-causal case) 0.096 ms at the float32 CUDA-core peak of 67
// TFLOP/s or 0.039 ms as 3xTF32 work at 495 TFLOP/s; at N=2, T=8192 the
// products decide (206 GFLOP: 1.25 ms as 3xTF32).  So both products, S = Q K^T over the depth
// D and O += P V over each key tile, run on the tensor cores as 3xTF32
// mma.sync (csrc/flash_mma.cuh: the split, the fragments, the swizzle).
//
// Design.  One block per (64-query tile, batch*head), 4 warps of 16
// query rows, the block's Q tile resident in shared memory; the K and V
// tiles (64 keys, 32 at D = 128) and their bias row stream through a
// double-buffered cp.async ring, so the next tile lands while this one
// computes.  Per tile, each warp forms its 16-row score tile (C
// fragments), scales it, adds the bias, masks it, and updates the online
// softmax per row: the row max over the 4 lanes that share a fragment
// row (__shfl_xor_sync 1 and 2), alpha = exp(m_old - m_new) rescaling
// the float32 O accumulator and each lane's partial row sum l, p =
// exp(s - m_new) in place; p then enters P V as the A fragments it
// already is (the k-permutation of flash_mma.cuh), into zeroed C
// fragments added to O in float32.  l is summed over the 4 lanes once,
// at the end.  Shared memory: 81 KB a block at D = 64, 96 KB at D = 128
// (32-key tiles, so two blocks still fit an SM), 41 KB at D = 32.
//
// Numerics follow the TPU kernel: scores and softmax in f32, masked
// scores set to NEG_INF = -1e30, the normaliser clamped at 1e-30, lse =
// m + log(l), and the causal test q_off + q_pos >= k_off + k_pos
// (offsets for ring attention; 0 in prefill).  Rows past Tq or Tk are
// zero-filled by the copies and keys past Tk masked.  Under a causal
// mask, K tiles wholly above the diagonal are skipped, as the TPU kernel
// skips its k-blocks; so a row that sees no key at all (only with k_off
// > q_off) averages V over the tiles its block does not skip, as there.
// Rows whose keys all carry the -1e9 padding bias (prefill rows of slots
// that are not joining) stay finite.  Each block owns its output rows:
// no atomics, and two runs give the same bits.  The 16-byte copies need
// every row of q, k, v and o to start 16-byte aligned: the entry point
// returns cudaErrorMisalignedAddress otherwise, and the wrapper
// (ops/kernels/flash_attention.py) hands it a copy of any operand that
// is not.

// The bf16 path (flash_attention_fwd_bf16_launch; the AMP policy hands
// the flash op bf16 Q, K, V and key bias).  It follows the TPU kernel on
// bf16 operands: S = Q K^T with bf16 operands and float32 accumulation,
// scale, bias, masks and the online softmax in float32 as above, p
// rounded to bf16 before P V (the TPU kernel's p.astype(vv.dtype)), O
// accumulated in float32, divided by max(l, 1e-30) and stored bf16; lse
// float32.  The products run as bf16 mma.sync m16n8k16 (flash_mma.cuh:
// mma_bf16): a bf16 product is exact, so one pass is float32-accurate,
// at a third of 3xTF32's instructions.  Q's A fragments are loaded into
// registers once; K and V stream as bf16 tiles of 64 keys (kBf16Keys) at
// every D, twice the float32 path's 32 at D = 128, since a bf16 tile
// takes half the shared memory; the P V product takes p's C fragments
// as bf16 A fragments (pack_bf16) and V's B fragments by ldmatrix.trans.
// The bias the wrapper hands it is float32 (a bf16 bias widened
// exactly).  Shared memory: 40.5 KB a block at D = 64, 80.5 KB at
// D = 128, 20.5 KB at D = 32.  What bounds it on the H100 at the
// training shape (N=64, H=8, T=256, D=64): its 67 MB take 0.020 ms at
// 3.35 TB/s, its 6.45 GFLOP of products 0.0065 ms at the 989 TFLOP/s
// bf16 peak: bytes.  Rows of q, k, v and o must start 16-byte aligned
// (strides multiples of 8 values).

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using namespace flash;

constexpr int kBlockQ = 64;         // queries a block
constexpr int kWarps = 4;           // 16 queries a warp
static_assert(16 * kWarps == kBlockQ, "a warp owns 16 rows");
constexpr float kNegInf = -1e30f;

// keys a streamed tile
template <int D>
__host__ __device__ constexpr int fwd_keys() {
  return D > 64 ? 32 : 64;
}

template <int D>
__host__ __device__ constexpr int fwd_stage_floats() {
  return 2 * fwd_keys<D>() * D + fwd_keys<D>();     // K, V, bias row
}

// keys a streamed tile of the bf16 path
constexpr int kBf16Keys = 64;

template <int D>
constexpr size_t fwd_bf16_smem_bytes() {
  // Q (resident) + 2 x (K, V tiles) in bf16, 2 x bias row in float32
  return 2 * (kBlockQ * D + 2 * 2 * kBf16Keys * D) +
         sizeof(float) * 2 * kBf16Keys;
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  // Q (resident) + 2 x (K, V tiles, bias row)
  return sizeof(float) * (kBlockQ * D + 2 * fwd_stage_floats<D>());
}

template <int D>
__global__ void __launch_bounds__(32 * kWarps, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ bias, float* __restrict__ o,
                 float* __restrict__ lse, int n_head, int t_q, int t_k,
                 int64_t q_bs, int64_t q_hs, int64_t q_rs, int64_t kv_bs,
                 int64_t kv_hs, int64_t kv_rs, float scale, int causal,
                 int q_off, int k_off) {
  constexpr int kKeys = fwd_keys<D>();
  constexpr int kNt = kKeys / 8;                 // n-tiles of a score tile
  constexpr int kThreads = 32 * kWarps;
  constexpr int kStage = fwd_stage_floats<D>();
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // kBlockQ x D
  float* ring = qs + kBlockQ * D;                // 2 stages

  const int g = blockIdx.y;
  const int n = g / n_head;
  const int h = g % n_head;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = (tid >> 5) * 16;                // the warp's queries

  const float* kg = k + n * kv_bs + h * kv_hs;
  const float* vg = v + n * kv_bs + h * kv_hs;
  const float* bg = bias != nullptr ? bias + static_cast<int64_t>(n) * t_k
                                    : nullptr;

  // causal: K tiles from n_kt on lie wholly above the diagonal
  int n_kt = (t_k + kKeys - 1) / kKeys;
  if (causal) {
    const int x = q_off + q0 + kBlockQ - k_off;
    n_kt = x <= 0 ? 0 : min(n_kt, (x + kKeys - 1) / kKeys);
  }
  auto issue_kv = [&](int kb, float* stage) {
    const int kk0 = kb * kKeys;
    stage_rows<D>(stage, kg, kv_rs, kk0, t_k, kKeys, kThreads);
    stage_rows<D>(stage + kKeys * D, vg, kv_rs, kk0, t_k, kKeys, kThreads);
    stage_row(stage + 2 * kKeys * D, bg, kk0, t_k, kKeys, 0, k);
  };

  stage_rows<D>(qs, q + n * q_bs + h * q_hs, q_rs, q0, t_q, kBlockQ,
                kThreads);
  if (n_kt > 0) issue_kv(0, ring);
  cp_commit();

  float m_r[2] = {kNegInf, kNegInf};   // rows gq and gq + 8 of the warp
  float l_r[2] = {0.f, 0.f};           // this lane's part of the row sum
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

    float s[kNt][4];
    tile_scores<D, kNt>(s, qs, m0, kts, gq, tq);      // S = Q K^T
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qp = q0 + m0 + gq + 8 * (r >> 1);
        const int kc = 8 * j + 2 * tq + (r & 1);
        const int kp = kk0 + kc;
        const bool valid =
            kp < t_k && (!causal || q_off + qp >= k_off + kp);
        s[j][r] = valid ? s[j][r] * scale + bias_s[kc] : kNegInf;
        tmax[r >> 1] = fmaxf(tmax[r >> 1], s[j][r]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m_r[i], tmax[i]);
      alpha[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[j][r] = expf(s[j][r] - m_r[r >> 1]);       // p
        l_r[r >> 1] += s[j][r];
      }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nt][r] *= alpha[r >> 1];
    tile_product<D, kNt, D>(acc, s, vts, 0, gq, tq);  // O += P V
  }

  float lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i] + __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float lc = fmaxf(l, 1e-30f);
    lse_r[i] = m_r[i] + logf(lc);
    l_r[i] = lc;
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] /= l_r[r >> 1];
  const float one[2] = {1.f, 1.f};
  store_rows<D>(o + n * q_bs + h * q_hs, q_rs, acc, one, q0 + m0, 0, t_q,
                gq, tq);
  if (tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + m0 + gq + 8 * i;
      if (row < t_q) lse[static_cast<int64_t>(g) * t_q + row] = lse_r[i];
    }
  }
}

// The bf16 path: Q, K and V bf16, the bias float32 (widened by the
// wrapper), lse float32, O bf16.  One block per (64-query tile,
// batch*head), 4 warps of 16 query rows; Q's A fragments are loaded into
// registers once, K and V tiles of 64 keys stream through the cp.async
// ring as bf16 tiles.
template <int D>
__global__ void __launch_bounds__(32 * kWarps, 2)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int n_head, int t_q, int t_k,
                      int64_t q_bs, int64_t q_hs, int64_t q_rs,
                      int64_t kv_bs, int64_t kv_hs, int64_t kv_rs,
                      float scale, int causal, int q_off, int k_off) {
  constexpr int kKeys = kBf16Keys;
  constexpr int kNt = kKeys / 8;                 // n-tiles of a score tile
  constexpr int kThreads = 32 * kWarps;
  constexpr int kStage = 2 * kKeys * D;          // K, V tiles (bf16)
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* ring = qs + kBlockQ * D;        // 2 stages
  float* bias_ring = reinterpret_cast<float*>(ring + 2 * kStage);

  const int g = blockIdx.y;
  const int n = g / n_head;
  const int h = g % n_head;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = (tid >> 5) * 16;                // the warp's queries

  const __nv_bfloat16* kg = k + n * kv_bs + h * kv_hs;
  const __nv_bfloat16* vg = v + n * kv_bs + h * kv_hs;
  const float* bg = bias != nullptr ? bias + static_cast<int64_t>(n) * t_k
                                    : nullptr;

  // causal: K tiles from n_kt on lie wholly above the diagonal
  int n_kt = (t_k + kKeys - 1) / kKeys;
  if (causal) {
    const int x = q_off + q0 + kBlockQ - k_off;
    n_kt = x <= 0 ? 0 : min(n_kt, (x + kKeys - 1) / kKeys);
  }
  auto issue_kv = [&](int kb, int st) {
    const int kk0 = kb * kKeys;
    __nv_bfloat16* stage = ring + st * kStage;
    stage_rows16<D>(stage, kg, kv_rs, kk0, t_k, kKeys, kThreads);
    stage_rows16<D>(stage + kKeys * D, vg, kv_rs, kk0, t_k, kKeys,
                    kThreads);
    stage_row(bias_ring + st * kKeys, bg, kk0, t_k, kKeys, 0, lse);
  };

  stage_rows16<D>(qs, q + n * q_bs + h * q_hs, q_rs, q0, t_q, kBlockQ,
                  kThreads);
  if (n_kt > 0) issue_kv(0, 0);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  uint32_t qf[D / 16][4];            // the warp's Q rows as A fragments
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qf[kk][0] = ld_pair<D>(qs, m0 + gq, 16 * kk + 2 * tq);
    qf[kk][1] = ld_pair<D>(qs, m0 + gq + 8, 16 * kk + 2 * tq);
    qf[kk][2] = ld_pair<D>(qs, m0 + gq, 16 * kk + 8 + 2 * tq);
    qf[kk][3] = ld_pair<D>(qs, m0 + gq + 8, 16 * kk + 8 + 2 * tq);
  }

  float m_r[2] = {kNegInf, kNegInf};   // rows gq and gq + 8 of the warp
  float l_r[2] = {0.f, 0.f};           // this lane's part of the row sum
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
    const __nv_bfloat16* kts = ring + (kb & 1) * kStage;
    const __nv_bfloat16* vts = kts + kKeys * D;
    const float* bias_s = bias_ring + (kb & 1) * kKeys;
    const int kk0 = kb * kKeys;

    float s[kNt][4];                                   // S = Q K^T
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < kNt; ++j)
        mma_bf16(s[j], qf[kk], ld_pair<D>(kts, 8 * j + gq, 16 * kk + 2 * tq),
                 ld_pair<D>(kts, 8 * j + gq, 16 * kk + 8 + 2 * tq));
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qp = q0 + m0 + gq + 8 * (r >> 1);
        const int kc = 8 * j + 2 * tq + (r & 1);
        const int kp = kk0 + kc;
        const bool valid =
            kp < t_k && (!causal || q_off + qp >= k_off + kp);
        s[j][r] = valid ? s[j][r] * scale + bias_s[kc] : kNegInf;
        tmax[r >> 1] = fmaxf(tmax[r >> 1], s[j][r]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m_r[i], tmax[i]);
      alpha[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
      l_r[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[j][r] = expf(s[j][r] - m_r[r >> 1]);       // p, float32
        l_r[r >> 1] += s[j][r];
      }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nt][r] *= alpha[r >> 1];
    // O += P V: p rounded to bf16, two score tiles an A fragment; V's B
    // fragments by ldmatrix.trans, two n-tiles a call
#pragma unroll
    for (int ks = 0; ks < kKeys / 16; ++ks) {
      const uint32_t pa[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                              pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                              pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                              pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
      const int vrow = 16 * ks + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vts + at16<D>(vrow, 16 * np + (lane >> 4) * 8));
        mma_bf16(acc[2 * np], pa, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
  }

  float lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i] + __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float lc = fmaxf(l, 1e-30f);
    lse_r[i] = m_r[i] + logf(lc);
    l_r[i] = lc;
  }
  __nv_bfloat16* og = o + n * q_bs + h * q_hs;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + m0 + gq + 8 * i;
      if (row < t_q)
        *reinterpret_cast<uint32_t*>(og + static_cast<int64_t>(row) * q_rs +
                                     nt * 8 + 2 * tq) =
            pack_bf16(acc[nt][2 * i] / l_r[i], acc[nt][2 * i + 1] / l_r[i]);
    }
  if (tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + m0 + gq + 8 * i;
      if (row < t_q) lse[static_cast<int64_t>(g) * t_q + row] = lse_r[i];
    }
  }
}

template <int D>
int launch_d(const float* q, const float* k, const float* v,
             const float* bias, float* o, float* lse, int n_batch,
             int n_head, int t_q, int t_k, int64_t q_bs, int64_t q_hs,
             int64_t q_rs, int64_t kv_bs, int64_t kv_hs, int64_t kv_rs,
             float scale, int causal, int q_off, int k_off,
             cudaStream_t stream) {
  auto kernel = &flash_fwd_kernel<D>;
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_q + kBlockQ - 1) / kBlockQ, n_batch * n_head);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(
      q, k, v, bias, o, lse, n_head, t_q, t_k, q_bs, q_hs, q_rs, kv_bs,
      kv_hs, kv_rs, scale, causal, q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16_d(const __nv_bfloat16* q, const __nv_bfloat16* k,
                  const __nv_bfloat16* v, const float* bias,
                  __nv_bfloat16* o, float* lse, int n_batch, int n_head,
                  int t_q, int t_k, int64_t q_bs, int64_t q_hs, int64_t q_rs,
                  int64_t kv_bs, int64_t kv_hs, int64_t kv_rs, float scale,
                  int causal, int q_off, int k_off, cudaStream_t stream) {
  auto kernel = &flash_fwd_bf16_kernel<D>;
  const size_t smem = fwd_bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_q + kBlockQ - 1) / kBlockQ, n_batch * n_head);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(
      q, k, v, bias, o, lse, n_head, t_q, t_k, q_bs, q_hs, q_rs, kv_bs,
      kv_hs, kv_rs, scale, causal, q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements; o has q's strides, v has k's.  bias may be
// NULL.  Returns the cudaError_t of the launch (0 = success), or
// cudaErrorMisalignedAddress when a row of q, k, v or o does not start
// 16-byte aligned.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int n_batch, int n_head, int d, int t_q, int t_k,
    int64_t q_bs, int64_t q_hs, int64_t q_rs, int64_t kv_bs, int64_t kv_hs,
    int64_t kv_rs, float scale, int causal, int q_off, int k_off,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_batch == 0 || t_q == 0) return 0;
  const void* const rows[4] = {q, k, v, o};
  const int64_t strides[6] = {q_bs, q_hs, q_rs, kv_bs, kv_hs, kv_rs};
  if (!rows_aligned(rows, 4, strides, 6))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  switch (d) {
    case 32:
      return launch_d<32>(qf, kf, vf, bf, of, lf, n_batch, n_head, t_q, t_k,
                          q_bs, q_hs, q_rs, kv_bs, kv_hs, kv_rs, scale,
                          causal, q_off, k_off, st);
    case 64:
      return launch_d<64>(qf, kf, vf, bf, of, lf, n_batch, n_head, t_q, t_k,
                          q_bs, q_hs, q_rs, kv_bs, kv_hs, kv_rs, scale,
                          causal, q_off, k_off, st);
    case 128:
      return launch_d<128>(qf, kf, vf, bf, of, lf, n_batch, n_head, t_q,
                           t_k, q_bs, q_hs, q_rs, kv_bs, kv_hs, kv_rs, scale,
                           causal, q_off, k_off, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 path: q, k, v and o bf16, bias float32 (or NULL), lse
// float32; the same arguments as flash_attention_fwd_launch.  Rows must
// start 16-byte aligned (strides multiples of 8 values).
extern "C" int flash_attention_fwd_bf16_launch(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int n_batch, int n_head, int d, int t_q, int t_k,
    int64_t q_bs, int64_t q_hs, int64_t q_rs, int64_t kv_bs, int64_t kv_hs,
    int64_t kv_rs, float scale, int causal, int q_off, int k_off,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_batch == 0 || t_q == 0) return 0;
  const void* const rows[4] = {q, k, v, o};
  const int64_t strides[6] = {q_bs, q_hs, q_rs, kv_bs, kv_hs, kv_rs};
  if (!rows_aligned(rows, 4, strides, 6, 2))
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const bf* qb = static_cast<const bf*>(q);
  const bf* kb = static_cast<const bf*>(k);
  const bf* vb = static_cast<const bf*>(v);
  const float* bf32 = static_cast<const float*>(bias);
  bf* ob = static_cast<bf*>(o);
  float* lf = static_cast<float*>(lse);
  switch (d) {
    case 32:
      return launch_bf16_d<32>(qb, kb, vb, bf32, ob, lf, n_batch, n_head,
                               t_q, t_k, q_bs, q_hs, q_rs, kv_bs, kv_hs,
                               kv_rs, scale, causal, q_off, k_off, st);
    case 64:
      return launch_bf16_d<64>(qb, kb, vb, bf32, ob, lf, n_batch, n_head,
                               t_q, t_k, q_bs, q_hs, q_rs, kv_bs, kv_hs,
                               kv_rs, scale, causal, q_off, k_off, st);
    case 128:
      return launch_bf16_d<128>(qb, kb, vb, bf32, ob, lf, n_batch, n_head,
                                t_q, t_k, q_bs, q_hs, q_rs, kv_bs, kv_hs,
                                kv_rs, scale, causal, q_off, k_off, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
