// Flash-attention forward kernel for Hopper (sm_90a).
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
// (N, H, T, D) with row stride D and head stride T*D.  The key-padding
// bias is (N, Tk) — one row per batch element, read as row g / H and
// never repeated per head.  O has q's layout; lse is (N*H, Tq) f32.
//
// Design.  One block per (64-row q tile, batch*head), 64 threads: thread
// r owns query row r of the tile, holding its q row and its output
// accumulator in registers.  The block walks the 64-row K/V tiles; each
// tile is loaded once into shared memory (coalesced, rows past Tk
// zeroed so undefined memory never reaches the accumulator), every
// thread scores its row against the tile's 64 keys (the K reads are
// shared-memory broadcasts), keeps the scores in a shared column-major
// buffer, and updates its online softmax (m, l, acc) once per tile.
// Under a causal mask, K tiles wholly above the diagonal are skipped.
// Q and O go through shared memory so their global reads and writes are
// coalesced.
//
// What bounds it: by the roofline, bytes.  At the prefill shape T=128
// (N=16, H=8, D=64, f32) q, k, v and o are ~17 MB (~5 us at 3.35 TB/s)
// against ~0.27 GFLOP of visible (q, k) pairs (~4 us at 67 TFLOP/s f32).
// This simple design is held well above both by each thread's serial
// f32 FMA loop on the CUDA cores; a tensor-core (wgmma) version with
// several warps per q tile is the next step.
//
// Numerics follow the TPU kernel: scores and softmax in f32, masked
// scores set to NEG_INF = -1e30, the normaliser clamped at 1e-30, and
// the causal test q_off + q_pos >= k_off + k_pos (offsets for ring
// attention; 0 in prefill).  Rows whose keys all carry the -1e9 padding
// bias (prefill rows of slots that are not joining) stay finite.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  // K tile + V tile + column-major score tile; the Q/O staging tile
  // (kBlockQ x (D+1)) reuses the K/V area.
  return sizeof(float) * (2 * kBlockK * D + kBlockK * kBlockQ);
}

template <int D>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ bias, float* __restrict__ o,
                 float* __restrict__ lse, int n_head, int t_q, int t_k,
                 int64_t q_bs, int64_t q_hs, int64_t q_rs, int64_t kv_bs,
                 int64_t kv_hs, int64_t kv_rs, float scale, int causal,
                 int q_off, int k_off) {
  static_assert(2 * kBlockK * D >= kBlockQ * (D + 1), "staging area");
  extern __shared__ float smem[];
  float* ks = smem;                 // kBlockK x D
  float* vs = ks + kBlockK * D;     // kBlockK x D
  float* ss = vs + kBlockK * D;     // scores, ss[j * kBlockQ + r]
  float* stage = smem;              // kBlockQ x (D + 1), Q in / O out

  const int g = blockIdx.y;
  const int n = g / n_head;
  const int h = g % n_head;
  const int qb = blockIdx.x;
  const int r = threadIdx.x;
  const int q_pos = qb * kBlockQ + r;

  const float* qg = q + n * q_bs + h * q_hs;
  const float* kg = k + n * kv_bs + h * kv_hs;
  const float* vg = v + n * kv_bs + h * kv_hs;
  float* og = o + n * q_bs + h * q_hs;
  const float* bg = bias != nullptr ? bias + (int64_t)n * t_k : nullptr;

  for (int idx = r; idx < kBlockQ * D; idx += kBlockQ) {
    const int rr = idx / D, dd = idx % D;
    const int qp = qb * kBlockQ + rr;
    stage[rr * (D + 1) + dd] = qp < t_q ? qg[qp * q_rs + dd] : 0.f;
  }
  __syncthreads();
  float qreg[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qreg[d] = stage[r * (D + 1) + d];
  __syncthreads();

  float m = kNegInf, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  const int n_kb = (t_k + kBlockK - 1) / kBlockK;
  for (int kb = 0; kb < n_kb; ++kb) {
    // causal: this and every later K tile lies wholly above the diagonal
    if (causal && q_off + (qb + 1) * kBlockQ <= k_off + kb * kBlockK) break;
    for (int idx = r; idx < kBlockK * D; idx += kBlockQ) {
      const int jj = idx / D, dd = idx % D;
      const int kp = kb * kBlockK + jj;
      const bool in = kp < t_k;
      ks[idx] = in ? kg[kp * kv_rs + dd] : 0.f;
      vs[idx] = in ? vg[kp * kv_rs + dd] : 0.f;
    }
    __syncthreads();
    float tmax = kNegInf;
    for (int j = 0; j < kBlockK; ++j) {
      const int kp = kb * kBlockK + j;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qreg[d] * ks[j * D + d];
      float sc = dot * scale;
      const bool valid =
          kp < t_k && (!causal || q_off + q_pos >= k_off + kp);
      if (bg != nullptr && kp < t_k) sc += bg[kp];
      sc = valid ? sc : kNegInf;
      ss[j * kBlockQ + r] = sc;
      tmax = fmaxf(tmax, sc);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(ss[j * kBlockQ + r] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += p * vs[j * D + d];
    }
    m = m_new;
    __syncthreads();
  }

  const float lc = fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < D; ++d) stage[r * (D + 1) + d] = acc[d] / lc;
  if (q_pos < t_q) lse[(int64_t)g * t_q + q_pos] = m + logf(lc);
  __syncthreads();
  for (int idx = r; idx < kBlockQ * D; idx += kBlockQ) {
    const int rr = idx / D, dd = idx % D;
    const int qp = qb * kBlockQ + rr;
    if (qp < t_q) og[qp * q_rs + dd] = stage[rr * (D + 1) + dd];
  }
}

template <int D>
int launch_d(const float* q, const float* k, const float* v,
             const float* bias, float* o, float* lse, int n_batch,
             int n_head, int t_q, int t_k, int64_t q_bs, int64_t q_hs,
             int64_t q_rs, int64_t kv_bs, int64_t kv_hs, int64_t kv_rs,
             float scale, int causal, int q_off, int k_off,
             cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_q + kBlockQ - 1) / kBlockQ, n_batch * n_head);
  flash_fwd_kernel<D><<<grid, kBlockQ, smem, stream>>>(
      q, k, v, bias, o, lse, n_head, t_q, t_k, q_bs, q_hs, q_rs, kv_bs,
      kv_hs, kv_rs, scale, causal, q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements.  bias may be NULL.  Returns the cudaError_t
// of the launch (0 = success).
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int n_batch, int n_head, int d, int t_q, int t_k,
    int64_t q_bs, int64_t q_hs, int64_t q_rs, int64_t kv_bs, int64_t kv_hs,
    int64_t kv_rs, float scale, int causal, int q_off, int k_off,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_batch == 0 || t_q == 0) return 0;
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
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
