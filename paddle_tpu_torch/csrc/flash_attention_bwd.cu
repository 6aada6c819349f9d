// Flash-attention backward kernels for Hopper (sm_90a): dK/dV (+ the key
// bias gradient) and dQ.
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
// Design.  Both kernels use 64-thread blocks and 64-row tiles in shared
// memory with a row pitch of D+4 floats, so a thread reading its own row
// with 16-byte loads hits distinct banks and a row read by all threads
// at once is a broadcast.
//  - dK/dV: one block per (64-key tile, batch*head); thread j owns key j
//    and keeps its dK and dV rows (2*D floats) in registers, while its k
//    and v rows stay in shared memory (registers would pass 255 at
//    D=64).  The block walks the q tiles, skipping those wholly above
//    the causal diagonal; for each it stages O and dO, computes delta per
//    row, then stages Q, lse and delta and accumulates.
//  - dQ: one block per (64-query tile, batch*head); thread i owns query
//    row i (its q row and dQ accumulator in registers, its dO row in
//    shared memory), computes its own delta, and walks the K/V tiles up
//    to the causal diagonal.  This is the forward kernel's structure.
// Outputs go through shared memory so their global writes are coalesced.
//
// What bounds them: by the roofline, operations.  At the training shape
// N=64, H=8, T=256, D=64 (f32) the backward moves ~270 MB (~80 us at
// 3.35 TB/s) against 8*D flops per visible (q, k) pair in dK/dV and 6*D
// in dQ: ~15 GFLOP causal, ~30 GFLOP not (~225 / ~450 us at 67 TFLOP/s
// f32).  These simple kernels stay well above that: one thread per row
// walks its pairs serially with f32 FMAs on the CUDA cores, at 64
// threads a block.  Tensor cores (wgmma), TMA and bf16 are later work.
//
// Masking matches the TPU kernel: a pair is visible when the key is
// before Tk, the query before Tq, and, under causal, q_off + q_pos >=
// k_off + k_pos.  p and ds are exactly 0 elsewhere, and tile rows past
// Tq or Tk are zeroed when staged, so undefined memory never reaches an
// accumulator.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;    // rows per q or k tile, and threads per block

struct RowStrides {
  int64_t b, h, r;            // batch, head, row strides in elements
};

// q, k, v, o, dO, dQ, dK, dV
struct BwdStrides {
  RowStrides q, k, v, o, dout, dq, dk, dv;
};

template <int D>
__host__ __device__ constexpr int pitch() { return D + 4; }

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// acc += a * b lane by lane: four independent FMA chains, so a dot
// product over D is D/4 dependent steps, not D
__device__ __forceinline__ void fma4(float4& acc, float4 a, float4 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
  acc.z = fmaf(a.z, b.z, acc.z);
  acc.w = fmaf(a.w, b.w, acc.w);
}

__device__ __forceinline__ float hsum(float4 a) {
  return (a.x + a.y) + (a.z + a.w);
}

// Stage rows [row0, row0 + kBlock) of one head of a strided tensor into
// shared memory at pitch D+4; rows at or past `limit` become zeros.
template <int D>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int64_t row_stride, int row0,
                                           int limit) {
  constexpr int P = pitch<D>();
  for (int idx = threadIdx.x; idx < kBlock * D; idx += kBlock) {
    const int rr = idx / D, dd = idx % D;
    const int row = row0 + rr;
    dst[rr * P + dd] = row < limit ? src[row * row_stride + dd] : 0.f;
  }
}

// Write rows [row0, row0 + kBlock) (those before `limit`) from shared
// memory to a strided tensor, coalesced.
template <int D>
__device__ __forceinline__ void store_tile(float* dst, const float* src,
                                           int64_t row_stride, int row0,
                                           int limit) {
  constexpr int P = pitch<D>();
  for (int idx = threadIdx.x; idx < kBlock * D; idx += kBlock) {
    const int rr = idx / D, dd = idx % D;
    const int row = row0 + rr;
    if (row < limit) dst[row * row_stride + dd] = src[rr * P + dd];
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q (O while delta is formed), dO tiles + lse and delta rows
  return sizeof(float) * (4 * kBlock * pitch<D>() + 2 * kBlock);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // K (O, then Q, then dQ while staging), V, dO tiles + the bias row
  return sizeof(float) * (3 * kBlock * pitch<D>() + kBlock);
}

template <int D>
__global__ void __launch_bounds__(kBlock)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ o,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dlse,
                     const float* __restrict__ bias, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ dbias,
                     int n_head, int t_q, int t_k, BwdStrides st, float scale,
                     int causal, int q_off, int k_off) {
  constexpr int P = pitch<D>();
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // kBlock x P
  float* vs = ks + kBlock * P;                   // kBlock x P
  float* qs = vs + kBlock * P;                   // kBlock x P (O, then Q)
  float* dos = qs + kBlock * P;                  // kBlock x P
  float* lse_s = dos + kBlock * P;               // kBlock
  float* delta_s = lse_s + kBlock;               // kBlock

  const int g = blockIdx.y;
  const int n = g / n_head;
  const int h = g % n_head;
  const int kb = blockIdx.x;
  const int j = threadIdx.x;
  const int k_pos = kb * kBlock + j;
  const bool k_in = k_pos < t_k;

  const float* qg = q + n * st.q.b + h * st.q.h;
  const float* og = o + n * st.o.b + h * st.o.h;
  const float* dog = dout + n * st.dout.b + h * st.dout.h;
  stage_tile<D>(ks, k + n * st.k.b + h * st.k.h, st.k.r, kb * kBlock, t_k);
  stage_tile<D>(vs, v + n * st.v.b + h * st.v.h, st.v.r, kb * kBlock, t_k);
  const float bias_j =
      (bias != nullptr && k_in) ? bias[(int64_t)n * t_k + k_pos] : 0.f;

  float dk_acc[D], dv_acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dk_acc[d] = dv_acc[d] = 0.f;
  float db = 0.f;

  const float4* kj = reinterpret_cast<const float4*>(ks + j * P);
  const float4* vj = reinterpret_cast<const float4*>(vs + j * P);
  const int n_qb = (t_q + kBlock - 1) / kBlock;
  for (int qb = 0; qb < n_qb; ++qb) {
    // causal: every query of this tile precedes every key of ours
    if (causal && q_off + (qb + 1) * kBlock <= k_off + kb * kBlock) continue;
    const int q0 = qb * kBlock;
    __syncthreads();                 // the previous tile's readers are done
    stage_tile<D>(qs, og, st.o.r, q0, t_q);
    stage_tile<D>(dos, dog, st.dout.r, q0, t_q);
    __syncthreads();
    {
      // delta of query row j of this tile: rowsum(dO * O) - dlse
      const float4* a = reinterpret_cast<const float4*>(dos + j * P);
      const float4* b = reinterpret_cast<const float4*>(qs + j * P);
      float acc = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) acc += dot4(a[d4], b[d4]);
      const int qp = q0 + j;
      const bool in = qp < t_q;
      if (dlse != nullptr && in) acc -= dlse[(int64_t)g * t_q + qp];
      delta_s[j] = acc;
      lse_s[j] = in ? lse[(int64_t)g * t_q + qp] : 0.f;
    }
    __syncthreads();
    stage_tile<D>(qs, qg, st.q.r, q0, t_q);
    __syncthreads();
    for (int i = 0; i < kBlock; ++i) {
      const int qp = q0 + i;
      const bool valid = k_in && qp < t_q &&
                         (!causal || q_off + qp >= k_off + k_pos);
      if (!valid) continue;
      const float4* qi = reinterpret_cast<const float4*>(qs + i * P);
      const float4* doi = reinterpret_cast<const float4*>(dos + i * P);
      float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) fma4(s4, qi[d4], kj[d4]);
      const float p = expf(hsum(s4) * scale + bias_j - lse_s[i]);
      float4 dp4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 a = doi[d4];
        dv_acc[4 * d4 + 0] += p * a.x;
        dv_acc[4 * d4 + 1] += p * a.y;
        dv_acc[4 * d4 + 2] += p * a.z;
        dv_acc[4 * d4 + 3] += p * a.w;
        fma4(dp4, a, vj[d4]);
      }
      const float ds = p * (hsum(dp4) - delta_s[i]);
      db += ds;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 a = qi[d4];
        dk_acc[4 * d4 + 0] += ds * a.x;
        dk_acc[4 * d4 + 1] += ds * a.y;
        dk_acc[4 * d4 + 2] += ds * a.z;
        dk_acc[4 * d4 + 3] += ds * a.w;
      }
    }
  }

  if (dbias != nullptr && k_in) dbias[(int64_t)g * t_k + k_pos] = db;
  __syncthreads();                   // every reader of ks/vs is done
#pragma unroll
  for (int d = 0; d < D; ++d) {
    ks[j * P + d] = dk_acc[d] * scale;
    vs[j * P + d] = dv_acc[d];
  }
  __syncthreads();
  store_tile<D>(dk + n * st.dk.b + h * st.dk.h, ks, st.dk.r, kb * kBlock,
                t_k);
  store_tile<D>(dv + n * st.dv.b + h * st.dv.h, vs, st.dv.r, kb * kBlock,
                t_k);
}

template <int D>
__global__ void __launch_bounds__(kBlock)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dlse,
                    const float* __restrict__ bias, float* __restrict__ dq,
                    int n_head, int t_q, int t_k, BwdStrides st, float scale,
                    int causal, int q_off, int k_off) {
  constexpr int P = pitch<D>();
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // kBlock x P
  float* vs = ks + kBlock * P;                   // kBlock x P
  float* dos = vs + kBlock * P;                  // kBlock x P
  float* bias_s = dos + kBlock * P;              // kBlock

  const int g = blockIdx.y;
  const int n = g / n_head;
  const int h = g % n_head;
  const int qb = blockIdx.x;
  const int i = threadIdx.x;
  const int q0 = qb * kBlock;
  const int q_pos = q0 + i;
  const bool q_in = q_pos < t_q;

  const float* kg = k + n * st.k.b + h * st.k.h;
  const float* vg = v + n * st.v.b + h * st.v.h;
  const float* bg = bias != nullptr ? bias + (int64_t)n * t_k : nullptr;

  // delta of this thread's row, from the O tile (staged in ks) and dO
  stage_tile<D>(ks, o + n * st.o.b + h * st.o.h, st.o.r, q0, t_q);
  stage_tile<D>(dos, dout + n * st.dout.b + h * st.dout.h, st.dout.r, q0,
                t_q);
  __syncthreads();
  const float4* doi = reinterpret_cast<const float4*>(dos + i * P);
  float delta = 0.f;
  {
    const float4* oi = reinterpret_cast<const float4*>(ks + i * P);
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) delta += dot4(doi[d4], oi[d4]);
  }
  if (dlse != nullptr && q_in) delta -= dlse[(int64_t)g * t_q + q_pos];
  const float lse_i = q_in ? lse[(int64_t)g * t_q + q_pos] : 0.f;
  __syncthreads();
  stage_tile<D>(ks, q + n * st.q.b + h * st.q.h, st.q.r, q0, t_q);
  __syncthreads();
  float qreg[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qreg[d] = ks[i * P + d];
    acc[d] = 0.f;
  }

  const int n_kb = (t_k + kBlock - 1) / kBlock;
  for (int kb = 0; kb < n_kb; ++kb) {
    // causal: this and every later K tile lies wholly above the diagonal
    if (causal && q_off + (qb + 1) * kBlock <= k_off + kb * kBlock) break;
    __syncthreads();                 // the previous tile's readers are done
    stage_tile<D>(ks, kg, st.k.r, kb * kBlock, t_k);
    stage_tile<D>(vs, vg, st.v.r, kb * kBlock, t_k);
    {
      const int kp = kb * kBlock + i;
      bias_s[i] = (bg != nullptr && kp < t_k) ? bg[kp] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kBlock; ++j) {
      const int kp = kb * kBlock + j;
      const bool valid = q_in && kp < t_k &&
                         (!causal || q_off + q_pos >= k_off + kp);
      if (!valid) continue;
      const float4* kj = reinterpret_cast<const float4*>(ks + j * P);
      const float4* vj = reinterpret_cast<const float4*>(vs + j * P);
      float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 dp4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        fma4(s4, make_float4(qreg[4 * d4 + 0], qreg[4 * d4 + 1],
                             qreg[4 * d4 + 2], qreg[4 * d4 + 3]),
             kj[d4]);
        fma4(dp4, doi[d4], vj[d4]);
      }
      const float p = expf(hsum(s4) * scale + bias_s[j] - lse_i);
      const float ds = p * (hsum(dp4) - delta);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kk = kj[d4];
        acc[4 * d4 + 0] += ds * kk.x;
        acc[4 * d4 + 1] += ds * kk.y;
        acc[4 * d4 + 2] += ds * kk.z;
        acc[4 * d4 + 3] += ds * kk.w;
      }
    }
  }

  __syncthreads();                   // every reader of ks is done
#pragma unroll
  for (int d = 0; d < D; ++d) ks[i * P + d] = acc[d] * scale;
  __syncthreads();
  store_tile<D>(dq + n * st.dq.b + h * st.dq.h, ks, st.dq.r, q0, t_q);
}

BwdStrides unpack(const int64_t* s) {
  // host array: (batch, head, row) for q, k, v, o, dO, dQ, dK, dV
  BwdStrides st;
  RowStrides* f[8] = {&st.q, &st.k, &st.v, &st.o, &st.dout, &st.dq, &st.dk,
                      &st.dv};
  for (int t = 0; t < 8; ++t) *f[t] = {s[3 * t], s[3 * t + 1], s[3 * t + 2]};
  return st;
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* o, const float* dout, const float* lse,
               const float* dlse, const float* bias, float* dk, float* dv,
               float* dbias, int n_batch, int n_head, int t_q, int t_k,
               const BwdStrides& st, float scale, int causal, int q_off,
               int k_off, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_k + kBlock - 1) / kBlock, n_batch * n_head);
  flash_bwd_dkv_kernel<D><<<grid, kBlock, smem, stream>>>(
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
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_q + kBlock - 1) / kBlock, n_batch * n_head);
  flash_bwd_dq_kernel<D><<<grid, kBlock, smem, stream>>>(
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
// cudaError_t of the launch (0 = success).
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  float* dbf = static_cast<float*>(dbias);
  switch (d) {
    case 32:
      return launch_dkv<32>(BWD_INPUTS, dkf, dvf, dbf, n_batch, n_head, t_q,
                            t_k, st, scale, causal, q_off, k_off, s);
    case 64:
      return launch_dkv<64>(BWD_INPUTS, dkf, dvf, dbf, n_batch, n_head, t_q,
                            t_k, st, scale, causal, q_off, k_off, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dqf = static_cast<float*>(dq);
  switch (d) {
    case 32:
      return launch_dq<32>(BWD_INPUTS, dqf, n_batch, n_head, t_q, t_k, st,
                           scale, causal, q_off, k_off, s);
    case 64:
      return launch_dq<64>(BWD_INPUTS, dqf, n_batch, n_head, t_q, t_k, st,
                           scale, causal, q_off, k_off, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
