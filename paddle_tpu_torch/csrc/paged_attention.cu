// Ragged paged-attention decode kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// ragged_paged_attention -> _paged_attn_kernel.  One query token per
// slot attends over that slot's K/V pages of the shared pools, addressed
// through the slot's row of the page table and masked to its length.
//
// Layout (the reference's head-major contract): q and out are (S, H*D),
// the pools are (P, page, H*D), optional int8 scale sidecars are
// (P, page, 1) f32, the page table is (S, max_pages) int32 and lengths is
// (S,) int32.
//
// Design.  One block per (slot, head), four warps.  Warp w takes the
// slot's tokens w, w+4, w+8, ... below the slot's length; each lane holds
// D/32 consecutive elements of the head's slice, so a K row is one
// coalesced D-element read per warp and q.k is a register dot product
// finished by a warp butterfly reduction.  Each warp keeps its own
// online-softmax state (running max m, normaliser l, accumulator acc) in
// registers; the four states merge through shared memory at the end.
// The physical page of token t is read from the page table in the loop
// (page_table[s, t / page]) — what the Pallas BlockSpec index map did on
// the TPU.
//
// What bounds it: decode attention reads every K/V row of every slot
// once and does 4 flops per element, far below the card's
// operations-per-byte balance, so by the roofline it is memory-bound
// (~1 us for one decode step of the serving configuration).  The design
// reads each needed row exactly once and never touches rows at or past a
// slot's length: they may hold NaN from an evicted slot, and page-table
// entries past the used range are 0 and are never dereferenced.  Each
// warp walks its tokens one after another, so at these sizes the chain
// of dependent row loads, not bandwidth, sets the time; splitting a slot
// over several blocks and keeping more loads in flight (flash-decoding)
// is the next step.
//
// Numerics follow the TPU kernel: scores in f32, NEG_INF = -1e30 as the
// running-max seed, the normaliser clamped at 1e-30, the output cast to
// q's dtype (f32 here).  int8 rows are dequantised with their per-row
// scale.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename KV, int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const float* __restrict__ q,
                       const KV* __restrict__ k_pages,
                       const KV* __restrict__ v_pages,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths,
                       float* __restrict__ out,
                       int n_head, int page, int max_pages, float scale) {
  constexpr int VPL = D / 32;  // values per lane
  const int s = blockIdx.x / n_head;
  const int h = blockIdx.x % n_head;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hd = n_head * D;
  const int col = h * D + lane * VPL;

  int len = lengths[s];
  const int cap = max_pages * page;
  len = len < 0 ? 0 : (len > cap ? cap : len);

  float qv[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) qv[i] = q[(int64_t)s * hd + col + i];

  float m = kNegInf, l = 0.f;
  float acc[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) acc[i] = 0.f;

  const int* pt_row = page_table + (int64_t)s * max_pages;
  for (int t = warp; t < len; t += kWarps) {
    const int64_t row = (int64_t)pt_row[t / page] * page + (t % page);
    const KV* krow = k_pages + row * hd + col;
    const KV* vrow = v_pages + row * hd + col;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) dot += qv[i] * to_f32(krow[i]);
    dot = warp_sum(dot);
    if (k_scales != nullptr) dot *= k_scales[row];
    const float sc = dot * scale;
    const float vs = v_scales != nullptr ? v_scales[row] : 1.f;
    const float m_new = fmaxf(m, sc);
    const float alpha = expf(m - m_new);
    const float p = expf(sc - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      acc[i] = acc[i] * alpha + p * (to_f32(vrow[i]) * vs);
    m = m_new;
  }

  // merge the four warps' online-softmax states
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) sm_acc[warp][lane * VPL + i] = acc[i];
  __syncthreads();
  if (warp == 0) {
    float mm = sm_m[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w]);
    float ll = 0.f;
    float o[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) o[i] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w] - mm);
      ll += sm_l[w] * f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) o[i] += sm_acc[w][lane * VPL + i] * f;
    }
    const float denom = fmaxf(ll, 1e-30f);
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      out[(int64_t)s * hd + col + i] = o[i] / denom;
  }
}

template <typename KV>
int launch_typed(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* pt, const void* lengths,
                 void* out, int n_slots, int n_head, int d, int page,
                 int max_pages, float scale, cudaStream_t stream) {
  const dim3 grid(n_slots * n_head), block(kWarps * 32);
#define PAGED_LAUNCH(DD)                                                     \
  paged_attention_kernel<KV, DD><<<grid, block, 0, stream>>>(                \
      static_cast<const float*>(q), static_cast<const KV*>(k),               \
      static_cast<const KV*>(v), static_cast<const float*>(ks),              \
      static_cast<const float*>(vs), static_cast<const int*>(pt),            \
      static_cast<const int*>(lengths), static_cast<float*>(out), n_head,    \
      page, max_pages, scale)
  switch (d) {
    case 32: PAGED_LAUNCH(32); break;
    case 64: PAGED_LAUNCH(64); break;
    case 128: PAGED_LAUNCH(128); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PAGED_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kv_type: 0 = float32, 1 = bfloat16, 2 = int8 (ks/vs required).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* lengths, void* out, int n_slots, int n_head, int d,
    int page, int max_pages, float scale, int kv_type, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_slots == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_type) {
    case 0:
      return launch_typed<float>(q, k_pages, v_pages, nullptr, nullptr,
                                 page_table, lengths, out, n_slots, n_head,
                                 d, page, max_pages, scale, st);
    case 1:
      return launch_typed<__nv_bfloat16>(q, k_pages, v_pages, nullptr,
                                         nullptr, page_table, lengths, out,
                                         n_slots, n_head, d, page,
                                         max_pages, scale, st);
    case 2:
      return launch_typed<int8_t>(q, k_pages, v_pages, k_scales, v_scales,
                                  page_table, lengths, out, n_slots, n_head,
                                  d, page, max_pages, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
