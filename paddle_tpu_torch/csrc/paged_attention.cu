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
// What bounds it: decode attention reads every K/V row of every slot
// once and does 4 flops per element, far below the card's
// operations-per-byte balance, so by the roofline it is memory-bound:
// ~1 us for one decode step of the serving configuration, ~30 us for 16
// slots of 2048-4096 tokens.  What kept the first design (one block per
// (slot, head), each warp walking its tokens one at a time, D/32
// elements a lane) far from that was latency: a chain of dependent
// page-table, K and V loads per token with few bytes in flight.
//
// Design (flash-decoding).  A block of four warps handles one (slot,
// head, split); a split is a fixed run of `pages_per_split` of the
// slot's pages.  The wrapper picks the split size from shapes alone
// (max_pages, S x H and the SM count), never from the lengths, so the
// grid and the workspace do not depend on the data and no decode step
// waits on a read of the lengths.
//  - A split reads its page-table entries once, into shared memory.
//  - Loads are 16 bytes a lane: a row of D elements is LPR = D / EPL
//    lanes (EPL = 4 f32, 8 bf16 or 16 int8 elements a load), so one warp
//    load covers 32 / LPR tokens (4 at D = 64 bf16), and each warp keeps
//    kUnroll such loads of K and of V in flight before it uses any.
//  - q.k is reduced over the LPR lanes of a row by xor-shuffles; each
//    lane keeps the online-softmax state (running max m, normaliser l,
//    its EPL accumulators) of the tokens in its row slot, in registers,
//    rescaled once per group of kUnroll tokens.  The slots of a warp,
//    then the four warps (through shared memory, in warp order), merge.
//  - A split that starts at or past its slot's length writes the empty
//    state (m = -1e30, l = 0) and exits.  With one split the block writes
//    the output itself; with more, each split's (m, l, acc) goes to the
//    workspace and a second kernel merges them in split order, reading
//    the acc of the non-empty splits only.  No atomics: two runs give the
//    same bits.
//  - Rows at or past a slot's length are never read (they may hold NaN
//    from an evicted slot), and page-table entries past the used range
//    are never dereferenced.
//
// Numerics follow the TPU kernel: scores in f32, NEG_INF = -1e30 as the
// running-max seed, the normaliser clamped at 1e-30, the output cast to
// q's dtype (f32 here), lengths clamped to [0, max_pages * page].  int8
// rows are dequantised with their per-row scale.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;           // warp loads of K (and V) in flight
constexpr int kMaxSplitPages = 4096;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// The EPL = 16 / sizeof(KV) elements of one 16-byte load, as float32.
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[4],
                                       float) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}

// bfloat16 (the top half of a float32): element 2i in the low half-word
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[8],
                                       uint16_t) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& r, float (&x)[16],
                                       int8_t) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      x[4 * i + b] = static_cast<float>(
          static_cast<int8_t>(static_cast<uint8_t>(w[i] >> (8 * b))));
}

// KV is float, uint16_t (bfloat16 bits) or int8_t.
template <typename KV, int D>
__global__ void __launch_bounds__(kThreads)
    paged_split_kernel(const float* __restrict__ q,
                       const KV* __restrict__ k_pages,
                       const KV* __restrict__ v_pages,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths,
                       float* __restrict__ out, float* __restrict__ ws,
                       int n_sh, int n_head, int page, int max_pages,
                       int pps, int n_splits, float scale) {
  constexpr int EPL = 16 / sizeof(KV);   // elements a lane loads at once
  constexpr int LPR = D / EPL;           // lanes of a row
  constexpr int TPW = 32 / LPR;          // tokens of one warp load
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row lanes");
  extern __shared__ int sm_page[];       // the split's page-table entries
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  const int split = blockIdx.x % n_splits, sh = blockIdx.x / n_splits;
  const int s = sh / n_head, h = sh % n_head;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = lane / LPR, sub = lane % LPR;
  const int hd = n_head * D;
  const int cap = max_pages * page;
  int len = lengths[s];
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int span = pps * page;
  const int t0 = split * span;
  const int t1 = min(t0 + span, len);
  const size_t at = static_cast<size_t>(sh) * n_splits + split;
  if (n_splits > 1 && t0 >= len) {       // nothing of this slot here
    if (threadIdx.x == 0) {
      ws[2 * at] = kNegInf;
      ws[2 * at + 1] = 0.f;
    }
    return;
  }
  const int n_pg = t1 > t0 ? (t1 - t0 + page - 1) / page : 0;
  const int* pt = page_table + static_cast<int64_t>(s) * max_pages +
                  static_cast<int64_t>(split) * pps;
  for (int i = threadIdx.x; i < n_pg; i += kThreads) sm_page[i] = pt[i];
  const int col = h * D + sub * EPL;
  float qv[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i)
    qv[i] = q[static_cast<int64_t>(s) * hd + col + i];
  __syncthreads();

  float m = kNegInf, l = 0.f, acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.f;
  constexpr int kStep = kWarps * TPW * kUnroll;   // tokens an iteration
  for (int base = t0; base < t1; base += kStep) {
    uint4 kr[kUnroll], vr[kUnroll];
    float ksc[kUnroll], vsc[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + (u * kWarps + warp) * TPW + slot;
      ok[u] = t < t1;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      ksc[u] = vsc[u] = 1.f;
      if (ok[u]) {
        const int rel = t - t0;
        const int64_t row =
            static_cast<int64_t>(sm_page[rel / page]) * page + rel % page;
        kr[u] = __ldg(reinterpret_cast<const uint4*>(k_pages + row * hd + col));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(v_pages + row * hd + col));
        if (k_scales != nullptr) {
          ksc[u] = __ldg(k_scales + row);
          vsc[u] = __ldg(v_scales + row);
        }
      }
    }
    float sc[kUnroll];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kx[EPL];
      unpack(kr[u], kx, KV());
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) dot += qv[i] * kx[i];
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1) dot += __shfl_xor_sync(kFull, dot, o);
      sc[u] = ok[u] ? (dot * ksc[u]) * scale : kNegInf;
      mx = fmaxf(mx, sc[u]);
    }
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      const float p = expf(sc[u] - mx);
      l += p;
      float vx[EPL];
      unpack(vr[u], vx, KV());
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[i] += p * (vx[i] * vsc[u]);
    }
    m = mx;
  }

  // the row slots of the warp, then the four warps, in warp order
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
    const float mo = __shfl_xor_sync(kFull, m, o);
    const float lo = __shfl_xor_sync(kFull, l, o);
    const float mn = fmaxf(m, mo);
    const float a = expf(m - mn), b = expf(mo - mn);
    l = l * a + lo * b;
#pragma unroll
    for (int i = 0; i < EPL; ++i)
      acc[i] = acc[i] * a + __shfl_xor_sync(kFull, acc[i], o) * b;
    m = mn;
  }
  if (slot == 0) {
#pragma unroll
    for (int i = 0; i < EPL; ++i) sm_acc[warp][sub * EPL + i] = acc[i];
    if (sub == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
  }
  __syncthreads();
  const int d = threadIdx.x;
  if (d >= D) return;
  float mm = sm_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w]);
  float ll = 0.f, o = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float f = expf(sm_m[w] - mm);
    ll += sm_l[w] * f;
    o += sm_acc[w][d] * f;
  }
  if (n_splits == 1) {
    out[static_cast<int64_t>(sh) * D + d] = o / fmaxf(ll, 1e-30f);
    return;
  }
  ws[static_cast<size_t>(n_sh) * n_splits * 2 + at * D + d] = o;
  if (d == 0) {
    ws[2 * at] = mm;
    ws[2 * at + 1] = ll;
  }
}

// out of one (slot, head): its splits' states merged in split order; the
// acc of a split is read only when its l > 0 (the split held tokens).
template <int D>
__global__ void __launch_bounds__(D)
    paged_merge_kernel(const float* __restrict__ ws, float* __restrict__ out,
                       int n_sh, int n_splits) {
  const int sh = blockIdx.x, d = threadIdx.x;
  const float* ml = ws + static_cast<size_t>(sh) * n_splits * 2;
  const float* acc = ws + static_cast<size_t>(n_sh) * n_splits * 2 +
                     static_cast<size_t>(sh) * n_splits * D;
  float mm = kNegInf;
  for (int sp = 0; sp < n_splits; ++sp)
    if (ml[2 * sp + 1] > 0.f) mm = fmaxf(mm, ml[2 * sp]);
  float ll = 0.f, o = 0.f;
  for (int sp = 0; sp < n_splits; ++sp) {
    const float l = ml[2 * sp + 1];
    if (l > 0.f) {
      const float f = expf(ml[2 * sp] - mm);
      ll += l * f;
      o += acc[static_cast<size_t>(sp) * D + d] * f;
    }
  }
  out[static_cast<int64_t>(sh) * D + d] = o / fmaxf(ll, 1e-30f);
}

template <typename KV>
int launch_typed(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* pt, const void* lengths,
                 void* out, void* ws, int n_slots, int n_head, int d,
                 int page, int max_pages, int pps, float scale,
                 cudaStream_t stream) {
  const int n_splits = max_pages > pps ? (max_pages + pps - 1) / pps : 1;
  const int n_sh = n_slots * n_head;
  if (n_splits > 1 && ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = static_cast<int64_t>(n_sh) * n_splits;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(pps) * sizeof(int);
#define PAGED_LAUNCH(DD)                                                     \
  paged_split_kernel<KV, DD><<<static_cast<int>(blocks), kThreads, smem,    \
                               stream>>>(                                   \
      static_cast<const float*>(q), static_cast<const KV*>(k),               \
      static_cast<const KV*>(v), static_cast<const float*>(ks),              \
      static_cast<const float*>(vs), static_cast<const int*>(pt),            \
      static_cast<const int*>(lengths), static_cast<float*>(out),            \
      static_cast<float*>(ws), n_sh, n_head, page, max_pages, pps, n_splits, \
      scale);                                                                \
  if (n_splits > 1)                                                          \
    paged_merge_kernel<DD><<<n_sh, DD, 0, stream>>>(                         \
        static_cast<const float*>(ws), static_cast<float*>(out), n_sh,       \
        n_splits)
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

// kv_type: 0 = float32, 1 = bfloat16, 2 = int8 (ks/vs required).  The
// pools must start 16-byte aligned.  pages_per_split in [1, 4096]; with
// more than one split (max_pages > pages_per_split) `workspace` holds
// S x H x n_splits x (2 + d) floats, n_splits = ceil(max_pages /
// pages_per_split).  Returns the cudaError_t of the launches (0 =
// success).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* page_table,
    const void* lengths, void* out, void* workspace, int n_slots,
    int n_head, int d, int page, int max_pages, int pages_per_split,
    float scale, int kv_type, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_slots == 0) return 0;
  if (pages_per_split < 1 || pages_per_split > kMaxSplitPages ||
      reinterpret_cast<uintptr_t>(k_pages) % 16 ||
      reinterpret_cast<uintptr_t>(v_pages) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_type) {
    case 0:
      return launch_typed<float>(q, k_pages, v_pages, nullptr, nullptr,
                                 page_table, lengths, out, workspace,
                                 n_slots, n_head, d, page, max_pages,
                                 pages_per_split, scale, st);
    case 1:
      return launch_typed<uint16_t>(q, k_pages, v_pages, nullptr, nullptr,
                                    page_table, lengths, out, workspace,
                                    n_slots, n_head, d, page, max_pages,
                                    pages_per_split, scale, st);
    case 2:
      return launch_typed<int8_t>(q, k_pages, v_pages, k_scales, v_scales,
                                  page_table, lengths, out, workspace,
                                  n_slots, n_head, d, page, max_pages,
                                  pages_per_split, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
