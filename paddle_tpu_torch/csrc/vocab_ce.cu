// Fused vocabulary projection + label-smoothed softmax cross-entropy for
// Hopper (sm_90a): the forward, dh and dW kernels.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/vocab_ce.py:
// _fwd_kernel (:146, called from _fwd at :274), _bwd_dh_kernel (:204,
// called at :311) and _bwd_dw_kernel (:235, called at :326), the
// custom-VJP pair behind fused_vocab_ce.  For N tokens h (N, D), the
// projection W (D, V) and int32 labels in [0, V), with z = h W:
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
// Design.  256 threads per block, float32 on the CUDA cores (no TF32).
// Every kernel has one resident 64-row tile of an operand in shared
// memory, 64 rows x 512 columns at a pitch of 513 floats (rows past the
// operand's end and columns past D are zero), and streams the other
// operand through 16-deep K-slices (registers prefetch the next slice
// while the current one is multiplied).  A 64 x 64 tile of z is computed
// with a 4 x 4 micro-tile per thread:
//  - forward: a block owns 64 tokens (resident: their h rows) and walks
//    the vocabulary in 64-column tiles (streamed: W), keeping per thread
//    and token a running max, sum of exponentials, sum of logits and the
//    label logit (the Pallas grid's sequential vocab axis becomes this
//    loop).  The 16 partial states of a token are merged through shared
//    memory at the end; the TPU's 8-sublane replication of the stats is
//    a TPU layout device and is not carried over.  64-token tiles give
//    256 blocks at N = 16384 (two waves on 132 SMs), where 128-token
//    tiles would leave 4 SMs idle in a single wave.
//  - dh: a block owns 64 tokens and walks the vocabulary in 64-column
//    tiles; per tile it stages W[:, tile] (resident, as [v][d]),
//    recomputes z from streamed h, forms dz in registers, stages it in
//    shared memory and accumulates dh (64 x 512) += dz W_tile^T in
//    registers: 8 tokens x 16 columns (128 floats) per thread.  The
//    resident W tile serves both the recompute and the product.
//  - dW: a block owns 64 vocabulary columns and walks the tokens in
//    64-row tiles; per tile it stages h[tile] (resident), recomputes z
//    from streamed W[:, cols], forms dz, and accumulates dW^T (64 x 512)
//    += dz^T h_tile in registers.  One block per 64 columns (500 blocks
//    at V = 32000) owns its dW columns over all tokens: no second pass,
//    no atomics, so two runs give the same bits.
// Ragged edges: tokens >= N and vocabulary columns >= V are zero in the
// staged tiles and are skipped (forward) or given dz = 0 (backward), so
// undefined memory never meets an accumulator (the 0 * NaN poisoning the
// Pallas kernel guards against at vocab_ce.py:220-225 and :251-255).
//
// What bounds them on the H100 (float32 peak 67 TFLOP/s, 3.35 TB/s):
// operations.  At N = 16384 tokens (bench, 64 x 256, and long context,
// 2 x 8192), D = 512, V = 32000: forward 2NDV = 0.54 TFLOP (8.0 ms);
// dh and dW each 4NDV = 1.07 TFLOP with the recompute (16.0 ms); the
// bytes (h 34 MB, W 66 MB) are under 0.1 ms.  The design keeps the
// shared-memory traffic under the FMA rate (broadcast reads of the
// streamed slice, conflict-free reads of the resident tile at pitch
// 513); tensor cores (wgmma, bf16) are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows of the resident tile, of z tiles
constexpr int kBK = 16;            // depth of a streamed K-slice
constexpr int kAP = kTile + 4;     // pitch of the slice and dz buffers
constexpr int kMaxD = 512;         // dh/dW: 16 columns x 32 lanes
constexpr int kRP = kMaxD + 1;     // pitch of the resident tile
constexpr float kNeg = -1e30f;     // the reference's NEG

constexpr size_t kResFloats = static_cast<size_t>(kTile) * kRP;
constexpr size_t kSliceFloats = static_cast<size_t>(kBK) * kAP;
constexpr size_t kFwdSmem =
    (kResFloats + kSliceFloats + 4 * 16 * kTile) * sizeof(float);
constexpr size_t kBwdSmem =
    (kResFloats + kSliceFloats + static_cast<size_t>(kTile) * kAP) *
    sizeof(float);

// The streamed operand: element (k, m), k < D, m < 64, at
// base[k * sk + m * sm]; zero outside k < kmax, m < mmax.  k_contig says
// consecutive k are adjacent in memory (h rows), else consecutive m (W).
struct Streamed {
  const float* base;
  int64_t sk, sm;
  int kmax, mmax;
  bool k_contig;
};

__device__ __forceinline__ void slice_coords(bool k_contig, int idx, int& k,
                                             int& m) {
  if (k_contig) {
    m = idx / kBK;
    k = idx % kBK;
  } else {
    k = idx / kTile;
    m = idx % kTile;
  }
}

__device__ __forceinline__ void load_slice(const Streamed& a, int k0,
                                           float (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int k, m;
    slice_coords(a.k_contig, threadIdx.x + i * kThreads, k, m);
    k += k0;
    r[i] = (k < a.kmax && m < a.mmax) ? a.base[k * a.sk + m * a.sm] : 0.f;
  }
}

__device__ __forceinline__ void store_slice(const Streamed& a, float* as,
                                            const float (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int k, m;
    slice_coords(a.k_contig, threadIdx.x + i * kThreads, k, m);
    as[k * kAP + m] = r[i];
  }
}

// res[r][c] (r < 64, c < 512) = element (r, c) at base[r * sr + c * sc],
// zero outside r < rmax, c < cmax.  c_contig: consecutive c are adjacent
// in memory (h rows), else consecutive r (W columns).  Threads walk the
// adjacent index, so the global reads are coalesced; at pitch 513 the
// shared-memory writes of a warp hit distinct banks either way.
__device__ __forceinline__ void load_res(float* res, const float* base,
                                         int64_t sr, int64_t sc, int rmax,
                                         int cmax, bool c_contig) {
#pragma unroll 8
  for (int idx = threadIdx.x; idx < kTile * kMaxD; idx += kThreads) {
    int r, c;
    if (c_contig) {
      r = idx / kMaxD;
      c = idx % kMaxD;
    } else {
      c = idx / kTile;
      r = idx % kTile;
    }
    res[r * kRP + c] =
        (r < rmax && c < cmax) ? base[r * sr + c * sc] : 0.f;
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
    store_slice(a, as, r);
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
  load_res(res, h + static_cast<int64_t>(t0) * d, d, 1, n - t0, d, true);
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
    const Streamed a{w + v0, v, 1, d, v - v0, false};
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

// The dh (DH = true) and dW (DH = false) kernels: see the design notes.
template <bool DH>
__device__ __forceinline__ void bwd_body(
    const float* __restrict__ h, const float* __restrict__ w,
    const int* __restrict__ labels, const float* __restrict__ lse,
    const float* __restrict__ g, float* __restrict__ out, int n, int d,
    int v, float eps) {
  extern __shared__ float smem[];
  float* res = smem;                        // W[:, tile] as [v][d] / h[tile]
  float* as = res + kResFloats;             // streamed slices
  float* sdz = as + kSliceFloats;           // dz as [inner][owner]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lane = threadIdx.x % 32, ro = threadIdx.x / 32;
  const int o0 = blockIdx.x * kTile;        // first owned token / column
  const float keep = 1.f - eps, spread = eps / v;
  // dh: the owned tokens' stats, for the z rows ty*4 + i
  float o_lse[4] = {0.f, 0.f, 0.f, 0.f}, o_g[4] = {0.f, 0.f, 0.f, 0.f};
  int o_lbl[4] = {-1, -1, -1, -1};
  if (DH) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = o0 + ty * 4 + i;
      if (t < n) {
        o_lse[i] = lse[t];
        o_g[i] = g[t];
        o_lbl[i] = labels[t];
      }
    }
  }
  float acc[8][16];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[r][c] = 0.f;

  const Streamed a = DH
      ? Streamed{h + static_cast<int64_t>(o0) * d, 1, d, d, n - o0, true}
      : Streamed{w + o0, v, 1, d, v - o0, false};
  const int n_inner = DH ? v : n;
  for (int i0 = 0; i0 < n_inner; i0 += kTile) {
    __syncthreads();          // the previous tile's products are done
    if (DH)
      load_res(res, w + i0, 1, v, v - i0, d, false);
    else
      load_res(res, h + static_cast<int64_t>(i0) * d, d, 1, n - i0, d,
               true);
    float z[4][4];
    z_tile(a, as, res, d, z);
    // dz for z rows (owned) ty*4 + i and columns (inner) tx + 16j
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int inner = i0 + tx + 16 * j;
      float j_lse = 0.f, j_g = 0.f;
      int j_lbl = -1;
      if (!DH && inner < n) {
        j_lse = lse[inner];
        j_g = g[inner];
        j_lbl = labels[inner];
      }
      float dz[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = DH ? inner : o0 + ty * 4 + i;      // vocabulary
        const float t_lse = DH ? o_lse[i] : j_lse;
        const float t_g = DH ? o_g[i] : j_g;
        const int t_lbl = DH ? o_lbl[i] : j_lbl;
        const bool valid = col < v;
        const float p = valid ? expf(z[i][j] - t_lse) : 0.f;
        dz[i] = t_g * (p - (col == t_lbl ? keep : 0.f) -
                       (valid ? spread : 0.f));
      }
      *reinterpret_cast<float4*>(&sdz[(tx + 16 * j) * kAP + ty * 4]) =
          make_float4(dz[0], dz[1], dz[2], dz[3]);
    }
    __syncthreads();
    // acc[r][c] += sum_k dz(owner ro*8 + r, inner k) * res[k][lane + 32c]
#pragma unroll 2
    for (int k = 0; k < kTile; ++k) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&sdz[k * kAP + ro * 8]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sdz[k * kAP + ro * 8 + 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float b = res[k * kRP + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[r][c] = fmaf(av[r], b, acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int o = o0 + ro * 8 + r;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int col = lane + 32 * c;
      if (col >= d) continue;
      if (DH) {
        if (o < n) out[static_cast<int64_t>(o) * d + col] = acc[r][c];
      } else {
        if (o < v) out[static_cast<int64_t>(col) * v + o] = acc[r][c];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
vocab_ce_dh_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   const int* __restrict__ labels,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   float* __restrict__ dh, int n, int d, int v, float eps) {
  bwd_body<true>(h, w, labels, lse, g, dh, n, d, v, eps);
}

__global__ void __launch_bounds__(kThreads, 1)
vocab_ce_dw_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   const int* __restrict__ labels,
                   const float* __restrict__ lse, const float* __restrict__ g,
                   float* __restrict__ dw, int n, int d, int v, float eps) {
  bwd_body<false>(h, w, labels, lse, g, dw, n, d, v, eps);
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
  err = cudaFuncSetAttribute(vocab_ce_dh_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kBwdSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  vocab_ce_dh_kernel<<<(n + kTile - 1) / kTile, kThreads, kBwdSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<float*>(dh), n, d, v, eps);
  return static_cast<int>(cudaGetLastError());
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
  err = cudaFuncSetAttribute(vocab_ce_dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kBwdSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  vocab_ce_dw_kernel<<<(v + kTile - 1) / kTile, kThreads, kBwdSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<const int*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(g), static_cast<float*>(dw), n, d, v, eps);
  return static_cast<int>(cudaGetLastError());
}
