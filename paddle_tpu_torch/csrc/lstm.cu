// Fused LSTM recurrence for Hopper (sm_90a): the forward and the backward
// kernel, each one persistent cooperative launch over all T time steps.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/recurrence.py:
// _fwd_kernel (:119, called from _fwd_call at :216) and _bwd_kernel (:150,
// called from _bwd_call at :247), the custom-VJP pair behind fused_lstm.
// Operands are time-major float32: xs (T, N, 4H) is the projected,
// bias-added input, W (H, 4H) the recurrent weights, h0/c0 (N, H), sl (N,)
// int32 lengths.  Gate columns are [candidate, input, forget, output].
//
//   forward, for t = 0 .. T-1:
//     gates = xs[t] + h W;  i, f, o = sigmoid;  c' = f c + i tanh(cand)
//     h' = o tanh(c');  rows whose step is not valid keep (h, c)
//     hs[t] = h, cs[t] = c                       (every step is written)
//   backward, for t = T-1 .. 0: the gates are recomputed from hs[t-1],
//     cs[t-1] (h0, c0 at t = 0); dg (N, 4H) is zero on frozen rows and is
//     dxs[t]; dh_{t-1} = dg W^T; dW += h_{t-1}^T dg; frozen rows pass
//     (dh, dc) through; the last carries are dh0, dc0.
//   A step is valid for row n when t < sl[n]; with rev (the caller flipped
//   the time axis) when T-1-t < sl[n].
//
// Design.  A TPU grid step owns a time block and whole (N, H) operands in
// VMEM; here W (4 MB at H = 512) does not fit one SM, so the work is split
// by hidden unit: block b owns units 4b .. 4b+3 and their 16 gate columns.
// Its (H x 16) slice of W is loaded into shared memory once and stays for
// all T steps.  Every step needs all of h_{t-1}: the blocks exchange it
// through the output itself (hs[t] is written, a grid-wide barrier
// follows, and the next step reads hs[t] from L2 with ld.global.cg, since
// L1 is not coherent across SMs inside one kernel).  The barrier is
// cooperative_groups' grid sync, so the grid must be co-resident: H / 4
// blocks of 256 threads, one per SM; the entry points check that with the
// occupancy API and return an error instead of hanging.
//  - forward: per step and 128-row tile a block multiplies h_{t-1}
//    (streamed through shared memory in 64-deep chunks, the next chunk
//    prefetched into registers) with its W slice; a thread owns 2 rows x
//    the 4 gates of one unit, so the gate arithmetic is thread-local.
//  - backward, phase 1: the same product recomputes the gates; the thread
//    forms dg for its columns, writes them to dxs[t] (the exchange buffer
//    of phase 2) and to shared memory, and the block adds h_{t-1}^T dg
//    into its (H x 16) slice of dW, held in shared memory for the whole
//    sequence and written once at the end.  Grid barrier.  Phase 2: the
//    block reads all of dxs[t] (from L2) and forms dh_{t-1} for its own
//    units with its 4 rows of W (a second resident slice).  Phase 1 of the
//    next step needs only the block's own dh, so one barrier a step is
//    enough.  The (dh, dc) carries live in the dh0 / dc0 outputs.
//    No atomics anywhere: two runs give the same bits.
// Ragged sizes: any N >= 1, T >= 1; H a multiple of 4, H <= 512.  Rows
// past N and depths past H are zero in the staged tiles and are never
// written.
//
// What bounds them on the H100 (float32 peak 67 TFLOP/s, 3.35 TB/s):
// operations on paper (forward 2 T N H 4H, backward 6 T N H 4H with the
// recompute); in fact the chain of T dependent barriers and the re-reads
// of h_{t-1} and dg from L2 by every block (PERF.md has the times).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = 4;              // hidden units a block owns
constexpr int kCols = 4 * kUnits;      // their gate columns
constexpr int kRows = 128;             // rows of a tile
constexpr int kChunk = 64;             // depth of a staged chunk
constexpr int kPitch = kChunk + 4;     // pitch of a staged row
constexpr int kMaxH = 512;
constexpr int kStageFloats = kRows * kPitch;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// One 128 x 64 chunk of a row-major matrix (rows x ld) in registers:
// element (row0 + r, col0 + c), zero past nrows / ncols.  Read from L2
// (ld.global.cg): the matrix may have been written by other blocks of
// this launch.  ld and col0 are multiples of 4 and the base is 16-byte
// aligned, so every float4 is whole.
struct Stage {
  float4 v[8];
};

__device__ __forceinline__ void stage_load(Stage& s, const float* src, int ld,
                                           int row0, int nrows, int col0,
                                           int ncols) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = row0 + (idx >> 4);
    const int c = col0 + ((idx & 15) << 2);
    s.v[i] = (r < nrows && c < ncols)
                 ? __ldcg(reinterpret_cast<const float4*>(
                       src + static_cast<size_t>(r) * ld + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void stage_store(const Stage& s, float* buf) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    *reinterpret_cast<float4*>(buf + (idx >> 4) * kPitch +
                               ((idx & 15) << 2)) = s.v[i];
  }
}

// acc[r][g] += sum_k hprev[row0 + rp + 64 r][k] * Ws[k][u][g] for the
// thread's unit u = tid & 3 and row pair rp = tid >> 2.  Ws has
// round_up(H, 64) rows, zero past H.  Ends with a block barrier.
__device__ __forceinline__ void gate_product(float (&acc)[2][4],
                                             const float* hprev, int H,
                                             int row0, int N, const float* Ws,
                                             float* stage) {
  const int u = threadIdx.x & 3, rp = threadIdx.x >> 2;
  const int nchunks = (H + kChunk - 1) / kChunk;
  Stage st;
  stage_load(st, hprev, H, row0, N, 0, H);
  for (int c = 0; c < nchunks; ++c) {
    float* buf = stage + (c & 1) * kStageFloats;
    stage_store(st, buf);
    __syncthreads();
    if (c + 1 < nchunks) stage_load(st, hprev, H, row0, N, (c + 1) * kChunk, H);
    const float* a0 = buf + rp * kPitch;
    const float* a1 = buf + (rp + 64) * kPitch;
    const float* wc = Ws + c * kChunk * kCols + u * 4;
#pragma unroll 4
    for (int k = 0; k < kChunk; k += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
      const float4 x1 = *reinterpret_cast<const float4*>(a1 + k);
      const float xa[4] = {x0.x, x0.y, x0.z, x0.w};
      const float xb[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 wv =
            *reinterpret_cast<const float4*>(wc + (k + kk) * kCols);
        acc[0][0] = fmaf(xa[kk], wv.x, acc[0][0]);
        acc[0][1] = fmaf(xa[kk], wv.y, acc[0][1]);
        acc[0][2] = fmaf(xa[kk], wv.z, acc[0][2]);
        acc[0][3] = fmaf(xa[kk], wv.w, acc[0][3]);
        acc[1][0] = fmaf(xb[kk], wv.x, acc[1][0]);
        acc[1][1] = fmaf(xb[kk], wv.y, acc[1][1]);
        acc[1][2] = fmaf(xb[kk], wv.z, acc[1][2]);
        acc[1][3] = fmaf(xb[kk], wv.w, acc[1][3]);
      }
    }
  }
  __syncthreads();
}

// dWs[k][u][g] += sum_n hprev[row0 + n][k] * dgs[n][u][g] over the tile's
// 128 rows.  A thread owns 4 depths x the 4 gates of one unit over a
// quarter of the rows; the four quarters add into dWs one after another,
// so the sum has one order.  Ends with a block barrier.
__device__ __forceinline__ void dw_product(const float* hprev, int H, int row0,
                                           int N, const float* dgs, float* dWs,
                                           float* stage) {
  const int u = threadIdx.x & 3, kq = (threadIdx.x >> 2) & 15;
  const int ngrp = threadIdx.x >> 6;
  const int nchunks = (H + kChunk - 1) / kChunk;
  Stage st;
  stage_load(st, hprev, H, row0, N, 0, H);
  for (int c = 0; c < nchunks; ++c) {
    float* buf = stage + (c & 1) * kStageFloats;
    stage_store(st, buf);
    __syncthreads();
    if (c + 1 < nchunks) stage_load(st, hprev, H, row0, N, (c + 1) * kChunk, H);
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    const float* a = buf + ngrp * 32 * kPitch + kq * 4;
    const float* d = dgs + ngrp * 32 * kCols + u * 4;
#pragma unroll 8
    for (int n = 0; n < 32; ++n) {
      const float4 hv = *reinterpret_cast<const float4*>(a + n * kPitch);
      const float4 dv = *reinterpret_cast<const float4*>(d + n * kCols);
      const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[kk][0] = fmaf(hk[kk], dv.x, acc[kk][0]);
        acc[kk][1] = fmaf(hk[kk], dv.y, acc[kk][1]);
        acc[kk][2] = fmaf(hk[kk], dv.z, acc[kk][2]);
        acc[kk][3] = fmaf(hk[kk], dv.w, acc[kk][3]);
      }
    }
    float* o = dWs + (c * kChunk + kq * 4) * kCols + u * 4;
    for (int p = 0; p < 4; ++p) {
      if (ngrp == p) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float4* q = reinterpret_cast<float4*>(o + kk * kCols);
          float4 v = *q;
          v.x += acc[kk][0];
          v.y += acc[kk][1];
          v.z += acc[kk][2];
          v.w += acc[kk][3];
          *q = v;
        }
      }
      __syncthreads();
    }
  }
}

// acc[r][u] = sum_c dxt[row0 + rp + 64 r][c] * Wr[u][c] over all G = 4H
// gate columns, for the thread's row pair rp = tid >> 2; the four lanes
// tid & 3 of a row pair each take every fourth float4 of a chunk and are
// summed by shuffles (all four end with the total).  Wr has gpad columns,
// zero past G.  Ends with a block barrier.
__device__ __forceinline__ void dh_product(float (&acc)[2][4], const float* dxt,
                                           int G, int row0, int N,
                                           const float* Wr, int gpad,
                                           float* stage) {
  const int kp = threadIdx.x & 3, rp = threadIdx.x >> 2;
  const int nchunks = gpad / kChunk;
  Stage st;
  stage_load(st, dxt, G, row0, N, 0, G);
  for (int c = 0; c < nchunks; ++c) {
    float* buf = stage + (c & 1) * kStageFloats;
    stage_store(st, buf);
    __syncthreads();
    if (c + 1 < nchunks) stage_load(st, dxt, G, row0, N, (c + 1) * kChunk, G);
    const float* a0 = buf + rp * kPitch + kp * 4;
    const float* a1 = buf + (rp + 64) * kPitch + kp * 4;
    const float* wr = Wr + c * kChunk + kp * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 d0 = *reinterpret_cast<const float4*>(a0 + i * 16);
      const float4 d1 = *reinterpret_cast<const float4*>(a1 + i * 16);
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const float4 wv =
            *reinterpret_cast<const float4*>(wr + u * gpad + i * 16);
        acc[0][u] = fmaf(d0.x, wv.x, acc[0][u]);
        acc[0][u] = fmaf(d0.y, wv.y, acc[0][u]);
        acc[0][u] = fmaf(d0.z, wv.z, acc[0][u]);
        acc[0][u] = fmaf(d0.w, wv.w, acc[0][u]);
        acc[1][u] = fmaf(d1.x, wv.x, acc[1][u]);
        acc[1][u] = fmaf(d1.y, wv.y, acc[1][u]);
        acc[1][u] = fmaf(d1.z, wv.z, acc[1][u]);
        acc[1][u] = fmaf(d1.w, wv.w, acc[1][u]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      acc[r][u] += __shfl_xor_sync(0xffffffffu, acc[r][u], 1);
      acc[r][u] += __shfl_xor_sync(0xffffffffu, acc[r][u], 2);
    }
}

// The block's slice of W as Ws[k][u][g] = W[k][g H + j0 + u], zero for
// k >= H (hpad rows).
__device__ __forceinline__ void load_w_slice(float* Ws, const float* w, int H,
                                             int hpad, int j0) {
  for (int idx = threadIdx.x; idx < hpad * kCols; idx += kThreads) {
    const int k = idx >> 4, u = (idx >> 2) & 3, g = idx & 3;
    Ws[idx] = k < H ? w[static_cast<size_t>(k) * 4 * H + g * H + j0 + u] : 0.f;
  }
}

__device__ __forceinline__ bool step_valid(int t, int T, int rev, int len) {
  return (rev ? T - 1 - t : t) < len;
}

__global__ void __launch_bounds__(kThreads, 1)
    lstm_fwd_kernel(const float* __restrict__ xs, const float* __restrict__ w,
                    const float* __restrict__ h0, const float* __restrict__ c0,
                    const int* __restrict__ sl, float* hs, float* cs, int T,
                    int N, int H, int rev) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int hpad = round_up(H, kChunk);
  float* Ws = smem;
  float* stage = Ws + hpad * kCols;
  const int j0 = blockIdx.x * kUnits;
  load_w_slice(Ws, w, H, hpad, j0);
  __syncthreads();
  const int u = threadIdx.x & 3, rp = threadIdx.x >> 2;
  const int j = j0 + u;
  const size_t nh = static_cast<size_t>(N) * H;
  for (int t = 0; t < T; ++t) {
    const float* hprev = t ? hs + (t - 1) * nh : h0;
    const float* cprev = t ? cs + (t - 1) * nh : c0;
    const float* xt = xs + t * nh * 4;
    float* ht = hs + t * nh;
    float* ct = cs + t * nh;
    for (int row0 = 0; row0 < N; row0 += kRows) {
      float x[2][4], hp[2], cp[2];
      bool ok[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = row0 + rp + 64 * r;
        hp[r] = cp[r] = 0.f;
        ok[r] = false;
#pragma unroll
        for (int g = 0; g < 4; ++g) x[r][g] = 0.f;
        if (n < N) {
          const float* xr = xt + static_cast<size_t>(n) * 4 * H + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) x[r][g] = __ldg(xr + g * H);
          hp[r] = __ldcg(hprev + static_cast<size_t>(n) * H + j);
          cp[r] = __ldcg(cprev + static_cast<size_t>(n) * H + j);
          ok[r] = step_valid(t, T, rev, sl[n]);
        }
      }
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      gate_product(acc, hprev, H, row0, N, Ws, stage);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = row0 + rp + 64 * r;
        if (n >= N) continue;
        const float ca = tanhf(x[r][0] + acc[r][0]);
        const float ig = sigmoid_f(x[r][1] + acc[r][1]);
        const float fg = sigmoid_f(x[r][2] + acc[r][2]);
        const float og = sigmoid_f(x[r][3] + acc[r][3]);
        float c_new = fg * cp[r] + ig * ca;
        float h_new = og * tanhf(c_new);
        if (!ok[r]) {
          c_new = cp[r];
          h_new = hp[r];
        }
        __stcg(ht + static_cast<size_t>(n) * H + j, h_new);
        __stcg(ct + static_cast<size_t>(n) * H + j, c_new);
      }
    }
    __threadfence();
    grid.sync();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    lstm_bwd_kernel(const float* __restrict__ xs, const float* __restrict__ w,
                    const float* __restrict__ h0, const float* __restrict__ c0,
                    const int* __restrict__ sl, const float* __restrict__ hs,
                    const float* __restrict__ cs,
                    const float* __restrict__ dhs,
                    const float* __restrict__ dcs, float* dxs, float* dw,
                    float* dh0, float* dc0, int T, int N, int H, int rev) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int hpad = round_up(H, kChunk);
  const int G = 4 * H;
  const int gpad = round_up(G, kChunk);
  float* Ws = smem;                       // [hpad][4 units][4 gates]
  float* Wr = Ws + hpad * kCols;          // [4 units][gpad]
  float* dWs = Wr + kUnits * gpad;        // as Ws
  float* stage = dWs + hpad * kCols;      // 2 x [128][kPitch]
  float* dgs = stage + 2 * kStageFloats;  // [128][4 units][4 gates]
  const int j0 = blockIdx.x * kUnits;
  load_w_slice(Ws, w, H, hpad, j0);
  for (int idx = threadIdx.x; idx < kUnits * gpad; idx += kThreads) {
    const int uu = idx / gpad, c = idx % gpad;
    Wr[idx] = c < G ? w[static_cast<size_t>(j0 + uu) * G + c] : 0.f;
  }
  for (int idx = threadIdx.x; idx < hpad * kCols; idx += kThreads)
    dWs[idx] = 0.f;
  __syncthreads();
  const int u = threadIdx.x & 3, rp = threadIdx.x >> 2;
  const int j = j0 + u;
  const size_t nh = static_cast<size_t>(N) * H;
  for (int t = T - 1; t >= 0; --t) {
    const float* hprev = t ? hs + (t - 1) * nh : h0;
    const float* cprev = t ? cs + (t - 1) * nh : c0;
    const float* xt = xs + t * nh * 4;
    const float* dht = dhs + t * nh;
    const float* dct = dcs + t * nh;
    float* dxt = dxs + t * nh * 4;
    const bool last = t == T - 1;     // the carries start at zero
    // phase 1: gates again, dg for the block's columns, dW
    for (int row0 = 0; row0 < N; row0 += kRows) {
      float x[2][4], cp[2], dh_in[2], dc_in[2];
      bool ok[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = row0 + rp + 64 * r;
        cp[r] = dh_in[r] = dc_in[r] = 0.f;
        ok[r] = false;
#pragma unroll
        for (int g = 0; g < 4; ++g) x[r][g] = 0.f;
        if (n < N) {
          const size_t e = static_cast<size_t>(n) * H + j;
          const float* xr = xt + static_cast<size_t>(n) * G + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) x[r][g] = __ldg(xr + g * H);
          cp[r] = __ldg(cprev + e);
          dh_in[r] = __ldg(dht + e) + (last ? 0.f : __ldcg(dh0 + e));
          dc_in[r] = __ldg(dct + e) + (last ? 0.f : __ldcg(dc0 + e));
          ok[r] = step_valid(t, T, rev, sl[n]);
        }
      }
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      gate_product(acc, hprev, H, row0, N, Ws, stage);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = row0 + rp + 64 * r;
        float4 dg = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n < N) {
          const float ca = tanhf(x[r][0] + acc[r][0]);
          const float ig = sigmoid_f(x[r][1] + acc[r][1]);
          const float fg = sigmoid_f(x[r][2] + acc[r][2]);
          const float og = sigmoid_f(x[r][3] + acc[r][3]);
          const float c_new = fg * cp[r] + ig * ca;
          const float tc = tanhf(c_new);
          const float dh_tot = dh_in[r], dc_pass = dc_in[r];
          const float dc_tot = dc_pass + dh_tot * og * (1.f - tc * tc);
          float dc_carry = dc_pass;
          if (ok[r]) {
            dg.x = (dc_tot * ig) * (1.f - ca * ca);
            dg.y = (dc_tot * ca) * ig * (1.f - ig);
            dg.z = (dc_tot * cp[r]) * fg * (1.f - fg);
            dg.w = (dh_tot * tc) * og * (1.f - og);
            dc_carry = dc_tot * fg;
          }
          __stcg(dc0 + static_cast<size_t>(n) * H + j, dc_carry);
          float* xo = dxt + static_cast<size_t>(n) * G + j;
          __stcg(xo, dg.x);
          __stcg(xo + H, dg.y);
          __stcg(xo + 2 * H, dg.z);
          __stcg(xo + 3 * H, dg.w);
        }
        *reinterpret_cast<float4*>(dgs + (rp + 64 * r) * kCols + u * 4) = dg;
      }
      __syncthreads();
      dw_product(hprev, H, row0, N, dgs, dWs, stage);
    }
    __threadfence();
    grid.sync();
    // phase 2: dh_{t-1} for the block's units from all of dxs[t]
    for (int row0 = 0; row0 < N; row0 += kRows) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      dh_product(acc, dxt, G, row0, N, Wr, gpad, stage);
      if ((threadIdx.x & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = row0 + rp + 64 * r;
          if (n >= N) continue;
          const bool valid = step_valid(t, T, rev, sl[n]);
#pragma unroll
          for (int uu = 0; uu < kUnits; ++uu) {
            const size_t e = static_cast<size_t>(n) * H + j0 + uu;
            float v = acc[r][uu];
            if (!valid) v = __ldg(dht + e) + (last ? 0.f : __ldcg(dh0 + e));
            __stcg(dh0 + e, v);
          }
        }
      }
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < H * kCols; idx += kThreads) {
    const int k = idx >> 4, uu = (idx >> 2) & 3, g = idx & 3;
    dw[static_cast<size_t>(k) * G + g * H + j0 + uu] = dWs[idx];
  }
}

size_t fwd_smem(int H) {
  return (static_cast<size_t>(round_up(H, kChunk)) * kCols +
          2 * kStageFloats) * sizeof(float);
}

size_t bwd_smem(int H) {
  return (2 * static_cast<size_t>(round_up(H, kChunk)) * kCols +
          static_cast<size_t>(kUnits) * round_up(4 * H, kChunk) +
          2 * kStageFloats + kRows * kCols) * sizeof(float);
}

int check_dims(int t, int n, int h) {
  if (t < 1 || n < 1 || h < kUnits || h % kUnits || h > kMaxH) return -1;
  return 0;
}

// Opt into the dynamic shared memory and check that `blocks` blocks can
// all be resident at once: a grid barrier among blocks that are not never
// returns.  0, a CUDA error, -2 (no cooperative launch on this device)
// or -3 (the grid cannot be co-resident).
int prepare(const void* kernel, int blocks, size_t smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return -2;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * sms < blocks) return -3;
  return 0;
}

}  // namespace

// xs (t, n, 4h), w (h, 4h), h0 / c0 (n, h) float32; sl (n,) int32; hs, cs
// (t, n, h) float32 outputs; all contiguous and 16-byte aligned.  rev: the
// caller flipped the time axis.  Launches on `stream` without
// synchronising; returns 0, a CUDA error code, or -1 (sizes), -2, -3 (see
// prepare).
extern "C" int lstm_fwd_launch(const void* xs, const void* w, const void* h0,
                               const void* c0, const void* sl, void* hs,
                               void* cs, int t, int n, int h, int rev,
                               int device, void* stream) {
  int rc = check_dims(t, n, h);
  if (rc) return rc;
  const int blocks = h / kUnits;
  const size_t smem = fwd_smem(h);
  rc = prepare(reinterpret_cast<const void*>(lstm_fwd_kernel), blocks, smem,
               device);
  if (rc) return rc;
  void* args[] = {&xs, &w, &h0, &c0, &sl, &hs, &cs, &t, &n, &h, &rev};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm_fwd_kernel), dim3(blocks),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// As the forward, plus hs, cs (the forward's outputs) and the cotangents
// dhs, dcs (t, n, h); outputs dxs (t, n, 4h), dw (h, 4h), dh0, dc0 (n, h).
extern "C" int lstm_bwd_launch(const void* xs, const void* w, const void* h0,
                               const void* c0, const void* sl, const void* hs,
                               const void* cs, const void* dhs,
                               const void* dcs, void* dxs, void* dw, void* dh0,
                               void* dc0, int t, int n, int h, int rev,
                               int device, void* stream) {
  int rc = check_dims(t, n, h);
  if (rc) return rc;
  const int blocks = h / kUnits;
  const size_t smem = bwd_smem(h);
  rc = prepare(reinterpret_cast<const void*>(lstm_bwd_kernel), blocks, smem,
               device);
  if (rc) return rc;
  void* args[] = {&xs, &w,   &h0, &c0,  &sl,  &hs, &cs, &dhs, &dcs,
                  &dxs, &dw, &dh0, &dc0, &t,  &n,  &h,  &rev};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm_bwd_kernel), dim3(blocks),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
