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
// by hidden unit, and every step needs all of h_{t-1}: the blocks exchange
// it through the output itself (hs[t] is written, a grid-wide barrier
// follows, and the next step reads hs[t] through L2, with cp.async.cg or
// ld.global.cg, since L1 is not coherent across SMs inside one kernel).
// The barrier is cooperative_groups' grid sync, which orders the grid's
// memory itself (no per-thread fence before it), so the grid must be
// co-resident; the entry points check that with the occupancy API and
// return an error instead of hanging.
//
// Both kernels share one grid and one gate product, on the tensor cores
// (3xTF32 mma.sync with the fragments, split and accumulation rule of
// csrc/flash_mma.cuh): 2 row groups x ceil(H / 8) unit groups (128 blocks
// of 256 threads at H = 512, one an SM); block (g, u) owns units 8u ..
// 8u+7, their 32 gate columns, and the 64-row tiles g, g + 2, .. of the
// batch.  Its (H x 32) slice of W stays in shared memory, float32, for
// all T steps.  Per step and tile the block stages its 64 rows of h_{t-1}
// once (cp.async into a tile XOR-swizzled by row bits 0, 1, 2 to column
// bits 3, 4, 2, so that a fragment read of 8 rows x 4 columns and one of
// 4 rows x 8 columns both hit 32 distinct banks).  The gate product
// (64 x 32, K = H) runs on 8 warps, 4 row tiles x 2 halves of the depth;
// each 64-deep K-slice goes into its own tensor-core accumulators (even
// and odd 8-deep steps apart) and is added to float32 registers.  The
// halves swap the rows each keeps through shared memory, and lane (gq,
// tq) of a warp then holds the four gates of units tq and 4 + tq for one
// row (gate_col's column order makes that so), so the cell update is
// thread-local.  Units past H are zero in the W slice and never written.
//  - forward: the tile is copied in one cp.async group per 64-deep slice
//    of each half (4 groups at H = 512), and the warps start on a slice
//    as soon as it has landed, so the product overlaps the rest of the
//    copy.  A step moves 16 MB through L2 at N = 128, H = 512 (each block
//    reads its 64 rows of h_{t-1}, 128 KB), half of what H / 4 blocks
//    that each read all of h_{t-1} would.  A block's own operands of the
//    next step (xs[t+1] of its rows and units, and the h_t, c_t it wrote
//    itself, which frozen rows keep) are loaded before the grid barrier;
//    hs[t] and cs[t] are written with st.global.cg.  W is split into its
//    big and small TF32 parts as it is read, not once at launch: the two
//    planes (128 KB at H = 512) and the 128 KB h tile do not fit the
//    227 KB of shared memory together, and a ring of depth chunks small
//    enough to fit beside the planes costs a block barrier per chunk.
//    The forward's gate slices, splits and pass order are the backward's
//    recompute's, so both see the same gate bits.
//  - backward: after the gates (recomputed as above from the staged
//    h_{t-1}), each lane forms its row's dg for two units, writes dxs[t]
//    and stores dg split into big / small planes.  dW (H x 32) += h^T dg:
//    warp w owns rows w, w + 8, .. of H in 16-row tiles, reading the
//    staged h tile the other way (4 rows x 8 depths); each tile's product
//    goes into fresh accumulators and is added to float32 registers that
//    hold the row group's dW for the whole launch.  Then the block's
//    partial dh, transposed (H x 64) = W_slice dg^T with K = 32, goes to
//    a scratch laid out [destination unit group][source unit group][row]
//    [8 units] (two such buffers, by the parity of t, so that no block
//    overwrites a partial another block has yet to read).  Grid barrier.
//    Phase 2: each block sums, for its rows, the ceil(H / 8) partials of
//    its own 8 units in a fixed order (a quarter of the sources a lane,
//    then xor-shuffles), which is dh_{t-1}.  A step thus moves 48 MB
//    through L2 at N = 128, H = 512 (each block: its 64 rows of h_{t-1},
//    128 KB of partials out and 128 KB in), where the CUDA-core design
//    (H / 4 blocks each reading h_{t-1} twice and all of dg) moved 192 MB.
//    The next step's h rows are copied, and its elementwise operands
//    loaded, while the partial product, the barrier and phase 2 run.  At
//    the end the two row groups' dW meet in the scratch and are added in
//    group order.  The (dh, dc) carries live in the dh0 / dc0 outputs.
// No atomics anywhere: two runs give the same bits.
// Ragged sizes: any N >= 1, T >= 1; H a multiple of 4, H <= 512.  Rows
// past N and depths past H are zero in the staged tiles and are never
// written.
//
// What bounds them on the H100 (TF32 tensor cores 495 TFLOP/s, float32
// 67 TFLOP/s, 3.35 TB/s): operations on paper (forward 2 T N H 4H,
// backward 6 T N H 4H with the recompute, three TF32 passes each);
// in fact the chain of T dependent barriers and the per-step traffic
// through L2 (PERF.md has the times).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kHStep = 4;              // H must be a multiple of this
constexpr int kMaxH = 512;
constexpr int kBRows = 64;             // rows of a tile
constexpr int kGroups = 2;             // row groups of the grid
constexpr int kBUnits = 8;             // hidden units a block owns
constexpr int kBCols = 4 * kBUnits;    // their gate columns
constexpr int kSlice = 8;              // 8-deep k-steps in a K-slice

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ bool step_valid(int t, int T, int rev, int len) {
  return (rev ? T - 1 - t : t) < len;
}

// ---- shared by both kernels: the W slice, the h tile, the gate product --

// A swizzled [rows][pitch] array, pitch a multiple of 32 (the h tile, the
// W slice, the dg planes): column bits 3, 4 and 2 take row bits 0, 1 and
// 2, so a fragment read of 8 rows x 4 columns and one of 4 rows x 8
// columns both hit 32 distinct banks, and 4-float chunks stay whole.
__device__ __forceinline__ int ath(int r, int c, int pitch) {
  return r * pitch + (c ^ (((r & 3) << 3) | (r & 4)));
}

// Column of gate q of unit u among the block's 32: lane t of a C
// fragment pair holds columns 2t, 2t+1 of two n-tiles, which are the four
// gates of one unit.
__device__ __forceinline__ int gate_col(int q, int u) {
  return 16 * (u >> 2) + 8 * (q >> 1) + 2 * (u & 3) + (q & 1);
}

// The block's (H x 32) slice of W, swizzled, columns in gate_col order,
// zero for units past H and rows past H (up to round_up(H, 32)).
__device__ __forceinline__ void load_w_slice(float* wsl, const float* w,
                                             int H, int j0) {
  const int hp32 = round_up(H, 32);
  for (int idx = threadIdx.x; idx < hp32 * kBCols; idx += kThreads) {
    const int k = idx >> 5, c = idx & 31;
    const int uu = 4 * (c >> 4) + ((c & 7) >> 1);
    const int q = 2 * ((c >> 3) & 1) + (c & 1);
    wsl[ath(k, c, kBCols)] =
        k < H && j0 + uu < H
            ? w[static_cast<size_t>(k) * 4 * H + q * H + j0 + uu]
            : 0.f;
  }
}

// Issue the copies of columns [c_lo, c_hi) (multiples of 4) of rows
// [row0, row0 + 64) of hprev (N x H) into the swizzled tile, zeros past
// N and H (no commit).  Four threads a row: thread i copies the 16-byte
// chunks i % 4, i % 4 + 4, .. of row i / 4, so issuing takes no division.
__device__ __forceinline__ void issue_h_cols(float* tile, const float* hprev,
                                             int row0, int N, int H,
                                             int pitch, int c_lo, int c_hi) {
  static_assert(kThreads == 4 * kBRows, "four threads a row");
  const int r = threadIdx.x >> 2, row = row0 + r;
  const float* src = hprev + static_cast<size_t>(row < N ? row : 0) * H;
  for (int k = c_lo + 4 * (threadIdx.x & 3); k < c_hi; k += 16) {
    const bool ok = row < N && k < H;
    flash::cp16(tile + ath(r, k, pitch), ok ? src + k : hprev, ok);
  }
}

// x = big + small (flash::split) for the four registers of a fragment.
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) flash::split(x[i], big[i], small[i]);
}

// The 3xTF32 passes of one k-step over NT tiles, small terms first.
template <int NT>
__device__ __forceinline__ void mma3(float (&c)[NT][4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[NT][2],
                                     const uint32_t (&bs)[NT][2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) flash::mma_tf32(c[j], as, bb[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) flash::mma_tf32(c[j], ab, bs[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) flash::mma_tf32(c[j], ab, bb[j]);
}

// acc (rows mt*16 + gq (+8) x the 32 gate columns) += the staged h tile
// times the W slice over k-steps [s_from, s_to): each K-slice of up to 8
// k-steps (64 deep) from s_from in its own accumulators, even and odd
// steps apart, added to acc in float32.
__device__ __forceinline__ void gate_slices(float (&acc)[4][4],
                                            const float* tile,
                                            const float* wsl, int hp32,
                                            int mt, int gq, int tq,
                                            int s_from, int s_to) {
  for (int s0 = s_from; s0 < s_to; s0 += kSlice) {
    float pe[4][4], po[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) pe[nt][r] = po[nt][r] = 0.f;
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      if (s0 + i >= s_to) break;
      const int kk = (s0 + i) * 8, r0 = mt * 16 + gq;
      float a[4];
      a[0] = tile[ath(r0, kk + tq, hp32)];
      a[1] = tile[ath(r0 + 8, kk + tq, hp32)];
      a[2] = tile[ath(r0, kk + tq + 4, hp32)];
      a[3] = tile[ath(r0 + 8, kk + tq + 4, hp32)];
      uint32_t ab[4], as[4];
      split4(a, ab, as);
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        flash::split(wsl[ath(kk + tq, nt * 8 + gq, kBCols)], bb[nt][0],
                     bs[nt][0]);
        flash::split(wsl[ath(kk + tq + 4, nt * 8 + gq, kBCols)], bb[nt][1],
                     bs[nt][1]);
      }
      if (i & 1)
        mma3<4>(po, ab, as, bb, bs);
      else
        mma3<4>(pe, ab, as, bb, bs);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[nt][r] += pe[nt][r] + po[nt][r];
  }
}

// Warp (mt, kh) formed rows mt*16 + gq and + 8 over half kh of the
// depth; it keeps row mt*16 + gq + 8 kh and hands the other row's sums to
// the warp of the other half through xg ([4][2][4][2][32] floats).
__device__ __forceinline__ void gates_out(const float (&acc)[4][4],
                                          float* xg, int mt, int kh,
                                          int lane) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      xg[(((mt * 2 + 1 - kh) * 4 + nt) * 2 + e) * 32 + lane] =
          kh ? acc[nt][e] : acc[nt][2 + e];
}

// After a block barrier: column 2 tq + e of n-tile nt of the kept row,
// both halves of the depth summed.
__device__ __forceinline__ float gate_sum(const float (&acc)[4][4],
                                          const float* xg, int mt, int kh,
                                          int nt, int e, int lane) {
  return (kh ? acc[nt][2 + e] : acc[nt][e]) +
         xg[(((mt * 2 + kh) * 4 + nt) * 2 + e) * 32 + lane];
}

// ---- forward ----------------------------------------------------------------

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most n (0 .. 3) of this thread's cp.async groups are
// still in flight.
__device__ __forceinline__ void cp_wait_pending(int n) {
  if (n >= 3)
    cp_wait<3>();
  else if (n == 2)
    cp_wait<2>();
  else if (n == 1)
    cp_wait<1>();
  else
    cp_wait<0>();
}

// Issue the copies of rows [row0, row0 + 64) of hprev into the tile as
// n_copy cp.async groups: group g holds the g-th K-slice (k-steps 8g ..
// 8g + 7) of each half of the depth, `half` k-steps a half.
__device__ __forceinline__ void issue_h_slices(float* tile,
                                               const float* hprev, int row0,
                                               int N, int H, int pitch,
                                               int half, int n_copy) {
  const int nks = pitch / 8;
  for (int g = 0; g < n_copy; ++g) {
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const int lo = kh * half + kSlice * g;
      const int hi = min(min(lo + kSlice, (kh + 1) * half), nks);
      if (lo < hi)
        issue_h_cols(tile, hprev, row0, N, H, pitch, 8 * lo, 8 * hi);
    }
    flash::cp_commit();
  }
}

// A lane's operands of a tile at step t: xs[t] of its row and two units,
// and the row's h_{t-1}, c_{t-1} there (h0, c0, or what this same thread
// wrote at step t-1), which a frozen row keeps.
struct FwdIn {
  float x[2][4], hp[2], cp[2];
  bool in[2], ok;
};

__device__ __forceinline__ void load_fwd_in(FwdIn& s, const float* xs,
                                            const float* hprev,
                                            const float* cprev,
                                            const int* sl, int t, int T,
                                            int rev, int n, int N, int H,
                                            int j0, int tq) {
  const size_t nh = static_cast<size_t>(N) * H;
  const bool row_ok = n < N;
  s.ok = row_ok && step_valid(t, T, rev, sl[n]);
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int j = j0 + 4 * v + tq;
    s.in[v] = row_ok && j < H;
    s.hp[v] = s.cp[v] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) s.x[v][q] = 0.f;
    if (s.in[v]) {
      const size_t e = static_cast<size_t>(n) * H + j;
      const float* xr = xs + t * nh * 4 + static_cast<size_t>(n) * 4 * H + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) s.x[v][q] = __ldg(xr + q * H);
      s.hp[v] = __ldcg(hprev + e);
      s.cp[v] = __ldcg(cprev + e);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    lstm_fwd_kernel(const float* __restrict__ xs, const float* __restrict__ w,
                    const float* __restrict__ h0, const float* __restrict__ c0,
                    const int* __restrict__ sl, float* hs, float* cs, int T,
                    int N, int H, int rev) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int U = (H + kBUnits - 1) / kBUnits, hp32 = round_up(H, 32);
  const int grp = blockIdx.x / U, ub = blockIdx.x % U;   // row group, units
  const int j0 = ub * kBUnits;
  float* wsl = smem;                        // [hp32][32] W slice, float32
  float* tile = wsl + hp32 * kBCols;        // [64][hp32] h rows
  float* xg = tile + kBRows * hp32;         // [4][2][4][2][32] gate halves
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // warp (mt, kh): rows mt*16 .. +16 over half kh of the depth; lane
  // (gq, tq) then owns row er, units tq and 4 + tq
  const int mt = warp & 3, kh = warp >> 2;
  const int er = mt * 16 + gq + 8 * kh;
  const int nks = hp32 / 8, half = (nks + 1) / 2;
  const int ks_lo = kh * half, ks_hi = min(nks, ks_lo + half);
  const int n_copy = (half + kSlice - 1) / kSlice;   // copy groups, <= 4
  const size_t nh = static_cast<size_t>(N) * H;
  const int first_row = kBRows * grp, stride = kBRows * kGroups;
  const bool has_rows = first_row < N;
  if (has_rows)     // the first tile lands while the W slice loads
    issue_h_slices(tile, h0, first_row, N, H, hp32, half, n_copy);
  load_w_slice(wsl, w, H, j0);
  FwdIn in;
  if (has_rows)
    load_fwd_in(in, xs, h0, c0, sl, 0, T, rev, first_row + er, N, H, j0,
                tq);
  for (int t = 0; t < T; ++t) {
    const float* hprev = t ? hs + (t - 1) * nh : h0;
    const float* cprev = t ? cs + (t - 1) * nh : c0;
    float* ht = hs + t * nh;
    float* ct = cs + t * nh;
    for (int row0 = first_row; row0 < N; row0 += stride) {
      const int n = row0 + er;
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
      for (int g = 0; g < n_copy; ++g) {
        cp_wait_pending(n_copy - 1 - g);
        __syncthreads();    // K-slice g of both halves is in
        const int s_from = ks_lo + kSlice * g;
        gate_slices(acc, tile, wsl, hp32, mt, gq, tq, s_from,
                    min(s_from + kSlice, ks_hi));
      }
      gates_out(acc, xg, mt, kh, lane);
      __syncthreads();      // the halves are in xg; the tile is free
      if (row0 + stride < N)
        issue_h_slices(tile, hprev, row0 + stride, N, H, hp32, half, n_copy);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        if (!in.in[v]) continue;
        float pre[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pre[q] = in.x[v][q] +
                   gate_sum(acc, xg, mt, kh, 2 * v + (q >> 1), q & 1, lane);
        const float ca = tanhf(pre[0]);
        const float ig = sigmoid_f(pre[1]);
        const float fg = sigmoid_f(pre[2]);
        const float og = sigmoid_f(pre[3]);
        float c_new = fg * in.cp[v] + ig * ca;
        float h_new = og * tanhf(c_new);
        if (!in.ok) {
          c_new = in.cp[v];
          h_new = in.hp[v];
        }
        const size_t e = static_cast<size_t>(n) * H + j0 + 4 * v + tq;
        __stcg(ht + e, h_new);
        __stcg(ct + e, c_new);
      }
      if (row0 + stride < N)       // the next tile of this step
        load_fwd_in(in, xs, hprev, cprev, sl, t, T, rev, row0 + stride + er,
                    N, H, j0, tq);
    }
    if (t + 1 < T) {
      // the next step's own operands need no other block: load them first
      if (has_rows)
        load_fwd_in(in, xs, ht, ct, sl, t + 1, T, rev, first_row + er, N, H,
                    j0, tq);
      grid.sync();
      if (has_rows)
        issue_h_slices(tile, ht, first_row, N, H, hp32, half, n_copy);
    }
  }
}

// ---- backward ---------------------------------------------------------------

// The whole tile [row0, row0 + 64) of hprev as one cp.async group.
__device__ __forceinline__ void issue_h_tile(float* tile, const float* hprev,
                                             int row0, int N, int H,
                                             int pitch) {
  issue_h_cols(tile, hprev, row0, N, H, pitch, 0, pitch);
  flash::cp_commit();
}

// A lane's elementwise operands of a tile: one row, units tq and 4 + tq
// of the block's 8; dc holds the carry already, dh gets it at the tile.
struct StepIn {
  float x[2][4], cp[2], dh[2], dc[2];
  bool in[2], ok;
};

__device__ __forceinline__ void load_step_in(
    StepIn& s, const float* xs, const float* hs, const float* cs,
    const float* c0, const float* dhs, const float* dcs, const int* sl,
    const float* dc0, int t, int T, int rev, int n, int N, int H, int j0,
    int tq) {
  const size_t nh = static_cast<size_t>(N) * H;
  const float* cprev = t ? cs + (t - 1) * nh : c0;
  const bool row_ok = n < N;
  s.ok = row_ok && step_valid(t, T, rev, sl[n]);
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int j = j0 + 4 * v + tq;
    s.in[v] = row_ok && j < H;
    s.cp[v] = s.dh[v] = s.dc[v] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) s.x[v][q] = 0.f;
    if (s.in[v]) {
      const size_t e = static_cast<size_t>(n) * H + j;
      const float* xr = xs + t * nh * 4 + static_cast<size_t>(n) * 4 * H + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) s.x[v][q] = __ldg(xr + q * H);
      s.cp[v] = __ldg(cprev + e);
      s.dh[v] = __ldg(dhs + t * nh + e);
      s.dc[v] = __ldg(dcs + t * nh + e) + (t == T - 1 ? 0.f : __ldcg(dc0 + e));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    lstm_bwd_kernel(const float* __restrict__ xs, const float* __restrict__ w,
                    const float* __restrict__ h0, const float* __restrict__ c0,
                    const int* __restrict__ sl, const float* __restrict__ hs,
                    const float* __restrict__ cs,
                    const float* __restrict__ dhs,
                    const float* __restrict__ dcs, float* dxs, float* dw,
                    float* dh0, float* dc0, float* scratch, int T, int N,
                    int H, int rev) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H, U = (H + kBUnits - 1) / kBUnits;
  const int hp32 = round_up(H, 32);
  const int grp = blockIdx.x / U, ub = blockIdx.x % U;   // row group, units
  const int j0 = ub * kBUnits;
  float* wsl = smem;                        // [hp32][32] W slice, float32
  float* tile = wsl + hp32 * kBCols;        // [64][hp32] h rows
  uint32_t* dgb = reinterpret_cast<uint32_t*>(tile + kBRows * hp32);
  uint32_t* dgs = dgb + kBRows * kBCols;    // [64][32] dg, big / small
  float* xg = reinterpret_cast<float*>(dgs + kBRows * kBCols);
                                            // [4][2][4][2][32] gate halves
  float* partial = scratch;                 // 2 x [U][U][N][8]
  float* dw_part = scratch + 2 * static_cast<size_t>(U) * U * N * kBUnits;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t nh = static_cast<size_t>(N) * H;
  const int first_row = kBRows * grp, stride = kBRows * kGroups;
  const bool has_rows = first_row < N;
  if (has_rows)     // the first tile lands while the W slice loads
    issue_h_tile(tile, T > 1 ? hs + (T - 2) * nh : h0, first_row, N, H,
                 hp32);
  load_w_slice(wsl, w, H, j0);
  // gates: warp (mt, kh) forms rows mt*16 .. +16 x all 32 columns over
  // half kh of the depth; the halves meet in shared memory, and lane
  // (gq, tq) then owns row er = mt*16 + gq + 8 kh, units tq and 4 + tq,
  // whose 4 gates are columns 2tq, 2tq+1 of n-tiles 0, 1 and 2, 3
  const int mt = warp & 3, kh = warp >> 2;
  const int er = mt * 16 + gq + 8 * kh;
  // dW (H x 32) of the block's row group for the whole launch: warp w
  // owns hidden row tiles w, w + 8, w + 16, w + 24 and the 4 column tiles
  float dwacc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) dwacc[i][nt][r] = 0.f;
  const int nks = hp32 / 8, half = (nks + 1) / 2;
  const int ks_lo = kh * half, ks_hi = min(nks, ks_lo + half);
  StepIn in;
  if (has_rows)
    load_step_in(in, xs, hs, cs, c0, dhs, dcs, sl, dc0, T - 1, T, rev,
                 first_row + er, N, H, j0, tq);
  for (int t = T - 1; t >= 0; --t) {
    const float* hprev = t ? hs + (t - 1) * nh : h0;
    float* dxt = dxs + t * nh * 4;
    float* part_t = partial + static_cast<size_t>(t & 1) * U * U * N * kBUnits;
    const bool last = t == T - 1;     // the carries start at zero
    for (int row0 = first_row; row0 < N; row0 += stride) {
      const int n = row0 + er;
      // the dh carry, from this block's phase 2 of the previous step
#pragma unroll
      for (int v = 0; v < 2; ++v)
        if (in.in[v] && !last)
          in.dh[v] += __ldcg(dh0 + static_cast<size_t>(n) * H + j0 + 4 * v +
                             tq);
      flash::cp_wait_all();
      __syncthreads();      // the tile is in; the last tile's reads are done
      float acc[4][4];      // gates: rows mt*16 + gq (+8) x 4 n-tiles
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
      gate_slices(acc, tile, wsl, hp32, mt, gq, tq, ks_lo, ks_hi);
      // the rows the other half keeps go to it through shared memory
      gates_out(acc, xg, mt, kh, lane);
      __syncthreads();
      // dg for the lane's row and two units: dxs[t], the dc carry, the
      // split dg tile
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        float dg[4] = {0.f, 0.f, 0.f, 0.f};
        const int j = j0 + 4 * v + tq;
        if (in.in[v]) {
          float pre[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int nt = 2 * v + (q >> 1), e = q & 1;
            pre[q] = in.x[v][q] + gate_sum(acc, xg, mt, kh, nt, e, lane);
          }
          const float ca = tanhf(pre[0]);
          const float ig = sigmoid_f(pre[1]);
          const float fg = sigmoid_f(pre[2]);
          const float og = sigmoid_f(pre[3]);
          const float cp = in.cp[v], dh_tot = in.dh[v], dc_pass = in.dc[v];
          const float tc = tanhf(fg * cp + ig * ca);
          const float dc_tot = dc_pass + dh_tot * og * (1.f - tc * tc);
          float dc_carry = dc_pass;
          if (in.ok) {
            dg[0] = (dc_tot * ig) * (1.f - ca * ca);
            dg[1] = (dc_tot * ca) * ig * (1.f - ig);
            dg[2] = (dc_tot * cp) * fg * (1.f - fg);
            dg[3] = (dh_tot * tc) * og * (1.f - og);
            dc_carry = dc_tot * fg;
          }
          __stcg(dc0 + static_cast<size_t>(n) * H + j, dc_carry);
          float* xo = dxt + static_cast<size_t>(n) * G + j;
#pragma unroll
          for (int q = 0; q < 4; ++q) __stcg(xo + q * H, dg[q]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t big, small;
          flash::split(dg[q], big, small);
          const int at = ath(er, gate_col(q, 4 * v + tq), kBCols);
          dgb[at] = big;
          dgs[at] = small;
        }
      }
      __syncthreads();
      // dW (H x 32) += h^T dg over the tile's 64 rows, two row tiles of H
      // at a time; each tile's sum is added to dwacc in float32
#pragma unroll
      for (int ip = 0; ip < 4; ip += 2) {
        if ((warp + 8 * ip) * 16 >= H) break;
        float part[2][4][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) part[i][nt][r] = 0.f;
#pragma unroll 2
        for (int ks = 0; ks < kBRows / 8; ++ks) {
          const int kr = ks * 8;
          uint32_t bb[4][2], bs[4][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int a0 = ath(kr + tq, nt * 8 + gq, kBCols);
            const int a1 = ath(kr + tq + 4, nt * 8 + gq, kBCols);
            bb[nt][0] = dgb[a0];
            bb[nt][1] = dgb[a1];
            bs[nt][0] = dgs[a0];
            bs[nt][1] = dgs[a1];
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int m0 = (warp + 8 * (ip + i)) * 16;
            if (m0 >= H) break;
            float a[4];
            a[0] = tile[ath(kr + tq, m0 + gq, hp32)];
            a[1] = tile[ath(kr + tq, m0 + gq + 8, hp32)];
            a[2] = tile[ath(kr + tq + 4, m0 + gq, hp32)];
            a[3] = tile[ath(kr + tq + 4, m0 + gq + 8, hp32)];
            uint32_t ab[4], as[4];
            split4(a, ab, as);
            mma3<4>(part[i], ab, as, bb, bs);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              dwacc[ip + i][nt][r] += part[i][nt][r];
      }
      __syncthreads();      // the tile is free: copy the next one
      if (row0 + stride < N)
        issue_h_tile(tile, hprev, row0 + stride, N, H, hp32);
      else if (t > 0)
        issue_h_tile(tile, t > 1 ? hs + (t - 2) * nh : h0, first_row, N, H,
                     hp32);
      // the block's partial dh, transposed: (H x 64) = W_slice dg^T, K = 32;
      // warp w owns hidden row tiles w + 8i and all 8 row tiles of the tile
      for (int i = 0; i < 4; ++i) {
        const int m0 = (warp + 8 * i) * 16;
        if (m0 >= H) break;
        uint32_t ab[4][4], as[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          float a[4];
          a[0] = wsl[ath(m0 + gq, ks * 8 + tq, kBCols)];
          a[1] = wsl[ath(m0 + gq + 8, ks * 8 + tq, kBCols)];
          a[2] = wsl[ath(m0 + gq, ks * 8 + tq + 4, kBCols)];
          a[3] = wsl[ath(m0 + gq + 8, ks * 8 + tq + 4, kBCols)];
          split4(a, ab[ks], as[ks]);
        }
        // lane (gq, tq) holds hidden units m0 + gq (+8): destination
        // blocks m0 / 8 (+1), unit gq
        const int d_lo = m0 >> 3;
#pragma unroll
        for (int ng = 0; ng < 8; ng += 4) {
          float p[4][4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) p[nt][r] = 0.f;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            uint32_t bb[4][2], bs[4][2];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int r = (ng + nt) * 8 + gq;
              const int a0 = ath(r, ks * 8 + tq, kBCols);
              const int a1 = ath(r, ks * 8 + tq + 4, kBCols);
              bb[nt][0] = dgb[a0];
              bb[nt][1] = dgb[a1];
              bs[nt][0] = dgs[a0];
              bs[nt][1] = dgs[a1];
            }
            mma3<4>(p, ab[ks], as[ks], bb, bs);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int dest = d_lo + (r >> 1);
              const int row = row0 + (ng + nt) * 8 + 2 * tq + (r & 1);
              if (dest < U && row < N)
                __stcg(part_t + ((static_cast<size_t>(dest) * U + ub) * N +
                                 row) * kBUnits + gq,
                       p[nt][r]);
            }
        }
      }
      if (row0 + stride < N)       // the next tile of this step
        load_step_in(in, xs, hs, cs, c0, dhs, dcs, sl, dc0, t, T, rev,
                     row0 + stride + er, N, H, j0, tq);
    }
    grid.sync();
    if (t > 0 && has_rows)         // the next step's first tile
      load_step_in(in, xs, hs, cs, c0, dhs, dcs, sl, dc0, t - 1, T, rev,
                   first_row + er, N, H, j0, tq);
    // phase 2: dh_{t-1} of the block's units for its rows, the sum of the
    // U partials; lane q takes sources q, q + 4, .. then xor-shuffles
    const float* mine = part_t + static_cast<size_t>(ub) * U * N * kBUnits;
    const int pr = tid >> 2, pq = tid & 3;
    for (int nb = first_row; nb < N; nb += stride) {
      const int n = nb + pr;
      float sum[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) sum[u] = 0.f;
      if (n < N) {
#pragma unroll 8
        for (int src = pq; src < U; src += 4) {
          const float4* p = reinterpret_cast<const float4*>(
              mine + (static_cast<size_t>(src) * N + n) * kBUnits);
          const float4 lo = __ldcg(p), hi = __ldcg(p + 1);
          sum[0] += lo.x;
          sum[1] += lo.y;
          sum[2] += lo.z;
          sum[3] += lo.w;
          sum[4] += hi.x;
          sum[5] += hi.y;
          sum[6] += hi.z;
          sum[7] += hi.w;
        }
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1)
#pragma unroll
        for (int u = 0; u < 8; ++u)
          sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], x);
      float mine2[2] = {sum[0], sum[1]};     // units 2 pq, 2 pq + 1
#pragma unroll
      for (int k = 1; k < 4; ++k)
        if (pq == k) {
          mine2[0] = sum[2 * k];
          mine2[1] = sum[2 * k + 1];
        }
      if (n < N) {
        const bool valid = step_valid(t, T, rev, sl[n]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 2 * pq + e;
          if (j >= H) continue;
          const size_t at = static_cast<size_t>(n) * H + j;
          float v = mine2[e];
          if (!valid)
            v = __ldg(dhs + t * nh + at) + (last ? 0.f : __ldcg(dh0 + at));
          __stcg(dh0 + at, v);
        }
      }
    }
    __syncthreads();
  }
  // dW: each row group's partial, then their sum in group order
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m0 = (warp + 8 * i) * 16;
    if (m0 >= H) break;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = m0 + gq + 8 * (r >> 1), c = nt * 8 + 2 * tq + (r & 1);
        if (k < H)
          __stcg(dw_part + ((static_cast<size_t>(grp) * U + ub) * H + k) *
                               kBCols + c,
                 dwacc[i][nt][r]);
      }
  }
  grid.sync();
  // block (g, u) sums the groups' partials for rows g, g + 2, .. of H
  for (int idx = tid; idx < H * kBCols; idx += kThreads) {
    const int k = idx >> 5, c = idx & 31;
    if (k % kGroups != grp) continue;
    const int uu = 4 * (c >> 4) + ((c & 7) >> 1);
    const int q = 2 * ((c >> 3) & 1) + (c & 1);
    if (j0 + uu >= H) continue;
    float v = 0.f;
    for (int g = 0; g < kGroups; ++g)
      v += __ldcg(dw_part + ((static_cast<size_t>(g) * U + ub) * H + k) *
                                kBCols + c);
    dw[static_cast<size_t>(k) * G + q * H + j0 + uu] = v;
  }
}

// ---- a probe of the L2 read rate (chip_smoke.py, phase 3d) -----------------

// Every block reads all n4 float4 of buf through L2 (ld.global.cg) and
// writes one sum per warp to out[block][warp], so `blocks` blocks read
// blocks x n4 x 16 bytes: the pattern of the backward's per-step reads,
// where every block reads data that all blocks read.
__global__ void __launch_bounds__(512)
    cache_read_probe_kernel(const float4* __restrict__ buf, int n4,
                            float* out) {
  const int nt = blockDim.x;
  float s = 0.f;
  int i = threadIdx.x;
  for (; i + 7 * nt < n4; i += 8 * nt) {
    float4 v[8];      // eight loads in flight a thread
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __ldcg(buf + i + k * nt);
#pragma unroll
    for (int k = 0; k < 8; ++k) s += (v[k].x + v[k].y) + (v[k].z + v[k].w);
  }
  for (; i < n4; i += nt) {
    const float4 v = __ldcg(buf + i);
    s += (v.x + v.y) + (v.z + v.w);
  }
#pragma unroll
  for (int x = 16; x; x >>= 1) s += __shfl_xor_sync(0xffffffffu, s, x);
  if ((threadIdx.x & 31) == 0)
    out[blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5)] = s;
}

// The W slice, the h tile and the gate halves.
size_t fwd_smem(int H) {
  return (static_cast<size_t>(round_up(H, 32)) * kBCols +
          static_cast<size_t>(kBRows) * round_up(H, 32) + 2048) *
         sizeof(float);
}

// The W slice, the h tile, the split dg tile and the gate halves.
size_t bwd_smem(int H) {
  return (static_cast<size_t>(round_up(H, 32)) * kBCols +
          static_cast<size_t>(kBRows) * round_up(H, 32) +
          2 * kBRows * kBCols + 2048) * sizeof(float);
}

// Both kernels' grid: 2 row groups x ceil(H / 8) unit groups.
int grid_blocks(int H) { return kGroups * ((H + kBUnits - 1) / kBUnits); }

int check_dims(int t, int n, int h) {
  if (t < 1 || n < 1 || h < kHStep || h % kHStep || h > kMaxH) return -1;
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
  const int blocks = grid_blocks(h);
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
// dhs, dcs (t, n, h); outputs dxs (t, n, 4h), dw (h, 4h), dh0, dc0 (n, h);
// scratch, float32 and 16-byte aligned, for the blocks' partial dh (two
// buffers, by the parity of the step, of U x U x n x 8, U = ceil(h / 8))
// and the two row groups' partial dW (2 x U x h x 32).
extern "C" int lstm_bwd_launch(const void* xs, const void* w, const void* h0,
                               const void* c0, const void* sl, const void* hs,
                               const void* cs, const void* dhs,
                               const void* dcs, void* dxs, void* dw, void* dh0,
                               void* dc0, void* scratch, int t, int n, int h,
                               int rev, int device, void* stream) {
  int rc = check_dims(t, n, h);
  if (rc) return rc;
  const int blocks = grid_blocks(h);
  const size_t smem = bwd_smem(h);
  rc = prepare(reinterpret_cast<const void*>(lstm_bwd_kernel), blocks, smem,
               device);
  if (rc) return rc;
  void* args[] = {&xs,  &w,  &h0,  &c0,  &sl,      &hs, &cs,
                  &dhs, &dcs, &dxs, &dw, &dh0, &dc0, &scratch,
                  &t,   &n,  &h,   &rev};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm_bwd_kernel), dim3(blocks),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The L2 probe: `blocks` blocks of 512 threads each read buf (n4 float4,
// 16-byte aligned); out holds blocks x 16 floats.  Each block asks for
// 120 KB of shared memory it does not use, so that no two share an SM,
// as the backward's blocks do not.
extern "C" int l2_read_probe_launch(const void* buf, int n4, int blocks,
                                    void* out, int device, void* stream) {
  if (n4 < 1 || blocks < 1) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kOneASm = 120 * 1024;
  err = cudaFuncSetAttribute(cache_read_probe_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kOneASm);
  if (err != cudaSuccess) return static_cast<int>(err);
  cache_read_probe_kernel<<<blocks, 512, kOneASm,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(buf), n4, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
