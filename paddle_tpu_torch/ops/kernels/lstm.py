"""Fused LSTM recurrence: CUDA kernels + plain PyTorch versions, forward
and backward.

Replaces the TPU kernels of paddle_tpu/ops/pallas/recurrence.py: the
forward `_fwd_call` (kernel body `_fwd_kernel`) and the custom-VJP
backward `_bwd_call` (kernel body `_bwd_kernel`).  Over time-major xs
(T, N, 4H) — the projected, bias-added input — recurrent weights W
(H, 4H), initial states h0/c0 (N, H) and int32 lengths sl (N,), with the
gate columns [candidate, input, forget, output]:

    gates = xs[t] + h W
    c' = sigmoid(f) c + sigmoid(i) tanh(cand);  h' = sigmoid(o) tanh(c')
    rows whose step is not valid keep (h, c);  hs[t], cs[t] = h, c

A step is valid for row n when t < sl[n]; with `rev` (the caller flipped
the time axis) when T-1-t < sl[n].  The backward recomputes the gates
from the saved hs, cs, so the (T, N, 4H) gates never reach device memory.

The kernels (csrc/lstm.cu) are one persistent cooperative launch each,
split over the SMs by hidden unit and row group with a grid barrier per
step; they take float32, any N >= 1 and T >= 1, and H a multiple of 4 up
to 512.  Every product of both (the forward's gates, the backward's
recompute, dW and dh) runs on the tensor cores (mma.sync TF32, split
3xTF32 so they stay float32-accurate); the backward has a scratch for
the blocks' partial dh that the wrapper allocates.
The TPU kernel's time blocking (block_t, the padded tail) is a TPU device
and is not carried over.

Plain versions: `lstm_fwd_plain` (a loop over T of torch.matmul and the
gate arithmetic) and `lstm_bwd_plain` (the backward written out step by
step without autograd).  They are the CPU path and the card's reference
for the kernels.

`LSTMFn` is the autograd Function (the port of `_lstm` / `_lstm_vjp_fwd`
/ `_lstm_vjp_bwd`); `fused_lstm` is the reference's public entry with its
signature, rejections and return values.
"""

from __future__ import annotations

import ctypes

import torch

from . import (TF32_FLOP_PER_S, _build, bump, charge, launch_counts,
               plain_calls, register_kernel_cost, routed)

UNITS_PER_BLOCK = 4     # csrc/lstm.cu kHStep: H must be a multiple
MAX_H = 512             # csrc/lstm.cu kMaxH
_SOURCE = "lstm"
_FWD, _BWD = "lstm_fwd", "lstm_bwd"
# The kernels' flops in the reference's dense-equivalent convention
# (paddle_tpu/ops/pallas/recurrence.py:55-83), T steps of N rows, H
# units: h W once a step forward, dg W^T and h^T dg once backward (the
# gates' recompute not counted); the gates' elementwise work at 10 a
# cell forward, 22 backward.
_LSTM_FWD_PER_CELL = 10.0
_LSTM_BWD_PER_CELL = 22.0


def lstm_fwd_cost(t, n, h):
    return t * n * (2.0 * h * 4 * h + _LSTM_FWD_PER_CELL * h)


def lstm_bwd_cost(t, n, h):
    return t * n * (4.0 * h * 4 * h + _LSTM_BWD_PER_CELL * h)


register_kernel_cost(_FWD, lstm_fwd_cost)
register_kernel_cost(_BWD, lstm_bwd_cost)
_LAUNCH_ERRORS = {
    -1: "sizes outside what the kernel takes",
    -2: "the device does not support cooperative launches",
    -3: "the grid of 2 x ceil(H / 8) blocks cannot be resident at once "
        "on this device (the kernel's grid barrier needs that)"}


def _valid(t, t_len, sl, rev):
    """(N, 1) bool: does work-domain step t advance each row's state?"""
    step = t_len - 1 - t if rev else t
    return (step < sl).reshape(-1, 1)


def _gates(x_t, h, w):
    g = x_t + torch.matmul(h, w)
    cand, ig, fg, og = g.chunk(4, dim=-1)
    return torch.tanh(cand), torch.sigmoid(ig), torch.sigmoid(fg), \
        torch.sigmoid(og)


def lstm_fwd_plain(xs, w, h0, c0, sl, rev=False):
    """Plain version of the forward kernel: (hs, cs), each (T, N, H)."""
    t_len = xs.shape[0]
    h, c = h0, c0
    hs, cs = [], []
    for t in range(t_len):
        ca, i, f, o = _gates(xs[t], h, w)
        c_new = f * c + i * ca
        h_new = o * torch.tanh(c_new)
        ok = _valid(t, t_len, sl, rev)
        h = torch.where(ok, h_new, h)
        c = torch.where(ok, c_new, c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_bwd_plain(xs, w, h0, c0, sl, hs, cs, dhs, dcs, rev=False):
    """Plain version of the backward kernel: (dxs, dw, dh0, dc0) from the
    forward's operands, its saved outputs hs, cs and their cotangents —
    the kernel's arithmetic step by step, without autograd."""
    t_len = xs.shape[0]
    dh = torch.zeros_like(h0)
    dc = torch.zeros_like(c0)
    dw = torch.zeros_like(w)
    dxs = [None] * t_len
    zero = torch.zeros((), dtype=xs.dtype, device=xs.device)
    for t in range(t_len - 1, -1, -1):
        h_prev = hs[t - 1] if t else h0
        c_prev = cs[t - 1] if t else c0
        ca, i, f, o = _gates(xs[t], h_prev, w)
        tc = torch.tanh(f * c_prev + i * ca)
        dh_tot = dhs[t] + dh
        # a frozen row's h_out is h_prev itself: its dh does not fold
        # into the cell cotangent
        dc_pass = dcs[t] + dc
        dc_tot = dc_pass + dh_tot * o * (1.0 - tc * tc)
        dg = torch.cat([(dc_tot * i) * (1.0 - ca * ca),
                        (dc_tot * ca) * i * (1.0 - i),
                        (dc_tot * c_prev) * f * (1.0 - f),
                        (dh_tot * tc) * o * (1.0 - o)], dim=1)
        ok = _valid(t, t_len, sl, rev)
        dg = torch.where(ok, dg, zero)
        dxs[t] = dg
        dh = torch.where(ok, torch.matmul(dg, w.t()), dh_tot)
        dc = torch.where(ok, dc_tot * f, dc_pass)
        dw = dw + torch.matmul(h_prev.t(), dg)
    return torch.stack(dxs), dw, dh, dc


def _check(xs, w, h0, c0, sl, *seqs):
    if xs.dim() != 3 or xs.shape[2] % 4:
        raise ValueError(f"lstm: xs {tuple(xs.shape)} is not (T, N, 4*H)")
    t_len, n, g4 = xs.shape
    h = g4 // 4
    for name, t, want in (("w", w, (h, g4)), ("h0", h0, (n, h)),
                          ("c0", c0, (n, h)), ("sl", sl, (n,)),
                          *((f"sequence operand {i}", s, (t_len, n, h))
                            for i, s in enumerate(seqs))):
        if tuple(t.shape) != want:
            raise ValueError(f"lstm: {name} of shape {tuple(t.shape)}, "
                             f"want {want}")
    devices = {t.device for t in (xs, w, h0, c0, sl, *seqs)}
    if len(devices) != 1:
        raise ValueError(f"lstm: operands on different devices: "
                         f"{sorted(str(d) for d in devices)}")
    return xs.device.type


def kernel_takes(x, w, h0, c0) -> bool:
    """Do the kernels take these operands: float32, H = x.shape[-1] / 4 a
    multiple of 4 and at most 512?  dynamic_lstm's route on the card
    (ops/rnn.py); `_check_kernel` raises on the same limits."""
    h = x.shape[-1] // 4
    return all(t.dtype == torch.float32 for t in (x, w, h0, c0)) \
        and h % UNITS_PER_BLOCK == 0 and h <= MAX_H


def _check_kernel(xs, w, h0, c0, sl, *seqs):
    """Raise for what the kernels do not take (no quiet fallback)."""
    floats = (xs, w, h0, c0, *seqs)
    if any(t.dtype == torch.bfloat16 for t in floats):
        raise NotImplementedError(
            "the LSTM kernels take float32 only; bf16 operands wait on "
            "the kernels' bf16 paths: ROADMAP queue B, B.3 (bf16 operand "
            "paths); use_pallas=False takes the composed route")
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"lstm kernels: float32 operands (ROADMAP B.3), "
                        f"got {[str(t.dtype) for t in floats]}")
    if sl.dtype != torch.int32:
        raise TypeError(f"lstm kernels: int32 lengths, got {sl.dtype}")
    t_len, n, g4 = xs.shape
    h = g4 // 4
    if t_len < 1 or n < 1:
        raise ValueError(f"lstm kernels: T = {t_len}, N = {n}; both must "
                         f"be at least 1")
    if h % UNITS_PER_BLOCK or h > MAX_H:
        raise ValueError(f"lstm kernels: H = {h} must be a multiple of "
                         f"{UNITS_PER_BLOCK} and at most {MAX_H} (ROADMAP "
                         f"B.2); use_pallas=False takes the composed route")


def _aligned(t):
    """Contiguous and 16-byte aligned (the kernels read float4)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _raise_launch(which, rc):
    what = _LAUNCH_ERRORS.get(rc, f"CUDA error {rc}")
    raise RuntimeError(f"lstm {which} kernel launch failed: {what}")


def _charge(name, xs):
    t, n, g4 = xs.shape
    charge(name, (t, n, g4 // 4),
           lambda: bound_bytes_and_flops(t, n, g4 // 4, xs.element_size())[
               name[len("lstm_"):]][0])


@routed
def lstm_fwd(xs, w, h0, c0, sl, rev=False):
    """Forward: (hs, cs).  Routes by device: CUDA launches the kernel, CPU
    runs the plain version, meta allocates the outputs."""
    kind = _check(xs, w, h0, c0, sl)
    t_len, n, g4 = xs.shape
    if kind == "meta":
        return tuple(torch.empty((t_len, n, g4 // 4), dtype=xs.dtype,
                                 device=xs.device) for _ in range(2))
    if kind == "cpu":
        bump(plain_calls, _FWD)
        _charge(_FWD, xs)
        return lstm_fwd_plain(xs, w, h0, c0, sl, rev)
    if kind != "cuda":
        raise ValueError(f"lstm: unsupported device {xs.device}")
    _check_kernel(xs, w, h0, c0, sl)
    xs, w, h0, c0, sl = (_aligned(t) for t in (xs, w, h0, c0, sl))
    hs, cs = (torch.empty((t_len, n, g4 // 4), dtype=torch.float32,
                          device=xs.device) for _ in range(2))
    rc = _bind().lstm_fwd_launch(
        xs.data_ptr(), w.data_ptr(), h0.data_ptr(), c0.data_ptr(),
        sl.data_ptr(), hs.data_ptr(), cs.data_ptr(), t_len, n, g4 // 4,
        int(bool(rev)), xs.device.index or 0, _stream(xs))
    if rc != 0:
        _raise_launch("forward", rc)
    bump(launch_counts, _FWD)
    _charge(_FWD, xs)
    return hs, cs


@routed
def lstm_bwd(xs, w, h0, c0, sl, hs, cs, dhs, dcs, rev=False):
    """Backward: (dxs, dw, dh0, dc0).  Routes by device as `lstm_fwd`."""
    kind = _check(xs, w, h0, c0, sl, hs, cs, dhs, dcs)
    if kind == "meta":
        return (torch.empty_like(xs), torch.empty_like(w),
                torch.empty_like(h0), torch.empty_like(c0))
    if kind == "cpu":
        bump(plain_calls, _BWD)
        _charge(_BWD, xs)
        return lstm_bwd_plain(xs, w, h0, c0, sl, hs, cs, dhs, dcs, rev)
    if kind != "cuda":
        raise ValueError(f"lstm: unsupported device {xs.device}")
    _check_kernel(xs, w, h0, c0, sl, hs, cs, dhs, dcs)
    ops = [_aligned(t) for t in (xs, w, h0, c0, sl, hs, cs, dhs, dcs)]
    outs = [torch.empty_like(t) for t in ops[:4]]
    t_len, n, g4 = xs.shape
    scratch = torch.empty(scratch_floats(n, g4 // 4), dtype=torch.float32,
                          device=xs.device)
    rc = _bind().lstm_bwd_launch(
        *(t.data_ptr() for t in ops), *(t.data_ptr() for t in outs),
        scratch.data_ptr(), t_len, n, g4 // 4, int(bool(rev)),
        xs.device.index or 0, _stream(xs))
    if rc != 0:
        _raise_launch("backward", rc)
    bump(launch_counts, _BWD)
    _charge(_BWD, xs)
    return tuple(outs)


class LSTMFn(torch.autograd.Function):
    """Differentiable recurrence: (xs, w, h0, c0, sl, rev) -> (hs, cs).
    Forward: `lstm_fwd`, saving the operands and hs, cs.  Backward:
    `lstm_bwd` (the backward kernel on CUDA); sl gets no gradient."""

    @staticmethod
    def forward(ctx, xs, w, h0, c0, sl, rev):
        hs, cs = lstm_fwd(xs, w, h0, c0, sl, rev)
        ctx.save_for_backward(xs, w, h0, c0, sl, hs, cs)
        ctx.rev = rev
        return hs, cs

    @staticmethod
    def backward(ctx, dhs, dcs):
        xs, w, h0, c0, sl, hs, cs = ctx.saved_tensors
        dxs, dw, dh0, dc0 = lstm_bwd(xs, w, h0, c0, sl, hs, cs,
                                     dhs.to(hs.dtype), dcs.to(cs.dtype),
                                     ctx.rev)
        return dxs, dw, dh0, dc0, None, None


def fused_lstm(x, w, h0=None, c0=None, seq_len=None, *,
               is_reverse=False, use_peepholes=False,
               gate_activation="sigmoid", cell_activation="tanh",
               candidate_activation="tanh"):
    """Fused multi-timestep LSTM over a pre-projected, bias-added input.

    x: (N, T, 4H), `x @ W_x + b` done by the caller (the dynamic_lstm
    contract); w: (H, 4H) recurrent weights; h0/c0: optional (N, H)
    initial states; seq_len: optional (N,) int lengths (state freezes
    past each row's end).

    Returns (hidden (N, T, H), cell (N, T, H), last_h (N, H),
    last_c (N, H)).  Differentiable w.r.t. x, w, h0, c0 through `LSTMFn`.
    """
    if use_peepholes:
        raise ValueError(
            "fused_lstm (the recurrence kernel) does not support "
            "peepholes — use the composed path (use_pallas=False)")
    acts = (gate_activation, cell_activation, candidate_activation)
    if acts != ("sigmoid", "tanh", "tanh"):
        raise ValueError(
            f"fused_lstm supports only (sigmoid, tanh, tanh) "
            f"activations, got {acts} — the fused backward derivatives "
            f"are hand-derived; use the composed path (use_pallas=False)")
    n, t, g4 = x.shape
    if g4 % 4:
        raise ValueError(f"fused_lstm: input width {g4} is not 4*H")
    h_dim = g4 // 4
    if h0 is None:
        h0 = torch.zeros((n, h_dim), dtype=x.dtype, device=x.device)
    if c0 is None:
        c0 = torch.zeros((n, h_dim), dtype=x.dtype, device=x.device)
    if seq_len is None:
        sl = torch.full((n,), t, dtype=torch.int32, device=x.device)
    else:
        sl = seq_len.to(torch.int32).reshape(n)
    xs = x.transpose(0, 1)                  # (T, N, 4H) time-major
    if is_reverse:
        xs = xs.flip(0)
    xs = xs.contiguous()    # one copy here, none in forward or backward
    hs, cs = LSTMFn.apply(xs, w, h0, c0, sl, bool(is_reverse))
    # the carry freezes past each row's end, so the last work-domain step
    # is the final state
    h_last, c_last = hs[-1], cs[-1]
    if is_reverse:
        hs, cs = hs.flip(0), cs.flip(0)
    return hs.transpose(0, 1), cs.transpose(0, 1), h_last, c_last


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def scratch_floats(n, h):
    """Floats of the backward kernel's scratch (the layout of csrc/lstm.cu
    lstm_bwd_launch): two buffers, by the parity of the step, of the
    blocks' partial dh, [U destination][U source unit groups][N rows]
    [8 units] with U = ceil(H / 8), and the two row groups' partial dW,
    [2][U][H][32]; 40 MB at N = 128, H = 512."""
    u = -(-h // 8)
    return 2 * u * u * n * 8 + 2 * u * h * 32


def _bind() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, n_ptr in ((lib.lstm_fwd_launch, 7), (lib.lstm_bwd_launch, 14)):
        if fn.argtypes is None:
            fn.argtypes = [p] * n_ptr + [i] * 5 + [p]
            fn.restype = i
    if lib.l2_read_probe_launch.argtypes is None:
        lib.l2_read_probe_launch.argtypes = [p, i, i, p, i, p]
        lib.l2_read_probe_launch.restype = i
    return lib


def l2_read_probe(buf, blocks):
    """Launch csrc/lstm.cu's L2 probe: `blocks` blocks each read all of
    `buf` (a 16-byte aligned CUDA float32 tensor, a multiple of 4 long)
    through L2.  Returns the (blocks, 16) per-warp sums.  A measurement
    aid (chip_smoke.py, phase 3d), not a kernel of the port's path."""
    out = torch.empty((blocks, 16), dtype=torch.float32, device=buf.device)
    rc = _bind().l2_read_probe_launch(buf.data_ptr(), buf.numel() // 4,
                                      blocks, out.data_ptr(),
                                      buf.device.index or 0, _stream(buf))
    if rc != 0:
        raise RuntimeError(f"L2 probe launch failed: CUDA error {rc}")
    return out


def bound_bytes_and_flops(t, n, h, el=4):
    """{"fwd" | "bwd": (bytes, flops)} that each kernel's function needs:
    each input read once, each output written once; 2*T*N*H*4H flops for
    the forward's h W, 6*T*N*H*4H for the backward (its recompute of the
    gates, dg W^T and h^T dg)."""
    xs, seq, w, st = t * n * 4 * h * el, t * n * h * el, h * 4 * h * el, \
        n * h * el
    common = xs + w + 2 * st + n * 4
    mac = t * n * h * 4 * h
    return {"fwd": (common + 2 * seq, 2 * mac),
            "bwd": (common + 4 * seq + xs + w + 2 * st, 6 * mac)}


def tensor_core_bound_ms(t, n, h):
    """{"fwd" | "bwd": ms}: the least time of each kernel's 3xTF32
    products on the tensor cores, 3 TF32 operations for each flop of
    `bound_bytes_and_flops` (2*T*N*H*4H forward, 6*T*N*H*4H backward) at
    the H100's 495 TFLOP/s."""
    return {k: 3 * flops / TF32_FLOP_PER_S * 1e3 for k, (_, flops)
            in bound_bytes_and_flops(t, n, h).items()}
