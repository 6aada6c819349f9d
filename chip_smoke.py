"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives paddle_tpu_torch only (it imports neither jax nor paddle_tpu):

1. prints the card (nvidia-smi name and power limit), turns TF32 off
   and bf16 GEMMs' reduced-precision reductions off (the reference's
   bf16 products accumulate in float32 and round once);
2. builds the port's CUDA kernels from paddle_tpu_torch/csrc with nvcc
   (sm_90a), one nvcc per source, all started together, and prints each
   kernel's registers and spills;
3. holds each kernel against its plain PyTorch version on the card at
   the main paths' shapes — paged attention over float32, bfloat16 and
   int8 pools with ragged lengths and NaN past each length, at the
   serving shape and at a long-length shape (max_len 4096, lengths
   2048-4096, pools larger than the L2), twice with the same bits, timed
   by the profiler's device time; paged attention at the speculative
   verify run's shape (80 rows: 16 slots x 5 rows on one page table each
   at staggered lengths, dead rows, two inactive slots; float32 and bf16
   pools, with its own split plan and with the step's, plan_rows 16),
   the bf16 case timed beside its bound; causal flash
   attention with a key-padding bias at T = 32, 64, 128 — and times the
   kernel, the plain version and, for flash, one library call
   (scaled_dot_product_attention, never used by the port) beside the
   3xTF32 and float32 bounds (flash by the profiler's device time as
   well: back to back, a call this small reads the host); holds the flash forward kernel (O and
   lse; 3xTF32 on the tensor cores) against the plain forward at D = 32,
   64 and 128, in both layouts, causal and not, with a key bias and
   without, at T = 100, with causal offsets 37/5 at T = 130, and with
   operands one float into their storage (the wrapper copies them), and
   checks that two forward runs at the training shape give the same
   bits;
   3b. does the same for the flash-attention backward kernels (dK/dV and
   dQ, 3xTF32 on the tensor cores) against the plain backward: the
   training shape N=64, H=8, T=256, D=64 (nhtd transposed views,
   key-padding bias, causal and not), T=100 causal, an nthd case, a case
   with the bias gradient and an lse cotangent, two causal cases with
   nonzero q/k offsets at T=130 (one where no query sees any key), a
   case whose operands start one float into their storage (rows not
   16-byte aligned: the wrapper copies them), and D = 128 and D = 32
   cases (causal, offsets, nthd with the bias gradient); checks that
   two backward runs at the training shape give the same bits; prints
   both kernels' ptxas registers and spills; and times them beside
   their 3xTF32 and float32 bounds; the library call is autograd
   through scaled_dot_product_attention; at phase 6d's shape (N=2,
   T=8192, causal and not) it holds the backward pair against the plain
   backward and times it beside the library's backward; it times the
   flash forward alone at the training shapes of phases 6 and 6d beside
   its bounds and scaled_dot_product_attention; and at head dim 128
   (N=16, H=8, T=512: d_model 1024, 8 heads), causal and not, it holds
   the forward and the backward pair against the plain versions and
   times both beside their bounds and the library's forward and
   backward;
   3c. holds the vocab-CE forward, dh and dW kernels against their
   plain versions at the training shape (N = 16384 tokens, D = 512,
   V = 32000, eps 0.1, some labels out of range and clamped, a quarter
   of the cotangent zero), at a ragged shape (N = 1000, V = 1003), with
   eps = 0, and at two ragged depths (D = 100 and D = 61, N = 999,
   V = 1001: 16-byte and 4-byte copies), checks that two backward runs
   at the training shape give the same bits and that the library's
   label-smoothed `F.cross_entropy` is the same loss, and times kernel,
   plain version and library (matmul + cross_entropy, forward, then its
   autograd backward) beside the float32 and the 3xTF32 tensor-core
   bounds;
   3d. holds the LSTM recurrence kernels (forward and backward) against
   their plain versions at the stacked-LSTM training shape (T = N = 128,
   H = 512, the bench's ragged lengths, non-zero h0/c0, forward and
   reversed) and at a small ragged shape (N = 5, T = 7, H = 24, lengths
   0 and 1), checks that two forward and two backward runs give the
   same bits, and times kernel (back to back and by device time) beside
   its 3xTF32 and float32 bounds, plain version and, as the library
   yardstick, `torch.nn.LSTM`
   (cuDNN; it also contains the x-projection, so it is set against fc +
   kernel);
   3f. holds the flash forward (O and lse) and the backward pair against
   their plain versions at BERT-base's shape (N = 32, H = 12, T = 128,
   D = 64, not causal, the key-padding bias of ragged lengths in 1..128
   with a row of length 1, built as bert.py builds it), in both layouts
   (nhtd transposed views and nthd), checks that two runs give the same
   bits, and times the forward and the pair by device time beside their
   3xTF32 and float32 bounds and scaled_dot_product_attention with the
   same additive mask (forward, and its autograd backward);
   3g. holds the flash kernels' bf16 paths (the forward with bf16
   mma.sync, P rounded to bf16 before P V; the bf16 dK/dV and dQ
   kernels, flash_bwd_dkv_bf16_kernel and flash_bwd_dq_bf16_kernel:
   bf16 tiles by cp.async, s and dp one bf16 mma.sync pass, p and ds
   split hi + lo for two passes of dV, dK and dQ; their ptxas registers
   and spills are logged in 3b beside the float32 kernels') against the
   bf16 plain versions at phase 6i's shape (N = 64, H = 8, T = 256, D = 64,
   nhtd transposed views, causal and not), BERT-base's (N = 32, H = 12,
   T = 128, not causal), D = 128 (N = 16, H = 8, T = 512) and T = 8192
   (N = 2, H = 8, causal), with a bf16 key bias as the AMP policy casts
   it: O within TOL_BF16_O of max |O|, lse within TOL_KERNEL, each
   gradient within TOL_BF16_GRAD relative; and times each kernel by
   device time beside its bound at the bf16 peak, the plain versions
   and scaled_dot_product_attention on the same bf16 operands, forward
   and backward;
   3e. runs, for each kernel, its op on a shape the kernel refuses (flash
   head dim 96, vocab-CE D = 768, LSTM H = 514, paged head dim 96) with
   use_pallas=False: one composed call counted, no kernel launch, and the
   result within tolerance of the same op on the CPU from the same
   inputs; with use_pallas=True the op must raise;
4. serves a stream of 64 ragged requests through DecodeEngine at the
   repository's decode-serving configuration (DecoderLM vocab 8192,
   4 layers, 8 heads, d_model 512; 16 slots, 384 pages of 16 tokens,
   bfloat16 KV, prefill buckets 32/64/128, decode chunk 16), with the
   kernel launch counts set to 0 just before and read just after;
   then times one decode step's host and device time alone (4b);
   4c. the reference bench's serving_decode_spec_k4 at full width: the
   same ARCH/SERVE with bf16 KV, 64 repeat-heavy prompts of 8-128 tokens,
   budgets in 48..96, a ReqTracer(sample_rate=0) on each engine; first
   the sequential engine, then DecodeEngine(speculate_k=4) with the
   n-gram drafter, on the same weights: the same tokens request for
   request, no kernel build after warmup, every committed token a
   prefill's or a verify's, one paged launch a layer per verify run and
   one flash launch a layer per prefill, no plain or composed call;
   logs both engines' tokens/s, the accept rate and histogram, TTFT/TPOT
   and the tracer's join_wait/dispatch p50; then one verify round alone:
   each slot's first verify row equal, op for op and bit for bit, to the
   step program's row at 16 rows (the batch invariance the parity rests
   on), and its host and device time as in 4b;
   4d. eight of those requests with a ModelDrafter of the target's own
   ARCH and weights: the same tokens as the sequential engine, and per
   verify round 1 + k paged launches a layer (the verify run and the
   drafter's k steps); the accept histogram is logged;
5. runs a short float32-KV stream on the card and the same requests
   through the port on the CPU from the same weights, and compares the
   prefill logits and one decode step's logits;
6. trains the repository's Transformer benchmark configuration (bench.py
   bench_transformer: vocab 32000, 6+6 layers, 8 heads, d_model 512,
   d_inner 2048, T=256, batch 64, dropout 0.1, flash attention, float32;
   the bench's bf16 AMP is phase 6i) through build_model / Executor.run
   on the card: one warmup step, then
   timed steps with the launch counts zeroed just before them (12 flash
   forward, 12 dK/dV and 12 dQ launches per step, no plain call, no
   composed attention), and one profiled window (6b);
   6c. the same with `use_fused_ce=True` (1 vocab-CE forward, dh and dW
   launch per step besides the flash launches), profiled as 6b;
   6d. the reference's long-context stack (bench.py longctx_8k: T =
   8192, batch 2, `flash_cross=True`, `use_fused_ce=True`): 18 launches
   of each flash kernel and 1 of each vocab-CE kernel per step, and one
   profiled window;
   6e. the repository's stacked dynamic LSTM benchmark (bench.py
   bench_lstm: vocab 5147, emb 512, hidden 512, 3 layers, max_len 128,
   batch 128, ragged lengths, Adam, float32, nothing cut): 3 LSTM forward
   and 3 backward launches per step, no plain or composed call, and one
   profiled window;
   6f. BERT-base pretraining, MLM + NSP, at the reference bench's widths
   and batch (bench.py bench_bert: vocab 30522, 12 layers, 12 heads,
   d_model 768, d_inner 3072, max_len 128, 20 masked positions, batch
   32, dropout 0.1, flash attention, Adam under linear_lr_warmup over
   polynomial_decay; float32, not the bench's bf16 AMP), its startup
   program run on the card: 12 flash forward, 12 dK/dV and 12 dQ
   launches per step, no plain or composed call, every loss finite, and
   one profiled window;
   6g. ResNet-50 at the reference bench's configuration (bench.py
   bench_resnet50: flowers, depth 50, 1000 classes, batch 128, 3 x 224 x
   224, NCHW, momentum 0.9 at 0.1; float32, not the bench's bf16 AMP, and
   one frozen batch made from a seed): conv2d, pool2d and batch_norm
   through torch (cuDNN convolutions), every kernel count 0, every loss
   finite, images/s, peak memory and one profiled window;
   6h. DeepFM at the bench's configuration (bench.py bench_deepfm: batch
   4096, 26 id fields, 13 dense, vocab 1,000,001 x 16, DNN 400 x 3, Adam;
   make_fake_batch): both is_sparse tables take the SparseGrad path, and
   after the timed steps every row no batch touched keeps its bits in
   both tables and their Adam moments; examples/s, peak memory and one
   profiled window;
7. trains the phase-6 configuration, unfused, fused and with
   `fused_qkv=True` (q, k and v slices of one projection reach the
   flash kernels), at dropout 0 on a cut batch (2 x 64 tokens) for 3
   Adam steps on the card and on the CPU from the same weights, and
   compares the losses, the step-1 gradients and the final parameters;
   7c. the same for the stacked LSTM at full width on a cut batch
   (8 x 32 tokens);
   7d. the same for BERT-base at full width on a cut batch (2 x 128
   tokens, ragged lengths): the total, MLM and NSP losses;
   7e. ResNet-50 at full width on 2 x 3 x 224 x 224 (momentum at 1e-5:
   losses, step-1 gradients, each parameter's update and every batch
   norm's moving statistics, at the tolerances of TOL_RESNET_*) and
   DeepFM at full width on 64 examples (as phase 7, plus equal AUC
   histograms and untouched table rows bit-equal on both devices);
   6i-6k. bf16 mixed precision (`use_amp=True`, the optimizer wrapped by
   `amp.decorate`), as the reference's bench runs these three: the
   Transformer of phase 6 (batch 64 x 256), BERT-base (batch 32 x 128)
   and ResNet-50 (batch 128 x 224 x 224, frozen batch), each with its
   step time, throughput, peak memory and a profiled window (device busy
   and idle share, kernels a step); the Transformer and BERT launch the
   bf16 flash kernels 12 times each a step (12 flash ops) and make no
   plain, composed or float32 flash call;
   7f. the AMP Transformer (2 x 64 tokens) and AMP BERT-base (2 x 128)
   at full width, dropout 0, card against CPU from the same weights:
   the step-1 loss within TOL_AMP_LOSS, each step-1 gradient within
   TOL_AMP_GRAD relative L2, and all of them together within
   TOL_AMP_SHARE of AMP's own distance from float32 (a float32 step of
   the same program on the CPU);
6l. checkpoint and resume at full width: phase 6c's Transformer (fused
   CE) under bf16 AMP with `amp.decorate(use_dynamic_loss_scaling=True)`
   (the update guard and telemetry on), dropout 0.1: 6 uninterrupted
   steps; from the same start 3 steps, `io.save_sharded`, a fresh scope
   and executor that run the startup program, `io.load_sharded` (the
   loaded state bit-equal to the saved), the RNG counter and telemetry
   carried over as the reference's Trainer carries them, 3 more steps:
   losses, persistables and telemetry bit-equal to the uninterrupted
   run's (or, if two uninterrupted runs differ, within twice their
   spread, the ops torch names as not deterministic logged); 12 bf16
   flash forward, dK/dV and dQ and 1 vocab-CE forward, dh and dW launch
   a step, no plain or composed call; bytes written, snapshot, write and
   load times; then `save_inference_model` of the forward program,
   `load_inference_model` and a run whose loss equals the trained
   program's `clone(for_test=True)` loss bit for bit;
6m. the update guard on the card: a guarded and an unguarded step of
   that program, their host synchronizations counted with
   `torch.cuda.set_sync_debug_mode` (the guard adds none), step times,
   device busy time and peak memory; a guarded run of five steps whose
   third carries a token id outside the vocabulary: the update ops'
   state keeps its bits through it, one step skipped, the loss scale
   halves and regrows after two good steps, the first non-finite op
   (numerics on) is the lookup that reads the poisoned feed; and the dh
   and dW kernels at the training shape with the cotangent x 2^15,
   unscaled, against the unscaled kernels;
6n. contrib.Trainer over 6l's program (`build_guarded`'s graph as
   `train_func` and `optimizer_func`) and one epoch of 8 seeded batches
   of 6l's shape, the fourth carrying a token id outside the
   vocabulary; `CheckpointConfig(step_interval=2, async_save=True,
   max_num_checkpoints=2)`, `TelemetryConfig(interval=2)`,
   `step_deadline_s`, `preempt_drain=True`; each run a process of its
   own (`python3 chip_smoke.py --trainer-worker DIR ...`): first an
   uninterrupted control alone on the card (the phase's step and save
   timings: each save's blocking time against its background write, the
   step with and without a write in flight, the goodput categories,
   which must sum to the wall); then, side by side, a run SIGKILLed
   while its second async write is in flight (the writes held 2 s by
   the chaos delaypoint), relaunched, and a run SIGTERMed after 6
   steps, which drains to an emergency checkpoint and exits with
   PREEMPT_EXIT_CODE, relaunched.  Each relaunch's final checkpoint (the
   CRC32 of every variable), run counter, telemetry and step losses
   equal the control's (or lie within twice the spread of two
   uninterrupted runs); no torn directory is left.  The last relaunch
   then runs a DispatchWatchdog around two real steps and a
   `chaos.hang` in a third (StepHangError, a `step_hang` event), and the
   Inferencer on the saved parameters, its loss bit-equal to the trained
   program's `clone(for_test=True)` loss;
8. prints one `kernels` JSON line (the launches of every path above,
   6l, 6m and 6n included), the card line, and as its last line
   {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no
result line; without CUDA it exits 1 at once.  Details go to
chip_smoke_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# the configuration of the reference's decode-serving bench
# (paddle_tpu bench.py:1250-1257), at full width and depth
ARCH = dict(vocab_size=8192, n_layer=4, n_head=8, d_model=512,
            d_inner=1024, seed=0)
SERVE = dict(num_slots=16, page_size=16, max_len=512, num_pages=384,
             prefill_buckets=(32, 64, 128), decode_chunk=16)
N_REQUESTS = 64
SPEC_K = 4                    # phase 4c/4d: bench.py serving_decode_spec_k4
N_ORACLE = 8                  # phase 4d's requests

TOL_KERNEL = 2e-5     # f32 on both sides, other summation order
TOL_LOGITS = 1e-3     # f32 end to end, TF32 off, logits of size ~1-10
# f32 both sides, sums over up to T=256 (q, k) pairs in another order
TOL_BWD = 2e-5

# the Transformer of the reference's training bench (bench.py:698-736,
# run at bench.py:2229-2236), float32 (--no-amp), full width and depth
TRAIN_ARCH = dict(src_vocab_size=32000, trg_vocab_size=32000,
                  max_length=256, n_layer=6, n_head=8, d_model=512,
                  d_inner_hid=2048, dropout=0.1, use_flash=True)
TRAIN_BATCH = 64
TRAIN_STEPS = 10
# phase 6d: the reference's longctx_8k entry (bench.py:2315-2335; the
# widths and depth of TRAIN_ARCH, flash_cross as bench.py:722 sets it
# above 1024 tokens), float32, 16384 tokens a step as phase 6
LONGCTX = dict(max_length=8192, flash_cross=True, use_fused_ce=True)
LONGCTX_BATCH, LONGCTX_STEPS = 2, 3
# phase 3c: each vocab-CE output within TOL_VOCAB of its max |plain|
# (plus TOL_VOCAB): sums over D = 512, V = 32000 or N = 16384 terms in
# another order
TOL_VOCAB = 2e-5
# phase 7: the card against the CPU, batch and sequence cut to 2 x 64
PARITY_BATCH, PARITY_T, PARITY_STEPS = 2, 64, 3
TOL_LOSS = 1e-4       # f32, 6+6 layers and a 32000-way logsumexp
# per parameter, |g_card - g_cpu|_2 / |g_cpu|_2: ReLU units whose input
# lies within float32 noise of 0 switch on or off between two summation
# orders (the JAX package and the port, both on the CPU, differ by up to
# 5e-4 here, and by 4e-3 of max |g| elementwise)
TOL_GRAD = 2e-3

# phases 3d, 6e, 7c: the stacked dynamic LSTM of the reference's bench
# (bench.py:848-907 as bench.py:2242 runs it), float32 as the bench runs
# it, nothing cut
LSTM_ARCH = dict(vocab_size=5147, emb_dim=512, hidden_dim=512,
                 stacked_num=3, class_num=2, max_len=128,
                 learning_rate=1e-3, pallas_rnn=True, rnn_unroll=1)
LSTM_BATCH, LSTM_STEPS = 128, 10
# each LSTM output within TOL_LSTM of its max |plain| (plus TOL_LSTM):
# float32 on both sides; the recurrence compounds the differences of
# another summation order and libm over up to 128 steps
TOL_LSTM = 1e-4
LSTM_PARITY_BATCH, LSTM_PARITY_T = 8, 32

# phases 3f, 6f, 7d: BERT-base pretraining as the reference's bench runs
# it (bench.py:790-801, batch 32 as bench.py:2238 runs it), flash
# attention, float32: the bench's default is bf16 AMP, cut as phase 6's
BERT_ARCH = dict(vocab_size=30522, max_len=128, n_layer=12, n_head=12,
                 d_model=768, d_inner=3072, max_predictions=20,
                 dropout=0.1, use_flash=True)
BERT_BATCH, BERT_STEPS = 32, 10
BERT_PARITY_BATCH = 2          # phase 7d: 2 x 128 tokens, full width

# phases 6g, 7e: ResNet-50 as the reference's bench runs it (bench.py:471-
# 520, run at bench.py:2218: flowers, depth 50, 1000 classes, momentum 0.9
# at learning rate 0.1, batch 128, 3 x 224 x 224, NCHW), float32 (the
# bench's default is bf16 AMP, cut as phase 6's) on one frozen device
# batch made from a seed (the bench's data_mode="frozen": its synthetic
# mode prepends `randint`, which the port lacks)
RESNET_ARCH = dict(dataset="flowers", depth=50, class_dim=1000,
                   learning_rate=0.1)
RESNET_BATCH, RESNET_STEPS = 128, 5
# phase 7e, ResNet-50 at full width on 2 x 3 x 224 x 224, card vs CPU.
# At batch 2 its fifty-three batch norms make the gradients large and
# the trajectory chaotic: at learning rate 1e-3 or 1e-4 the two devices'
# step-2 losses part by 0.6% and 1.5% (H100, 700 W); so 1e-5.  The card
# is not deterministic itself (cuDNN's backward convolutions): two card
# runs' step-2 losses differ by 1.4e-6.  Each batch norm divides by the
# reference's float32 E[x^2] - mean^2, which amplifies the difference of
# two summation orders from layer to layer (on the CPU alone, two thread
# counts give step-1 gradients 4e-3 apart at 2 x 64 x 64).  Measured at
# 1e-5: losses 3.0e-4 relative, step-1 gradients 2.6e-2 relative L2
# (a batch norm's scale), updates over three steps 1.5e-1 relative L2,
# moving statistics 1.4e-3 of the largest; the tolerances are those
# with a margin of 3 to 7.  A wrong update rule, sign or statistic
# misses them by far (errors of order 1).
RESNET_PARITY_BATCH, RESNET_PARITY_LR = 2, 1e-5
TOL_RESNET_LOSS = 1e-3
TOL_RESNET_GRAD = 1e-1
TOL_RESNET_UPDATE = 5e-1
TOL_RESNET_STATS = 1e-2
# phases 6h, 7e: DeepFM as the reference's bench runs it (bench.py:910-
# 960, run at bench.py:2246 with batch 4096): build_model's defaults (26
# id fields, 13 dense, vocab 1,000,001, embedding 16, DNN 400 x 3, Adam
# 1e-3), make_fake_batch; nothing cut
DEEPFM_BATCH, DEEPFM_STEPS = 4096, 20
DEEPFM_PARITY_BATCH = 64       # phase 7e: full width, 64 examples

# phase 3g: the flash kernels' bf16 paths against their bf16 plain
# versions.  O is stored bf16 by both and the kernel rounds p against
# its running row max, the plain version against the final one: two bf16
# ulps of max |O|.  The gradients: both compute in float32 from the same
# bf16 values and round once to bf16, one ulp (2^-7 relative), plus
# 2^-10 of the largest magnitude for sums near 0.
TOL_BF16_O = 2 ** -6
TOL_BF16_GRAD = 2 ** -7
# phases 6i-6k: the same configurations as 6, 6f and 6g under bf16 AMP
AMP = dict(use_amp=True)
# phase 7f: AMP card against CPU at step 1.  Every bf16 rounding of a
# float32 value the two devices sum in another order (cuBLAS or the
# kernels against the CPU's) can land one bf16 ulp (2^-8 relative) apart,
# and 6 + 6 (Transformer) or 12 (BERT) layers carry those flips on.  At
# full width that puts any two implementations that round where the ops
# say about as far apart as AMP is from float32: on the CPU, the JAX
# package and the port part by 0.83 of AMP's own step-1 gradient
# distance from float32 at the 7f Transformer (2 x 64 tokens; 0.13 at
# the CPU tests' 2 layers of d_model 32), the card and the CPU by 0.81
# (BERT-base at 2 x 128: 0.99; H100, 700 W); a layer norm's weight
# gradient, a sum over the tokens with much cancellation, then differs
# by 6.1% (BERT 6.5%) relative L2 between the devices (median 2.1%,
# 2.3%).  So: the losses within 2e-3 (measured 1.3e-4, BERT 5.4e-4),
# each parameter's gradient within 0.15 relative L2, and all of them
# together within 1.5 of AMP's distance from float32 on the CPU (float32
# end to end is held to 1e-4 and 2e-3 in phase 7).
TOL_AMP_LOSS = 2e-3
TOL_AMP_GRAD = 0.15
TOL_AMP_SHARE = 1.5

OUT_DIR = "chip_smoke_out"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=100, warmup=10) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(nbytes, flops):
    """(ms, "bytes" or "operations"): the least time of a kernel that
    computes on the CUDA cores, at the H100's HBM3 rate and float32 peak
    outside the tensor cores (the tensor-core kernels' modules give their
    3xTF32 bounds)."""
    from paddle_tpu_torch.ops.kernels import F32_FLOP_PER_S, HBM_BYTES_PER_S

    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def ptxas_summary(build_log):
    """[(function, "Used N registers, ...; spills")] from `nvcc -Xptxas
    -v` output, kernel template names demangled to name<D>,
    name<D, VEC>, name<bf16, D> or name<D, bf16> (integer, bool and
    pool-type or operand-type template arguments)."""
    import re

    types = {"a": "int8", "t": "bf16", "f": "f32", "13__nv_bfloat16": "bf16"}
    out, fn, spill = [], None, ""
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
            # the kernel's length-prefixed name in the mangled one (it
            # may hold digits: flash_fwd_bf16_kernel), then its template
            # arguments
            for part in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", fn):
                name = part.group(2)[:int(part.group(1))]
                if not name.endswith("_kernel"):
                    continue
                k = re.match(r"I([aft])?((?:L[ib]\d+E)*)(f|13__nv_bfloat16)?E",
                             fn[part.start(2) + len(name):])
                args = [] if not k else [types.get(k.group(1))] + [
                    val if kind == "i" else ("true" if val == "1"
                                             else "false")
                    for kind, val in re.findall(r"L([ib])(\d+)E",
                                                k.group(2))] + [
                    types.get(k.group(3))]
                args = [a for a in args if a is not None]
                fn = f"{name}<{', '.join(args)}>" if args else name
                break
        elif "spill stores" in ln:
            spill = ln.split(":", 1)[-1].strip()
        elif "Used" in ln and "registers" in ln:
            out.append((fn, f"{ln.split(':', 1)[1].strip()}; {spill}"))
    return out


def check_close(name, got, want, tol):
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    abs_err = float(err.max())
    rel_err = float((err / want.abs().clamp_min(1e-6)).max())
    top = float(want.abs().max())
    ok = abs_err <= tol + tol * top
    log(f"  {name}: max_abs_err {abs_err:.3e} ({abs_err / max(top, 1e-30):.2e}"
        f" of max|want| {top:.3e}) max_rel_err {rel_err:.3e} (tol {tol:g} "
        f"abs + {tol:g} rel) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: outside the tolerance "
                             f"(max abs err {abs_err:.3e})")
    return abs_err


# -- phase 3: kernels against their plain versions ------------------------

# phase 3's long-length decode shape: the serving widths at max_len 4096,
# lengths uniform in 2048..4096, a page for every slot's every position
# (16 x 256 + 1 bf16 pages, ~67 MB a pool: the two exceed the L2)
LONG_DECODE = dict(max_len=4096, min_len=2048)


def paged_case(kv_dtype, dev, seed=0, long=False):
    """One decode step of the main path: 16 slots, 8 heads of 64, pools of
    384 pages of 16 rows, 32 pages per slot, ragged lengths as the stream
    has them (prompt 8-128 plus up to 96 generated), NaN past each
    length inside the slot's last page.  With `long`, the long-length
    shape (LONG_DECODE): 256 pages a slot, 16 x 256 + 1 pages."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pk

    g = torch.Generator().manual_seed(seed)
    s, h, d = SERVE["num_slots"], ARCH["n_head"], ARCH["d_model"] // \
        ARCH["n_head"]
    page = SERVE["page_size"]
    if long:
        maxp = LONG_DECODE["max_len"] // page
        p = s * maxp + 1
        lens = torch.randint(LONG_DECODE["min_len"],
                             LONG_DECODE["max_len"] + 1, (s,), generator=g,
                             dtype=torch.int32)
    else:
        p, maxp = SERVE["num_pages"], SERVE["max_len"] // page
        lens = torch.randint(8, 128 + 96 + 1, (s,), generator=g,
                             dtype=torch.int32)
    hd = h * d
    pt = torch.zeros(s, maxp, dtype=torch.int32)
    perm = torch.randperm(p, generator=g)
    used = [-(-int(n) // page) for n in lens]
    off = 0
    for i in range(s):
        pt[i, :used[i]] = perm[off:off + used[i]]
        off += used[i]
    q = torch.randn(s, hd, generator=g)
    ks = vs = None
    if kv_dtype == torch.int8:
        kc = torch.randint(-127, 128, (p, page, hd), generator=g,
                           dtype=torch.int8)
        vc = torch.randint(-127, 128, (p, page, hd), generator=g,
                           dtype=torch.int8)
        ks = (torch.rand(p, page, 1, generator=g) * 0.02).to(dev)
        vs = (torch.rand(p, page, 1, generator=g) * 0.02).to(dev)
    else:
        kc = torch.randn(p, page, hd, generator=g).to(kv_dtype)
        vc = torch.randn(p, page, hd, generator=g).to(kv_dtype)
        for i in range(s):
            for t in range(int(lens[i]), used[i] * page):
                kc[pt[i, t // page], t % page] = 1e3
                vc[pt[i, t // page], t % page] = float("nan")
    args = [x.to(dev) for x in (q, kc, vc, pt, lens)]
    return pk, args, h, ks, vs


def phase_kernels(dev):
    from paddle_tpu_torch.ops.kernels import flash_attention as fk

    rows = {}
    log("phase 3: kernels vs plain versions on the card")
    rows["paged_attention"] = phase_paged_cases(dev)
    rows["paged_attention_verify"] = phase_paged_verify_cases(dev)

    errs = []

    errs = []
    n, h, d = SERVE["num_slots"], ARCH["n_head"], ARCH["d_model"] // \
        ARCH["n_head"]
    for t in SERVE["prefill_buckets"]:
        g = torch.Generator().manual_seed(t)
        q, k, v = (torch.randn(n, t, h * d, generator=g).to(dev)
                   for _ in range(3))
        seq = torch.randint(0, t + 1, (n,), generator=g)
        seq[0] = 0                              # a slot not joining
        bias = ((torch.arange(t)[None, :] < seq[:, None]).float() * 1e9
                - 1e9).reshape(n, 1, 1, t).to(dev)
        scale = d ** -0.5

        def kern():
            return fk.flash_attention_fwd(q, k, v, bias, scale, True,
                                          layout="nthd", n_head=h)

        def plain():
            return fk.flash_attention_fwd_plain(q, k, v, bias, scale, True,
                                                layout="nthd", n_head=h)

        o, lse = kern()
        torch.cuda.synchronize()
        wo, wl = plain()
        errs.append(check_close(f"flash_attention_fwd T={t} out", o, wo,
                                TOL_KERNEL))
        check_close(f"flash_attention_fwd T={t} lse", lse, wl, TOL_KERNEL)
        if t == max(SERVE["prefill_buckets"]):
            causal = torch.full((t, t), float("-inf"), device=dev).triu(1)
            mask = bias + causal                   # (N, 1, T, T)
            q4, k4, v4 = (x.view(n, t, h, d).transpose(1, 2)
                          for x in (q, k, v))

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, scale=scale)

            # back to back, a call this small reads the host's time: the
            # kernel and the library call are timed by their device time
            k_ms, p_ms, l_ms = cuda_ms(kern), cuda_ms(plain), \
                cuda_ms(library)
            kd_ms = profiled_kernel_ms(kern, ("flash_fwd_kernel",),
                                       iters=100)["flash_fwd_kernel"]
            ld_ms = profiled_call_ms(library, iters=100)
            nbytes, flops = fk.bound_bytes_and_flops(q, k, bias, True,
                                                     "nthd", h)
            f32_ms, f32_by = bound_ms(nbytes, flops)
            b_ms, b_by = fk.tensor_core_bound_ms(q, k, bias, True, "nthd", h)
            rows["flash_attention_fwd"] = dict(
                ms=kd_ms, plain_ms=p_ms, library_ms=ld_ms, bound_ms=b_ms,
                bound_by=b_by, f32_bound_ms=f32_ms, f32_bound_by=f32_by,
                wrapper_ms=k_ms, library_call_ms=l_ms, bytes=nbytes,
                flops=flops,
                shape=f"N=16 T={t} H=8 D=64 f32 nthd causal+key bias")
            log(f"  flash_attention_fwd T={t}: kernel device ms {kd_ms:.5f} "
                f"(wrapper back to back {k_ms:.5f}) plain_ms {p_ms:.5f} "
                f"library device ms {ld_ms:.5f} (back to back {l_ms:.5f}) "
                f"bound_ms (3xTF32) {b_ms:.5f} ({b_by}) f32_bound_ms "
                f"{f32_ms:.5f} ({f32_by})")
    errs += phase_flash_fwd_cases(dev)
    rows["flash_attention_fwd"]["max_abs_err"] = max(errs)
    return rows


_PAGED_KERNELS = ("paged_split_kernel", "paged_merge_kernel")


def phase_paged_cases(dev):
    """The paged kernel against its plain version for each pool type at
    the serving shape and the long-length shape, twice, bit-equal; the
    bf16 pools (the main path's) timed by device time (one wrapper call
    launches the split kernel and, with more than one split, the merge
    kernel), beside the wrapper back to back, the plain version and the
    bytes bound."""
    row, errs = {}, []
    for long in (False, True):
        tag = "long" if long else "serving"
        for kv_dtype in (torch.float32, torch.bfloat16, torch.int8):
            pk, (q, kc, vc, pt, lens), h, ks, vs = paged_case(kv_dtype, dev,
                                                              long=long)

            def kern():
                return pk.paged_attention(q, kc, vc, pt, lens, n_head=h,
                                          k_scales=ks, v_scales=vs)

            def plain():
                return pk.paged_attention_plain(q, kc, vc, pt, lens, h,
                                                k_scales=ks, v_scales=vs)

            got = kern()
            torch.cuda.synchronize()
            errs.append(check_close(f"paged_attention {tag} {kv_dtype}",
                                    got, plain(), TOL_KERNEL))
            if not torch.equal(kern(), got):
                raise AssertionError(f"paged_attention {tag} {kv_dtype}: "
                                     f"two runs differ")
            if kv_dtype != torch.bfloat16:      # the main path's pools
                continue
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            plan = pk.launch_plan(q, kc, pt, h, sms)
            names = _PAGED_KERNELS[:1 + (plan["n_splits"] > 1)]
            dev_ms = sum(profiled_kernel_ms(kern, names, iters=100).values())
            k_ms, p_ms = cuda_ms(kern), cuda_ms(plain)
            nbytes, flops = pk.bound_bytes_and_flops(q, kc, pt, lens, h)
            b_ms, b_by = bound_ms(nbytes, flops)
            rec = dict(ms=dev_ms, wrapper_ms=k_ms, plain_ms=p_ms,
                       library_ms=None, bound_ms=b_ms, bound_by=b_by,
                       bytes=nbytes, flops=flops, plan=plan,
                       shape=f"S=16 P={kc.shape[0]} page=16 "
                             f"maxp={pt.shape[1]} H*D=512 bf16, "
                             f"sum(lengths)={int(lens.sum())}")
            if long:
                row["long"] = rec
            else:
                row.update(rec)
            log(f"  paged_attention {tag} bf16: kernel device ms "
                f"{dev_ms:.5f} (wrapper back to back {k_ms:.5f}) plain_ms "
                f"{p_ms:.5f} bound_ms {b_ms:.5f} ({b_by}); "
                f"{plan['n_splits']} splits of {plan['pages_per_split']} "
                f"pages")
    log("  two paged runs bit-equal in every case")
    row["max_abs_err"] = max(errs)
    return row


def paged_verify_case(kv_dtype, dev, seed=0, k=SPEC_K):
    """The speculative verify run's paged call (phase 4c's shape): 16
    slots x (k+1) = 80 rows, 8 heads of 64, pools of 384 pages of 16
    rows; each slot's k+1 rows on that slot's page table at lengths
    c+1..c+k+1 (c: its committed tokens, 8-128 prompt plus up to 96
    generated), the rows past the slot's draft length (drawn from 0..k)
    pinned to c+1 as the engine pins its dead rows, two slots inactive
    (all their rows length 0 on the zero page table, as the engine leaves
    them); 1e3 / NaN past each slot's longest row inside its last
    page."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pk

    g = torch.Generator().manual_seed(seed)
    s, h, d = SERVE["num_slots"], ARCH["n_head"], ARCH["d_model"] // \
        ARCH["n_head"]
    page, p = SERVE["page_size"], SERVE["num_pages"]
    maxp, k1, hd = SERVE["max_len"] // page, k + 1, h * d
    committed = torch.randint(8, 128 + 96 - k, (s,), generator=g)
    draft_len = torch.randint(0, k + 1, (s,), generator=g)
    inactive = (3, 11)
    kc = torch.randn(p, page, hd, generator=g).to(kv_dtype)
    vc = torch.randn(p, page, hd, generator=g).to(kv_dtype)
    pt = torch.zeros(s * k1, maxp, dtype=torch.int32)
    lens = torch.zeros(s * k1, dtype=torch.int32)
    perm = torch.randperm(p, generator=g)
    off, j = 0, torch.arange(k1)
    for i in range(s):
        if i in inactive:
            continue
        used = -(-(int(committed[i]) + k1) // page)
        pages = perm[off:off + used]
        off += used
        rows = slice(i * k1, (i + 1) * k1)
        pt[rows, :used] = pages.to(torch.int32)
        lens[rows] = (committed[i] + 1 + torch.where(
            j <= draft_len[i], j, 0)).to(torch.int32)
        for t in range(int(lens[rows].max()), used * page):
            kc[pages[t // page], t % page] = 1e3
            vc[pages[t // page], t % page] = float("nan")
    q = torch.randn(s * k1, hd, generator=g)
    return pk, [x.to(dev) for x in (q, kc, vc, pt, lens)], h


def phase_paged_verify_cases(dev):
    """The paged kernel at the verify shape against its plain version,
    float32 and bf16 pools, with the plan of the 80 rows and with the
    step's plan (plan_rows 16, the main path's launch), twice bit-equal;
    the bf16 case (the main path's pools) timed by device time beside the
    wrapper back to back, the plain version and the bytes bound (a slot's
    rows read its K/V rows once between them)."""
    row, errs = {}, []
    s = SERVE["num_slots"]
    for kv_dtype in (torch.float32, torch.bfloat16):
        pk, (q, kc, vc, pt, lens), h = paged_verify_case(kv_dtype, dev)
        want = pk.paged_attention_plain(q, kc, vc, pt, lens, h)
        for plan_rows in (None, s):
            def kern(plan_rows=plan_rows):
                return pk.paged_attention(q, kc, vc, pt, lens, n_head=h,
                                          plan_rows=plan_rows)

            got = kern()
            torch.cuda.synchronize()
            errs.append(check_close(
                f"paged_attention verify shape {kv_dtype} plan_rows="
                f"{plan_rows}", got, want, TOL_KERNEL))
            if not torch.equal(kern(), got):
                raise AssertionError(f"paged_attention verify shape "
                                     f"{kv_dtype}: two runs differ")
        if kv_dtype != torch.bfloat16:
            continue
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = pk.launch_plan(q, kc, pt, h, sms, plan_rows=s)
        names = _PAGED_KERNELS[:1 + (plan["n_splits"] > 1)]
        dev_ms = sum(profiled_kernel_ms(kern, names, iters=100).values())
        k_ms = cuda_ms(kern)
        p_ms = cuda_ms(lambda: pk.paged_attention_plain(q, kc, vc, pt, lens,
                                                        h))
        nbytes, flops = pk.bound_bytes_and_flops(q, kc, pt, lens, h)
        b_ms, b_by = bound_ms(nbytes, flops)
        row.update(ms=dev_ms, wrapper_ms=k_ms, plain_ms=p_ms,
                   library_ms=None, bound_ms=b_ms, bound_by=b_by,
                   bytes=nbytes, flops=flops, plan=plan,
                   shape=f"rows=80 (16 slots x 5) P={kc.shape[0]} page=16 "
                         f"maxp={pt.shape[1]} H*D=512 bf16, "
                         f"sum(lengths)={int(lens.sum())}")
        log(f"  paged_attention verify shape bf16: kernel device ms "
            f"{dev_ms:.5f} (wrapper back to back {k_ms:.5f}) plain_ms "
            f"{p_ms:.5f} bound_ms {b_ms:.5f} ({b_by}); "
            f"{plan['n_splits']} splits of {plan['pages_per_split']} pages")
    row["max_abs_err"] = max(errs)
    return row


def phase_flash_fwd_cases(dev):
    """The forward kernel (O and lse) against the plain forward beyond the
    serving shapes: D = 32, 64 and 128, both layouts, causal and not,
    with a key bias and without, at T = 100 (ragged tiles); causal
    offsets 37/5 at T = 130; operands one float into their storage (the
    wrapper copies them); and two runs at the training shape, which must
    give the same bits.  Returns the max abs errors of O."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fk

    for fn, used in ptxas_summary(_build.build_log("flash_attention_fwd")):
        log(f"  ptxas {fn}: {used}")
    h = TRAIN_ARCH["n_head"]
    cases = []
    for d in (32, 64, 128):
        for layout in ("nthd", "nhtd"):
            for causal in (True, False):
                for with_bias in (True, False):
                    cases.append((f"D={d} {layout} T=100"
                                  f"{' causal' if causal else ''}"
                                  f"{' +bias' if with_bias else ''}",
                                  (4, h, 100, d, layout, causal),
                                  dict(bias=with_bias)))
    for d in (64, 128):
        cases += [(f"D={d} offsets 37/5 T=130 causal",
                   (4, h, 130, d, "nhtd", True),
                   dict(q_offset=37, k_offset=5)),
                  (f"D={d} misaligned T=100 causal",
                   (4, h, 100, d, "nhtd", True), dict(misaligned=True))]
    errs = []
    for i, (name, (n, ch, t, d, layout, causal), extra) in enumerate(cases):
        q, k, v, _, bias, _ = flash_operands(
            dev, n, ch, t, d, layout, seed=50 + i,
            misaligned=extra.get("misaligned", False))
        if not extra.get("bias", True):
            bias = None
        args = (q, k, v, bias, None, causal, layout, ch,
                extra.get("q_offset", 0), extra.get("k_offset", 0))
        o, lse = fk.flash_attention_fwd(*args)
        torch.cuda.synchronize()
        wo, wl = fk.flash_attention_fwd_plain(*args)
        errs.append(check_close(f"flash_attention_fwd {name} out", o, wo,
                                TOL_KERNEL))
        check_close(f"flash_attention_fwd {name} lse", lse, wl, TOL_KERNEL)
    n, t, d = TRAIN_BATCH, TRAIN_ARCH["max_length"], \
        TRAIN_ARCH["d_model"] // h
    q, k, v, _, bias, _ = flash_operands(dev, n, h, t, d, "nhtd", seed=49)
    first = fk.flash_attention_fwd(q, k, v, bias, None, True, "nhtd", h)
    again = fk.flash_attention_fwd(q, k, v, bias, None, True, "nhtd", h)
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("flash fwd: two runs at the training shape "
                             "differ")
    log("  two forward runs at the training shape bit-equal")
    return errs


# -- phase 3b: the flash backward kernels against the plain backward -----

def flash_operands(dev, n, h, t, d, layout, seed, dbias=False,
                   misaligned=False, lengths=None):
    """q, k, v, dO as the training path makes them: nhtd operands are
    transposed views of (N, T, H, D) tensors (the model's reshape +
    transpose), with the key-padding bias of ragged lengths (row 0 full
    length), or of `lengths` when given: mask * 1e9 - 1e9, as the
    models' sequence_mask + scale build it.  With `misaligned`,
    q/k/v/dO start one float into their storage.  Returns them, the bias
    and the generator, for more draws."""
    g = torch.Generator().manual_seed(seed)
    shape = (n, t, h * d) if layout == "nthd" else (n, t, h, d)
    q, k, v, do = (torch.randn(*shape, generator=g).to(dev)
                   for _ in range(4))
    if misaligned:
        q, k, v, do = (torch.empty(x.numel() + 1, device=dev)[1:]
                       .view(shape).copy_(x) for x in (q, k, v, do))
    if layout == "nhtd":
        q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
    if lengths is None:
        seq = torch.randint(1, t + 1, (n,), generator=g)
        seq[0] = t
    else:
        seq = torch.as_tensor(lengths)
    bias = ((torch.arange(t)[None, :] < seq[:, None]).float() * 1e9
            - 1e9).reshape(n, 1, 1, t).to(dev)
    if dbias:                                # a bias with a gradient
        bias = bias + torch.randn(n, 1, 1, t, generator=g).to(dev) * 0.1
    return q, k, v, do, bias, g


def bwd_case(dev, n, h, t, d, layout, causal, seed, dbias=False,
             dlse=False, q_offset=0, k_offset=0, misaligned=False,
             lengths=None):
    """Operands of one backward call as the training path makes them
    (`flash_operands`); O and lse come from the forward kernel."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fk

    q, k, v, do, bias, g = flash_operands(dev, n, h, t, d, layout, seed,
                                          dbias, misaligned, lengths)
    o, lse = fk.flash_attention_fwd(q, k, v, bias, None, causal,
                                    layout=layout, n_head=h,
                                    q_offset=q_offset, k_offset=k_offset)
    dl = torch.randn(lse.shape, generator=g).to(dev) if dlse else None
    return dict(q=q, k=k, v=v, bias=bias, o=o, lse=lse, do=do, dlse=dl,
                causal=causal, layout=layout, n_head=h, need_dbias=dbias,
                args=(q, k, v, bias, o, lse, do, dl, None, causal, layout,
                      h, q_offset, k_offset))


_BWD_KERNELS = ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")
# the bf16 paths' kernels of their own (phase 3g)
_BWD_BF16_KERNELS = ("flash_bwd_dkv_bf16_kernel", "flash_bwd_dq_bf16_kernel")


def phase_bwd_kernels(dev):
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fk

    log("phase 3b: flash backward kernels vs the plain backward")
    # registers and spills of the float32 kernels and, beside them, the
    # bf16 paths' kernels, each at D = 32, 64 and 128
    ptx = [(fn, used) for fn, used in
           ptxas_summary(_build.build_log("flash_attention_bwd"))
           if fn.startswith(_BWD_KERNELS + _BWD_BF16_KERNELS)]
    for fn, used in ptx:
        log(f"  ptxas {fn}: {used}")
    if not all(any(fn == f"{k}<{d}>" for fn, _ in ptx)
               for k in _BWD_KERNELS + _BWD_BF16_KERNELS
               for d in (32, 64, 128)):
        raise AssertionError("no ptxas line for the flash backward kernels")
    n, h, t, d = TRAIN_BATCH, TRAIN_ARCH["n_head"], \
        TRAIN_ARCH["max_length"], TRAIN_ARCH["d_model"] // \
        TRAIN_ARCH["n_head"]
    cases = [("train causal", (n, h, t, d, "nhtd", True), {}),
             ("train", (n, h, t, d, "nhtd", False), {}),
             ("T=100 causal", (8, h, 100, d, "nhtd", True), {}),
             ("nthd T=128 causal", (8, h, 128, d, "nthd", True), {}),
             ("dbias+dlse T=100", (4, h, 100, d, "nhtd", False),
              dict(dbias=True, dlse=True)),
             ("offsets 37/5 T=130 causal", (8, h, 130, d, "nhtd", True),
              dict(q_offset=37, k_offset=5)),
             ("offsets 0/200 T=130 causal (no key visible)",
              (8, h, 130, d, "nhtd", True), dict(q_offset=0, k_offset=200)),
             ("misaligned T=100 causal", (8, h, 100, d, "nhtd", True),
              dict(misaligned=True)),
             ("D=128 T=100 causal", (8, h, 100, 128, "nhtd", True), {}),
             ("D=128 nthd dbias+dlse T=100", (4, h, 100, 128, "nthd", False),
              dict(dbias=True, dlse=True)),
             ("D=128 offsets 37/5 T=130 causal",
              (8, h, 130, 128, "nhtd", True),
              dict(q_offset=37, k_offset=5)),
             ("D=32 T=100 causal", (8, h, 100, 32, "nhtd", True), {})]
    errs, timed = {"dkv": [], "dq": []}, {}
    for i, (name, (cn, ch, ct, cd, layout, causal), extra) in \
            enumerate(cases):
        c = bwd_case(dev, cn, ch, ct, cd, layout, causal, seed=10 + i,
                     **extra)

        def kern():
            return fk.flash_attention_bwd(*c["args"],
                                          need_dbias=c["need_dbias"])

        def plain():
            return fk.flash_attention_bwd_plain(*c["args"])

        got = kern()
        torch.cuda.synchronize()
        want = plain()
        for gname, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
            if b is None or (a is None and not c["need_dbias"]):
                continue
            errs["dq" if gname == "dq" else "dkv"].append(
                check_close(f"flash bwd {name} {gname}", a, b, TOL_BWD))
        del want
        if i == 0:
            # each block owns its rows over the whole sum, no atomics
            again = kern()
            if not all(torch.equal(a, b) for a, b in zip(got, again)
                       if a is not None):
                raise AssertionError("flash bwd: two runs at the training "
                                     "shape differ")
            log("  two backward runs at the training shape bit-equal")
            del again
        if not name.startswith("train"):
            continue
        per = profiled_kernel_ms(kern, _BWD_KERNELS)
        ms = {"dkv": per["flash_bwd_dkv_kernel"],
              "dq": per["flash_bwd_dq_kernel"],
              "both": cuda_ms(kern, iters=20, warmup=3)}
        ms["plain"] = cuda_ms(plain, iters=10, warmup=2)
        ms["library"] = cuda_ms(_sdpa_backward(c, d), iters=10, warmup=2)
        bounds = fk.bound_bytes_and_flops_bwd(c["q"], c["k"], c["bias"],
                                              causal, layout, ch)
        tc = fk.tensor_core_bound_ms_bwd(c["q"], c["k"], c["bias"], causal,
                                         layout, ch)
        timed[name] = dict(ms=ms, bounds=bounds, tc=tc)
        log(f"  {name}: dkv_ms {ms['dkv']:.5f} dq_ms {ms['dq']:.5f} "
            f"(wrapper, both kernels: {ms['both']:.5f}) plain_ms "
            f"{ms['plain']:.5f} library_ms {ms['library']:.5f}")
    rows = {}
    for kname, full in (("dkv", "flash_attention_bwd_dkv"),
                        ("dq", "flash_attention_bwd_dq")):
        # the main path's mix: 6 causal and 6 non-causal launches a step
        per = []
        for name, r in timed.items():
            f32_ms, f32_by = bound_ms(*r["bounds"][kname])
            tc_ms, tc_by = r["tc"][kname]
            per.append(dict(ms=r["ms"][kname], plain_ms=r["ms"]["plain"],
                            library_ms=r["ms"]["library"],
                            bound_ms=tc_ms, bound_by=tc_by,
                            f32_bound_ms=f32_ms, f32_bound_by=f32_by,
                            bytes=r["bounds"][kname][0],
                            flops=r["bounds"][kname][1], case=name))
        mean = {key: sum(p[key] for p in per) / len(per)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "f32_bound_ms")}
        # the mix's bound is operations when the non-causal case's is
        mean["bound_by"] = per[-1]["bound_by"]
        mean["max_abs_err"] = max(errs[kname])
        mean["cases"] = per
        mean["shape"] = ("N=64 H=8 T=256 D=64 f32 nhtd (transposed views) "
                         "+ key bias; mean of the causal and non-causal "
                         "case, the training step's 6 + 6 mix")
        rows[full] = mean
        log(f"  {full}: ms {mean['ms']:.5f} bound_ms (3xTF32) "
            f"{mean['bound_ms']:.5f} (causal {per[0]['bound_by']}, not "
            f"{per[-1]['bound_by']}) f32_bound_ms "
            f"{mean['f32_bound_ms']:.5f} plain_ms {mean['plain_ms']:.5f} "
            f"library_ms {mean['library_ms']:.5f}")
    return rows


def flash_bwd_at_longctx_shape(dev):
    """The backward pair alone at phase 6d's shape (N=2, H=8, T=8192,
    D=64, nhtd transposed views + key-padding bias), causal and not:
    held against the plain backward (TOL_BWD; 128 q and k tiles a
    block's sum runs over), and timed beside the library's backward and
    the 3xTF32 bounds.  The plain version's score-sized tensors take
    ~20 GB at this shape."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fk

    h, d = TRAIN_ARCH["n_head"], TRAIN_ARCH["d_model"] // TRAIN_ARCH["n_head"]
    n, t = LONGCTX_BATCH, LONGCTX["max_length"]
    out = {}
    for causal in (True, False):
        tag = "causal" if causal else "not causal"
        c = bwd_case(dev, n, h, t, d, "nhtd", causal, seed=40)

        def kern():
            return fk.flash_attention_bwd(*c["args"], need_dbias=False)

        got = kern()
        torch.cuda.synchronize()
        want = fk.flash_attention_bwd_plain(*c["args"])
        err = {}
        for gname, a, b in zip(("dq", "dk", "dv"), got, want):
            err[gname] = check_close(f"flash bwd T={t} {tag} {gname}", a, b,
                                     TOL_BWD)
        del got, want
        torch.cuda.empty_cache()
        per = profiled_kernel_ms(kern, _BWD_KERNELS, iters=3, warmup=1)
        lib = cuda_ms(_sdpa_backward(c, d), iters=3, warmup=1)
        tc = fk.tensor_core_bound_ms_bwd(c["q"], c["k"], c["bias"], causal,
                                         "nhtd", h)
        row = {"dkv_ms": per["flash_bwd_dkv_kernel"],
               "dq_ms": per["flash_bwd_dq_kernel"], "library_ms": lib,
               "dkv_bound_ms": tc["dkv"][0], "dq_bound_ms": tc["dq"][0],
               "dkv_max_abs_err": max(err["dk"], err["dv"]),
               "dq_max_abs_err": err["dq"]}
        out[tag] = row
        log(f"  flash bwd alone at N={n} T={t} H=8 D=64 nhtd {tag}: dkv_ms "
            f"{row['dkv_ms']:.5f} dq_ms {row['dq_ms']:.5f} (pair "
            f"{row['dkv_ms'] + row['dq_ms']:.5f}) library_ms {lib:.5f}; "
            f"3xTF32 bounds {tc['dkv'][0]:.5f} / {tc['dq'][0]:.5f}")
        del c
        torch.cuda.empty_cache()
    return out


def _profiled_device_events(fn, iters, warmup):
    """The CUDA kernel events of `iters` calls of fn() under torch.profiler.
    The profiler traces one call in a warm-up step it discards before the
    measured step: a kernel launched as tracing starts can go unrecorded,
    and every launch of the measured step must be seen."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def _device_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profiled_kernel_ms(fn, names, iters=20, warmup=3, attempts=3):
    """{name: mean device ms per launch} of the CUDA kernels whose name
    contains each of `names`, over `iters` calls of fn() under
    torch.profiler (one wrapper call launches both backward kernels).
    The trace should see every launch of the measured step, but the
    profiler has dropped records (1 of 5 dh launches in one run, 1-9 of
    20 flash backward launches in another, on the same card): a trace
    that missed some is taken again, up to `attempts` traces, and if none
    saw them all, the mean is over the launches the fullest trace
    recorded, which must be at least half of them."""
    best = None
    for attempt in range(attempts):
        events = _profiled_device_events(fn, iters, warmup)
        counts = {name: sum(e.count for e in events if name in e.key)
                  for name in names}
        if best is None or min(counts.values()) > min(best[1].values()):
            best = (events, counts)
        if all(c == iters for c in counts.values()):
            break
        log(f"  profiler trace {attempt + 1} saw {counts} launches, want "
            f"{iters} each")
    events, counts = best
    if min(counts.values()) * 2 < iters:
        raise AssertionError(f"launches profiled {counts}, want {iters} "
                             f"each (at least half), in {attempts} traces")
    return {name: sum(_device_us(e) for e in events if name in e.key)
            / counts[name] / 1e3 for name in names}


def profiled_call_ms(fn, iters=20, warmup=3, attempts=3):
    """Mean device ms of all the kernels one call of fn() launches (a
    library call's device time, without the host's).  A trace that saw
    no kernel at all (as one of SDPA's bf16 forward at D = 128 did) is
    taken again, up to `attempts` traces; if none saw one, the call is
    timed by CUDA events instead (host time included), and the log says
    so."""
    for attempt in range(attempts):
        events = _profiled_device_events(fn, iters, warmup)
        if events:
            return sum(_device_us(e) for e in events) / iters / 1e3
        log(f"  profiler trace {attempt + 1} saw no CUDA kernel")
    log("  no trace saw a kernel: timed by CUDA events instead")
    return cuda_ms(fn, iters=iters, warmup=warmup)


def _sdpa_mask(c):
    """The case's key bias and, when causal, the causal mask as one float
    attn_mask for scaled_dot_product_attention."""
    if not c["causal"]:
        return c["bias"].to(c["q"].dtype)
    t = c["q"].shape[2]
    return (c["bias"] + torch.full((t, t), float("-inf"),
                                   device=c["bias"].device).triu(1)
            ).to(c["q"].dtype)


def _sdpa_backward(c, d):
    """The library yardstick: autograd through scaled_dot_product_attention
    (`_sdpa_mask`), the backward alone timed (dQ, dK and dV in one
    call)."""
    q, k, v = (c[x].detach().requires_grad_() for x in ("q", "k", "v"))
    o = torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=_sdpa_mask(c), scale=d ** -0.5)
    do = c["do"]

    def run():
        return torch.autograd.grad(o, (q, k, v), do, retain_graph=True)

    return run


def _sdpa_forward(c, d):
    """The library yardstick of the forward: scaled_dot_product_attention
    on the same inputs (`_sdpa_mask`)."""
    mask = _sdpa_mask(c)

    def run():
        return torch.nn.functional.scaled_dot_product_attention(
            c["q"], c["k"], c["v"], attn_mask=mask, scale=d ** -0.5)

    return run


def flash_fwd_timed(c, d, iters):
    """The forward kernel alone on a case's inputs, beside its 3xTF32 and
    float32 bounds and the library call."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fk

    def kern():
        return fk.flash_attention_fwd(c["q"], c["k"], c["v"], c["bias"],
                                      None, c["causal"], layout=c["layout"],
                                      n_head=c["n_head"])

    f32_ms, f32_by = bound_ms(*fk.bound_bytes_and_flops(
        c["q"], c["k"], c["bias"], c["causal"], c["layout"], c["n_head"]))
    tc_ms, tc_by = fk.tensor_core_bound_ms(c["q"], c["k"], c["bias"],
                                           c["causal"], c["layout"],
                                           c["n_head"])
    return dict(causal=c["causal"], bound_ms=tc_ms, bound_by=tc_by,
                f32_bound_ms=f32_ms, f32_bound_by=f32_by,
                ms=cuda_ms(kern, iters=iters, warmup=2),
                library_ms=cuda_ms(_sdpa_forward(c, d), iters=iters,
                                   warmup=2))


def _mean_row(per):
    row = {key: sum(p[key] for p in per) / len(per)
           for key in ("ms", "bound_ms", "f32_bound_ms", "library_ms")}
    row["cases"] = per
    return row


def flash_fwd_at_training_shapes(dev):
    """The flash forward alone at the training steps' shapes: phase 6's
    N=64, T=256 and phase 6d's N=2, T=8192 (H=8, D=64, nhtd transposed
    views + key-padding bias, causal and not, the mean of the two as
    each step runs both), with its bounds and scaled_dot_product_attention
    on the same inputs beside it."""
    h, d = TRAIN_ARCH["n_head"], TRAIN_ARCH["d_model"] // TRAIN_ARCH["n_head"]
    out = {}
    for n, t in ((TRAIN_BATCH, TRAIN_ARCH["max_length"]),
                 (LONGCTX_BATCH, LONGCTX["max_length"])):
        per = []
        for causal in (True, False):
            c = bwd_case(dev, n, h, t, d, "nhtd", causal, seed=30 + t)
            per.append(flash_fwd_timed(c, d, iters=20 if t <= 256 else 3))
            del c
        row = out[f"N={n} T={t}"] = _mean_row(per)
        log(f"  flash_attention_fwd alone at N={n} T={t} H=8 D=64 nhtd: "
            f"ms {row['ms']:.5f} (causal {per[0]['ms']:.5f}, not "
            f"{per[1]['ms']:.5f}) bound_ms (3xTF32) {row['bound_ms']:.5f} "
            f"({per[0]['bound_by']}, {per[1]['bound_by']}) f32_bound_ms "
            f"{row['f32_bound_ms']:.5f} library_ms {row['library_ms']:.5f} "
            f"(causal {per[0]['library_ms']:.5f}, not "
            f"{per[1]['library_ms']:.5f})")
    return out


def flash_at_d128_shape(dev):
    """Head dim 128 (d_model 1024, 8 heads) at N=16, T=512, nhtd
    transposed views + key-padding bias, causal and not: the forward
    (O, lse) held against the plain forward (TOL_KERNEL) and the backward
    pair against the plain backward (TOL_BWD), each timed beside its
    3xTF32 and float32 bounds and the library's forward or backward."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fk

    n, h, t, d = 16, 8, 512, 128
    out = {"fwd": [], "bwd": []}
    for causal in (True, False):
        tag = "causal" if causal else "not causal"
        c = bwd_case(dev, n, h, t, d, "nhtd", causal, seed=45)
        wo, wl = fk.flash_attention_fwd_plain(*c["args"][:4], None, causal,
                                              "nhtd", h)
        fwd = flash_fwd_timed(c, d, iters=20)
        fwd["max_abs_err"] = check_close(f"flash fwd D=128 {tag} out",
                                         c["o"], wo, TOL_KERNEL)
        check_close(f"flash fwd D=128 {tag} lse", c["lse"], wl, TOL_KERNEL)
        out["fwd"].append(fwd)
        del wo, wl

        def kern():
            return fk.flash_attention_bwd(*c["args"], need_dbias=False)

        got = kern()
        torch.cuda.synchronize()
        want = fk.flash_attention_bwd_plain(*c["args"])
        err = {g: check_close(f"flash bwd D=128 {tag} {g}", a, b, TOL_BWD)
               for g, a, b in zip(("dq", "dk", "dv"), got, want)}
        del got, want
        per = profiled_kernel_ms(kern, _BWD_KERNELS)
        tc = fk.tensor_core_bound_ms_bwd(c["q"], c["k"], c["bias"], causal,
                                         "nhtd", h)
        bounds = fk.bound_bytes_and_flops_bwd(c["q"], c["k"], c["bias"],
                                              causal, "nhtd", h)
        out["bwd"].append({
            "causal": causal, "dkv_ms": per["flash_bwd_dkv_kernel"],
            "dq_ms": per["flash_bwd_dq_kernel"],
            "library_ms": cuda_ms(_sdpa_backward(c, d), iters=10, warmup=2),
            "dkv_bound_ms": tc["dkv"][0], "dkv_bound_by": tc["dkv"][1],
            "dq_bound_ms": tc["dq"][0], "dq_bound_by": tc["dq"][1],
            "dkv_f32_bound_ms": bound_ms(*bounds["dkv"])[0],
            "dq_f32_bound_ms": bound_ms(*bounds["dq"])[0],
            "dkv_max_abs_err": max(err["dk"], err["dv"]),
            "dq_max_abs_err": err["dq"]})
        b = out["bwd"][-1]
        log(f"  flash D=128 N={n} T={t} H={h} nhtd {tag}: fwd ms "
            f"{fwd['ms']:.5f} bound_ms (3xTF32) {fwd['bound_ms']:.5f} "
            f"({fwd['bound_by']}) f32_bound_ms {fwd['f32_bound_ms']:.5f} "
            f"library_ms {fwd['library_ms']:.5f}; bwd dkv_ms "
            f"{b['dkv_ms']:.5f} dq_ms {b['dq_ms']:.5f} (pair "
            f"{b['dkv_ms'] + b['dq_ms']:.5f}) 3xTF32 bounds "
            f"{b['dkv_bound_ms']:.5f} / {b['dq_bound_ms']:.5f}, f32 bounds "
            f"{b['dkv_f32_bound_ms']:.5f} / {b['dq_f32_bound_ms']:.5f}, "
            f"library_ms {b['library_ms']:.5f}")
        del c
        torch.cuda.empty_cache()
    out["fwd_mean"] = _mean_row(out["fwd"])
    return out


# -- phase 3f: the flash kernels at BERT-base's shape ---------------------

def flash_at_bert_shape(dev):
    """BERT-base's attention alone: N=32, H=12, T=128, D=64, not causal,
    the key-padding bias of ragged lengths in 1..128 (row 0 of length 1)
    as bert.py builds it, in both layouts (nhtd as transposed views, the
    model's; nthd, head_major's).  The forward (O, lse) within
    TOL_KERNEL of the plain forward and the backward pair within TOL_BWD
    of the plain backward, two runs of each bit-equal; device times
    (profiler) beside the 3xTF32 and float32 bounds and
    scaled_dot_product_attention with the same additive mask, forward
    and its autograd backward (the yardstick only), and the plain
    versions' times (CUDA events)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fk

    n, t, h = BERT_BATCH, BERT_ARCH["max_len"], BERT_ARCH["n_head"]
    d = BERT_ARCH["d_model"] // h
    lengths = torch.randint(1, t + 1, (n,),
                            generator=torch.Generator().manual_seed(60))
    lengths[0], lengths[1] = 1, t
    out = {"lengths": lengths.tolist()}
    for layout in ("nhtd", "nthd"):
        c = bwd_case(dev, n, h, t, d, layout, False, seed=61,
                     lengths=lengths)
        q, k, v, bias = c["args"][:4]

        def fwd():
            return fk.flash_attention_fwd(q, k, v, bias, None, False,
                                          layout=layout, n_head=h)

        def bwd():
            return fk.flash_attention_bwd(*c["args"], need_dbias=False)

        wo, wl = fk.flash_attention_fwd_plain(q, k, v, bias, None, False,
                                              layout, h)
        err = {"out": check_close(f"flash fwd BERT {layout} out", c["o"],
                                  wo, TOL_KERNEL),
               "lse": check_close(f"flash fwd BERT {layout} lse",
                                  c["lse"], wl, TOL_KERNEL)}
        del wo, wl
        got = bwd()
        torch.cuda.synchronize()
        want = fk.flash_attention_bwd_plain(*c["args"])
        for g, a, b in zip(("dq", "dk", "dv"), got, want):
            err[g] = check_close(f"flash bwd BERT {layout} {g}", a, b,
                                 TOL_BWD)
        del want
        o2, l2 = fwd()
        again = bwd()
        if not (torch.equal(o2, c["o"]) and torch.equal(l2, c["lse"])
                and all(torch.equal(a, b) for a, b in zip(got[:3],
                                                          again[:3]))):
            raise AssertionError(f"flash at BERT's shape ({layout}): two "
                                 f"runs differ")
        del got, again, o2, l2
        # the library call on the same values as (N, H, T, D) tensors
        four = dict(c)
        if layout == "nthd":
            for x in ("q", "k", "v", "do"):
                four[x] = c[x].view(n, t, h, d).transpose(1, 2)
        fwd_ms = profiled_kernel_ms(fwd, ("flash_fwd_kernel",))
        per = profiled_kernel_ms(bwd, _BWD_KERNELS)
        lib_fwd = profiled_call_ms(_sdpa_forward(four, d))
        lib_bwd = profiled_call_ms(_sdpa_backward(four, d))
        plain_fwd = cuda_ms(lambda: fk.flash_attention_fwd_plain(
            q, k, v, bias, None, False, layout, h), iters=10, warmup=2)
        plain_bwd = cuda_ms(lambda: fk.flash_attention_bwd_plain(
            *c["args"]), iters=10, warmup=2)
        tc = fk.tensor_core_bound_ms(q, k, bias, False, layout, h)
        f32 = bound_ms(*fk.bound_bytes_and_flops(q, k, bias, False,
                                                  layout, h))
        tcb = fk.tensor_core_bound_ms_bwd(q, k, bias, False, layout, h)
        bb = fk.bound_bytes_and_flops_bwd(q, k, bias, False, layout, h)
        row = {"fwd_ms": fwd_ms["flash_fwd_kernel"],
               "dkv_ms": per["flash_bwd_dkv_kernel"],
               "dq_ms": per["flash_bwd_dq_kernel"],
               "library_fwd_ms": lib_fwd, "library_bwd_ms": lib_bwd,
               "plain_fwd_ms": plain_fwd, "plain_bwd_ms": plain_bwd,
               "fwd_bound_ms": tc[0], "fwd_bound_by": tc[1],
               "fwd_f32_bound_ms": f32[0], "fwd_f32_bound_by": f32[1],
               "dkv_bound_ms": tcb["dkv"][0], "dkv_bound_by": tcb["dkv"][1],
               "dq_bound_ms": tcb["dq"][0], "dq_bound_by": tcb["dq"][1],
               "dkv_f32_bound_ms": bound_ms(*bb["dkv"])[0],
               "dq_f32_bound_ms": bound_ms(*bb["dq"])[0],
               "fwd_max_abs_err": max(err["out"], err["lse"]),
               "dkv_max_abs_err": max(err["dk"], err["dv"]),
               "dq_max_abs_err": err["dq"]}
        out[layout] = row
        log(f"  flash at BERT's shape N={n} H={h} T={t} D={d} {layout}, "
            f"not causal, key bias: fwd device ms {row['fwd_ms']:.5f} "
            f"(bounds 3xTF32 {tc[0]:.5f} {tc[1]}, f32 {f32[0]:.5f} "
            f"{f32[1]}; plain {plain_fwd:.5f}, library {lib_fwd:.5f}); "
            f"dkv {row['dkv_ms']:.5f} "
            f"dq {row['dq_ms']:.5f} (pair "
            f"{row['dkv_ms'] + row['dq_ms']:.5f}; 3xTF32 bounds "
            f"{tcb['dkv'][0]:.5f} / {tcb['dq'][0]:.5f}, f32 "
            f"{row['dkv_f32_bound_ms']:.5f} / {row['dq_f32_bound_ms']:.5f}; "
            f"plain backward {plain_bwd:.5f}, library backward "
            f"{lib_bwd:.5f})")
        del c, four
        torch.cuda.empty_cache()
    log("  two runs at BERT's shape bit-equal, both layouts")
    return out


# -- phase 3g: the flash kernels' bf16 paths -----------------------------

_BF16_FWD = ("flash_fwd_bf16_kernel",)


def bf16_case(dev, n, h, t, d, layout, causal, seed, lengths=None):
    """`bwd_case`'s operands (nhtd ones transposed views) in bf16 and the
    key bias in bf16, as the AMP policy casts them; O and lse from the
    forward kernel's bf16 path."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fk

    q, k, v, do, bias, _ = flash_operands(dev, n, h, t, d, layout, seed,
                                          lengths=lengths)
    q, k, v, do, bias = (x.bfloat16() for x in (q, k, v, do, bias))
    o, lse = fk.flash_attention_fwd(q, k, v, bias, None, causal,
                                    layout=layout, n_head=h)
    return dict(q=q, k=k, v=v, bias=bias, o=o, lse=lse, do=do, dlse=None,
                causal=causal, layout=layout, n_head=h,
                args=(q, k, v, bias, o, lse, do, None, None, causal,
                      layout, h))


def _check_bf16_grad(name, got, want):
    """One bf16 gradient within TOL_BF16_GRAD of the plain one, element by
    element, plus 2^-10 of its largest magnitude; returns the max abs
    error."""
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{name}: non-finite gradient")
    err = (got - want).abs()
    top = float(want.abs().max())
    over = err - (TOL_BF16_GRAD * want.abs() + 2 ** -10 * top)
    worst = float(over.max())
    log(f"  {name}: max_abs_err {float(err.max()):.3e} (max|want| "
        f"{top:.3e}; tol {TOL_BF16_GRAD:g} rel + 2^-10 of max) "
        f"{'ok' if worst <= 0 else 'FAIL'}")
    if worst > 0:
        raise AssertionError(f"{name}: outside the tolerance")
    return float(err.max())


def flash_bf16_cases(dev):
    """3g (module docstring): each shape's forward and backward against
    the bf16 plain versions, then device times beside the bounds at the
    bf16 peak, the plain versions' times (not at T = 8192, where the
    plain backward alone takes ~20 GB) and scaled_dot_product_attention
    on the same bf16 operands.  Returns the rows of the three bf16
    kernels (their times at phase 6i's shape, the mean of causal and not,
    as each Transformer step runs both; the errors the largest of every
    case) and every case."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import flash_attention as fk

    log("phase 3g: the flash kernels' bf16 paths vs their bf16 plain "
        "versions")
    h6, d6 = TRAIN_ARCH["n_head"], TRAIN_ARCH["d_model"] // \
        TRAIN_ARCH["n_head"]
    hb = BERT_ARCH["n_head"]
    shapes = [("6i", TRAIN_BATCH, h6, TRAIN_ARCH["max_length"], d6,
               "nhtd", True),
              ("6i", TRAIN_BATCH, h6, TRAIN_ARCH["max_length"], d6,
               "nhtd", False),
              ("6j BERT", BERT_BATCH, hb, BERT_ARCH["max_len"],
               BERT_ARCH["d_model"] // hb, "nhtd", False),
              ("D=128", 16, 8, 512, 128, "nhtd", True),
              ("T=8192", LONGCTX_BATCH, h6, 8192, d6, "nhtd", True)]
    cases, errs = [], {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    for i, (tag, n, h, t, d, layout, causal) in enumerate(shapes):
        name = (f"flash bf16 {tag} N={n} H={h} T={t} D={d} "
                f"{'causal' if causal else 'not causal'}")
        c = bf16_case(dev, n, h, t, d, layout, causal, seed=80 + i)
        q, k, v, bias = c["args"][:4]
        wo, wl = fk.flash_attention_fwd_plain(q, k, v, bias, None, causal,
                                              layout, h)
        o_err = float((c["o"].float() - wo.float()).abs().max())
        o_top = float(wo.float().abs().max())
        log(f"  {name} out: max_abs_err {o_err:.3e} ({o_err / o_top:.2e} "
            f"of max|O| {o_top:.3e}; tol {TOL_BF16_O:g} of max) "
            f"{'ok' if o_err <= TOL_BF16_O * o_top else 'FAIL'}")
        if not o_err <= TOL_BF16_O * o_top:
            raise AssertionError(f"{name}: O outside the tolerance")
        check_close(f"{name} lse", c["lse"], wl, TOL_KERNEL)
        del wo, wl

        def fwd():
            return fk.flash_attention_fwd(q, k, v, bias, None, causal,
                                          layout=layout, n_head=h)

        def bwd():
            return fk.flash_attention_bwd(*c["args"], need_dbias=False)

        before = dict(kernels.launch_counts)
        got = bwd()
        torch.cuda.synchronize()
        after = kernels.launch_counts
        for kname in ("flash_attention_bwd_dkv_bf16",
                      "flash_attention_bwd_dq_bf16"):
            if after[kname] != before[kname] + 1:
                raise AssertionError(f"{name}: {kname} not launched")
        want = fk.flash_attention_bwd_plain(*c["args"])
        gerr = {g: _check_bf16_grad(f"{name} {g}", a, b)
                for g, a, b in zip(("dq", "dk", "dv"), got, want)}
        del got, want
        errs["fwd"] = max(errs["fwd"], o_err)
        errs["dkv"] = max(errs["dkv"], gerr["dk"], gerr["dv"])
        errs["dq"] = max(errs["dq"], gerr["dq"])
        iters = 3 if t > 1024 else 20
        fwd_ms = profiled_kernel_ms(fwd, _BF16_FWD, iters=iters,
                                    warmup=1)[_BF16_FWD[0]]
        per = profiled_kernel_ms(bwd, _BWD_BF16_KERNELS, iters=iters,
                                 warmup=1)
        lib_fwd = profiled_call_ms(_sdpa_forward(c, d), iters=iters,
                                   warmup=1)
        lib_bwd = profiled_call_ms(_sdpa_backward(c, d), iters=iters,
                                   warmup=1)
        plain_fwd = plain_bwd = None
        if t <= 1024:
            plain_fwd = cuda_ms(lambda: fk.flash_attention_fwd_plain(
                q, k, v, bias, None, causal, layout, h), iters=5, warmup=1)
            plain_bwd = cuda_ms(lambda: fk.flash_attention_bwd_plain(
                *c["args"]), iters=5, warmup=1)
        fb = fk.tensor_core_bound_ms(q, k, bias, causal, layout, h)
        bb = fk.tensor_core_bound_ms_bwd(q, k, bias, causal, layout, h)
        row = dict(shape=name, causal=causal, fwd_ms=fwd_ms,
                   dkv_ms=per["flash_bwd_dkv_bf16_kernel"],
                   dq_ms=per["flash_bwd_dq_bf16_kernel"],
                   fwd_bound_ms=fb[0], fwd_bound_by=fb[1],
                   dkv_bound_ms=bb["dkv"][0], dkv_bound_by=bb["dkv"][1],
                   dq_bound_ms=bb["dq"][0], dq_bound_by=bb["dq"][1],
                   plain_fwd_ms=plain_fwd, plain_bwd_ms=plain_bwd,
                   library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
                   fwd_max_abs_err=o_err, dkv_max_abs_err=max(
                       gerr["dk"], gerr["dv"]), dq_max_abs_err=gerr["dq"])
        cases.append(row)
        log(f"  {name}: fwd device ms {fwd_ms:.5f} (bound at the bf16 "
            f"peak {fb[0]:.5f} {fb[1]}; plain {plain_fwd}; SDPA bf16 "
            f"{lib_fwd:.5f}); dkv {row['dkv_ms']:.5f} dq {row['dq_ms']:.5f}"
            f" (bounds {bb['dkv'][0]:.5f} {bb['dkv'][1]} / "
            f"{bb['dq'][0]:.5f} {bb['dq'][1]}; plain backward {plain_bwd};"
            f" SDPA bf16 backward {lib_bwd:.5f})")
        del c
        torch.cuda.empty_cache()
    main = [r for r in cases if r["shape"].startswith("flash bf16 6i")]

    def mean(key):
        return sum(r[key] for r in main) / len(main)

    rows = {}
    for kname, pre, plain_key, lib_key, err in (
            ("flash_attention_fwd_bf16", "fwd", "plain_fwd_ms",
             "library_fwd_ms", errs["fwd"]),
            ("flash_attention_bwd_dkv_bf16", "dkv", "plain_bwd_ms",
             "library_bwd_ms", errs["dkv"]),
            ("flash_attention_bwd_dq_bf16", "dq", "plain_bwd_ms",
             "library_bwd_ms", errs["dq"])):
        rows[kname] = dict(
            ms=mean(f"{pre}_ms"), plain_ms=mean(plain_key),
            bound_ms=mean(f"{pre}_bound_ms"),
            bound_by=main[0][f"{pre}_bound_by"],
            library_ms=mean(lib_key), max_abs_err=err,
            shape="N=64 H=8 T=256 D=64 bf16 nhtd key bias, mean of causal "
                  "and not (the backward's plain and library times are "
                  "the whole backward)")
    return rows, cases


# -- phase 3c: the vocab-CE kernels against their plain versions ---------

def vocab_case(dev, n, d, v, seed, n_bad=0):
    """h (N, D) and W (D, V) giving logits of order 1, labels from numpy
    with `n_bad` out of range (-3 and V + 5, clamped as fused_vocab_ce
    clamps them) and a cotangent with a quarter of it zero."""
    rng = np.random.RandomState(seed)
    h = torch.as_tensor(rng.randn(n, d).astype(np.float32)).to(dev)
    w = torch.as_tensor((rng.randn(d, v) * 0.05).astype(np.float32)).to(dev)
    raw = rng.randint(0, v, size=n).astype(np.int64)
    raw[:n_bad:2], raw[1:n_bad:2] = -3, v + 5
    g = rng.randn(n).astype(np.float32)
    g[rng.rand(n) < 0.25] = 0.0
    lbl = torch.as_tensor(np.clip(raw, 0, v - 1).astype(np.int32)).to(dev)
    return h, w, torch.as_tensor(raw).to(dev), lbl, \
        torch.as_tensor(g).to(dev)


def phase_vocab_kernels(dev):
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import vocab_ce as vk

    log("phase 3c: vocab-CE kernels vs plain versions on the card")
    for fn, used in ptxas_summary(_build.build_log("vocab_ce")):
        log(f"  ptxas {fn}: {used}")
    n, d, v = TRAIN_BATCH * TRAIN_ARCH["max_length"], \
        TRAIN_ARCH["d_model"], TRAIN_ARCH["trg_vocab_size"]
    cases = [("train eps=0.1", (n, d, v, 0.1, 16)),
             ("ragged N=1000 V=1003 eps=0.1", (1000, d, 1003, 0.1, 4)),
             ("eps=0 N=4096", (4096, d, v, 0.0, 0)),
             ("ragged D=100 N=999 V=1001", (999, 100, 1001, 0.1, 6)),
             ("ragged D=61 N=999 V=1001", (999, 61, 1001, 0.1, 6))]
    errs = {"fwd": [], "dh": [], "dw": []}
    rows = {}
    for i, (name, (cn, cd, cv, eps, bad)) in enumerate(cases):
        h, w, raw, lbl, g = vocab_case(dev, cn, cd, cv, seed=i, n_bad=bad)
        got = vk.vocab_ce_fwd(h, w, lbl)
        torch.cuda.synchronize()
        want = vk.vocab_ce_fwd_plain(h, w, lbl)
        for oname, a, b in zip(("lse", "z_label", "z_sum"), got, want):
            errs["fwd"].append(check_close(f"vocab_ce fwd {name} {oname}",
                                           a, b, TOL_VOCAB))
        dh, dw = vk.vocab_ce_bwd(h, w, lbl, got[0], g, eps)
        torch.cuda.synchronize()
        wdh, wdw = vk.vocab_ce_bwd_plain(h, w, lbl, got[0], g, eps)
        errs["dh"].append(check_close(f"vocab_ce dh {name}", dh, wdh,
                                      TOL_VOCAB))
        errs["dw"].append(check_close(f"vocab_ce dW {name}", dw, wdw,
                                      TOL_VOCAB))
        del wdh, wdw, want
        # labels outside [0, V) select no logit: z_label is NEG there
        n_tok, n_voc = lbl.shape[0], w.shape[1]
        raw_lbl = torch.where(torch.arange(n_tok, device=dev) % 7 == 0,
                              torch.where(lbl % 2 == 0, -1, n_voc + 7),
                              lbl).to(torch.int32)
        got_raw = vk.vocab_ce_fwd(h, w, raw_lbl)
        want_raw = vk.vocab_ce_fwd_plain(h, w, raw_lbl)
        bad = (raw_lbl < 0) | (raw_lbl >= n_voc)
        if not torch.equal(got_raw[1][bad], want_raw[1][bad]):
            raise AssertionError(f"vocab_ce fwd {name}: a label outside "
                                 f"[0, V) selected a logit")
        errs["fwd"].append(check_close(
            f"vocab_ce fwd {name} z_label, labels outside [0, V) beside",
            got_raw[1][~bad], want_raw[1][~bad], TOL_VOCAB))
        del got_raw, want_raw
        if i:
            continue
        # one block owns its rows or columns over the whole sum, no atomics
        again = vk.vocab_ce_bwd(h, w, lbl, got[0], g, eps)
        if not (torch.equal(again[0], dh) and torch.equal(again[1], dw)):
            raise AssertionError("vocab_ce bwd: two runs at the training "
                                 "shape differ")
        again = vk.vocab_ce_fwd(h, w, lbl)
        if not all(torch.equal(a, b) for a, b in zip(again, got)):
            raise AssertionError("vocab_ce fwd: two runs at the training "
                                 "shape differ")
        log("  two forward and two backward runs at the training shape "
            "bit-equal")
        del again
        # the library's label-smoothed CE is the same loss (through the
        # clamp of fused_vocab_ce on the raw labels)
        loss = vk.fused_vocab_ce(h, w, raw, eps)
        ce = torch.nn.functional.cross_entropy(
            torch.matmul(h, w), lbl.long(), label_smoothing=eps,
            reduction="none")
        check_close("fused_vocab_ce loss vs F.cross_entropy", loss, ce,
                    TOL_VOCAB)
        rows = _time_vocab(vk, h, w, lbl, g, eps)
    for k, full in (("fwd", "vocab_ce_fwd"), ("dh", "vocab_ce_dh"),
                    ("dw", "vocab_ce_dw")):
        rows[full]["max_abs_err"] = max(errs[k])
    return rows


def _time_vocab(vk, h, w, lbl, g, eps):
    """Kernel, plain and library times at the training shape."""
    (n, d), v = h.shape, w.shape[1]
    lse = vk.vocab_ce_fwd(h, w, lbl)[0]
    ms = {"fwd": cuda_ms(lambda: vk.vocab_ce_fwd(h, w, lbl), iters=5,
                         warmup=1)}
    ms.update(profiled_kernel_ms(
        lambda: vk.vocab_ce_bwd(h, w, lbl, lse, g, eps),
        ("vocab_ce_dh_kernel", "vocab_ce_dw_kernel"), iters=5, warmup=1))
    plain_fwd = cuda_ms(lambda: vk.vocab_ce_fwd_plain(h, w, lbl), iters=3,
                        warmup=1)
    plain_bwd = cuda_ms(lambda: vk.vocab_ce_bwd_plain(h, w, lbl, lse, g,
                                                      eps),
                        iters=3, warmup=1)
    hh, ww = h.detach().requires_grad_(), w.detach().requires_grad_()

    def lib_fwd():
        return torch.nn.functional.cross_entropy(
            torch.matmul(hh, ww), lbl.long(), label_smoothing=eps,
            reduction="none")

    lib_fwd_ms = cuda_ms(lambda: lib_fwd().detach(), iters=3, warmup=1)
    loss = lib_fwd()

    def lib_bwd():
        return torch.autograd.grad(loss, (hh, ww), g, retain_graph=True)

    lib_bwd_ms = cuda_ms(lib_bwd, iters=3, warmup=1)
    del loss
    bounds = vk.bound_bytes_and_flops(n, d, v)
    tc_bound = vk.tensor_core_bound_ms(n, d, v)
    rows = {}
    for k, full, k_ms, p_ms, l_ms in (
            ("fwd", "vocab_ce_fwd", ms["fwd"], plain_fwd, lib_fwd_ms),
            ("dh", "vocab_ce_dh", ms["vocab_ce_dh_kernel"], plain_bwd,
             lib_bwd_ms),
            ("dw", "vocab_ce_dw", ms["vocab_ce_dw_kernel"], plain_bwd,
             lib_bwd_ms)):
        b_ms, b_by = bound_ms(*bounds[k])
        rows[full] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                          bound_ms=b_ms, bound_by=b_by, f32_bound_ms=b_ms,
                          bytes=bounds[k][0], flops=bounds[k][1],
                          shape=f"N={n} D={d} V={v} f32 eps={eps}")
        extra = ""
        if k in tc_bound:
            # the three run 3xTF32 on the tensor cores: their least time
            # is 3 * 2NDV (forward) or 3 * 4NDV TF32 operations at the
            # TF32 peak
            rows[full]["bound_ms"] = tc_bound[k]
            extra = f" tensor_core_3xtf32_bound_ms {tc_bound[k]:.5f}"
        log(f"  {full}: kernel_ms {k_ms:.5f} f32_bound_ms {b_ms:.5f} "
            f"({b_by}){extra} plain_ms {p_ms:.5f} library_ms {l_ms:.5f}")
    log("  (plain and library backward times are dh and dW together)")
    return rows


# -- phase 3d: the LSTM recurrence kernels against their plain versions ---

def lstm_case(dev, t, n, h, seed, lengths=None):
    """Time-major operands of one recurrence call: xs of the size the
    x-projection gives, W at the initializer's scale, non-zero h0/c0, the
    bench's ragged lengths (uniform in T/2..T) unless given, and
    cotangents for hs and cs."""
    rng = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return torch.as_tensor((rng.randn(*shape) * scale)
                               .astype(np.float32)).to(dev)

    xs, w = f(t, n, 4 * h, scale=0.5), f(h, 4 * h, scale=h ** -0.5)
    h0, c0 = f(n, h, scale=0.3), f(n, h, scale=0.3)
    if lengths is None:
        lengths = rng.randint(t // 2, t + 1, (n,))
    sl = torch.as_tensor(np.asarray(lengths, np.int32)).to(dev)
    return (xs, w, h0, c0, sl), (f(t, n, h), f(t, n, h))


def phase_lstm_kernels(dev):
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import lstm as lk

    log("phase 3d: LSTM recurrence kernels vs plain versions on the card")
    for fn, used in ptxas_summary(_build.build_log("lstm")):
        log(f"  ptxas {fn}: {used}")
    t, n, h = LSTM_ARCH["max_len"], LSTM_BATCH, LSTM_ARCH["hidden_dim"]
    cases = [("train", (t, n, h, None), False),
             ("train reversed", (t, n, h, None), True),
             ("ragged N=5 T=7 H=24", (7, 5, 24, [7, 0, 1, 4, 6]), False),
             ("ragged reversed", (7, 5, 24, [7, 0, 1, 4, 6]), True),
             # several 64-row tiles over the backward's two row groups, the
             # last one ragged
             ("N=300 T=9 H=512", (9, 300, h, None), False),
             ("N=300 T=9 H=512 reversed", (9, 300, h, None), True),
             ("N=1 T=1 H=512", (1, 1, h, None), False),
             ("H=4 N=3 T=6", (6, 3, 4, [6, 0, 3]), False),
             ("all rows frozen", (7, 9, 40, [0] * 9), False),
             ("all rows frozen reversed", (7, 9, 40, [0] * 9), True)]
    errs = {"fwd": [], "bwd": []}
    timed = None
    for i, (name, (ct, cn, ch, lens), rev) in enumerate(cases):
        ops, cots = lstm_case(dev, ct, cn, ch, seed=40 + i, lengths=lens)
        hs, cs = lk.lstm_fwd(*ops, rev)
        torch.cuda.synchronize()
        for oname, a, b in zip(("hs", "cs"), (hs, cs),
                               lk.lstm_fwd_plain(*ops, rev)):
            errs["fwd"].append(check_close(f"lstm fwd {name} {oname}", a, b,
                                           TOL_LSTM))
        if not all(torch.equal(a, b) for a, b in
                   zip(lk.lstm_fwd(*ops, rev), (hs, cs))):
            raise AssertionError(f"lstm fwd {name}: two runs differ")
        got = lk.lstm_bwd(*ops, hs, cs, *cots, rev)
        torch.cuda.synchronize()
        want = lk.lstm_bwd_plain(*ops, hs, cs, *cots, rev)
        for oname, a, b in zip(("dxs", "dW", "dh0", "dc0"), got, want):
            errs["bwd"].append(check_close(f"lstm bwd {name} {oname}", a, b,
                                           TOL_LSTM))
        again = lk.lstm_bwd(*ops, hs, cs, *cots, rev)
        if not all(torch.equal(a, b) for a, b in zip(again, got)):
            raise AssertionError(f"lstm bwd {name}: two runs differ")
        if i == 0:
            timed = (ops, cots, hs, cs)
    log("  two forward and two backward runs bit-equal in every case")
    ops, cots, hs, cs = timed
    ms = {"fwd": cuda_ms(lambda: lk.lstm_fwd(*ops, False), iters=10,
                         warmup=2),
          "bwd": cuda_ms(lambda: lk.lstm_bwd(*ops, hs, cs, *cots, False),
                         iters=10, warmup=2),
          "fwd_plain": cuda_ms(lambda: lk.lstm_fwd_plain(*ops, False),
                               iters=3, warmup=1),
          "bwd_plain": cuda_ms(lambda: lk.lstm_bwd_plain(*ops, hs, cs, *cots,
                                                         False),
                               iters=3, warmup=1)}
    calls = {"fwd": lambda: lk.lstm_fwd(*ops, False),
             "bwd": lambda: lk.lstm_bwd(*ops, hs, cs, *cots, False)}
    dev_ms = {k: profiled_kernel_ms(fn, (f"lstm_{k}_kernel",), iters=10)
              [f"lstm_{k}_kernel"] for k, fn in calls.items()}
    lib = _cudnn_lstm_ms(dev, t, n, h)
    bounds = lk.bound_bytes_and_flops(t, n, h)
    tc_bound = lk.tensor_core_bound_ms(t, n, h)
    rows = {}
    for k, full in (("fwd", "lstm_fwd"), ("bwd", "lstm_bwd")):
        b_ms, b_by = bound_ms(*bounds[k])
        rows[full] = dict(
            ms=ms[k], plain_ms=ms[f"{k}_plain"], library_ms=lib[k],
            bound_ms=b_ms, bound_by=b_by, f32_bound_ms=b_ms,
            bytes=bounds[k][0], flops=bounds[k][1],
            max_abs_err=max(errs[k]),
            shape=f"T={t} N={n} H={h} f32, lengths {t // 2}..{t}, "
                  f"h0/c0 non-zero")
        # both kernels run 3xTF32 on the tensor cores: the least time is
        # 3 TF32 operations a product flop at the TF32 peak
        rows[full]["bound_ms"] = tc_bound[k]
        log(f"  {full}: kernel_ms {ms[k]:.5f} (device {dev_ms[k]:.5f}) "
            f"tensor_core_3xtf32_bound_ms {tc_bound[k]:.5f} f32_bound_ms "
            f"{b_ms:.5f} ({b_by}) plain_ms {ms[f'{k}_plain']:.5f} "
            f"library_ms {lib[k]:.5f}")
        rows[full]["device_ms"] = dev_ms[k]
    rows["lstm_bwd"]["l2"] = _l2_probe(dev, lk, n, h)
    log("  (library: torch.nn.LSTM, cuDNN, one layer over (128, 128, 512) "
        "at full lengths; it also contains the x-projection, so it is set "
        "against fc + kernel)")
    return rows


def _l2_bytes_per_step(n, h):
    """{design: bytes}: what the backward's blocks read and write through
    L2 in one step at N rows and H units (the carries and xs aside).
    The earlier CUDA-core design: H / 4 blocks each read h_{t-1} twice and
    all of dg (N x 4H).  The tensor-core design: 2 row groups x H / 8
    blocks each read their N / 2 rows of h_{t-1} once, write their
    partial dh (N / 2 x H) and read the H / 8 partials of their own 8
    units (N / 2 x 8 each)."""
    el, u = 4, -(-h // 8)
    old = (h // 4) * (2 * n * h + n * 4 * h) * el
    rows = n / 2
    new = 2 * u * (rows * h + rows * h + u * rows * 8) * el
    return {"cuda_cores": old, "tensor_cores": int(new)}


def _l2_probe(dev, lk, n, h):
    """The card's L2 read rate as the backward's blocks see it: 128 blocks
    each read all of one 1 MB buffer (ld.global.cg, eight 16-byte loads
    in flight a thread), and one block alone; beside it the L2 bytes a
    step of the old and new backward designs at N x H."""
    buf = torch.ones(2 ** 18, device=dev)          # 1 MB
    res = {}
    for blocks in (128, 1):
        ms = cuda_ms(lambda: lk.l2_read_probe(buf, blocks), iters=50,
                     warmup=5)
        res[f"{blocks}_blocks"] = dict(
            us=ms * 1e3, gb_per_s=buf.numel() * 4 * blocks / ms / 1e6)
    steps = _l2_bytes_per_step(n, h)
    rate = res["128_blocks"]["gb_per_s"] * 1e9
    res["bytes_per_step"] = steps
    res["us_per_step_at_probe_rate"] = {k: v / rate * 1e6
                                        for k, v in steps.items()}
    log(f"  L2 probe: 128 blocks x 1 MB in {res['128_blocks']['us']:.2f} "
        f"us ({res['128_blocks']['gb_per_s']:.1f} GB/s), one block "
        f"{res['1_blocks']['gb_per_s']:.1f} GB/s; backward L2 bytes a step "
        f"at N={n} H={h}: {steps} = "
        f"{res['us_per_step_at_probe_rate']} us at the probe's rate")
    return res


def _cudnn_lstm_ms(dev, t, n, h):
    """The library yardstick: one torch.nn.LSTM layer (cuDNN), forward
    and its autograd backward, timed here and used nowhere in the port."""
    g = torch.Generator().manual_seed(0)
    lstm = torch.nn.LSTM(h, h).to(dev)
    x = torch.randn(t, n, h, generator=g).to(dev).requires_grad_()
    dout = torch.randn(t, n, h, generator=g).to(dev)
    fwd = cuda_ms(lambda: lstm(x)[0], iters=10, warmup=2)
    out = lstm(x)[0]
    leaves = (x, *lstm.parameters())
    bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, dout,
                                              retain_graph=True),
                  iters=10, warmup=2)
    return {"fwd": fwd, "bwd": bwd}


# -- phase 3e: shapes the kernels refuse, through the composed routes -----

def refused_cases():
    """{name: (op, inputs as numpy, attrs, output slots, tolerance)}: one
    op per kernel at a shape its kernel does not take, at the widths of
    the main paths (8 heads, T = 256, V = 32000, 128-step sequences)."""
    rng = np.random.RandomState(60)

    def f(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    v, n_tok = TRAIN_ARCH["trg_vocab_size"], 1024
    lbl = rng.randint(0, v, n_tok).astype(np.int64)
    lbl[:2] = [v + 3, -v - 2]                 # NaN loss on both routes
    page, pages, slots, d_paged = 16, 64, 8, 96
    lens = rng.randint(1, 8 * page, slots).astype(np.int32)
    pt = rng.permutation(pages)[:slots * 8].reshape(slots, 8) \
        .astype(np.int32)
    h_lstm = 514
    return {
        "flash D=96": ("flash_attention",
                       {"Q": f(2, 8, 256, 96), "K": f(2, 8, 256, 96),
                        "V": f(2, 8, 256, 96)},
                       {"causal": True}, ("Out",), TOL_KERNEL),
        "vocab-CE D=768": ("fused_vocab_softmax_ce",
                           {"Hidden": f(n_tok, 768), "W": f(768, v,
                                                            scale=0.03),
                            "Label": lbl},
                           {"epsilon": 0.1}, ("Loss",), TOL_VOCAB),
        "LSTM H=514": ("dynamic_lstm",
                       {"Input": f(16, 128, 4 * h_lstm, scale=0.5),
                        "Weight": f(h_lstm, 4 * h_lstm,
                                    scale=h_lstm ** -0.5),
                        "Bias": f(1, 4 * h_lstm, scale=0.1),
                        "SeqLen": rng.randint(64, 129, 16).astype(np.int32)},
                       {}, ("Hidden", "Cell"), TOL_LSTM),
        "paged D=96": ("paged_attention",
                       {"Q": f(slots, 8 * d_paged),
                        "KCache": f(pages, page, 8 * d_paged),
                        "VCache": f(pages, page, 8 * d_paged),
                        "PageTable": pt, "Lengths": lens},
                       {"n_head": 8}, ("Out",), TOL_KERNEL),
    }


def run_op(op, ins_np, attrs, device):
    from paddle_tpu_torch.core.registry import OpContext, get_op_impl

    ins = {s: [torch.as_tensor(a).to(device)] for s, a in ins_np.items()}
    return get_op_impl(op)(OpContext((0, 0), 0, device=device), ins,
                           dict(attrs))


def phase_refused_shapes(dev):
    from paddle_tpu_torch.ops import kernels

    log("phase 3e: shapes the kernels refuse, use_pallas=False: composed "
        "routes on the card against the op on the CPU")
    out = {}
    for name, (op, ins, attrs, slots, tol) in refused_cases().items():
        kernels.reset_counts()
        got = run_op(op, ins, dict(attrs, use_pallas=False), dev)
        torch.cuda.synchronize()
        c = kernels.counts()
        if c["composed"][op] != 1 or sum(c["composed"].values()) != 1 \
                or any(c["launches"].values()) or any(c["plain"].values()):
            raise AssertionError(f"{name}: counts {c}, want one composed "
                                 f"{op} call and nothing else")
        want = run_op(op, ins, dict(attrs, use_pallas=False), "cpu")
        errs = []
        for slot in slots:
            a, b = got[slot][0].detach().cpu(), want[slot][0].detach()
            nan = torch.isnan(b)
            if not torch.equal(torch.isnan(a), nan):
                raise AssertionError(f"{name} {slot}: NaN where the CPU "
                                     f"has none, or the reverse")
            errs.append(check_close(f"{name} {slot} (card vs CPU, "
                                    f"{int(nan.sum())} NaN rows equal)",
                                    a[~nan], b[~nan], tol))
        try:
            run_op(op, ins, dict(attrs, use_pallas=True), dev)
        except (ValueError, TypeError, NotImplementedError) as e:
            log(f"  {name} use_pallas=True raises: {e}")
        else:
            raise AssertionError(f"{name}: use_pallas=True did not raise")
        out[name] = {"op": op, "counts": c, "max_abs_err": max(errs)}
    return out


# -- phase 4: the serving stream ------------------------------------------

def phase_stream(dev):
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.models.decoder_lm import DecoderLM
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving.decode import DecodeConfig, DecodeEngine

    log("phase 4: DecodeEngine stream on the card")
    lm = DecoderLM(kv_dtype="bfloat16", prefill_pallas=True, **ARCH)
    cfg = DecodeConfig(kv_dtype="bfloat16", **SERVE)
    t0 = time.perf_counter()
    eng = DecodeEngine(lm, cfg, place=CUDAPlace(0)).start()
    log(f"  start (startup program + warmup): "
        f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, ARCH["vocab_size"], size=int(n))
               for n in rng.randint(8, 129, size=N_REQUESTS)]
    budgets = [int(b) for b in rng.randint(48, 97, size=N_REQUESTS)]
    kernels.reset_counts()
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    outs = [f.result(600) for f in futs]
    wall = time.perf_counter() - t0
    counts = kernels.counts()
    assert eng.drain(60)
    snap = eng.stats.snapshot()
    eng.close()
    bad = [(i, len(o), b) for i, (o, b) in enumerate(zip(outs, budgets))
           if len(o) != b]
    assert not bad, f"requests without their full budget: {bad[:5]}"
    assert snap["executor_failures"] == 0, snap
    assert snap["post_warmup_compiles"] == 0, snap
    la, pl = counts["launches"], counts["plain"]
    # one launch per layer for each step run and each prefill run
    layers = ARCH["n_layer"]
    assert la["paged_attention"] == layers * snap["decode_iterations"], \
        (la, snap["decode_iterations"])
    assert la["flash_attention_fwd"] == layers * snap["prefills"], \
        (la, snap["prefills"])
    assert la["paged_attention"] > 0 and la["flash_attention_fwd"] > 0 \
        and max(pl.values()) == 0 and max(counts["composed"].values()) \
        == 0, counts
    tokens = snap["tokens_generated"]
    res = {"requests": N_REQUESTS, "tokens": tokens,
           "budget_tokens": sum(budgets), "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "ttft_ms": snap["ttft_ms"], "tpot_ms": snap["tpot_ms"],
           "decode_iterations": snap["decode_iterations"],
           "decode_dispatches": snap["decode_dispatches"],
           "prefills": snap["prefills"],
           "preemptions": snap["preemptions"],
           "slot_occupancy": snap["slot_occupancy"],
           "kv_page_utilization": snap["kv_page_utilization"],
           "post_warmup_compiles": snap["post_warmup_compiles"],
           "warmup": snap["warmup"], "launches": la, "plain_calls": pl}
    log(f"  {N_REQUESTS} requests, {tokens} tokens in {wall:.3f} s: "
        f"{tokens / wall:.1f} tokens/s")
    log(f"  TTFT p50 {snap['ttft_ms']['p50_ms']} ms p99 "
        f"{snap['ttft_ms']['p99_ms']} ms; TPOT p50 "
        f"{snap['tpot_ms']['p50_ms']} ms p99 {snap['tpot_ms']['p99_ms']} ms")
    log(f"  decode iterations {snap['decode_iterations']}, prefills "
        f"{snap['prefills']}, preemptions {snap['preemptions']}, "
        f"post_warmup_compiles {snap['post_warmup_compiles']}")
    log(f"  launches {la}, plain calls {pl}")
    return res


# -- phase 4b: where one decode step's time goes -------------------------

def phase_step_profile(dev, steps=20):
    """The step program alone, run as the engine runs it (16 active
    slots at ragged lengths, next tokens read back after every run), on
    this thread: host ms per step without the profiler, then one
    torch.profiler window for the device's busy time and the costliest
    kernels and host ops."""
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.core.executor import interpret_program
    from paddle_tpu_torch.models.decoder_lm import DecoderLM

    log("phase 4b: one decode step, host vs device")
    lm = DecoderLM(kv_dtype="bfloat16", prefill_pallas=True, **ARCH)
    scope = lm.init_params(place=CUDAPlace(0))
    s, page = SERVE["num_slots"], SERVE["page_size"]
    maxp = SERVE["max_len"] // page
    rng = np.random.RandomState(3)
    lens = rng.randint(8, 128 + 96 - steps, size=s).astype(np.int32)
    n_pg = -(-(int(lens.max()) + steps + 1) // page)   # disjoint pages
    pt = np.zeros((s, maxp), np.int32)
    pt[:, :n_pg] = np.arange(s * n_pg).reshape(s, n_pg)
    env = {n: v for n, v in scope.vars.items()
           if isinstance(v, torch.Tensor)}
    env.update(lm.fresh_pools(SERVE["num_pages"], page, dev))
    env["page_table"] = torch.as_tensor(pt).to(dev)
    step = lm.step
    fetch = (step["next_token"], *step["cache_outs"])
    tok = rng.randint(1, ARCH["vocab_size"], size=s).astype(np.int32)

    def run_steps(n):
        nonlocal tok
        for i in range(n):
            pos = lens + i
            feed = torch.as_tensor(np.stack(
                [tok, pos, pos + 1, np.ones_like(pos)])).to(dev)
            out = interpret_program(
                step["main"], dict(env, tokens=feed[0], write_pos=feed[1],
                                   lengths=feed[2], active=feed[3]),
                None, fetch_names=fetch, device=dev)
            tok = out[step["next_token"]].to(torch.int32).cpu().numpy()

    return _host_device_profile(run_steps, steps, "step")


def _host_device_profile(run_n, steps, what):
    """run_n(n) runs n rounds as the engine runs them; host ms a round
    without the profiler, then one torch.profiler window for the device's
    busy time and the costliest kernels and host ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_n(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_n(steps)
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_n(steps)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / steps
    avg = prof.key_averages()

    # device-side events only: the host ops that launched them carry the
    # same time again in their own rows
    kern = sorted((e for e in avg if e.device_type == DeviceType.CUDA),
                  key=_device_us, reverse=True)
    busy_ms = sum(_device_us(e) for e in kern) / 1e3 / steps
    host = sorted((e for e in avg if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    res = {"step_ms": step_ms, "profiled_step_ms": prof_ms,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": 1.0 - busy_ms / prof_ms,
           "kernel_launches_per_step": sum(e.count for e in kern) / steps,
           "top_kernels": [(e.key, e.count // steps,
                            _device_us(e) / steps) for e in kern[:8]],
           "top_host_ops": [(e.key, e.count // steps,
                             e.self_cpu_time_total / steps)
                            for e in host[:8]]}
    log(f"  {what} {step_ms:.3f} ms (profiled {prof_ms:.3f} ms); device "
        f"busy {busy_ms:.4f} ms/{what}, idle share "
        f"{res['device_idle_share']:.3f}; "
        f"{res['kernel_launches_per_step']:.0f} kernels/{what}")
    for name, n, us in res["top_kernels"]:
        log(f"    device {us:9.2f} us/step  x{n:<3d} {name[:70]}")
    for name, n, us in res["top_host_ops"]:
        log(f"    host   {us:9.2f} us/step  x{n:<3d} {name[:70]}")
    return res


# -- phases 4c/4d: speculative decoding -----------------------------------

def repeat_heavy_prompts(n, vocab, lo, hi, seed=0):
    """The reference bench's repeat-heavy stream (paddle_tpu bench.py
    `_repeat_heavy_prompts`, copied): short random motifs tiled to ragged
    prompt lengths."""
    rng = np.random.RandomState(seed)
    prompts = []
    for _ in range(n):
        motif = rng.randint(1, vocab, size=rng.randint(2, 5))
        length = rng.randint(lo, hi + 1)
        prompts.append(np.tile(motif, -(-length // len(motif)))
                       [:length].astype(np.int64))
    return prompts


def _spec_setup():
    """(DecoderLM, DecodeConfig, weights on the card, prompts, budgets) of
    the reference's serving_decode_spec_k4 (bench.py:1236-1290 at the TPU
    widths): phase 4's ARCH/SERVE with bf16 KV, 64 repeat-heavy prompts of
    8-128 tokens, budgets randint(48, 97) from seed 1."""
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.core.executor import RNG_STATE_VAR
    from paddle_tpu_torch.models.decoder_lm import DecoderLM
    from paddle_tpu_torch.serving.decode import DecodeConfig

    lm = DecoderLM(kv_dtype="bfloat16", prefill_pallas=True, **ARCH)
    cfg = DecodeConfig(kv_dtype="bfloat16", **SERVE)
    scope = lm.init_params(place=CUDAPlace(0))
    params = {n: v for n, v in scope.vars.items()
              if isinstance(v, torch.Tensor) and n != RNG_STATE_VAR}
    prompts = repeat_heavy_prompts(N_REQUESTS, ARCH["vocab_size"], 8, 128)
    budgets = [int(b) for b in
               np.random.RandomState(1).randint(48, 97, N_REQUESTS)]
    return lm, cfg, params, prompts, budgets


def _serve(lm, cfg, params, prompts, budgets, **engine_kw):
    """One stream through a fresh DecodeEngine on the card with a
    ReqTracer(sample_rate=0), the kernel counts zeroed just before the
    first submit and read after the last result.  Checks every request
    got its budget, no failure, no kernel build after warmup and no
    plain or composed call.  Returns (tokens, wall s, stats snapshot,
    counts, tracer)."""
    from paddle_tpu_torch import CUDAPlace
    from paddle_tpu_torch.observe import ReqTracer
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving.decode import DecodeEngine

    tracer = ReqTracer(sample_rate=0.0)
    eng = DecodeEngine(lm, cfg, place=CUDAPlace(0), params=params,
                       tracer=tracer, queue_capacity=4 * len(prompts),
                       **engine_kw).start()
    kernels.reset_counts()
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    outs = [f.result(600).tolist() for f in futs]
    wall = time.perf_counter() - t0
    counts = kernels.counts()
    assert eng.drain(60)
    snap = eng.stats.snapshot()
    eng.close()
    bad = [(i, len(o), b) for i, (o, b) in enumerate(zip(outs, budgets))
           if len(o) != b]
    assert not bad, f"requests without their full budget: {bad[:5]}"
    assert snap["executor_failures"] == 0, snap
    assert snap["post_warmup_compiles"] == 0, snap
    assert max(counts["plain"].values()) == 0 \
        and max(counts["composed"].values()) == 0, counts
    return outs, wall, snap, counts, tracer


def _check_parity(spec_outs, seq_outs, label):
    diverged = [i for i, (a, b) in enumerate(zip(spec_outs, seq_outs))
                if a != b]
    if diverged:
        i = diverged[0]
        at = next(j for j, (x, y) in enumerate(zip(spec_outs[i],
                                                   seq_outs[i])) if x != y)
        raise AssertionError(
            f"{label}: {len(diverged)} request(s) diverged from the "
            f"sequential engine; request {i} at token {at}")
    log(f"  token parity with the sequential engine: {len(seq_outs)} "
        f"requests, {sum(map(len, seq_outs))} tokens")


def _spec_summary(snap, wall, seq_wall, tracer):
    spec = snap["speculation"]
    phases = tracer.phase_summary()
    res = {"tokens": snap["tokens_generated"], "wall_s": wall,
           "tokens_per_s": snap["tokens_generated"] / wall,
           "sequential_tokens_per_s": snap["tokens_generated"] / seq_wall,
           "speedup_vs_sequential": seq_wall / wall,
           **{k: spec[k] for k in ("accept_rate", "accept_hist",
                                   "speculation_efficiency",
                                   "verify_dispatches", "drafted_tokens",
                                   "accepted_tokens", "emitted_tokens")},
           "ttft_ms": snap["ttft_ms"], "tpot_ms": snap["tpot_ms"],
           "join_wait_ms_p50": phases["join_wait"]["p50_ms"],
           "dispatch_ms_p50": phases["dispatch"]["p50_ms"],
           "prefills": snap["prefills"], "preemptions": snap["preemptions"],
           "post_warmup_compiles": snap["post_warmup_compiles"]}
    log(f"  speculative {res['tokens_per_s']:.1f} tokens/s, sequential "
        f"{res['sequential_tokens_per_s']:.1f} tokens/s: speedup "
        f"{res['speedup_vs_sequential']:.3f}")
    log(f"  accept_rate {spec['accept_rate']} accept_hist "
        f"{spec['accept_hist']} speculation_efficiency "
        f"{spec['speculation_efficiency']}; {spec['verify_dispatches']} "
        f"verify runs, {snap['prefills']} prefills, "
        f"{snap['preemptions']} preemptions")
    log(f"  TTFT p50 {snap['ttft_ms']['p50_ms']} ms p99 "
        f"{snap['ttft_ms']['p99_ms']} ms; TPOT p50 "
        f"{snap['tpot_ms']['p50_ms']} ms p99 {snap['tpot_ms']['p99_ms']} ms;"
        f" tracer join_wait p50 {res['join_wait_ms_p50']} ms, dispatch "
        f"p50 {res['dispatch_ms_p50']} ms")
    return res


def phase_speculative_stream(dev):
    """Phase 4c: the sequential engine (decode chunk 16), then
    DecodeEngine(speculate_k=4) with the n-gram drafter, on the same
    stream and weights: token parity request for request, every verify
    run one paged launch a layer, every prefill one flash launch a
    layer; then one verify round alone (phase_verify_round)."""
    log(f"phase 4c: speculative decoding (k = {SPEC_K}, NGramDrafter) vs "
        f"the sequential engine, {N_REQUESTS} repeat-heavy requests")
    lm, cfg, params, prompts, budgets = _spec_setup()
    seq_outs, seq_wall, seq_snap, seq_counts, _ = _serve(
        lm, cfg, params, prompts, budgets)
    layers = ARCH["n_layer"]
    assert seq_counts["launches"]["paged_attention"] == \
        layers * seq_snap["decode_iterations"], seq_counts
    outs, wall, snap, counts, tracer = _serve(
        lm, cfg, params, prompts, budgets, speculate_k=SPEC_K)
    _check_parity(outs, seq_outs, "phase 4c")
    spec = snap["speculation"]
    la = counts["launches"]
    assert spec["emitted_tokens"] + snap["prefill_joins"] == \
        snap["tokens_generated"], (spec, snap)
    assert la["paged_attention"] == layers * spec["verify_dispatches"], \
        (la, spec)
    assert la["flash_attention_fwd"] == layers * snap["prefills"], \
        (la, snap["prefills"])
    res = _spec_summary(snap, wall, seq_wall, tracer)
    res["sequential_decode_iterations"] = seq_snap["decode_iterations"]
    res["launches"] = {
        "paged_attention": seq_counts["launches"]["paged_attention"],
        "paged_attention_verify": la["paged_attention"],
        "flash_attention_fwd": la["flash_attention_fwd"]
        + seq_counts["launches"]["flash_attention_fwd"]}
    log(f"  launches: sequential {seq_counts['launches']}, speculative {la}")
    res["verify_round"] = phase_verify_round(dev, lm, params)
    return res


def phase_verify_round(dev, lm, params, rounds=20):
    """One verify round at 16 slots x 5 rows after a prefill of 16
    prompts: first, every op's output in each slot's first row equals,
    bit for bit, the step program's at 16 rows on the same inputs (the
    batch invariance the engine's parity rests on: OpContext.row_block);
    then host ms a round (feeds in, verify run, accepted and tokens read
    back) and one profiled window, as phase 4b."""
    from paddle_tpu_torch.core.executor import interpret_program

    s, page, k1 = SERVE["num_slots"], SERVE["page_size"], SPEC_K + 1
    maxp = SERVE["max_len"] // page
    rng = np.random.RandomState(4)
    lens = rng.randint(8, 129, size=s).astype(np.int32)
    n_pg = -(-(128 + k1 * (2 * rounds + 4)) // page)
    pt = np.zeros((s, maxp), np.int32)
    pt[:, :n_pg] = np.arange(s * n_pg).reshape(s, n_pg)
    pools = lm.fresh_pools(SERVE["num_pages"], page, dev)

    def T(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    def run(built, fetch, pools, row_block=None, **feeds):
        env = dict(params)
        env.update(pools)
        env.update({n: T(a) for n, a in feeds.items()})
        return interpret_program(built["main"], env, None,
                                 fetch_names=(*fetch, *built["cache_outs"]),
                                 device=dev, row_block=row_block)

    tokens = np.zeros((s, 128), np.int32)
    for i in range(s):
        tokens[i, :lens[i]] = rng.randint(1, ARCH["vocab_size"], lens[i])
    pre = lm.prefill(128)
    env = run(pre, (pre["next_token"],), pools, tokens=tokens, seq_len=lens,
              last_idx=(lens - 1)[:, None], page_table=pt)
    pools = {n: env[o] for n, o in zip(lm.cache_feed_names(),
                                       pre["cache_outs"])}
    cur = env[pre["next_token"]].to(torch.int32).cpu().numpy()
    ver = lm.verify(SPEC_K)
    drafts = rng.randint(1, ARCH["vocab_size"], (s, SPEC_K)).astype(np.int32)

    def verify_feeds(pos):
        folded = np.zeros((4, s * k1), np.int32)
        ar = np.arange(k1)
        for i in range(s):
            b = i * k1
            folded[0, b] = cur[i]
            folded[0, b + 1:b + k1] = drafts[i]
            folded[1, b:b + k1] = pos[i] + ar
            folded[2, b:b + k1] = pos[i] + ar + 1
            folded[3, b:b + k1] = 1
        return dict(tokens=folded[0], write_pos=folded[1],
                    lengths=folded[2], active=folded[3], drafts=drafts,
                    draft_len=np.full(s, SPEC_K, np.int32),
                    slot_active=np.ones(s, np.int32),
                    page_table=np.repeat(pt, k1, axis=0))

    step = lm.step
    a = run(step, (step["next_token"],),
            {n: v.clone() for n, v in pools.items()}, tokens=cur,
            write_pos=lens, lengths=lens + 1, active=np.ones(s, np.int32),
            page_table=pt)

    def row_diffs(row_block):
        """[(op, var, max abs diff)] of the step program's row outputs
        where a verify run's slot rows differ from the step run's."""
        b = run(ver, (ver["accepted"],),
                {n: v.clone() for n, v in pools.items()},
                row_block=row_block, **verify_feeds(lens))
        diffs, compared = [], 0
        for op in step["main"].global_block().ops:
            for names in op.desc.outputs.values():
                for n in names:
                    x, y = a.get(n), b.get(n)
                    if not (isinstance(x, torch.Tensor) and x.dim() > 0
                            and x.shape[0] == s and y.shape[0] == s * k1):
                        continue
                    compared += 1
                    if not torch.equal(x, y[::k1]):
                        diffs.append((op.type, n, float(
                            (x.float() - y[::k1].float()).abs().max())))
        return diffs, compared

    # without batch invariance, for the record: which ops' rows depend on
    # the row count on this card (ROADMAP C8)
    loose, compared = row_diffs(None)
    log(f"  without row_block: {len(loose)} of {compared} row outputs "
        f"differ from the step's; first {loose[:1]}; ops "
        f"{sorted({d[0] for d in loose})}")
    g = torch.Generator().manual_seed(6)
    x = torch.randn(s * k1, ARCH["d_model"], generator=g).to(dev)
    for n_out in (ARCH["d_model"], ARCH["d_inner"], ARCH["vocab_size"]):
        w = torch.randn(ARCH["d_model"], n_out, generator=g).to(dev)
        d = float(((x @ w)[::k1] - x[::k1].contiguous() @ w).abs().max())
        log(f"  torch.matmul rows at {s * k1} rows vs {s} rows, N = "
            f"{n_out}: max abs diff {d:.3e}")
    diffs, compared = row_diffs(s)
    if diffs:
        raise AssertionError(f"verify rows differ from the step rows: "
                             f"{diffs[:3]}")
    log(f"  verify rows = step rows bit for bit at all {compared} row "
        f"outputs of the step program")

    pos = lens.copy()

    def run_rounds(n):
        nonlocal pos, pools
        for _ in range(n):
            env = run(ver, (ver["accepted"], ver["tokens"]), pools,
                      row_block=s, **verify_feeds(pos))
            pools = {n_: env[o] for n_, o in zip(lm.cache_feed_names(),
                                                 ver["cache_outs"])}
            both = torch.cat([env[ver["accepted"]][:, None],
                              env[ver["tokens"]]], dim=1).cpu()
            pos = pos + 1 + both[:, 0].numpy().clip(0, SPEC_K)

    res = _host_device_profile(run_rounds, rounds, "verify round")
    res["row_outputs_bit_equal"] = compared
    res["row_outputs_differing_without_row_block"] = loose
    return res


def phase_oracle_stream(dev):
    """Phase 4d: 8 requests through the sequential engine and through
    DecodeEngine(speculate_k=4) with a ModelDrafter of the target's own
    ARCH and weights: token parity, and per verify round one paged launch
    a layer for the verify run plus k for the drafter's steps; per
    prefill one flash launch a layer for the engine and one a layer but
    the last for the drafter's mirror.  The accept histogram is the reference's
    (ROADMAP C7): logged, not held to all-accept."""
    from paddle_tpu_torch.models.decoder_lm import DecoderLM
    from paddle_tpu_torch.serving.speculate import ModelDrafter

    log(f"phase 4d: oracle ModelDrafter (the target's ARCH and weights), "
        f"{N_ORACLE} requests")
    lm, cfg, params, prompts, budgets = _spec_setup()
    prompts, budgets = prompts[:N_ORACLE], budgets[:N_ORACLE]
    seq_outs, seq_wall, _, seq_counts, _ = _serve(lm, cfg, params, prompts,
                                                  budgets)
    drafter = ModelDrafter(DecoderLM(kv_dtype="bfloat16",
                                     prefill_pallas=True, **ARCH),
                           k=SPEC_K, params=params)
    outs, wall, snap, counts, tracer = _serve(
        lm, cfg, params, prompts, budgets, speculate_k=SPEC_K,
        drafter=drafter)
    _check_parity(outs, seq_outs, "phase 4d")
    spec = snap["speculation"]
    la, layers = counts["launches"], ARCH["n_layer"]
    verify = layers * spec["verify_dispatches"]
    assert la["paged_attention"] == verify * (1 + SPEC_K), (la, spec)
    # the drafter's mirror fetches only the pools, so its last layer's
    # attention output, which feeds no pool, is pruned from its prefill
    assert la["flash_attention_fwd"] == \
        (2 * layers - 1) * snap["prefills"], (la, snap["prefills"])
    res = _spec_summary(snap, wall, seq_wall, tracer)
    res["launches"] = {
        "paged_attention": seq_counts["launches"]["paged_attention"]
        + la["paged_attention"] - verify,
        "paged_attention_verify": verify,
        "flash_attention_fwd": la["flash_attention_fwd"]
        + seq_counts["launches"]["flash_attention_fwd"]}
    return res


# -- phase 5: the card against the CPU ------------------------------------

def phase_card_vs_cpu(dev):
    from paddle_tpu_torch import CPUPlace, CUDAPlace
    from paddle_tpu_torch.convert import params_from_arrays
    from paddle_tpu_torch.core.executor import interpret_program
    from paddle_tpu_torch.models.decoder_lm import DecoderLM
    from paddle_tpu_torch.serving.decode import DecodeConfig, DecodeEngine

    log("phase 5: float32-KV stream, card vs CPU, same weights")
    lm = DecoderLM(kv_dtype="float32", prefill_pallas=True, **ARCH)
    scope = lm.init_params(place=CUDAPlace(0))
    arrays = {n: v.cpu().numpy() for n, v in scope.vars.items()
              if isinstance(v, torch.Tensor)}
    s, page = SERVE["num_slots"], SERVE["page_size"]
    maxp = SERVE["max_len"] // page
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, ARCH["vocab_size"], size=n)
               for n in (9, 31, 64, 100)]
    # one prefill (bucket 128) of the four prompts, then one step
    bucket = 128
    n_pg = bucket // page + 1
    tokens = np.zeros((s, bucket), np.int32)
    seq_len = np.zeros((s,), np.int32)
    pt = np.zeros((s, maxp), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
        seq_len[i] = len(p)
        pt[i, :n_pg] = i * maxp + np.arange(n_pg)
    envs = {}
    for device in ("cpu", dev):
        env = params_from_arrays(arrays, device, program=lm.step["main"])
        env.update(lm.fresh_pools(s * maxp, page, device))
        feeds = dict(tokens=tokens, seq_len=seq_len, page_table=pt,
                     last_idx=np.maximum(seq_len - 1, 0)[:, None])
        env.update({n: torch.as_tensor(a).to(device)
                    for n, a in feeds.items()})
        envs[device] = env

    def run(device, built, **feeds):
        """One program run on `device`; the pools carry over."""
        env = envs[device]
        env.update({n: torch.as_tensor(a).to(device)
                    for n, a in feeds.items()})
        env = interpret_program(
            built["main"], env, None,
            fetch_names=(built["logits"], *built["cache_outs"]),
            device=torch.device(device))
        for n, o in zip(lm.cache_feed_names(), built["cache_outs"]):
            env[n] = env[o]
        envs[device] = env
        return env[built["logits"]][:len(prompts)].float().cpu()

    logits = {d: [run(d, lm.prefill(bucket))] for d in ("cpu", dev)}
    # both devices decode the same next token: the CPU's first token
    nxt = np.zeros((s,), np.int32)
    nxt[:len(prompts)] = logits["cpu"][0].argmax(-1).numpy()
    for d in ("cpu", dev):
        logits[d].append(run(d, lm.step, tokens=nxt, write_pos=seq_len,
                             lengths=seq_len + 1,
                             active=(seq_len > 0).astype(np.int32)))
    errs = [check_close(f"{name} logits (card vs CPU)", c, h, TOL_LOGITS)
            for name, c, h in zip(("prefill", "decode step"),
                                  logits[dev], logits["cpu"])]
    # the same four requests through both engines, from the same weights
    cfg = DecodeConfig(kv_dtype="float32", **SERVE)
    streams = []
    for place, device in ((CUDAPlace(0), dev), (CPUPlace(), "cpu")):
        eng = DecodeEngine(lm, cfg, place=place,
                           params=params_from_arrays(arrays, device))
        eng.start()
        futs = [eng.submit(p, max_new_tokens=48) for p in prompts]
        streams.append([f.result(600).tolist() for f in futs])
        eng.close()
    same = sum(a == b for x, y in zip(*streams) for a, b in zip(x, y))
    total = sum(len(x) for x in streams[0])
    log(f"  engine tokens equal card vs CPU: {same}/{total}")
    return {"prefill_logits_max_abs_err": errs[0],
            "step_logits_max_abs_err": errs[1],
            "stream_tokens_equal": same, "stream_tokens": total}


# -- phase 6: training the Transformer at full width ----------------------

def build_training(**overrides):
    """(main, startup, model) of the bench Transformer, float32."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = transformer.build_model(**dict(TRAIN_ARCH, **overrides))
    return main, startup, model


def _flash_ops(program):
    return sum(op.type == "flash_attention"
               for op in program.global_block().ops)


def _vocab_ops(program):
    return sum(op.type == "fused_vocab_softmax_ce"
               for op in program.global_block().ops)


def phase_train(dev, card, label="phase 6", overrides=None,
                batch=TRAIN_BATCH, steps=TRAIN_STEPS, profile="phase 6b"):
    """Train the bench Transformer (with `overrides`) on the card
    (`_train_on_card`); `profile` labels one profiled window after the
    timed steps (None: no window)."""
    from paddle_tpu_torch.models import transformer

    overrides = overrides or {}
    arch = dict(TRAIN_ARCH, **overrides)
    log(f"{label}: Transformer training on the card (batch {batch} x "
        f"{arch['max_length']}, {overrides or 'bench config'}, "
        f"{'bf16 AMP' if arch.get('use_amp') else 'f32'})")
    torch.cuda.reset_peak_memory_stats(dev)
    main, startup, model = build_training(**overrides)
    t_len = arch["max_length"]
    vocab = arch["trg_vocab_size"]
    feed = transformer.make_fake_batch(batch, t_len, arch["src_vocab_size"],
                                       vocab)
    # label-smoothed CE of near-uniform logits at random init
    res = _train_on_card(dev, card, main, startup, model["loss"], feed,
                         batch * t_len, steps, np.log(vocab), profile)
    res.update(batch=batch, max_length=t_len, overrides=overrides)
    return res


def _train_on_card(dev, card, main, startup, loss, feed, tokens_per_step,
                   steps, want_first, profile):
    """Run `startup` and one warmup step on the card (its loss within 0.5
    of `want_first`), then `steps` timed steps with the launch counts
    zeroed just before them: each flash op launches the flash forward,
    dK/dV and dQ kernels once a step (their bf16 paths under AMP, and
    then no float32 flash launch), each fused-CE op the vocab-CE
    forward, dh and dW kernels once, and nothing takes a plain or
    composed path.  `profile` labels one profiled window after them
    (None: no window)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import kernels

    n_flash, n_vocab = _flash_ops(main), _vocab_ops(main)
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    feed = {n: torch.as_tensor(a).to(dev) for n, a in feed.items()}
    first = float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0][0])
    torch.cuda.synchronize()
    log(f"  startup + warmup step {time.perf_counter() - t0:.3f} s, "
        f"loss {first:.6f} (expected near {want_first:.6f}); "
        f"{n_flash} flash_attention ops, {n_vocab} fused CE ops")
    if not abs(first - want_first) < 0.5:
        raise AssertionError(f"step-1 loss {first} is not near "
                             f"{want_first}")
    kernels.reset_counts()
    t0 = time.perf_counter()
    losses = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                      return_numpy=False)[0] for _ in range(steps)]
    losses = [float(x.reshape(())) for x in losses]   # syncs
    wall = time.perf_counter() - t0
    counts = kernels.counts()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    la, pl, co = counts["launches"], counts["plain"], counts["composed"]
    # under AMP the flash op gets bf16 operands: the kernels' bf16 paths
    want = _want_launches(main, steps)
    if la != want or max(pl.values()) or max(co.values()):
        raise AssertionError(f"training launches {counts}, want {want} "
                             f"and no plain or composed call")
    leaked = [n for n, v in scope.vars.items()
              if isinstance(v, torch.Tensor)
              and (v.requires_grad or v.grad_fn is not None)]
    if leaked:
        raise AssertionError(f"scope holds autograd state: {leaked[:4]}")
    tokens = tokens_per_step * steps
    res = {"steps": steps, "flash_ops": n_flash,
           "vocab_ce_ops": n_vocab, "wall_s": wall,
           "steps_per_s": steps / wall, "tokens_per_s": tokens / wall,
           "step_ms": wall * 1e3 / steps, "first_loss": first,
           "losses": losses, "launches": la, "plain_calls": pl,
           "composed_calls": co,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    log(f"  {steps} steps in {wall:.3f} s: "
        f"{res['steps_per_s']:.4f} steps/s, {res['tokens_per_s']:.1f} "
        f"tokens/s ({res['step_ms']:.2f} ms/step) on {card}; losses "
        f"{losses[0]:.6f} .. {losses[-1]:.6f}; peak device memory "
        f"{res['peak_mem_bytes'] / 1e9:.3f} GB")
    log(f"  launches {la}, plain calls {pl}, composed {co}")
    if profile:
        res["profile"] = _profile_train_step(exe, main, feed, loss, scope,
                                             label=profile)
    return res


def _profile_train_step(exe, main, feed, loss, scope, steps=2,
                        label="phase 6b"):
    """6b: host ms against device-busy ms of training steps, and the
    costliest device kernels (torch.profiler, as phase 4b)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / steps
    avg = prof.key_averages()

    kern = sorted((e for e in avg if e.device_type == DeviceType.CUDA),
                  key=_device_us, reverse=True)
    busy_ms = sum(_device_us(e) for e in kern) / 1e3 / steps
    res = {"profiled_step_ms": prof_ms, "device_busy_ms_per_step": busy_ms,
           "device_idle_share": 1.0 - busy_ms / prof_ms,
           "kernel_launches_per_step": sum(e.count for e in kern) / steps,
           "top_kernels": [(e.key, e.count // steps, _device_us(e) / steps)
                           for e in kern[:16]]}
    log(f"{label}: profiled step {prof_ms:.3f} ms; device busy "
        f"{busy_ms:.3f} ms/step, idle share "
        f"{res['device_idle_share']:.3f}; "
        f"{res['kernel_launches_per_step']:.0f} kernels/step")
    for name, n, us in res["top_kernels"]:
        log(f"    device {us:11.2f} us/step  x{n:<4d} {name[:70]}")
    return res


# -- phase 6f: training BERT-base -----------------------------------------

def build_bert(**overrides):
    """(main, startup, model) of the bench's BERT-base, float32."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import bert

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = bert.build_model(**dict(BERT_ARCH, **overrides))
    return main, startup, model


def phase_train_bert(dev, card, batch=BERT_BATCH, steps=BERT_STEPS,
                     label="phase 6f", overrides=None):
    """Train BERT-base at the bench's widths and batch on the card
    (`_train_on_card`: 12 launches of each flash kernel a step, no plain
    or composed call), its startup program (truncated normal draws)
    run there too, and one profiled window (as 6b); `overrides`
    (use_amp) go to build_model."""
    from paddle_tpu_torch.models import bert

    overrides = overrides or {}
    t_len, vocab = BERT_ARCH["max_len"], BERT_ARCH["vocab_size"]
    log(f"{label}: BERT-base pretraining (MLM + NSP) on the card (batch "
        f"{batch} x {t_len}, {BERT_ARCH['n_layer']} layers, "
        f"{BERT_ARCH['n_head']} heads, d_model {BERT_ARCH['d_model']}, "
        f"vocab {vocab}, flash attention, "
        f"{'bf16 AMP' if overrides.get('use_amp') else 'f32'})")
    torch.cuda.reset_peak_memory_stats(dev)
    main, startup, model = build_bert(**overrides)
    feed = bert.make_fake_batch(batch, t_len, vocab,
                                BERT_ARCH["max_predictions"])
    # MLM CE of near-uniform logits plus NSP CE of two near-equal ones
    res = _train_on_card(dev, card, main, startup, model["loss"], feed,
                         batch * t_len, steps, np.log(vocab) + np.log(2),
                         f"{label}, profiled")
    res.update(batch=batch, max_length=t_len, overrides=overrides)
    per_step = {k: v / steps for k, v in res["launches"].items()}
    log(f"  kernel launches a step {per_step}")
    if res["flash_ops"] != BERT_ARCH["n_layer"]:
        raise AssertionError(f"{res['flash_ops']} flash ops, want one a "
                             f"layer")
    return res


# -- phase 6e: training the stacked dynamic LSTM, nothing cut -------------

def build_lstm(**overrides):
    """(main, startup, model) of the bench's stacked dynamic LSTM."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import stacked_dynamic_lstm

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = stacked_dynamic_lstm.build_model(
            **dict(LSTM_ARCH, **overrides))
    return main, startup, model


def phase_train_lstm(dev, card, batch=LSTM_BATCH, steps=LSTM_STEPS):
    """Train the stacked LSTM at the bench's size on the card: one warmup
    step, then `steps` timed steps with the launch counts zeroed just
    before them; each dynamic_lstm op launches the forward and the
    backward kernel once a step and nothing takes a plain or composed
    path.  One profiled window follows."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import stacked_dynamic_lstm
    from paddle_tpu_torch.ops import kernels

    t_len = LSTM_ARCH["max_len"]
    log(f"phase 6e: stacked dynamic LSTM training on the card (batch "
        f"{batch} x {t_len}, hidden {LSTM_ARCH['hidden_dim']}, "
        f"{LSTM_ARCH['stacked_num']} layers, f32, the bench config)")
    torch.cuda.reset_peak_memory_stats(dev)
    main, startup, model = build_lstm()
    n_lstm = sum(op.type == "dynamic_lstm"
                 for op in main.global_block().ops)
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    feed = stacked_dynamic_lstm.make_fake_batch(batch, t_len,
                                                LSTM_ARCH["vocab_size"])
    lens = feed["words.seq_len"]
    feed = {n: torch.as_tensor(a).to(dev) for n, a in feed.items()}
    fetch = [model["loss"], model["accuracy"]]
    first, first_acc = (float(x[0]) for x in exe.run(
        main, feed=feed, fetch_list=fetch, scope=scope))
    torch.cuda.synchronize()
    log(f"  startup + warmup step {time.perf_counter() - t0:.3f} s, loss "
        f"{first:.6f} (ln 2 = {np.log(2):.6f}), accuracy {first_acc:.4f}; "
        f"{n_lstm} dynamic_lstm ops; lengths {lens.min()}..{lens.max()}")
    if not abs(first - np.log(2)) < 0.1:
        raise AssertionError(f"step-1 loss {first} is not near ln 2")
    kernels.reset_counts()
    t0 = time.perf_counter()
    outs = [exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                    return_numpy=False) for _ in range(steps)]
    losses = [float(o[0].reshape(())) for o in outs]      # syncs
    wall = time.perf_counter() - t0
    accs = [float(o[1].reshape(())) for o in outs]
    counts = kernels.counts()
    if not all(np.isfinite(losses)) or not losses[-1] < first:
        raise AssertionError(f"losses {first} then {losses}: not finite "
                             f"or not lower after {steps} steps")
    la, pl, co = counts["launches"], counts["plain"], counts["composed"]
    want = dict.fromkeys(la, 0)
    want.update(lstm_fwd=n_lstm * steps, lstm_bwd=n_lstm * steps)
    if n_lstm != 3 or la != want or max(pl.values()) or max(co.values()):
        raise AssertionError(f"training launches {counts}, want {want} "
                             f"and no plain or composed call")
    leaked = [n for n, v in scope.vars.items()
              if isinstance(v, torch.Tensor)
              and (v.requires_grad or v.grad_fn is not None)]
    if leaked:
        raise AssertionError(f"scope holds autograd state: {leaked[:4]}")
    res = {"steps": steps, "batch": batch, "max_len": t_len,
           "lstm_ops": n_lstm, "wall_s": wall, "step_ms": wall * 1e3 / steps,
           "tokens_per_s": batch * t_len * steps / wall,
           "examples_per_s": batch * steps / wall, "first_loss": first,
           "first_accuracy": first_acc, "losses": losses,
           "accuracies": accs, "launches": la, "plain_calls": pl,
           "composed_calls": co,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    log(f"  {steps} steps in {wall:.3f} s: {res['step_ms']:.2f} ms/step, "
        f"{res['tokens_per_s']:.1f} tokens/s, "
        f"{res['examples_per_s']:.1f} examples/s on {card}; losses "
        f"{losses[0]:.6f} .. {losses[-1]:.6f}, accuracy {accs[0]:.4f} .. "
        f"{accs[-1]:.4f}; peak device memory "
        f"{res['peak_mem_bytes'] / 1e9:.3f} GB")
    log(f"  launches {la}, plain calls {pl}, composed {co}")
    res["profile"] = _profile_train_step(exe, main, feed, model["loss"],
                                         scope, label="phase 6e, profiled")
    return res


# -- phases 6g and 6h: ResNet-50 and DeepFM training -----------------------

def build_resnet(**overrides):
    """(main, startup, model) of the bench's ResNet-50, float32."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = resnet.build_model(**dict(RESNET_ARCH, **overrides))
    return main, startup, model


def build_deepfm():
    """(main, startup, model) of the bench's DeepFM (build_model's
    defaults)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import deepfm

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = deepfm.build_model()
    return main, startup, model


def resnet_batch(batch, seed=0):
    """A frozen image batch: N(0, 1) pixels, labels in [0, 1000)."""
    rng = np.random.RandomState(seed)
    return {"data": rng.randn(batch, 3, 224, 224).astype(np.float32),
            "label": rng.randint(0, RESNET_ARCH["class_dim"],
                                 (batch, 1)).astype(np.int64)}


def _timed_steps(dev, card, label, main, startup, loss, feed, steps,
                 examples, unit):
    """Startup and one warmup step on the card, then `steps` timed steps
    with the kernel counts zeroed just before them (no kernel of the
    port lies on these paths: every count must stay 0) and one profiled
    window; every loss finite."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import kernels

    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    feed = {n: torch.as_tensor(a).to(dev) for n, a in feed.items()}
    first = float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0][0])
    torch.cuda.synchronize()
    log(f"  startup + warmup step {time.perf_counter() - t0:.3f} s, loss "
        f"{first:.6f}")
    kernels.reset_counts()
    t0 = time.perf_counter()
    losses = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                      return_numpy=False)[0] for _ in range(steps)]
    losses = [float(x.reshape(())) for x in losses]   # syncs
    wall = time.perf_counter() - t0
    counts = kernels.counts()
    if not np.isfinite([first] + losses).all():
        raise AssertionError(f"non-finite losses {first}, {losses}")
    if any(max(c.values()) for c in counts.values()):
        raise AssertionError(f"{label}: kernel counts {counts}, want 0")
    res = {"steps": steps, "wall_s": wall, "step_ms": wall * 1e3 / steps,
           f"{unit}_per_s": examples * steps / wall, "first_loss": first,
           "losses": losses, "counts": counts,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    log(f"  {steps} steps in {wall:.3f} s: {res['step_ms']:.2f} ms/step, "
        f"{res[unit + '_per_s']:.1f} {unit}/s on {card}; losses "
        f"{losses[0]:.6f} .. {losses[-1]:.6f}; peak device memory "
        f"{res['peak_mem_bytes'] / 1e9:.3f} GB; kernel counts all 0")
    res["profile"] = _profile_train_step(exe, main, feed, loss, scope,
                                         label=f"{label}, profiled")
    return res, exe, scope, feed


def phase_train_resnet(dev, card, batch=RESNET_BATCH, steps=RESNET_STEPS,
                       label="phase 6g", overrides=None):
    """6g: ResNet-50 at the bench's config on the card (conv2d, pool2d
    and batch_norm on cuDNN and torch, momentum); 6k with `overrides`
    (use_amp)."""
    overrides = overrides or {}
    log(f"{label}: ResNet-50 training on the card (batch {batch} x 3 x "
        f"224 x 224, NCHW, momentum 0.9, lr {RESNET_ARCH['learning_rate']},"
        f" {'bf16 AMP' if overrides.get('use_amp') else 'f32'}, frozen "
        f"batch)")
    torch.cuda.reset_peak_memory_stats(dev)
    main, startup, model = build_resnet(**overrides)
    types = [op.type for op in main.global_block().ops]
    res, _, scope, _ = _timed_steps(dev, card, label, main, startup,
                                    model["loss"], resnet_batch(batch),
                                    steps, batch, "images")
    n_bn = types.count("batch_norm")
    moved = [n for n in scope.vars if n.endswith(".mean")
             and float(scope.find_var(n).abs().max()) > 0]
    if (types.count("conv2d"), n_bn, types.count("momentum")) != \
            (53, 53, 161) or len(moved) != n_bn:
        raise AssertionError(f"{types.count('conv2d')} conv2d, {n_bn} "
                             f"batch_norm, {types.count('momentum')} "
                             f"momentum ops, {len(moved)} moving means "
                             f"updated")
    res.update(batch=batch, conv2d_ops=53, batch_norm_ops=n_bn,
               overrides=overrides)
    return res


def phase_train_deepfm(dev, card, batch=DEEPFM_BATCH, steps=DEEPFM_STEPS):
    """6h: DeepFM at the bench's config on the card.  Both is_sparse
    tables take the SparseGrad path (checked on one step's gradients),
    and after the timed steps every row no batch touched keeps its bits
    in both tables and in their Adam moments."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.executor import interpret_program
    from paddle_tpu_torch.core.selected_rows import SparseGrad
    from paddle_tpu_torch.models import deepfm

    log(f"phase 6h: DeepFM training on the card (batch {batch}, 26 fields,"
        f" vocab 1000001 x 16, DNN 400 x 3, Adam, f32)")
    torch.cuda.reset_peak_memory_stats(dev)
    main, startup, model = build_deepfm()
    batch_np = deepfm.make_fake_batch(batch)
    res, exe, scope, feed = _timed_steps(dev, card, "phase 6h", main,
                                         startup, model["loss"], batch_np,
                                         steps, batch, "examples")
    tables = ("fm_w1", "fm_emb")
    state = {n: v for n, v in scope.vars.items()
             if n.startswith(tables) and isinstance(v, torch.Tensor)
             and v.shape[0] == 1000001}
    if len(state) != 6:
        raise AssertionError(f"table state {sorted(state)}")
    env = {n: v for n, v in scope.vars.items()
           if isinstance(v, torch.Tensor)}
    env.update(feed)
    env = interpret_program(main, env, (main.random_seed, 0),
                            fetch_names=[model["loss"].name], device=dev)
    for t in tables:
        g = env[f"{t}@GRAD"]
        if not isinstance(g, SparseGrad) or g.rows.shape[0] != batch * 26:
            raise AssertionError(f"{t}@GRAD is {g!r}, not a SparseGrad of "
                                 f"{batch * 26} rows")
    # the starting values: a fresh scope's startup run draws the same
    init = pt.Scope()
    exe.run(startup, scope=init)
    touched = torch.zeros(1000001, dtype=torch.bool, device=dev)
    touched[torch.as_tensor(batch_np["sparse_ids"]).reshape(-1).to(dev)] = \
        True
    kept = {}
    for n, v in state.items():
        start = init.find_var(n)
        kept[n] = bool(torch.equal(v[~touched], start[~touched]))
        moved = not torch.equal(v[touched], start[touched])
        if not (kept[n] and moved):
            raise AssertionError(f"{n}: untouched rows kept their bits "
                                 f"{kept[n]}, touched rows moved {moved}")
    n_touched = int(touched.sum())
    log(f"  sparse path: fm_w1@GRAD and fm_emb@GRAD are SparseGrads of "
        f"{batch * 26} rows; {n_touched} rows touched, the other "
        f"{1000001 - n_touched} kept their bits in both tables and their "
        f"moments")
    res.update(batch=batch, touched_rows=n_touched, untouched_kept=kept)
    return res


# -- phase 7: training, the card against the CPU --------------------------

def phase_train_parity(dev, **overrides):
    """7: the phase-6 Transformer with `overrides` (use_fused_ce, or
    fused_qkv: q, k and v slices of one projection reach the flash
    kernels) on a batch the CPU takes."""
    from paddle_tpu_torch.models import transformer

    log(f"phase 7: training card vs CPU ({PARITY_BATCH} x {PARITY_T} "
        f"tokens, dropout 0, {PARITY_STEPS} Adam steps, "
        f"{overrides or 'unfused'})")
    main, startup, model = build_training(dropout=0.0,
                                          max_length=PARITY_T, **overrides)
    feed = transformer.make_fake_batch(PARITY_BATCH, PARITY_T,
                                       TRAIN_ARCH["src_vocab_size"],
                                       TRAIN_ARCH["trg_vocab_size"], seed=3)
    feed["src_len"] = np.array([PARITY_T, 41], np.int32)   # ragged, >= 1
    feed["trg_len"] = np.array([17, PARITY_T], np.int32)
    lr_sum = sum(_noam_lr(t) for t in range(1, PARITY_STEPS + 1))
    return _card_vs_cpu_training(dev, main, startup, [model["loss"].name],
                                 feed, lr_sum)


def phase_bert_parity(dev):
    """7d: BERT-base at full width on a batch the CPU takes (2 x 128,
    ragged lengths, dropout 0): the total, MLM and NSP losses."""
    from paddle_tpu_torch.models import bert

    t_len = BERT_ARCH["max_len"]
    log(f"phase 7d: BERT-base training card vs CPU ({BERT_PARITY_BATCH} x "
        f"{t_len} tokens, dropout 0, {PARITY_STEPS} Adam steps)")
    main, startup, model = build_bert(dropout=0.0)
    feed = bert.make_fake_batch(BERT_PARITY_BATCH, t_len,
                                BERT_ARCH["vocab_size"],
                                BERT_ARCH["max_predictions"], seed=3)
    feed["seq_len"] = np.array([t_len, 37], np.int32)
    lr_sum = sum(_bert_lr(t) for t in range(1, PARITY_STEPS + 1))
    return _card_vs_cpu_training(
        dev, main, startup,
        [model[k].name for k in ("loss", "mlm_loss", "nsp_loss")], feed,
        lr_sum)


def phase_amp_parity(dev):
    """7f: the AMP Transformer (2 x 64 tokens, ragged) and AMP BERT-base
    (2 x 128, ragged) at full width, dropout 0: one step on the card
    (bf16 flash kernels, bf16 cuBLAS GEMMs) and on the CPU (the plain
    versions, the CPU's bf16 products) from the same weights, and one
    step of the same program without AMP on the CPU.  The step-1 losses
    within TOL_AMP_LOSS; each parameter's step-1 gradient within
    TOL_AMP_GRAD relative L2, and all of them together within
    TOL_AMP_SHARE of AMP's own distance from float32 on the CPU
    (|g_card - g_cpu|_2 against |g_cpu - g_cpu,f32|_2)."""
    from paddle_tpu_torch.models import bert, transformer

    out = {}
    log(f"phase 7f: AMP training card vs CPU (Transformer {PARITY_BATCH} "
        f"x {PARITY_T}, BERT-base {BERT_PARITY_BATCH} x "
        f"{BERT_ARCH['max_len']}, dropout 0, step 1)")
    feed = transformer.make_fake_batch(PARITY_BATCH, PARITY_T,
                                       TRAIN_ARCH["src_vocab_size"],
                                       TRAIN_ARCH["trg_vocab_size"], seed=3)
    feed["src_len"] = np.array([PARITY_T, 41], np.int32)
    feed["trg_len"] = np.array([17, PARITY_T], np.int32)
    cases = [("Transformer", lambda **kw: build_training(
        dropout=0.0, max_length=PARITY_T, **kw), ("loss",), feed)]
    t_len = BERT_ARCH["max_len"]
    feed = bert.make_fake_batch(BERT_PARITY_BATCH, t_len,
                                BERT_ARCH["vocab_size"],
                                BERT_ARCH["max_predictions"], seed=3)
    feed["seq_len"] = np.array([t_len, 37], np.int32)
    cases.append(("BERT-base", lambda **kw: build_bert(dropout=0.0, **kw),
                  ("loss", "mlm_loss", "nsp_loss"), feed))
    for name, build, keys, feed in cases:
        main, startup, model = build(**AMP)
        losses = [model[k].name for k in keys]
        card, cpu, arrays, params = _card_and_cpu_runs(
            dev, main, startup, losses, feed, steps=1)
        f32 = _cpu_step(build()[0], arrays, losses, params, feed)
        loss_err = max(abs(a - b) for a, b in zip(card["losses"][0],
                                                   cpu["losses"][0]))
        dist = float(np.sqrt(sum(np.sum((a - b) ** 2) for a, b in
                                 zip(card["grads"], cpu["grads"]))))
        amp = float(np.sqrt(sum(np.sum((a - b) ** 2) for a, b in
                                zip(cpu["grads"], f32["grads"]))))
        rel = {n: float(np.linalg.norm(a - b)
                        / max(np.linalg.norm(b), 1e-30))
               for n, a, b in zip(params, card["grads"], cpu["grads"])}
        worst = max(rel, key=rel.get)
        log(f"  {name}: step-1 losses card {card['losses'][0]} cpu "
            f"{cpu['losses'][0]} (float32 {f32['losses'][0]}): max abs "
            f"err {loss_err:.3e} (tol {TOL_AMP_LOSS:g}); gradients of "
            f"{len(params)} parameters: |card - cpu|_2 {dist:.4e} = "
            f"{dist / amp:.3f} of AMP's |cpu - cpu f32|_2 {amp:.4e} (tol "
            f"{TOL_AMP_SHARE:g}); per parameter worst |dg|_2/|g|_2 "
            f"{rel[worst]:.3e} ({worst}; tol {TOL_AMP_GRAD:g}), median "
            f"{float(np.median(list(rel.values()))):.3e}")
        if not loss_err <= TOL_AMP_LOSS:
            raise AssertionError(f"7f {name}: losses differ by {loss_err}")
        if not rel[worst] <= TOL_AMP_GRAD:
            raise AssertionError(f"7f {name}: step-1 gradients of {worst} "
                                 f"differ by {rel[worst]}")
        if not dist <= TOL_AMP_SHARE * amp:
            raise AssertionError(f"7f {name}: step-1 gradients differ by "
                                 f"{dist / amp:.3f} of AMP's distance "
                                 f"from float32")
        out[name] = {"losses_card": card["losses"][0],
                     "losses_cpu": cpu["losses"][0],
                     "losses_cpu_f32": f32["losses"][0],
                     "loss_max_abs_err": loss_err,
                     "grad_l2_card_cpu": dist, "grad_l2_amp_f32": amp,
                     "grad_share_of_amp": dist / amp,
                     "grad_max_rel_l2_err": rel[worst],
                     "grad_median_rel_l2_err": float(
                         np.median(list(rel.values())))}
    return out


def _cpu_step(main, arrays, loss_names, params, feed):
    """One step of `main` on the CPU from `arrays`: its losses and the
    gradients of `params`, as `_card_and_cpu_runs` returns them."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import params_from_arrays

    scope = pt.Scope()
    for n, t in params_from_arrays(arrays, "cpu", program=main).items():
        scope.set_var(n, t)
    out = pt.Executor(pt.CPUPlace()).run(
        main, feed=feed, scope=scope,
        fetch_list=list(loss_names) + [f"{p}@GRAD" for p in params])
    n = len(loss_names)
    return {"losses": [[float(x.reshape(-1)[0]) for x in out[:n]]],
            "grads": out[n:]}


def phase_lstm_parity(dev):
    """7c: the stacked LSTM at full width on a batch the CPU takes."""
    from paddle_tpu_torch.models import stacked_dynamic_lstm

    log(f"phase 7c: stacked LSTM training card vs CPU "
        f"({LSTM_PARITY_BATCH} x {LSTM_PARITY_T} tokens, {PARITY_STEPS} "
        f"Adam steps)")
    main, startup, model = build_lstm(max_len=LSTM_PARITY_T)
    feed = stacked_dynamic_lstm.make_fake_batch(
        LSTM_PARITY_BATCH, LSTM_PARITY_T, LSTM_ARCH["vocab_size"], seed=3)
    feed["words.seq_len"][:2] = (LSTM_PARITY_T, 1)
    return _card_vs_cpu_training(
        dev, main, startup, [model["loss"].name], feed,
        LSTM_ARCH["learning_rate"] * PARITY_STEPS)


def _card_and_cpu_runs(dev, main, startup, loss_names, feed, state=(),
                       steps=PARITY_STEPS):
    """`steps` steps of `main` on the card and on the CPU from the
    same weights (drawn on the card by `startup`): (card, cpu, arrays,
    params), each run a dict of the losses named in `loss_names` at
    every step, the step-1 gradients, and the final parameters and
    values of the names in `state`; `arrays` the starting values."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import params_from_arrays

    init = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
    arrays = {n: v.cpu().numpy() for n, v in init.vars.items()
              if isinstance(v, torch.Tensor)}
    params = [p.name for p in main.all_parameters()]
    n_loss = len(loss_names)
    fetch = list(loss_names) + [f"{p}@GRAD" for p in params]
    runs = {}
    for place, device in ((pt.CUDAPlace(0), dev), (pt.CPUPlace(), "cpu")):
        scope = pt.Scope()
        for n, t in params_from_arrays(arrays, device, program=main).items():
            scope.set_var(n, t)
        exe = pt.Executor(place)
        losses, grads = [], None
        for step in range(steps):
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            losses.append([float(x.reshape(-1)[0]) for x in out[:n_loss]])
            if step == 0:
                grads = out[n_loss:]
        runs[str(device)] = dict(
            losses=losses, grads=grads,
            params={n: scope.find_var(n).cpu().numpy()
                    for n in [*params, *state]})
    return runs[str(dev)], runs["cpu"], arrays, params


def _card_vs_cpu_training(dev, main, startup, loss_names, feed, lr_sum):
    """PARITY_STEPS Adam steps of `main` on the card and on the CPU from
    the same weights (drawn on the card by `startup`), checked by
    `_check_adam_runs`."""
    card, cpu, _, params = _card_and_cpu_runs(dev, main, startup,
                                              loss_names, feed)
    return _check_adam_runs(card, cpu, loss_names, params, lr_sum)


def _check_adam_runs(card, cpu, loss_names, params, lr_sum):
    """The losses named in `loss_names`, the step-1 gradients and the
    final parameters of two runs of Adam steps within TOL_LOSS, TOL_GRAD
    and 4 * lr_sum."""
    loss_err = max(abs(a - b) for x, y in zip(card["losses"],
                                              cpu["losses"])
                   for a, b in zip(x, y))
    log(f"  losses ({', '.join(loss_names)}) card {card['losses']} cpu "
        f"{cpu['losses']}: max abs err {loss_err:.3e} (tol {TOL_LOSS:g})")
    if not loss_err <= TOL_LOSS:
        raise AssertionError(f"losses differ by {loss_err}")
    rel = {n: (float(np.linalg.norm(a - b) / max(np.linalg.norm(b),
                                                  1e-30)),
               float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)))
           for n, a, b in zip(params, card["grads"], cpu["grads"])}
    worst = max(rel, key=lambda n: rel[n][0])
    grad_err = rel[worst][0]
    log(f"  step-1 gradients over {len(params)} parameters: worst "
        f"|dg|_2/|g|_2 {grad_err:.3e} ({worst}; tol {TOL_GRAD:g}), worst "
        f"max|dg|/max|g| {max(r[1] for r in rel.values()):.3e}")
    if not grad_err <= TOL_GRAD:
        raise AssertionError(f"step-1 gradients of {worst} differ by "
                             f"{grad_err}")
    # Adam turns a gradient near 0 into a step of about +-lr whose sign
    # is noise: the bound is a few lr per step
    bound = 4 * lr_sum + 1e-6
    p_err = max(float(np.abs(card["params"][n] - cpu["params"][n]).max())
                for n in params)
    log(f"  parameters after {PARITY_STEPS} steps: max abs err "
        f"{p_err:.3e} (bound 4 * sum(lr) + 1e-6 = {bound:.3e})")
    if not p_err <= bound:
        raise AssertionError(f"parameters differ by {p_err} > {bound}")
    return {"losses_card": card["losses"], "losses_cpu": cpu["losses"],
            "loss_max_abs_err": loss_err, "grad_max_rel_l2_err": grad_err,
            "grad_max_rel_err": max(r[1] for r in rel.values()),
            "param_max_abs_err": p_err, "param_bound": bound}


def phase_resnet_parity(dev):
    """7e: ResNet-50 at full width on 2 x 3 x 224 x 224 (momentum at
    RESNET_PARITY_LR) on the card and on the CPU from the same weights:
    losses, step-1 gradients, each parameter's update over the steps and
    every batch norm's moving mean and variance, at the TOL_RESNET_*
    tolerances (see their comment)."""
    log(f"phase 7e: ResNet-50 training card vs CPU ({RESNET_PARITY_BATCH} x"
        f" 3 x 224 x 224, {PARITY_STEPS} momentum steps at lr "
        f"{RESNET_PARITY_LR})")
    main, startup, model = build_resnet(learning_rate=RESNET_PARITY_LR)
    stats = [v.name for v in main.global_block().vars.values()
             if v.name.endswith((".mean", ".var"))]
    card, cpu, arrays, params = _card_and_cpu_runs(
        dev, main, startup, [model["loss"].name],
        resnet_batch(RESNET_PARITY_BATCH, seed=3), stats)
    loss_err = max(abs(a[0] - b[0]) / abs(b[0])
                   for a, b in zip(card["losses"], cpu["losses"]))
    floor = 1e-4 * max(np.linalg.norm(g) for g in cpu["grads"])
    grad_rel = {n: float(np.linalg.norm(a - b) / (np.linalg.norm(b) + floor))
                for n, a, b in zip(params, card["grads"], cpu["grads"])}
    upd = {n: (card["params"][n] - arrays[n], cpu["params"][n] - arrays[n])
           for n in params}
    floor = 1e-4 * max(np.linalg.norm(b) for _, b in upd.values())
    upd_rel = {n: float(np.linalg.norm(a - b) / (np.linalg.norm(b) + floor))
               for n, (a, b) in upd.items()}
    stats_err = {}
    for suffix in (".mean", ".var"):
        names = [n for n in stats if n.endswith(suffix)]
        scale = max(np.abs(cpu["params"][n]).max() for n in names)
        stats_err[suffix] = max(float(np.abs(card["params"][n]
                                             - cpu["params"][n]).max())
                                for n in names) / scale
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_u = max(upd_rel, key=upd_rel.get)
    log(f"  losses card {card['losses']} cpu {cpu['losses']}: max rel err "
        f"{loss_err:.3e} (tol {TOL_RESNET_LOSS:g})")
    log(f"  step-1 gradients over {len(params)} parameters: worst rel L2 "
        f"{grad_rel[worst_g]:.3e} ({worst_g}; tol {TOL_RESNET_GRAD:g}); "
        f"updates over {PARITY_STEPS} steps: worst rel L2 "
        f"{upd_rel[worst_u]:.3e} ({worst_u}; tol {TOL_RESNET_UPDATE:g})")
    log(f"  moving statistics of {len(stats) // 2} batch norms: max err "
        f"over the largest, mean {stats_err['.mean']:.3e}, variance "
        f"{stats_err['.var']:.3e} (tol {TOL_RESNET_STATS:g})")
    if not (loss_err <= TOL_RESNET_LOSS
            and grad_rel[worst_g] <= TOL_RESNET_GRAD
            and upd_rel[worst_u] <= TOL_RESNET_UPDATE
            and max(stats_err.values()) <= TOL_RESNET_STATS):
        raise AssertionError("ResNet-50 card and CPU differ beyond the "
                             "tolerances")
    return {"losses_card": card["losses"], "losses_cpu": cpu["losses"],
            "loss_max_rel_err": loss_err,
            "grad_max_rel_l2_err": grad_rel[worst_g],
            "update_max_rel_l2_err": upd_rel[worst_u],
            "moving_stats_max_err": stats_err}


def phase_deepfm_parity(dev):
    """7e: DeepFM at full width on 64 examples on the card and on the CPU
    from the same weights: loss and AUC, step-1 gradients and final
    parameters as phase 7 holds them (`_check_adam_runs`), the AUC
    histograms equal (whole counts), and in both runs the rows no
    example touched bit-equal to their start in both tables and their
    moments."""
    from paddle_tpu_torch.models import deepfm

    log(f"phase 7e: DeepFM training card vs CPU ({DEEPFM_PARITY_BATCH} "
        f"examples, full width, {PARITY_STEPS} Adam steps)")
    main, startup, model = build_deepfm()
    feed = deepfm.make_fake_batch(DEEPFM_PARITY_BATCH, seed=3)
    state = [v.name for v in main.global_block().vars.values()
             if v.persistable and v.name.startswith(("auc", "fm_w1",
                                                      "fm_emb"))]
    names = [model["loss"].name, model["auc"].name]
    card, cpu, arrays, params = _card_and_cpu_runs(dev, main, startup,
                                                   names, feed, state)
    res = _check_adam_runs(card, cpu, names, params, 1e-3 * PARITY_STEPS)
    untouched = np.setdiff1d(np.arange(1000001),
                             np.unique(feed["sparse_ids"]))
    kept = 0
    for n in state:
        a, b = card["params"][n], cpu["params"][n]
        if n.startswith("auc"):
            if not np.array_equal(a, b):
                raise AssertionError(f"{n} differs between card and CPU")
        elif a.shape[0] == 1000001:
            for run in (a, b):
                if not np.array_equal(run[untouched],
                                      arrays[n][untouched]):
                    raise AssertionError(f"{n}: untouched rows moved")
            kept += 1
    log(f"  AUC histograms equal; untouched rows bit-equal to their start "
        f"in {kept} table tensors on both devices")
    return dict(res, tables_kept=kept)


def _noam_lr(step, d_model=512, warmup=4000, scale=2.0):
    """build_model's learning rate at `step` (noam_decay x 2.0)."""
    return scale * d_model ** -0.5 * min(step ** -0.5,
                                         step * warmup ** -1.5)


def _bert_lr(step, learning_rate=1e-4, warmup_steps=10000):
    """BERT build_model's learning rate at `step` inside its warmup
    (linear_lr_warmup from 0 over polynomial_decay)."""
    return learning_rate * min(step / warmup_steps, 1.0)


# -- phases 6l and 6m: checkpoint and resume, the update guard ------------

# phase 6c's Transformer (fused CE) under bf16 AMP with dynamic loss
# scaling: amp.decorate(use_dynamic_loss_scaling=True) turns on the
# update guard and the device-side telemetry
RESUME_STEPS = 3        # 6l: 3 steps, save, resume, 3 more = 6 whole
GUARD_INCR_EVERY = 2    # 6m: the loss scale doubles after 2 good steps
GUARD_TIMED_STEPS = 3   # 6m: guarded and unguarded steps, two rounds each


def build_guarded(incr_every_n_steps=1000, guard=True):
    """(main, startup, model) of the bench Transformer with the fused CE
    under bf16 AMP: build_model's graph and optimizer (noam x 2.0, Adam
    0.9/0.997/1e-9), the optimizer wrapped by amp.decorate with
    use_dynamic_loss_scaling=`guard` (False: phase 6i's plain AMP)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp, layers, optimizer
    from paddle_tpu_torch.models import transformer

    arch = dict(TRAIN_ARCH, use_fused_ce=True)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = transformer.build_model(**arch, with_optimizer=False)
        lr = layers.elementwise_mul(
            layers.noam_decay(arch["d_model"], 4000),
            layers.fill_constant([1], "float32", 2.0))
        opt = optimizer.AdamOptimizer(learning_rate=lr, beta1=0.9,
                                      beta2=0.997, epsilon=1e-9)
        amp.decorate(opt, use_dynamic_loss_scaling=guard,
                     incr_every_n_steps=incr_every_n_steps).minimize(
                         model["loss"])
    return main, startup, model


def _want_launches(main, steps):
    """Kernel launches `steps` training steps of `main` make: each flash
    op the forward, dK/dV and dQ once (their bf16 paths under AMP), each
    fused-CE op the vocab-CE forward, dh and dW once; nothing else."""
    from paddle_tpu_torch.ops import kernels

    n_flash, n_vocab = _flash_ops(main), _vocab_ops(main)
    flash = "_bf16" if main._amp_lists is not None else ""
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update({f"flash_attention_fwd{flash}": n_flash * steps,
                 f"flash_attention_bwd_dkv{flash}": n_flash * steps,
                 f"flash_attention_bwd_dq{flash}": n_flash * steps,
                 "vocab_ce_fwd": n_vocab * steps,
                 "vocab_ce_dh": n_vocab * steps,
                 "vocab_ce_dw": n_vocab * steps})
    return want


def _check_launches(label, main, steps):
    """The counts since the last reset against `_want_launches`, with no
    plain or composed call; returns the counts."""
    from paddle_tpu_torch.ops import kernels

    counts = kernels.counts()
    want = _want_launches(main, steps)
    la, pl, co = counts["launches"], counts["plain"], counts["composed"]
    if la != want or max(pl.values()) or max(co.values()):
        raise AssertionError(f"{label}: launches {counts}, want {want} "
                             f"and no plain or composed call")
    log(f"  {label}: launches over {steps} steps {la}; no plain or "
        f"composed call")
    return counts


def _state(main, scope):
    return {v.name: scope.find_var(v.name) for v in main.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def _clone_scope(src):
    """A new scope holding a copy of every value of `src` (tensors
    cloned on their device)."""
    import paddle_tpu_torch as pt

    out = pt.Scope()
    for n, v in src.vars.items():
        out.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
    return out


def _carry_train_state(old, new, program, dev):
    """The RNG counter and the telemetry accumulator from scope `old` to
    scope `new`, through JSON as the reference's Trainer carries them
    (paddle_tpu/contrib/trainer.py:327-409); phase 6n resumes through the
    port's own contrib.Trainer."""
    from paddle_tpu_torch.core.executor import RNG_STATE_VAR
    from paddle_tpu_torch.observe import metrics

    st = json.loads(json.dumps({
        "rng": old.find_var(RNG_STATE_VAR),
        "telemetry": {k: v.cpu().numpy().tolist() for k, v in
                      old.find_var(metrics.TELEMETRY_VAR).items()}}))
    new.set_var(RNG_STATE_VAR, st["rng"])
    tmpl = metrics.init_telemetry_for(program, dev)
    new.set_var(metrics.TELEMETRY_VAR, {
        k: torch.tensor(v, dtype=tmpl[k].dtype, device=dev)
        for k, v in st["telemetry"].items()})


def _differ(a, b):
    """{name: max |a - b|} over the names whose tensors are not
    bit-equal (dicts of tensors, or two lists)."""
    if isinstance(a, list):
        a, b = dict(enumerate(a)), dict(enumerate(b))
    out = {}
    for n in a:
        if not (a[n].dtype == b[n].dtype and torch.equal(a[n], b[n])):
            out[n] = float((a[n].float() - b[n].float()).abs().max())
    return out


def _nondeterministic_ops(exe, main, feed, loss, scope):
    """The ops of one step that torch reports as having no deterministic
    implementation (`use_deterministic_algorithms(True, warn_only)`)."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    return_numpy=False)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).splitlines()[0][:200] for w in caught
                   if "determinis" in str(w.message)})


def _transformer_feed(dev):
    from paddle_tpu_torch.models import transformer

    v = TRAIN_ARCH["trg_vocab_size"]
    return {n: torch.as_tensor(a).to(dev) for n, a in
            transformer.make_fake_batch(TRAIN_BATCH,
                                        TRAIN_ARCH["max_length"], v,
                                        v).items()}


def phase_resume(dev, card):
    """6l: train 6 steps uninterrupted; from the same start, 3 steps,
    io.save_sharded, a fresh scope and executor that run the startup
    program, io.load_sharded (the loaded state bit-equal to the saved),
    the RNG counter and telemetry carried over, 3 more steps: the
    losses, persistables and telemetry equal the uninterrupted run's bit
    for bit, or, when two uninterrupted runs already differ, within
    twice their spread, with the ops torch names as not deterministic.
    Then the forward program through save_inference_model and
    load_inference_model: its loss equals the trained program's
    clone(for_test=True) loss bit for bit."""
    import shutil

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io, observe
    from paddle_tpu_torch.ops import kernels

    log(f"phase 6l: checkpoint and resume of the AMP fused-CE Transformer "
        f"under dynamic loss scaling (batch {TRAIN_BATCH} x "
        f"{TRAIN_ARCH['max_length']}, dropout {TRAIN_ARCH['dropout']})")
    main, startup, model = build_guarded()
    loss = model["loss"]
    feed = _transformer_feed(dev)
    exe = pt.Executor(pt.CUDAPlace(0))
    start = pt.Scope()
    exe.run(startup, scope=start)

    def steps(ex, scope, n):
        return [ex.run(main, feed=feed, fetch_list=[loss], scope=scope,
                       return_numpy=False)[0] for _ in range(n)]

    n = RESUME_STEPS
    kernels.reset_counts()
    whole = _clone_scope(start)
    t0 = time.perf_counter()
    want = steps(exe, whole, 2 * n)
    torch.cuda.synchronize()
    whole_ms = (time.perf_counter() - t0) * 1e3 / (2 * n)
    part = _clone_scope(start)
    got = steps(exe, part, n)
    ckpt = os.path.join(OUT_DIR, "ckpt_6l")
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize()
    with pt.scope_guard(part):
        job = io.save_sharded(exe, ckpt, main_program=main)
    file_bytes = sum(os.path.getsize(os.path.join(ckpt, f))
                     for f in os.listdir(ckpt))
    saved = _state(main, part)
    exe2, fresh = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
    exe2.run(startup, scope=fresh)          # loading overwrites it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with pt.scope_guard(fresh):
        io.load_sharded(exe2, ckpt, main_program=main)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    bad = _differ(_state(main, fresh), saved)
    if bad or set(_state(main, fresh)) != set(saved):
        raise AssertionError(f"loaded state differs from the saved: "
                             f"{sorted(bad)[:4]}")
    _carry_train_state(part, fresh, main, dev)
    got += steps(exe2, fresh, n)
    torch.cuda.synchronize()
    counts = _check_launches("phase 6l", main, 4 * n)
    tel = {k: observe.fetch_telemetry(sc, reset=False)
           for k, sc in (("whole", whole), ("resumed", fresh))}
    for k, t in tel.items():
        if (t.steps, t.skipped_update_steps, t.nonfinite_grad_steps,
                t.loss_scale) != (2 * n, 0, 0, 2.0 ** 15):
            raise AssertionError(f"6l {k} telemetry {t}")
    from paddle_tpu_torch.observe.metrics import TELEMETRY_VAR

    diff = {"losses": _differ(got, want),
            "persistables": _differ(_state(main, fresh),
                                    _state(main, whole)),
            "telemetry": _differ(fresh.find_var(TELEMETRY_VAR),
                                 whole.find_var(TELEMETRY_VAR))}
    res = {"steps": 2 * n, "bytes_total": job.bytes_total,
           "file_bytes": file_bytes, "snapshot_ms": job.snapshot_ms,
           "write_ms": job.write_ms, "load_ms": load_ms,
           "whole_run_ms_per_step": whole_ms,
           "n_persistables": len(saved),
           "losses": [float(x.reshape(())) for x in want],
           "resume_differs": {k: len(v) for k, v in diff.items()},
           "launches": counts["launches"], "plain_calls": counts["plain"],
           "composed_calls": counts["composed"]}
    log(f"  checkpoint: {len(saved)} persistables, {job.bytes_total} "
        f"bytes of arrays, {file_bytes} bytes on disk; snapshot "
        f"{job.snapshot_ms:.1f} ms, write {job.write_ms:.1f} ms, load "
        f"{load_ms:.1f} ms on {card}")
    log(f"  losses {res['losses'][0]:.6f} .. {res['losses'][-1]:.6f} "
        f"({whole_ms:.2f} ms/step over the uninterrupted run, the "
        f"program's first step included); telemetry "
        f"{tel['resumed'].as_dict()}")
    if any(diff.values()):
        again = _clone_scope(start)
        want2 = steps(exe, again, 2 * n)
        spread = {"losses": _differ(want2, want),
                  "persistables": _differ(_state(main, again),
                                          _state(main, whole))}
        res["uninterrupted_spread"] = {k: max(v.values(), default=0.0)
                                       for k, v in spread.items()}
        res["resume_max_abs"] = {k: max(v.values(), default=0.0)
                                 for k, v in diff.items()}
        res["nondeterministic_ops"] = _nondeterministic_ops(
            exe, main, feed, loss, _clone_scope(start))
        log(f"  resume differs from the uninterrupted run: "
            f"{res['resume_max_abs']}; two uninterrupted runs differ by "
            f"{res['uninterrupted_spread']}; not deterministic: "
            f"{res['nondeterministic_ops']}")
        if not any(spread.values()):
            raise AssertionError("the resumed run differs from the "
                                 "uninterrupted one, which repeats itself")
        for k in ("losses", "persistables"):
            if res["resume_max_abs"][k] > 2 * res["uninterrupted_spread"][k]:
                raise AssertionError(f"6l: resumed {k} outside twice the "
                                     f"spread of two uninterrupted runs")
    else:
        log("  resumed losses, persistables and telemetry bit-equal to "
            "the uninterrupted run's")
    ex_dir = os.path.join(OUT_DIR, "export_6l")
    shutil.rmtree(ex_dir, ignore_errors=True)
    t0 = time.perf_counter()
    with pt.scope_guard(fresh):
        io.save_inference_model(ex_dir, model["feeds"], [loss], exe2,
                                main_program=main)
    save_ms = (time.perf_counter() - t0) * 1e3
    plain = exe2.run(main.clone(for_test=True), feed=feed,
                     fetch_list=[loss], scope=fresh, return_numpy=False)[0]
    inf_scope = pt.Scope()
    t0 = time.perf_counter()
    with pt.scope_guard(inf_scope):
        prog, feed_names, targets = io.load_inference_model(ex_dir, exe2)
    torch.cuda.synchronize()
    reload_ms = (time.perf_counter() - t0) * 1e3
    served = exe2.run(prog, feed={k: feed[k] for k in feed_names},
                      fetch_list=targets, scope=inf_scope,
                      return_numpy=False)[0]
    if not torch.equal(served, plain):
        raise AssertionError(f"exported program's loss {served} differs "
                             f"from clone(for_test=True)'s {plain}")
    log(f"  inference export: {len(prog.global_block().ops)} ops, save "
        f"{save_ms:.1f} ms, load {reload_ms:.1f} ms; loss "
        f"{float(served.reshape(())):.6f} bit-equal to "
        f"clone(for_test=True)'s")
    res.update(export_save_ms=save_ms, export_load_ms=reload_ms,
               export_ops=len(prog.global_block().ops))
    shutil.rmtree(ckpt, ignore_errors=True)
    shutil.rmtree(ex_dir, ignore_errors=True)
    return res


def _sync_warnings(fn):
    """The synchronizing CUDA calls fn() makes, as
    torch.cuda.set_sync_debug_mode("warn") reports them: the Python line
    that made each one."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message).lower()]


def phase_guard(dev, card):
    """6m: the update guard on the card.  A guarded and an unguarded
    step (the same Transformer, plain amp.decorate): their host
    synchronizations (the guard adds none), step times, device busy
    time and peak memory.  Then a guarded run of five steps whose third
    has one token id outside the vocabulary (the Transformer's feeds are
    integer ids, which chaos.poison_feed refuses as the reference's
    does; the lookup turns such an id into a NaN row, ROADMAP C3): every
    persistable the update ops write keeps its bits through that step
    (the forward's learning-rate counter advances, as in the reference),
    one step is skipped,
    the loss scale halves and regrows after GUARD_INCR_EVERY good steps,
    the other steps train, and with numerics on the first non-finite op
    is the lookup that reads the poisoned feed.  Last, the dh and dW
    kernels at the training shape with the cotangent x 2^15, unscaled,
    against the unscaled kernels."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import vocab_ce as vk

    log(f"phase 6m: the update guard on the card (AMP fused-CE "
        f"Transformer, batch {TRAIN_BATCH} x {TRAIN_ARCH['max_length']})")
    feed = _transformer_feed(dev)
    runs = {}
    for label, guard in (("unguarded", False), ("guarded", True)):
        main, startup, model = build_guarded(GUARD_INCR_EVERY, guard=guard)
        scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
        exe.run(startup, scope=scope)
        loss = model["loss"]

        def step(m=main, s=scope, e=exe, lv=loss):
            return e.run(m, feed=feed, fetch_list=[lv], scope=s,
                         return_numpy=False)[0]

        step()
        runs[label] = dict(main=main, startup=startup, scope=scope,
                           exe=exe, loss=loss, step=step,
                           syncs=_sync_warnings(step), ms=[])
    for _ in range(2):
        for label, r in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GUARD_TIMED_STEPS):
                r["step"]()
            torch.cuda.synchronize()
            r["ms"].append((time.perf_counter() - t0) * 1e3
                           / GUARD_TIMED_STEPS)
    res = {}
    for label, r in runs.items():
        torch.cuda.reset_peak_memory_stats(dev)
        r["step"]()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        prof = _profile_train_step(r["exe"], r["main"], feed, r["loss"],
                                   r["scope"], label=f"phase 6m, {label}")
        res[label] = {"step_ms": min(r["ms"]), "step_ms_rounds": r["ms"],
                      "peak_mem_bytes": peak, "host_syncs": r["syncs"],
                      "profile": prof}
        log(f"  {label}: step {min(r['ms']):.2f} ms (rounds {r['ms']}), "
            f"device busy {prof['device_busy_ms_per_step']:.2f} ms, peak "
            f"{peak / 1e9:.3f} GB, {len(r['syncs'])} host syncs "
            f"{r['syncs']} on {card}")
    if (len(res["guarded"]["host_syncs"])
            != len(res["unguarded"]["host_syncs"])):
        raise AssertionError(f"the guard adds host syncs: "
                             f"{res['guarded']['host_syncs']}")
    r = runs["guarded"]
    main, exe, loss = r["main"], r["exe"], r["loss"]
    scope = pt.Scope()
    exe.run(r["startup"], scope=scope)
    src = feed["src_word"].clone()
    src[0, 0] = TRAIN_ARCH["src_vocab_size"] + 7
    poisoned = dict(feed, src_word=src)
    ops = main.global_block().ops
    reader = next(i for i, op in enumerate(ops)
                  if "src_word" in op.desc.input_names())
    fwd_written = {n for op in ops[:main._backward_info["index"]]
                   for n in op.desc.output_names()}
    kernels.reset_counts()
    scales, losses, moved = [], [], []
    for i, f in enumerate((feed, feed, poisoned, feed, feed)):
        if i == 2:
            observe.enable_numerics(main)
        before = {k: v.clone() for k, v in _state(main, scope).items()}
        losses.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                    scope=scope, return_numpy=False)[0]
                            .reshape(())))
        tel = observe.fetch_telemetry(scope, reset=False, program=main)
        scales.append(tel.loss_scale)
        changed = _differ(_state(main, scope), before)
        moved.append(len(changed))
        if i == 2:
            # the guard rolls back what the update ops write; state the
            # forward writes (the learning rate's step counter) advances,
            # as in the reference (paddle_tpu/core/executor.py:577-590)
            if set(changed) - fwd_written:
                raise AssertionError(f"the poisoned step changed "
                                     f"{sorted(changed)[:4]}")
            kept_through = sorted(changed)
            fno = tel.first_nonfinite_op
            if fno is None or fno["op_index"] != reader:
                raise AssertionError(f"first non-finite op {fno}, want "
                                     f"op {reader} (reads src_word)")
    counts = _check_launches("phase 6m", main, 5)
    want_scales = [2.0 ** 15, 2.0 ** 16, 2.0 ** 15, 2.0 ** 15, 2.0 ** 16]
    clean = [x for i, x in enumerate(losses) if i != 2]
    if (scales != want_scales or tel.skipped_update_steps != 1
            or tel.nonfinite_grad_steps != 1 or not np.isfinite(clean).all()
            or np.isfinite(losses[2]) or 0 in [moved[i] for i in
                                               (0, 1, 3, 4)]):
        raise AssertionError(f"6m: scales {scales} (want {want_scales}), "
                             f"losses {losses}, changed {moved}, "
                             f"telemetry {tel.as_dict()}")
    log(f"  guarded run: losses {losses}; loss scale {scales}; "
        f"persistables changed per step {moved} (the poisoned step: "
        f"{kept_through}, written by forward ops); skipped "
        f"{tel.skipped_update_steps}; first non-finite op "
        f"{tel.first_nonfinite_op}")
    h, w, _, lbl, g = vocab_case(dev, TRAIN_BATCH * TRAIN_ARCH["max_length"],
                                 TRAIN_ARCH["d_model"],
                                 TRAIN_ARCH["trg_vocab_size"], seed=16)
    lse = vk.vocab_ce_fwd(h, w, lbl)[0]
    scale = torch.tensor(2.0 ** 15, device=dev)
    dh, dw = vk.vocab_ce_bwd(h, w, lbl, lse, g, 0.1)
    sdh, sdw = vk.vocab_ce_bwd(h, w, lbl, lse, g * scale, 0.1)
    inv = 1.0 / scale
    errs = {"dh": check_close("6m dh (g x 2^15, unscaled)", sdh * inv, dh,
                              TOL_VOCAB),
            "dw": check_close("6m dW (g x 2^15, unscaled)", sdw * inv, dw,
                              TOL_VOCAB)}
    res.update(poisoned_step=dict(
        losses=losses, loss_scales=scales, changed_per_step=moved,
        forward_state_advanced=kept_through, telemetry=tel.as_dict()),
        scaled_vocab_bwd_max_abs_err=errs,
        scaled_vocab_bwd_bit_equal=bool(torch.equal(sdh * inv, dh)
                                        and torch.equal(sdw * inv, dw)),
        launches=counts["launches"], plain_calls=counts["plain"],
        composed_calls=counts["composed"])
    log(f"  dh/dW with g x 2^15, unscaled: bit-equal to the unscaled "
        f"kernels: {res['scaled_vocab_bwd_bit_equal']}")
    return res


# -- phase 6n: the Trainer — async checkpoints, kill and resume ----------

# phase 6l's AMP fused-CE Transformer under contrib.Trainer: one epoch of
# TRAINER_BATCHES seeded batches, the one at TRAINER_NAN_AT carrying a
# token id outside the vocabulary (a NaN row; the guard skips the step)
TRAINER_BATCHES = 8
TRAINER_NAN_AT = 3
TRAINER_STEP_DEADLINE_S = 30.0   # the steady-state step budget
TRAINER_SLOW_WRITE_S = 2.0       # 6n's SIGKILL victim: writes held 2 s
TRAINER_KILL_AT = 4              # ... killed once serial 1 is in flight
TRAINER_TERM_AT = 6              # 6n's SIGTERM victim: after 6 steps,
TRAINER_TERM_PACE_S = 0.3        # each step's handler held 0.3 s so the
#                                  signal lands before its boundary
TRAINER_HANG_BUDGET_S = 2.0      # the in-worker DispatchWatchdog's step
TRAINER_WORKER_TIMEOUT_S = 300


def trainer_funcs():
    """(train_func, optimizer_func) of build_guarded's graph for
    contrib.Trainer: build_model's forward and loss, then Adam under noam
    x 2.0 wrapped by amp.decorate with dynamic loss scaling."""
    from paddle_tpu_torch import amp, layers, optimizer
    from paddle_tpu_torch.models import transformer

    arch = dict(TRAIN_ARCH, use_fused_ce=True)

    def train_func():
        return transformer.build_model(**arch, with_optimizer=False)["loss"]

    def optimizer_func():
        lr = layers.elementwise_mul(
            layers.noam_decay(arch["d_model"], 4000),
            layers.fill_constant([1], "float32", 2.0))
        return amp.decorate(
            optimizer.AdamOptimizer(learning_rate=lr, beta1=0.9,
                                    beta2=0.997, epsilon=1e-9),
            use_dynamic_loss_scaling=True)

    return train_func, optimizer_func


def trainer_batches():
    """The epoch's batches (host numpy, phase 6l's feed shape), one per
    seed; batch TRAINER_NAN_AT has a source id equal to the vocabulary
    size."""
    from paddle_tpu_torch.models import transformer

    v = TRAIN_ARCH["trg_vocab_size"]
    out = [transformer.make_fake_batch(TRAIN_BATCH, TRAIN_ARCH["max_length"],
                                       v, v, seed=100 + i)
           for i in range(TRAINER_BATCHES)]
    out[TRAINER_NAN_AT]["src_word"][0, 0] = v
    return out


def _set_matmul_flags():
    """TF32 off, and bf16 GEMMs without reduced-precision reductions
    (the reference's bf16 products accumulate in float32 and round
    once)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False


def trainer_worker(argv) -> int:
    """One 6n training process, `chip_smoke.py --trainer-worker DIR
    [--slow-write S] [--pace S] [--checks]`: contrib.Trainer on cuda:0
    over one epoch, its checkpoints under DIR/ck, its event log
    DIR/events.jsonl, its background writes held S each (chaos
    delaypoint); prints "STEP <epoch> <step> <unix time>" after each
    step, then sleeps `--pace`; on SIGTERM drains and exits with
    PREEMPT_EXIT_CODE.  `--checks` adds `_trainer_checks` after train().
    Writes DIR/result.json (steps, kernel counts against the launches
    its runs should make, goodput, checkpoint spans) on the way out."""
    import argparse

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.contrib import (BeginStepEvent, CheckpointConfig,
                                          EndStepEvent, Trainer)
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.resilience import TrainingPreempted, chaos

    ap = argparse.ArgumentParser(prog="chip_smoke.py --trainer-worker")
    ap.add_argument("dir")
    ap.add_argument("--slow-write", type=float, default=0.0)
    ap.add_argument("--pace", type=float, default=0.0)
    ap.add_argument("--checks", action="store_true")
    args = ap.parse_args(argv)
    _set_matmul_flags()
    _build.build()
    if args.slow_write > 0:
        chaos.arm_delay("ckpt:write", args.slow_write, times=10 ** 6)
    t0 = time.time()
    train_func, optimizer_func = trainer_funcs()
    trainer = Trainer(
        train_func, optimizer_func, place=pt.CUDAPlace(0),
        checkpoint_config=CheckpointConfig(
            os.path.join(args.dir, "ck"), step_interval=2, async_save=True,
            max_num_checkpoints=2),
        telemetry=observe.TelemetryConfig(
            interval=2, log_path=os.path.join(args.dir, "events.jsonl")),
        step_deadline_s=TRAINER_STEP_DEADLINE_S, preempt_drain=True)
    t_ready = time.time()
    batches = trainer_batches()
    steps, begun = [], {}

    def handler(e):
        if isinstance(e, BeginStepEvent):
            pending = trainer._pending_save
            begun.update(t=time.perf_counter(), inflight=bool(
                pending is not None and not pending.done()))
        elif isinstance(e, EndStepEvent):
            now = time.time()
            steps.append({"epoch": e.epoch, "step": e.step,
                          "ms": (time.perf_counter() - begun["t"]) * 1e3,
                          "write_in_flight": begun["inflight"],
                          "loss": float(np.asarray(e.metrics[0])
                                        .reshape(-1)[0]),
                          "t": now})
            print(f"STEP {e.epoch} {e.step} {now:.6f}", flush=True)
            time.sleep(args.pace)

    res = {"t_begin": t0, "t_trainer_s": t_ready - t0, "resume": [
        trainer._resume_epoch, trainer._resume_step_in_epoch]}
    rc = 0
    try:
        trainer.train(num_epochs=1, reader=lambda: iter(batches),
                      event_handler=handler)
    except TrainingPreempted as e:
        res["preempted"] = e.as_dict()
        rc = e.exit_code
    want = _want_launches(trainer.train_program, len(steps))
    spans = [ev for ev in
             trainer.goodput_ledger.export_chrome_trace()["traceEvents"]
             if ev.get("args", {}).get("category") == "checkpoint"]
    res.update(steps=steps, goodput=trainer.goodput(),
               ckpt_stats=trainer.ckpt_stats,
               checkpoint_spans_ms=[(ev["name"], ev["dur"] / 1e3)
                                    for ev in spans],
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    if rc == 0 and args.checks:
        res["checks"] = _trainer_checks(trainer, batches, args.dir, want)
    res.update(counts=kernels.counts(), want=want)
    with open(os.path.join(args.dir, "result.json"), "w") as f:
        json.dump(res, f, default=str)
    if rc == 0:
        trainer.stop()
        print("DONE", flush=True)
    return rc


def _trainer_checks(trainer, batches, run_dir, want):
    """After train(), in the worker: a DispatchWatchdog (step budget
    TRAINER_HANG_BUDGET_S) around two real steps on the card, then a
    chaos.hang in a third (StepHangError after a step_hang event); then
    save_params and the Inferencer, whose loss equals the trained
    program's clone(for_test=True) loss bit for bit.  Adds the launches
    of those 2 steps and 2 forward runs to `want`."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp, observe
    from paddle_tpu_torch.contrib import Inferencer
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.resilience import (DispatchWatchdog,
                                             StepHangError, chaos)

    program, loss = trainer.train_program, trainer.train_outputs[0]
    wd = DispatchWatchdog(TRAINER_HANG_BUDGET_S, event_log=trainer._event_log)
    for i in range(2):
        with wd.guard(f"check step {i}"):
            trainer.exe.run(program, feed=batches[i], fetch_list=[loss],
                            scope=trainer.scope)
    t0 = time.perf_counter()
    try:
        with wd.guard("check step 2"):
            chaos.hang(60)
        raise AssertionError("6n: the hung step was not interrupted")
    except StepHangError as e:
        hang = e.as_dict()
    hang_s = time.perf_counter() - t0
    ev = [e for e in observe.read_events(trainer._event_log.path)
          if e["event"] == "step_hang"]
    kinds = [r["kind"] for r in wd.regions]
    if (kinds != ["first_compile", "step", "step"]
            or hang["kind"] != "hung_step" or not ev
            or ev[-1]["hang_kind"] != "hung_step"):
        raise AssertionError(f"6n watchdog: regions {wd.regions}, hang "
                             f"{hang}, events {ev}")
    params = os.path.join(run_dir, "params")
    trainer.save_params(params)
    feed = batches[0]
    plain = trainer.exe.run(program.clone(for_test=True), feed=feed,
                            fetch_list=[loss], scope=trainer.scope)[0]
    arch = dict(TRAIN_ARCH, use_fused_ce=True, dropout=0.0)

    def infer_func():
        # the forward at dropout 0 (a test-mode upscale_in_train dropout
        # passes its input through), under the bf16 policy as
        # amp.decorate(...).minimize marks a program (a forward-only
        # program has no minimize)
        out = transformer.build_model(**arch, with_optimizer=False)["loss"]
        infer_program = pt.default_main_program()
        infer_program._amp_lists = amp.AutoMixedPrecisionLists()
        infer_program._bump()
        return out

    served = Inferencer(infer_func, params,
                        place=pt.CUDAPlace(0)).infer(feed)[0]
    if served.dtype != plain.dtype or not np.array_equal(served, plain):
        raise AssertionError(f"6n Inferencer loss {served} differs from "
                             f"clone(for_test=True)'s {plain}")
    for k, n in _want_launches(program, 2).items():
        want[k] += n
    want["flash_attention_fwd_bf16"] += 2 * _flash_ops(program)
    want["vocab_ce_fwd"] += 2 * _vocab_ops(program)
    return {"watchdog_regions": kinds, "hang": hang, "hang_s": hang_s,
            "inference_loss": float(served.reshape(-1)[0])}


def _worker_cmd(run_dir, *flags):
    return [sys.executable, os.path.abspath(__file__), "--trainer-worker",
            run_dir, *flags]


def _worker_result(run_dir, rc, out, spawned):
    path = os.path.join(run_dir, "result.json")
    if not os.path.exists(path):
        raise AssertionError(f"6n worker in {run_dir} wrote no result "
                             f"(rc {rc}): {out[-2000:]}")
    with open(path) as f:
        res = json.load(f)
    os.remove(path)                 # a relaunch in this directory writes anew
    res.update(rc=rc, run_dir=run_dir, first_step_after_spawn_s=(
        res["steps"][0]["t"] - spawned if res["steps"] else None))
    counts, want = res["counts"], res["want"]
    if (counts["launches"] != want or max(counts["plain"].values())
            or max(counts["composed"].values())):
        raise AssertionError(f"6n worker {run_dir}: launches {counts}, "
                             f"want {want} and no plain or composed call")
    return res


def _run_worker(run_dir, *flags):
    """A worker run to its end; its result."""
    os.makedirs(run_dir, exist_ok=True)
    spawned = time.time()
    r = subprocess.run(_worker_cmd(run_dir, *flags), capture_output=True,
                       text=True, timeout=TRAINER_WORKER_TIMEOUT_S)
    if r.returncode != 0 or "DONE" not in r.stdout:
        raise AssertionError(f"6n worker {run_dir} failed (rc "
                             f"{r.returncode}): {r.stderr[-3000:]}")
    return _worker_result(run_dir, r.returncode, r.stdout, spawned)


def _signal_worker(run_dir, sig, at_step, wait_for=None, flags=()):
    """A worker that gets `sig` once `at_step` steps are done and the
    path `wait_for` (under its checkpoint root) exists; (rc, stdout,
    spawn time)."""
    import signal as _signal

    os.makedirs(run_dir, exist_ok=True)
    err = open(os.path.join(run_dir, "stderr.txt"), "w")
    spawned = time.time()
    p = subprocess.Popen(_worker_cmd(run_dir, *flags),
                         stdout=subprocess.PIPE, stderr=err, text=True)
    lines = []
    try:
        deadline = time.monotonic() + TRAINER_WORKER_TIMEOUT_S
        for line in p.stdout:
            lines.append(line)
            if line.startswith("STEP ") and int(line.split()[2]) + 1 \
                    >= at_step:
                break
        if wait_for is not None:
            target = os.path.join(run_dir, "ck", wait_for)
            while not os.path.exists(target):
                if time.monotonic() > deadline or p.poll() is not None:
                    raise AssertionError(f"6n: {target} never appeared: "
                                         f"{''.join(lines)[-2000:]}")
                time.sleep(0.01)
            time.sleep(0.3)       # the save's submit is done, its write not
        if p.poll() is not None:
            raise AssertionError(f"6n victim ended before its signal "
                                 f"(rc {p.returncode}): {''.join(lines)}")
        p.send_signal(sig)
        rest = p.stdout.read()
        rc = p.wait(timeout=TRAINER_WORKER_TIMEOUT_S)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        err.close()
    if sig == _signal.SIGKILL and rc != -_signal.SIGKILL:
        raise AssertionError(f"6n SIGKILL victim: rc {rc}")
    return rc, "".join(lines) + (rest or ""), spawned


def _serials(ckpt):
    """(listed serials, torn directories) of a checkpoint root; a
    listed serial must have its manifest (trainer state written last)."""
    listed, torn = [], []
    for name in sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []:
        path = os.path.join(ckpt, name)
        if not (name.startswith("ckpt_") and os.path.isdir(path)):
            continue
        if os.path.exists(os.path.join(path, "__trainer_state__.json")):
            if not os.path.exists(os.path.join(path, "__shards__.json")):
                raise AssertionError(f"{path}: trainer state without its "
                                     f"manifest")
            listed.append(int(name.split("_")[1]))
        else:
            torn.append(name)
    return sorted(listed), torn


def _final_checkpoint(run_dir):
    """The newest serial of a finished run (its epoch-end save, the
    state train() returned with): {var: CRC32 of its bytes} from the
    manifest, and the train_state (run counter, telemetry, cursor)."""
    ckpt = os.path.join(run_dir, "ck")
    listed, _ = _serials(ckpt)
    path = os.path.join(ckpt, f"ckpt_{listed[-1]}")
    with open(os.path.join(path, "__shards__.json")) as f:
        crcs = {n: [s["crc32"] for s in m["shards"]]
                for n, m in json.load(f)["vars"].items()}
    with open(os.path.join(path, "__trainer_state__.json")) as f:
        st = json.load(f)
    return path, crcs, st


def _final_arrays(path):
    with np.load(os.path.join(path, "shards_p0.npz")) as z:
        return {k.split("::")[0]: z[k] for k in z.files}


def _max_abs(a, b):
    return max((float(np.max(np.abs(a[k].astype(np.float64)
                                    - b[k].astype(np.float64))))
                for k in a if a[k].dtype.kind == "f"), default=0.0)


def _compare_runs(root, name, control, relaunch, spread_lock):
    """The relaunch of chain `name` against the control: its final
    checkpoint's variables (CRC32 of every one), run counter and
    telemetry, and the loss of every step it ran, bit for bit; where
    they differ, within twice the spread of a second uninterrupted run.
    Both chains resume at an even step, so the telemetry windows (every
    2 steps of a process) fall where the control's do."""
    path, crcs, st = _final_checkpoint(os.path.join(root, name))
    cpath, ccrcs, cst = _final_checkpoint(os.path.join(root, "control"))
    if set(crcs) != set(ccrcs):
        raise AssertionError(f"6n {name}: other variables than the control")
    want = {(s["epoch"], s["step"]): s["loss"] for s in control["steps"]}
    bad_losses = [s["step"] for s in relaunch["steps"]
                  if s["loss"] != want[(s["epoch"], s["step"])]
                  and not (np.isnan(s["loss"])
                           and np.isnan(want[(s["epoch"], s["step"])]))]
    keys = ("telemetry", "rng_key", "data_cursor")
    out = {"vars_differing": sorted(n for n in ccrcs
                                    if crcs[n] != ccrcs[n]),
           "train_state_differing": [k for k in keys
                                     if st["train_state"][k]
                                     != cst["train_state"][k]],
           "losses_differing": bad_losses}
    if any(out.values()):
        with spread_lock:
            again = os.path.join(root, "control_again")
            if not os.path.isdir(again):
                _run_worker(again)
        base = _final_arrays(cpath)
        spread = _max_abs(_final_arrays(_final_checkpoint(again)[0]), base)
        got = _max_abs(_final_arrays(path), base)
        out.update(resume_max_abs=got, uninterrupted_spread=spread)
        log(f"  6n {name}: differs from the control ({out})")
        if spread == 0.0 or got > 2 * spread:
            raise AssertionError(f"6n {name}: resumed state outside twice "
                                 f"the spread of two uninterrupted runs")
    return out


def _events(run_dir):
    from paddle_tpu_torch.observe import read_events

    return read_events(os.path.join(run_dir, "events.jsonl"))


def _trainer_summary(res):
    """A run's timings: each save's blocking time (its ledger span)
    beside its snapshot and background write, step times with and
    without a write in flight (the first step apart), the goodput
    categories (which must sum to the wall), spawn to first step."""
    ev = _events(res["run_dir"])
    saves = [e for e in ev if e["event"] == "ckpt_save"]
    blocking = dict(res["checkpoint_spans_ms"])
    steady = res["steps"][1:]

    def mean(xs):
        return sum(xs) / len(xs) if xs else None

    rep = res["goodput"]
    total = sum(rep["categories_s"].values())
    if abs(total - rep["wall_s"]) > 1e-3:
        raise AssertionError(f"6n goodput categories sum to {total}, the "
                             f"wall is {rep['wall_s']}")
    return {
        "steps": len(res["steps"]), "resumed_from": res["resume"],
        "first_step_ms": res["steps"][0]["ms"] if res["steps"] else None,
        "step_ms_write_in_flight": mean(
            [s["ms"] for s in steady if s["write_in_flight"]]),
        "step_ms_no_write": mean(
            [s["ms"] for s in steady if not s["write_in_flight"]]),
        "saves": [{"serial": e["serial"], "step": [e["epoch"], e["step"]],
                   "blocking_ms": blocking.get(f"save:{e['serial']}"),
                   "snapshot_ms": e["snapshot_ms"],
                   "write_ms": e["write_ms"], "bytes": e["bytes"],
                   "emergency": e["emergency"]} for e in saves
                  if e["ts"] >= res["t_begin"]],
        "goodput": {k: rep[k] for k in ("wall_s", "categories_s",
                                        "goodput", "steps",
                                        "replay_steps", "mean_step_s",
                                        "background_ms")},
        "trainer_init_s": res["t_trainer_s"],
        "spawn_to_first_step_s": res["first_step_after_spawn_s"],
        "peak_memory_bytes": res["peak_memory_bytes"],
    }


def _trainer_line(s):
    def ms(x):
        return "n/a" if x is None else f"{x:.1f}"

    saves = s["saves"]
    return (f"{s['steps']} steps, step {ms(s['step_ms_no_write'])} ms "
            f"(with a write in flight {ms(s['step_ms_write_in_flight'])} "
            f"ms); saves blocked "
            f"{[round(x['blocking_ms'] or 0, 1) for x in saves]} ms, wrote "
            f"{[round(x['write_ms'], 1) for x in saves]} ms; goodput "
            f"{s['goodput']['goodput']:.4f} of {s['goodput']['wall_s']:.2f} "
            f"s {s['goodput']['categories_s']}; spawn to first step "
            f"{s['spawn_to_first_step_s']:.2f} s")


def _kill_chain(root, control, lock):
    """A worker SIGKILLed once its second save is in flight (its writes
    held TRAINER_SLOW_WRITE_S), then relaunched to its end."""
    import signal as _signal

    run_dir = os.path.join(root, "sigkill")
    rc, _, _ = _signal_worker(run_dir, _signal.SIGKILL, TRAINER_KILL_AT,
                              wait_for="ckpt_1", flags=(
                                  "--slow-write", str(TRAINER_SLOW_WRITE_S)))
    listed, torn = _serials(os.path.join(run_dir, "ck"))
    if listed != [0] or torn != ["ckpt_1"] or os.path.exists(
            os.path.join(run_dir, "ck", "ckpt_1", "shards_p0.npz")):
        raise AssertionError(f"6n SIGKILL: listed {listed}, torn {torn}; "
                             f"want serial 0 and a torn, unwritten ckpt_1")
    relaunch = _run_worker(run_dir)
    if relaunch["goodput"]["replay_steps"] < 1:
        raise AssertionError("6n: the relaunch counted no replay")
    return [relaunch], dict(
        _trainer_summary(relaunch), victim_rc=rc,
        **_compare_runs(root, "sigkill", control, relaunch, lock))


def _term_chain(root, control, lock):
    """A worker SIGTERMed after TRAINER_TERM_AT steps: it drains to an
    emergency checkpoint and exits with PREEMPT_EXIT_CODE; relaunched
    to its end with `--checks`."""
    import signal as _signal

    from paddle_tpu_torch.resilience import PREEMPT_EXIT_CODE

    run_dir = os.path.join(root, "sigterm")
    rc, out, spawned = _signal_worker(
        run_dir, _signal.SIGTERM, TRAINER_TERM_AT,
        flags=("--pace", str(TRAINER_TERM_PACE_S)))
    if rc != PREEMPT_EXIT_CODE:
        raise AssertionError(f"6n SIGTERM victim: rc {rc}, want "
                             f"{PREEMPT_EXIT_CODE}: {out[-2000:]}")
    victim = _worker_result(run_dir, rc, out, spawned)
    ev = _events(run_dir)
    kinds = [e["event"] for e in ev]
    drain = next(e for e in ev if e["event"] == "preempt_drain")
    emerg = next(e for e in ev if e["event"] == "ckpt_save"
                 and e["emergency"])
    done = next(e for e in ev if e["event"] == "ckpt_emergency")
    if (kinds.count("preempt_drain") != 1
            or kinds.index("preempt_drain") > kinds.index("ckpt_emergency")
            or drain["reason"] != "signal:SIGTERM"
            or (drain["epoch"], drain["step"]) != (0, TRAINER_TERM_AT)):
        raise AssertionError(f"6n drain {drain}, events {kinds}; want one "
                             f"SIGTERM drain after step {TRAINER_TERM_AT}")
    relaunch = _run_worker(run_dir, "--checks")
    return [victim, relaunch], dict(
        _trainer_summary(relaunch), victim_rc=rc,
        drained_at=[drain["epoch"], drain["step"]],
        drain_s=done["ts"] - drain["ts"],
        emergency_snapshot_ms=emerg["snapshot_ms"],
        emergency_write_ms=emerg["write_ms"], checks=relaunch["checks"],
        **_compare_runs(root, "sigterm", control, relaunch, lock))


def phase_trainer(dev, card):
    """6n: contrib.Trainer over phase 6l's AMP fused-CE Transformer, each
    run a `chip_smoke.py --trainer-worker` process on the card.  First an
    uninterrupted control, alone on the card (its timings are the
    phase's step and save figures); then, side by side, two chains that
    must end in the control's state (`_compare_runs`): `_kill_chain`
    (SIGKILL with a write in flight, relaunch) and `_term_chain` (SIGTERM
    drain, relaunch with the watchdog and Inferencer checks).  No torn
    directory is left.  The launches of every run that finished (the
    SIGKILL victim reports none) are summed."""
    import shutil
    import threading

    root = os.path.abspath(os.path.join(OUT_DIR, "trainer_6n"))
    shutil.rmtree(root, ignore_errors=True)
    log(f"phase 6n: contrib.Trainer, the AMP fused-CE Transformer (batch "
        f"{TRAIN_BATCH} x {TRAIN_ARCH['max_length']}, {TRAINER_BATCHES} "
        f"batches, batch {TRAINER_NAN_AT} poisoned), async saves every 2 "
        f"steps, kill and resume across processes on {card}")
    torch.cuda.empty_cache()
    res, finished, errors = {}, [], []
    lock = threading.Lock()
    try:
        control = _run_worker(os.path.join(root, "control"))
        finished.append(control)
        res["control"] = _trainer_summary(control)
        log(f"  control: {_trainer_line(res['control'])}")

        def chain(name, fn):
            try:
                runs, res[name] = fn(root, control, lock)
                finished.extend(runs)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=chain, args=a) for a in
                   (("sigkill", _kill_chain), ("sigterm", _term_chain))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        for name in ("control", "sigkill", "sigterm"):
            if _serials(os.path.join(root, name, "ck"))[1]:
                raise AssertionError(f"6n {name}: a torn directory left")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"  SIGKILL with serial 1 in flight, relaunched from "
        f"{res['sigkill']['resumed_from']}: "
        f"{_trainer_line(res['sigkill'])}")
    t = res["sigterm"]
    log(f"  SIGTERM after {TRAINER_TERM_AT} steps: drained at "
        f"{t['drained_at']} in {t['drain_s']:.3f} s (emergency save: "
        f"snapshot {t['emergency_snapshot_ms']:.1f} ms, write "
        f"{t['emergency_write_ms']:.1f} ms), exit {t['victim_rc']}; "
        f"relaunched: {_trainer_line(t)}")
    log(f"  (the two chains shared the card and the host)")
    ch = t["checks"]
    log(f"  checks: watchdog regions {ch['watchdog_regions']}, a hung "
        f"step raised StepHangError after {ch['hang_s']:.2f} s "
        f"({ch['hang']['budget_s']} s budget) with a step_hang event; "
        f"Inferencer loss {ch['inference_loss']:.6f} bit-equal to "
        f"clone(for_test=True)'s")
    launches = dict.fromkeys(control["counts"]["launches"], 0)
    for r in finished:
        for k, n in r["counts"]["launches"].items():
            launches[k] += n
    res["launches"] = launches
    log(f"  6n launches {launches}; variables differing from the control: "
        f"SIGKILL {len(res['sigkill']['vars_differing'])}, SIGTERM "
        f"{len(res['sigterm']['vars_differing'])}")
    return res

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--trainer-worker"]:
        return trainer_worker(sys.argv[2:])
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"phase 1: card: {card}")
    _set_matmul_flags()
    log(f"  TF32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}; bf16 reduced-precision "
        f"reduction "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}"
        f"; torch {torch.__version__} CUDA {torch.version.cuda}")

    from paddle_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    built = _build.build()
    log(f"phase 2: built {sorted(built)} in "
        f"{time.perf_counter() - t0:.2f} s (per source: "
        f"{ {k: round(v, 2) for k, v in built.items()} })")
    ptxas = {}
    for name in _build.KERNEL_SOURCES:
        # ptxas -v: registers, spills and shared memory per instantiation
        ptxas[name] = ptxas_summary(_build.build_log(name))
        for fn, used in ptxas[name]:
            log(f"  {name}: {fn}: {used}")
    paged = [("paged_attention", f"paged_split_kernel<{kv}, {d}>")
             for kv in ("f32", "bf16", "int8") for d in (32, 64, 128)]
    paged += [("paged_attention", f"paged_merge_kernel<{d}>")
              for d in (32, 64, 128)]
    for src, kern in (("flash_attention_fwd", "flash_fwd_bf16_kernel<"),
                      ("vocab_ce", "vocab_ce_fwd_kernel<"),
                      ("vocab_ce", "vocab_ce_dh_kernel<"),
                      ("vocab_ce", "vocab_ce_dw_kernel<"),
                      ("lstm", "lstm_fwd_kernel"),
                      ("lstm", "lstm_bwd_kernel"), *paged):
        if not any(fn.startswith(kern) for fn, _ in ptxas[src]):
            raise AssertionError(f"no ptxas line for {kern.rstrip('<')}")

    from paddle_tpu_torch.ops.kernels import vocab_ce as vk

    log(f"  vocab_ce: dynamic shared memory {vk.SMEM_BYTES} bytes a "
        f"block (one block per SM)")

    seconds = {}

    def timed(name, fn, *args, **kw):
        """fn(*args, **kw), its wall time logged and kept (the script's
        time budget, phase by phase)."""
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        log(f"  [{name}: {seconds[name]:.1f} s]")
        return res

    rows = timed("3", phase_kernels, dev)
    rows.update(timed("3b", phase_bwd_kernels, dev))
    flash_train_shapes = timed("3b fwd", flash_fwd_at_training_shapes, dev)
    flash_bwd_longctx = timed("3b T=8192", flash_bwd_at_longctx_shape, dev)
    flash_d128 = timed("3b D=128", flash_at_d128_shape, dev)
    log("phase 3f: the flash kernels at BERT-base's shape")
    flash_bert = timed("3f", flash_at_bert_shape, dev)
    bert_rows = [flash_bert[layout] for layout in ("nhtd", "nthd")]
    for name, key in (("flash_attention_bwd_dkv", "dkv_max_abs_err"),
                      ("flash_attention_bwd_dq", "dq_max_abs_err")):
        rows[name]["max_abs_err"] = max(
            [rows[name]["max_abs_err"]]
            + [r[key] for r in flash_bwd_longctx.values()]
            + [r[key] for r in flash_d128["bwd"]]
            + [r[key] for r in bert_rows])
    rows["flash_attention_fwd"]["max_abs_err"] = max(
        [rows["flash_attention_fwd"]["max_abs_err"]]
        + [r["max_abs_err"] for r in flash_d128["fwd"]]
        + [r["fwd_max_abs_err"] for r in bert_rows])
    bf16_rows, flash_bf16 = timed("3g", flash_bf16_cases, dev)
    rows.update(bf16_rows)
    rows.update(timed("3c", phase_vocab_kernels, dev))
    rows.update(timed("3d", phase_lstm_kernels, dev))
    refused = timed("3e", phase_refused_shapes, dev)
    stream = timed("4", phase_stream, dev)
    profile = timed("4b", phase_step_profile, dev)
    spec_stream = timed("4c", phase_speculative_stream, dev)
    oracle = timed("4d", phase_oracle_stream, dev)
    parity = timed("5", phase_card_vs_cpu, dev)
    train = timed("6", phase_train, dev, card)
    train_fused = timed("6c", phase_train, dev, card, "phase 6c",
                        dict(use_fused_ce=True),
                        profile="phase 6c, profiled")
    train_longctx = timed("6d", phase_train, dev, card, "phase 6d", LONGCTX,
                          batch=LONGCTX_BATCH, steps=LONGCTX_STEPS,
                          profile="phase 6d, profiled")
    train_lstm = timed("6e", phase_train_lstm, dev, card)
    train_bert = timed("6f", phase_train_bert, dev, card)
    train_parity = timed("7", phase_train_parity, dev)
    train_parity_fused = timed("7 fused CE", phase_train_parity, dev,
                               use_fused_ce=True)
    train_parity_qkv = timed("7 fused_qkv", phase_train_parity, dev,
                             fused_qkv=True)
    lstm_parity = timed("7c", phase_lstm_parity, dev)
    bert_parity = timed("7d", phase_bert_parity, dev)
    train_resnet = timed("6g", phase_train_resnet, dev, card)
    train_deepfm = timed("6h", phase_train_deepfm, dev, card)
    resnet_parity = timed("7e ResNet-50", phase_resnet_parity, dev)
    deepfm_parity = timed("7e DeepFM", phase_deepfm_parity, dev)
    train_amp = timed("6i", phase_train, dev, card, "phase 6i", AMP,
                      profile="phase 6i, profiled")
    train_bert_amp = timed("6j", phase_train_bert, dev, card,
                           label="phase 6j", overrides=AMP)
    train_resnet_amp = timed("6k", phase_train_resnet, dev, card,
                             label="phase 6k", overrides=AMP)
    amp_parity = timed("7f", phase_amp_parity, dev)
    train_resume = timed("6l", phase_resume, dev, card)
    train_guard = timed("6m", phase_guard, dev, card)
    train_trainer = timed("6n", phase_trainer, dev, card)

    fa = "paddle_tpu/ops/pallas/flash_attention.py"
    vc = "paddle_tpu/ops/pallas/vocab_ce.py"
    replaces = {
        "paged_attention": "paddle_tpu/ops/pallas/paged_attention.py:163",
        "paged_attention_verify":
            "paddle_tpu/ops/pallas/paged_attention.py:163",
        "flash_attention_fwd": f"{fa}:276",
        "flash_attention_bwd_dkv": f"{fa}:402",
        "flash_attention_bwd_dq": f"{fa}:458",
        "flash_attention_fwd_bf16": f"{fa}:276",
        "flash_attention_bwd_dkv_bf16": f"{fa}:402",
        "flash_attention_bwd_dq_bf16": f"{fa}:458",
        "vocab_ce_fwd": f"{vc}:146",
        "vocab_ce_dh": f"{vc}:204",
        "vocab_ce_dw": f"{vc}:235",
        "lstm_fwd": "paddle_tpu/ops/pallas/recurrence.py:216",
        "lstm_bwd": "paddle_tpu/ops/pallas/recurrence.py:247",
    }
    sources = {"paged_attention_verify": "paged_attention",
               "flash_attention_bwd_dkv": "flash_attention_bwd",
               "flash_attention_bwd_dq": "flash_attention_bwd",
               "flash_attention_fwd_bf16": "flash_attention_fwd",
               "flash_attention_bwd_dkv_bf16": "flash_attention_bwd",
               "flash_attention_bwd_dq_bf16": "flash_attention_bwd",
               "vocab_ce_fwd": "vocab_ce", "vocab_ce_dh": "vocab_ce",
               "vocab_ce_dw": "vocab_ce", "lstm_fwd": "lstm",
               "lstm_bwd": "lstm"}
    # each path's launches, its counts zeroed just before it: the flash
    # forward runs on the serving paths and the Transformer training
    # paths and BERT's, the LSTM kernels on the stacked-LSTM path, the
    # flash kernels' bf16 paths on the AMP Transformer's and BERT's; the
    # paged kernel at the step shape on the sequential engines and the
    # model drafter's steps, at the verify shape (paged_attention_verify)
    # on the speculative engines' verify runs
    paths = (stream, spec_stream, oracle, train, train_fused, train_longctx,
             train_lstm, train_bert, train_amp, train_bert_amp, train_resume,
             train_guard, train_trainer)
    launches = {k: sum(p["launches"].get(k, 0) for p in paths)
                for k in replaces}
    kern = []
    for name in replaces:
        r = rows[name]
        kern.append({"name": name, "route": "cuda",
                     "source": f"paddle_tpu_torch/csrc/"
                               f"{sources.get(name, name)}.cu",
                     "replaces": replaces[name],
                     "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "ptxas": ptxas, "kernels": rows,
                   "flash_fwd_training_shapes": flash_train_shapes,
                   "flash_bwd_longctx_shape": flash_bwd_longctx,
                   "flash_d128_shape": flash_d128,
                   "flash_bert_shape": flash_bert,
                   "refused_shapes": refused,
                   "stream": stream, "step_profile": profile,
                   "speculative_stream": spec_stream,
                   "oracle_model_drafter": oracle,
                   "card_vs_cpu": parity, "train": train,
                   "train_fused_ce": train_fused,
                   "train_longctx": train_longctx,
                   "train_lstm": train_lstm,
                   "train_bert": train_bert,
                   "train_lstm_card_vs_cpu": lstm_parity,
                   "train_card_vs_cpu": train_parity,
                   "train_fused_ce_card_vs_cpu": train_parity_fused,
                   "train_fused_qkv_card_vs_cpu": train_parity_qkv,
                   "train_bert_card_vs_cpu": bert_parity,
                   "train_resnet": train_resnet,
                   "train_deepfm": train_deepfm,
                   "train_resnet_card_vs_cpu": resnet_parity,
                   "train_deepfm_card_vs_cpu": deepfm_parity,
                   "flash_bf16": flash_bf16,
                   "train_amp": train_amp,
                   "train_bert_amp": train_bert_amp,
                   "train_resnet_amp": train_resnet_amp,
                   "train_amp_card_vs_cpu": amp_parity,
                   "train_resume": train_resume,
                   "train_guard": train_guard,
                   "train_trainer": train_trainer,
                   "phase_seconds": seconds,
                   "seconds": time.perf_counter() - t_start}, f, indent=1,
                  default=str)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
