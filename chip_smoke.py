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
   CE) at CUT_LAYERS + CUT_LAYERS layers under bf16 AMP with `amp.decorate(use_dynamic_loss_scaling=True)`
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
   own (`python3 chip_smoke.py --trainer-worker DIR ...`), three side
   by side on the card: an uninterrupted control (the phase's step and
   save timings, shared card: each save's blocking time against its
   background write, the step with and without a write in flight, the
   goodput categories, which must sum to the wall), a run SIGKILLed
   while its second async write is in flight (the writes held 1 s by
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
6o. gradient accumulation: the bench Transformer (dropout 0, CUT_LAYERS
   + CUT_LAYERS layers) at batch 64 as K = 1 and as K = 4 micro-batches of 16, float32 and bf16 AMP,
   3 steps each from the same weights (the full-batch run's noam
   counter advanced to match accumulation's K increments a step):
   losses within TOL_LOSS (AMP: TOL_AMP_LOSS) and parameters within
   4 * sum(lr); each flash kernel 4 times as often a step; step ms,
   peak device memory and a profiled window of each;
6p. recompute and pipeline scopes: phase 6d's long-context Transformer
   built plain, with `recompute=True`, with `pipeline=True` and plain
   again, 3 steps each from the same weights: losses and parameters
   against the plain run's (bit-equality reported), the flash forward
   twice a step per flash op under recompute, step ms and peak device
   memory;
6q. each update op of the other optimizers, ModelAverage and EMA on the
   card against the CPU at a 512 x 2048 parameter, sparse adagrad on a
   32000 x 512 table; ModelAverage and EMA on the bench Transformer for
   4 steps: `apply()` on the card (no host sync for ModelAverage, one
   for EMA) equal to the CPU's formula, `restore()` giving back the same
   tensors;
6r. the book models: the sequence tagger at the book's widths (hidden
   512, depth 8, batch 10), word2vec with NCE and the recommender, card
   against CPU from the same weights (losses within 1e-4; word2vec's
   finite, its NCE draws differing across devices, and its loss at one
   fixed draw lower after the steps than before), step ms;
6s. control flow, through machine translation at the widths of upstream
   Fluid's benchmark/fluid/models/machine_translation.py (embed and
   hidden 512, vocabularies 30000, batch 16, source and target length
   50): `seq_to_seq_net` (DynamicRNN) 3 Adam steps card against CPU
   from the same weights (losses within 1e-4), with step ms, idle share,
   kernels a step and peak memory; `beam_search_net` (While, tensor
   arrays, beam_search, beam_search_decode; beam 4, 50 steps) from the
   trained weights card against CPU (sentences equal, final scores
   within 1e-4), with decode ms and the host syncs a decode (one a
   condition check of the While); and a While of 8 iterations whose body
   calls flash_attention at the training shape: the forward kernel's
   launch count rises by exactly 8 and the output equals the plain
   version's (TOL_KERNEL);
6t. the switch-MoE Transformer (bench.py --moe-experts): phase 6's
   configuration with each of its 12 FFN sublayers a top-1 switch-MoE
   block of 8 experts (capacity factor 1.25, capacity 2560, aux weight
   0.01; moe_ffn routes by index); (a) MOE_STEPS timed steps float32,
   then under bf16 AMP, with 12 launches of each flash kernel a step
   (their bf16 paths under AMP), no plain or composed call, step ms,
   tokens/s, peak memory, a profiled window (idle share, kernels a
   step) and the last step's tokens a expert and tokens past capacity
   per layer; (b) card against CPU at CUT_LAYERS + CUT_LAYERS layers and
   2 x 64 tokens, dropout 0, 3 Adam
   steps, top-1 and top-2 (every moe_ffn's top_k set to 2), at phase
   7's tolerances, with each layer's routing compared token by token
   (a token routed to another expert must be a near-tie of its CPU
   logits, TOL_ROUTE_TIE); (c) each of the 85 ops of the registry's
   dense half (`dense_op_cases`) on the card against the CPU, outputs
   and gradients within TOL_DENSE, integers and bools exactly, random
   ops by shape, dtype and range;
6u. QAT and int8 serving, the reference bench's int8 line (bench.py:969-
   1043): (a) ResNet-50 at the bench's widths (flowers, 1000 classes)
   with QuantizeTranspiler before minimize, 3 momentum steps at batch 32
   (every loss finite, every moving-average scale state nonzero after
   step 1); then a freshly transpiled forward program, 3 calibration
   runs at batch 8, clone(for_test), save_inference_model and
   load_inference_model, convert_to_int8 (every conv2d and the
   classifier's mul converted, no fake-quantize op left, the weights
   int8 on the card); int8 inference at batch 8 and 64 timed beside the
   plain float32 program and the QDQ-simulated one, top-1 against the
   latter; at batch 8 the card against the same model loaded and
   converted on the CPU: the first quantized conv's int32 accumulators
   bit for bit, the logits within TOL_INT8_LOGITS, top-1, and the share
   of activation codes that differ, layer by layer; (b) the SRL tagger
   at the book's widths, crf_decoding into chunk_eval (IOB), card
   against CPU: paths and counts equal; the kernel counts zeroed before
   (a) and read after (b); (c) each of the 30 ops of the sequence,
   structured and quantize families (`seq_struct_quant_op_cases`: warpctc
   at B 16, T 400, 29 classes; quantized_conv2d at ResNet-50's stem, a
   3 x 3 x 512 layer and groups 32) on the card against the CPU,
   quantized_conv2d and quantized_matmul bit for bit;
6v. detection (the detection and vision_extra families): (a) Faster
   R-CNN ResNet-50-C4 at upstream Fluid PaddleCV/rcnn's training
   setting (`faster_rcnn`: one 800 x 1333 image with 8 seeded gt boxes,
   res2-res4 of models/resnet.py's bottleneck blocks with frozen
   affine_channel batch norms, an RPN of 15 anchors a cell,
   rpn_target_assign 256 anchors, generate_proposals 12000 / 2000 at NMS
   0.7, generate_proposal_labels 512 RoIs at 81 classes, roi_align 14 x
   14, res5 and the two heads; momentum 0.01 with L2 1e-4):
   FRCNN_STEPS steps with use_random (finite losses, sampled counts
   within their budgets, each step's ms and NMS iterations), then one
   step with use_random=False whose anchor_generator,
   generate_proposals, rpn_target_assign, generate_proposal_labels and
   roi_align run again on the CPU from the card's inputs (integers
   equal, boxes within TOL_BOX, the rest within TOL_DENSE, roi_align's
   input gradient on res4's first FRCNN_ALIGN_CHANNELS channels, within
   TOL_DENSE plus TOL_GRAD_SHARE of its largest); two
   more steps timed and a profiled window;
   (b) the detection program at the test setting (6000 / 1000
   proposals, box_coder decoding, box_clip, softmax, multiclass_nms at
   score 0.05, NMS 0.5, keep 100, detection_map against the gts), the
   ms and NMS iterations of generate_proposals and multiclass_nms each
   alone, both card against CPU; the kernel counts zeroed before (a)
   and read after (b); (c) each of the 27 ops (`detection_op_cases`, at
   MobileNet-SSD's, YOLOv3-608's and Faster R-CNN's widths) and
   ssd_loss per image over a batch of 8 on the card against the CPU;
4e. (A) the serving fleet at the reference bench's widths
   (bench_serving_fleet: DecoderLM vocab 8192, 4 layers, d_model 512,
   bf16 KV; 8 slots, pages of 16, max_len 256, prefill buckets 32 and
   64, decode chunk 8): 48 requests through one DecodeEngine (the
   control), then through a two-replica Fleet on the card with replica
   0 killed (`chaos.kill_replica`) after half the stream and the same
   weights reloaded from a sharded checkpoint (`fleet.reload`) in the
   middle of the rest: every response's tokens equal the control's, no
   client failure, a failover, zero post-warmup compiles fleet-wide, the
   survivor's model_version moved; requests/s, TTFT and TPOT, the reload
   pause and the failover, hedge and retry counts;
4f. (B) ResNet-50 served (bench_serving_engine at batch 32): the
   per-request Predictor over 24 images, then the ServingEngine (ladder
   1 and 32, max_wait_ms 5, queue 128) over 192 requests from 64 client
   threads, each response against Predictor.run on its image alone
   within TOL_SERVE_BATCHED (and a batch run with TF32 on outside it),
   zero post-warmup compiles; requests/s,
   latency, batching_speedup, occupancy and padding waste; then an
   `enable_int8()` Predictor on 6u's QAT export at batch 8, bit for bit
   against Executor.run of the same convert_to_int8 program;
4g. disaggregated serving (bench_serving_disagg at 4e's widths): ROADMAP
   C15's measurement (a decode step's logits at 16 rows against two
   8-row steps, with and without `row_block` 8; the blocked run must be
   bit-equal); `paged_kv_import` on the card bit for bit against the
   CPU for float32, bf16 and int8 pools and scales; the 48-request
   stream through a unified two-replica Fleet (the control), then a
   DisaggFleet of one prefill worker (8 slots) and one decode worker
   (16 slots, step row block 8): tokens equal to the control's 48 of
   48, 48 handoffs, no client failure, zero post-warmup compiles, its
   /metrics scraped once over 127.0.0.1 with the disagg_* families;
   then one prefill and two decode workers of 8 slots, decode worker 0
   killed once half the requests completed: the control's tokens, no
   client failure, a decode failover; TTFT and tokens/s of both fleets,
   handoff ms, pages and bytes, the flash forward and paged launches;
6w. data parallelism (parallel.CompiledProgram) on the phase-6
   Transformer at the bench's widths and CUT_LAYERS + CUT_LAYERS layers,
   dropout 0, Adam with noam, global
   batch DP_BATCH: (a) one process as trainer 0 of 1 through
   `init_distributed` (NCCL), `CompiledProgram(...).with_data_parallel(
   mesh=make_mesh({"dp": 1}))` for DP_STEPS steps, every fetch and
   parameter bit for bit the plain `Executor.run`'s; (b) two ranks on
   the one card (`chip_smoke.py --dp-worker DIR RANK PORT` each, gloo
   through the host: NCCL refuses two ranks of a communicator on one
   device), half the batch each, in the default mode, grad_sync "bf16"
   and "int8": the ranks' parameters bit-identical after every run,
   step 1's synchronized gradients bit for bit the plain mean of the
   two ranks' local gradients (int8: its two quantized phases) and
   within TOL_DP_GRAD (int8 TOL_DP_GRAD_INT8) of (a)'s by relative L2,
   losses within TOL_DP_LOSS of (a) and parameters within 4 * sum(lr)
   (default and bf16), int8 within TOL_DP_INT8 of bf16 and descending,
   each flash kernel once a flash op a step on each rank; each rank's
   step ms and gradient-exchange ms; (c) 7e's ResNet-50 (2 x 224^2, lr
   RESNET_PARITY_LR) at dp = 2 in the default mode against the one
   process's global batch on the card: losses and every batch norm's
   moving statistics within TOL_RESNET_LOSS and TOL_RESNET_STATS
   (`chip_smoke.py --phase 6w` builds the kernels and runs 6w alone);
6y. the cost, memory and trace planes (run after 7d): (a) the bench
   Transformer's steps under `fluid.profiler.profiler`, the per-op
   table's top rows, every flash kernel's device time on a
   flash_attention row, forward and backward, `[unattributed]` and the
   table's total against phase 6's own profile; (b) `op_cost_table`
   joined to a profiled step, unfused and fused CE, the kernel ops at
   the registry's flops, no row above the card's peak, the step's flops
   and MFU, card against CPU per-op flops at 2+2 layers; (c) the memory
   ledger against the allocator, `plan_fit` at batch 64 from probes 2
   and 4 against the allocator, the scope, run counter and counts
   untouched; (d) the ServingEngine's and DecodeEngine's gates on the
   card's budget; (e) the stacked LSTM's rows, card and CPU
   (`chip_smoke.py --phase 6y` runs it alone);
6z. the health plane, the gang supervisor and the divergence autopilot
   (run after 6x): a store client whose store's host process is killed
   raises, call by call, only what the health plane catches (ROADMAP
   C24); then on the float32 fused-CE Transformer at CUT_LAYERS +
   CUT_LAYERS layers with the update guard: (c) a Trainer's steps with
   the health plane off, then on (over chaos.FakeKv, its threads
   running): the same launches and host synchronizations; (a)
   `Trainer(autopilot=AutopilotConfig(skip_streak=1))` over 12 batches,
   batch 5 with one id outside the vocabulary, async checkpoints every
   2 steps: one rollback to serial 1, the window [4, 6) quarantined,
   every persistable bit for bit a control whose reader never yields
   batches 4 and 5, recovery_rollback before data_quarantine, recovery
   time in the goodput ledger, recovery_autopilot_enabled 1 and
   recovery_rollbacks_total 1; (b) `Supervisor(host_coordinator=True,
   max_restarts=1)` over two `chip_smoke.py --gang-worker` ranks on the
   card (gloo, the health plane at 0.25 s x 4 misses, each rank a
   Trainer on its own batches), rank 1 SIGKILLed after its step 8
   (`chaos.arm_kill_rank_env`): the survivor's PeerLostError names it
   within the miss window plus two polls, exit 43, one relaunch, each
   rank resumed from its newest valid serial and ended DONE with every
   persistable bit for bit that rank's Trainer run uninterrupted in
   this process; detection latency, relaunch-to-first-step, backoff and
   each rank's goodput categories logged (`chip_smoke.py --phase 6z`
   runs it alone);
8. the periphery (run after 6z), on 6e's stacked LSTM at its full
   width: (a) 8 RecordIO shards of MultiSlot lines from the synthetic
   imdb reader, written by the native codec, trained 2 epochs through
   `AsyncExecutor` at 4 parser threads (16 batches an epoch, the LSTM
   kernels 3 + 3 a step, no composed call, the epoch-2 mean loss below
   epoch 1's); the same startup state through `AsyncExecutor` at one
   thread and through a plain `Executor.run` loop over the parsed
   batches, every persistable bit for bit; examples/s, device idle
   share of a profiled window file-fed at 1 and 4 threads and fed from
   memory, parse ms a batch and queue depths; (b) a `DeviceFeeder` over
   a reader delayed one step at capacity 1 and 4 against N x max and
   N x sum, whether its copies overlap kernels in a profile; every
   batch on the card, `reader_queue_speed_test_mode` serving batch 1,
   an injected `feeder:producer` error retried with the same losses;
   (c) an eager step (the one-layer model's forward ops traced under
   `imperative.guard()`): every parameter's .grad and an eager Adam
   step within TOL_EAGER of the static program's, the LSTM kernels once
   forward and once backward; (d) `FLAGS.check_nan_inf` naming a planted
   NaN parameter, `FLAGS.benchmark` adding one device synchronization a
   run, a child process under FLAGS_fraction_of_tpu_memory_to_use=0.5
   refused an allocation over the cap; (e) `metrics.Auc` and
   `metrics.Accuracy` over the untrained model's fetches against the
   in-graph auc op and the fetched predictions, within TOL_METRIC
   (`chip_smoke.py --phase 8` runs it alone);
9. prints one `kernels` JSON line (the launches of every path above,
   6l-6z, 4e-4g and 8 included), the card line, and as its last line
   {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no
result line; without CUDA it exits 1 at once.  Details go to
chip_smoke_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
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
# the depth of the Transformer paths after phase 6k that do not measure
# the bench model itself (6l-6o, 6t (b), 6w, 6x (d)), cut from 6 + 6 to
# keep the whole script well inside its time limit; widths unchanged
CUT_LAYERS = 2
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
                batch=TRAIN_BATCH, steps=TRAIN_STEPS, profile="phase 6b",
                extra_fetch=None):
    """Train the bench Transformer (with `overrides`) on the card
    (`_train_on_card`); `profile` labels one profiled window after the
    timed steps (None: no window); `extra_fetch(main)` names variables
    fetched once after the timed steps (res["extra"])."""
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
                         batch * t_len, steps, np.log(vocab), profile,
                         extra_fetch and extra_fetch(main))
    res.update(batch=batch, max_length=t_len, overrides=overrides)
    return res


def _train_on_card(dev, card, main, startup, loss, feed, tokens_per_step,
                   steps, want_first, profile, extra=None):
    """Run `startup` and one warmup step on the card (its loss within 0.5
    of `want_first`), then `steps` timed steps with the launch counts
    zeroed just before them: each flash op launches the flash forward,
    dK/dV and dQ kernels once a step (their bf16 paths under AMP, and
    then no float32 flash launch), each fused-CE op the vocab-CE
    forward, dh and dW kernels once, and nothing takes a plain or
    composed path.  `profile` labels one profiled window after them
    (None: no window); the variables named in `extra` are fetched once
    after the timed steps, before the window (res["extra"], numpy)."""
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
    if extra:
        res["extra"] = dict(zip(extra, exe.run(main, feed=feed,
                                               fetch_list=list(extra),
                                               scope=scope)))
    if profile:
        res["profile"] = _profile_train_step(exe, main, feed, loss, scope,
                                             label=profile)
    return res


def _profile_train_step(exe, main, feed, loss, scope, steps=2,
                        label="phase 6b", **run_kw):
    """6b: host ms against device-busy ms of training steps, and the
    costliest device kernels (torch.profiler, as phase 4b); `run_kw`
    goes to each `exe.run` (accumulation_steps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    **run_kw)
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
                       steps=PARITY_STEPS, extra=()):
    """`steps` steps of `main` on the card and on the CPU from the
    same weights (drawn on the card by `startup`): (card, cpu, arrays,
    params), each run a dict of the losses named in `loss_names` at
    every step, the step-1 gradients, the step-1 values of the names in
    `extra` (numpy) and the final parameters and values of the names in
    `state`; `arrays` the starting values."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import params_from_arrays

    init = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
    arrays = {n: v.cpu().numpy() for n, v in init.vars.items()
              if isinstance(v, torch.Tensor)}
    params = [p.name for p in main.all_parameters()]
    n_loss = len(loss_names)
    fetch = list(loss_names) + [f"{p}@GRAD" for p in params] + list(extra)
    n_grad = n_loss + len(params)
    runs = {}
    for place, device in ((pt.CUDAPlace(0), dev), (pt.CPUPlace(), "cpu")):
        scope = pt.Scope()
        for n, t in params_from_arrays(arrays, device, program=main).items():
            scope.set_var(n, t)
        exe = pt.Executor(place)
        losses, grads, first = [], None, None
        for step in range(steps):
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            losses.append([float(x.reshape(-1)[0]) for x in out[:n_loss]])
            if step == 0:
                grads = out[n_loss:n_grad]
                first = dict(zip(extra, out[n_grad:]))
        runs[str(device)] = dict(
            losses=losses, grads=grads, extra=first,
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
    """(main, startup, model) of the bench Transformer at CUT_LAYERS +
    CUT_LAYERS layers with the fused CE under bf16 AMP: build_model's
    graph and optimizer (noam x 2.0, Adam 0.9/0.997/1e-9), the optimizer
    wrapped by amp.decorate with use_dynamic_loss_scaling=`guard`
    (False: phase 6i's plain AMP)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp, layers, optimizer
    from paddle_tpu_torch.models import transformer

    arch = dict(TRAIN_ARCH, use_fused_ce=True, n_layer=CUT_LAYERS)
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
        f"at {CUT_LAYERS}+{CUT_LAYERS} layers under dynamic loss scaling "
        f"(batch {TRAIN_BATCH} x "
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
        f"Transformer at {CUT_LAYERS}+{CUT_LAYERS} layers, batch "
        f"{TRAIN_BATCH} x {TRAIN_ARCH['max_length']})")
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
TRAINER_SLOW_WRITE_S = 1.0       # 6n's SIGKILL victim: writes held 1 s
TRAINER_KILL_AT = 4              # ... killed once serial 1 is in flight
TRAINER_TERM_AT = 6              # 6n's SIGTERM victim: after 6 steps,
TRAINER_TERM_PACE_S = 0.3        # each step's handler held 0.3 s so the
#                                  signal lands before its boundary
TRAINER_HANG_BUDGET_S = 2.0      # the in-worker DispatchWatchdog's step
TRAINER_WORKER_TIMEOUT_S = 300


def trainer_funcs():
    """(train_func, optimizer_func) of build_guarded's graph for
    contrib.Trainer at CUT_LAYERS + CUT_LAYERS layers:
    build_model's forward and loss, then Adam under noam x 2.0 wrapped
    by amp.decorate with dynamic loss scaling."""
    from paddle_tpu_torch import amp, layers, optimizer
    from paddle_tpu_torch.models import transformer

    arch = dict(TRAIN_ARCH, use_fused_ce=True, n_layer=CUT_LAYERS)

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
    arch = dict(TRAIN_ARCH, use_fused_ce=True, dropout=0.0,
                n_layer=CUT_LAYERS)

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
    held TRAINER_SLOW_WRITE_S), then relaunched to its end; `control()`
    waits for the control's run."""
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
        **_compare_runs(root, "sigkill", control(), relaunch, lock))


def _term_chain(root, control, lock):
    """A worker SIGTERMed after TRAINER_TERM_AT steps: it drains to an
    emergency checkpoint and exits with PREEMPT_EXIT_CODE; relaunched
    to its end with `--checks`; `control()` waits for the control's
    run."""
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
        **_compare_runs(root, "sigterm", control(), relaunch, lock))


def phase_trainer(dev, card):
    """6n: contrib.Trainer over phase 6l's AMP fused-CE Transformer, each
    run a `chip_smoke.py --trainer-worker` process on the card.  An
    uninterrupted control and, side by side with it, two chains that
    must end in the control's state (`_compare_runs`, once the control
    is done): `_kill_chain` (SIGKILL with a write in flight, relaunch)
    and `_term_chain` (SIGTERM drain, relaunch with the watchdog and
    Inferencer checks).  The three first processes share the card and
    the host (their step and save figures with them).  No torn
    directory is left.  The launches of every run that finished (the
    SIGKILL victim reports none) are summed."""
    import shutil
    import threading

    root = os.path.abspath(os.path.join(OUT_DIR, "trainer_6n"))
    shutil.rmtree(root, ignore_errors=True)
    log(f"phase 6n: contrib.Trainer, the AMP fused-CE Transformer at "
        f"{CUT_LAYERS}+{CUT_LAYERS} layers (batch "
        f"{TRAIN_BATCH} x {TRAIN_ARCH['max_length']}, {TRAINER_BATCHES} "
        f"batches, batch {TRAINER_NAN_AT} poisoned), async saves every 2 "
        f"steps, kill and resume across processes on {card}")
    torch.cuda.empty_cache()
    res, finished, errors = {}, [], []
    lock = threading.Lock()
    done, box = threading.Event(), {}
    try:
        def run_control():
            try:
                box["control"] = _run_worker(os.path.join(root, "control"))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
            finally:
                done.set()

        def control():
            done.wait()
            if "control" not in box:
                raise AssertionError("6n: the control run failed")
            return box["control"]

        def chain(name, fn):
            try:
                runs, res[name] = fn(root, control, lock)
                finished.extend(runs)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=run_control)] + [
            threading.Thread(target=chain, args=a) for a in
            (("sigkill", _kill_chain), ("sigterm", _term_chain))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        control = box["control"]
        finished.append(control)
        res["control"] = _trainer_summary(control)
        log(f"  control: {_trainer_line(res['control'])}")
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
    log(f"  (the control and the two chains shared the card and the "
        f"host)")
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

# -- phases 6o-6r: accumulation, recompute, optimizers, book models -------

ACCUM_K = 4          # 6o: batch 64 as 4 micro-batches of 16
ACCUM_STEPS = 3      # 6o, 6p: steps held against the plain run
LR_COUNTER = "@lr_decay_counter@"
# 6q: each update op card vs CPU at a Transformer FFN weight's size;
# elementwise float32 (lars_momentum's two norms sum 1M terms in another
# order), so within 1e-5 of the CPU's max |value|
OPT_SHAPE = (512, 2048)
TOL_OPT = 1e-5
AVG_STEPS = 4        # 6q: ModelAverage and EMA on the bench Transformer
# 6r: the sequence tagger at the book's widths (the reference's
# test_label_semantic_roles.py: word_dim 32, mark_dim 5, hidden_dim 512,
# depth 8, batch 10; the conll05 dictionaries are not in the repository,
# so build_model's dictionary sizes), word2vec and the recommender at
# their build_model defaults
SRL_ARCH = dict(word_dim=32, mark_dim=5, hidden_dim=512, depth=8)
SRL_BATCH = 10
BOOK_STEPS = 3
W2V_STEPS = 20
TOL_BOOK = 1e-4      # card vs CPU losses, relative to max(1, |loss|)


def _steps_on_card(exe, main, feed, loss, scope, steps, k=1,
                   counter_extra=0, peaks=None):
    """`steps` steps; each one's loss (a host read ends it) and wall ms.
    `counter_extra` advances the noam counter before each step; a list
    `peaks` gets each step's peak device memory (the peak reset before
    the step)."""
    losses, ms = [], []
    for _ in range(steps):
        if counter_extra:
            c = scope.find_var(LR_COUNTER)
            scope.set_var(LR_COUNTER, c + counter_extra)
        torch.cuda.synchronize()
        if peaks is not None:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                      return_numpy=False, accumulation_steps=k)
        losses.append(float(out[0].reshape(())))
        ms.append((time.perf_counter() - t0) * 1e3)
        if peaks is not None:
            peaks.append(torch.cuda.max_memory_allocated())
    return losses, ms


def phase_accumulate(dev, card, label="phase 6o", overrides=None):
    """6o: the bench Transformer (dropout 0) for ACCUM_STEPS steps at
    batch 64 (K = 1) and as ACCUM_K micro-batches of 16 from the same
    weights.  The noam counter is a persistable forward output, which
    accumulation threads through the micro-batches (K increments a
    step, as in the reference), so the full-batch run's counter is
    advanced K - 1 before each step and both follow the same rates.
    Checks: losses within TOL_LOSS (AMP: TOL_AMP_LOSS) and parameters
    within 4 * sum(lr); each flash kernel K times a step as often as at
    K = 1, no plain or composed call.  Reports step ms, peak device
    memory and a profiled window (idle share, kernels a step) of each."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import kernels

    overrides = overrides or {}
    amp = bool(overrides.get("use_amp"))
    log(f"{label}: gradient accumulation, the bench Transformer at batch "
        f"{TRAIN_BATCH} as K = 1 and K = {ACCUM_K} micro-batches, "
        f"{CUT_LAYERS}+{CUT_LAYERS} layers, "
        f"{'bf16 AMP' if amp else 'f32'}, dropout 0, {ACCUM_STEPS} steps")
    main, startup, model = build_training(dropout=0.0, n_layer=CUT_LAYERS,
                                          **overrides)
    loss = model["loss"]
    feed = _transformer_feed(dev)
    exe = pt.Executor(pt.CUDAPlace(0))
    init = pt.Scope()
    exe.run(startup, scope=init)
    params = [p.name for p in main.all_parameters()]
    runs = {}
    for k in (1, ACCUM_K):
        scope = _clone_scope(init)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_counts()
        losses, ms = _steps_on_card(exe, main, feed, loss, scope,
                                    ACCUM_STEPS, k,
                                    counter_extra=ACCUM_K - k)
        counts = _check_launches(f"{label} K={k}", main, ACCUM_STEPS * k)
        peak = torch.cuda.max_memory_allocated(dev)
        runs[k] = dict(losses=losses, step_ms=ms, peak_mem_bytes=peak,
                       launches=counts["launches"],
                       params={n: scope.find_var(n) for n in params})
        log(f"  K={k}: losses {losses}, step ms {[round(x, 2) for x in ms]}"
            f", peak device memory {peak / 1e9:.3f} GB")
        runs[k]["profile"] = _profile_train_step(
            exe, main, feed, loss, scope, label=f"{label} K={k}, profiled",
            accumulation_steps=k)
        del scope
    a, b = runs[ACCUM_K], runs[1]
    tol = TOL_AMP_LOSS if amp else TOL_LOSS
    loss_err = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    bound = 4 * sum(_noam_lr(s * ACCUM_K, TRAIN_ARCH["d_model"])
                    for s in range(1, ACCUM_STEPS + 1)) + 1e-6
    p_err = max(_differ(a["params"], b["params"]).values(), default=0.0)
    log(f"  K={ACCUM_K} against K=1: losses max abs err {loss_err:.3e} "
        f"(tol {tol:g}), parameters max abs err {p_err:.3e} (bound "
        f"{bound:.3e}); peak memory {a['peak_mem_bytes'] / 1e9:.3f} against "
        f"{b['peak_mem_bytes'] / 1e9:.3f} GB on {card}")
    if not (loss_err <= tol and p_err <= bound):
        raise AssertionError(f"{label}: accumulation differs from the full "
                             f"batch: losses {loss_err}, params {p_err}")
    res = {"k": ACCUM_K, "steps": ACCUM_STEPS, "loss_max_abs_err": loss_err,
           "param_max_abs_err": p_err, "param_bound": bound,
           "launches": {n: a["launches"][n] + b["launches"][n]
                        for n in a["launches"]},
           "overrides": overrides}
    for k, r in runs.items():
        res[f"k{k}"] = {key: v for key, v in r.items() if key != "params"}
    return res


def phase_recompute(dev, card):
    """6p: phase 6d's long-context Transformer (T 8192, batch 2, flash,
    fused CE, dropout 0.1) built plain, with `recompute=True`, with
    `pipeline=True`, and plain again (the spread of two plain runs),
    ACCUM_STEPS steps each from the same weights.  Checks: each run's
    losses within TOL_LOSS and parameters within 4 * sum(lr) of the
    plain run's (bit-equality reported); under recompute the flash
    forward launches twice a step per flash op, the backward pair and
    the vocab-CE kernels once, no plain or composed call.  Reports step
    ms and peak device memory."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import kernels

    log(f"phase 6p: recompute and pipeline scopes on phase 6d's long-"
        f"context Transformer (batch {LONGCTX_BATCH} x "
        f"{LONGCTX['max_length']}), {ACCUM_STEPS} steps each")
    v = TRAIN_ARCH["trg_vocab_size"]
    feed = {n: torch.as_tensor(a).to(dev) for n, a in
            transformer.make_fake_batch(LONGCTX_BATCH,
                                        LONGCTX["max_length"], v,
                                        v).items()}
    exe = pt.Executor(pt.CUDAPlace(0))
    arrays, runs = None, {}
    for name, kw in (("plain", {}), ("recompute", dict(recompute=True)),
                     ("pipeline", dict(pipeline=True)), ("plain2", {})):
        main, startup, model = build_training(**LONGCTX, **kw)
        scope = pt.Scope()
        if arrays is None:
            exe.run(startup, scope=scope)
            arrays = _clone_scope(scope)
        else:
            scope = _clone_scope(arrays)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        start = torch.cuda.memory_allocated(dev)
        kernels.reset_counts()
        peaks = []
        losses, ms = _steps_on_card(exe, main, feed, model["loss"], scope,
                                    ACCUM_STEPS, peaks=peaks)
        peak = max(peaks)
        counts = kernels.counts()
        want = _want_launches(main, ACCUM_STEPS)
        if name == "recompute":
            want["flash_attention_fwd"] *= 2
        la, pl, co = counts["launches"], counts["plain"], counts["composed"]
        if la != want or max(pl.values()) or max(co.values()):
            raise AssertionError(f"phase 6p {name}: launches {counts}, "
                                 f"want {want}")
        runs[name] = dict(losses=losses, step_ms=ms, peak_mem_bytes=peak,
                          step_peak_mem_bytes=peaks,
                          start_mem_bytes=start, launches=la,
                          state={n: scope.find_var(n) for n in
                                 (p.name for p in main.all_parameters())})
        log(f"  {name}: losses {losses}, step ms "
            f"{[round(x, 2) for x in ms]}, peak device memory a step "
            f"{[round(x / 1e9, 3) for x in peaks]} GB (allocated at the "
            f"start {start / 1e9:.3f} GB); flash forward "
            f"{la['flash_attention_fwd'] // ACCUM_STEPS} a step, dK/dV "
            f"{la['flash_attention_bwd_dkv'] // ACCUM_STEPS}")
        del scope
    plain = runs["plain"]
    bound = 4 * sum(_noam_lr(s, TRAIN_ARCH["d_model"])
                    for s in range(1, ACCUM_STEPS + 1)) + 1e-6
    res = {"steps": ACCUM_STEPS}
    for name in ("recompute", "pipeline", "plain2"):
        r = runs[name]
        loss_err = max(abs(x - y) for x, y in zip(r["losses"],
                                                  plain["losses"]))
        diff = _differ(r["state"], plain["state"])
        p_err = max(diff.values(), default=0.0)
        bits = not diff and r["losses"] == plain["losses"]
        log(f"  {name} against plain: losses max abs err {loss_err:.3e}, "
            f"parameters max abs err {p_err:.3e} (bound {bound:.3e}); "
            f"bit for bit: {bits}")
        if not (loss_err <= TOL_LOSS and p_err <= bound):
            raise AssertionError(f"phase 6p: {name} differs from the plain "
                                 f"run: losses {loss_err}, params {p_err}")
        res[name] = dict(loss_max_abs_err=loss_err, param_max_abs_err=p_err,
                         bit_equal=bits)
    for name, r in runs.items():
        res.setdefault(name, {}).update(
            {k: v for k, v in r.items() if k != "state"})
    res["launches"] = {k: runs["plain"]["launches"][k]
                       + runs["recompute"]["launches"][k]
                       + runs["pipeline"]["launches"][k]
                       + runs["plain2"]["launches"][k]
                       for k in runs["plain"]["launches"]}
    log(f"  peak device memory: recompute "
        f"{runs['recompute']['peak_mem_bytes'] / 1e9:.3f} GB against plain "
        f"{plain['peak_mem_bytes'] / 1e9:.3f} GB; steady step "
        f"{np.mean(runs['recompute']['step_ms'][1:]):.2f} against "
        f"{np.mean(plain['step_ms'][1:]):.2f} ms on {card}")
    return res


def _opt_cases(rng):
    """{op: (inputs, attrs)} of each update op the port added with the
    other optimizers, ModelAverage and EMA, at OPT_SHAPE."""
    def t(lo=None):
        a = rng.standard_normal(OPT_SHAPE).astype(np.float32)
        return np.abs(a) + lo if lo is not None else a

    p, g, lr = t(), t(), np.array([0.01], np.float32)
    base = {"Param": p, "Grad": g, "LearningRate": lr}
    one = np.array([3.0], np.float32)
    return {
        "lars_momentum": (dict(base, Velocity=t()),
                          dict(mu=0.9, lars_coeff=0.001,
                               lars_weight_decay=0.0005)),
        "adamax": (dict(base, Moment=t(), InfNorm=t(0.1),
                        Beta1Pow=np.array([0.81], np.float32)), {}),
        "adagrad": (dict(base, Moment=t(0.1)), {}),
        "decayed_adagrad": (dict(base, Moment=t(0.1)), {}),
        "adadelta": (dict(base, AvgSquaredGrad=t(0.1),
                          AvgSquaredUpdate=t(0.1)), {}),
        "rmsprop": (dict(base, MeanSquare=t(2.0), Moment=t(),
                         MeanGrad=t()), dict(momentum=0.9, centered=True)),
        "ftrl": (dict(base, SquaredAccumulator=t(0.1),
                      LinearAccumulator=t()), dict(l1=0.1, l2=0.1)),
        "proximal_gd": (base, dict(l1=0.1, l2=0.1)),
        "proximal_adagrad": (dict(base, Moment=t(0.1)),
                             dict(l1=0.1, l2=0.1)),
        "average_accumulates": (
            {"Param": p, "Sum1": t(), "Sum2": t(), "Sum3": t(),
             "NumAccumulates": one, "OldNumAccumulates": one,
             "NumUpdates": one},
            dict(average_window=0.5, min_average_window=2,
                 max_average_window=4)),
        "ema_accumulate": ({"Param": p, "Ema": t()}, dict(decay=0.999)),
    }


def _swap_check(name, avg, exe, scope, params, want, dev, max_syncs):
    """avg.apply() on the card: its synchronizing calls (at most
    `max_syncs`), the installed values against `want` (CPU, float32)
    and their device; then restore(): the very tensors back, bits
    unchanged."""
    import paddle_tpu_torch as pt

    before = {n: scope.find_var(n) for n in params}
    bits = {n: v.clone() for n, v in before.items()}
    with pt.scope_guard(scope):
        ctx = avg.apply(exe, need_restore=False)
        t0 = time.perf_counter()
        syncs = _sync_warnings(ctx.__enter__)
        torch.cuda.synchronize()
        apply_ms = (time.perf_counter() - t0) * 1e3
        got = {n: scope.find_var(n) for n in params}
        err = max(float((got[n].cpu() - want[n]).abs().max()
                        / max(float(want[n].abs().max()), 1e-30))
                  for n in params)
        on_card = all(got[n].device == dev for n in params)
        ctx.__exit__(None, None, None)
        avg.restore(exe)
    same = all(scope.find_var(n) is before[n]
               and torch.equal(scope.find_var(n), bits[n]) for n in params)
    log(f"  {name}: apply() {apply_ms:.2f} ms, {len(syncs)} host syncs "
        f"{syncs}, max err {err:.3e} of max |value| against the CPU, on "
        f"the card {on_card}; restore() gave back the same tensors, bits "
        f"unchanged: {same}")
    if not (len(syncs) <= max_syncs and err <= 1e-6 and on_card and same):
        raise AssertionError(f"phase 6q: {name} apply/restore: syncs "
                             f"{syncs}, err {err}, on card {on_card}, "
                             f"restored {same}")
    return dict(apply_ms=apply_ms, host_syncs=len(syncs), max_rel_err=err)


def phase_optimizers(dev, card):
    """6q: each update op the slice added on the card against the same
    op on the CPU at OPT_SHAPE (sparse adagrad too); then ModelAverage
    and EMA on the bench Transformer (dropout 0) for AVG_STEPS steps:
    `apply()` swaps in values computed on the card (ModelAverage with no
    host sync, EMA with one) equal to the CPU's formula on the same
    accumulators, and `restore()` gives back the same tensors."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.registry import OpContext, get_op_impl
    from paddle_tpu_torch.core.selected_rows import SparseGrad
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import kernels

    log(f"phase 6q: the optimizer ops card vs CPU at {OPT_SHAPE}; "
        f"ModelAverage and EMA on the bench Transformer")
    rng = np.random.default_rng(7)
    ops = {}
    for op, (ins, attrs) in _opt_cases(rng).items():
        card_out = run_op(op, ins, attrs, dev)
        cpu_out = run_op(op, ins, attrs, "cpu")
        err = 0.0
        for slot, vals in cpu_out.items():
            want = vals[0].float()
            got = card_out[slot][0].float().cpu()
            err = max(err, float((got - want).abs().max()
                                 / max(float(want.abs().max()), 1e-30)))
        ops[op] = err
    # sparse adagrad: 4096 looked-up rows of a 32000 x 512 table, repeats
    table = rng.standard_normal((32000, 512)).astype(np.float32)
    ids = rng.integers(0, 32000, 4096)
    rows = rng.standard_normal((4096, 512)).astype(np.float32)
    outs = {}
    for device in (dev, "cpu"):
        g = SparseGrad(torch.as_tensor(ids).to(device),
                       torch.as_tensor(rows).to(device), table.shape)
        ins = {"Param": [torch.as_tensor(table).to(device)], "Grad": [g],
               "Moment": [torch.full(table.shape, 0.1, device=device)],
               "LearningRate": [torch.tensor([0.01], device=device)]}
        outs[str(device)] = get_op_impl("adagrad")(
            OpContext((0, 0), 0, device=device), ins, {})
    ops["adagrad sparse"] = max(
        float((outs[str(dev)][s][0].cpu() - outs["cpu"][s][0]).abs().max()
              / float(outs["cpu"][s][0].abs().max()))
        for s in ("ParamOut", "MomentOut"))
    log(f"  update ops, max |card - cpu| / max |cpu|: "
        f"{ {k: f'{v:.2e}' for k, v in ops.items()} } (tol {TOL_OPT:g})")
    bad = {k: v for k, v in ops.items() if not v <= TOL_OPT}
    if bad:
        raise AssertionError(f"phase 6q: update ops differ: {bad}")

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = transformer.build_model(**dict(TRAIN_ARCH, dropout=0.0))
        ma = pt.optimizer.ModelAverage(0.15, min_average_window=2,
                                       max_average_window=3)
        ema = pt.optimizer.ExponentialMovingAverage(0.999)
        ema.update()
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = _transformer_feed(dev)
    kernels.reset_counts()
    losses, ms = _steps_on_card(exe, main, feed, model["loss"], scope,
                                AVG_STEPS)
    counts = _check_launches("phase 6q", main, AVG_STEPS)
    params = [p.name for p in main.all_parameters()]

    def cpu(n):
        return scope.find_var(n).cpu()

    want_ma = {}
    for n in params:
        total = float(cpu(f"{n}.num_accumulates").reshape(())) + float(
            cpu(f"{n}.old_num_accumulates").reshape(()))
        want_ma[n] = ((cpu(f"{n}.sum_1") + cpu(f"{n}.sum_2")
                       + cpu(f"{n}.sum_3")) / total if total > 0
                      else cpu(n))
    t = float(cpu(ema._step_var.name).reshape(()))
    want_ema = {n: cpu(f"{n}.ema") / (1.0 - 0.999 ** t) for n in params}
    log(f"  {AVG_STEPS} steps, losses {losses}, step ms "
        f"{[round(x, 2) for x in ms]} on {card}; EMA t = {t}")
    res = {"update_ops_max_rel_err": ops, "losses": losses, "step_ms": ms,
           "launches": counts["launches"],
           "model_average": _swap_check("ModelAverage", ma, exe, scope,
                                        params, want_ma, dev, 0),
           "ema": _swap_check("ExponentialMovingAverage", ema, exe, scope,
                              params, want_ema, dev, 1)}
    return res


def _book_builds():
    """(name, build kwargs, feed, steps, card-vs-CPU parity) of 6r."""
    from paddle_tpu_torch.models import (recommender, sequence_tagging,
                                         word2vec)

    return [
        ("sequence_tagging", sequence_tagging, SRL_ARCH,
         sequence_tagging.make_fake_batch(SRL_BATCH), BOOK_STEPS, True),
        ("word2vec", word2vec, {}, word2vec.make_fake_batch(),
         W2V_STEPS, False),
        ("recommender", recommender, {}, recommender.make_fake_batch(),
         BOOK_STEPS, True),
    ]


def phase_book_models(dev, card):
    """6r: the three book models (synthetic feeds from make_fake_batch),
    each from the same weights on the card and on the CPU: the sequence
    tagger and the recommender's losses within TOL_BOOK of max(1, |loss|)
    at every step; word2vec's NCE draws differ across devices, so its
    losses are held finite and its forward loss at one fixed run counter
    (the same negatives) lower after the steps than before.  No port
    kernel lies on these paths (the tagger's
    relu/sigmoid LSTM takes the composed route, which the LSTM kernel
    does not take); its composed calls are reported."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import params_from_arrays
    from paddle_tpu_torch.ops import kernels

    log("phase 6r: the book models card vs CPU (sequence tagging at the "
        "book's widths, word2vec with NCE, the recommender)")
    from paddle_tpu_torch.core.executor import RNG_STATE_VAR

    def fixed_draw_loss(exe, test, loss, scope, feed):
        """The forward loss at one fixed run counter: the same NCE
        negatives before and after training."""
        run = scope.find_var(RNG_STATE_VAR)
        scope.set_var(RNG_STATE_VAR, 10 ** 6)
        out = exe.run(test, feed=feed, fetch_list=[loss], scope=scope)
        scope.set_var(RNG_STATE_VAR, run)
        return float(out[0].reshape(-1)[0])

    res = {}
    for name, mod, kw, feed, steps, parity in _book_builds():
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup), pt.unique_name.guard():
            model = mod.build_model(**kw)
        init = pt.Scope()
        pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
        arrays = {n: v.cpu().numpy() for n, v in init.vars.items()
                  if isinstance(v, torch.Tensor)}
        runs = {}
        for place, device in ((pt.CUDAPlace(0), dev), (pt.CPUPlace(), "cpu")):
            scope = pt.Scope()
            for n, v in params_from_arrays(arrays, device,
                                           program=main).items():
                scope.set_var(n, v)
            exe = pt.Executor(place)
            f = {n: torch.as_tensor(a).to(device) for n, a in feed.items()}
            if device == dev:
                test = main.clone(for_test=True)
                before = fixed_draw_loss(exe, test, model["loss"], scope, f)
                kernels.reset_counts()
                losses, ms = _steps_on_card(exe, main, f, model["loss"],
                                            scope, steps)
                counts = kernels.counts()
                after = fixed_draw_loss(exe, test, model["loss"], scope, f)
            else:
                losses = [float(exe.run(main, feed=f,
                                        fetch_list=[model["loss"]],
                                        scope=scope)[0].reshape(-1)[0])
                          for _ in range(steps)]
            runs[str(device)] = losses
        card_l, cpu_l = runs[str(dev)], runs["cpu"]
        if max(counts["launches"].values()) or max(counts["plain"].values()):
            raise AssertionError(f"phase 6r {name}: kernel counts {counts}")
        ok = np.isfinite(card_l + cpu_l).all()
        if parity:
            err = max(abs(a - b) / max(1.0, abs(b))
                      for a, b in zip(card_l, cpu_l))
            ok = ok and err <= TOL_BOOK
        else:
            err = None
            ok = ok and after < before
        steady = float(np.mean(ms[1:]))
        log(f"  {name}: card losses {[round(x, 6) for x in card_l]}, cpu "
            f"{[round(x, 6) for x in cpu_l]}; "
            + (f"max rel err {err:.3e} (tol {TOL_BOOK:g}); " if parity
               else f"finite; on the card the loss at one fixed draw "
                    f"{before:.6f} before, {after:.6f} after; ")
            + f"step {steady:.2f} ms (first {ms[0]:.1f}) on {card}; "
            f"composed calls {counts['composed']}")
        if not ok:
            raise AssertionError(f"phase 6r {name}: card {card_l}, cpu "
                                 f"{cpu_l}")
        res[name] = dict(losses_card=card_l, losses_cpu=cpu_l,
                         loss_max_rel_err=err, step_ms=ms,
                         fixed_draw_loss=(before, after),
                         steady_step_ms=steady,
                         composed_calls=counts["composed"])
    return res


# -- phase 6s: control flow through machine translation ----------------

# upstream Fluid's benchmark/fluid/models/machine_translation.py, which
# the reference's model cites: embed = hidden = 512, dictionaries of
# 30000, batch 16; sentences of 50 tokens, the decode's beam 4 (the
# net's default) and 50 steps
MT_ARCH = dict(src_vocab_size=30000, trg_vocab_size=30000, embed_dim=512,
               hidden_dim=512)
MT_BATCH, MT_LEN, MT_BEAM = 16, 50, 4
MT_STEPS = 3
MT_LR = 1e-3
TOL_MT = 1e-4        # card vs CPU losses and final beam scores, relative
SUB_BLOCK_ITERS = 8  # the While around flash_attention


def mt_feed(seed=0):
    """Synthetic batches: ids in [2, V) (0 and 1 are the decode's start
    and end tokens), lengths from half the sentence to all of it."""
    rng = np.random.RandomState(seed)
    b, t, v = MT_BATCH, MT_LEN, MT_ARCH["src_vocab_size"]
    return {
        "src_word_id": rng.randint(2, v, (b, t)).astype(np.int64),
        "src_word_id.seq_len": rng.randint(t // 2, t + 1, b)
        .astype(np.int32),
        "trg_word_id": rng.randint(2, v, (b, t)).astype(np.int64),
        "trg_word_id.seq_len": rng.randint(t // 2, t + 1, b)
        .astype(np.int32),
        "trg_next_id": rng.randint(2, v, (b, t)).astype(np.int64),
    }


def _mt_programs():
    """(train main, train startup, loss), (decode main, sentences,
    scores) of the machine-translation nets at MT_ARCH."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import machine_translation as mt

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, _ = mt.seq_to_seq_net(batch_size=MT_BATCH, max_src_len=MT_LEN,
                                    max_trg_len=MT_LEN, **MT_ARCH)
        pt.optimizer.Adam(learning_rate=MT_LR).minimize(loss)
    dec, dec_startup = pt.Program(), pt.Program()
    with pt.program_guard(dec, dec_startup), pt.unique_name.guard():
        sents, scores, _ = mt.beam_search_net(
            batch_size=MT_BATCH, max_src_len=MT_LEN, beam_size=MT_BEAM,
            max_decode_len=MT_LEN, start_id=0, end_id=1, **MT_ARCH)
    return (main, startup, loss), (dec, sents, scores)


def _no_kernel(label, counts):
    """No port kernel lies on the machine-translation paths (GRU,
    attention and beam search are compositions of torch ops, as they
    are XLA compositions in the reference): nothing launched, no plain
    version called."""
    if max(counts["launches"].values()) or max(counts["plain"].values()):
        raise AssertionError(f"phase 6s {label}: kernel counts {counts}")


def phase_control_flow(dev, card):
    """6s: machine translation's training (DynamicRNN) and beam decode
    (While, tensor arrays, beam_search, beam_search_decode) at full
    width, card against CPU, and a kernel op inside a While body."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import params_from_arrays
    from paddle_tpu_torch.ops import kernels

    log(f"phase 6s: machine translation at full width (embed/hidden 512, "
        f"vocab 30000, batch {MT_BATCH}, length {MT_LEN}, beam {MT_BEAM}) "
        f"card vs CPU; flash_attention in a While body")
    (main, startup, loss), (dec, sents, scores) = _mt_programs()
    init = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
    arrays = {n: v.cpu().numpy() for n, v in init.vars.items()
              if isinstance(v, torch.Tensor)}
    feed = mt_feed()
    res, scopes = {}, {}
    for place, device in ((pt.CUDAPlace(0), dev), (pt.CPUPlace(), "cpu")):
        scope = pt.Scope()
        for n, v in params_from_arrays(arrays, device,
                                       program=main).items():
            scope.set_var(n, v)
        exe = pt.Executor(place)
        f = {n: torch.as_tensor(a).to(device) for n, a in feed.items()}
        if device == dev:
            peaks = []
            kernels.reset_counts()
            losses, ms = _steps_on_card(exe, main, f, loss, scope, MT_STEPS,
                                        peaks=peaks)
            _no_kernel("training", kernels.counts())
            prof = _profile_train_step(exe, main, f, loss, scope, steps=2,
                                       label="phase 6s training, profiled")
            res["train"] = dict(losses_card=losses, step_ms=ms,
                                peak_bytes=max(peaks), profile=prof)
            # the decode on both devices from the card's trained weights
            trained = {n: scope.find_var(n).cpu().numpy()
                       for n in arrays if scope.find_var(n) is not None}
        else:
            res["train"]["losses_cpu"] = [
                float(exe.run(main, feed=f, fetch_list=[loss],
                              scope=scope)[0].reshape(-1)[0])
                for _ in range(MT_STEPS)]
        scopes[str(device)] = scope
    card_l, cpu_l = res["train"]["losses_card"], res["train"]["losses_cpu"]
    err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(card_l, cpu_l))
    res["train"]["loss_max_rel_err"] = err
    tr = res["train"]
    steady = float(np.mean(tr["step_ms"][1:]))
    tokens = MT_BATCH * MT_LEN * 2
    log(f"  training: card losses {[round(x, 6) for x in card_l]}, cpu "
        f"{[round(x, 6) for x in cpu_l]}; max rel err {err:.3e} (tol "
        f"{TOL_MT:g}); step {steady:.2f} ms (first {tr['step_ms'][0]:.1f}; "
        f"{tokens / steady * 1e3:.0f} tokens/s, source and target); idle "
        f"share {tr['profile']['device_idle_share']:.3f}; "
        f"{tr['profile']['kernel_launches_per_step']:.0f} kernels/step; "
        f"peak {tr['peak_bytes'] / 2**30:.2f} GiB on {card}")
    if not (np.isfinite(card_l + cpu_l).all() and err <= TOL_MT):
        raise AssertionError(f"phase 6s training: card {card_l}, cpu "
                             f"{cpu_l}")
    res["decode"] = _mt_decode(dev, dec, sents, scores, trained, feed, card)
    res["sub_block"] = _kernel_in_while(dev)
    res["launches"] = res["sub_block"]["launches"]
    return res


def _mt_decode(dev, dec, sents, scores, trained, feed, card):
    """The beam decode card against CPU from the same trained weights:
    sentences equal, final scores within TOL_MT; decode ms (the second
    of two runs), the host syncs of one decode and the While's trips."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import params_from_arrays
    from paddle_tpu_torch.ops import kernels

    src = {n: feed[n] for n in ("src_word_id", "src_word_id.seq_len")}
    out = {}
    for place, device in ((pt.CUDAPlace(0), dev), (pt.CPUPlace(), "cpu")):
        scope = pt.Scope()
        for n, v in params_from_arrays(trained, device,
                                       program=dec).items():
            scope.set_var(n, v)
        exe = pt.Executor(place)
        f = {n: torch.as_tensor(a).to(device) for n, a in src.items()}

        def run():
            return exe.run(dec, feed=f, fetch_list=[sents, scores],
                           scope=scope, return_numpy=False)

        if device == dev:
            kernels.reset_counts()
            run()
            torch.cuda.synchronize()
            _no_kernel("decode", kernels.counts())
            t0 = time.perf_counter()
            got = run()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            syncs = _sync_warnings(run)
        else:
            got = run()
        out[str(device)] = [g.cpu().numpy() for g in got]
    (s_card, sc_card), (s_cpu, sc_cpu) = out[str(dev)], out["cpu"]
    # every hypothesis holds end_id (1) from its first end on: the steps
    # the loop ran are the longest hypothesis's, or the cap
    steps = int(max((row != 1).sum() for row in s_card.reshape(
        -1, MT_LEN)))
    differ = np.argwhere(s_card != s_cpu)
    err = float(np.max(np.abs(sc_card - sc_cpu)
                       / np.maximum(1.0, np.abs(sc_cpu))))
    by_line = {}
    for line in syncs:
        by_line[line] = by_line.get(line, 0) + 1
    log(f"  decode: sentences {s_card.shape} equal card vs CPU: "
        f"{not len(differ)}; final scores max rel err {err:.3e} (tol "
        f"{TOL_MT:g}); decode {ms:.1f} ms ({MT_BATCH * MT_BEAM} beams x "
        f"up to {MT_LEN} steps); {len(syncs)} host syncs a decode "
        f"({by_line}); on {card}")
    if len(differ):
        first = tuple(differ[0])
        raise AssertionError(
            f"phase 6s decode: {len(differ)} tokens differ, first at "
            f"(row, beam, step) {first}: card {s_card[first[:2]]}, cpu "
            f"{s_cpu[first[:2]]}; scores card {sc_card[first[:2]]}, cpu "
            f"{sc_cpu[first[:2]]}")
    if not (np.isfinite(sc_card).all() and err <= TOL_MT):
        raise AssertionError(f"phase 6s decode scores: card {sc_card}, "
                             f"cpu {sc_cpu}")
    return dict(decode_ms=ms, host_syncs=len(syncs), sync_lines=by_line,
                steps_run=steps, scores_max_rel_err=err,
                scores_card=sc_card.tolist())


def _kernel_in_while(dev):
    """A While of SUB_BLOCK_ITERS iterations whose body calls
    flash_attention at the training shape (N 64, H 8, T 256, D 64,
    causal): the forward kernel launches exactly once an iteration, and
    the While's output equals the plain version's on the same inputs.
    The counts are zeroed just before the run and read just after."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import flash_attention as fk

    n, t = TRAIN_BATCH, TRAIN_ARCH["max_length"]
    h = TRAIN_ARCH["n_head"]
    d = TRAIN_ARCH["d_model"] // h
    layers = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        q, k, v = (layers.data(name, shape=[n, h, t, d],
                               append_batch_size=False)
                   for name in ("q", "k", "v"))
        o = layers.fill_constant([n, h, t, d], "float32", 0.0)
        i = layers.fill_constant([1], "int32", 0)
        limit = layers.fill_constant([1], "int32", SUB_BLOCK_ITERS)
        cond = layers.less_than(i, limit)
        w = layers.While(cond)
        with w.block():
            att = layers.flash_attention(q, k, v, causal=True)
            layers.assign(layers.elementwise_add(o, att), o)
            layers.increment(i, 1)
            layers.less_than(i, limit, cond=cond)
    g = torch.Generator(device=dev).manual_seed(61)
    feed = {name: torch.randn((n, h, t, d), generator=g, device=dev)
            for name in ("q", "k", "v")}
    exe = pt.Executor(pt.CUDAPlace(0))
    torch.cuda.synchronize()
    kernels.reset_counts()
    (got,) = exe.run(main, feed=feed, fetch_list=[o], return_numpy=False)
    torch.cuda.synchronize()
    counts = kernels.counts()
    fwd = counts["launches"]["flash_attention_fwd"]
    if fwd != SUB_BLOCK_ITERS:
        raise AssertionError(f"phase 6s: flash_attention_fwd launched "
                             f"{fwd} times in a While of "
                             f"{SUB_BLOCK_ITERS} iterations: {counts}")
    plain, _ = fk.flash_attention_fwd_plain(feed["q"], feed["k"],
                                            feed["v"], None, None, True)
    want = torch.zeros_like(plain)
    for _ in range(SUB_BLOCK_ITERS):
        want = want + plain
    err = check_close("phase 6s flash_attention in a While body", got,
                      want, TOL_KERNEL * SUB_BLOCK_ITERS)
    log(f"  flash_attention in a While of {SUB_BLOCK_ITERS} iterations at "
        f"N={n} H={h} T={t} D={d} causal: flash_attention_fwd launches "
        f"{fwd}; sum of the {SUB_BLOCK_ITERS} outputs against the plain "
        f"version's, max abs err {err:.3e} (tol "
        f"{TOL_KERNEL * SUB_BLOCK_ITERS:g})")
    return dict(launches=counts["launches"], max_abs_err=err)


# -- phase 6t: the switch-MoE Transformer and the registry's dense half ----

# the bench Transformer with every FFN sublayer a top-1 switch-MoE block of
# 8 experts (bench.py --moe-experts: bench.py:701, :719, :1880-1882;
# capacity factor 1.25 and aux weight 0.01, the defaults of switch_moe and
# transformer()): 12 MoE layers, capacity C = ceil(16384 / 8 * 1.25) = 2560
MOE = dict(moe_experts=8)
MOE_STEPS = 5
# a token routed to another expert on the card than on the CPU must have
# the CPU's logits of the two experts within this relative distance
TOL_ROUTE_TIE = 1e-5
# phase 6t (c): each op's floating outputs and gradients card against CPU
TOL_DENSE = dict(rtol=2e-3, atol=1e-6)


def _moe_ops(program):
    return [op for op in program.global_block().ops if op.type == "moe_ffn"]


def _moe_summary(label, res, tokens, card):
    """Log a 6t training run: its Fraction (tokens a expert), the
    tokens past each layer's capacity, kernels and idle share."""
    frac = np.stack([np.asarray(v).reshape(-1)
                     for v in res.pop("extra").values()])
    e = frac.shape[1]
    cap = int(np.ceil(tokens / e * 1.25))
    per_expert = np.rint(frac * tokens).astype(np.int64)
    dropped = np.clip(per_expert - cap, 0, None).sum(axis=1)
    prof = res.get("profile", {})
    res["moe"] = {"layers": int(frac.shape[0]), "experts": e,
                  "capacity": cap,
                  "tokens_per_expert_last_step": per_expert.tolist(),
                  "dropped_tokens_per_layer": dropped.tolist()}
    log(f"  {label}: step {res['step_ms']:.2f} ms, "
        f"{res['tokens_per_s']:.1f} tokens/s, idle share "
        f"{prof.get('device_idle_share', float('nan')):.3f}, "
        f"{prof.get('kernel_launches_per_step', float('nan')):.0f} "
        f"kernels/step, flash launches {res['launches']}, peak "
        f"{res['peak_mem_bytes'] / 1e9:.3f} GB on {card}")
    log(f"  {label}: last step's tokens a expert over {frac.shape[0]} MoE "
        f"layers: min {per_expert.min()}, max {per_expert.max()} "
        f"(capacity {cap}); first layer {per_expert[0].tolist()}; tokens "
        f"past capacity a layer {dropped.tolist()}")
    if not np.allclose(frac.sum(axis=1), 1.0, atol=1e-5):
        raise AssertionError(f"{label}: fractions {frac.sum(axis=1)}")
    return res


def _routing_flips(dev, card_run, cpu_run, arrays, moe_ops, top_k):
    """Each MoE layer's routing at step 1, card against CPU: the gate
    logits X @ GateW from each device's own X (the op's product, on its
    device) routed by the op's own `route`.  Returns (tokens whose
    expert differs, the largest relative logit gap among them, slots
    that differ for an unchanged expert)."""
    from paddle_tpu_torch.ops.moe import route

    flips, worst, slot_only = 0, 0.0, 0
    for op in moe_ops:
        w = arrays[op.input("GateW")[0]]
        x_name = op.input("X")[0]
        xs = {}
        for name, run, device in (("card", card_run, dev),
                                  ("cpu", cpu_run, "cpu")):
            x = torch.as_tensor(run["extra"][x_name]).to(device)
            x = x.reshape(-1, x.shape[-1])
            xs[name] = torch.matmul(x, torch.as_tensor(w).to(device)).float()
        b, e = xs["cpu"].shape
        cap = max(1, int(np.ceil(b * top_k / e * 1.25)))
        plans = {n: route(lg, top_k, cap) for n, lg in xs.items()}
        lcpu = xs["cpu"]
        for (ic, sc, _), (ip, sp, _) in zip(plans["card"], plans["cpu"]):
            ic, sc = ic.cpu(), sc.cpu()
            diff = ic != ip
            for t in torch.nonzero(diff).reshape(-1).tolist():
                a, c = lcpu[t, ip[t]], lcpu[t, ic[t]]
                gap = float((a - c).abs() / max(float(a.abs()),
                                                 float(c.abs()), 1e-30))
                worst = max(worst, gap)
            flips += int(diff.sum())
            slot_only += int(((sc != sp) & ~diff).sum())
    return flips, worst, slot_only


def phase_moe_parity(dev, top_k):
    """6t (b): the MoE Transformer at full width on PARITY_BATCH x
    PARITY_T tokens, dropout 0, PARITY_STEPS Adam steps, float32, card
    against CPU from the same weights (`_check_adam_runs`); top_k 2 is
    the same program with every moe_ffn's top_k (switch_moe's) set to 2.
    The routing of each layer at step 1 compared: a token routed to
    another expert must be a near-tie (TOL_ROUTE_TIE)."""
    from paddle_tpu_torch.models import transformer

    log(f"phase 6t (b): MoE Transformer at {CUT_LAYERS}+{CUT_LAYERS} "
        f"layers card vs CPU, top-{top_k} "
        f"({PARITY_BATCH} x {PARITY_T} tokens, dropout 0, {PARITY_STEPS} "
        f"Adam steps)")
    main, startup, model = build_training(dropout=0.0, max_length=PARITY_T,
                                          n_layer=CUT_LAYERS, **MOE)
    ops = _moe_ops(main)
    if top_k != 1:
        for op in ops:
            op.desc.attrs["top_k"] = top_k
        main._bump()
    feed = transformer.make_fake_batch(PARITY_BATCH, PARITY_T,
                                       TRAIN_ARCH["src_vocab_size"],
                                       TRAIN_ARCH["trg_vocab_size"], seed=3)
    feed["src_len"] = np.array([PARITY_T, 41], np.int32)
    feed["trg_len"] = np.array([17, PARITY_T], np.int32)
    card, cpu, arrays, params = _card_and_cpu_runs(
        dev, main, startup, [model["loss"].name], feed,
        extra=[op.input("X")[0] for op in ops])
    flips, worst, slot_only = _routing_flips(dev, card, cpu, arrays, ops,
                                             top_k)
    log(f"  routing at step 1 over {len(ops)} layers x "
        f"{PARITY_BATCH * PARITY_T} tokens x {top_k} choice(s): {flips} "
        f"token(s) routed to another expert on the card (largest relative "
        f"logit gap {worst:.3e}, tol {TOL_ROUTE_TIE:g}); {slot_only} slot(s) "
        f"differing for an unchanged expert")
    if worst > TOL_ROUTE_TIE or (slot_only and not flips):
        raise AssertionError(f"top-{top_k} routing differs beyond near-ties: "
                             f"{flips} flips, gap {worst}, {slot_only} slots")
    lr_sum = sum(_noam_lr(t) for t in range(1, PARITY_STEPS + 1))
    res = _check_adam_runs(card, cpu, [model["loss"].name], params, lr_sum)
    res.update(routing_flips=flips, routing_max_gap=worst,
               slot_only_diffs=slot_only)
    return res


def _dyadic(rng, *shape):
    """Multiples of 1/8 in [-1, 1): products and short sums of them are
    exact in float32 on every device, so gate logits tie exactly where
    they tie and route alike on the card and the CPU."""
    return (rng.randint(-8, 8, shape) / 8.0).astype(np.float32)


def dense_op_cases():
    """{name: (op, ins, attrs, output slot, gradient slots)} of phase 6t
    (c): each of the 85 ops of the registry's dense half at a small
    shape, numpy inputs from a fixed seed (ins values may be lists: a
    multi-tensor slot); gradient slots None mark a random op."""
    r = np.random.RandomState(20)

    def f(*s):
        return r.randn(*s).astype(np.float32)

    def p(*s):
        return (r.rand(*s) + 0.5).astype(np.float32)

    img, x2 = f(2, 3, 7, 9), f(4, 33)
    cases = {}
    for op, attrs in (("abs", {}), ("brelu", {"t_min": -0.5, "t_max": 0.7}),
                      ("ceil", {}), ("cos", {}), ("elu", {"alpha": 0.7}),
                      ("exp", {}), ("floor", {}),
                      ("hard_shrink", {"threshold": 0.3}),
                      ("hard_sigmoid", {}), ("leaky_relu", {"alpha": 0.1}),
                      ("log_softmax", {"axis": 1}), ("logsigmoid", {}),
                      ("round", {}), ("selu", {}), ("sin", {}),
                      ("soft_relu", {"threshold": 1.5}), ("softplus", {}),
                      ("softshrink", {"lambda": 0.3}), ("softsign", {}),
                      ("stanh", {}), ("swish", {"beta": 1.3}),
                      ("tanh_shrink", {}),
                      ("thresholded_relu", {"threshold": 0.5}),
                      ("relu6", {"threshold": 1.0})):
        grads = [] if op in ("ceil", "floor", "round") else ["X"]
        cases[op] = (op, {"X": x2}, attrs, "Out", grads)
    for op in ("pow", "reciprocal", "rsqrt"):
        cases[op] = (op, {"X": p(4, 33)}, {"factor": 2.5}, "Out", ["X"])
    lbl = r.randint(0, 6, (5, 1)).astype(np.int32)
    cases.update({
        "prelu": ("prelu", {"X": f(2, 3, 4, 4), "Alpha": p(3)},
                  {"mode": "channel"}, "Out", ["X", "Alpha"]),
        "bpr_loss": ("bpr_loss", {"X": f(5, 6), "Label": lbl}, {}, "Y",
                     ["X"]),
        "conv2d_transpose": ("conv2d_transpose", {
            "Input": f(2, 4, 6, 5), "Filter": f(4, 3, 3, 3) * 0.3},
            {"strides": 2, "paddings": 1, "groups": 2, "dilations": [1, 2]},
            "Output", ["Input", "Filter"]),
        "depthwise_conv2d_transpose": ("depthwise_conv2d_transpose", {
            "Input": f(2, 3, 5, 5), "Filter": f(3, 1, 3, 3) * 0.3},
            {"strides": 2, "paddings": 1, "groups": 3}, "Output",
            ["Input", "Filter"]),
        "conv3d": ("conv3d", {"Input": f(2, 4, 6, 7, 5),
                              "Filter": f(4, 2, 3, 3, 2) * 0.3},
                   {"strides": 2, "paddings": "SAME", "groups": 2},
                   "Output", ["Input", "Filter"]),
        "conv3d_transpose": ("conv3d_transpose", {
            "Input": f(1, 2, 3, 4, 3), "Filter": f(2, 3, 2, 3, 2) * 0.3},
            {"strides": 2, "paddings": [0, 1, 0]}, "Output",
            ["Input", "Filter"]),
        "grid_sampler": ("grid_sampler", {
            "X": f(2, 3, 5, 6), "Grid": (r.rand(2, 4, 3, 2) * 3 - 1.5)
            .astype(np.float32)}, {}, "Output", ["X", "Grid"]),
        "group_norm": ("group_norm", {"X": f(2, 6, 4, 3), "Scale": p(6),
                                      "Bias": f(6)}, {"groups": 3},
                       "Y", ["X", "Scale", "Bias"]),
        "hinge_loss": ("hinge_loss", {"Logits": f(6, 1), "Labels": r.randint(
            0, 2, (6, 1)).astype(np.float32)}, {}, "Loss", ["Logits"]),
        "huber_loss": ("huber_loss", {"X": f(6, 1), "Y": f(6, 1)},
                       {"delta": 0.5}, "Out", ["X", "Y"]),
        "interpolate": ("interpolate", {"X": img},
                        {"out_h": 11, "out_w": 13, "align_corners": False,
                         "align_mode": 0}, "Out", ["X"]),
        "interpolate nearest": ("interpolate", {"X": img},
                                {"out_h": 13, "out_w": 17,
                                 "interp_method": "nearest"}, "Out", ["X"]),
        "kldiv_loss": ("kldiv_loss", {"X": f(4, 5), "Target": p(4, 5)},
                       {"reduction": "batchmean"}, "Loss", ["X"]),
        "l1_norm": ("l1_norm", {"X": f(4, 5)}, {}, "Out", ["X"]),
        "log_loss": ("log_loss", {"Predicted": r.rand(6, 1).astype(
            np.float32), "Labels": r.rand(6, 1).astype(np.float32)},
            {}, "Loss", ["Predicted"]),
        "lrn": ("lrn", {"X": p(2, 6, 3, 3)}, {"n": 5, "alpha": 0.3},
                "Out", ["X"]),
        "margin_rank_loss": ("margin_rank_loss", {
            "Label": np.sign(f(6, 1)), "X1": f(6, 1), "X2": f(6, 1)},
            {"margin": 0.1}, "Out", ["X1", "X2"]),
        "maxout": ("maxout", {"X": f(2, 6, 3, 3)}, {"groups": 3}, "Out",
                   ["X"]),
        "pad2d": ("pad2d", {"X": img}, {"paddings": [1, 2, 3, 0],
                                        "mode": "reflect"}, "Out", ["X"]),
        "pool2d_with_index": ("pool2d_with_index", {
            "X": np.round(f(2, 3, 7, 7))}, {"ksize": 3, "strides": 2,
                                            "paddings": 1}, "Out", ["X"]),
        "rank_loss": ("rank_loss", {"Label": r.rand(6, 1).astype(
            np.float32), "Left": f(6, 1), "Right": f(6, 1)}, {}, "Out",
            ["Left", "Right"]),
        "smooth_l1_loss": ("smooth_l1_loss", {
            "X": f(4, 5), "Y": f(4, 5), "InsideWeight": p(4, 5),
            "OutsideWeight": p(4, 5)}, {"sigma": 2.0}, "Out", ["X", "Y"]),
        "space_to_depth": ("space_to_depth", {"X": f(2, 3, 4, 6)},
                           {"blocksize": 2}, "Out", ["X"]),
        "squared_l2_distance": ("squared_l2_distance", {
            "X": f(4, 5), "Y": f(4, 5)}, {}, "Out", ["X", "Y"]),
        "squared_l2_norm": ("squared_l2_norm", {"X": f(4, 5)}, {}, "Out",
                            ["X"]),
        "teacher_student_sigmoid_loss": ("teacher_student_sigmoid_loss", {
            "X": f(8, 1) * 10, "Label": (r.rand(8, 1) * 4 - 2).astype(
                np.float32)}, {}, "Y", ["X"]),
        # basic
        "arg_min": ("arg_min", {"X": np.round(f(5, 7))}, {"axis": 1},
                    "Out", []),
        "argsort": ("argsort", {"X": np.round(f(5, 7))}, {"axis": -1},
                    "Out", ["X"]),
        "bilinear_tensor_product": ("bilinear_tensor_product", {
            "X": f(3, 4), "Y": f(3, 5), "Weight": f(6, 4, 5),
            "Bias": f(1, 6)}, {}, "Out", ["X", "Y", "Weight", "Bias"]),
        "cos_sim": ("cos_sim", {"X": f(4, 6), "Y": f(1, 6)}, {}, "Out",
                    ["X", "Y"]),
        "cumsum": ("cumsum", {"X": f(4, 9)}, {"axis": 1, "exclusive": True,
                                              "reverse": True}, "Out",
                   ["X"]),
        "elementwise_mod": ("elementwise_mod", {
            "X": r.randint(-20, 20, (4, 5)).astype(np.int32),
            "Y": r.randint(1, 7, (4, 5)).astype(np.int32)}, {}, "Out", []),
        "fill_zeros_like": ("fill_zeros_like", {"X": f(3, 4)}, {}, "Out",
                            []),
        "flatten": ("flatten", {"X": img}, {"axis": 2}, "Out", ["X"]),
        "isfinite": ("isfinite", {"X": [f(3, 4), np.array(
            [1.0, np.inf], np.float32)]}, {}, "Out", []),
        "minus": ("minus", {"X": f(3, 4), "Y": f(3, 4)}, {}, "Out",
                  ["X", "Y"]),
        "multiplex": ("multiplex", {"Ids": np.array([[2], [0], [1], [2]],
                                                    np.int32),
                                    "X": [f(4, 3), f(4, 3), f(4, 3)]}, {},
                      "Out", []),
        "pad": ("pad", {"X": f(3, 4)}, {"paddings": [1, 0, 2, 3],
                                        "pad_value": 0.5}, "Out", ["X"]),
        "pad_constant_like": ("pad_constant_like", {"X": f(4, 6),
                                                    "Y": f(2, 5)},
                              {"pad_value": -1.0}, "Out", ["Y"]),
        "reduce_max": ("reduce_max", {"X": np.round(f(3, 4, 5))},
                       {"dim": [0, 2]}, "Out", ["X"]),
        "reduce_min": ("reduce_min", {"X": f(3, 4, 5)},
                       {"dim": [1], "keep_dim": True}, "Out", ["X"]),
        "reduce_prod": ("reduce_prod", {"X": p(3, 4, 5)},
                        {"dim": [0, 2]}, "Out", ["X"]),
        "reverse": ("reverse", {"X": f(3, 4, 5)}, {"axis": [0, 2]}, "Out",
                    ["X"]),
        "scatter": ("scatter", {"X": f(6, 3), "Ids": np.array(
            [2, 4, 2, -1, 7, 2, 4], np.int32), "Updates": f(7, 3)},
            {"overwrite": True}, "Out", ["X", "Updates"]),
        "scatter add": ("scatter", {"X": f(6, 3), "Ids": np.array(
            [2, 4, 2, -1, 7, 2, 4], np.int32), "Updates": f(7, 3)},
            {"overwrite": False}, "Out", ["X", "Updates"]),
        "shape": ("shape", {"Input": img}, {}, "Out", []),
        "stack": ("stack", {"X": [f(3, 4), f(3, 4)]}, {"axis": 1}, "Y",
                  []),
        "unstack": ("unstack", {"X": f(3, 4)}, {"axis": 1}, "Y", ["X"]),
        "randint": ("randint", {}, {"shape": [64, 64], "low": -3,
                                    "high": 5}, "Out", None),
        "uniform_random_batch_size_like": (
            "uniform_random_batch_size_like", {"Input": f(64, 2)},
            {"shape": [-1, 64], "min": -3.0, "max": 5.0}, "Out", None),
        "gaussian_random_batch_size_like": (
            "gaussian_random_batch_size_like", {"Input": f(64, 2)},
            {"shape": [-1, 64], "mean": 1.0, "std": 0.5}, "Out", None),
        "random_crop": ("random_crop", {"X": np.arange(
            16 * 2 * 7 * 9, dtype=np.float32).reshape(16, 2, 7, 9)},
                        {"shape": [2, 3, 4]}, "Out", None),
        # misc, sparse, rnn, moe
        "print": ("print", {"In": f(3, 4)}, {"message": "phase 6t print",
                                             "summarize": 4}, "Out",
                  ["In"]),
        "conv_shift": ("conv_shift", {"X": f(4, 9), "Y": f(4, 5)}, {},
                       "Out", ["X", "Y"]),
        "hash": ("hash", {"X": np.array([[-1], [-7], [-2 ** 31],
                                         [2 ** 31 - 1], [0], [123456789]],
                                        np.int32)}, {"mod_by": 10007},
                 "Out", []),
        "shard_index": ("shard_index", {"X": np.array(
            [[-3], [0], [7], [8], [15], [20]], np.int32)},
            {"index_num": 16, "nshards": 2, "shard_id": 1,
             "ignore_value": -9}, "Out", []),
        "attention_lstm": ("attention_lstm", {
            "X": f(3, 5, 4), "C0": f(3, 2), "H0": f(3, 2),
            "AttentionWeight": f(6, 1), "AttentionBias": f(1, 1),
            "AttentionScalar": np.array([[0.7]], np.float32),
            "AttentionScalarBias": np.array([[0.1]], np.float32),
            "LSTMWeight": f(6, 8), "LSTMBias": f(1, 8),
            "SeqLen": np.array([5, 0, 3], np.int32)}, {}, "Hidden",
            ["X", "C0", "AttentionWeight", "LSTMWeight"]),
        "row_conv": ("row_conv", {"X": f(2, 6, 3), "Filter": f(3, 3)}, {},
                     "Out", ["X", "Filter"]),
        "moe_ffn": ("moe_ffn", {
            "X": _dyadic(r, 300, 16), "GateW": _dyadic(r, 16, 8),
            "W1": f(8, 16, 32) * 0.3, "B1": f(8, 32) * 0.1,
            "W2": f(8, 32, 16) * 0.3, "B2": f(8, 16) * 0.1},
            {"top_k": 2, "capacity_factor": 0.8}, "Out",
            ["X", "GateW", "W1", "B1", "W2", "B2"]),
    })
    from paddle_tpu_torch.ops.misc import register_py_func

    cases["py_func"] = ("py_func", {"X": [f(3, 4)]},
                        {"handle": register_py_func(lambda a: a * 2 + 1.0),
                         "out_shapes": [[3, 4]],
                         "out_dtypes": ["float32"]}, "Out", [])
    return cases


def _run_dense(op, ins_np, attrs, device, grad_slots, out_slot):
    """(outputs {slot: numpy}, gradients {slot: numpy}) of one op on
    `device`; the gradients of sum(out * cos weights) of `out_slot`."""
    from paddle_tpu_torch.core.registry import OpContext, get_op_impl

    ins = {}
    for s, v in ins_np.items():
        vs = v if isinstance(v, list) else [v]
        ins[s] = [torch.as_tensor(a).to(device) for a in vs]
    for s in grad_slots or ():
        ins[s][0] = ins[s][0].detach().requires_grad_()
    outs = get_op_impl(op)(OpContext((0, 7), 11, device=device), ins,
                           dict(attrs))
    got = {s: [t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16
               else t.detach().cpu().numpy() for t in v]
           for s, v in outs.items()}
    grads = {}
    if grad_slots:
        o = outs[out_slot][0]
        # the weights made on the CPU: the same bits on both devices
        w = torch.cos(torch.arange(o.numel(), dtype=torch.float32)
                      * 0.1).to(device)
        leaves = [ins[s][0] for s in grad_slots]
        gs = torch.autograd.grad((o.float().reshape(-1) * w).sum(), leaves,
                                 allow_unused=True)
        grads = {s: (np.zeros(tuple(l.shape), np.float32) if g is None
                     else g.cpu().numpy())
                 for s, l, g in zip(grad_slots, leaves, gs)}
    return got, grads


def _check_draws(name, op, got, attrs, ins):
    """A random op's shape, dtype and range (its draws come from the
    op's generator on each device, so no two devices agree bit for
    bit)."""
    o = got["Out"][0]
    if op == "randint":
        ok = (o.shape == (64, 64) and o.dtype == np.int32
              and o.min() >= -3 and o.max() <= 4)
    elif op == "random_crop":
        x = ins["X"]
        ok = o.shape == (16, 2, 3, 4)
        for i in range(16):
            r, c = divmod(int(o[i, 0, 0, 0] - x[i, 0, 0, 0]), 9)
            ok = ok and np.array_equal(o[i], x[i, :, r:r + 3, c:c + 4])
    elif op.startswith("uniform"):
        ok = (o.shape == (64, 64) and o.dtype == np.float32
              and o.min() >= -3.0 and o.max() < 5.0
              and abs(o.mean() - 1.0) < 4 * 2.31 / 64)
    else:
        ok = (o.shape == (64, 64) and o.dtype == np.float32
              and abs(o.mean() - 1.0) < 4 * 0.5 / 64
              and abs(o.std() - 0.5) < 0.05 * 0.5)
    if not ok:
        raise AssertionError(f"phase 6t (c) {name}: draws out of shape, "
                             f"dtype or range")


def phase_dense_ops(dev):
    """6t (c): each op of the registry's dense half on the card against
    the port on the CPU, on the same numpy inputs (`dense_op_cases`):
    floating outputs and gradients within TOL_DENSE, integer and
    boolean outputs exactly; random ops by shape, dtype and range."""
    cases = dense_op_cases()
    ops = sorted({c[0] for c in cases.values()})
    log(f"phase 6t (c): {len(ops)} ops of the registry's dense half, "
        f"{len(cases)} cases, card vs CPU")
    worst, n_cmp = {}, 0
    for name, (op, ins, attrs, out_slot, grad_slots) in sorted(
            cases.items()):
        got, g_card = _run_dense(op, ins, attrs, dev, grad_slots, out_slot)
        if grad_slots is None:
            _check_draws(name, op, got, attrs, ins)
            continue
        want, g_cpu = _run_dense(op, ins, attrs, "cpu", grad_slots,
                                 out_slot)
        pairs = [(f"{s}[{i}]", a, b) for s in want
                 for i, (a, b) in enumerate(zip(got[s], want[s]))]
        pairs += [(f"d/d{s}", g_card[s], g_cpu[s]) for s in g_cpu]
        for what, a, b in pairs:
            n_cmp += 1
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"phase 6t (c) {name} {what}: "
                                     f"{a.shape} {a.dtype} vs {b.shape} "
                                     f"{b.dtype}")
            if np.issubdtype(b.dtype, np.floating):
                fin = np.isfinite(b)
                if not np.array_equal(fin, np.isfinite(a)) or not \
                        np.allclose(a[fin], b[fin], **TOL_DENSE):
                    raise AssertionError(
                        f"phase 6t (c) {name} {what}: card vs CPU max abs "
                        f"err {np.abs(a[fin] - b[fin]).max():.3e}")
                err = float(np.abs(a[fin] - b[fin]).max()) if fin.any() \
                    else 0.0
            else:
                if not np.array_equal(a, b):
                    raise AssertionError(f"phase 6t (c) {name} {what}: "
                                         f"not equal")
                err = 0.0
            worst[name] = max(worst.get(name, 0.0), err)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    log(f"  {n_cmp} outputs and gradients compared, all within tolerance "
        f"(rtol {TOL_DENSE['rtol']:g}, atol {TOL_DENSE['atol']:g}; integer "
        f"and bool exact); largest abs errors "
        f"{[(k, f'{v:.2e}') for k, v in top]}")
    return {"ops": len(ops), "cases": len(cases), "compared": n_cmp,
            "max_abs_err": worst}


def phase_moe(dev, card):
    """6t: (a) the MoE Transformer at the bench's widths, float32 then
    bf16 AMP, MOE_STEPS timed steps each (12 flash forward, dK/dV and dQ
    launches a step, no plain or composed call); (b) card against CPU,
    top-1 and top-2; (c) the registry's dense half card against CPU."""
    res, seconds = {}, {}

    def fractions(main):
        return [op.output("Fraction")[0] for op in _moe_ops(main)]

    def part(key, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[key] = time.perf_counter() - t0
        log(f"  [6t {key}: {seconds[key]:.1f} s]")
        return out

    tokens = TRAIN_BATCH * TRAIN_ARCH["max_length"]
    for key, label, over in (("train_f32", "phase 6t (a) f32", MOE),
                             ("train_amp", "phase 6t (a) AMP",
                              dict(MOE, **AMP))):
        r = part(key, phase_train, dev, card, label, over, steps=MOE_STEPS,
                 profile=f"{label}, profiled", extra_fetch=fractions)
        res[key] = _moe_summary(label, r, tokens, card)
        torch.cuda.empty_cache()
    res["parity_top1"] = part("parity_top1", phase_moe_parity, dev, 1)
    res["parity_top2"] = part("parity_top2", phase_moe_parity, dev, 2)
    res["dense_ops"] = part("dense_ops", phase_dense_ops, dev)
    res["seconds"] = seconds
    res["launches"] = {k: res["train_f32"]["launches"].get(k, 0)
                       + res["train_amp"]["launches"].get(k, 0)
                       for k in res["train_f32"]["launches"]}
    return res


# -- phase 6u: QAT and int8 serving, chunk evaluation, the sequence,
#    structured and quantize families -------------------------------------

# (a) the reference bench's int8 line (bench.py:969-1043): ResNet-50 at
# RESNET_ARCH's widths, QuantizeTranspiler before minimize and 3 momentum
# steps at batch 32 (float32); then a freshly transpiled forward program,
# 3 calibration runs at batch 8, clone(for_test), save_inference_model /
# load_inference_model, convert_to_int8, and int8 inference at batch 8
# and 64 beside the plain float32 program
QAT_BATCH, QAT_STEPS = 32, 3
INT8_CALIB_BATCH, INT8_CALIB_RUNS = 8, 3
INT8_BATCHES = (8, 64)
INT8_TIMED = 10
# int8 card against CPU at batch 8: every int8 product is exact on both,
# but the float ops between them (batch norm, relu, pooling, the residual
# adds, cuDNN's float convolutions of nothing) and the codes of the next
# layer's activations come from float32 values summed in other orders; a
# value at a rounding tie lands one code apart, and that step propagates.
# The logits (the classifier's pre-softmax output) within this share of
# their largest magnitude; the top-1 class equal wherever the CPU's top
# two logits are further apart than that
TOL_INT8_LOGITS = 2e-2
# (b) the SRL book model (SRL_ARCH, batch SRL_BATCH) with chunk_eval on
# its Viterbi decode, as test_label_semantic_roles.py evaluates it
SRL_LABELS = 9     # sequence_tagging.build_model's label_dict_len


def _quantized_ops(program):
    return [op for op in program.global_block().ops
            if op.type in ("quantized_conv2d", "quantized_matmul")]


def _logits_name(program, predict):
    """The classifier's pre-softmax output: the input of the softmax op
    that makes `predict`."""
    for op in program.global_block().ops:
        if op.type == "softmax" and op.output("Out")[0] == predict:
            return op.input("X")[0]
    raise AssertionError(f"no softmax makes {predict}")


def _fetch_run(exe, program, feed, names, scope):
    return exe.run(program, feed=feed, fetch_list=names, scope=scope,
                   return_numpy=False)


def _timed_forward(exe, program, feed, fetch, scope, iters=INT8_TIMED):
    """ms a batch of `iters` forward runs after one warmup run, ended by
    a device synchronize."""
    exe.run(program, feed=feed, fetch_list=fetch, scope=scope,
            return_numpy=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        exe.run(program, feed=feed, fetch_list=fetch, scope=scope,
                return_numpy=False)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _build_resnet_qat(optimizer):
    """(main, startup, model): RESNET_ARCH's ResNet-50, QAT transpiled
    before the momentum optimizer (`optimizer` False: the forward
    program of bench.py's int8 recipe)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        arch = dict(RESNET_ARCH)
        lr = arch.pop("learning_rate")
        model = resnet.build_model(**arch, with_optimizer=False)
        pt.QuantizeTranspiler().training_transpile(main, startup)
        if optimizer:
            pt.optimizer.MomentumOptimizer(learning_rate=lr,
                                           momentum=0.9).minimize(
                model["loss"])
    return main, startup, model


def phase_qat_train(dev, card):
    """6u (a), training: QAT_STEPS momentum steps of the transpiled
    ResNet-50 at batch QAT_BATCH on the card; every loss finite and every
    moving-average scale state nonzero after step 1."""
    import paddle_tpu_torch as pt

    main, startup, model = _build_resnet_qat(True)
    states = sorted(v.name for v in main.list_vars()
                    if v.name.endswith(".quant_scale_state"))
    types = [op.type for op in main.global_block().ops]
    n_w = types.count("fake_quantize_dequantize_abs_max")
    n_a = types.count("fake_quantize_dequantize_moving_average_abs_max")
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = {n: torch.as_tensor(a).to(dev)
            for n, a in resnet_batch(QAT_BATCH, seed=5).items()}
    torch.cuda.reset_peak_memory_stats(dev)
    losses, ms, zero_after_1 = [], [], None
    for step in range(QAT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[model["loss"]],
                      scope=scope, return_numpy=False)
        losses.append(float(out[0].reshape(())))
        ms.append((time.perf_counter() - t0) * 1e3)
        if step == 0:
            zero_after_1 = [n for n in states
                            if not float(scope.find_var(n).reshape(-1)[0])]
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  (a) QAT training: {n_w} weight and {n_a} activation QDQ ops, "
        f"{len(states)} scale states; losses {losses}; step ms "
        f"{[round(x, 2) for x in ms]} at batch {QAT_BATCH}; peak "
        f"{peak / 1e9:.3f} GB on {card}")
    if not np.isfinite(losses).all() or zero_after_1 or not states:
        raise AssertionError(f"6u (a) QAT: losses {losses}, scale states "
                             f"still 0 after step 1: {zero_after_1}")
    return {"losses": losses, "step_ms": ms, "weight_qdq_ops": n_w,
            "activation_qdq_ops": n_a, "scale_states": len(states),
            "peak_mem_bytes": peak}


def _int8_models(dev, card):
    """bench.py's int8 recipe on the card: (converted program, its scope,
    the QDQ-simulated program, its scope, the plan, fetch names, the
    directory of the saved model)."""
    import paddle_tpu_torch as pt

    main, startup, model = _build_resnet_qat(False)
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    for i in range(INT8_CALIB_RUNS):
        calib = resnet_batch(INT8_CALIB_BATCH, seed=10 + i)["data"]
        exe.run(main, feed={"data": torch.as_tensor(calib).to(dev)},
                fetch_list=[model["predict"]], scope=scope,
                return_numpy=False)
    infer = main.clone(for_test=True)
    d = os.path.join(OUT_DIR, "int8_model")
    block = infer.global_block()
    predict = model["predict"].name
    # the classifier's logits beside its softmax: a served model's
    # outputs that no saturated softmax hides
    with pt.scope_guard(scope):
        pt.io.save_inference_model(
            d, ["data"], [block.var(predict),
                          block.var(_logits_name(infer, predict))],
            exe, main_program=infer)
    qscope = pt.Scope()
    with pt.scope_guard(qscope):
        prog, _, fetch = pt.io.load_inference_model(d, exe)
    plan = pt.quantize_module.convert_to_int8(prog, qscope)
    return prog, qscope, infer, scope, plan, fetch, d


def _check_conversion(prog, qscope, plan, dev):
    """Every conv2d and the classifier's mul converted, no simulation op
    left, the converted weights int8 on the card."""
    types = [op.type for op in prog.global_block().ops]
    qops = _quantized_ops(prog)
    kinds = [t for t, _, _ in plan.values()]
    weights = [op.input("Filter" if op.type == "quantized_conv2d"
                        else "Y")[0] for op in qops]
    bad = [w for w in weights if qscope.find_var(w).dtype != torch.int8
           or qscope.find_var(w).device != dev]
    ok = (kinds.count("quantized_conv2d") == 53
          and kinds.count("quantized_matmul") == 1
          and "conv2d" not in types and "mul" not in types
          and not any(t.startswith("fake_") for t in types)
          and len(qops) == len(plan) and not bad)
    if not ok:
        raise AssertionError(f"6u (a) convert_to_int8: plan {kinds}, ops "
                             f"{sorted(set(types))}, weights not int8 on "
                             f"the card: {bad}")
    return weights


def _code_flips(card_acts, cpu_acts, qops):
    """Over every quantized op's input activation at batch 8: the share
    of int8 codes that differ card against CPU, the share that differ by
    exactly one step, the largest difference, the count, and the share
    op by op in program order (the codes quantized on the CPU from each
    device's own activation values)."""
    from paddle_tpu_torch.ops.quantize import quantize_codes

    total = differ = one = 0
    worst, per_op = 0, []
    for op, a, b in zip(qops, card_acts, cpu_acts):
        qmax = float(2 ** (int(op.attrs.get("bit_length", 8)) - 1) - 1)
        ca = quantize_codes(a.cpu(), op.attrs["in_scale"], qmax)
        cb = quantize_codes(b.cpu(), op.attrs["in_scale"], qmax)
        d = (ca - cb).abs()
        total += d.numel()
        differ += int((d > 0).sum())
        one += int((d == 1).sum())
        worst = max(worst, int(d.max()))
        per_op.append(float((d > 0).float().mean()))
    return differ / total, one / total, worst, total, per_op


def phase_int8_serving(dev, card):
    """6u (a), serving: the converted int8 ResNet-50 (the plan, no QDQ
    left, int8 weights on the card), int8 inference at batch 8 and 64
    beside the plain float32 program, the card against the port on the
    CPU at batch 8 (the first quantized conv's int32 accumulators bit
    for bit, logits within TOL_INT8_LOGITS, top-1, the share of
    activation codes that flip) and top-1 against the QDQ-simulated
    program."""
    import shutil

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.ops.quantize import conv_accumulators

    prog, qscope, sim, sim_scope, plan, fetch, d = _int8_models(dev, card)
    weights = _check_conversion(prog, qscope, plan, dev)
    qops = _quantized_ops(prog)
    predict = fetch[0].name
    logits = _logits_name(prog, predict)
    acts = [op.input("Input" if op.type == "quantized_conv2d" else "X")[0]
            for op in qops]
    exe = pt.Executor(pt.CUDAPlace(0))
    res = {"converted_ops": len(plan), "quantized_conv2d": 53,
           "quantized_matmul": 1}
    log(f"  (a) convert_to_int8: {len(plan)} ops converted (53 "
        f"quantized_conv2d, 1 quantized_matmul), no QDQ op left, "
        f"{len(weights)} int8 weights on the card")

    # the card against the port on the CPU, batch 8: the same saved
    # model loaded and converted on the CPU
    cpu_exe = pt.Executor(pt.CPUPlace())
    cpu_scope = pt.Scope()
    with pt.scope_guard(cpu_scope):
        cprog, _, _ = pt.io.load_inference_model(d, cpu_exe)
    cplan = pt.quantize_module.convert_to_int8(cprog, cpu_scope)
    shutil.rmtree(d, ignore_errors=True)
    if cplan != plan or any(not torch.equal(
            qscope.find_var(w).cpu(), cpu_scope.find_var(w))
            for w in weights):
        raise AssertionError("6u (a): the CPU's conversion differs")
    x8 = resnet_batch(8, seed=20)["data"]
    names = [logits, predict] + acts
    on_card = [t.cpu() for t in _fetch_run(
        exe, prog, {"data": torch.as_tensor(x8).to(dev)}, names, qscope)]
    on_cpu = [torch.as_tensor(np.asarray(t)) for t in cpu_exe.run(
        cprog, feed={"data": x8}, fetch_list=names, scope=cpu_scope)]
    op0 = qops[0]
    w0 = qscope.find_var(op0.input("Filter")[0])
    _, acc_card = conv_accumulators(torch.as_tensor(x8).to(dev), w0,
                                    op0.attrs)
    _, acc_cpu = conv_accumulators(torch.as_tensor(x8), w0.cpu(),
                                   op0.attrs)
    acc_equal = bool(torch.equal(acc_card.cpu(), acc_cpu))
    lc, lp = on_card[0].float(), on_cpu[0].float()
    scale = float(lp.abs().max())
    err = float((lc - lp).abs().max()) / scale
    top2 = lp.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * TOL_INT8_LOGITS * scale
    agree = lc.argmax(1) == lp.argmax(1)
    flip_share, one_step, worst, n_codes, per_op = _code_flips(
        on_card[2:], on_cpu[2:], qops)
    log(f"  (a) int8 card vs CPU at batch 8: first quantized conv's "
        f"int32 accumulators {tuple(acc_cpu.shape)} equal bit for bit "
        f"{acc_equal}; logits max abs err {err:.3e} of their largest "
        f"{scale:.4g} (tol {TOL_INT8_LOGITS:g}); top-1 agrees on "
        f"{int(agree.sum())}/{len(agree)} ({int(clear.sum())} rows clear "
        f"of a "
        f"near-tie); activation codes differing {flip_share:.3e} of "
        f"{n_codes} ({one_step:.3e} by one step, largest {worst}); op by "
        f"op along the network {[f'{x:.1e}' for x in per_op]}")
    if not (acc_equal and err <= TOL_INT8_LOGITS
            and bool(agree[clear].all())):
        raise AssertionError("6u (a): int8 card and CPU differ beyond "
                             "the tolerances")
    res.update(first_conv_acc_equal=acc_equal, logits_max_rel_err=err,
               logits_scale=scale, top1_agree=int(agree.sum()),
               top1_rows_clear=int(clear.sum()),
               code_flip_share=flip_share, code_one_step_share=one_step,
               code_max_diff=worst, codes_compared=n_codes,
               code_flip_share_by_op=per_op)

    # int8 against the QDQ-simulated float program, and the timings
    # beside the plain float32 program (fresh weights: the same network)
    main_fp, startup_fp = pt.Program(), pt.Program()
    with pt.program_guard(main_fp, startup_fp), pt.unique_name.guard():
        arch = dict(RESNET_ARCH)
        arch.pop("learning_rate")
        fp = resnet.build_model(**arch, with_optimizer=False)
    fp_prog = main_fp.clone(for_test=True)
    fp_scope = pt.Scope()
    exe.run(startup_fp, scope=fp_scope)
    res["batches"] = {}
    for b in INT8_BATCHES:
        xb = torch.as_tensor(resnet_batch(b, seed=30 + b)["data"]).to(dev)
        q = _fetch_run(exe, prog, {"data": xb}, [logits], qscope)[0]
        s = _fetch_run(exe, sim, {"data": xb}, [logits], sim_scope)[0]
        top1 = float((q.argmax(1) == s.argmax(1)).float().mean())
        int8_ms = _timed_forward(exe, prog, {"data": xb}, [predict], qscope)
        fp_ms = _timed_forward(exe, fp_prog, {"data": xb},
                               [fp["predict"]], fp_scope)
        sim_ms = _timed_forward(exe, sim, {"data": xb}, [predict],
                                sim_scope)
        res["batches"][b] = dict(int8_ms=int8_ms, float32_ms=fp_ms,
                                 qdq_sim_ms=sim_ms, top1_vs_qdq=top1,
                                 finite=bool(torch.isfinite(q).all()))
        log(f"  (a) batch {b}: int8 {int8_ms:.2f} ms/batch, plain float32 "
            f"{fp_ms:.2f} ms/batch, QDQ-simulated {sim_ms:.2f} ms/batch; "
            f"int8 top-1 equal to the QDQ program's on {top1:.4f} on {card}")
        if not torch.isfinite(q).all():
            raise AssertionError(f"6u (a): non-finite int8 logits at "
                                 f"batch {b}")
    return res


def phase_srl_chunk_eval(dev, card):
    """6u (b): the SRL tagger at SRL_ARCH's widths, crf_decoding ->
    chunk_eval(IOB, ceil((labels - 1) / 2) chunk types) against the
    labels, card against CPU from the same weights: the decoded paths
    and the three counts equal."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import params_from_arrays
    from paddle_tpu_torch.models import sequence_tagging

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        model = sequence_tagging.build_model(**SRL_ARCH,
                                             with_optimizer=False)
        target = main.global_block().var("target")
        chunk = pt.layers.chunk_eval(
            model["crf_decode"], target, chunk_scheme="IOB",
            num_chunk_types=int(np.ceil((SRL_LABELS - 1) / 2)))
    init = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init)
    arrays = {n: v.cpu().numpy() for n, v in init.vars.items()
              if isinstance(v, torch.Tensor)}
    feed = sequence_tagging.make_fake_batch(SRL_BATCH)
    fetch = [model["crf_decode"]] + list(chunk)
    runs = {}
    for place, device in ((pt.CUDAPlace(0), dev), (pt.CPUPlace(), "cpu")):
        scope = pt.Scope()
        for n, v in params_from_arrays(arrays, device, program=main).items():
            scope.set_var(n, v)
        f = {n: torch.as_tensor(a).to(device) for n, a in feed.items()}
        runs[device] = [np.asarray(v) for v in pt.Executor(place).run(
            main, feed=f, fetch_list=fetch, scope=scope)]
    c, p = runs[dev], runs["cpu"]
    counts = [int(v.reshape(-1)[0]) for v in c[4:7]]
    equal = np.array_equal(c[0], p[0]) and all(
        np.array_equal(a, b) for a, b in zip(c[4:7], p[4:7]))
    log(f"  (b) SRL (hidden {SRL_ARCH['hidden_dim']}, depth "
        f"{SRL_ARCH['depth']}, batch {SRL_BATCH}) crf_decoding -> "
        f"chunk_eval: inferred, labelled, correct chunks {counts} on the "
        f"card, {[int(v.reshape(-1)[0]) for v in p[4:7]]} on the CPU; "
        f"paths equal {np.array_equal(c[0], p[0])}; P/R/F1 "
        f"{[float(v.reshape(-1)[0]) for v in c[1:4]]}")
    if not equal:
        raise AssertionError("6u (b): chunk counts or paths differ card "
                             "against CPU")
    return {"counts_card": counts,
            "counts_cpu": [int(v.reshape(-1)[0]) for v in p[4:7]],
            "precision_recall_f1": [float(v.reshape(-1)[0])
                                    for v in c[1:4]]}


# the ops of 6u (c) whose outputs and gradients must equal the CPU's bit
# for bit: int8 products with exact int32 accumulation
EXACT_OPS = ("quantized_conv2d", "quantized_matmul")
# warpctc's gradient at the speech shape: its log-domain alphas reach the
# loss's magnitude (~1e3 at T = 400), where a float32 ulp is ~1e-4, and
# each gradient entry (softmax minus a posterior exp(alpha + beta -
# log Z), in [-1, 1]) carries that absolute error: the gradient within
# 4 ulps of the largest loss, absolute (the loss itself within TOL_DENSE)
CTC_GRAD_ULPS = 4


def seq_struct_quant_op_cases():
    """{name: (op, ins, attrs, output slot, gradient slots)} of phase 6u
    (c): each of the 30 ops of the sequence, structured and quantize
    families on numpy inputs from a fixed seed; gradient slots None mark
    a random op.  warpctc at a speech shape (B 16, T 400, 29 classes,
    labels up to 100 long); quantized_conv2d at ResNet-50's stem, a
    3 x 3 x 512 layer and a groups-32 layer."""
    r = np.random.RandomState(21)

    def f(*s):
        return r.randn(*s).astype(np.float32)

    def lens(n, lo, hi):
        return r.randint(lo, hi + 1, (n,)).astype(np.int32)

    def codes(*s):
        return r.randint(-127, 128, s).astype(np.int8)

    q = {"in_scale": 3.1, "weight_scale": 0.42}
    sl = lens(8, 0, 40)
    sl[0] = 40
    return {
        "sequence_softmax": ("sequence_softmax", {"X": f(8, 40),
                                                  "SeqLen": sl}, {}, "Out",
                             ["X"]),
        "sequence_expand": ("sequence_expand", {"X": f(8, 1, 64),
                                                "Y": f(8, 40, 1)}, {},
                            "Out", ["X"]),
        "sequence_expand nested": ("sequence_expand", {
            "X": f(8, 20, 16), "Y": f(8, 6, 4), "SeqLen": lens(8, 0, 20),
            "YLen": lens(8, 0, 6), "YLen2": r.randint(0, 5, (8, 6)).astype(
                np.int32)}, {}, "Out", ["X"]),
        "sequence_expand_as": ("sequence_expand_as", {
            "X": f(8, 1, 64), "Y": f(8, 40, 1)}, {}, "Out", ["X"]),
        "sequence_reverse": ("sequence_reverse", {"X": f(8, 40, 32),
                                                  "SeqLen": sl}, {}, "Y",
                             ["X"]),
        "sequence_concat": ("sequence_concat", {
            "X": [f(8, 20, 16), f(8, 10, 16), f(8, 30, 16)],
            "SeqLen": [lens(8, 0, 20), lens(8, 0, 10), lens(8, 0, 30)]},
            {}, "Out", ["X"]),
        "sequence_pad": ("sequence_pad", {
            "X": f(8, 40, 16), "SeqLen": sl,
            "PadValue": np.array([0.25], np.float32)},
            {"padded_length": 64}, "Out", ["X"]),
        "sequence_unpad": ("sequence_unpad", {
            "X": f(8, 40, 16), "Length": sl.astype(np.int64)}, {}, "Out",
            ["X"]),
        "sequence_slice": ("sequence_slice", {
            "X": f(8, 40, 16), "Offset": r.randint(0, 20, (8, 1)),
            "Length": r.randint(0, 21, (8, 1))}, {}, "Out", ["X"]),
        "sequence_enumerate": ("sequence_enumerate", {
            "X": r.randint(0, 50, (8, 40)).astype(np.int32)},
            {"win_size": 4, "pad_value": -1}, "Out", []),
        "sequence_erase": ("sequence_erase", {
            "X": r.randint(0, 10, (8, 40)).astype(np.int32)},
            {"tokens": [0, 3, 7]}, "Out", []),
        "im2sequence": ("im2sequence", {"X": f(4, 3, 32, 32)},
                        {"kernels": [4, 4], "strides": [4, 4]}, "Out",
                        ["X"]),
        "sequence_scatter": ("sequence_scatter", {
            "X": f(8, 100), "Ids": r.randint(-5, 105, (8, 30)).astype(
                np.int32), "Updates": f(8, 30), "IdsLen": lens(8, 0, 30)},
            {}, "Out", ["X", "Updates"]),
        "sequence_reshape": ("sequence_reshape", {"X": f(8, 40, 16),
                                                  "SeqLen": sl},
                             {"new_dim": 32}, "Out", ["X"]),
        "lod_reset": ("lod_reset", {"X": f(8, 40, 16), "SeqLen": sl},
                      {"target_lod": [0, 7, 7, 19,
                                      int(sl.sum()) // 2, int(sl.sum())]},
                      "Out", ["X"]),
        # structured
        "chunk_eval": ("chunk_eval", {
            "Inference": r.randint(0, 9, (32, 100)).astype(np.int32),
            "Label": r.randint(0, 9, (32, 100)).astype(np.int32),
            "SeqLen": lens(32, 0, 100)},
            {"num_chunk_types": 4, "excluded_chunk_types": [1]}, "F1-Score",
            []),
        "edit_distance": ("edit_distance", {
            "Hyps": r.randint(0, 6, (32, 60)).astype(np.int32),
            "Refs": r.randint(0, 6, (32, 50)).astype(np.int32),
            "HypsLen": lens(32, 0, 60), "RefsLen": lens(32, 0, 50)},
            {"normalized": True, "ignored_tokens": [0]}, "Out", []),
        "warpctc speech": ("warpctc", {
            "Logits": f(16, 400, 29), "Label": r.randint(
                1, 29, (16, 100)).astype(np.int32),
            "LogitsLen": lens(16, 300, 400), "LabelLen": lens(16, 50, 100)},
            {"blank": 0, "norm_by_times": False}, "Loss", ["Logits"]),
        "ctc_align": ("ctc_align", {
            "Input": r.randint(0, 29, (32, 400)).astype(np.int32),
            "SeqLen": lens(32, 0, 400)}, {"blank": 0}, "Output", []),
        "hierarchical_sigmoid": ("hierarchical_sigmoid", {
            "X": f(64, 128), "Label": r.randint(0, 1000, (64, 1)),
            "W": f(999, 128) * 0.1, "Bias": f(999) * 0.1},
            {"num_classes": 1000}, "Out", ["X", "W", "Bias"]),
        "sampling_id": ("sampling_id", {"X": np.tile(np.array(
            [0.1, 0.2, 0.3, 0.4, 0.0], np.float32), (4096, 1))}, {}, "Out",
            None),
        "precision_recall": ("precision_recall", {
            "Indices": r.randint(0, 10, (256, 1)).astype(np.int32),
            "MaxProbs": r.rand(256, 1).astype(np.float32),
            "Labels": r.randint(0, 10, (256, 1)).astype(np.int32),
            "Weights": r.rand(256, 1).astype(np.float32),
            "StatesInfo": r.randint(0, 50, (10, 4)).astype(np.float32)},
            {"class_number": 10}, "BatchMetrics", []),
        "mean_iou": ("mean_iou", {
            "Predictions": r.randint(0, 21, (4, 64, 64)).astype(np.int32),
            "Labels": r.randint(0, 21, (4, 64, 64)).astype(np.int32),
            "InWrongs": [r.randint(0, 9, (21,)).astype(np.int32)],
            "InCorrects": [r.randint(0, 9, (21,)).astype(np.int32)],
            "InMeanIou": [np.array([0.5], np.float32)]},
            {"num_classes": 21}, "OutMeanIou", []),
        "modified_huber_loss": ("modified_huber_loss", {
            "X": f(256, 1) * 2, "Y": r.randint(0, 2, (256, 1)).astype(
                np.float32)}, {}, "Out", ["X"]),
        "positive_negative_pair": ("positive_negative_pair", {
            "Score": f(128, 2), "Label": r.randint(0, 3, (128, 1)).astype(
                np.float32), "QueryID": r.randint(0, 8, (128, 1)).astype(
                np.int32), "Weight": r.rand(128, 1).astype(np.float32)},
            {"column": 1}, "PositivePair", []),
        # quantize
        "fake_quantize_abs_max": ("fake_quantize_abs_max", {
            "X": f(64, 1024)}, {"bit_length": 8}, "Out", []),
        "fake_dequantize_max_abs": ("fake_dequantize_max_abs", {
            "X": codes(64, 1024).astype(np.float32),
            "Scale": np.array([2.7], np.float32)}, {"max_range": 127.0},
            "Out", []),
        "fake_quantize_dequantize_abs_max": (
            "fake_quantize_dequantize_abs_max", {"X": f(64, 1024)},
            {"bit_length": 8}, "Out", ["X"]),
        "fake_qdq_moving_average first step": (
            "fake_quantize_dequantize_moving_average_abs_max", {
                "X": f(8, 256, 14, 14), "InScale": np.zeros(1, np.float32)},
            {"moving_rate": 0.9}, "Out", ["X"]),
        "fake_qdq_moving_average running": (
            "fake_quantize_dequantize_moving_average_abs_max", {
                "X": f(8, 256, 14, 14), "InScale": np.array([3.5],
                                                            np.float32)},
            {"moving_rate": 0.9}, "Out", ["X"]),
        "quantized_conv2d stem": ("quantized_conv2d", {
            "Input": f(2, 3, 224, 224), "Filter": codes(64, 3, 7, 7)},
            dict(q, strides=2, paddings=3), "Output", []),
        "quantized_conv2d 3x3x512": ("quantized_conv2d", {
            "Input": f(2, 512, 7, 7), "Filter": codes(512, 512, 3, 3)},
            dict(q, paddings=1), "Output", []),
        "quantized_conv2d groups 32": ("quantized_conv2d", {
            "Input": f(2, 256, 28, 28), "Filter": codes(256, 8, 3, 3)},
            dict(q, paddings=1, groups=32), "Output", []),
        "quantized_matmul fc": ("quantized_matmul", {
            "X": f(8, 2048), "Y": codes(2048, 1000)}, q, "Out", []),
    }


def _check_sampling(got, ins):
    ids = got["Out"][0]
    if not (ids.shape == (4096,) and ids.dtype == np.int32
            and ids.min() >= 0 and ids.max() <= 3):
        raise AssertionError(f"6u (c) sampling_id: ids {ids.shape} "
                             f"{ids.dtype} in [{ids.min()}, {ids.max()}]")


def phase_seq_struct_quant_ops(dev):
    """6u (c): each op of the sequence, structured and quantize families
    on the card against the port on the CPU (`seq_struct_quant_op_cases`):
    floating outputs and gradients within TOL_DENSE, integer outputs
    exactly, the int8 products (EXACT_OPS) bit for bit, sampling_id by
    shape, dtype and range."""
    cases = seq_struct_quant_op_cases()
    ops = sorted({c[0] for c in cases.values()})
    log(f"phase 6u (c): {len(ops)} ops of the sequence, structured and "
        f"quantize families, {len(cases)} cases, card vs CPU")
    worst, n_cmp, bits = {}, 0, {}
    for name, (op, ins, attrs, out_slot, grad_slots) in sorted(
            cases.items()):
        got, g_card = _run_dense(op, ins, attrs, dev, grad_slots, out_slot)
        if grad_slots is None:
            _check_sampling(got, ins)
            continue
        want, g_cpu = _run_dense(op, ins, attrs, "cpu", grad_slots,
                                 out_slot)
        pairs = [(f"{s}[{i}]", a, b) for s in want
                 for i, (a, b) in enumerate(zip(got[s], want[s]))]
        pairs += [(f"d/d{s}", g_card[s], g_cpu[s]) for s in g_cpu]
        for what, a, b in pairs:
            n_cmp += 1
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"phase 6u (c) {name} {what}: "
                                     f"{a.shape} {a.dtype} vs {b.shape} "
                                     f"{b.dtype}")
            same = np.array_equal(a, b)
            bits[name] = bits.get(name, True) and same
            if op in EXACT_OPS or not np.issubdtype(b.dtype, np.floating):
                if not same:
                    raise AssertionError(f"phase 6u (c) {name} {what}: not "
                                         f"equal")
                err = 0.0
            else:
                fin = np.isfinite(b)
                tol = dict(TOL_DENSE)
                if op == "warpctc" and what.startswith("d/d"):
                    tol = dict(rtol=0.0, atol=CTC_GRAD_ULPS * float(
                        np.spacing(np.abs(want["Loss"][0]).max())))
                if not np.array_equal(fin, np.isfinite(a)) or not \
                        np.allclose(a[fin], b[fin], **tol):
                    raise AssertionError(
                        f"phase 6u (c) {name} {what}: card vs CPU max abs "
                        f"err {np.abs(a[fin] - b[fin]).max():.3e} (tol "
                        f"{tol})")
                err = float(np.abs(a[fin] - b[fin]).max()) if fin.any() \
                    else 0.0
            worst[name] = max(worst.get(name, 0.0), err)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    log(f"  {n_cmp} outputs and gradients compared, all within tolerance "
        f"(rtol {TOL_DENSE['rtol']:g}, atol {TOL_DENSE['atol']:g}; integer "
        f"outputs and {', '.join(EXACT_OPS)} exact); bit-equal cases "
        f"{sorted(k for k, v in bits.items() if v)}; largest abs errors "
        f"{[(k, f'{v:.2e}') for k, v in top]}")
    return {"ops": len(ops), "cases": len(cases), "compared": n_cmp,
            "max_abs_err": worst, "bit_equal": bits}


def phase_qat_int8(dev, card):
    """6u: (a) QAT training and int8 serving of ResNet-50, (b) the SRL
    tagger's chunk evaluation card against CPU, with the kernel counts
    zeroed just before (a) and read after (b); (c) the 30 ops card
    against CPU."""
    from paddle_tpu_torch.ops import kernels

    log(f"phase 6u: QAT ResNet-50 ({RESNET_ARCH['depth']} layers, "
        f"{RESNET_ARCH['class_dim']} classes) trained and served int8; SRL "
        f"chunk evaluation; the sequence, structured and quantize families")
    res, seconds = {}, {}

    def part(key, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[key] = time.perf_counter() - t0
        log(f"  [6u {key}: {seconds[key]:.1f} s]")
        return out

    kernels.reset_counts()
    res["qat_train"] = part("qat_train", phase_qat_train, dev, card)
    torch.cuda.empty_cache()
    res["int8"] = part("int8", phase_int8_serving, dev, card)
    torch.cuda.empty_cache()
    res["srl_chunk_eval"] = part("srl", phase_srl_chunk_eval, dev, card)
    counts = kernels.counts()
    log(f"  kernel counts over (a) and (b): launches "
        f"{ {k: v for k, v in counts['launches'].items() if v} }, plain "
        f"calls { {k: v for k, v in counts['plain'].items() if v} }")
    res["ops"] = part("ops", phase_seq_struct_quant_ops, dev)
    res["seconds"] = seconds
    res["counts"] = counts
    res["launches"] = counts["launches"]
    return res


# ---------------------------------------------------------------------------
# phase 6v: Faster R-CNN ResNet-50-C4, the detection and vision families
# ---------------------------------------------------------------------------

# upstream Fluid PaddleCV/rcnn's ResNet-50-C4 Faster R-CNN at its
# per-card training batch (one 800 x 1333 image) and its RPN, sampling and
# test settings; 8 seeded ground-truth boxes in 80 classes
FRCNN = dict(image=(800, 1333), batch=1, classes=81, gt_boxes=8,
             stages=(3, 4, 6, 3), base=64,
             anchor_sizes=(32.0, 64.0, 128.0, 256.0, 512.0),
             aspect_ratios=(0.5, 1.0, 2.0), rpn_batch=256,
             train_nms=(12000, 2000), test_nms=(6000, 1000), rois=512,
             roi_resolution=14)
FRCNN_STEPS = 3
FRCNN_LR = 0.01
FRCNN_BRANCH_SCALE = 0.2   # each bottleneck's last frozen affine scale


def _conv_affine(fluid, x, filters, size, stride, name, act=None,
                 scale=1.0):
    """conv2d (no bias, He init) and the frozen batch norm of upstream's
    rcnn trunk: an affine_channel whose Scale and Bias are parameters
    that do not train."""
    L = fluid.layers
    conv = L.conv2d(x, filters, size, stride=stride,
                    padding=(size - 1) // 2, bias_attr=False,
                    param_attr=fluid.ParamAttr(
                        name=f"{name}_weights",
                        initializer=fluid.initializer.MSRA(uniform=False)))
    helper = L.LayerHelper("affine_channel")

    def frozen(suffix, value):
        return helper.create_parameter(
            fluid.ParamAttr(name=f"{name}_{suffix}", trainable=False,
                            initializer=fluid.initializer.Constant(value)),
            shape=[filters], dtype="float32")

    out = L.affine_channel(conv, scale=frozen("scale", scale),
                           bias=frozen("offset", 0.0))
    return L.relu(out) if act == "relu" else out


def _bottleneck(fluid, x, ch_out, stride, name):
    """models/resnet.py's bottleneck (stride on the first 1 x 1), its
    batch norms frozen affines; the branch's last scale
    FRCNN_BRANCH_SCALE keeps the untrained trunk's activations in range."""
    if x.shape[1] != ch_out * 4:
        short = _conv_affine(fluid, x, ch_out * 4, 1, stride,
                             f"{name}_branch1")
    else:
        short = x
    c1 = _conv_affine(fluid, x, ch_out, 1, stride, f"{name}_branch2a",
                      "relu")
    c2 = _conv_affine(fluid, c1, ch_out, 3, 1, f"{name}_branch2b", "relu")
    c3 = _conv_affine(fluid, c2, ch_out * 4, 1, 1, f"{name}_branch2c",
                      scale=FRCNN_BRANCH_SCALE)
    return fluid.layers.elementwise_add(short, c3, act="relu")


def _layer_warp(fluid, x, ch_out, count, stride, name):
    """models/resnet.py's layer_warp."""
    for i in range(count):
        x = _bottleneck(fluid, x, ch_out, stride if i == 0 else 1,
                        f"{name}{chr(ord('a') + i)}")
    return x


def _frcnn_head(fluid, cfg, body, rois, n_rois):
    """RoIAlign on res4, res5 over the RoIs, average pooling, the class
    and box heads: (cls_score (R, C), bbox_pred (R, 4C))."""
    L = fluid.layers
    b = cfg["batch"]
    ids = np.repeat(np.arange(b), n_rois)[:, None].astype(np.float32)
    rois5 = L.concat([L.assign(ids), L.reshape(rois, [-1, 4])], axis=1)
    res = cfg["roi_resolution"]
    pooled = L.roi_align(body, rois5, res, res, 1.0 / 16.0,
                         sampling_ratio=0)
    res5 = _layer_warp(fluid, pooled, cfg["base"] * 8, cfg["stages"][3], 2,
                       "res5")
    feat = L.pool2d(res5, pool_type="avg", global_pooling=True)
    c = cfg["classes"]

    def fc(x, size, std, name):
        return L.fc(x, size,
                    param_attr=fluid.ParamAttr(
                        name=f"{name}_w",
                        initializer=fluid.initializer.Normal(0.0, std)),
                    bias_attr=fluid.ParamAttr(
                        name=f"{name}_b",
                        initializer=fluid.initializer.Constant(0.0)))

    return fc(feat, c, 0.01, "cls_score"), fc(feat, 4 * c, 0.001,
                                              "bbox_pred")


def faster_rcnn(fluid, cfg, train=True, use_random=True):
    """Faster R-CNN with a ResNet-C4 trunk (res2-res4 of
    models/resnet.py's blocks, frozen affines), built with `fluid`'s
    layers as upstream Fluid's PaddleCV/rcnn builds it.  train: the RPN
    and RCNN losses (RPN sigmoid CE + smooth L1 at sigma 3, RCNN softmax
    CE + smooth L1) under momentum with L2; returns {name: Variable}.
    Else the detection program: proposals at the test setting, the head,
    box_coder decoding, box_clip, softmax, multiclass_nms and
    detection_map against the ground truth."""
    L = fluid.layers
    b, (h, w), c = cfg["batch"], cfg["image"], cfg["classes"]
    g = cfg["gt_boxes"]
    image = L.data("image", shape=[b, 3, h, w], append_batch_size=False)
    im_info = L.data("im_info", shape=[b, 3], append_batch_size=False)
    gt_box = L.data("gt_box", shape=[b, g, 4], append_batch_size=False)
    gt_label = L.data("gt_label", shape=[b, g], dtype="int32",
                      append_batch_size=False)
    is_crowd = L.data("is_crowd", shape=[b, g], dtype="int32",
                      append_batch_size=False)
    base = cfg["base"]
    x = _conv_affine(fluid, image, base, 7, 2, "conv1", "relu")
    x = L.pool2d(x, 3, "max", 2, 1)
    for i, (count, stride) in enumerate(zip(cfg["stages"][:3], (1, 2, 2))):
        x = _layer_warp(fluid, x, base * 2 ** i, count, stride,
                        f"res{i + 2}")
    body = x                                          # stride 16
    dim = body.shape[1]
    na = len(cfg["anchor_sizes"]) * len(cfg["aspect_ratios"])

    def conv(xx, filters, size, name, act=None):
        return L.conv2d(xx, filters, size, padding=(size - 1) // 2, act=act,
                        param_attr=fluid.ParamAttr(
                            name=f"{name}_w",
                            initializer=fluid.initializer.Normal(0.0, 0.01)),
                        bias_attr=fluid.ParamAttr(
                            name=f"{name}_b",
                            initializer=fluid.initializer.Constant(0.0)))

    rpn = conv(body, dim, 3, "conv_rpn", "relu")
    rpn_cls = conv(rpn, na, 1, "rpn_cls_score")
    rpn_bbox = conv(rpn, 4 * na, 1, "rpn_bbox_pred")
    anchors, variances = L.detection.anchor_generator(
        rpn, anchor_sizes=list(cfg["anchor_sizes"]),
        aspect_ratios=list(cfg["aspect_ratios"]),
        variance=[1.0, 1.0, 1.0, 1.0], stride=[16.0, 16.0])
    pre_n, post_n = cfg["train_nms" if train else "test_nms"]
    rois, rois_num = L.detection.generate_proposals(
        L.sigmoid(rpn_cls), rpn_bbox, im_info, anchors, variances,
        pre_nms_top_n=pre_n, post_nms_top_n=post_n, nms_thresh=0.7,
        min_size=0.0)
    out = dict(rois=rois, rois_num=rois_num)
    if train:
        fh, fw = body.shape[2], body.shape[3]
        score_flat = L.reshape(L.transpose(rpn_cls, perm=[0, 2, 3, 1]),
                               shape=[0, -1, 1])
        delta_flat = L.reshape(L.transpose(
            L.reshape(rpn_bbox, shape=[0, na, 4, fh, fw]),
            perm=[0, 3, 4, 1, 2]), shape=[0, -1, 4])
        (pred_score, pred_loc, tgt_lbl, tgt_bbox, in_w,
         score_w) = L.detection.rpn_target_assign(
            delta_flat, score_flat, L.reshape(anchors, shape=[-1, 4]),
            variances, gt_box, is_crowd, im_info,
            rpn_batch_size_per_im=cfg["rpn_batch"], rpn_straddle_thresh=0.0,
            rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
            rpn_negative_overlap=0.3, use_random=use_random)
        n_w = L.reduce_sum(score_w)
        rpn_cls_loss = L.elementwise_div(L.reduce_sum(L.elementwise_mul(
            L.sigmoid_cross_entropy_with_logits(
                L.squeeze(pred_score, axes=[2]), L.cast(tgt_lbl, "float32")),
            score_w)), n_w)
        f4 = int(cfg["rpn_batch"] * 0.5) * 4
        in_w4 = L.reshape(in_w, shape=[0, f4])
        rpn_reg_loss = L.elementwise_div(L.reduce_sum(L.smooth_l1(
            L.reshape(pred_loc, shape=[0, f4]),
            L.reshape(tgt_bbox, shape=[0, f4]),
            inside_weight=in_w4, outside_weight=in_w4, sigma=3.0)),
            L.elementwise_max(n_w, L.fill_constant([1], "float32", 1.0)))
        (s_rois, labels, tgts, s_in_w, s_out_w,
         s_num) = L.detection.generate_proposal_labels(
            rois, gt_label, is_crowd, gt_box, im_info,
            batch_size_per_im=cfg["rois"], fg_fraction=0.25, fg_thresh=0.5,
            bg_thresh_hi=0.5, bg_thresh_lo=0.0,
            bbox_reg_weights=[0.1, 0.1, 0.2, 0.2], class_nums=c,
            use_random=use_random, rpn_rois_num=rois_num)
        cls_score, bbox_pred = _frcnn_head(fluid, cfg, body, s_rois,
                                           cfg["rois"])
        lab = L.reshape(L.cast(labels, "int64"), shape=[-1, 1])
        loss_cls = L.mean(L.softmax_with_cross_entropy(cls_score, lab,
                                                       ignore_index=-1))
        loss_bbox = L.mean(L.smooth_l1(
            bbox_pred, L.reshape(tgts, shape=[-1, 4 * c]),
            inside_weight=L.reshape(s_in_w, shape=[-1, 4 * c]),
            outside_weight=L.reshape(s_out_w, shape=[-1, 4 * c]),
            sigma=1.0))
        loss = L.sums([rpn_cls_loss, rpn_reg_loss, loss_cls, loss_bbox])
        fluid.optimizer.MomentumOptimizer(
            learning_rate=FRCNN_LR, momentum=0.9,
            regularization=fluid.regularizer.L2Decay(1e-4)).minimize(loss)
        out.update(loss=loss, rpn_cls_loss=rpn_cls_loss,
                   rpn_reg_loss=rpn_reg_loss, loss_cls=loss_cls,
                   loss_bbox=loss_bbox, fg_num=L.reduce_sum(tgt_lbl),
                   rois_fg=labels, sampled=s_num, score_w=score_w)
        return out
    cls_score, bbox_pred = _frcnn_head(fluid, cfg, body, rois, post_n)
    r = b * post_n
    prob = L.softmax(cls_score)                                   # (R, C)
    pvar = L.assign(np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (r, 1)))
    deltas = L.transpose(L.reshape(bbox_pred, shape=[r, c, 4]),
                         perm=[1, 0, 2])                          # (C, R, 4)
    boxes = L.detection.box_coder(L.reshape(rois, shape=[r, 4]), pvar,
                                  deltas, code_type="decode_center_size",
                                  box_normalized=False)
    boxes = L.reshape(L.transpose(boxes, perm=[1, 0, 2]),
                      shape=[b, post_n * c, 4])
    boxes = L.detection.box_clip(boxes, im_info)
    norm = L.assign(np.float32([1.0 / w, 1.0 / h, 1.0 / w, 1.0 / h]))
    boxes = L.elementwise_mul(boxes, norm)
    # class c's scores on its own boxes, 0 on the other classes' boxes:
    # (C, R, 1) x eye (C, 1, C) → (C, N, P * C) → (N, C, P * C)
    eye = L.assign(np.eye(c, dtype=np.float32).reshape(c, 1, c))
    scores = L.transpose(L.reshape(L.elementwise_mul(
        L.reshape(L.transpose(prob, perm=[1, 0]), shape=[c, r, 1]), eye),
        shape=[c, b, post_n * c]), perm=[1, 0, 2])
    dets, det_num = L.detection.multiclass_nms(
        boxes, scores, score_threshold=0.05, nms_top_k=post_n,
        keep_top_k=100, nms_threshold=0.5, background_label=0)
    gt_norm = L.data("gt_norm", shape=[b, g, 6], append_batch_size=False)
    m_ap = L.detection.detection_map(dets, gt_norm, class_num=c,
                                     background_label=0,
                                     overlap_threshold=0.5,
                                     ap_version="integral")
    out.update(prob=prob, boxes=boxes, dets=dets, det_num=det_num,
               m_ap=m_ap)
    return out


def frcnn_feed(cfg, seed=0):
    """One synthetic batch: pixels N(0, 1), `gt_boxes` boxes an image of
    32-400 pixels a side with classes in 1..C-1, im_info [h, w, 1], and
    the boxes normalized for detection_map (label, box, difficult 0)."""
    rng = np.random.RandomState(seed)
    b, (h, w), g = cfg["batch"], cfg["image"], cfg["gt_boxes"]
    lo, hi = min(32.0, h / 4), min(400.0, h / 2)
    size = rng.uniform(lo, hi, (b, g, 2))
    x1 = rng.uniform(0, w - size[..., 0] - 1)
    y1 = rng.uniform(0, h - size[..., 1] - 1)
    boxes = np.stack([x1, y1, x1 + size[..., 0], y1 + size[..., 1]],
                     axis=-1).astype(np.float32)
    labels = rng.randint(1, cfg["classes"], (b, g)).astype(np.int32)
    scale = np.float32([w, h, w, h])
    return {"image": rng.randn(b, 3, h, w).astype(np.float32),
            "im_info": np.tile(np.float32([h, w, 1.0]), (b, 1)),
            "gt_box": boxes, "gt_label": labels,
            "is_crowd": np.zeros((b, g), np.int32),
            "gt_norm": np.concatenate(
                [labels[..., None].astype(np.float32), boxes / scale,
                 np.zeros((b, g, 1), np.float32)], axis=-1)}


TOL_BOX = dict(rtol=0.0, atol=1e-3)   # pixel boxes to 1333 (ulp 1.2e-4)
# gradients: TOL_DENSE plus this share of their largest magnitude (the
# RoI ops' backward scatter-adds overlapping samples, in another order on
# each device, so an entry near 0 keeps the error of its largest terms)
TOL_GRAD_SHARE = 1e-5
FRCNN_ALIGN_CHANNELS = 128            # roi_align's CPU check: res4's first
ON_PATH = ("anchor_generator", "generate_proposals", "rpn_target_assign",
           "generate_proposal_labels", "roi_align")
BOX_SLOTS = ("RpnRois", "Rois", "Anchors")
NMS_OPS = ("multiclass_nms", "generate_proposals")


def _frcnn_build(cfg, train, use_random=True):
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        out = faster_rcnn(pt, cfg, train=train, use_random=use_random)
    return main, startup, out


def _cpu_op(op, ins_np, attrs):
    """One port op on the CPU from numpy inputs (an array or a list of
    arrays a slot) → {slot: its first output as numpy}."""
    got, _ = _run_dense(op, ins_np, attrs, "cpu", None, None)
    return {s: v[0] for s, v in got.items()}


def _grad_tol(b):
    return dict(rtol=TOL_DENSE["rtol"], atol=max(
        TOL_DENSE["atol"], TOL_GRAD_SHARE * float(np.abs(b).max(initial=0))))


def _compare(label, what, a, b, tol):
    """Card `a` against CPU `b`: integers equal, floats within `tol`;
    → max abs err."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{label} {what}: {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    if not np.issubdtype(b.dtype, np.floating):
        if not np.array_equal(a, b):
            raise AssertionError(f"{label} {what}: integers differ at "
                                 f"{int((a != b).sum())} of {a.size}")
        return 0.0
    if not np.allclose(a, b, **tol):
        raise AssertionError(f"{label} {what}: max abs err "
                             f"{np.abs(a - b).max():.3e} (tol {tol})")
    return float(np.abs(a - b).max()) if a.size else 0.0


def _ops_card_vs_cpu(label, program, vals, types, dev):
    """Each op of `types` in `program`, run on the CPU from the inputs the
    card run fetched (`vals`), against the card's outputs: integer
    outputs equal, boxes within TOL_BOX, the rest within TOL_DENSE; the
    NMS ops' kept sets equal.  roi_align on res4's first
    FRCNN_ALIGN_CHANNELS channels (each channel is independent), with
    its input gradient card against CPU."""
    errs = {}
    for op in program.global_block().ops:
        if op.type not in types:
            continue
        desc = op.desc
        ins = {s: [vals[n] for n in ns] for s, ns in desc.inputs.items()}
        if op.type == "roi_align":
            ins["X"] = [ins["X"][0][:, :FRCNN_ALIGN_CHANNELS]]
        t0 = time.perf_counter()
        cpu = _cpu_op(op.type, ins, desc.attrs)
        for slot, ns in desc.outputs.items():
            card = vals[ns[0]]
            if op.type == "roi_align":
                card = card[:, :FRCNN_ALIGN_CHANNELS]
            tol = TOL_BOX if slot in BOX_SLOTS else TOL_DENSE
            errs[f"{op.type}.{slot}"] = _compare(label, f"{op.type}.{slot}",
                                                 card, cpu[slot], tol)
        if op.type == "roi_align":
            attrs = dict(desc.attrs)
            one = {s: v[0] for s, v in ins.items()}
            _, g_card = _run_dense(op.type, one, attrs, dev, ["X"], "Out")
            _, g_cpu = _run_dense(op.type, one, attrs, "cpu", ["X"], "Out")
            errs["roi_align.dX"] = _compare(label, "roi_align dX",
                                            g_card["X"], g_cpu["X"],
                                            _grad_tol(g_cpu["X"]))
        cpu_s = time.perf_counter() - t0
        log(f"  {label}: {op.type} card vs CPU ({cpu_s:.1f} s on the CPU)")
    return errs


def phase_frcnn(dev, card):
    """6v (a) and (b): Faster R-CNN ResNet-50-C4 at upstream's training
    setting (FRCNN_STEPS momentum steps, use_random), one more step with
    use_random=False whose detection ops run again on the CPU from the
    card's inputs, then the detection program at the test setting."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.registry import OpContext, get_op_impl
    from paddle_tpu_torch.ops import detection

    cfg = FRCNN
    log(f"phase 6v (a): Faster R-CNN ResNet-50-C4, {cfg['image'][0]} x "
        f"{cfg['image'][1]}, {cfg['classes']} classes, {cfg['gt_boxes']} "
        f"gt boxes, {FRCNN_STEPS} momentum steps (lr {FRCNN_LR}), float32")
    torch.cuda.reset_peak_memory_stats(dev)
    main, startup, out = _frcnn_build(cfg, True, use_random=True)
    fixed, _, fout = _frcnn_build(cfg, True, use_random=False)
    infer, _, iout = _frcnn_build(cfg, False)
    types = [op.type for op in main.global_block().ops]
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed_np = frcnn_feed(cfg, 0)
    feed = {k: torch.as_tensor(v).to(dev) for k, v in feed_np.items()}
    train_feed = {k: v for k, v in feed.items()
                  if main.global_block().has_var(k)}
    names = ("loss", "rpn_cls_loss", "rpn_reg_loss", "loss_cls",
             "loss_bbox", "fg_num", "score_w", "rois_fg", "sampled",
             "rois_num")
    steps = []
    for _ in range(FRCNN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v = dict(zip(names, exe.run(main, feed=train_feed, scope=scope,
                                    fetch_list=[out[n] for n in names])))
        ms = (time.perf_counter() - t0) * 1e3
        rec = {n: float(np.asarray(v[n]).reshape(-1)[0])
               for n in names[:5]}
        rec.update(ms=ms, rpn_fg=int(v["fg_num"].sum()),
                   rpn_sampled=int(v["score_w"].sum()),
                   rcnn_fg=int((v["rois_fg"] > 0).sum()),
                   rcnn_sampled=int(v["sampled"].sum()),
                   proposals=int(v["rois_num"].sum()),
                   nms_iterations=detection.nms_iterations[
                       "generate_proposals"])
        steps.append(rec)
        log(f"  step {len(steps)}: loss {rec['loss']:.6f} (rpn cls "
            f"{rec['rpn_cls_loss']:.4f}, rpn box {rec['rpn_reg_loss']:.4f}, "
            f"rcnn cls {rec['loss_cls']:.4f}, rcnn box "
            f"{rec['loss_bbox']:.4f}); RPN fg {rec['rpn_fg']} of "
            f"{rec['rpn_sampled']}, RCNN fg {rec['rcnn_fg']} of "
            f"{rec['rcnn_sampled']}, {rec['proposals']} proposals, NMS "
            f"{rec['nms_iterations']} iterations; {ms:.1f} ms")
        if not (np.isfinite([rec[n] for n in names[:5]]).all()
                and rec["rpn_fg"] <= cfg["rpn_batch"] // 2
                and rec["rpn_sampled"] <= cfg["rpn_batch"]
                and rec["rcnn_fg"] <= cfg["rois"] // 4
                and rec["rcnn_sampled"] <= cfg["rois"]):
            raise AssertionError(f"phase 6v (a): step {rec}")
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  {types.count('affine_channel')} frozen affine_channel ops, "
        f"{types.count('conv2d')} conv2d; peak device memory "
        f"{peak / 1e9:.3f} GB on {card}")
    # one more step, use_random=False: every detection op's inputs and
    # outputs fetched, the ops run again on the CPU
    io = sorted({n for op in fixed.global_block().ops if op.type in ON_PATH
                 for ns in list(op.desc.inputs.values())
                 + list(op.desc.outputs.values()) for n in ns})
    vals = dict(zip(io, exe.run(fixed, feed=train_feed, fetch_list=io,
                                scope=scope)))
    errs = _ops_card_vs_cpu("phase 6v (a)", fixed, vals, ON_PATH, dev)
    log(f"  use_random=False step: {len(errs)} outputs card vs CPU, "
        f"integers equal; largest errors "
        f"{sorted(errs.items(), key=lambda kv: -kv[1])[:4]}")
    # warm steps, then a profiled window (where a step's time goes)
    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        exe.run(main, feed=train_feed, fetch_list=[out["loss"]], scope=scope)
        warm.append((time.perf_counter() - t0) * 1e3)
    log(f"  two more steps: {warm[0]:.1f}, {warm[1]:.1f} ms")
    prof = _profile_train_step(exe, main, train_feed, out["loss"], scope,
                               label="phase 6v (a), profiled")
    # (b) the detection program at upstream's test setting
    log("phase 6v (b): detection at the test setting (pre-NMS "
        f"{cfg['test_nms'][0]}, post-NMS {cfg['test_nms'][1]}; "
        "multiclass_nms score 0.05, NMS 0.5, keep 100)")
    det_io = sorted({n for op in infer.global_block().ops
                     if op.type in NMS_OPS
                     for ns in list(op.desc.inputs.values())
                     + list(op.desc.outputs.values()) for n in ns})
    fetch = ["rois_num", "dets", "det_num", "m_ap"]
    t0 = time.perf_counter()
    got = exe.run(infer, feed=feed, fetch_list=[iout[k] for k in fetch]
                  + det_io, scope=scope)
    det_ms = (time.perf_counter() - t0) * 1e3
    dvals = dict(zip(det_io, got[len(fetch):]))
    det = dict(zip(fetch, got[:len(fetch)]))
    m_ap = float(np.asarray(det["m_ap"]).reshape(()))
    n_det = int(det["det_num"].sum())
    if not (0.0 <= m_ap <= 1.0 and 0 <= n_det <= 100):
        raise AssertionError(f"phase 6v (b): mAP {m_ap}, {n_det} detections")
    timing = {}
    for op in infer.global_block().ops:
        if op.type not in NMS_OPS:
            continue
        ins = {s: [torch.as_tensor(dvals[n]).to(dev) for n in ns]
               for s, ns in op.desc.inputs.items()}
        impl, ctx = get_op_impl(op.type), OpContext((0, 7), 11, device=dev)
        # multiclass_nms also with every candidate valid (score 0): an
        # untrained head's class scores (~1/C) lie under 0.05
        variants = [("", dict(op.desc.attrs))]
        if op.type == "multiclass_nms":
            variants.append((" all valid", dict(op.desc.attrs,
                                                score_threshold=0.0)))
        for tag, attrs in variants:
            ms = cuda_ms(lambda: impl(ctx, ins, attrs), iters=5, warmup=1)
            key = op.type + tag.replace(" ", "_")
            valid = None
            if op.type == "multiclass_nms":
                sc = ins["Scores"][0]
                valid = int((sc[:, 1:] > attrs["score_threshold"]).sum())
            timing[key] = {"ms": ms, "nms_iterations":
                           detection.nms_iterations[op.type],
                           "candidates_over_threshold": valid}
            log(f"  {op.type}{tag} alone on the card: {ms:.3f} ms, NMS "
                f"{detection.nms_iterations[op.type]} iterations"
                + ("" if valid is None else
                   f", {valid} candidates over the score threshold"))
            if tag:
                got_all = {k: v[0].cpu().numpy()
                           for k, v in impl(ctx, ins, attrs).items()}
                cpu_all = _cpu_op(op.type, {k: [dvals[n] for n in ns]
                                            for k, ns in
                                            op.desc.inputs.items()}, attrs)
                for slot in got_all:
                    _compare("phase 6v (b) all valid", slot, got_all[slot],
                             cpu_all[slot], TOL_DENSE)
                _compare("phase 6v (b) all valid", "labels",
                         got_all["Out"][..., 0].astype(np.int32),
                         cpu_all["Out"][..., 0].astype(np.int32), TOL_DENSE)
    errs_b = _ops_card_vs_cpu("phase 6v (b)", infer, dvals, NMS_OPS, dev)
    log(f"  {n_det} detections, mAP {m_ap:.6f} (integral, overlap 0.5); "
        f"{int(det['rois_num'].sum())} proposals; the program {det_ms:.1f} "
        f"ms; generate_proposals and multiclass_nms card vs CPU equal")
    return {"steps": steps, "warm_step_ms": warm, "profile": prof,
            "peak_mem_bytes": peak,
            "affine_channel_ops": types.count("affine_channel"),
            "card_vs_cpu_max_abs_err": errs, "detection": {
                "m_ap": m_ap, "detections": n_det,
                "proposals": int(det["rois_num"].sum()), "ms": det_ms,
                "ops": timing, "card_vs_cpu_max_abs_err": errs_b}}


def _ssd_prior_sizes(min_ratio=20, max_ratio=90, base=300, n=6):
    """upstream multi_box_head's min and max sizes (layers/detection.py):
    the first map at 10% and 20% of the base, the rest in steps of
    floor((max - min) / (n - 2)) percent."""
    step = int(math.floor((max_ratio - min_ratio) / (n - 2)))
    mins, maxs = [base * 0.10], [base * 0.20]
    for ratio in range(min_ratio, max_ratio + 1, step):
        mins.append(base * ratio / 100.0)
        maxs.append(base * (ratio + step) / 100.0)
    return mins, maxs


SSD_MAPS = (19, 10, 5, 3, 2, 1)      # MobileNet-SSD at 300 x 300
SSD_BATCH, SSD_CLASSES, SSD_GT = 8, 21, 6
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]
YOLO_HEADS = ((19, [6, 7, 8], 32), (38, [3, 4, 5], 16), (76, [0, 1, 2], 8))


def detection_op_cases():
    """{name: (op, inputs, attrs, out slot, grad slots)}: each of the 27
    ops of the detection and vision_extra families at least once, at the
    models' widths where a model runs it: MobileNet-SSD's priors, loss,
    NMS and 11-point mAP (300 x 300, 21 VOC classes, batch 8), the three
    YOLOv3-608 heads (batch 8, 80 classes, 50 boxes an image), Faster
    R-CNN's RPN ops at 6v (a)'s shape (generate_proposals with eta
    0.9)."""
    rng = np.random.RandomState(22)
    f32 = np.float32
    cases = {}
    mins, maxs = _ssd_prior_sizes()
    img = np.zeros((SSD_BATCH, 3, 300, 300), f32)
    priors = []
    for i, s in enumerate(SSD_MAPS):
        attrs = {"min_sizes": [mins[i]], "max_sizes": [maxs[i]],
                 "aspect_ratios": [2.0] if i == 0 else [2.0, 3.0],
                 "flip": True, "clip": True, "offset": 0.5,
                 "variances": [0.1, 0.1, 0.2, 0.2]}
        ins = {"Input": np.zeros((SSD_BATCH, 1, s, s), f32), "Image": img}
        cases[f"prior_box_{s}"] = ("prior_box", ins, attrs, "Boxes", [])
        priors.append(_cpu_op("prior_box", ins, attrs)["Boxes"].reshape(
            -1, 4))
    prior = np.concatenate(priors)                        # (P, 4)
    p = prior.shape[0]
    pvar = np.tile(f32([0.1, 0.1, 0.2, 0.2]), (p, 1))
    lo = rng.uniform(0, 0.7, (SSD_BATCH, SSD_GT, 2))
    gt = np.concatenate([lo, lo + rng.uniform(0.1, 0.3, lo.shape)],
                        -1).astype(f32)
    gt_lbl = rng.randint(1, SSD_CLASSES, (SSD_BATCH, SSD_GT))
    deltas = (rng.randn(SSD_BATCH, p, 4) * 0.5).astype(f32)
    cases["box_coder_decode_ssd"] = (
        "box_coder", {"PriorBox": prior, "PriorBoxVar": pvar,
                      "TargetBox": deltas},
        {"code_type": "decode_center_size"}, "OutputBox", ["TargetBox"])
    cases["box_coder_encode_ssd"] = (
        "box_coder", {"PriorBox": prior, "PriorBoxVar": pvar,
                      "TargetBox": gt.reshape(-1, 4)},
        {"code_type": "encode_center_size"}, "OutputBox", ["TargetBox"])
    boxes = _cpu_op("box_coder", cases["box_coder_decode_ssd"][1],
                    cases["box_coder_decode_ssd"][2])["OutputBox"]
    logits = rng.randn(SSD_BATCH, SSD_CLASSES, p).astype(f32) * 2
    scores = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    nms_attrs = {"score_threshold": 0.01, "nms_threshold": 0.45,
                 "nms_top_k": 400, "keep_top_k": 200, "background_label": 0}
    nms_ins = {"BBoxes": boxes, "Scores": scores.astype(f32)}
    cases["multiclass_nms_ssd"] = ("multiclass_nms", nms_ins, nms_attrs,
                                   "Out", [])
    dets = _cpu_op("multiclass_nms", nms_ins, nms_attrs)["Out"]
    label = np.concatenate([gt_lbl[..., None].astype(f32), gt,
                            (rng.rand(SSD_BATCH, SSD_GT, 1) < 0.2).astype(
                                f32)], -1)
    cases["detection_map_ssd_11point"] = (
        "detection_map", {"DetectRes": dets, "Label": label},
        {"class_num": SSD_CLASSES, "overlap_threshold": 0.5,
         "ap_type": "11point", "evaluate_difficult": False}, "MAP", [])
    iou = _cpu_op("iou_similarity", {"X": gt[0], "Y": prior}, {})["Out"]
    cases["iou_similarity_ssd"] = ("iou_similarity",
                                   {"X": gt.reshape(-1, 4), "Y": prior}, {},
                                   "Out", ["X"])
    cases["bipartite_match_ssd"] = (
        "bipartite_match", {"DistMat": iou},
        {"match_type": "per_prediction", "dist_threshold": 0.5},
        "ColToRowMatchIndices", [])
    match = _cpu_op("bipartite_match", {"DistMat": iou},
                    {"match_type": "per_prediction",
                     "dist_threshold": 0.5})
    cases["target_assign_ssd"] = (
        "target_assign", {"X": gt[0],
                          "MatchIndices": match["ColToRowMatchIndices"]},
        {"mismatch_value": 0}, "Out", [])
    m_idx = np.tile(match["ColToRowMatchIndices"], (SSD_BATCH, 1))
    for mtype in ("max_negative", "hard_example"):
        cases[f"mine_hard_examples_{mtype}"] = (
            "mine_hard_examples",
            {"ClsLoss": rng.rand(SSD_BATCH, p).astype(f32),
             "LocLoss": rng.rand(SSD_BATCH, p).astype(f32),
             "MatchIndices": m_idx,
             "MatchDist": np.tile(match["ColToRowMatchDist"],
                                  (SSD_BATCH, 1))},
            {"mining_type": mtype, "sample_size": 64}, "NegMask", [])
    cases["density_prior_box"] = (
        "density_prior_box", {"Input": np.zeros((1, 1, 19, 19), f32),
                              "Image": img[:1]},
        {"densities": [4, 2, 1], "fixed_sizes": [32.0, 64.0, 128.0],
         "fixed_ratios": [1.0]}, "Boxes", [])
    for s, mask, down in YOLO_HEADS:
        n_gt = rng.randint(20, 51, SSD_BATCH)
        box = np.zeros((SSD_BATCH, 50, 4), f32)
        lbl = np.full((SSD_BATCH, 50), -1, np.int32)
        for i, k in enumerate(n_gt):
            box[i, :k, :2] = rng.uniform(0.05, 0.95, (k, 2))
            box[i, :k, 2:] = rng.uniform(0.02, 0.6, (k, 2))
            lbl[i, :k] = rng.randint(0, 80, k)
        cases[f"yolov3_loss_{s}"] = (
            "yolov3_loss", {"X": (rng.randn(SSD_BATCH, 255, s, s) * 0.5)
                            .astype(f32), "GTBox": box, "GTLabel": lbl},
            {"anchors": YOLO_ANCHORS, "anchor_mask": mask, "class_num": 80,
             "ignore_thresh": 0.7, "downsample_ratio": down}, "Loss", ["X"])
    # Faster R-CNN's RPN ops at 6v (a)'s shape
    (h, w), na = FRCNN["image"], 15
    fh, fw = -(-h // 16), -(-w // 16)
    anc_attrs = {"anchor_sizes": list(FRCNN["anchor_sizes"]),
                 "aspect_ratios": list(FRCNN["aspect_ratios"]),
                 "variances": [1.0, 1.0, 1.0, 1.0], "stride": [16.0, 16.0]}
    anc_ins = {"Input": np.zeros((1, 1, fh, fw), f32)}
    cases["anchor_generator_frcnn"] = ("anchor_generator", anc_ins,
                                       anc_attrs, "Anchors", [])
    anchors = _cpu_op("anchor_generator", anc_ins, anc_attrs)["Anchors"]
    im_info = f32([[h, w, 1.0]])
    gp_ins = {"Scores": rng.rand(1, na, fh, fw).astype(f32),
              "BboxDeltas": (rng.randn(1, 4 * na, fh, fw) * 0.3).astype(f32),
              "ImInfo": im_info, "Anchors": anchors,
              "Variances": np.ones(anchors.shape, f32)}
    gp_attrs = {"pre_nms_topN": FRCNN["train_nms"][0],
                "post_nms_topN": FRCNN["train_nms"][1], "nms_thresh": 0.7,
                "min_size": 0.0, "eta": 0.9}
    cases["generate_proposals_eta0.9"] = ("generate_proposals", gp_ins,
                                          gp_attrs, "RpnRois", [])
    props = _cpu_op("generate_proposals", gp_ins, dict(gp_attrs, eta=1.0))
    feed = frcnn_feed(FRCNN, 0)
    cases["rpn_target_assign_frcnn"] = (
        "rpn_target_assign", {"Anchor": anchors.reshape(-1, 4),
                              "GtBoxes": feed["gt_box"], "ImInfo": im_info},
        {"rpn_batch_size_per_im": FRCNN["rpn_batch"], "use_random": False},
        "TargetBBox", [])
    cases["generate_proposal_labels_frcnn"] = (
        "generate_proposal_labels",
        {"RpnRois": props["RpnRois"], "RpnRoisNum": props["RpnRoisNum"],
         "GtClasses": feed["gt_label"], "GtBoxes": feed["gt_box"],
         "ImInfo": im_info},
        {"batch_size_per_im": FRCNN["rois"], "class_nums": FRCNN["classes"],
         "use_random": False}, "Rois", [])
    top = props["RpnRois"][0, :128]
    rois = np.concatenate([np.zeros((len(top), 1), f32), top], 1)
    cases["roi_align_frcnn"] = (
        "roi_align", {"X": rng.randn(1, 64, fh, fw).astype(f32),
                      "ROIs": rois},
        {"pooled_height": 14, "pooled_width": 14,
         "spatial_scale": 1 / 16.0, "sampling_ratio": 0}, "Out", ["X"])
    cases["roi_pool_frcnn"] = (
        "roi_pool", {"X": rng.randn(1, 64, fh, fw).astype(f32),
                     "ROIs": rois},
        {"pooled_height": 7, "pooled_width": 7, "spatial_scale": 1 / 16.0},
        "Out", ["X"])
    cases["box_clip_frcnn"] = (
        "box_clip", {"Input": (rng.randn(1, 8100, 4) * 400 + 500).astype(
            f32), "ImInfo": f32([[h, w, 1.5]])}, {}, "Output", ["Input"])
    # R-FCN's position-sensitive pooling, the rest of the vision family
    cases["psroi_pool_rfcn"] = (
        "psroi_pool", {"X": rng.rand(1, 10 * 7 * 7, 38, 50).astype(f32),
                       "ROIs": rois[:64]},
        {"output_channels": 10, "pooled_height": 7, "pooled_width": 7,
         "spatial_scale": 1 / 16.0}, "Out", ["X"])
    x5 = rng.randn(2, 16, 16, 32, 32).astype(f32)
    cases["pool3d_max"] = ("pool3d", {"X": x5},
                           {"pooling_type": "max", "ksize": 3, "strides": 2,
                            "paddings": 1}, "Out", ["X"])
    cases["pool3d_avg"] = ("pool3d", {"X": x5},
                           {"pooling_type": "avg", "ksize": 3, "strides": 2,
                            "paddings": 1}, "Out", ["X"])
    x4 = rng.randn(8, 256, 13, 13).astype(f32)
    for ptype in ("max", "avg"):
        cases[f"spp_{ptype}"] = ("spp", {"X": x4}, {"pyramid_height": 3,
                                                     "pooling_type": ptype},
                                 "Out", ["X"])
    cases["affine_channel_res4"] = (
        "affine_channel", {"X": rng.randn(1, 1024, fh, fw).astype(f32),
                           "Scale": rng.rand(1024).astype(f32),
                           "Bias": rng.randn(1024).astype(f32)}, {}, "Out",
        ["X", "Scale", "Bias"])
    cases["affine_grid"] = ("affine_grid",
                            {"Theta": rng.randn(8, 2, 3).astype(f32)},
                            {"output_shape": [8, 3, 64, 64]}, "Output",
                            ["Theta"])
    cases["crop"] = ("crop", {"X": rng.randn(8, 64, 32, 32).astype(f32)},
                     {"shape": [8, 64, 24, 24], "offsets": [0, 0, 3, 5]},
                     "Out", ["X"])
    win = rng.randint(0, 2, (8, 64, 16, 16, 2))
    pos = ((np.arange(16)[:, None] * 2 + win[..., 0]) * 32
           + np.arange(16)[None, :] * 2 + win[..., 1]).astype(np.int32)
    cases["unpool"] = ("unpool", {"X": rng.randn(8, 64, 16, 16).astype(f32),
                                  "Indices": pos},
                       {"unpool_size": [32, 32]}, "Out", ["X"])
    cases["similarity_focus"] = (
        "similarity_focus", {"X": rng.rand(8, 16, 32, 32).astype(f32)},
        {"axis": 1, "indexes": [0, 5]}, "Out", [])
    cases["polygon_box_transform"] = (
        "polygon_box_transform",
        {"Input": rng.randn(2, 8, 128, 128).astype(f32)}, {}, "Output",
        ["Input"])
    quads = np.array([[i % 2] + list(rng.uniform(0, 60, 8))
                      for i in range(16)], f32)
    cases["roi_perspective_transform"] = (
        "roi_perspective_transform",
        {"X": rng.randn(2, 32, 64, 64).astype(f32), "ROIs": quads},
        {"transformed_height": 8, "transformed_width": 32,
         "spatial_scale": 1.0}, "Out", ["X"])
    return cases


def _ssd_loss_program(p):
    """ssd_loss per image over a batch of SSD_BATCH (the layer takes one
    image's (P, 4) and (P, C)): the SSD_BATCH losses."""
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        L = pt.layers
        loc = L.data("loc", shape=[SSD_BATCH, p, 4], append_batch_size=False)
        conf = L.data("conf", shape=[SSD_BATCH, p, SSD_CLASSES],
                      append_batch_size=False)
        gtb = L.data("gtb", shape=[SSD_BATCH, SSD_GT, 4],
                     append_batch_size=False)
        gtl = L.data("gtl", shape=[SSD_BATCH, SSD_GT, 1], dtype="int64",
                     append_batch_size=False)
        prior = L.data("prior", shape=[p, 4], append_batch_size=False)
        pvar = L.data("pvar", shape=[p, 4], append_batch_size=False)

        def img(v, i, shape):
            return L.reshape(L.slice(v, axes=[0], starts=[i], ends=[i + 1]),
                             shape)

        losses = [L.detection.ssd_loss(
            img(loc, i, [p, 4]), img(conf, i, [p, SSD_CLASSES]),
            img(gtb, i, [SSD_GT, 4]), img(gtl, i, [SSD_GT, 1]), prior, pvar)
            for i in range(SSD_BATCH)]
        total = L.concat(losses, axis=0)
    return main, total


def phase_detection_ops(dev):
    """6v (c): each op of the detection and vision_extra families on the
    card against the port on the CPU (`detection_op_cases`): floating
    outputs within TOL_DENSE, gradients within it plus TOL_GRAD_SHARE of
    their largest, integer outputs and the NMS ops' labels exactly; and ssd_loss per image over a batch of 8 at
    MobileNet-SSD's widths, the program on the card against the CPU."""
    import paddle_tpu_torch as pt

    cases = detection_op_cases()
    ops = sorted({c[0] for c in cases.values()})
    mins, _ = _ssd_prior_sizes()
    log(f"phase 6v (c): {len(ops)} ops of the detection and vision_extra "
        f"families, {len(cases)} cases, card vs CPU (SSD min sizes "
        f"{[round(m, 1) for m in mins]})")
    worst, n_cmp, secs = {}, 0, {}
    for name, (op, ins, attrs, out_slot, grad_slots) in sorted(
            cases.items()):
        t0 = time.perf_counter()
        got, g_card = _run_dense(op, ins, attrs, dev, grad_slots, out_slot)
        want, g_cpu = _run_dense(op, ins, attrs, "cpu", grad_slots,
                                 out_slot)
        pairs = [(f"{s}[{i}]", a, b) for s in want
                 for i, (a, b) in enumerate(zip(got[s], want[s]))]
        pairs += [(f"d/d{s}", g_card[s], g_cpu[s]) for s in g_cpu]
        if op == "multiclass_nms":
            pairs.append(("labels", got["Out"][0][..., 0].astype(np.int32),
                          want["Out"][0][..., 0].astype(np.int32)))
        for what, a, b in pairs:
            n_cmp += 1
            tol = TOL_BOX if what.startswith(BOX_SLOTS) else (
                _grad_tol(b) if what.startswith("d/d") else TOL_DENSE)
            worst[name] = max(worst.get(name, 0.0),
                              _compare(f"phase 6v (c) {name}", what, a, b,
                                       tol))
        secs[name] = time.perf_counter() - t0
    priors = cases["box_coder_encode_ssd"][1]["PriorBox"].shape[0]
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    slow = sorted(secs.items(), key=lambda kv: -kv[1])[:3]
    log(f"  {n_cmp} outputs and gradients compared, all within tolerance; "
        f"MobileNet-SSD {priors} priors; largest abs errors "
        f"{[(k, f'{v:.2e}') for k, v in top]}; slowest cases "
        f"{[(k, round(v, 1)) for k, v in slow]} s")
    # ssd_loss, one image at a time over the batch
    rng = np.random.RandomState(23)
    enc = cases["box_coder_encode_ssd"][1]
    p = enc["PriorBox"].shape[0]
    feed = {"loc": (rng.randn(SSD_BATCH, p, 4) * 0.1).astype(np.float32),
            "conf": rng.randn(SSD_BATCH, p, SSD_CLASSES).astype(np.float32),
            "gtb": enc["TargetBox"].reshape(SSD_BATCH, SSD_GT, 4),
            "gtl": rng.randint(1, SSD_CLASSES, (SSD_BATCH, SSD_GT, 1)),
            "prior": enc["PriorBox"], "pvar": enc["PriorBoxVar"]}
    main, total = _ssd_loss_program(p)
    runs = {}
    for place, name in ((pt.CUDAPlace(0), "card"), (pt.CPUPlace(), "cpu")):
        runs[name] = np.asarray(pt.Executor(place).run(
            main, feed=feed, fetch_list=[total], scope=pt.Scope())[0])
    ssd_err = _compare("phase 6v (c) ssd_loss", "losses", runs["card"],
                       runs["cpu"], TOL_DENSE)
    if not (np.isfinite(runs["card"]).all() and (runs["card"] > 0).all()):
        raise AssertionError(f"phase 6v (c) ssd_loss {runs['card']}")
    log(f"  ssd_loss per image, {SSD_BATCH} images x {p} priors x "
        f"{SSD_CLASSES} classes: card vs CPU max abs err {ssd_err:.2e}")
    return {"ops": len(ops), "cases": len(cases), "compared": n_cmp,
            "max_abs_err": worst, "seconds": secs, "ssd_priors": p,
            "ssd_loss": runs["card"].tolist(), "ssd_loss_max_abs_err":
            ssd_err}


def phase_detection(dev, card):
    """6v: (a) Faster R-CNN training and (b) detection, with the kernel
    counts zeroed just before (a) and read after (b); (c) the 27 ops
    card against CPU."""
    from paddle_tpu_torch.ops import kernels

    res, seconds = {}, {}

    def part(key, fn, *args):
        t0 = time.perf_counter()
        o = fn(*args)
        seconds[key] = time.perf_counter() - t0
        log(f"  [6v {key}: {seconds[key]:.1f} s]")
        return o

    kernels.reset_counts()
    res["frcnn"] = part("frcnn", phase_frcnn, dev, card)
    counts = kernels.counts()
    log(f"  kernel counts over (a) and (b): launches "
        f"{ {k: v for k, v in counts['launches'].items() if v} }, plain "
        f"calls { {k: v for k, v in counts['plain'].items() if v} }")
    torch.cuda.empty_cache()
    res["ops"] = part("ops", phase_detection_ops, dev)
    res["seconds"] = seconds
    res["counts"] = counts
    res["launches"] = counts["launches"]
    return res


# ---------------------------------------------------------------------------
# phases 4e and 4f: the serving layer — the replica Fleet, the
# dynamic-batching ServingEngine and the Predictor
# ---------------------------------------------------------------------------

# phase 4e (A): the reference's serving-fleet bench (bench.py:1423-1460,
# bench_serving_fleet at its TPU widths): DecoderLM vocab 8192, 4 layers,
# 8 heads, d_model 512, d_inner 1024, bf16 KV; 8 slots, pages of 16,
# max_len 256, prefill buckets (32, 64), decode chunk 8; two replicas on
# the one card; 48 prompts of 8-64 tokens (make_prompts seed 0), budgets
# randint(24, 49) from RandomState(1), as the bench draws them
FLEET_ARCH = dict(vocab_size=8192, n_layer=4, n_head=8, d_model=512,
                  d_inner=1024, seed=0)
FLEET_SERVE = dict(num_slots=8, page_size=16, max_len=256,
                   prefill_buckets=(32, 64), decode_chunk=8)
FLEET_REQUESTS, FLEET_REPLICAS, FLEET_MAX_NEW = 48, 2, 48
# phase 4f (B): the reference's serving-engine bench (bench.py:1080-1215,
# bench_serving_engine at batch 32): ResNet-50 (flowers, depth 50, 1000
# classes, with_optimizer=False) saved with save_inference_model; the
# per-request Predictor over 24 images one at a time; the engine with the
# ladder (1, 32), max_wait_ms 5, a queue of 128, 192 requests from 64
# client threads
SERVE_BATCH, SERVE_REQUESTS, SERVE_CLIENTS = 32, 192, 64
SERVE_PER_REQUEST = 24
# each engine response against Predictor.run on its image alone: the
# logits of a float32 network (TF32 off) whose batch-32 and batch-1
# convolutions may take other cuDNN algorithms, so other float32
# summation orders.  Measured 5.83e-7 of the largest logit (H100, four
# runs, the same value each); the limit keeps ~17x headroom over that.
# The batch of 32 run again with TF32 on must exceed it (measured 6.2e-4),
# so the limit is known to see a batch whose products ran in TF32.
TOL_SERVE_BATCHED = 1e-5


def _stream_through(submit, prompts, budgets, timeout=600):
    futs = [submit(p, max_new_tokens=int(b))
            for p, b in zip(prompts, budgets)]
    return [f.result(timeout) for f in futs]


def phase_fleet(dev, card):
    """4e (A): the same 48-request stream through one unkilled
    DecodeEngine (the control), then through a two-replica Fleet on the
    card: half the stream, `chaos.kill_replica` of replica 0, the rest
    with `fleet.reload` of the same weights (a sharded checkpoint) in
    the middle, the kernel counts zeroed just before the fleet's stream
    and read after.  Every response's tokens equal the control's, no
    client failure, at least one failover, zero post-warmup compiles
    fleet-wide, the reloaded replicas' model_version moved."""
    import shutil

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.executor import RNG_STATE_VAR
    from paddle_tpu_torch.models.decoder_lm import DecoderLM, make_prompts
    from paddle_tpu_torch.observe import ReqTracer
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine, Fleet,
                                          FleetConfig)

    log(f"phase 4e (A): a {FLEET_REPLICAS}-replica DecoderLM Fleet on the "
        f"card: a replica killed and the weights reloaded mid-stream")
    lm = DecoderLM(kv_dtype="bfloat16", prefill_pallas=True, **FLEET_ARCH)
    cfg = DecodeConfig(kv_dtype="bfloat16", **FLEET_SERVE)
    scope = lm.init_params(place=pt.CUDAPlace(0))
    params = {n: v for n, v in scope.vars.items()
              if isinstance(v, torch.Tensor) and n != RNG_STATE_VAR}
    n = FLEET_REQUESTS
    prompts = make_prompts(n, FLEET_ARCH["vocab_size"], min_len=8,
                           max_len=64, seed=0)
    budgets = np.random.RandomState(1).randint(
        max(2, FLEET_MAX_NEW // 2), FLEET_MAX_NEW + 1, n)

    def engine():
        return DecodeEngine(lm, cfg, queue_capacity=4 * n,
                            memory_budget_bytes=False,
                            params={k: t.clone() for k, t in params.items()},
                            place=pt.CUDAPlace(0))

    ctl = engine().start()
    t0 = time.perf_counter()
    control = [o.tolist() for o in _stream_through(ctl.submit, prompts,
                                                   budgets)]
    control_s = time.perf_counter() - t0
    ctl_snap = ctl.stats.snapshot()
    ctl.close()

    ckpt = os.path.join(OUT_DIR, "fleet_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    with pt.scope_guard(scope):
        pt.io.save_sharded(pt.Executor(pt.CUDAPlace(0)), ckpt,
                           main_program=lm.step["main"])
    tracer = ReqTracer(sample_rate=0.0)
    engines = [engine() for _ in range(FLEET_REPLICAS)]
    fleet = Fleet(engines, FleetConfig(), tracer=tracer).start()
    half = n // 2
    kernels.reset_counts()
    t0 = time.perf_counter()
    futs = [fleet.submit(p, max_new_tokens=int(b))
            for p, b in zip(prompts[:half], budgets[:half])]
    chaos.kill_replica(engines[0])          # the scripted mid-run death
    outs = [f.result(600) for f in futs]
    futs = [fleet.submit(p, max_new_tokens=int(b))
            for p, b in zip(prompts[half:], budgets[half:])]
    reload_info = fleet.reload(ckpt)
    outs += [f.result(600) for f in futs]
    elapsed = time.perf_counter() - t0
    counts = kernels.counts()
    snap = fleet.snapshot()
    versions = {h.replica_id: h.engine.model_version
                for h in fleet.replicas}
    dead = [h.replica_id for h in fleet.replicas if h.dead]
    fleet.close()
    chaos.clear()
    shutil.rmtree(ckpt, ignore_errors=True)

    tokens = [r.tokens.tolist() for r in outs]
    diverged = [i for i, (a, b) in enumerate(zip(tokens, control))
                if a != b]
    la = counts["launches"]
    eng = snap["engines"]
    res = {"requests": n, "replicas": FLEET_REPLICAS,
           "tokens": sum(map(len, tokens)), "wall_s": elapsed,
           "requests_per_s": n / elapsed,
           "tokens_per_s": sum(map(len, tokens)) / elapsed,
           "control_wall_s": control_s,
           "control_tokens_per_s": ctl_snap["tokens_generated"] / control_s,
           "ttft_ms": eng["ttft_ms"], "tpot_ms": eng["tpot_ms"],
           "failovers": snap["failovers"], "hedges": snap["hedges"],
           "retries": snap["retries"], "ejects": snap["ejects"],
           "parity_checked": snap["parity_checked"],
           "parity_failed": snap["parity_failed"],
           "failed": snap["failed"], "saturated": snap["saturated"],
           "reload_pause_ms": snap["reload_pause_ms"],
           "reload_seconds": reload_info["seconds"],
           "model_versions": versions, "dead": dead,
           "post_warmup_compiles": snap["post_warmup_compiles"],
           "diverged": diverged, "launches": la,
           "plain_calls": counts["plain"]}
    log(f"  control (one engine): {ctl_snap['tokens_generated']} tokens in "
        f"{control_s:.3f} s")
    log(f"  fleet: {n} requests, {res['tokens']} tokens in {elapsed:.3f} s: "
        f"{res['requests_per_s']:.2f} requests/s, "
        f"{res['tokens_per_s']:.1f} tokens/s on {card}")
    log(f"  TTFT p50 {eng['ttft_ms']['p50_ms']} ms p99 "
        f"{eng['ttft_ms']['p99_ms']} ms; TPOT p50 {eng['tpot_ms']['p50_ms']}"
        f" ms p99 {eng['tpot_ms']['p99_ms']} ms (replicas merged)")
    log(f"  failovers {snap['failovers']} (parity checked "
        f"{snap['parity_checked']}, failed {snap['parity_failed']}), hedges "
        f"{snap['hedges']}, retries {snap['retries']}, ejects "
        f"{snap['ejects']}, client failures {snap['failed']}; reload "
        f"pause {snap['reload_pause_ms']} ms, roll "
        f"{reload_info['seconds']} s; versions {versions}; "
        f"post_warmup_compiles {snap['post_warmup_compiles']}")
    log(f"  tokens equal to the control's: {n - len(diverged)}/{n}; "
        f"launches { {k: v for k, v in la.items() if v} }")
    alive = [r for r in versions if r not in dead]
    if (diverged or snap["failed"] or snap["failovers"] < 1
            or snap["parity_failed"] or snap["post_warmup_compiles"]
            or reload_info["version"] != 1 or not alive
            or any(versions[r] != 1 for r in alive)
            or la["paged_attention"] < 1 or la["flash_attention_fwd"] < 1
            or max(counts["plain"].values())
            or max(counts["composed"].values())):
        raise AssertionError(f"4e (A) fleet: {res}")
    return res


def _resnet_inference_dir(d):
    """Save RESNET_ARCH's ResNet-50 (with_optimizer=False) with random
    weights from its startup program, as bench_serving_engine does, its
    logits fetched beside the softmax (a random network's softmax is
    saturated: its outputs would hide any difference)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet

    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        arch = dict(RESNET_ARCH)
        arch.pop("learning_rate")
        model = resnet.build_model(**arch, with_optimizer=False)
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    logits = main.global_block().var(
        _logits_name(main, model["predict"].name))
    with pt.scope_guard(scope):
        pt.io.save_inference_model(d, ["data"], [model["predict"], logits],
                                   exe, main_program=main)


def phase_serving_engine(dev, card):
    """4f (B): the per-request Predictor over SERVE_PER_REQUEST images
    one at a time, then the ServingEngine over SERVE_REQUESTS requests
    from SERVE_CLIENTS threads (each response against Predictor.run on
    its image alone within TOL_SERVE_BATCHED, zero post-warmup compiles);
    then an `AnalysisConfig(...).enable_int8()` Predictor on a QAT
    ResNet-50 exported as in phase 6u, at batch 8, bit for bit against
    Executor.run of the same convert_to_int8 program on the card."""
    import shutil
    import threading

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.observe import ReqTracer
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import BucketConfig, ServingEngine

    log("phase 4f (B): ResNet-50 through the Predictor and the "
        "dynamic-batching ServingEngine")
    d = os.path.join(OUT_DIR, "serving_resnet")
    shutil.rmtree(d, ignore_errors=True)
    _resnet_inference_dir(d)
    imgs = np.random.RandomState(0).rand(
        SERVE_REQUESTS, 3, 224, 224).astype(np.float32)
    kernels.reset_counts()
    predictor = pt.Predictor(pt.AnalysisConfig(d))
    predictor.run({"data": imgs[0:1]})                  # warm bucket 1
    t0 = time.perf_counter()
    for i in range(SERVE_PER_REQUEST):
        predictor.run({"data": imgs[i:i + 1]})
    per_req_rps = SERVE_PER_REQUEST / (time.perf_counter() - t0)

    tracer = ReqTracer(sample_rate=0.0)
    engine = ServingEngine(
        predictor.clone(), {"data": imgs[0]},
        buckets=BucketConfig((1, SERVE_BATCH)), max_wait_ms=5.0,
        queue_capacity=4 * SERVE_BATCH, tracer=tracer).start()
    outs = [None] * SERVE_REQUESTS
    errors = []

    def client(k):
        try:
            for i in range(k, SERVE_REQUESTS, SERVE_CLIENTS):
                outs[i] = engine.infer({"data": imgs[i]}, timeout_s=300)
        except Exception as e:  # noqa: BLE001 — recorded, raised below
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    snap = engine.stats.snapshot()
    engine.close()
    counts = kernels.counts()
    singles = [predictor.run({"data": imgs[i:i + 1]})
               for i in range(SERVE_REQUESTS)]
    # the logits (the second output) against each image run alone
    want = np.stack([o[1][0] for o in singles])
    scale = float(np.abs(want).max())
    err = top1 = None
    if not errors:
        got = np.stack([o[1] for o in outs])
        err = float(np.abs(got - want).max()) / scale
        top1 = int((got.argmax(1) == want.argmax(1)).sum())
    # what the limit reads on a batch whose products ran in TF32: the
    # first SERVE_BATCH images as one batch with TF32 on, against the
    # same single runs (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = predictor.run({"data": imgs[:SERVE_BATCH]})[1]
    finally:
        _set_matmul_flags()
    tf32_err = float(np.abs(tf32 - want[:SERVE_BATCH]).max()) / scale
    phases = tracer.phase_summary()
    res = {"requests": SERVE_REQUESTS, "clients": SERVE_CLIENTS,
           "requests_per_s": SERVE_REQUESTS / elapsed,
           "per_request_rps": per_req_rps,
           "batching_speedup": SERVE_REQUESTS / elapsed / per_req_rps,
           "e2e_ms": snap["e2e_ms"], "exec_ms": snap["exec_ms"],
           "exec_per_req_ms": snap["exec_per_req_ms"],
           "queue_wait_ms_p50": phases.get("queue_wait", {}).get("p50_ms"),
           "batch_occupancy": snap["batch_occupancy"],
           "padding_waste": snap["padding_waste"],
           "batches": snap["batches"], "warmup": snap.get("warmup"),
           "post_warmup_compiles": snap["post_warmup_compiles"],
           "logits_max_rel_err_vs_single": err,
           "logits_scale": scale, "top1_equal": top1,
           "tol": TOL_SERVE_BATCHED,
           "tf32_batch_max_rel_err_vs_single": tf32_err,
           "errors": errors[:3], "launches": counts["launches"],
           "plain_calls": counts["plain"]}
    log(f"  per-request Predictor: {per_req_rps:.1f} requests/s over "
        f"{SERVE_PER_REQUEST} images one at a time")
    log(f"  engine: {SERVE_REQUESTS} requests from {SERVE_CLIENTS} clients "
        f"in {elapsed:.3f} s: {res['requests_per_s']:.1f} requests/s, "
        f"batching_speedup {res['batching_speedup']:.3f}; e2e p50 "
        f"{snap['e2e_ms']['p50_ms']} ms p99 {snap['e2e_ms']['p99_ms']} ms; "
        f"occupancy {snap['batch_occupancy']}, padding waste "
        f"{snap['padding_waste']}, {snap['batches']} batches; "
        f"post_warmup_compiles {snap['post_warmup_compiles']} on {card}")
    log(f"  responses against Predictor.run alone: logits max abs err "
        f"{err} of their largest {scale:.4g} (tol {TOL_SERVE_BATCHED:g}); "
        f"top-1 equal on {top1}/{SERVE_REQUESTS}; a batch of "
        f"{SERVE_BATCH} with TF32 on: {tf32_err}")
    if (errors or err is None or err > TOL_SERVE_BATCHED
            or tf32_err <= TOL_SERVE_BATCHED
            or snap["post_warmup_compiles"] or snap["completed"]
            != SERVE_REQUESTS):
        raise AssertionError(f"4f (B) engine: {res}")
    shutil.rmtree(d, ignore_errors=True)
    del predictor
    torch.cuda.empty_cache()

    # the int8 Predictor against Executor.run of the same converted
    # program: 6u's recipe, its saved directory served through
    # AnalysisConfig.enable_int8()
    prog, qscope, _, _, plan, fetch, qdir = _int8_models(dev, card)
    x8 = resnet_batch(8, seed=20)["data"]
    exe = pt.Executor(pt.CUDAPlace(0))
    want = exe.run(prog, feed={"data": x8}, fetch_list=fetch,
                   scope=qscope)
    pred8 = pt.Predictor(pt.AnalysisConfig(qdir).enable_int8())
    got = pred8.run({"data": x8})
    shutil.rmtree(qdir, ignore_errors=True)
    # softmax and logits, both bit for bit
    equal = all(np.array_equal(g, w) for g, w in zip(got, want))
    res["int8"] = {"batch": 8, "converted_ops": len(pred8.int8_converted),
                   "plan_equal": pred8.int8_converted == plan,
                   "outputs": pred8.get_output_names(),
                   "bit_equal": equal,
                   "max_abs_diff": max(float(np.abs(g - w).max())
                                       for g, w in zip(got, want)),
                   "logits_scale": float(np.abs(want[1]).max()),
                   "finite": all(bool(np.isfinite(g).all()) for g in got)}
    log(f"  int8 Predictor (enable_int8, {len(pred8.int8_converted)} ops "
        f"converted, plan equal {res['int8']['plan_equal']}) against "
        f"Executor.run of the converted program at batch 8: softmax and "
        f"logits (largest {res['int8']['logits_scale']:.4g}) bit for bit "
        f"{equal} (max abs diff {res['int8']['max_abs_diff']:.3e})")
    if not (equal and res["int8"]["plan_equal"] and res["int8"]["finite"]):
        raise AssertionError(f"4f (B) int8 Predictor: {res['int8']}")
    return res


# ---------------------------------------------------------------------------
# phase 4g: disaggregated prefill/decode serving and its metrics plane
# ---------------------------------------------------------------------------

# the reference's disagg bench (bench.py:1591-1720, bench_serving_disagg
# at its TPU widths): 4e's model, geometry, prompts and budgets; the
# control is a unified two-replica Fleet; the disaggregated fleet is one
# prefill worker of FLEET_SERVE's slots and one decode worker of twice
# as many (the unified fleet's total, as the bench sizes it); the chaos
# run one prefill and two decode workers of FLEET_SERVE's slots, decode
# worker 0 killed once half the requests have completed
DISAGG_DECODE_SLOTS = 2 * FLEET_SERVE["num_slots"]


def step_row_bits(lm, params, cfg, prompts, dev, block):
    """ROADMAP C15: one decode step's logits for 2 x `block` slots, run
    as two steps of `block` rows (what unified engines of `block` slots
    run), as one step of 2 x `block` rows (a decode worker without a row
    block) and as one such step with `row_block=block` (the decode
    worker's runs).  The pools come from one prefill of the prompts; each
    step run writes its own copy.  Returns the bit-equality of the last
    two against the first and their largest absolute differences."""
    from paddle_tpu_torch.serving.decode import run_model_program

    s2, maxp, page = 2 * block, cfg.max_pages_per_slot, cfg.page_size
    names = lm.cache_feed_names()
    bucket = cfg.prefill_buckets[-1]
    ps = [p[:bucket] for p in prompts[:s2]]
    tokens = np.zeros((s2, bucket), np.int32)
    seq_len = np.zeros((s2,), np.int32)
    last_idx = np.zeros((s2, 1), np.int32)
    for i, p in enumerate(ps):
        tokens[i, :len(p)] = p
        seq_len[i] = len(p)
        last_idx[i, 0] = len(p) - 1
    pt_rows = np.arange(s2 * maxp, dtype=np.int32).reshape(s2, maxp)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    pre = lm.prefill(bucket)
    env, pools = run_model_program(
        pre, params, lm.fresh_pools(s2 * maxp, page, dev), names, dev,
        (pre["next_token"],), tokens=t(tokens), seq_len=t(seq_len),
        last_idx=t(last_idx), page_table=t(pt_rows))
    first = env[pre["next_token"]].to(torch.int32).cpu().numpy()
    st = lm.step

    def run(rows, row_block):
        own = {n: p.clone() for n, p in pools.items()}
        env, _ = run_model_program(
            st, params, own, names, dev, (st["logits"],),
            row_block=row_block, tokens=t(first[rows]),
            write_pos=t(seq_len[rows]), lengths=t(seq_len[rows] + 1),
            active=t(np.ones_like(seq_len[rows])),
            page_table=t(pt_rows[rows]))
        return env

    with torch.no_grad():
        halves = [run(slice(0, block), None), run(slice(block, s2), None)]
        whole = run(slice(0, s2), None)
        blocked = run(slice(0, s2), block)
    torch.cuda.synchronize(dev)

    def diffs(env):
        """[op type] of the step program whose row outputs differ from
        the two half runs', in program order."""
        out = []
        for op in st["main"].global_block().ops:
            for vs in op.desc.outputs.values():
                for v in vs:
                    x = env.get(v)
                    if not (isinstance(x, torch.Tensor) and x.dim() > 0
                            and x.shape[0] == s2):
                        continue
                    if not torch.equal(x, torch.cat([h[v] for h in halves])):
                        out.append(op.type)
        return out

    base = torch.cat([h[st["logits"]] for h in halves]).float()
    lw, lb = whole[st["logits"]].float(), blocked[st["logits"]].float()
    return {"rows": s2, "row_block": block,
            "whole_bit_equal": bool(torch.equal(lw, base)),
            "whole_max_abs_diff": float((lw - base).abs().max()),
            "whole_rows_differing": int((lw != base).any(dim=1).sum()),
            "whole_ops_differing": diffs(whole),
            "blocked_bit_equal": bool(torch.equal(lb, base)),
            "blocked_max_abs_diff": float((lb - base).abs().max()),
            "blocked_ops_differing": diffs(blocked)}


def import_op_cases(dev):
    """`paged_import_rows` (the paged_kv_import op) on the card against
    its CPU result, bit for bit, at 4g's geometry: float32, bf16 and
    int8 code pools with their float32 scale sidecars; rows past
    NumValid and a table whose padding 0 aliases a live page 0; the
    card's call under `set_sync_debug_mode("error")` (no host sync)."""
    from paddle_tpu_torch.ops.paged_kv import paged_import_rows

    page, c = FLEET_SERVE["page_size"], FLEET_ARCH["d_model"]
    maxp = -(-FLEET_SERVE["max_len"] // page)
    n_pages, t_cap, nv = DISAGG_DECODE_SLOTS * maxp, maxp * page, 37
    pt_row = torch.zeros((maxp,), dtype=torch.int32)
    pt_row[:3] = torch.tensor([0, 5, 9], dtype=torch.int32)
    g = torch.Generator().manual_seed(24)
    f32 = torch.randn((n_pages, page, c), generator=g)
    pools = {
        "float32": (f32, torch.randn((t_cap, c), generator=g)),
        "bfloat16": (f32.to(torch.bfloat16),
                     torch.randn((t_cap, c), generator=g).to(
                         torch.bfloat16)),
        "int8": (torch.randint(-127, 128, (n_pages, page, c),
                               generator=g).to(torch.int8),
                 torch.randint(-127, 128, (t_cap, c),
                               generator=g).to(torch.int8)),
        "int8 scales": (torch.rand((n_pages, page, 1), generator=g),
                        torch.rand((t_cap, 1), generator=g))}
    out = {}
    for name, (pool, rows) in pools.items():
        want = paged_import_rows(pool.clone(), rows, pt_row, nv)
        args = (pool.clone().to(dev), rows.to(dev), pt_row.to(dev),
                torch.tensor(nv, device=dev))
        # no host sync inside the import: a synchronizing call raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = paged_import_rows(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got = got.cpu()
        bits = {1: torch.int8, 2: torch.int16, 4: torch.int32}[
            got.element_size()]
        out[name] = {"bit_equal": bool(torch.equal(got.view(bits),
                                                   want.view(bits))),
                     "pool_changed": not torch.equal(want, pool)}
    return out


def _scrape(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode("utf-8")


def phase_disagg(dev, card):
    """4g: the reference's disagg bench on the card.  The same 48-request
    stream through a unified two-replica Fleet (the control), then
    through a DisaggFleet of one prefill worker and one decode worker of
    twice the slots: every response's tokens equal the control's, 48
    handoffs, no client failure, zero post-warmup compiles, the
    /metrics exposition scraped once over 127.0.0.1 with its disagg_*
    families; then one prefill and two decode workers with decode worker
    0 killed once half the requests completed: the control's tokens
    again, no client failure, a failover with its committed prefix
    verified.  Before the streams, ROADMAP C15's step-row measurement
    and the import op card against CPU.  The kernel counts are zeroed
    just before the disaggregated stream and read after the chaos
    run."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.executor import RNG_STATE_VAR
    from paddle_tpu_torch.models.decoder_lm import DecoderLM, make_prompts
    from paddle_tpu_torch.observe import ReqTracer
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine,
                                          DisaggFleet, Fleet, FleetConfig)

    log("phase 4g: disaggregated prefill/decode serving (DisaggFleet) "
        "against the unified two-replica Fleet, a decode worker killed, "
        "the /metrics scrape")
    lm = DecoderLM(kv_dtype="bfloat16", prefill_pallas=True, **FLEET_ARCH)
    scope = lm.init_params(place=pt.CUDAPlace(dev.index or 0))
    params = {n: v for n, v in scope.vars.items()
              if isinstance(v, torch.Tensor) and n != RNG_STATE_VAR}
    n = FLEET_REQUESTS
    prompts = make_prompts(n, FLEET_ARCH["vocab_size"], min_len=8,
                           max_len=64, seed=0)
    budgets = np.random.RandomState(1).randint(
        max(2, FLEET_MAX_NEW // 2), FLEET_MAX_NEW + 1, n)
    serve = dict(FLEET_SERVE)
    block = serve["num_slots"]

    def engine(role="unified", slots=block):
        cfg = DecodeConfig(kv_dtype="bfloat16",
                           **{**serve, "num_slots": slots})
        return DecodeEngine(lm, cfg, queue_capacity=4 * n,
                            memory_budget_bytes=False, role=role,
                            params={k: v.clone() for k, v in params.items()},
                            place=pt.CUDAPlace(dev.index or 0))

    res = {"requests": n, "budget_tokens": int(budgets.sum())}
    res["c15"] = step_row_bits(
        lm, params, DecodeConfig(kv_dtype="bfloat16", **serve), prompts,
        dev, block)
    c15 = res["c15"]
    log(f"  C15: a decode step's logits at {c15['rows']} rows against two "
        f"steps of {block}: bit-equal {c15['whole_bit_equal']} (max abs "
        f"diff {c15['whole_max_abs_diff']:.3e}, "
        f"{c15['whole_rows_differing']} rows differ; ops whose rows "
        f"differ {c15['whole_ops_differing'][:6]}); with row_block "
        f"{block}: bit-equal {c15['blocked_bit_equal']} (max abs diff "
        f"{c15['blocked_max_abs_diff']:.3e}; ops "
        f"{c15['blocked_ops_differing'][:6]})")
    res["import_op"] = import_op_cases(dev)
    log(f"  paged_kv_import card vs CPU: "
        f"{ {k: v['bit_equal'] for k, v in res['import_op'].items()} }")

    def stream(fleet):
        t0 = time.perf_counter()
        outs = _stream_through(fleet.submit, prompts, budgets)
        return outs, time.perf_counter() - t0

    ufleet = Fleet([engine(), engine()], FleetConfig()).start()
    u_outs, u_s = stream(ufleet)
    u_snap = ufleet.snapshot()
    u_ttft = ufleet.merged_stats().ttft_ms.summary()
    ufleet.close()
    control = [r.tokens.tolist() for r in u_outs]
    u_tokens = sum(map(len, control))
    res["unified"] = {"wall_s": u_s, "tokens": u_tokens,
                      "tokens_per_s": u_tokens / u_s, "ttft_ms": u_ttft,
                      "failed": u_snap["failed"],
                      "post_warmup_compiles":
                          u_snap["post_warmup_compiles"]}

    tracer = ReqTracer(sample_rate=0.0)
    dfleet = DisaggFleet([engine("prefill")],
                         [engine("decode", DISAGG_DECODE_SLOTS)],
                         FleetConfig(), tracer=tracer).start()
    srv = dfleet.start_metrics_server(host="127.0.0.1", port=0)
    kernels.reset_counts()
    d_outs, d_s = stream(dfleet)
    text = _scrape(srv.url + "/metrics")
    health = json.loads(_scrape(srv.url + "/healthz"))
    d_snap = dfleet.snapshot()
    dfleet.close()
    families = sorted({ln.split()[2] for ln in text.splitlines()
                       if ln.startswith("# TYPE disagg_")})
    d_tokens = [r.tokens.tolist() for r in d_outs]
    res["disagg"] = {
        "wall_s": d_s, "tokens": sum(map(len, d_tokens)),
        "tokens_per_s": sum(map(len, d_tokens)) / d_s,
        "ttft_ms": d_snap["ttft_ms"], "handoff_ms": d_snap["handoff_ms"],
        "handoffs": d_snap["handoffs"],
        "pages_transferred": d_snap["pages_transferred"],
        "bytes_transferred": d_snap["bytes_transferred"],
        "failed": d_snap["failed"], "parity_failed": d_snap["parity_failed"],
        "post_warmup_compiles": d_snap["post_warmup_compiles"],
        "step_row_block": block,
        "diverged": [i for i, (a, b) in enumerate(zip(d_tokens, control))
                     if a != b],
        "metric_families": families,
        "healthz_decode": health["healthy_decode"],
        "decode_tpot_ms": d_snap["engines"]["tpot_ms"]}

    cfleet = DisaggFleet([engine("prefill")], [engine("decode"),
                                               engine("decode")],
                         FleetConfig()).start()
    victim = cfleet.decode[0].engine
    t0 = time.perf_counter()
    futs = [cfleet.submit(p, max_new_tokens=int(b))
            for p, b in zip(prompts, budgets)]
    deadline = time.monotonic() + 600
    while sum(f.done() for f in futs) < n // 2:
        if time.monotonic() > deadline:
            raise AssertionError("4g chaos: half the stream did not "
                                 "complete within 600 s")
        time.sleep(0.001)
    chaos.kill_replica(victim)
    c_outs = [f.result(600) for f in futs]
    c_s = time.perf_counter() - t0
    counts = kernels.counts()
    c_snap = cfleet.snapshot()
    dead = [h.replica_id for h in cfleet.decode if h.dead]
    cfleet.close()
    chaos.clear()
    c_tokens = [r.tokens.tolist() for r in c_outs]
    res["chaos"] = {
        "wall_s": c_s, "decode_failovers": c_snap["decode_failovers"],
        "prefill_failovers": c_snap["prefill_failovers"],
        "parity_checked": c_snap["parity_checked"],
        "parity_failed": c_snap["parity_failed"],
        "failed": c_snap["failed"], "retries": c_snap["retries"],
        "ejects": c_snap["ejects"], "dead": dead,
        "handoffs": c_snap["handoffs"],
        "post_warmup_compiles": c_snap["post_warmup_compiles"],
        "diverged": [i for i, (a, b) in enumerate(zip(c_tokens, control))
                     if a != b]}
    la = counts["launches"]
    res["launches"] = la
    res["plain_calls"] = counts["plain"]
    d, c, u = res["disagg"], res["chaos"], res["unified"]
    log(f"  unified fleet (2 x {block} slots): {u['tokens']} tokens in "
        f"{u_s:.3f} s, {u['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{u_ttft['p50_ms']} ms p99 {u_ttft['p99_ms']} ms on {card}")
    log(f"  disagg (1 prefill x {block}, 1 decode x "
        f"{DISAGG_DECODE_SLOTS}, step row block {block}): {d['tokens']} "
        f"tokens in {d_s:.3f} s, {d['tokens_per_s']:.1f} tokens/s, TTFT "
        f"p50 {d['ttft_ms']['p50_ms']} ms p99 {d['ttft_ms']['p99_ms']} ms;"
        f" handoffs {d['handoffs']}, handoff p50 "
        f"{d['handoff_ms']['p50_ms']} ms p99 {d['handoff_ms']['p99_ms']} "
        f"ms, {d['pages_transferred']} pages, {d['bytes_transferred']} "
        f"bytes; decode TPOT p50 {d['decode_tpot_ms']['p50_ms']} ms; "
        f"failed {d['failed']}, parity failed {d['parity_failed']}, "
        f"post_warmup_compiles {d['post_warmup_compiles']}; tokens equal "
        f"to the unified fleet's {n - len(d['diverged'])}/{n}")
    log(f"  /metrics over {srv.url}: {len(families)} disagg_* families "
        f"{families}")
    log(f"  chaos (1 prefill, 2 decode x {block}, decode worker "
        f"{victim.replica_id} killed after {n // 2} completions): "
        f"{c_s:.3f} s, decode failovers {c['decode_failovers']} (parity "
        f"checked {c['parity_checked']}, failed {c['parity_failed']}), "
        f"retries {c['retries']}, ejects {c['ejects']}, dead {dead}, "
        f"client failures {c['failed']}, post_warmup_compiles "
        f"{c['post_warmup_compiles']}; tokens equal to the unified "
        f"fleet's {n - len(c['diverged'])}/{n}")
    log(f"  launches (disagg + chaos) { {k: v for k, v in la.items() if v} }")
    want_families = {"disagg_handoffs_total", "disagg_prefill_wait_ms",
                     "disagg_decode_tpot_ms", "disagg_handoff_ms",
                     "disagg_workers", "disagg_failovers_total"}
    if (not c15["blocked_bit_equal"]
            or not all(v["bit_equal"] and v["pool_changed"]
                       for v in res["import_op"].values())
            or u["failed"] or u["post_warmup_compiles"] or u_tokens
            != res["budget_tokens"]
            or d["diverged"] or d["failed"] or d["parity_failed"]
            or d["post_warmup_compiles"] or d["handoffs"] != n
            or not want_families <= set(families)
            or c["diverged"] or c["failed"] or c["parity_failed"]
            or c["decode_failovers"] < 1 or c["post_warmup_compiles"]
            or dead != [victim.replica_id]
            or la["paged_attention"] < 1 or la["flash_attention_fwd"] < 1
            or max(counts["plain"].values())
            or max(counts["composed"].values())):
        raise AssertionError(f"4g disagg: {res}")
    return res


# -- phase 6w: data parallelism -------------------------------------------

# the phase-6 Transformer (bench widths, CUT_LAYERS + CUT_LAYERS layers)
# at global batch 64, dropout 0 so every rank's program is the one
# process's, DP_STEPS Adam steps; two ranks on the one card share it over
# gloo through the host
DP_BATCH, DP_STEPS, DP_RANKS = 64, 3, 2
DP_ARCH = dict(dropout=0.0, n_layer=CUT_LAYERS)
DP_MODES = (None, "bf16", "int8")
# the ranks against one process: float32, other row counts in every
# cuBLAS product, the loss a sum over the ranks (as phase 7's TOL_LOSS)
TOL_DP_LOSS = 1e-4
# the int8 exchange against bf16 (the reference's documented 1e-2)
TOL_DP_INT8 = 1e-2
# step 1's synchronized gradients (every param@GRAD) against (a)'s
# global-batch gradients, relative L2 over all of them: float32 sums in
# another order (default, bf16); the int8 exchange's quantization
# (int8).  Each rank's exchange is also held bit for bit against the
# plain mean of the two ranks' local gradients (_plain_sync).  Measured
# 2.914e-6 and 1.461e-2 at 6 + 6 layers, 1.685e-6 and 1.612e-2 at 2 + 2
# (H100 80GB HBM3, 700 W); a copy giving both ranks rank 0's gradient
# reads 0.986
TOL_DP_GRAD = 1e-5
TOL_DP_GRAD_INT8 = 3e-2
DP_WORKER_TIMEOUT_S = 300
DP_LABEL = "gloo through the host on one card, not NCCL across cards"


def _free_port() -> int:
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _dp_feed():
    from paddle_tpu_torch.models import transformer

    return transformer.make_fake_batch(DP_BATCH, TRAIN_ARCH["max_length"],
                                       TRAIN_ARCH["src_vocab_size"],
                                       TRAIN_ARCH["trg_vocab_size"], seed=5)


def _scope_of(main, arrays, dev):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.convert import params_from_arrays

    scope = pt.Scope()
    for n, t in params_from_arrays(arrays, dev, program=main).items():
        scope.set_var(n, t)
    return scope


def _dp_steps(exe, target, feed, loss, scope, steps=DP_STEPS, grads=()):
    """`steps` runs of `target`: (losses, step ms, {name: step 1's
    value} of the names `grads`, fetched at step 1 on the card)."""
    losses, ms, first = [], [], {}
    for step in range(steps):
        fetch = [loss] + (list(grads) if step == 0 else [])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(target, feed=feed, fetch_list=fetch, scope=scope,
                      return_numpy=False)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[0].reshape(-1)[0]))
        if step == 0:
            first = dict(zip(grads, out[1:]))
    return losses, ms, first


def _grad_names(main):
    return [f"{p.name}@GRAD" for p in main.all_parameters() if p.trainable]


def _plain_sync(mode, parts, block, floor):
    """The plain mean of the ranks' local gradients `parts` (rank
    order) that the exchange of `mode` computes: their sum over n; under
    int8, for a float gradient of at least max(floor, n * block)
    elements, the two-phase blockwise-int8 exchange (each rank's chunks
    quantized at max|block| / 127, a zero block at scale 1, rounded half
    to even; the dequantized sum re-quantized; then over n)."""
    n, x = len(parts), parts[0]
    if mode != "int8" or not x.is_floating_point() or x.numel() < max(
            floor, n * block):
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc / n

    def quant(v):
        amax = v.abs().amax(dim=-1)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        q = torch.clamp(torch.round(v / scale[..., None]), -127, 127)
        return q * scale[..., None]

    size = x.numel()
    pad = (-size) % (n * block)
    red = None
    for p in parts:
        v = torch.nn.functional.pad(p.reshape(-1).float(), (0, pad))
        d = quant(v.reshape(n, -1, block))
        red = d if red is None else red + d
    out = quant(red).reshape(-1)[:size]
    return (out * (1.0 / n)).reshape(x.shape).to(x.dtype)


def _grad_rel_err(got, want):
    """sqrt(sum ||got - want||^2 / sum ||want||^2) over the names of
    `want`, float64 sums."""
    num = den = 0.0
    for n, w in want.items():
        w = w.double()
        num += float(torch.sum(torch.square(got[n].double() - w)))
        den += float(torch.sum(torch.square(w)))
    return (num / den) ** 0.5


def _persistables(main, scope):
    return {v.name: scope.find_var(v.name) for v in main.list_vars()
            if v.persistable and isinstance(scope.find_var(v.name),
                                            torch.Tensor)}


def _dp_worker_cmd(run_dir, rank, port):
    return [sys.executable, os.path.abspath(__file__), "--dp-worker",
            run_dir, str(rank), str(port)]


def dp_worker(argv) -> int:
    """One rank of 6w (b) and (c): `chip_smoke.py --dp-worker DIR RANK
    PORT`.  Joins a gloo group of DP_RANKS through init_distributed on
    the card, then runs the Transformer from DIR/transformer_init.npz on
    DIR/transformer_feed.npz in each of DP_MODES (DP_STEPS steps each,
    its half of the batch) and the ResNet from DIR/resnet_init.npz in
    the default mode; writes DIR/rank<RANK>.json (losses, step and
    exchange ms, kernel counts; for the Transformer, step 1's
    synchronized gradients against the plain mean of the ranks' local
    ones and against DIR/transformer_grad.npz) and each run's
    parameters to DIR/rank<RANK>_<mode>.npz."""
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.parallel import data_parallel as dpm

    run_dir, rank, port = argv[0], int(argv[1]), int(argv[2])
    _set_matmul_flags()
    _build.build()
    place = pt.CUDAPlace(0)
    pt.parallel.init_distributed(trainer_id=rank, num_trainers=DP_RANKS,
                                 coordinator=f"127.0.0.1:{port}",
                                 health=False, place=place, backend="gloo")
    dev = pt.Executor(place).device
    mesh = pt.parallel.make_mesh({"dp": DP_RANKS})
    spent = []
    exchange = dpm.DataParallelRunner.exchange
    local = {}

    def timed_exchange(self, loss, grads, *a, **kw):
        # the gradient exchange alone, the card drained on both sides;
        # step 1's local gradients kept for the plain mean
        if not local:
            local.update({p: g.detach().clone() for p, g in grads.items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exchange(self, loss, grads, *a, **kw)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    dpm.DataParallelRunner.exchange = timed_exchange
    res = {"rank": rank, "modes": {}}

    def gathered(t):
        # every rank's `t` in rank order, on the card: torch.distributed
        # on host copies, not the port's collectives
        parts = [torch.empty_like(t, device="cpu") for _ in range(DP_RANKS)]
        dist.all_gather(parts, t.cpu())
        return [x.to(t.device) for x in parts]

    def check_grads(mode, synced, want):
        """Step 1's synchronized gradients: bit for bit the plain mean
        of the ranks' local ones (names that differ), and against (a)'s
        global-batch gradients (relative L2)."""
        cfg = pt.parallel.GradSyncConfig()
        differ = []
        for p in sorted(local):
            plain = _plain_sync(mode, gathered(local[p]), cfg.block_size,
                                cfg.min_quant_numel)
            if not torch.equal(synced[f"{p}@GRAD"], plain):
                differ.append(p)
        return {"sync_differ": differ,
                "grad_rel_err": _grad_rel_err(synced, want)}

    def run(label, main, model, arrays, feed, mode=None, want=None):
        scope = _scope_of(main, arrays, dev)
        exe = pt.Executor(place)
        bs = pt.BuildStrategy()
        bs.grad_sync = mode
        pt.CompiledProgram(main).with_data_parallel(
            loss_name=model["loss"].name, build_strategy=bs, mesh=mesh)
        kernels.reset_counts()
        spent.clear()
        local.clear()
        names = _grad_names(main) if want is not None else ()
        losses, ms, synced = _dp_steps(exe, main, feed, model["loss"],
                                       scope, grads=names)
        counts = kernels.counts()
        np.savez(os.path.join(run_dir, f"rank{rank}_{label}.npz"),
                 **{n: v.cpu().numpy()
                    for n, v in _persistables(main, scope).items()})
        res["modes"][label] = {"losses": losses, "step_ms": ms,
                               "exchange_ms": list(spent),
                               "counts": counts,
                               "want": _want_launches(main, DP_STEPS)}
        if want is not None:
            res["modes"][label].update(check_grads(mode, synced, want))

    arrays = dict(np.load(os.path.join(run_dir, "transformer_init.npz")))
    feed = dict(np.load(os.path.join(run_dir, "transformer_feed.npz")))
    want = {n: torch.from_numpy(v).to(dev) for n, v in
            np.load(os.path.join(run_dir, "transformer_grad.npz")).items()}
    for mode in DP_MODES:
        main, startup, model = build_training(**DP_ARCH)
        run(mode or "default", main, model, arrays, feed, mode, want)
    del want
    arrays = dict(np.load(os.path.join(run_dir, "resnet_init.npz")))
    feed = dict(np.load(os.path.join(run_dir, "resnet_feed.npz")))
    main, startup, model = build_resnet(learning_rate=RESNET_PARITY_LR)
    run("resnet", main, model, arrays, feed)
    with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    pt.parallel.shutdown_distributed()
    print("DONE", flush=True)
    return 0


def _dp_one_process(dev, card):
    """6w (a): trainer 0 of 1 through init_distributed (NCCL), the
    compiled program on a one-rank mesh against plain Executor.run, bit
    for bit (fetches, state, step 1's gradients); returns (result,
    arrays, feed, the plain run's parameters and step-1 gradients, the
    compiled run's kernel counts)."""
    import torch.distributed as dist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import kernels

    place = pt.CUDAPlace(0)
    pt.parallel.init_distributed(trainer_id=0, num_trainers=1,
                                 coordinator=f"127.0.0.1:{_free_port()}",
                                 health=False, place=place)
    backend = dist.get_backend()
    # NCCL on the card (gloo only where the place is the CPU)
    if backend != ("gloo" if isinstance(place, pt.CPUPlace) else "nccl"):
        raise AssertionError(f"6w (a) ran on {backend}")
    main, startup, model = build_training(**DP_ARCH)
    init = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=init)
    arrays = {n: v.cpu().numpy() for n, v in init.vars.items()
              if isinstance(v, torch.Tensor)}
    feed = _dp_feed()
    runs = {}
    for label in ("plain", "compiled"):
        main, startup, model = build_training(**DP_ARCH)
        scope = _scope_of(main, arrays, dev)
        target = main
        if label == "compiled":
            target = pt.CompiledProgram(main).with_data_parallel(
                loss_name=model["loss"].name,
                mesh=pt.parallel.make_mesh({"dp": 1}))
        kernels.reset_counts()
        losses, ms, grads = _dp_steps(exe, target, feed, model["loss"],
                                      scope, grads=_grad_names(main))
        runs[label] = (losses, ms, _persistables(main, scope),
                       kernels.counts(), grads)
    (pl, pms, pstate, _, pgrads), (cl, cms, cstate, counts, cgrads) = (
        runs["plain"], runs["compiled"])
    differ = sorted(n for n in pstate if not torch.equal(pstate[n],
                                                         cstate[n]))
    differ += sorted(n for n in pgrads if not torch.equal(pgrads[n],
                                                          cgrads[n]))
    log(f"  (a) {backend}, one rank: losses plain {pl} compiled {cl}; "
        f"step ms plain {[round(x, 3) for x in pms]} compiled "
        f"{[round(x, 3) for x in cms]} ({card})")
    if pl != cl or differ:
        raise AssertionError(f"6w (a): compiled one-rank run not bit for "
                             f"bit the plain run (losses {pl} vs {cl}, "
                             f"{len(differ)} state vars or step-1 "
                             f"gradients differ: {differ[:4]})")
    want = _want_launches(main, DP_STEPS)
    if counts["launches"] != want or max(counts["plain"].values()):
        raise AssertionError(f"6w (a): launches {counts}, want {want}")
    pt.parallel.shutdown_distributed()
    names = {p.name for p in main.all_parameters()}
    params = {n: v.cpu().numpy() for n, v in pstate.items() if n in names}
    grads = {n: v.cpu().numpy() for n, v in pgrads.items()}
    return ({"backend": backend, "losses": pl, "step_ms_plain": pms,
             "step_ms_compiled": cms, "bit_equal": True}, arrays, feed,
            params, grads, counts)


def _resnet_global(dev, run_dir):
    """6w (c)'s control: 7e's ResNet-50 on the global batch in one
    process on the card; its start and feed saved for the ranks."""
    import paddle_tpu_torch as pt

    main, startup, model = build_resnet(learning_rate=RESNET_PARITY_LR)
    init = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=init)
    arrays = {n: v.cpu().numpy() for n, v in init.vars.items()
              if isinstance(v, torch.Tensor)}
    feed = resnet_batch(RESNET_PARITY_BATCH, seed=3)
    np.savez(os.path.join(run_dir, "resnet_init.npz"), **arrays)
    np.savez(os.path.join(run_dir, "resnet_feed.npz"), **feed)
    scope = _scope_of(main, arrays, dev)
    losses, _, _ = _dp_steps(exe, main, feed, model["loss"], scope)
    stats = {n: v.cpu().numpy() for n, v in _persistables(main,
                                                          scope).items()
             if n.endswith((".mean", ".var"))}
    return losses, stats


def _run_workers(label, run_dir, n, cmd, stem, timeout_s):
    """n worker processes side by side, rank r started as `cmd(r, port)`;
    their results, run_dir/<stem>.json with r in `stem`.  Each rank's
    output goes to <stem>.log: a pipe nobody drains could block a rank
    while another waits for it in a collective.  A rank that fails or
    outlives `timeout_s` fails phase `label` and every worker is
    stopped."""
    port = _free_port()
    stems = [os.path.join(run_dir, stem.format(r=r)) for r in range(n)]
    procs = []
    for r, path in enumerate(stems):
        with open(path + ".log", "w") as f:
            procs.append(subprocess.Popen(cmd(r, port), stdout=f,
                                          stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{label}: a rank of {n} outlived "
                             f"{timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, path) in enumerate(zip(procs, stems)):
        with open(path + ".log", errors="replace") as f:
            out = f.read()
        if p.returncode != 0 or "DONE" not in out:
            raise AssertionError(f"{label} rank {r} of {n} failed (rc "
                                 f"{p.returncode}): {out[-3000:]}")
    res = []
    for path in stems:
        with open(path + ".json") as f:
            res.append(json.load(f))
    return res


def phase_data_parallel(dev, card):
    """6w (see the module docstring)."""
    log(f"phase 6w: data parallelism, the bench Transformer (dropout 0) "
        f"at {CUT_LAYERS}+{CUT_LAYERS} layers, global batch {DP_BATCH}, "
        f"{DP_STEPS} Adam steps; {card}")
    run_dir = os.path.join(OUT_DIR, "dp")
    os.makedirs(run_dir, exist_ok=True)
    one, arrays, feed, want_params, want_grads, counts_a = _dp_one_process(
        dev, card)
    np.savez(os.path.join(run_dir, "transformer_init.npz"), **arrays)
    np.savez(os.path.join(run_dir, "transformer_feed.npz"), **feed)
    np.savez(os.path.join(run_dir, "transformer_grad.npz"), **want_grads)
    del want_grads
    resnet_losses, resnet_stats = _resnet_global(dev, run_dir)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _run_workers("6w", run_dir, DP_RANKS,
                         lambda r, port: _dp_worker_cmd(run_dir, r, port),
                         "rank{r}", DP_WORKER_TIMEOUT_S)
    log(f"  (b)+(c) {DP_RANKS} ranks, {DP_LABEL}: "
        f"{time.perf_counter() - t0:.1f} s with their start")
    lr_sum = sum(_noam_lr(t) for t in range(1, DP_STEPS + 1))
    bound = 4 * lr_sum + 1e-6
    launches = dict(counts_a["launches"])
    summary = {"one_process": one, "label": DP_LABEL, "card": card,
               "modes": {}}
    for label in [m or "default" for m in DP_MODES] + ["resnet"]:
        runs = [r["modes"][label] for r in ranks]
        params = [dict(np.load(os.path.join(run_dir,
                                            f"rank{r}_{label}.npz")))
                  for r in range(DP_RANKS)]
        if any(x["losses"] != runs[0]["losses"] for x in runs) or any(
                not np.array_equal(p[n], params[0][n]) for p in params[1:]
                for n in params[0]):
            raise AssertionError(f"6w {label}: the ranks differ")
        for r, x in enumerate(runs):
            c = x["counts"]
            if (c["launches"] != x["want"] or max(c["plain"].values())
                    or max(c["composed"].values())):
                raise AssertionError(f"6w {label} rank {r}: launches {c},"
                                     f" want {x['want']}")
            for k, v in c["launches"].items():
                launches[k] = launches.get(k, 0) + v
        losses = runs[0]["losses"]
        entry = {"losses": losses,
                 "step_ms": {r: x["step_ms"] for r, x in enumerate(runs)},
                 "exchange_ms": {r: x["exchange_ms"]
                                 for r, x in enumerate(runs)}}
        if label == "resnet":
            loss_err = max(abs(a - b) / abs(b) for a, b in
                           zip(losses, resnet_losses))
            stats_err = {}
            for suffix in (".mean", ".var"):
                names = [n for n in resnet_stats if n.endswith(suffix)]
                scale = max(np.abs(resnet_stats[n]).max() for n in names)
                stats_err[suffix] = max(float(np.abs(
                    params[0][n] - resnet_stats[n]).max())
                    for n in names) / float(scale)
            entry.update(one_process_losses=resnet_losses,
                         loss_max_rel_err=loss_err,
                         moving_stats_max_err=stats_err)
            if not (loss_err <= TOL_RESNET_LOSS
                    and max(stats_err.values()) <= TOL_RESNET_STATS):
                raise AssertionError(f"6w (c): ResNet dp=2 against the "
                                     f"global batch: {entry}")
        else:
            loss_err = max(abs(a - b) / abs(b)
                           for a, b in zip(losses, one["losses"]))
            p_err = max(float(np.abs(params[0][n] - want_params[n]).max())
                        for n in want_params if n in params[0])
            g_errs = [x["grad_rel_err"] for x in runs]
            g_tol = TOL_DP_GRAD_INT8 if label == "int8" else TOL_DP_GRAD
            entry.update(loss_max_rel_err=loss_err, param_max_abs_err=p_err,
                         param_bound=bound, grad_rel_err=g_errs,
                         grad_tol=g_tol,
                         sync_differ={r: x["sync_differ"]
                                      for r, x in enumerate(runs)})
            log(f"  {label}: step-1 gradients against (a) rel L2 "
                f"{[f'{e:.3e}' for e in g_errs]} (tol {g_tol:g}); against "
                f"the plain mean of the ranks' local gradients: "
                f"{[len(x['sync_differ']) for x in runs]} of "
                f"{len(want_params)} differ")
            if any(x["sync_differ"] for x in runs) or max(g_errs) > g_tol:
                raise AssertionError(f"6w (b) {label}: the synchronized "
                                     f"gradients: {entry}")
            if label != "int8" and not (loss_err <= TOL_DP_LOSS
                                        and p_err <= bound):
                raise AssertionError(f"6w (b) {label} against (a): losses "
                                     f"{loss_err}, params {p_err}")
        summary["modes"][label] = entry
        log(f"  {label}: losses {losses} (rel err {loss_err:.3e}); "
            f"step ms rank 0 {[round(x, 1) for x in entry['step_ms'][0]]}"
            f", rank 1 {[round(x, 1) for x in entry['step_ms'][1]]}; "
            f"exchange ms rank 0 "
            f"{[round(x, 1) for x in entry['exchange_ms'][0]]}, rank 1 "
            f"{[round(x, 1) for x in entry['exchange_ms'][1]]} ({DP_LABEL};"
            f" {card})")
    bf16 = summary["modes"]["bf16"]["losses"]
    int8 = summary["modes"]["int8"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(int8, bf16))
    summary["int8_vs_bf16_max_rel"] = rel
    log(f"  int8 against bf16: max rel {rel:.3e} (tol {TOL_DP_INT8:g}); "
        f"descending {int8[-1] < int8[0]}")
    if not (rel <= TOL_DP_INT8 and int8[-1] < int8[0]):
        raise AssertionError(f"6w int8: {int8} against bf16 {bf16}")
    summary["launches"] = launches
    return summary


# -- phase 6x: the model axes ----------------------------------------------

# ranks share the one card over gloo through the host, as 6w (b) does: (a)
# mp = 2 (and, at 2+2 layers, with the fused vocab CE), (b) sp = 2, (c)
# pp = 2, (d) ep = 2 (at CUT_LAYERS + CUT_LAYERS layers) in one group of
# two worker processes, (e) dp = 2 x mp = 2 in a group of four.  Each run takes
# MX_STEPS Adam (SGD for (b)) steps from the one-process run's start
# values and feed, and is held against the one-process run (a plain
# CUDAPlace(0) Executor): step 1's gradients by relative L2, every loss
# relatively
MX_STEPS, MX_BATCH = 3, 64
MX_PARTS_2, MX_PARTS_4 = ("a", "b", "c", "d"), ("e",)
# (b): longctx_8k's attention (LONGCTX: T 8192, 8 heads of 64), causal,
# behind an fc to head-grouped QKV (tests/test_ring_attention.py:101-150)
MX_SP = dict(n=2, t=8192, h=8, d=64)
# (e): (a)'s Transformer cut to 2+2 layers
MX_DPMP_LAYERS = 2
# every loss of a run within this share of the one-process run's
TOL_MX_LOSS = 1e-4
# step 1's gradients against the one-process run's, relative L2 over the
# names the rank holds.  (b) and (d) keep every product's shape: float32
# sums in another order only (the ring's lse merge and its backward's
# dQ/dK/dV sums); measured 3.756e-7 (ring), 0 (Ulysses), 2.8e-10 (ep at
# 6 + 6 layers; 3.006e-10 at 2 + 2) (H100 80GB HBM3, 700 W).  (a), (c) and (e) change the shapes of the
# Transformer's products (half the columns or rows under mp, 16-row
# microbatches under pp), so cuBLAS sums in other orders, and 12 layers
# carry the difference on; measured 1.086e-4, 9.357e-5 and 1.352e-4, and
# one process with its products split the same way reads as much
# (MX_ALT).  A wrong exchange reads ~0.5 or more (a missing all-reduce
# leaves each rank half of a sum)
TOL_MX_GRAD = 1e-5
TOL_MX_GRAD_RESHAPED = 1e-3
MX_WORKER_TIMEOUT_S = 240
# the cause of the gaps of (a), (c) and (e), shown in one process: step
# 1's gradients of the part's program with each Megatron-sharded product
# split as mp = 2 splits it (`_SplitProducts`), or of (c)'s in its 4
# microbatches (gradient accumulation, K = the pipeline's default 2 x
# pp).  Against the plain run they read what the ranks read (1.085e-4
# split, 1.021e-4 in microbatches; H100 80GB HBM3, 700 W); the ranks
# against them 2.549e-7 (mp) and 1.970e-6 (pp): within TOL_MX_GRAD, the
# level of the parts that keep every product's shape
MX_ALT = {"a": "split", "a_fce": "split", "c": "accum", "e": "split"}
MX_ACCUM = 4


class _SplitProducts:
    """A one-process run (tensor_parallel.activated) whose `mul`s with a
    Megatron-sharded weight compute as mp = 2 does on its two ranks: a
    column-sharded weight's product as two half-column products side by
    side, a row-sharded one's as rank 0's half-K product plus rank 1's.
    Every other op runs as it is."""

    def __init__(self, rules):
        self.rules = rules.rules

    def run_op(self, desc, ins, attrs, call):
        if desc.type != "mul":
            return call(ins, attrs)
        w = desc.inputs["Y"][0]
        spec = next((sp for pat, sp in self.rules if pat.search(w)), None)
        x, y = ins["X"][0], ins["Y"][0]
        if spec == (None, "mp"):
            return {"Out": [torch.cat(
                [call({"X": [x], "Y": [h.contiguous()]}, attrs)["Out"][0]
                 for h in y.chunk(2, 1)], dim=-1)]}
        if spec == ("mp", None):
            xs, ys = x.chunk(2, -1), y.chunk(2, 0)
            o0, o1 = (call({"X": [a.contiguous()], "Y": [b.contiguous()]},
                           attrs)["Out"][0] for a, b in zip(xs, ys))
            return {"Out": [o0 + o1]}
        return call(ins, attrs)


def _mx_want_counts(key):
    """The collectives mp = 2 inserts in a step of (a), (a_fce) and (e):
    one forward all-reduce an attention block and an MLP block (5 a
    layer: the encoder's self-attention and FFN, the decoder's self- and
    cross-attention and FFN), one each for the two vocab-sharded
    embeddings' lookups, and the vocab-parallel CE's two (the sum of
    exps, the label terms) and its row max; the fused CE's run leaves
    its projection whole.  No forward all-gather (a gather would
    compute replicated); None for the other parts."""
    if key not in ("a", "a_fce", "e"):
        return None
    layers = TRAIN_ARCH["n_layer"] if key == "a" else MX_DPMP_LAYERS
    ce = int(key != "a_fce")
    return {"all_reduce": 5 * layers + 2 + 2 * ce, "all_reduce_max": ce}


def _mx_sp_program(strategy):
    """(b)'s program: fc to head-grouped QKV, the flash op (causal,
    sequence_parallel=strategy), mean of squares, SGD."""
    import paddle_tpu_torch as pt

    n, t, h, d = (MX_SP[k] for k in "nthd")
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 3
    layers = pt.layers
    with pt.program_guard(main, startup), pt.unique_name.guard():
        x = layers.data("x", shape=[n, t, h * d], append_batch_size=False)
        qkv = layers.fc(x, size=3 * h * d, num_flatten_dims=2,
                        bias_attr=False, name="attn_qkv")
        r = layers.transpose(layers.reshape(qkv, shape=[0, 0, h, 3 * d]),
                             perm=[0, 2, 1, 3])
        q, k, v = (layers.slice(r, axes=[3], starts=[i * d],
                                ends=[(i + 1) * d]) for i in range(3))
        att = layers.flash_attention(q, k, v, causal=True,
                                     sequence_parallel=strategy)
        loss = layers.reduce_mean(layers.square(att))
        pt.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, {"loss": loss}


def _mx_builds():
    """{part: (builder, feed name)} of 6x's programs."""
    return {
        "a": (lambda: build_training(dropout=0.0), "tr"),
        "a_fce": (lambda: build_training(dropout=0.0, n_layer=MX_DPMP_LAYERS,
                                         use_fused_ce=True), "fce"),
        "b": (lambda: _mx_sp_program(True), "sp"),
        "b_ulysses": (lambda: _mx_sp_program("ulysses"), "sp"),
        "c": (lambda: build_training(dropout=0.0, pipeline=True), "tr"),
        "d": (lambda: build_training(dropout=0.0, n_layer=CUT_LAYERS,
                                     **MOE), "moe"),
        "e": (lambda: build_training(dropout=0.0, n_layer=MX_DPMP_LAYERS),
              "dpmp"),
    }


def _mx_feed(kind):
    if kind == "sp":
        n, t, h, d = (MX_SP[k] for k in "nthd")
        return {"x": np.random.RandomState(0).randn(n, t, h * d).astype(
            np.float32)}
    from paddle_tpu_torch.models import transformer

    return transformer.make_fake_batch(MX_BATCH, TRAIN_ARCH["max_length"],
                                       TRAIN_ARCH["src_vocab_size"],
                                       TRAIN_ARCH["trg_vocab_size"], seed=5)


def _mx_steps(exe, target, feed, loss, scope, grads=(), compiled=None,
              steps=MX_STEPS, accum=1):
    """`steps` runs: (losses, step ms, step 1's {name: value} of
    `grads`, the collectives each step inserted and their ms)."""
    losses, ms, first, counts, coll_ms = [], [], {}, [], []
    for step in range(steps):
        fetch = [loss] + (list(grads) if step == 0 else [])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(target, feed=feed, fetch_list=fetch, scope=scope,
                      return_numpy=False, accumulation_steps=accum)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[0].reshape(-1)[0]))
        if step == 0:
            first = dict(zip(grads, out[1:]))
        if compiled is not None:
            counts.append(compiled.collective_counts())
            coll_ms.append(compiled.collective_ms())
    return losses, ms, first, counts, coll_ms


def _mx_baselines(dev, run_dir):
    """The one-process runs 6x holds its ranks against, on the card:
    each program's start values, feed, losses and step 1's gradients
    (for (d) the port's plain version of ep = 2's grouped routing,
    ops.moe.moe_grouped(groups=2), with its dropped choices)."""
    import contextlib

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import moe as M
    from paddle_tpu_torch.parallel import tensor_parallel
    from paddle_tpu_torch.parallel.strategies import \
        megatron_transformer_rules

    place = pt.CUDAPlace(0)
    out = {}
    for part, kind in (("a", "tr"), ("a_fce", "fce"), ("b", "sp"),
                       ("d", "moe"), ("e", "dpmp")):
        build, _ = _mx_builds()[part]
        main, startup, model = build()
        init = pt.Scope()
        exe = pt.Executor(place)
        exe.run(startup, scope=init)
        arrays = {n: v.cpu().numpy() for n, v in init.vars.items()
                  if isinstance(v, torch.Tensor)}
        feed = _mx_feed(kind)
        scope = _scope_of(main, arrays, dev)
        real = M.moe_grouped
        if part == "d":
            M.moe_grouped = lambda *a, **kw: real(*a, **dict(kw, groups=2))
            M.drop_log = []
        try:
            losses, ms, grads, _, _ = _mx_steps(exe, main, feed,
                                                model["loss"], scope,
                                                grads=_grad_names(main))
            drops = None if M.drop_log is None else \
                [int(t) for t in M.drop_log]
        finally:
            M.moe_grouped, M.drop_log = real, None
        np.savez(os.path.join(run_dir, f"{kind}_init.npz"), **arrays)
        np.savez(os.path.join(run_dir, f"{kind}_feed.npz"), **feed)
        np.savez(os.path.join(run_dir, f"{kind}_grad.npz"),
                 **{n: v.cpu().numpy() for n, v in grads.items()})
        out[kind] = {"losses": losses, "step_ms": ms, "drops": drops}
        del scope
        for alt_part, alt in MX_ALT.items():
            if _mx_builds()[alt_part][1] != kind:
                continue
            # step 1 of (a) with the products split as mp = 2 splits
            # them, or of (c) in its microbatches: its gradients, and
            # their gap from the plain run's
            main, _, model = _mx_builds()[alt_part][0]()
            scope = _scope_of(main, arrays, dev)
            with (tensor_parallel.activated(_SplitProducts(
                    megatron_transformer_rules())) if alt == "split"
                  else contextlib.nullcontext()):
                _, _, alt_grads, _, _ = _mx_steps(
                    exe, main, feed, model["loss"], scope,
                    grads=_grad_names(main), steps=1,
                    accum=MX_ACCUM if alt == "accum" else 1)
            out[kind][f"{alt}_vs_plain"] = _grad_rel_err(alt_grads, grads)
            np.savez(os.path.join(run_dir, f"{kind}_{alt}_grad.npz"),
                     **{n: v.cpu().numpy() for n, v in alt_grads.items()})
            del scope, alt_grads
        del grads
        torch.cuda.empty_cache()
    with open(os.path.join(run_dir, "baselines.json"), "w") as f:
        json.dump(out, f)
    return out


def _mx_worker_cmd(run_dir, rank, n, port, parts):
    return [sys.executable, os.path.abspath(__file__), "--mx-worker",
            run_dir, str(rank), str(n), str(port), ",".join(parts)]


def mx_worker(argv) -> int:
    """One rank of 6x: `chip_smoke.py --mx-worker DIR RANK N PORT
    PARTS`.  Joins a gloo group of N through init_distributed on the
    card and runs each of PARTS (6x's letters) from DIR's start values
    and feeds; writes DIR/rank<RANK>_<N>.json (per part: losses, step
    ms, the collectives a step and their ms, step 1's gradients against
    DIR's one-process ones, bytes held, kernel counts)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops import moe as M
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fk
    from paddle_tpu_torch.parallel.pipeline_engine import (StageHeld,
                                                           stage_ownership)
    from paddle_tpu_torch.parallel.strategies import \
        megatron_transformer_rules
    from torch.distributed.tensor import DTensor

    import importlib

    ra = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")
    run_dir, rank, n, port, parts = argv[0], int(argv[1]), int(argv[2]), \
        int(argv[3]), argv[4].split(",")
    _set_matmul_flags()
    _build.build()
    place = pt.CUDAPlace(0)
    pt.parallel.init_distributed(trainer_id=rank, num_trainers=n,
                                 coordinator=f"127.0.0.1:{port}",
                                 health=False, place=place, backend="gloo")
    dev = pt.Executor(place).device
    heads = []
    real_fwd = fk.flash_attention_fwd

    def recording_fwd(q, k, *a, **kw):
        layout = a[4] if len(a) > 4 else kw.get("layout", "nhtd")
        n_head = a[5] if len(a) > 5 else kw.get("n_head")
        heads.append(fk.dims(q, k, layout, n_head)[1])
        return real_fwd(q, k, *a, **kw)

    fk.flash_attention_fwd = recording_fwd
    res = {"rank": rank, "parts": {}}

    def held_bytes(scope, main):
        params = {p.name for p in main.all_parameters()}
        mine = total = 0
        for name, v in scope.vars.items():
            if name not in params:
                continue
            if isinstance(v, DTensor):
                loc = v.to_local()
                mine += loc.numel() * loc.element_size()
                total += v.numel() * loc.element_size()
            elif isinstance(v, StageHeld):
                size = int(np.prod(v.shape)) * v.dtype.itemsize
                total += size
                mine += size if v.value is not None else 0
        return mine, total

    def run(part, mesh_axes, rules=None):
        build, kind = _mx_builds()[part]
        main, startup, model = build()
        arrays = dict(np.load(os.path.join(run_dir, f"{kind}_init.npz")))
        feed = dict(np.load(os.path.join(run_dir, f"{kind}_feed.npz")))
        want = {nm: torch.from_numpy(v).to(dev) for nm, v in np.load(
            os.path.join(run_dir, f"{kind}_grad.npz")).items()}
        alt = MX_ALT.get(part)
        scope = _scope_of(main, arrays, dev)
        exe = pt.Executor(place)
        mesh = pt.parallel.make_mesh(mesh_axes)
        bs = pt.BuildStrategy()
        bs.sharding_rules = rules
        cp = pt.CompiledProgram(main).with_data_parallel(
            loss_name=model["loss"].name, build_strategy=bs, mesh=mesh)
        names = _grad_names(main)
        if mesh_axes.get("pp", 1) > 1:
            # the gradients of the parameters this rank's stage holds
            own = stage_ownership(main, mesh_axes["pp"])
            me = mesh.coordinate("pp")
            names = [g for g in names if own.get(g[:-len("@GRAD")], me)
                     == me]
        kernels.reset_counts()
        heads.clear()
        ra.offset_launches.clear()
        M.drop_log = []
        losses, ms, grads, counts, coll_ms = _mx_steps(
            exe, cp, feed, model["loss"], scope, grads=names, compiled=cp)
        drops = [int(t) for t in M.drop_log]
        M.drop_log = None
        c = kernels.counts()
        entry = {"losses": losses, "step_ms": ms,
                 "collectives": counts, "collective_ms": coll_ms,
                 "grad_rel_err": _grad_rel_err(
                     grads, {g: want[g] for g in names}),
                 "grad_rel_err_alt": None if alt is None else
                 _grad_rel_err(grads, {nm: torch.from_numpy(v).to(dev)
                                       for nm, v in np.load(os.path.join(
                                           run_dir, f"{kind}_{alt}_grad.npz"
                                       )).items() if nm in names}),
                 "worst_grads": sorted(
                     ((g, round(_grad_rel_err(grads, {g: want[g]}), 9))
                      for g in names if float(want[g].abs().sum()) > 0),
                     key=lambda t: -t[1])[:3],
                 "grad_names": len(names),
                 "held_bytes": held_bytes(scope, main),
                 "launches": c["launches"],
                 "plain": sum(c["plain"].values()),
                 "composed": sum(c["composed"].values()),
                 "flash_heads": sorted(set(heads)),
                 "offset_launches": dict(ra.offset_launches),
                 "drops": drops}
        del scope, grads, want
        torch.cuda.empty_cache()
        return entry

    megatron = megatron_transformer_rules()
    for part in parts:
        t0 = time.perf_counter()
        if part == "a":
            res["parts"]["a"] = run("a", {"mp": 2}, megatron)
            res["parts"]["a_fce"] = run("a_fce", {"mp": 2}, megatron)
        elif part == "b":
            res["parts"]["b_ring"] = run("b", {"sp": 2})
            res["parts"]["b_ulysses"] = run("b_ulysses", {"sp": 2})
        elif part == "c":
            res["parts"]["c"] = run("c", {"pp": 2})
        elif part == "d":
            res["parts"]["d"] = run("d", {"ep": 2},
                                    megatron_transformer_rules(
                                        moe_axis="ep"))
        elif part == "e":
            res["parts"]["e"] = run("e", {"dp": 2, "mp": 2}, megatron)
        res.setdefault("seconds", {})[part] = time.perf_counter() - t0
        print(f"part {part}: {res['seconds'][part]:.1f} s", flush=True)
    with open(os.path.join(run_dir, f"rank{rank}_{n}.json"), "w") as f:
        json.dump(res, f)
    pt.parallel.shutdown_distributed()
    print("DONE", flush=True)
    return 0


def phase_model_axes(dev, card):
    """6x: (a) mp = 2 on the bench Transformer (Megatron rules), and
    with the fused vocab CE at 2+2 layers (its kernels on the whole
    replicated W: the rules leave `vocab_proj` unsharded), (b) sp
    = 2 ring and Ulysses at longctx_8k's attention shape, (c) pp = 2 on
    the pipelined bench Transformer, (d) ep = 2 on 6t's switch-MoE
    Transformer at CUT_LAYERS + CUT_LAYERS layers, (e) dp = 2 x mp = 2 on the Transformer cut to 2+2
    layers; every run against its one-process run."""
    log(f"phase 6x: the model axes, ranks sharing one card ({DP_LABEL}); "
        f"{card}")
    run_dir = os.path.join(OUT_DIR, "mx")
    os.makedirs(run_dir, exist_ok=True)
    t0 = time.perf_counter()
    base = _mx_baselines(dev, run_dir)
    seconds = {"baselines": time.perf_counter() - t0}
    log(f"  one-process runs: {seconds['baselines']:.1f} s")
    ranks = {}
    for n, parts in ((2, MX_PARTS_2), (4, MX_PARTS_4)):
        t0 = time.perf_counter()
        ranks[n] = _run_workers(
            "6x", run_dir, n,
            lambda r, port: _mx_worker_cmd(run_dir, r, n, port, parts),
            f"rank{{r}}_{n}", MX_WORKER_TIMEOUT_S)
        seconds[f"{n} ranks"] = time.perf_counter() - t0
        log(f"  {n} ranks ({', '.join(parts)}): "
            f"{seconds[f'{n} ranks']:.1f} s with their start")
    summary = {"label": DP_LABEL, "card": card, "baselines": base,
               "seconds": seconds, "parts": {}}
    kinds = {"a": "tr", "a_fce": "fce", "b_ring": "sp", "b_ulysses": "sp",
             "c": "tr", "d": "moe", "e": "dpmp"}
    launches = {}
    for key, kind in kinds.items():
        n = 4 if key == "e" else 2
        runs = [r["parts"][key] for r in ranks[n]]
        one = base[kind]
        loss_err = max(abs(a - b) / abs(b) for x in runs
                       for a, b in zip(x["losses"], one["losses"]))
        g_err = [x["grad_rel_err"] for x in runs]
        g_tol = TOL_MX_GRAD_RESHAPED if key in ("a", "a_fce", "c", "e") \
            else TOL_MX_GRAD
        alt = MX_ALT.get(key)
        entry = {"losses": runs[0]["losses"],
                 "one_process_losses": one["losses"],
                 "loss_max_rel_err": loss_err, "grad_rel_err": g_err,
                 "grad_tol": g_tol,
                 # the cause of the gap: the one-process run split as
                 # the ranks split their work, against the plain one
                 # and against the ranks
                 "alt": alt,
                 "alt_vs_plain": None if alt is None else
                 one[f"{alt}_vs_plain"],
                 "grad_rel_err_alt": [x["grad_rel_err_alt"] for x in runs],
                 "worst_grads": runs[0]["worst_grads"],
                 "step_ms": {r: x["step_ms"] for r, x in enumerate(runs)},
                 "collective_ms": {r: x["collective_ms"]
                                   for r, x in enumerate(runs)},
                 "collectives_a_step": runs[0]["collectives"][-1],
                 "held_bytes": {r: x["held_bytes"]
                                for r, x in enumerate(runs)},
                 "flash_heads": runs[0]["flash_heads"],
                 "offset_launches": {r: x["offset_launches"]
                                     for r, x in enumerate(runs)},
                 "launches": {r: x["launches"] for r, x in enumerate(runs)}}
        bad = [r for r, x in enumerate(runs) if x["plain"] or x["composed"]]
        if bad:
            raise AssertionError(f"6x {key}: ranks {bad} made plain or "
                                 f"composed calls")
        if loss_err > TOL_MX_LOSS or max(g_err) > g_tol:
            raise AssertionError(f"6x {key}: against one process: losses "
                                 f"{loss_err:.3e} (tol {TOL_MX_LOSS:g}), "
                                 f"step-1 gradients {g_err} (tol "
                                 f"{g_tol:g}; worst "
                                 f"{runs[0]['worst_grads']}; against "
                                 f"one process {alt}: "
                                 f"{entry['grad_rel_err_alt']})")
        if alt is not None and max(entry["grad_rel_err_alt"]) > TOL_MX_GRAD:
            raise AssertionError(
                f"6x {key}: step-1 gradients against one process {alt} "
                f"{entry['grad_rel_err_alt']} (tol {TOL_MX_GRAD:g}; "
                f"against plain {g_err})")
        if any(x["losses"] != runs[0]["losses"] for x in runs):
            raise AssertionError(f"6x {key}: the ranks' losses differ")
        if key in ("a", "a_fce", "c", "d", "e"):
            # the sharded weights (mp, ep), the pipelined layers' (pp):
            # each rank holds half of their bytes
            for r, x in enumerate(runs):
                mine, total = x["held_bytes"]
                if not (total and 2 * mine == total):
                    raise AssertionError(f"6x {key} rank {r}: holds "
                                         f"{mine} of {total} bytes")
        if key in ("a", "a_fce", "e") and runs[0]["flash_heads"] != [
                TRAIN_ARCH["n_head"] // 2]:
            raise AssertionError(f"6x {key}: flash launches on heads "
                                 f"{runs[0]['flash_heads']}, want "
                                 f"{TRAIN_ARCH['n_head'] // 2}")
        want_counts = _mx_want_counts(key)
        if want_counts is not None:
            for r, x in enumerate(runs):
                got = x["collectives"][-1]
                if ({k: got.get(k, 0) for k in want_counts} != want_counts
                        or got.get("all_gather", 0)):
                    raise AssertionError(
                        f"6x {key} rank {r}: collectives a step {got}, "
                        f"want {want_counts} and no forward all_gather")
        if key == "b_ring" and not runs[1]["offset_launches"]:
            raise AssertionError("6x (b) ring: no flash launch with an "
                                 "offset")
        if key == "d":
            got = [sum(x) for x in zip(*(y["drops"] for y in runs))]
            entry["dropped_choices"] = {"ranks_summed": got,
                                        "one_process": one["drops"]}
            if got != one["drops"]:
                raise AssertionError(f"6x (d): dropped choices {got} "
                                     f"against one process's "
                                     f"{one['drops']}")
        for x in runs:
            for k, v in x["launches"].items():
                launches[k] = launches.get(k, 0) + v
        summary["parts"][key] = entry
        log(f"  ({key}) losses {entry['losses']} against one process "
            f"{one['losses']} (max rel {loss_err:.3e}); step-1 gradients "
            f"rel L2 {[f'{e:.3e}' for e in g_err]} (tol {g_tol:g}; worst "
            f"{entry['worst_grads']})"
            + ("" if alt is None else
               f"; one process {alt} against plain "
               f"{entry['alt_vs_plain']:.3e}, ranks against one process "
               f"{alt} {[f'{e:.3e}' for e in entry['grad_rel_err_alt']]}")
            + f"; step ms "
            f"{ {r: [round(v, 1) for v in s] for r, s in entry['step_ms'].items()} }"
            f"; collective ms {entry['collective_ms']}; collectives a "
            f"step {entry['collectives_a_step']}; bytes held (mine, of) "
            f"{entry['held_bytes']}; flash heads {entry['flash_heads']}; "
            f"offset launches {entry['offset_launches']} ({DP_LABEL}; "
            f"{card})")
    summary["launches"] = launches
    return summary


# -- phase 6y: the cost, memory and trace planes ----------------------------

# Each limit sits between the sound reading and what a planted fault
# reads, both taken in every run (PERF §6 has them):
# [unattributed] device time of a profiled bench step, what runs outside
# every op range (the feeds' copies, the loss's seed gradient): at most
# this share of the busy time.  Planted: the autograd engine's node
# events not read, so its gradient-buffer adds fall outside every op
TOL_UNATTRIBUTED = 0.005
# the op table's rows against phase 6's own profile of the same steps
# (the op ranges and node hooks cost host time, not device time).
# Planted: the optimizer's rows dropped
TOL_BUSY_SHARE = 0.02
# the ledger's peak against the caching allocator's for one step: blocks
# rounded up, cuBLAS workspaces no aten op returns on one side, storages
# the allocator reuses before Python drops them on the other.  Planted:
# the storages the backward makes left out of the ledger
TOL_LEDGER_GAP = 1e-3
# 6y (d): the refused ServingEngine's budget, a share of the ladder's
# largest prediction
REFUSE_SHARE = 0.95
COST_CPU_BATCH = 2          # 6y (b): card against CPU at 2+2 layers
COST_LSTM_BATCH = 8         # 6y (e): 6e's stacked LSTM, card and CPU
DECODE_HUGE_PAGES = 1 << 20  # 6y (d): 4 layers' bf16 K/V, 137 GB


def _flash_flops(program, batch, arch):
    """Registry flops of the flash ops of one step (forward and
    backward), every one self-attention at T = max_length."""
    from paddle_tpu_torch.ops import kernels

    nh = batch * arch["n_head"]
    t, d = arch["max_length"], arch["d_model"] // arch["n_head"]
    one = sum(kernels.KERNEL_COSTS[k](nh, t, t, d) for k in (
        "flash_attention_fwd", "flash_attention_bwd_dkv",
        "flash_attention_bwd_dq"))
    return _flash_ops(program) * one


def _op_flops(rows):
    out = {}
    for r in rows:
        out[r["op_type"]] = out.get(r["op_type"], 0.0) + r["flops"]
    return out


def _profiled(steps, run, prof_dir):
    """`steps` calls of `run()` under fluid.profiler, the trace under
    `prof_dir`."""
    import paddle_tpu_torch as pt

    with pt.profiler.profiler("All", None, prof_dir):
        for _ in range(steps):
            run()


def _planted(label, sound, planted, limit):
    """A check's sound reading against the limit and a planted fault's
    reading beyond it (the check can see that fault)."""
    log(f"  {label}: {sound:.3e} (limit {limit:g}; planted fault "
        f"{planted:.3e})")
    if not sound <= limit < planted:
        raise AssertionError(f"6y {label}: sound {sound}, planted "
                             f"{planted}, limit {limit}")
    return {"sound": sound, "planted": planted, "limit": limit}


def _cost_table(exe, main, feed, loss, scope, prof_dir, label):
    """op_cost_table joined to the trace under `prof_dir`: every row at
    most the card's peak, rows printed."""
    import paddle_tpu_torch as pt

    rows = pt.observe.op_cost_table(main, feed=feed, fetch_list=[loss],
                                    scope=scope, exe=exe,
                                    profile_dir=prof_dir)
    over = [r for r in rows if (r["achieved_flops_frac"] or 0) > 1.0]
    if over:
        raise AssertionError(f"6y (b) {label}: rows above the peak {over}")
    log(f"  {label}: op_cost_table, top rows:")
    for line in pt.observe.format_cost_table(rows, top=8).splitlines()[1:]:
        log(f"    {line}")
    return rows


def phase_cost_planes(dev, card):
    """6y: the cost, memory and trace planes on the card.  (a) the bench
    Transformer: two steps under `fluid.profiler.profiler`, the per-op
    table's top rows; every flash kernel's device time, forward and
    backward, on a `flash_attention` row, `[unattributed]` under
    TOL_UNATTRIBUTED of the busy time, the rows' total within
    TOL_BUSY_SHARE of phase 6's own profile of the same program, each
    limit below what a planted fault reads (`_planted`); (b)
    `op_cost_table(profile_dir=...)` of one profiled step, unfused and
    fused CE: the flash and fused-CE ops carry the registry's flops
    exactly, no row above the card's peak; `program_costs`' step flops
    and MFU; card and CPU per-op flops equal at 2+2 layers and batch 2;
    (c) `memory_report` of (a)'s step: the ledger's peak against the
    allocator's (TOL_LEDGER_GAP, against a ledger without the
    backward's storages); `plan_fit` at batch 64 from probes (2, 4)
    within PLAN_FIT_REL_TOL of the allocator's peak at 64; the scope,
    its run counter and the kernel counts as they were; (d) 4f's
    ResNet-50 ladder fits the card's budget, its largest bucket's
    prediction within PLAN_FIT_REL_TOL of that bucket measured as the
    gate probes, a budget of REFUSE_SHARE of that prediction raises
    BucketMemoryError before warmup; phase 4's DecoderLM
    geometry passes the DecodeEngine's gate, a pool past the card's
    memory raises DecodeMemoryError with no pool allocated; (e) 6e's
    stacked LSTM: each dynamic_lstm row carries the registry's
    lstm_fwd_cost + lstm_bwd_cost over T steps, on the card and the
    CPU.  The counts are zeroed before (a) and read after (e)."""
    import shutil

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import stacked_dynamic_lstm, transformer
    import types
    from unittest import mock

    from paddle_tpu_torch.observe import trace
    from paddle_tpu_torch.observe.memory import PLAN_FIT_REL_TOL, ledger_peak
    from paddle_tpu_torch.ops import kernels

    root = os.path.abspath(os.path.join(OUT_DIR, "cost_6y"))
    shutil.rmtree(root, ignore_errors=True)
    peak_flops, _bw = pt.observe.device_peaks()
    log(f"phase 6y: the cost, memory and trace planes on {card} (peak "
        f"{peak_flops:.3g} FLOP/s bf16 dense)")
    res, marks = {}, [("start", time.perf_counter())]
    torch.cuda.empty_cache()
    kernels.reset_counts()
    # (a) the bench Transformer under the profiler
    main, startup, model = build_training()
    loss = model["loss"]
    scope = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = {n: torch.as_tensor(a).to(dev) for n, a in
            transformer.make_fake_batch(
                TRAIN_BATCH, TRAIN_ARCH["max_length"],
                TRAIN_ARCH["src_vocab_size"],
                TRAIN_ARCH["trg_vocab_size"]).items()}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 3
    plain = _profile_train_step(exe, main, feed, loss, scope,
                                label="  6y (a) phase 6's profile")
    prof_dir = os.path.join(root, "a")

    def step():
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)

    t0 = time.perf_counter()
    _profiled(2, step, prof_dir)
    prof_s = time.perf_counter() - t0
    rows = pt.profiler.profile_table(prof_dir)
    total = sum(r["total_ms"] for r in rows) / 2
    unattr = sum(r["total_ms"] for r in rows
                 if r["op_type"] == "[unattributed]") / 2
    log(f"  6y (a): two profiled steps in {prof_s:.2f} s; op table "
        f"{total:.3f} ms a step against phase 6's busy "
        f"{plain['device_busy_ms_per_step']:.3f} ms; [unattributed] "
        f"{unattr:.3f} ms")
    for r in rows[:10]:
        log(f"    {r['op_type']:<28}{r['calls']:>7}{r['total_ms']:>11.3f} "
            f"ms {r['ratio']:>7.1%}")
    flash = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    stray, loose = [], {}
    for name, label, ms, _card in trace.device_events(prof_dir):
        if label is None:
            loose[name[:60]] = loose.get(name[:60], 0.0) + ms / 2
        for k, kern in (("fwd", "flash_fwd_kernel"),
                        ("dkv", "flash_bwd_dkv_kernel"),
                        ("dq", "flash_bwd_dq_kernel")):
            if kern in name:
                flash[k] += ms
                if trace.fluid_op_of(label or "") != "flash_attention":
                    stray.append((name, label))
    loose = sorted(loose.items(), key=lambda kv: -kv[1])[:5]
    log(f"  [unattributed] kernels, ms a step: "
        f"{[(k, round(v, 3)) for k, v in loose]}")
    busy = plain["device_busy_ms_per_step"]
    res["a"] = {"unattributed_top": loose, "op_table_ms_per_step": total, "busy_ms_per_step": busy,
                "unattributed_ms_per_step": unattr,
                "flash_ms_per_step": {k: v / 2 for k, v in flash.items()},
                "top_rows": rows[:10], "profiled_s": prof_s}
    log(f"  flash kernels on flash_attention rows: fwd "
        f"{flash['fwd'] / 2:.3f}, dK/dV {flash['dkv'] / 2:.3f}, dQ "
        f"{flash['dq'] / 2:.3f} ms a step")
    if stray or not all(flash.values()):
        raise AssertionError(f"6y (a): flash kernels off flash_attention "
                             f"rows {stray[:4]} or missing {flash}")
    with mock.patch.object(trace, "_node_ranges", lambda *a: None):
        planted = sum(r["total_ms"] for r in pt.profiler.profile_table(
            prof_dir) if r["op_type"] == "[unattributed]") / 2
    adam = sum(r["total_ms"] for r in rows if r["op_type"] == "adam") / 2
    res["a"]["limits"] = {
        "unattributed_share": _planted(
            "(a) [unattributed] share of the busy time", unattr / busy,
            planted / busy, TOL_UNATTRIBUTED),
        "busy_share": _planted(
            "(a) op table against the busy time",
            abs(total - busy) / busy, abs(total - adam - busy) / busy,
            TOL_BUSY_SHARE)}
    marks.append(("a", time.perf_counter()))
    # (b) the cost table of the same step, and (c) its memory
    _profiled(1, step, os.path.join(root, "b"))
    before = {n: v.clone() for n, v in scope.vars.items()
              if isinstance(v, torch.Tensor)}
    counter = scope.find_var("__rng_key__")
    counts = kernels.counts()
    t0 = time.perf_counter()
    cost_rows = _cost_table(exe, main, feed, loss, scope,
                            os.path.join(root, "b"), "6y (b)")
    ops = _op_flops(cost_rows)
    want = _flash_flops(main, TRAIN_BATCH, TRAIN_ARCH)
    if ops["flash_attention"] != want:
        raise AssertionError(f"6y (b): flash_attention {ops} against the "
                             f"registry's {want}")
    tot = pt.observe.program_costs(main, feed=feed, fetch_list=[loss],
                                   scope=scope, exe=exe)
    mfu = tot["flops"] / (step_ms / 1e3) / peak_flops
    rep = pt.observe.memory_report(main, feed=feed, fetch_list=[loss],
                                   scope=scope, exe=exe)
    ledger, alloc = rep["peak_bytes"], rep["allocator_peak_bytes"]
    gap = (alloc - ledger) / alloc
    # the same (memoized) record, the backward's storages left out
    rec = exe.compiled_step(main, feed=feed, fetch_list=[loss], scope=scope)
    no_grads = types.SimpleNamespace(allocs=[
        a for a in rec.allocs if a["phase"] != "backward"])
    planted_gap = (alloc - ledger_peak(no_grads)[0]) / alloc
    plan = pt.observe.plan_fit(main, feed, fetch_list=[loss], scope=scope,
                               exe=exe)
    plan_err = (plan["predicted_peak_bytes"] - alloc) / alloc
    res["b"] = {"flops": tot["flops"], "kernel_flops": tot["kernel_flops"],
                "bytes": tot["bytes"], "mfu_bf16_peak": mfu,
                "step_ms": step_ms,
                "profiled_step_ms": plain["profiled_step_ms"],
                "flash_flops": ops["flash_attention"],
                "rows": cost_rows[:12]}
    res["c"] = {"ledger_peak_bytes": ledger, "allocator_peak_bytes": alloc,
                "gap": gap, "breakdown": rep["breakdown"],
                "limits": {"ledger_gap": _planted(
                    "(c) ledger against the allocator", abs(gap),
                    abs(planted_gap), TOL_LEDGER_GAP)},
                "plan": {k: plan[k] for k in (
                    "predicted_peak_bytes", "probe_batches", "probe_peaks",
                    "per_example_bytes", "breakdown", "fits",
                    "budget_bytes")},
                "plan_rel_err": plan_err}
    log(f"  6y (b): program_costs {tot['flops'] / 1e12:.4f} TFLOP a step "
        f"({tot['kernel_flops'] / 1e12:.4f} in the hand-written kernels), "
        f"{tot['bytes'] / 1e9:.2f} GB; MFU {mfu:.4f} of the bf16 dense "
        f"peak at the unprofiled step {step_ms:.2f} ms; flash_attention "
        f"{ops['flash_attention']:.6g} flops = the registry's")
    log(f"  6y (c): ledger peak {ledger / 1e9:.3f} GB, allocator "
        f"{alloc / 1e9:.3f} GB (gap {gap:.4f}); plan_fit at batch "
        f"{plan['batch']} from probes {plan['probe_batches']}: "
        f"{plan['predicted_peak_bytes'] / 1e9:.3f} GB ({plan_err:+.4f} "
        f"against the allocator); breakdown {rep['breakdown']}")
    if abs(plan_err) > PLAN_FIT_REL_TOL:
        raise AssertionError(f"6y (c): allocator {alloc}, plan "
                             f"{plan['predicted_peak_bytes']}")
    changed = [n for n, v in before.items()
               if not torch.equal(scope.find_var(n), v)]
    if changed or scope.find_var("__rng_key__") != counter \
            or kernels.counts() != counts:
        raise AssertionError(f"6y (c): the planes moved the scope "
                             f"{changed[:4]}, the run counter or the counts")
    res["c"]["planes_s"] = time.perf_counter() - t0
    del before, scope, exe, feed
    torch.cuda.empty_cache()
    marks.append(("b, c", time.perf_counter()))
    # (b) fused CE
    main_f, startup_f, model_f = build_training(use_fused_ce=True)
    scope_f = pt.Scope()
    exe = pt.Executor(pt.CUDAPlace(0))
    exe.run(startup_f, scope=scope_f)
    feed = {n: torch.as_tensor(a).to(dev) for n, a in
            transformer.make_fake_batch(
                TRAIN_BATCH, TRAIN_ARCH["max_length"],
                TRAIN_ARCH["src_vocab_size"],
                TRAIN_ARCH["trg_vocab_size"]).items()}
    exe.run(main_f, feed=feed, fetch_list=[model_f["loss"]], scope=scope_f)
    prof_f = os.path.join(root, "b_fused")
    _profiled(1, lambda: exe.run(main_f, feed=feed,
                                 fetch_list=[model_f["loss"]],
                                 scope=scope_f), prof_f)
    rows_f = _cost_table(exe, main_f, feed, model_f["loss"], scope_f,
                         prof_f, "6y (b) fused CE")
    ce = [r for r in rows_f if r["op_type"] == "fused_vocab_softmax_ce"
          and r["bucket"] == "custom_call"]
    n_tok = TRAIN_BATCH * TRAIN_ARCH["max_length"]
    want_ce = _vocab_ops(main_f) * sum(
        kernels.KERNEL_COSTS[k](n_tok, TRAIN_ARCH["d_model"],
                                TRAIN_ARCH["trg_vocab_size"])
        for k in ("vocab_ce_fwd", "vocab_ce_dh", "vocab_ce_dw"))
    if len(ce) != 1 or ce[0]["flops"] != want_ce:
        raise AssertionError(f"6y (b): fused CE rows {ce}, registry "
                             f"{want_ce}")
    res["b"]["fused_ce_flops"] = ce[0]["flops"]
    del scope_f, exe, feed
    torch.cuda.empty_cache()
    marks.append(("b fused CE", time.perf_counter()))
    # (b) card against CPU at 2+2 layers
    main_c, startup_c, model_c = build_training(n_layer=CUT_LAYERS)
    scope_c = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup_c, scope=scope_c)
    cpu_scope = pt.Scope()
    for n, v in scope_c.vars.items():
        cpu_scope.set_var(n, v.cpu() if isinstance(v, torch.Tensor) else v)
    feed_np = transformer.make_fake_batch(
        COST_CPU_BATCH, TRAIN_ARCH["max_length"],
        TRAIN_ARCH["src_vocab_size"], TRAIN_ARCH["trg_vocab_size"])
    per_dev = {}
    for where, sc, place in (("card", scope_c, pt.CUDAPlace(0)),
                             ("cpu", cpu_scope, pt.CPUPlace())):
        per_dev[where] = _op_flops(pt.observe.op_cost_table(
            main_c, feed=feed_np, fetch_list=[model_c["loss"]], scope=sc,
            exe=pt.Executor(place)))
    differ = {k: (per_dev["card"].get(k), per_dev["cpu"].get(k))
              for k in set(per_dev["card"]) | set(per_dev["cpu"])
              if per_dev["card"].get(k) != per_dev["cpu"].get(k)}
    log(f"  6y (b): card against CPU at {CUT_LAYERS}+{CUT_LAYERS} layers, "
        f"batch {COST_CPU_BATCH}: {len(per_dev['card'])} op types, "
        f"{sum(per_dev['card'].values()):.6g} flops, differing {differ}")
    if differ:
        raise AssertionError(f"6y (b): card and CPU flops differ {differ}")
    res["b"]["card_vs_cpu_op_types"] = len(per_dev["card"])
    del scope_c, cpu_scope
    marks.append(("b card vs CPU", time.perf_counter()))
    # (d) the engines' gates on the card's budget
    res["d"] = _engine_gates(dev, card)
    marks.append(("d", time.perf_counter()))
    # (e) the stacked LSTM: one step on the card (its launches count),
    # then the cost table on the card and the CPU
    main_l, startup_l, model_l = build_lstm()
    scope_l = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup_l, scope=scope_l)
    cpu_l = pt.Scope()
    for n, v in scope_l.vars.items():
        cpu_l.set_var(n, v.cpu() if isinstance(v, torch.Tensor) else v)
    t_len = LSTM_ARCH["max_len"]
    feed_l = stacked_dynamic_lstm.make_fake_batch(
        COST_LSTM_BATCH, t_len, LSTM_ARCH["vocab_size"])
    pt.Executor(pt.CUDAPlace(0)).run(main_l, feed=feed_l,
                                     fetch_list=[model_l["loss"]],
                                     scope=scope_l)
    h = LSTM_ARCH["hidden_dim"]
    want_l = (kernels.KERNEL_COSTS["lstm_fwd"](t_len, COST_LSTM_BATCH, h)
              + kernels.KERNEL_COSTS["lstm_bwd"](t_len, COST_LSTM_BATCH, h))
    lstm = {}
    for where, sc, place in (("card", scope_l, pt.CUDAPlace(0)),
                             ("cpu", cpu_l, pt.CPUPlace())):
        rows_l = pt.observe.op_cost_table(
            main_l, feed=feed_l, fetch_list=[model_l["loss"]], scope=sc,
            exe=pt.Executor(place))
        lstm[where] = [r["flops"] for r in rows_l
                       if r["op_type"] == "dynamic_lstm"
                       and r["bucket"] == "custom_call"]
    n_lstm = sum(op.type == "dynamic_lstm"
                 for op in main_l.global_block().ops)
    log(f"  6y (e): dynamic_lstm rows card {lstm['card']}, CPU "
        f"{lstm['cpu']}; registry {n_lstm} x {want_l:.6g} (T = {t_len})")
    if lstm["card"] != lstm["cpu"] or lstm["card"] != [n_lstm * want_l]:
        raise AssertionError(f"6y (e): LSTM rows {lstm}, want "
                             f"{n_lstm} x {want_l}")
    res["e"] = {"dynamic_lstm_flops": lstm["card"][0], "T": t_len,
                "batch": COST_LSTM_BATCH}
    marks.append(("e", time.perf_counter()))
    res["seconds"] = {k: t - t0 for (_, t0), (k, t) in zip(marks,
                                                          marks[1:])}
    la = kernels.counts()["launches"]
    res["launches"] = la
    log(f"  6y launches { {k: v for k, v in la.items() if v} }; seconds "
        f"{ {k: round(v, 1) for k, v in res['seconds'].items()} }")
    shutil.rmtree(root, ignore_errors=True)
    return res


def _engine_gates(dev, card):
    """6y (d): the ServingEngine's and the DecodeEngine's memory gates on
    the card's own budget."""
    import shutil

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.decoder_lm import DecoderLM
    from paddle_tpu_torch.observe import device_memory_budget
    from paddle_tpu_torch.observe.memory import PLAN_FIT_REL_TOL, record_peak
    from paddle_tpu_torch.serving import (BucketConfig, BucketMemoryError,
                                          DecodeConfig, DecodeEngine,
                                          DecodeMemoryError, ServingEngine)

    budget = device_memory_budget(dev)
    d = os.path.join(OUT_DIR, "cost_6y_resnet")
    shutil.rmtree(d, ignore_errors=True)
    _resnet_inference_dir(d)
    example = {"data": np.zeros((3, 224, 224), np.float32)}
    eng = ServingEngine(pt.AnalysisConfig(d), example,
                        buckets=BucketConfig((1, SERVE_BATCH))).start()
    plan = eng.fit_plan
    top = plan["buckets"][-1]["predicted_peak_bytes"]
    # the largest bucket measured as the gate probes (one run unrecorded,
    # then one recorded)
    measured = record_peak(eng._probe(eng._spec_for(SERVE_BATCH, None)))
    eng.close()
    top_err = (top - measured) / measured
    if plan.get("budget_bytes") != budget \
            or not all(b["fits"] for b in plan["buckets"]) \
            or abs(top_err) > PLAN_FIT_REL_TOL:
        raise AssertionError(f"6y (d): ResNet-50 ladder plan {plan}, "
                             f"batch {SERVE_BATCH} measured {measured}")
    try:
        ServingEngine(pt.AnalysisConfig(d), example,
                      buckets=BucketConfig((1, SERVE_BATCH)),
                      memory_budget_bytes=int(REFUSE_SHARE * top)).start()
        raise AssertionError("6y (d): a budget below the ladder passed")
    except BucketMemoryError as e:
        refused = e.as_dict()
    shutil.rmtree(d, ignore_errors=True)
    lm = DecoderLM(kv_dtype="bfloat16", prefill_pallas=True, **ARCH)
    eng = DecodeEngine(lm, DecodeConfig(kv_dtype="bfloat16", **SERVE),
                       place=pt.CUDAPlace(0)).start()
    dplan = eng.fit_plan
    eng.close()
    if not dplan.get("fits") or dplan["budget_bytes"] != budget:
        raise AssertionError(f"6y (d): phase 4's geometry {dplan}")
    huge = dict(SERVE, num_pages=DECODE_HUGE_PAGES)
    pool = sum(int(np.prod(shape)) * 2 for shape, _ in
               lm.pool_specs(DECODE_HUGE_PAGES, SERVE["page_size"])
               .values())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    try:
        DecodeEngine(lm, DecodeConfig(kv_dtype="bfloat16", **huge),
                     place=pt.CUDAPlace(0)).start()
        raise AssertionError("6y (d): a pool past the card passed")
    except DecodeMemoryError as e:
        dref = e.as_dict()
    grew = torch.cuda.memory_allocated(dev) - held
    log(f"  6y (d): budget {budget / 1e9:.3f} GB; ResNet-50 ladder "
        f"{[(b['batch_size'], round(b['predicted_peak_bytes'] / 1e9, 3)) for b in plan['buckets']]}"
        f" GB fits (batch {SERVE_BATCH} measured {measured / 1e9:.3f} GB, "
        f"prediction {top_err:+.4f}), refused at "
        f"{refused['budget_bytes'] / 1e9:.3f} GB; "
        f"DecodeEngine {SERVE['num_pages']} pages predicted "
        f"{dplan['predicted_peak_bytes'] / 1e9:.3f} GB, "
        f"{DECODE_HUGE_PAGES} pages ({pool / 1e9:.1f} GB of pool) "
        f"predicted {dref['plan']['predicted_peak_bytes'] / 1e9:.1f} GB, "
        f"refused with {grew} bytes allocated meanwhile")
    if grew >= pool // 100:
        raise AssertionError(f"6y (d): {grew} bytes allocated by a "
                             f"refused pool of {pool}")
    return {"budget_bytes": budget, "resnet_plan": plan["buckets"],
            "resnet_top_measured": measured, "resnet_top_rel_err": top_err,
            "resnet_refused_at": refused["budget_bytes"],
            "decode_plan": {k: dplan[k] for k in (
                "predicted_peak_bytes", "probe_peaks", "fits")},
            "decode_refused_predicted": dref["plan"]["predicted_peak_bytes"],
            "decode_refused_pool_bytes": pool, "allocated_meanwhile": grew}


# -- phase 6z: the health plane, the gang supervisor and the autopilot ----

# (a) the reference's autopilot geometry (tests/test_autopilot.py:84-150)
AUTOPILOT_BATCHES = 12
AUTOPILOT_POISON_AT = 5
AUTOPILOT_WINDOW = {"from_epoch": 0, "from_step": 4, "to_epoch": 0,
                    "to_step": 6}
PLANE_COST_STEPS = 3       # (c): steps with the plane off, then on
# (b) the supervised gang: two ranks on the card, each its own Trainer
GANG_BATCHES = 12
GANG_CKPT_EVERY = 3        # each rank's checkpoint cadence, in steps
GANG_KILL_RANK = 1
GANG_KILL_AT = 8           # rank 1 dies once its step 8 is done (its
#                            serial of step 3 written, step 6's maybe not)
GANG_INTERVAL_S = 0.25     # heartbeat interval ...
GANG_MISS_BUDGET = 4       # ... and misses: a 1 s miss window
GANG_PACE_S = 0.3          # each step's handler held, so the loss lands
#                            while the survivor still trains
GANG_TIMEOUT_S = 420


def health_funcs():
    """(train_func, optimizer_func) of the float32 fused-CE bench
    Transformer at CUT_LAYERS + CUT_LAYERS layers (dropout 0.1): Adam
    under noam x 2.0, as build_guarded without AMP."""
    from paddle_tpu_torch import layers, optimizer
    from paddle_tpu_torch.models import transformer

    arch = dict(TRAIN_ARCH, use_fused_ce=True, n_layer=CUT_LAYERS)

    def train_func():
        return transformer.build_model(**arch, with_optimizer=False)["loss"]

    def optimizer_func():
        lr = layers.elementwise_mul(
            layers.noam_decay(arch["d_model"], 4000),
            layers.fill_constant([1], "float32", 2.0))
        return optimizer.AdamOptimizer(learning_rate=lr, beta1=0.9,
                                       beta2=0.997, epsilon=1e-9)

    return train_func, optimizer_func


def health_batches(n, seed, poison_at=None):
    """n seeded batches (host numpy, phase 6's feed shape); the one at
    `poison_at` has a source id equal to the vocabulary size (a NaN row
    through the lookup, ROADMAP C3)."""
    from paddle_tpu_torch.models import transformer

    v = TRAIN_ARCH["trg_vocab_size"]
    out = [transformer.make_fake_batch(TRAIN_BATCH, TRAIN_ARCH["max_length"],
                                       v, v, seed=seed + i)
           for i in range(n)]
    if poison_at is not None:
        out[poison_at]["src_word"][0, 0] = v
    return out


def health_trainer(run_dir, rank=0, autopilot=None, telemetry=True,
                   checkpoints=True, step_interval=2):
    """contrib.Trainer of health_funcs on cuda:0 with the update guard:
    async checkpoints every `step_interval` steps under
    run_dir/ck/rank<rank> (no epoch-end save), telemetry every step into
    run_dir/events.jsonl."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import observe, resilience
    from paddle_tpu_torch.contrib import CheckpointConfig, Trainer

    train_func, optimizer_func = health_funcs()
    t = Trainer(
        train_func, optimizer_func, place=pt.CUDAPlace(0),
        checkpoint_config=(CheckpointConfig(
            os.path.join(run_dir, "ck", f"rank{rank}"),
            step_interval=step_interval,
            epoch_interval=10 ** 6, max_num_checkpoints=3,
            async_save=True) if checkpoints else None),
        telemetry=(observe.TelemetryConfig(
            interval=1, log_path=os.path.join(run_dir, "events.jsonl"))
            if telemetry else None),
        autopilot=autopilot)
    resilience.enable_update_guard(t.train_program)
    return t


def _digests(trainer):
    """{persistable: sha256 of its bytes} — bit-for-bit identity."""
    import hashlib

    out = {}
    for v in trainer.train_program.list_vars():
        if v.persistable:
            val = trainer.scope.find_var(v.name)
            out[v.name] = hashlib.sha256(
                val.detach().cpu().contiguous().numpy().tobytes()
            ).hexdigest()
    return out


def _store_on_this_torch():
    """C24 on the running torch: a client of a store whose host
    process was killed — each call's exception type must be one the
    health plane catches (health.STORE_ERRORS) — and whether the store
    has `clone` and `list_keys`."""
    from datetime import timedelta

    import torch.distributed as dist

    from paddle_tpu_torch.resilience.health import STORE_ERRORS

    code = ("import time, torch.distributed as d\n"
            "s = d.TCPStore('127.0.0.1', 0, 1, is_master=True, "
            "wait_for_workers=False)\n"
            "print(s.port, flush=True)\n"
            "time.sleep(120)\n")
    host = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, text=True)
    try:
        store = dist.TCPStore("127.0.0.1", int(host.stdout.readline()),
                              is_master=False,
                              timeout=timedelta(seconds=5))
        store.set("k", "1")
        conn = store.clone()
        host.kill()
        host.wait()
        raised = {}
        for name, call in (("check", lambda: conn.check(["k"])),
                           ("get", lambda: conn.get("k")),
                           ("set", lambda: conn.set("k", "2")),
                           ("wait", lambda: conn.wait(
                               ["x"], timedelta(seconds=1)))):
            try:
                call()
                raised[name] = None
            except Exception as e:  # noqa: BLE001 — recorded and checked
                raised[name] = (type(e).__name__,
                                isinstance(e, STORE_ERRORS))
    finally:
        if host.poll() is None:
            host.kill()
            host.wait()
    res = {"torch": torch.__version__, "raised": raised,
           "clone": hasattr(dist.TCPStore, "clone"),
           "list_keys": hasattr(dist.TCPStore, "list_keys")}
    log(f"  store on torch {torch.__version__}, its host killed: {raised}; "
        f"clone {res['clone']}, list_keys {res['list_keys']}")
    if not all(r is not None and r[1] for r in raised.values()):
        raise AssertionError(f"6z: a dead store's errors escape "
                             f"STORE_ERRORS: {raised}")
    return res


def _plane_cost(dev, run_dir):
    """(c): the same Trainer's steps with the health plane off, then on
    (a plane over chaos.FakeKv with its heartbeat and monitor threads
    running): the same kernel launches and the same host
    synchronizations a step."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.resilience import FakeKv, HealthConfig, health

    t = health_trainer(run_dir, telemetry=False, checkpoints=False)
    batches = health_batches(2 + 2 * PLANE_COST_STEPS, 500)
    t.train(num_epochs=1, reader=lambda: iter(batches[:2]))  # warm
    res = {}
    for label in ("off", "on"):
        if label == "on":
            health.start_health_plane(rank=0, num_ranks=2, kv=FakeKv(),
                                      config=HealthConfig(
                                          interval_s=0.05, miss_budget=10 ** 6,
                                          startup_grace_s=10 ** 9))
        lo = 2 + PLANE_COST_STEPS * (label == "on")
        part = batches[lo:lo + PLANE_COST_STEPS]
        torch.cuda.synchronize()
        kernels.reset_counts()
        syncs = _sync_warnings(lambda: t.train(
            num_epochs=1, reader=lambda: iter(part)))
        counts = _check_launches(f"6z (c) plane {label}", t.train_program,
                                 PLANE_COST_STEPS)
        res[label] = {"syncs": len(syncs), "sync_lines": sorted(set(syncs)),
                      "launches": counts["launches"]}
    beats = health.get_health_plane().heartbeat._step
    health.stop_health_plane()
    t.stop()
    if (res["on"]["syncs"] != res["off"]["syncs"]
            or res["on"]["sync_lines"] != res["off"]["sync_lines"]
            or res["on"]["launches"] != res["off"]["launches"]):
        raise AssertionError(f"6z (c): the plane changed the step: {res}")
    if beats != PLANE_COST_STEPS:
        raise AssertionError(f"6z (c): heartbeat counter {beats}")
    log(f"  (c) plane off/on: {res['off']['syncs']} host syncs over "
        f"{PLANE_COST_STEPS} steps both ways "
        f"({res['off']['sync_lines']}), the same launches")
    res["launches"] = {k: res["off"]["launches"][k] + res["on"]["launches"][k]
                       for k in res["off"]["launches"]}
    return res


def _autopilot_on_card(dev, run_dir):
    """(a): the autopilot run against the control, on the card."""
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.resilience import AutopilotConfig

    batches = health_batches(AUTOPILOT_BATCHES, 300,
                             poison_at=AUTOPILOT_POISON_AT)
    kernels.reset_counts()
    t0 = time.perf_counter()
    t = health_trainer(os.path.join(run_dir, "auto"),
                       autopilot=AutopilotConfig(skip_streak=1,
                                                 loss_spike_z=None,
                                                 grad_norm_z=None))
    t.train(num_epochs=1, reader=lambda: iter(batches))
    auto_s = time.perf_counter() - t0
    counts = _check_launches("6z (a) autopilot", t.train_program,
                             AUTOPILOT_BATCHES)
    got = _digests(t)
    snap = t.autopilot.snapshot()
    windows = t.autopilot.quarantine_windows
    rep = t.goodput()
    reg = t.metrics_registry().snapshot()
    t.stop()
    events = observe.read_events(os.path.join(run_dir, "auto",
                                              "events.jsonl"))
    kinds = [e["event"] for e in events]
    rb = [e for e in events if e["event"] == "recovery_rollback"]

    kernels.reset_counts()
    skip = {AUTOPILOT_WINDOW["from_step"], AUTOPILOT_POISON_AT}
    clean = [b for i, b in enumerate(batches) if i not in skip]
    ctl = health_trainer(os.path.join(run_dir, "ctl"), checkpoints=False)
    ctl.train(num_epochs=1, reader=lambda: iter(clean))
    ctl_counts = _check_launches("6z (a) control", ctl.train_program,
                                 len(clean))
    want = _digests(ctl)
    ctl.stop()
    differ = sorted(k for k in want if got.get(k) != want[k])
    checks = {
        "bit_identical": not differ and set(got) == set(want),
        "one_rollback_to_serial_1": (snap["rollbacks"] == 1 and len(rb) == 1
                                     and rb[0]["serial"] == 1),
        "window": windows == [AUTOPILOT_WINDOW],
        "quarantined_2": snap["quarantined_batches"] == 2,
        "no_halt": snap["halted"] == 0 and "recovery_halt" not in kinds,
        "rollback_before_quarantine": ("recovery_rollback" in kinds
                                       and "data_quarantine" in kinds
                                       and kinds.index("recovery_rollback")
                                       < kinds.index("data_quarantine")),
        "goodput_recovery": rep["categories_s"].get("recovery", 0) > 0,
        "registry": (reg["recovery_autopilot_enabled"]["samples"][0]["value"]
                     == 1 and reg["recovery_rollbacks_total"]["samples"][0]
                     ["value"] == 1),
    }
    log(f"  (a) autopilot: {AUTOPILOT_BATCHES} batches, batch "
        f"{AUTOPILOT_POISON_AT} poisoned, rolled back to serial "
        f"{rb[0]['serial'] if rb else None}, window {windows}, "
        f"quarantined {snap['quarantined_batches']}, {auto_s:.1f} s; "
        f"recovery {rep['categories_s'].get('recovery', 0):.3f} s of "
        f"{rep['wall_s']:.1f} s; persistables differing from the "
        f"control: {len(differ)} of {len(want)}")
    if not all(checks.values()):
        raise AssertionError(f"6z (a): {checks}; differing {differ[:8]}")
    launches = {k: counts["launches"][k] + ctl_counts["launches"][k]
                for k in counts["launches"]}
    return {"checks": checks, "snapshot": snap, "windows": windows,
            "goodput": rep, "wall_s": auto_s, "launches": launches}


def _gang_worker_cmd(run_dir):
    return [sys.executable, os.path.abspath(__file__), "--gang-worker",
            run_dir]


def gang_worker(argv) -> int:
    """One 6z (b) rank, `chip_smoke.py --gang-worker DIR`, launched by the
    Supervisor with the PADDLE_* env: `init_distributed(backend="gloo")`
    (two ranks on one card; it starts the health plane), a health_trainer
    on the rank's own batches with checkpoints every GANG_CKPT_EVERY
    steps under DIR/ck/rank<r>;
    prints "STEP <epoch> <step> <unix time>" after each step (then
    `chaos.kill_rank` and GANG_PACE_S), "PEER_LOST <json>" and exit 43 on
    a gang error, else the done-rendezvous and "DONE".  Writes
    DIR/out/rank<r>.<pid>.json: steps, resume cursor, launches against
    their want, goodput, and (done) the persistables' digests."""
    from paddle_tpu_torch.contrib import EndStepEvent
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.parallel import init_distributed
    from paddle_tpu_torch.resilience import (PEER_LOST_EXIT_CODE,
                                             CheckpointBarrierPoisonedError,
                                             GangError, chaos, health)

    run_dir = argv[0]
    t_spawned = time.time()
    _set_matmul_flags()
    _build.build()
    rank, _ = init_distributed(backend="gloo")
    plane = health.get_health_plane()
    trainer = health_trainer(run_dir, rank=rank, telemetry=False,
                             step_interval=GANG_CKPT_EVERY)
    batches = health_batches(GANG_BATCHES, 700 + 100 * rank)
    # the cursor of the newest serial listed (its trainer state written
    # last): the one a relaunch must resume from
    newest = [0, 0]
    listed = trainer._list_checkpoints()
    if listed:
        with open(os.path.join(trainer._ckpt_root(), f"ckpt_{listed[-1]}",
                               "__trainer_state__.json")) as f:
            st = json.load(f)
        newest = [st["epoch"], st["step"]]
    res = {"rank": rank, "pid": os.getpid(), "t_spawned": t_spawned,
           "resume": [trainer._resume_epoch, trainer._resume_step_in_epoch],
           "newest_listed": newest, "steps": []}
    kernels.reset_counts()

    def handler(e):
        if isinstance(e, EndStepEvent):
            now = time.time()
            res["steps"].append([e.epoch, e.step, now])
            print(f"STEP {e.epoch} {e.step} {now:.6f}", flush=True)
            chaos.kill_rank(rank, e.epoch * GANG_BATCHES + e.step)
            time.sleep(GANG_PACE_S)

    def finish(rc, lost=None):
        res.update(rc=rc, counts=kernels.counts(),
                   want=_want_launches(trainer.train_program,
                                       len(res["steps"])),
                   goodput=trainer.goodput())
        if lost is not None:
            res["peer_lost"] = lost
        path = os.path.join(run_dir, "out", f"rank{rank}.{os.getpid()}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(res, f, default=str)
        sys.stdout.flush()
        os._exit(rc)  # no teardown: a peer may be gone

    def lost(e, at):
        payload = dict(e.as_dict(), rank=rank, at=at,
                       alarm_wall_time=plane.monitor.alarm_wall_time)
        print("PEER_LOST " + json.dumps(payload, default=str), flush=True)
        finish(PEER_LOST_EXIT_CODE, payload)

    try:
        trainer.train(num_epochs=1, reader=lambda: iter(batches),
                      event_handler=handler)
    except (GangError, CheckpointBarrierPoisonedError) as e:
        lost(e, "train")
    res["digests"] = _digests(trainer)
    plane.leave()
    if not plane.wait_gang_done(timeout_s=60.0):
        try:
            plane.check()
        except (GangError, CheckpointBarrierPoisonedError) as e:
            lost(e, "done_wait")
    print("DONE", flush=True)
    finish(0)
    return 0


def _gang_on_card(dev, run_dir):
    """(b): the supervised gang with a SIGKILL, against each rank's
    Trainer run uninterrupted in this process (the control)."""
    import shutil

    from paddle_tpu_torch import observe
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.resilience import Supervisor, chaos, classify_exit

    control, launches = {}, None
    for rank in (0, 1):
        kernels.reset_counts()
        t = health_trainer(run_dir, rank=rank, telemetry=False,
                           checkpoints=False)
        batches = health_batches(GANG_BATCHES, 700 + 100 * rank)
        t.train(num_epochs=1, reader=lambda: iter(batches))
        counts = _check_launches(f"6z (b) control rank {rank}",
                                 t.train_program, GANG_BATCHES)["launches"]
        launches = counts if launches is None else {
            k: launches[k] + counts[k] for k in counts}
        control[rank] = _digests(t)
        t.stop()
    torch.cuda.empty_cache()
    env = {"FLAGS_heartbeat_interval_s": str(GANG_INTERVAL_S),
           "FLAGS_heartbeat_miss_budget": str(GANG_MISS_BUDGET),
           "KINETO_LOG_LEVEL": "2"}
    chaos.arm_kill_rank_env(env, rank=GANG_KILL_RANK, at_step=GANG_KILL_AT,
                            once_file=os.path.join(run_dir, "killed.flag"))
    gang_dir = os.path.join(run_dir, "gang")
    log_path = os.path.join(run_dir, "supervisor.jsonl")
    sup_log = observe.RunEventLog(log_path)
    # the ranks' logs outlive the phase's directory (its checkpoints)
    logs = os.path.abspath(os.path.join(OUT_DIR, "health_6z_logs"))
    shutil.rmtree(logs, ignore_errors=True)
    sup = Supervisor(_gang_worker_cmd(gang_dir), 2, max_restarts=1,
                     grace_s=30.0, backoff_base_s=1.0, env=env,
                     host_coordinator=True, poll_s=0.05, log_dir=logs,
                     event_log=sup_log)
    t0 = time.perf_counter()
    try:
        result = sup.run()
    finally:
        sup_log.close()
    gang_s = time.perf_counter() - t0
    starts = [e["ts"] for e in observe.read_events(log_path)
              if e["event"] == "gang_start"]
    results = []
    out_dir = os.path.join(gang_dir, "out")
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            results.append(json.load(f))
    for r in results:
        c, w = r["counts"], r["want"]
        if (c["launches"] != w or max(c["plain"].values())
                or max(c["composed"].values())):
            raise AssertionError(f"6z (b) rank {r['rank']} pid {r['pid']}: "
                                 f"launches {c}, want {w}")
        launches = {k: launches[k] + c["launches"][k] for k in launches}

    def logtext(attempt, rank):
        with open(os.path.join(logs, f"attempt{attempt}_rank{rank}.out")) \
                as f:
            return f.read()

    a0 = result.attempts[0]
    survivor = 1 - GANG_KILL_RANK
    victim_steps = [ln.split() for ln in logtext(0, GANG_KILL_RANK)
                    .splitlines() if ln.startswith("STEP ")]
    lost = [json.loads(ln[len("PEER_LOST "):]) for ln in
            logtext(0, survivor).splitlines() if ln.startswith("PEER_LOST ")]
    latency = (lost[0]["alarm_wall_time"] - float(victim_steps[-1][3])
               if lost and victim_steps else None)
    bound = GANG_INTERVAL_S * GANG_MISS_BUDGET + 2 * min(GANG_INTERVAL_S, 1.0)
    firsts = {}
    for rank in (0, 1):
        steps = [ln.split() for ln in logtext(1, rank).splitlines()
                 if ln.startswith("STEP ")]
        firsts[rank] = float(steps[0][3]) - starts[1] if steps else None
    final = {r["rank"]: r for r in results if r["rc"] == 0}
    differ = {rank: sorted(k for k in control[rank]
                           if final.get(rank, {}).get("digests", {}).get(k)
                           != control[rank][k]) for rank in (0, 1)}
    resumed = {r["rank"]: r["resume"] for r in results if r["rc"] == 0}
    newest = {r["rank"]: r["newest_listed"] for r in results if r["rc"] == 0}
    checks = {
        "one_relaunch": result.ok and result.restarts == 1,
        "attempt0": (a0["classified"][GANG_KILL_RANK] == "signal:SIGKILL"
                     and a0["exit_codes"][survivor] == 43
                     and a0["reason"] in ("peer_lost", "crash")
                     and classify_exit(a0["exit_codes"][survivor])
                     == "peer_lost"),
        "survivor_named_the_victim": bool(lost) and lost[0].get(
            "missing_ranks") == [GANG_KILL_RANK],
        "latency_within_bound": latency is not None and latency <= bound,
        "attempt1_done": all("DONE" in logtext(1, r) for r in (0, 1)),
        "resumed_from_newest_serial": (set(resumed) == {0, 1}
                                       and resumed == newest),
        "resumed_mid_run": any(v != [0, 0] for v in resumed.values()),
        "bit_identical": all(not d for d in differ.values())
                         and set(final) == {0, 1},
    }
    good = {r: {k: round(v, 3) for k, v in
                final[r]["goodput"]["categories_s"].items()}
            for r in final}
    log(f"  (b) gang of 2 on the card (gloo, the store in the "
        f"supervisor): rank {GANG_KILL_RANK} SIGKILLed after step "
        f"{GANG_KILL_AT}; detected in {latency if latency is None else round(latency, 3)} s "
        f"(bound {bound:.2f} s = {GANG_INTERVAL_S} x {GANG_MISS_BUDGET} + "
        f"2 polls), attempt 0 {a0['classified']}, backoff slept "
        f"{sup.backoffs_slept}, relaunch to first step "
        f"{ {r: round(v, 2) if v is not None else None for r, v in firsts.items()} } s, "
        f"resumed from {resumed}; {gang_s:.1f} s")
    log(f"  (b) goodput categories (s) of the relaunched ranks: {good}; "
        f"persistables differing from the control: "
        f"{ {r: len(d) for r, d in differ.items()} }")
    if not all(checks.values()):
        raise AssertionError(f"6z (b): {checks}; attempts "
                             f"{result.attempts}; lost {lost}")
    return {"checks": checks, "attempts": result.attempts,
            "detect_latency_s": latency, "detect_bound_s": bound,
            "relaunch_to_first_step_s": firsts,
            "backoff_slept_s": sup.backoffs_slept, "resumed": resumed,
            "goodput": {r: final[r]["goodput"] for r in final},
            "wall_s": gang_s, "launches": launches}


def phase_health(dev, card):
    """6z: (c) the plane's cost, (a) the autopilot, (b) the supervised
    gang with a SIGKILL (see the module docstring).  Every run's
    launches against `_want_launches`; their sum is the phase's."""
    import shutil

    root = os.path.abspath(os.path.join(OUT_DIR, "health_6z"))
    shutil.rmtree(root, ignore_errors=True)
    log(f"phase 6z: the health plane, the supervisor and the autopilot, "
        f"the float32 fused-CE Transformer at {CUT_LAYERS}+{CUT_LAYERS} "
        f"layers (batch {TRAIN_BATCH} x {TRAIN_ARCH['max_length']}, "
        f"dropout {TRAIN_ARCH['dropout']}) on {card}")
    res = {"store": _store_on_this_torch()}
    try:
        res["plane_cost"] = _plane_cost(dev, os.path.join(root, "cost"))
        res["autopilot"] = _autopilot_on_card(dev,
                                              os.path.join(root, "auto"))
        torch.cuda.empty_cache()
        res["gang"] = _gang_on_card(dev, os.path.join(root, "gang"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    parts = [res[k]["launches"] for k in ("plane_cost", "autopilot", "gang")]
    res["launches"] = {k: sum(p[k] for p in parts) for k in parts[0]}
    log(f"  6z launches {res['launches']}")
    return res


# -- phase 8: the periphery (A step 12) --------------------------------------
# file-shard training of 6e's stacked LSTM: RecordIO shards (the native
# codec) leased to parser threads, MultiSlot parsing, the DeviceFeeder's
# copy stream, AsyncExecutor; PyReader-style prefetch; imperative mode on
# the card; FLAGS; host metrics against the in-graph ops

FILE_SHARDS = 8
FILE_LINES = 256             # lines a shard: 16 batches of 128 an epoch
FILE_THREADS = 4
FILE_EPOCHS = 2
PREFETCH_STEPS = 8           # (b): steps at capacity 1 and at 4
PREFETCH_RETRY_STEPS = 6     # (b): the retry check's steps, each way
PROFILE_SHARDS = 2           # the profiled windows: 2 shards, 4 steps
FLAG_RUNS = 3                # (d): runs with FLAGS.benchmark off, then on
TOL_EAGER = 1e-6             # (c): eager against static, bit for bit
#                              expected (the same ops and kernels)
TOL_METRIC = 1e-6            # (e): host metrics against the in-graph ops
MEM_FRACTION_CHILD = r"""
import torch, paddle_tpu_torch as pt
pt.Executor(pt.CUDAPlace(0))
total = torch.cuda.get_device_properties(0).total_memory
ok = torch.empty(int(0.3 * total), dtype=torch.uint8, device="cuda")
del ok
try:
    torch.empty(int(0.6 * total), dtype=torch.uint8, device="cuda")
except torch.cuda.OutOfMemoryError:
    print("capped")
else:
    print("not capped")
"""


def _multislot_desc():
    from paddle_tpu_torch.data.data_feed import DataFeedDesc

    return DataFeedDesc.from_slots(
        [{"name": "words", "type": "uint64", "dense": False,
          "max_len": LSTM_ARCH["max_len"]},
         {"name": "label", "type": "uint64", "dense": True, "dim": 1}],
        batch_size=LSTM_BATCH)


def write_imdb_shards(root):
    """FILE_SHARDS RecordIO shards of FILE_LINES MultiSlot lines each,
    from the synthetic imdb reader at T 128; returns the paths."""
    from paddle_tpu_torch.data import dataset, recordio

    samples = dataset.imdb.train(n=FILE_SHARDS * FILE_LINES,
                                 max_len=LSTM_ARCH["max_len"])()
    files = []
    for s in range(FILE_SHARDS):
        path = os.path.join(root, f"imdb-{s:05d}.recordio")
        with recordio.Writer(path, max_chunk_records=64) as w:
            for _ in range(FILE_LINES):
                tokens, label = next(samples)
                w.write((f"{len(tokens)} " + " ".join(map(str, tokens))
                         + f" 1 {label}").encode())
        files.append(path)
    return files


def _lstm_counts_ok(label, counts, fwd, bwd):
    la, pl, co = counts["launches"], counts["plain"], counts["composed"]
    want = dict.fromkeys(la, 0)
    want.update(lstm_fwd=fwd, lstm_bwd=bwd)
    if la != want or max(pl.values()) or max(co.values()):
        raise AssertionError(f"{label}: launches {counts}, want {want} and "
                             f"no plain or composed call")


def _window_idle_share(fn, steps):
    """Device idle share of fn() (`steps` training steps) in one profiled
    window: 1 - kernels' device time / the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(_device_us(e) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    if busy_ms <= 0:
        raise AssertionError("profiled window recorded no device time")
    return {"wall_ms": wall_ms, "step_ms": wall_ms / steps,
            "device_busy_ms": busy_ms, "device_idle_share":
            1.0 - busy_ms / wall_ms}, prof


def _copies_overlap_kernels(prof):
    """Whether a host-to-device copy ran on the card while a kernel ran
    (the copy stream against the step's stream), from the profile's
    device events; also the count of each."""
    from torch.autograd import DeviceType

    copies, kerns = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if "Memcpy HtoD" in e.name:
            copies.append(span)
        elif not e.name.startswith(("Memcpy", "Memset")):
            kerns.append(span)
    overlap = any(c0 < k1 and k0 < c1 for c0, c1 in copies
                  for k0, k1 in kerns)
    return overlap, len(copies), len(kerns)


def _feed_and_train(exe, main, loss, scope, feeder, steps):
    """`steps` steps fed by `feeder`: (losses, wall s); every batch must
    arrive on the executor's device (the card)."""
    losses = []
    t0 = time.perf_counter()
    it = iter(feeder)
    for _ in range(steps):
        feed = next(it)
        bad = [n for n, t in feed.items() if t.device != exe.device]
        if bad:
            raise AssertionError(f"feed {bad} not on {exe.device}")
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                      return_numpy=False)
        losses.append(out[0].reshape(()))
    losses = [float(v) for v in losses]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    feeder.reset()
    return losses, wall


def phase_file_shards(dev, card):
    """Phase 8 (A step 12): (a) AsyncExecutor trains the full-width
    stacked LSTM from native-codec RecordIO shards of MultiSlot lines at
    FILE_THREADS parser threads, bit for bit with the plain Executor loop
    at one thread; (b) DeviceFeeder prefetch, a reader delayed one step;
    (c) imperative mode, eager gradients and Adam against the static
    program's; (d) FLAGS; (e) host metrics against the in-graph ops."""
    import shutil
    import tempfile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import imperative, layers, metrics
    from paddle_tpu_torch.data import recordio
    from paddle_tpu_torch.data.data_feed import MultiSlotDataFeed
    from paddle_tpu_torch.data.pipeline import DeviceFeeder
    from paddle_tpu_torch.flags import FLAGS
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.resilience import chaos

    log(f"phase 8: file-shard training of the stacked LSTM (batch "
        f"{LSTM_BATCH} x {LSTM_ARCH['max_len']}, hidden "
        f"{LSTM_ARCH['hidden_dim']}, {LSTM_ARCH['stacked_num']} layers) "
        f"from {FILE_SHARDS} RecordIO shards; imperative mode; flags")
    # (d)'s child process starts first and runs beside the rest
    child = subprocess.Popen(
        [sys.executable, "-c", MEM_FRACTION_CHILD],
        env=dict(os.environ, FLAGS_fraction_of_tpu_memory_to_use="0.5"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    root = tempfile.mkdtemp(prefix="phase8_")
    res = {"card": card}
    try:
        t0 = time.perf_counter()
        files = write_imdb_shards(root)
        codec = recordio.codec()
        res["write_s"] = time.perf_counter() - t0
        if codec != "native":
            raise AssertionError(f"8 (a): the {codec} RecordIO codec ran")
        desc = _multislot_desc()
        main, startup, model = build_lstm()
        loss, acc = model["loss"], model["accuracy"]
        n_lstm = sum(op.type == "dynamic_lstm"
                     for op in main.global_block().ops)
        exe = pt.Executor(pt.CUDAPlace(0))
        scope0 = pt.Scope()
        exe.run(startup, scope=scope0)
        batches = list(MultiSlotDataFeed(desc).batches(files))
        per_epoch = FILE_SHARDS * FILE_LINES // LSTM_BATCH
        if len(batches) != per_epoch:
            raise AssertionError(f"8 (a): {len(batches)} batches parsed")

        # -- (a) AsyncExecutor at FILE_THREADS threads, FILE_EPOCHS -----
        scope = _clone_scope(scope0)
        aexe = pt.AsyncExecutor(pt.CUDAPlace(0))
        aexe.run(main, desc, files[:1], thread_num=1, fetch=[loss],
                 scope=_clone_scope(scope0))          # warm
        torch.cuda.synchronize()
        kernels.reset_counts()
        epochs = []
        for epoch in range(FILE_EPOCHS):
            t0 = time.perf_counter()
            means = aexe.run(main, desc, files, thread_num=FILE_THREADS,
                             fetch=[loss, acc], scope=scope)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = aexe.last_stats
            epochs.append({
                "loss": means[loss.name], "accuracy": means[acc.name],
                "steps": st["steps"], "wall_s": wall,
                "examples_per_s": st["steps"] * LSTM_BATCH / wall,
                "parse_ms_per_batch":
                    st["parse_s"] * 1e3 / max(st["parsed_batches"], 1),
                "feeder_queue_depths": st["feeder_queue_depths"],
                "merged_queue_depths": st["merged_queue_depths"]})
        counts = kernels.counts()
        steps = sum(e["steps"] for e in epochs)
        _lstm_counts_ok("8 (a)", counts, n_lstm * steps, n_lstm * steps)
        launches = dict(counts["launches"])
        if any(e["steps"] != per_epoch for e in epochs):
            raise AssertionError(f"8 (a): steps {[e['steps'] for e in epochs]}"
                                 f", want {per_epoch} an epoch")
        if not epochs[1]["loss"] < epochs[0]["loss"]:
            raise AssertionError(f"8 (a): epoch losses {epochs[0]['loss']} "
                                 f"then {epochs[1]['loss']}")
        for i, e in enumerate(epochs):
            log(f"  (a) epoch {i + 1}: mean loss {e['loss']:.6g}, accuracy "
                f"{e['accuracy']:.4f}, {e['steps']} steps in "
                f"{e['wall_s']:.3f} s, {e['examples_per_s']:.1f} examples/s "
                f"at {FILE_THREADS} threads; parse "
                f"{e['parse_ms_per_batch']:.2f} ms a batch; feeder queue "
                f"depth at each get {e['feeder_queue_depths']}")
        res["a_epochs"] = epochs
        res["codec"] = codec

        # parity: one thread against the plain Executor loop, bit for bit
        s_async, s_plain = _clone_scope(scope0), _clone_scope(scope0)
        t0 = time.perf_counter()
        aexe.run(main, desc, files, thread_num=1, fetch=[loss],
                 scope=s_async)
        torch.cuda.synchronize()
        one_thread_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for b in batches:
            exe.run(main, feed=b, fetch_list=[loss], scope=s_plain)
        torch.cuda.synchronize()
        memory_s = time.perf_counter() - t0
        a, b = _state(main, s_async), _state(main, s_plain)
        diff = sorted(n for n in b if not torch.equal(a[n], b[n]))
        if sorted(a) != sorted(b) or diff:
            raise AssertionError(f"8 (a): one-thread AsyncExecutor against "
                                 f"the plain loop: {diff[:6]} differ")
        res["parity"] = {"persistables": len(b), "equal": True}
        res["examples_per_s"] = {
            f"async_{FILE_THREADS}_threads": epochs[-1]["examples_per_s"],
            "async_1_thread": per_epoch * LSTM_BATCH / one_thread_s,
            "memory_fed_numpy": per_epoch * LSTM_BATCH / memory_s}
        log(f"  (a) one thread and the plain loop: {len(b)} persistables bit "
            f"for bit; examples/s {res['examples_per_s']}")
        # profiled windows: file-fed at 1 and FILE_THREADS threads, and
        # fed from memory (numpy, as the plain loop)
        few = files[:PROFILE_SHARDS]
        n_few = PROFILE_SHARDS * FILE_LINES // LSTM_BATCH
        win = {}
        for threads in (1, FILE_THREADS):
            win[f"async_{threads}"], _ = _window_idle_share(
                lambda t=threads: aexe.run(main, desc, few, thread_num=t,
                                           fetch=[loss], scope=s_async),
                n_few)

        def memory_fed():
            for bt in batches[:n_few]:
                exe.run(main, feed=bt, fetch_list=[loss], scope=s_plain)

        win["memory_fed"], _ = _window_idle_share(memory_fed, n_few)
        res["idle_share"] = win
        for k, v in win.items():
            log(f"  (a) profiled window, {k}: {v['step_ms']:.2f} ms a step, "
                f"device idle share {v['device_idle_share']:.3f}")

        # -- (b) DeviceFeeder prefetch against a reader delayed a step --
        step_s = win["memory_fed"]["step_ms"] / 1e3
        dev_batches = batches[:PREFETCH_STEPS]

        def delayed():
            for bt in dev_batches:
                time.sleep(step_s)
                yield bt

        pre = {}
        for cap in (1, 4):
            sc = _clone_scope(scope0)
            feeder = DeviceFeeder(delayed, capacity=cap,
                                  device=pt.CUDAPlace(0))
            _, wall = _feed_and_train(exe, main, loss, sc, feeder,
                                      PREFETCH_STEPS)
            pre[f"capacity_{cap}_s"] = wall
        n = PREFETCH_STEPS
        pre["n_max_delay_step_s"] = n * step_s
        pre["n_delay_plus_step_s"] = 2 * n * step_s
        feeder = DeviceFeeder(lambda: iter(dev_batches), capacity=4,
                              device=pt.CUDAPlace(0))
        sc = _clone_scope(scope0)
        _, prof = _window_idle_share(
            lambda: _feed_and_train(exe, main, loss, sc, feeder, 4), 4)
        pre["copies_overlap_kernels"], pre["copies"], pre["kernels"] = \
            _copies_overlap_kernels(prof)
        log(f"  (b) {n} steps with a reader delayed {step_s * 1e3:.2f} ms "
            f"a batch: capacity 1 {pre['capacity_1_s']:.3f} s, capacity 4 "
            f"{pre['capacity_4_s']:.3f} s; N x max(delay, step) "
            f"{pre['n_max_delay_step_s']:.3f} s, N x (delay + step) "
            f"{pre['n_delay_plus_step_s']:.3f} s; copies overlap kernels: "
            f"{pre['copies_overlap_kernels']} ({pre['copies']} copies)")
        # speed-test mode serves the first batch again and again
        FLAGS.reader_queue_speed_test_mode = True
        try:
            it = iter(DeviceFeeder(lambda: iter(dev_batches), capacity=2,
                                   device=pt.CUDAPlace(0)))
            served = [next(it) for _ in range(5)]
            it.reset()
        finally:
            FLAGS.reader_queue_speed_test_mode = False
        first = served[0]["words"]
        if not all(s["words"] is first for s in served):
            raise AssertionError("8 (b): speed-test mode served another batch")
        # a transient producer error is retried: the same losses
        runs = []
        for inject in (False, True):
            if inject:
                chaos.arm("feeder:producer", times=1)
            feeder = DeviceFeeder(lambda: iter(dev_batches), capacity=2,
                                  device=pt.CUDAPlace(0),
                                  retryable=(chaos.ChaosKilled,),
                                  backoff_s=0.001)
            losses, _ = _feed_and_train(exe, main, loss, _clone_scope(scope0),
                                        feeder, PREFETCH_RETRY_STEPS)
            chaos.clear()
            runs.append((losses, feeder.retries))
        if runs[1][1] != 1 or runs[0][0] != runs[1][0]:
            raise AssertionError(f"8 (b): retry run {runs[1]} against {runs[0]}")
        pre["retry"] = {"retries": runs[1][1], "losses_equal": True}
        log("  (b) every batch on cuda:0; speed-test mode served batch 1 five "
            "times; one injected producer error retried, losses bit for bit")
        res["prefetch"] = pre

        # -- (c) imperative mode on the card --------------------------------
        res["imperative"], eager_launches = _eager_on_card(
            dev, pt, imperative, batches[0])
        for k, v in eager_launches.items():
            launches[k] += v

        # -- (d) flags -------------------------------------------------------
        res["flags"] = _flags_on_card(exe, main, startup, loss, scope0,
                                      batches[0], child)
        child = None

        # -- (e) host metrics against the in-graph ops ------------------------
        # on the untrained model: (a)'s trained one ranks every example
        # right (AUC 1), which would hold the two AUCs to nothing
        res["metrics"] = _metrics_on_card(exe, main, loss, acc,
                                          _clone_scope(scope0), batches,
                                          layers, metrics)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        if child is not None:
            child.kill()
            child.communicate()
    res["launches"] = launches
    log(f"  8 launches {launches}")
    return res


def _eager_on_card(dev, pt, imperative, batch):
    """8 (c): 6e's model at one LSTM layer, its forward ops traced eagerly
    under imperative.guard() on the card from the static program's
    startup values: every parameter's .grad against the static program's
    gradients (one Executor step that also applies Adam), the LSTM
    kernels once forward and once backward, and an eager AdamOptimizer
    step against the static update."""
    from paddle_tpu_torch.ops import kernels

    main, startup, model = build_lstm(stacked_num=1)
    exe = pt.Executor(pt.CUDAPlace(0))
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.all_parameters()]
    start = {n: scope.find_var(n).clone() for n in params}
    from paddle_tpu_torch.ops.common import to_torch_dtype

    block = main.global_block()
    feed = {n: torch.as_tensor(a).to(
        device=dev, dtype=to_torch_dtype(block.var(n).dtype))
        for n, a in batch.items()}
    outs = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                   fetch_list=[model["loss"]] + [f"{n}@GRAD" for n in params])
    static_grads = dict(zip(params, outs[1:]))
    static_new = {n: scope.find_var(n) for n in params}
    k = main._backward_info["index"]
    fwd = main.global_block().ops[:k]
    types = [op.type for op in fwd]
    for need in ("lookup_table", "mul", "dynamic_lstm", "sequence_pool",
                 "softmax", "cross_entropy", "mean"):
        if need not in types:
            raise AssertionError(f"8 (c): no {need} in the forward {types}")
    torch.cuda.synchronize()
    kernels.reset_counts()
    with imperative.guard():
        env = {n: imperative.to_variable(start[n]) for n in params}
        for n, t in feed.items():
            env[n] = imperative.to_variable(t, stop_gradient=True)
        for op in fwd:
            slots = list(op.desc.outputs)
            got = imperative.trace_op(
                op.type, {s: [env[x] for x in names]
                          for s, names in op.desc.inputs.items()},
                dict(op.desc.attrs), out_slots=slots)
            got = got if isinstance(got, list) else [got]
            names = [x for s in slots for x in op.desc.outputs[s]]
            env.update(zip(names, got))
        root = env[model["loss"].name]
        root.backward()
        counts = kernels.counts()
        _lstm_counts_ok("8 (c) eager step", counts, 1, 1)
        grad_err = {n: float((env[n].grad - static_grads[n]).abs().max())
                    for n in params}
        opt = imperative.AdamOptimizer(learning_rate=LSTM_ARCH[
            "learning_rate"])
        opt.step([env[n] for n in params])
        upd_err = {n: float((env[n].value - static_new[n]).abs().max())
                   for n in params}
    bad = {n: e for n, e in {**grad_err, **upd_err}.items()
           if not e <= TOL_EAGER}
    if bad:
        raise AssertionError(f"8 (c): eager against static beyond "
                             f"{TOL_EAGER}: {bad}")
    res = {"params": len(params), "max_grad_err": max(grad_err.values()),
           "max_adam_err": max(upd_err.values()),
           "bit_equal_grads": sum(e == 0.0 for e in grad_err.values()),
           "launches": counts["launches"]}
    log(f"  (c) eager step on the card: {len(params)} parameters' .grad "
        f"within {res['max_grad_err']:.3g} of the static program's "
        f"({res['bit_equal_grads']} bit for bit), Adam within "
        f"{res['max_adam_err']:.3g}; LSTM kernels once forward, once "
        f"backward")
    return res, counts["launches"]


def _flags_on_card(exe, main, startup, loss, scope0, batch, child):
    """8 (d): check_nan_inf names a planted NaN parameter; FLAGS.benchmark
    adds one device synchronization a run; the memory fraction caps a
    child process's allocator."""
    from paddle_tpu_torch.flags import FLAGS

    res = {}
    test_prog = main.clone(for_test=True)
    sc = _clone_scope(scope0)
    victim = main.all_parameters()[-1].name
    val = sc.find_var(victim).clone()
    val.view(-1)[0] = float("nan")
    sc.set_var(victim, val)
    FLAGS.check_nan_inf = True
    try:
        exe.run(test_prog, feed=batch, fetch_list=[], scope=sc)
    except FloatingPointError as e:
        if repr(victim) not in str(e):
            raise AssertionError(f"8 (d): check_nan_inf named {e}, not "
                                 f"{victim!r}")
        res["check_nan_inf"] = str(e)
    else:
        raise AssertionError("8 (d): check_nan_inf did not raise")
    finally:
        FLAGS.check_nan_inf = False
    sc = _clone_scope(scope0)
    exe.run(main, feed=batch, fetch_list=[loss], scope=sc)
    syncs, device_syncs = {}, {}
    plain_sync = torch.cuda.synchronize

    def counted_sync(*a, **k):
        device_syncs[on] += 1
        return plain_sync(*a, **k)

    torch.cuda.synchronize = counted_sync
    try:
        for on in (False, True):
            FLAGS.benchmark = on
            device_syncs[on] = 0
            syncs[on] = _sync_warnings(lambda: [
                exe.run(main, feed=batch, fetch_list=[loss], scope=sc,
                        return_numpy=False) for _ in range(FLAG_RUNS)])
    finally:
        FLAGS.benchmark = False
        torch.cuda.synchronize = plain_sync
    # the synchronizations the sync-debug mode reports (6z (c)'s count);
    # a device-wide torch.cuda.synchronize counted where it reports none
    extra = len(syncs[True]) - len(syncs[False])
    explicit = device_syncs[True] - device_syncs[False]
    res["benchmark_syncs"] = {"off": len(syncs[False]),
                              "on": len(syncs[True]),
                              "device_synchronize_on": explicit,
                              "lines_on": sorted(set(syncs[True]))}
    if not (extra == FLAG_RUNS or (extra == 0 and explicit == FLAG_RUNS)):
        raise AssertionError(f"8 (d): FLAGS.benchmark added {extra} "
                             f"reported and {explicit} device syncs over "
                             f"{FLAG_RUNS} runs: {res}")
    try:
        out, err = child.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        child.kill()
        child.communicate()
        raise AssertionError("8 (d): the memory-fraction child hung")
    res["memory_fraction_child"] = out.strip()
    if child.returncode != 0 or out.strip() != "capped":
        raise AssertionError(f"8 (d): memory-fraction child rc "
                             f"{child.returncode}: {out} {err[-1500:]}")
    log(f"  (d) check_nan_inf: {res['check_nan_inf']}; FLAGS.benchmark: "
        f"{res['benchmark_syncs']['off']} then "
        f"{res['benchmark_syncs']['on']} reported host syncs, "
        f"{explicit} device syncs added over {FLAG_RUNS} runs; "
        f"FLAGS_fraction_of_tpu_memory_to_use=0.5 child: {out.strip()}")
    return res


def _metrics_on_card(exe, main, loss, acc, scope, batches, layers,
                     metrics):
    """8 (e): metrics.Auc and metrics.Accuracy over the model's fetches
    on the card (softmax and batch accuracy) against the in-graph auc
    op's streaming AUC and the accuracy of the fetched predictions."""
    import paddle_tpu_torch as pt

    test_prog = main.clone(for_test=True)
    block = test_prog.global_block()
    ce = [op for op in block.ops if op.type == "cross_entropy"][0]
    predict = block.var(ce.desc.inputs["X"][0])
    label = block.var(ce.desc.inputs["Label"][0])
    startup = pt.Program()
    with pt.program_guard(test_prog, startup):
        auc_out, _ = layers.auc(input=predict, label=label)
    exe.run(startup, scope=scope)
    m_auc, m_acc = metrics.Auc(), metrics.Accuracy()
    correct = total = 0
    for b in batches:
        p, a, g = exe.run(test_prog, feed=b, scope=scope,
                          return_numpy=False,
                          fetch_list=[predict, acc, auc_out])
        m_auc.update(p, b["label"])
        m_acc.update(a, LSTM_BATCH)
        pred = p.argmax(-1).cpu().numpy()
        correct += int((pred == b["label"].reshape(-1)).sum())
        total += LSTM_BATCH
    graph_auc = float(g.reshape(-1)[0])
    res = {"auc_host": m_auc.eval(), "auc_graph": graph_auc,
           "accuracy_host": m_acc.eval(), "accuracy_fetched": correct / total}
    if not (abs(res["auc_host"] - graph_auc) <= TOL_METRIC
            and abs(res["accuracy_host"] - correct / total) <= TOL_METRIC):
        raise AssertionError(f"8 (e): host metrics against the graph: {res}")
    log(f"  (e) AUC host {res['auc_host']:.7f} graph {graph_auc:.7f}; "
        f"accuracy host {res['accuracy_host']:.7f}, of the fetched "
        f"predictions {correct / total:.7f}")
    return res



def phase_alone(label) -> int:
    """`chip_smoke.py --phase <label>` (PHASES_ALONE): the kernels built
    and that phase alone; its summary to OUT_DIR/<json name>, the card
    line and "<label> ok" last."""
    from paddle_tpu_torch.ops.kernels import _build

    fn, name = PHASES_ALONE[label]
    card = card_line()
    _set_matmul_flags()
    t0 = time.perf_counter()
    built = _build.build()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    res = fn(torch.device("cuda", 0), card)
    log(f"  [{label}: {time.perf_counter() - t0:.1f} s]")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(res, f, indent=1, default=str)
    print(card)
    print(f"{label} ok")
    return 0


PHASES_ALONE = {"6w": (phase_data_parallel, "data_parallel.json"),
                "6x": (phase_model_axes, "model_axes.json"),
                "6y": (phase_cost_planes, "cost_planes.json"),
                "6z": (phase_health, "health.json"),
                "8": (phase_file_shards, "file_shards.json")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    # Kineto's warnings (records dropped, buffers exhausted) to stderr, so
    # a profile that records no CUDA activity names its cause (ROADMAP C22)
    os.environ.setdefault("KINETO_LOG_LEVEL", "2")
    if sys.argv[1:2] == ["--trainer-worker"]:
        return trainer_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--mx-worker"]:
        return mx_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--gang-worker"]:
        return gang_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--phase"] and sys.argv[2:] and \
            sys.argv[2] in PHASES_ALONE and len(sys.argv) == 3:
        return phase_alone(sys.argv[2])
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
    cost_planes = timed("6y", phase_cost_planes, dev, card)
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
    train_accum = timed("6o", phase_accumulate, dev, card)
    train_accum_amp = timed("6o AMP", phase_accumulate, dev, card,
                            "phase 6o AMP", AMP)
    train_recompute = timed("6p", phase_recompute, dev, card)
    train_optimizers = timed("6q", phase_optimizers, dev, card)
    train_book = timed("6r", phase_book_models, dev, card)
    control_flow = timed("6s", phase_control_flow, dev, card)
    moe = timed("6t", phase_moe, dev, card)
    qat_int8 = timed("6u", phase_qat_int8, dev, card)
    detection = timed("6v", phase_detection, dev, card)
    fleet = timed("4e", phase_fleet, dev, card)
    serving_engine = timed("4f", phase_serving_engine, dev, card)
    disagg = timed("4g", phase_disagg, dev, card)
    data_parallel = timed("6w", phase_data_parallel, dev, card)
    model_axes = timed("6x", phase_model_axes, dev, card)
    health = timed("6z", phase_health, dev, card)
    file_shards = timed("8", phase_file_shards, dev, card)

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
    # on the speculative engines' verify runs; the flash forward inside
    # 6s's While body; the flash kernels (float32, then bf16) on 6t's MoE
    # Transformer; none on 6u's QAT/int8 ResNet-50 and SRL paths nor on
    # 6v's Faster R-CNN (counted all the same); the paged kernel and the
    # flash forward on 4e's fleet replicas, none on 4f's ResNet-50
    # Predictor and ServingEngine; the flash forward on 4g's prefill
    # workers and the paged kernel on its decode workers; the flash
    # kernels on 6w's one-rank compiled run and on both ranks of each of
    # its modes; on 6x's ranks, the flash kernels on 4 of 8 heads under
    # mp, the ring's chunks with their q/k offsets under sp, every
    # microbatch's stage layers under pp, and the MoE Transformer's
    # attention under ep
    paths = (stream, spec_stream, oracle, train, train_fused, train_longctx,
             train_lstm, train_bert, train_amp, train_bert_amp, train_resume,
             train_guard, train_trainer, train_accum, train_accum_amp,
             train_recompute, train_optimizers, control_flow, moe, qat_int8,
             detection, fleet, serving_engine, disagg, data_parallel,
             model_axes, cost_planes, health, file_shards)
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
                   "train_accumulate": train_accum,
                   "train_accumulate_amp": train_accum_amp,
                   "train_recompute": train_recompute,
                   "train_optimizers": train_optimizers,
                   "train_book_models": train_book,
                   "control_flow": control_flow,
                   "moe": moe,
                   "qat_int8": qat_int8,
                   "detection": detection,
                   "fleet": fleet,
                   "serving_engine": serving_engine,
                   "disagg": disagg,
                   "data_parallel": data_parallel,
                   "model_axes": model_axes,
                   "cost_planes": cost_planes,
                   "health": health,
                   "file_shards": file_shards,
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
