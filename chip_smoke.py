#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an H100:
the kernels are built for sm_90a). Phases, each of which fails the run:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels of ``paddle_tpu_torch/csrc`` (flash forward,
   flash backward, the flash backward's delta, paged decode over float32
   and over int8 caches, dropout) and print the build time and the
   compiler's register / shared-memory report; for every instantiation
   of the three flash kernels (float32 and bf16), its registers, spills,
   shared memory and the count of HMMA (`mma.sync`) and HGMMA (`wgmma`)
   tensor-core instructions in ``cuobjdump -sass`` of the built library:
   not both 0 (and the forward must not spill at D <= 64), and the bf16
   forward, dQ and dK/dV kernels HGMMA only; ptxas's warnings that it
   serialized a kernel's wgmma (C7500-C7519), each printed; for
   every instantiation of the two paged decode sources' split and merge
   kernels, its registers, spills and shared memory;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it (max error vs tolerance, kernel ms, plain ms,
   the least time the card could take, and where one PyTorch call
   computes the same function, its time as a yardstick): the flash
   forward at the serving shapes; the flash forward with attention
   dropout and the dQ and dK/dV kernels at the training shapes (B 32,
   H 8, T 256, D 64, causal and not, rate 0 and 0.1, and a ragged T 200);
   the forward on peaked scores (q and k scaled by 4) and at T 200 for
   D 32, 64 and 128, causal and not; the delta kernel at the same shape
   against its plain version (each row within DELTA_TOL of its sum of
   |dO O|); every flash kernel launched twice on the same inputs gives
   equal bits; their bounds at the 3xTF32
   tensor-core rate they run at, and on the f32 CUDA cores for comparison
   with a CUDA-core version; the dropout mask of all three exactly equal
   to the plain version's;
   the paged decode kernel at S 8, H 8, Dh 64, block 16, seq_lens from 0
   to 1024, every row a slot must not read NaN; the int8 paged decode
   kernel at S 32, seq_lens spread over 0..1024, dead blocks' scales
   poisoned; both also at S 1, one slot at seq_len 1024 (the single long
   request), each with its split launch (P, NSPLIT, live blocks) and two
   launches bit-equal; beside them the floor of the timing method (one
   launch of a one-element kernel) and each paged pair with every chunk
   dead; the dropout kernel at [32, 256, 512] and [32, 256, 2048] and at
   train-base-unfused's attention weights [32, 8, 256, 256], rate 0.1,
   forward with and without `Mask` (train-base's forward writes none)
   and on a `dy`, bit for bit;
3b. the bf16 instantiations that bf16 mixed precision launches: the
   flash forward, dQ and dK/dV at train-base-amp's shape (B 64, H 8,
   T 256, D 64, causal and not, rate 0.1 and 0) against their bf16 plain
   versions (each element of O, dQ, dK, dV within BF16_ULPS bf16 ulps
   of its plain value plus BF16_ROW_TOL of its row's largest and
   BF16_ATOL of the tensor's, lse within LSE_TOL), two launches
   bit-equal, their bounds at the bf16 tensor-core rate (989 TFLOP/s)
   or in bytes, beside SDPA in bf16; the bf16 delta kernel against its
   plain version (three PyTorch passes) as in phase 3; the backward pair
   beside the delta kernel and beside SDPA's bf16 backward at the same
   dropout_p and at 0; their dropout masks bit for bit; the bf16 dropout kernel at
   [64, 256, 512], [64, 256, 2048] and [64, 8, 256, 256], bit for bit
   against its plain version, its keep bits the float32 kernel's;
4. serve-base: save the tiny_lm (vocab 30000, d_model 512, 8 heads, 6
   layers, 8 slots, block 16, context 1024) from a seed, serve it with
   `InferenceServer(CUDAPlace(0))`, send 8 concurrent generate requests
   (prompts of 40..500 tokens, 32 new tokens each), check that each
   kernel was launched 6 times per prefill step / decode step, and that
   the tokens equal a `CPUPlace()` run of the same dir;
4b. serve-base-int8: the same model saved with `kv_dtype="int8"`, its
   cache sized from serve-base's float32 byte budget (2050 blocks, 32
   slots), 32 concurrent requests: the int8 decode kernel launched 6
   times per decode step and the float32 one not at all, tokens equal to
   a `CPUPlace()` run of the same dir. The longest request, and any
   whose tokens differ, is replayed on both teacher-forced on the host's
   tokens: logits within Q8_LOGIT_TOL, int8 caches apart by rounding
   flips only, differing picks a near-tie (see Q8_LOGIT_TOL below);
4c. serve-base-swap: serve-base as v1 and a v2 from another weight seed;
   4 requests start on v1 (600 new tokens each), v2 is staged with
   `prepare_swap` and published with `commit_swap` while they decode,
   4 more requests follow: the first finish on v1, the later on v2, each
   with a `CPUPlace()` run's tokens of its version; no v2 prefill runs
   before v1's slots drain; v1 retires; the flash forward and paged decode
   kernels launch on both versions, once a layer a step;
4d. serve-resnet50: ResNet-50 (bench.py's, 224 x 224 x 3 NHWC, 1000
   classes, float32, TF32 off) built for inference, saved with
   `save_inference_model` and served one-shot by
   `InferenceServer(CUDAPlace(0))` over rows rungs 1..32: probes solo
   against a `CPUPlace()` server and coalesced into one batch of 32 against
   their solo rows (top-1 equal, probabilities and log-probabilities within
   tolerance); then 640 requests of 1-8 images from 16 closed-loop client
   threads, with v2 (parameters x 1.01) staged and committed halfway and
   v3 (x 1.02) saved over the served dir and picked up by the dir watcher,
   a probe after each flip against the host's run of that version: no
   failed request, every version serving, v1 and v2 retired, no kernel of
   ``csrc/`` launched; images/s, latency p50/p99, batches, occupancy,
   padding waste and peak device memory printed;
5. train-base: build Transformer-base (`models/transformer.py`: vocab
   30000, seq 256, 6 layers, 8 heads, d_model 512, d_inner 2048, dropout
   0.1, fused attention) with `Adam(1e-3)`, run its startup with
   `Executor(CUDAPlace(0))` and take 10 steps on one fixed batch of
   32 x 256 tokens: losses finite and falling, and per step 36 flash
   forward launches (18 attentions, each run again by its grad op), 18
   delta, 18 dQ and 18 dK/dV launches; print step ms, tokens/s and peak memory. Then
   the same again under ``FLAGS_dropout_impl=pallas``: every dropout op
   that passes the gate launches the dropout kernel in its forward and in
   its grad, and no launch writes the op's `Mask`, which nothing in the
   step reads; both readings side by side;
6. train parity: the same model at batch 2, from one startup state loaded
   into a `CUDAPlace(0)` and a `CPUPlace()` executor, PARITY_STEPS steps,
   losses
   equal within LOSS_RTOL: at dropout 0, and at dropout 0.1 under
   ``FLAGS_dropout_impl=pallas`` (the dropout kernel's and the flash
   kernels' masks are their plain versions');
6b. train-resnet50: build ResNet-50 as bench.py's headline benchmark
   builds it (`models/resnet.py`: depth 50, 1000 classes, 224 x 224 x 3,
   NHWC) with `Momentum(0.1, 0.9)`, run its startup with
   `Executor(CUDAPlace(0))` and take 10 steps of batch 128 on one fixed
   synthetic batch staged on the card, float32 with TF32 off: losses
   finite, no launch of any kernel above (its convs, pools and batch
   norms are cuDNN's through torch); print step ms, images/s, peak
   memory and the step's share of its float32 bound (3 x 2 x the
   multiply-adds an image, counted from the Program's conv and fc
   shapes, x 128, at 67 TFLOP/s). Then card against host, PARITY_STEPS
   steps each
   from the host's state (the comment at RESNET_PARITY_LR
   says why): ResNet-50 at
   batch 2 and the MNIST CNN (NCHW) at batch 16 with Adam, losses within
   LOSS_RTOL, running stats and the other state within their stated
   tolerances;
6c. train-resnet50-reader: the same model fed as a Fluid user feeds it,
   from a RecordIO file: 1024 uint8 224 x 224 x 3 images and int64 labels
   from RandomState(0) written by `convert_reader_to_recordio_file`
   (write time and codec path printed), read back through
   `reader.creator.recordio` -> `xmap_readers` (decode to float32 in
   numpy: / 255, minus a per-channel mean) -> `batch(128)`; (a)
   `Trainer.train` for 2 epochs (16 steps) with an `ark.CheckpointConfig`
   every 4 steps, the checkpoint dir copied before step 6, and a second
   Trainer resumed from that copy: its losses equal the first run's bit
   for bit (both under cuDNN's deterministic algorithms); (b)
   `AsyncFeeder(DataFeeder, reader, capacity=4, prepared=handle)`, 34
   steps in float32 and under `Executor(amp=True)`, each feed on the card
   before its step: 2 warm-up, 6 while the pipeline fills, 16 steady and
   10 draining its buffers, each phase's median apart; over the steady
   steps the step ms, images/s, the consumer's wait a step, the starved
   steps and the producer's ms a batch, beside 8 steps on a staged batch
   and 6b's staged step of the same call, and one batch's H2D pinned on a
   side stream against pageable (CUDA events);
   (c) `layers.py_reader` with `exe.run(feed=None)` until `EOFException`,
   two passes of 8 steps with `reset()` between, each popped feed on the
   card; losses finite everywhere and no kernel of ``csrc/`` launched;
7. bf16 mixed precision, the configuration bench.py measures
   (`Executor(CUDAPlace(0), amp=True)`): train-base-amp, 10 steps at
   bench.py's batch 64 with the bits dropout and 4 under
   ``FLAGS_dropout_impl=pallas``: per step the bf16 flash kernels launch
   36 forwards, 18 deltas, 18 dQ and 18 dK/dV, the float32 ones never; under
   `pallas` the dropout kernel launches in bf16 at every gated site but
   the two that no bf16 op reaches (after the embeddings), which run the
   float32 kernel, as the JAX package runs them in float32;
   train-resnet50-amp, 10 steps at batch 128, no kernel counter moving;
   step ms, tokens or images a second, peak memory and the share of the
   bf16 bound (3 x 2 x the multiply-adds model_macs counts, at 989
   TFLOP/s); then card against host under AMP, AMP_PARITY_STEPS steps
   each from the
   host's state: Transformer-base at batch 2 and dropout 0, ResNet-50 at
   batch 2, each side also taking each step in float32; the card's
   losses and state within AMP_NOISE_FACTOR times the distance bf16
   puts between the host's own AMP and float32 steps, and the output of
   every op of the policy's bf16 set bf16 in each AMP step (float32 in
   each float32 one);
7b. train-base-unfused: Transformer-base with ``fused_attention=False``
   (matmul, causal_mask + elementwise_add, softmax, dropout, matmul),
   float32 at batch 32 and AMP at 64, UNFUSED_STEPS steps each under
   ``auto`` and ``pallas``: no flash kernel launched; under ``pallas`` the
   dropout kernel at every gated op, its 18 attention weights among them,
   in the forward and the grad (124 launches a step float32; 120 bf16 and
   4 float32 under AMP); step ms, tokens/s and peak memory beside the
   fused path's of this call; then card vs host at batch 2 and dropout
   0, UNFUSED_PARITY_STEPS steps each from the host's state, float32
   (LOSS_RTOL)
   and AMP,
   and the unfused loss against the fused one from the same parameters
   (within TOL);
7c. train-se_resnext50: SE-ResNeXt-50 32x4d, 224 x 224 NHWC, 1000
   classes, batch 128, Momentum(0.9) on piecewise_decay with
   L2Decay(1e-4), 10 steps in float32 (TF32 off) and 10 under AMP: step
   ms, images/s, peak memory, share of the bound; card vs host at batch
   2, float32 and AMP, as for ResNet-50;
7d. train-vgg16: VGG-16 with batch norm on CIFAR-10's shape, batch 128,
   Adam(1e-3), 10 steps under ``pallas``: its downgrade_in_infer
   dropouts launch no kernel;
7e. train-deepfm: `models.deepfm.build()` at its defaults, batch 512,
   Adagrad(0.01) under GradientClipByGlobalNorm(10), 10 steps, the loss
   falling;
7f. the optimizer sweep: a 512-wide three-layer fc net, 3 steps on the
   card and on the host from one state, through every optimizer class,
   ModelAverage's apply and restore, every learning-rate schedule,
   append_LARS, every clip and a per-parameter learning rate: losses
   within SWEEP_LOSS_RTOL, each persistable within SWEEP_STATE_L2;
7g. train-stacked-lstm: the stacked dynamic LSTM at bench.py's
   configuration (`models.stacked_dynamic_lstm.build()`: dict 30000,
   embedding 512, 3 LSTMs of 512 with peepholes, Adam(1e-3); batch 64
   padded to 100 steps, lengths uniform in [50, 100] from RandomState(0),
   fed as a `(words, lengths)` pair), float32 and under AMP, 3 + 10 steps
   each, then one traced step of each (a torch.profiler session slows
   every later launch, so no timed step follows one): losses finite and
   falling, no kernel of csrc/ launched; step ms, examples/s, padded and
   valid tokens/s, peak memory and the traced step's device busy share.
   Then card vs host, PARITY_STEPS steps
   each from the host's state, at 2 layers x 64 (the second reversed),
   batch 4, T 12, lengths 1 and 12 among them; and each sequence op and
   gru / lstmp / lstm_unit / gru_unit (one case sweep) card vs host with
   its grads, within SEQ_OP_TOL;
7h. train-mt: BASELINE.json's "Fluid machine_translation", the
   attention seq2seq of `models.machine_translation.build` at the
   reference's Fluid benchmark widths (dictionary 30000, embedding,
   encoder and decoder 512), Adam(1e-3), float32 with TF32 off; batch
   64, source lengths uniform in [10, 50] from RandomState(0) fed as a
   `(src, lengths)` pair, target and label padded to 50; 3 + 10 steps on
   one batch, then one traced step: losses finite and falling, no kernel
   of csrc/ launched; step ms, examples/s, target tokens/s, peak memory,
   the traced step's device busy share and device events;
7i. infer-mt-beam: the trained parameters saved, `build_infer` (beam
   4, max_len 50) loaded with them and saved by `save_inference_model`,
   then `load_inference_model` into a fresh scope on the card and on the
   host; 16 sources decoded on each: ids equal (a row whose history
   parts from the host's at a step where the two sides' top-beam scores
   lie within MT_TIE of each other is reported as a tie, any other
   difference fails), scores within MT_SCORE_RTOL; ms a batch and
   generated tokens/s on the card;
7j. the book: the nine chapters of Fluid's book tests
   (``tools/torch_book.py``: fit_a_line, recognize_digits,
   image_classification, word2vec, understand_sentiment,
   label_semantic_roles, machine_translation, recommender_system,
   rnn_encoder_decoder) at the book's widths, batches and optimizers
   (`torch_book.CARD`), float32 with TF32 off, NCHW, each built through
   `layers`, trained through `optimizer.*.minimize` and
   `Executor(CUDAPlace(0))` on batches that `reader.batch` over the
   port's `dataset` readers and `DataFeeder` make: BOOK_WARMUP + BOOK_STEPS
   steps, then one counted step (the rule calls a step; every feed and
   persistable on the card); losses finite, no kernel of csrc/ launched;
   step ms (median), examples/s, peak memory; the inference model saved,
   loaded into a fresh scope on the card and on the host, one batch run
   on each (floats within LOSS_RTOL of the host's scale, the Viterbi
   paths equal, the classifiers' top-1 equal but at a host near-tie
   within BOOK_TIE); card vs host for BOOK_PARITY_STEPS steps each from
   the host's state (`run_step_parity`; the image chapters at batch 8;
   under Adam and Adagrad the parameters held through their optimizer
   slots);
   after the other traced steps, one traced step a chapter (device busy
   share). Numbers also in ``chiprun_out/chip_smoke_book.json``;
7k. the common op breadth: train-deepfm (7e's program) with
   `layers.auc` on its prediction, DEEPFM_STEPS steps on the host from
   one state, a new batch each step, each step also on the card from the
   host's state before it: StatPos / StatNeg equal every step (a
   prediction may move bucket only on a bucket's edge, AUC_BUCKET_TIE,
   reported), the AUC within AUC_TOL, the losses within LOSS_RTOL; a free
   run on the card times the step with and without the auc op;
   `io.save_params`, `load_params` into a fresh card scope and one more
   step, bit-equal to the step without the round trip. Then the breadth
   bank (`_breadth_cases`): each new activation, elementwise, reduction,
   `cumsum`, `argsort`, `l2_normalize`, `prelu` and loss op, and the
   three repaired ones, forward and grad on [8192, 2048] float32 (a
   quarter of the inputs on multiples of 0.5: zeros, bounds, ties);
   gather, scatter (both modes, ids repeated), gather_nd and one_hot on
   a [30000, 512] table with 8192 ids; stack, unstack, expand, pad,
   pad2d (three modes), flatten and reverse on [32, 8, 256, 64];
   depthwise_conv2d 3x3 on [32, 256, 56, 56], conv2d_transpose 4x4
   stride 2 from [32, 256, 14, 14] to 128 channels (both also under
   AMP), lrn on [32, 96, 55, 55] and grid_sampler on [32, 64, 56, 56]:
   two card runs bit-equal (cuDNN deterministic), the card ms a run,
   and the card against the host with the rows or batch cut by
   BREADTH_CUT (BREADTH_RTOL / BREADTH_ATOL, BREADTH_SCALE_TOL of the
   tensor's scale for BREADTH_SUM_ORDER, AMP within AMP_NOISE_FACTOR of
   the host's AMP-vs-float32 distance, finite where the host is); no
   kernel of csrc/ launched. Numbers in ``chip_smoke_train.json``;
7l. the rest of the op families: train-mobilenet-ssd
   (`tools/torch_mobilenet_ssd.py`: MobileNet-v1 SSD at 300 x 300, its
   published widths, 21 classes, six maps, 2278 priors, `ssd_loss`,
   RMSProp + L2Decay, float32, TF32 off) SSD_WARMUP + SSD_STEPS steps of
   batch SSD_BATCH on synthetic boxes: losses finite and falling, step
   ms, images/s, rule calls a step, peak memory, and after every timed
   step a traced one (busy share); card vs host SSD_PARITY_STEPS steps
   at SSD_PARITY_BATCH, each from the host's state: losses within
   LOSS_RTOL, match indices and mined negatives equal (the card's free
   run beside, reported); the `is_test` twin (detection_output: NMS
   0.45, top 400, keep 200, score 0.01; detection_map 11point and
   integral; an `evaluator.DetectionMAP`) over SSD_EVAL_BATCHES batches
   on the card, the ground truth as its own detections scoring 1, the
   NMS fed the card's decoded boxes and scores bit-equal on the host,
   and the host's mAP from the same parameters within SSD_MAP_ATOL plus
   one flipped detection's worth of AP a detection row that differs;
   SSD_AMP_STEPS AMP steps (`run_step_parity`); then the bank of the 36
   new ops (`_item6_cases`: the 3-D convs and pools at a C3D conv2
   stage, the resizes, `roi_pool`, the crops, `label_smooth`, the
   [30000, 512] table's `nce` and `hsigmoid`, a CRNN's CTC ops,
   `chunk_eval`, `mean_iou`, quantization, the detection ops at SSD's
   and Faster R-CNN's shapes), each as the breadth bank holds its cases
   (`nce` and `random_crop` by their draws' properties); no kernel of
   csrc/ launched in the phase. Numbers in ``chip_smoke_train.json``;
7m. the transpilers: infer-base-bf16 (Transformer-base at TRAIN_BASE's
   widths built `is_test` with fused attention, saved by
   `save_inference_model`, loaded on the card and rewritten by
   `transpiler.Float16Transpiler()`): every parameter bf16 on the card,
   `prepare(validate="error")` passing the float32 program and finding
   on the transpiled one only the dtype-mismatch errors that the JAX
   package finds on its own, each attention launching the
   flash forward instantiation of its Q's dtype on the host's run of the
   same transpiled dir and no other kernel, the first rows' logits within
   INFER_BF16_TOL of that host run (top-1 equal at a clear gap), beside
   the float32 program in the same call: ms a batch of 64, tokens/s,
   rule calls, parameter bytes and peak memory, top-1 agreement;
   serve-resnet50-folded (serve_resnet50_model's program and state saved,
   loaded on the card, folded there by `InferenceTranspiler`): 53 pairs,
   no batch_norm left, the folded parameters a numpy fold's bit for bit,
   served one-shot beside the unfolded dir: probes within the fold's
   tolerances, then closed-loop traffic on each (images/s, p50, p99) and
   prepared batches of 32 (ms, rule calls), no kernel of csrc/ launched;
   train-base with `memory_optimize`'s marks and without, MEMOPT_STEPS
   steps from one state: losses bit-equal, launches equal; after the
   other traced steps, one traced batch of each (busy share);
7n. the parallel plane: the planner's H100 rates (a bf16 torch.matmul
   at 8192^3, a 2 GiB device copy); the flash forward, dQ and dK/dV
   (float32 and bf16) and the dropout kernel at rank 1's offsets of
   train-base's batch (bh0, base), the whole batch's rows bit for bit and
   the float32 flash kernels against their plain versions there;
   pe-base-1: train-base through `ParallelExecutor(use_cuda=True)` over
   the one-rank mesh, PE_STEPS steps from the Executor's saved state,
   losses bit-equal to the Executor's and the same launches a step; then
   two ranks of this script (`--pe-rank`) that share the card (gloo),
   one world for pe-base-dp2 (batch split 16 / 16, dropout 0.1),
   pe-base-sp2 (dropout 0, ring attention, no flash launch) and
   pe-base-mp2 (each `_ffn1` weight's columns held in halves), each
   PE_RANK_STEPS steps within PE_RTOL / PE_ATOL of the Executor's
   trajectory, with step ms, collectives by kind and bytes and peak
   memory a rank; Trainer(parallel=True) against parallel=False, bit-equal;
7o. the health plane (``observe/``): train-base-observed, train-base
   through `Trainer(pulse_port=0)` with the `observe` flag on for
   OBS_STEPS steps while a `Scraper` reads /metrics, then OBS_OFF_STEPS
   with it off and as many on again: /metrics parses under the strict
   grammar,
   `executor_steps_total` counts the observed runs, `trainer_last_loss`
   is the last loss fetched, /healthz 200, /status' memory section live
   with `peak_bytes_in_use` equal to `torch.cuda.max_memory_allocated()`,
   the launches a step equal with the flag on and off; the step medians
   off and on again, the executor hooks' cost a run (OBS_FLAG_PAIRS
   interleaved runs of a one-fc step), the step log's phase shares and
   the memory estimate
   against the measured peak printed; one step with a weight set to inf
   turns /healthz 503 with the non-finite alert in /flight;
   serve-base-pulse, serve-base through `ServeConfig(pulse_port=0)`:
   /readyz 200 while it serves, no unexpected plan event, launches as in
   phase 4; a child process under a context from `xray.to_wire`: its
   flight dump after an unhandled `torch.cuda.OutOfMemoryError` names the
   error and holds the card's live memory, and its chrome trace stitches
   under the parent's span (one trace, two processes, no orphan);
   ``tools/torch_op_profile.py --measured-check`` at train-base's widths
   and batch and ``tools/torch_paddle_plan.py --devices 1`` (H100) exit 0
   (the two in parallel);
7p. the wire plane (``wire/``, ``transpiler/distribute_transpiler.py``):
   train-base-wire-int8, train-base from one saved state WIRE_STEPS steps
   unquantized, then WIRE_STEPS steps on the same batch through
   `DistributeTranspiler`'s collective path with comm_quant int8: one
   `comm_quant_dequant` an Adam op, the trainer Program verified, the
   residuals zero after the startup and non-zero after the first step,
   losses finite and falling and the last within the JAX tests' band of
   the unquantized run's, launches a step as train-base's, no
   unexpected plan build; the median step with and without comm_quant,
   the op's device time in one traced step and the residuals' bytes;
   one step's gradients through the host codec (int8 at WIRE_CHUNK and
   bf16): `decode_tensor` equal to the returned dequant bit for bit,
   each int8 element within half its chunk's scale, the compression
   ratios; pe-base-1 with `BuildStrategy.comm_quant = "int8"` bit-equal
   to the Executor on the same rewritten Program; pe-base-wire-dp2, two
   ranks of phase 7n's world with comm_quant bf16 (WIRE_DP2_STEPS steps):
   losses in the band of the unquantized run, the collectives a step
   (count and bytes) pe-base-dp2's, the op run whole on every rank; the
   observe CLIs on the card, started after phase 7o (a) and run beside
   the rest of 7o and 7p:
   ``tools/torch_telemetry_dump.py --assert-no-recompiles`` exits 0, and
   1 naming `feed_shape` with ``--two-shapes``;
   ``tools/torch_step_profile.py`` exits 0 with `flash_fwd`, `flash_dq`
   and `flash_dkv` among its top device ops;
7q. the parameter-server plane (``pserver/``, ``haven/``, ``ark/``,
   `Executor.run` on a pserver Program): train-base-ps-sync, train-base
   through `DistributeTranspiler(runtime="pserver")` on two pserver
   processes of this script (`--pserver-child`: each runs
   `Executor(CPUPlace()).run(get_pserver_program(ep))` and reports that
   it never initialized CUDA), PS_TRAINERS `SyncPSTrainer`s in threads,
   each on CUDAPlace(0) with its half of the batch: no `adam` op in a
   trainer Program; PS_PARITY_STEPS steps at dropout 0 whose mean losses
   lie within LOSS_RTOL of the Executor's at the whole batch, and whose
   pulled parameters lie within PS_PARAM_RTOL (relative L2, each) of the
   Executor's grads on the trainers' rows, averaged, under the servers'
   numpy Adam (their distance from the Executor's own parameters, and
   the elements outside tests/test_pserver.py's rtol / atol, printed);
   the flash forward, dQ, dK/dV and delta launched 36 / 18 / 18 / 18 a
   step a trainer; then, from the same state on two more pairs of
   pservers, PS_TIMED_STEPS at dropout 0.1 raw and with comm_quant int8,
   in turn: the step's median, its
   split (pull RPC, the host-to-device copies, the card's step, the
   grad fetch, push, barrier and apply), the wire's bytes a step, the
   int8 losses within the JAX tests' band of the raw job's, the card's
   peak; train-deepfm-ps-async, DeepFM with distributed tables through
   `AsyncPSTrainer` on the first two pservers: the loss falls, each
   push's rows are its batch's unique ids, no kernel launches;
   train-deepfm-ps-haven, the same job with one shard a primary/backup
   pair, the primary killed by `ark.chaos.kill_server` mid-run: every
   step done, the backup promoted, no push applied twice on any server,
   the blip under tools/haven_bench.py's lease + poll + retry budget,
   a retry budget for each call that met the dead primary;
7r. the coordination plane (``quorum/``, ``master/``):
   train-base-elastic, train-base at TRAIN_BATCH stepped by one trainer
   thread through the Executor on CUDAPlace(0) from one saved state, fed
   by `MasterClient(primary, standbys=[standby], quorum_endpoints=...,
   quorum_resource="master0").records(load_chunk)` over
   ELASTIC_BATCHES batch ids (`elastic_batch(i)`, one a task) from a
   primary / standby `Master` pair fenced by three in-process
   `QuorumNode`s (lease ELASTIC_LEASE_S, task timeout ELASTIC_TIMEOUT_S),
   the primary killed by `ark.chaos.kill_master` once ELASTIC_KILL_AFTER
   tasks are done there: the standby promoted within lease + lease/3 +
   2 s, no trainer failure, the pass complete at the promoted master,
   every id delivered and a single-issue task once, at most one issuing
   master at every sample, the quorum promotion metered and in the
   flight recorder, the flash forward, dQ, dK/dV and delta launched
   36 / 18 / 18 / 18 a step, and the losses the same bits as a replay of
   the delivered ids through a fresh Executor from the saved state; the
   promotion time, the trainer's stall across the kill, the step median
   and the sampler's period printed;
7s. disaggregated serving and the fleet (``fleet/``, ``torrent/``; run
   right after 4c, while phase 4's model dirs exist): serve-base-torrent,
   three in-process `ReplicaServer`s behind one `FleetRouter`, each over
   its own `InferenceServer(CUDAPlace(0))` on 4b's int8 dir, p0 with
   role prefill and d0 / d1 with role decode; one lone request first
   (the longest prompt), then 4b's INT8_REQUESTS prompts through
   `FleetRouter.generate_torrent` from TORRENT_CLIENTS threads, d1 killed
   (`ReplicaServer.kill()`) once TORRENT_KILL_AFTER generations completed:
   no request fails, every request's tokens equal 4b's card tokens or
   differ at a near tie under 4b's teacher-forced rule, the lone
   request's rows and scales on its decode replica equal those p0
   extracted bit for bit (both scopes read at their block ids), p0 ran
   every prefill step and the decode replicas none, the flash forward
   launched once a layer a p0 prefill step and the int8 paged decode once
   a layer a decode step (the float32 paged decode never),
   `fleet_affinity_sessions` back at 0, KV bytes metered,
   `torrent_generations_total{outcome="ok"}` one a request, at least one
   decode failover metered; serve-base-torrent-fp32, phase 4's
   N_REQUESTS prompts over a fresh p0 / d0 pair on phase 4's float32 dir,
   the rows through the wire's lossy int8 codec: every first token equal
   to phase 4's, the injected rows equal to the host codec's decode of
   p0's bit for bit, the flash forward and the float32 paged decode
   launched once a layer a step; the end-to-end TTFT (median, p99),
   tokens a second, KV bytes a request, the stream's ms and each
   re-prefill after the kill printed, with the later tokens' share equal
   to phase 4's in the fp32 arm;
7t. the C inference ABI (``capi/``, ``capi_runtime``): infer-base (7m's
   saved float32 dir) through libpaddle_tpu_capi.so built from the
   checkout, the place variable unset (CUDAPlace(0)): in this process by
   ctypes, CAPI_BATCHES batches of CAPI_BATCH x seq from DATA_SEED
   through `PD_PredictorRun`, the logits bit for bit those of
   `capi_runtime.Predictor.run` and of the Executor's prepared run of the
   loaded program, and 18 flash forward launches a batch (one a fused
   attention) and no other kernel; then a pure-C client compiled with
   gcc against the port's header, in a process of its own: it starts its
   interpreter through the ABI, creates the predictor on its main thread
   and runs the first batch from a second pthread, and its first row of
   logits equals the in-process run's bit for bit (where this machine's
   Python has no shared libpython to embed, that fact is printed and the
   client is not run); the ms a batch through the ABI against the
   prepared run, the library's build and the client's time to its first
   result printed;
7u. the serving kernels at every head dim the JAX kernels take (a
   multiple of 8 up to 256): the float32 flash forward and both paged
   decode kernels at D 8, 16, 24, 80, 96, 136 and 256 (the padded
   instantiations' widths and head dims padded into them) as phase 3
   checks them at D 64 (within TOL, two launches bit-equal, the paged
   poison and seq_len 0; kernel, plain, SDPA and bound), at serve-base's
   width (H = 512 // D) and on a ragged T 200, and at T 8192 (flash) and
   seq_lens up to 8192 (paged) at D 8 and 256; then serve-base-d8 (64
   heads of 8, the JAX tiny LM's head dim) and serve-base-d256 (2 heads of
   256), each with fp32 KV (phase 4's requests and gates: launches, tokens
   and prefill logits against the host) and int8 KV (serve-base-int8's
   slots, blocks, requests and gates: launches, the longest request
   teacher-forced against the host, first tokens equal to the float32
   run's), through `InferenceServer.submit_generate` as phase 4 serves.
   Their host side (the saves
   and host runs) runs in a child process from before phase 3 on, so that
   it overlaps the kernel checks;
7v. the training kernels at every head dim the JAX kernels take: the
   flash forward, dQ, dK/dV and delta kernels in float32 and bf16 at D 8,
   16, 24, 80, 96, 136 and 256 against their plain versions as phases 3
   and 3b check them at D 64 (within TOL / BWD_TOL or the bf16 rule, two
   launches bit-equal), at train-base's attention (B 32, T 256,
   H = 512 // D) causal and not at rate 0 and 0.1 (the first case timed:
   kernel, plain, SDPA, bound) and on a ragged T 200; then train-base-d8
   (64 heads of 8) and train-base-d256 (2 heads of 256), 5 steps each in
   float32 and under AMP (loss finite and falling, launch counts exact);
   then each at one layer and batch 2, card against host by
   run_step_parity (one step from one state: float32 within LOSS_RTOL,
   AMP by its noise rule, and the state after the step);
8. print one JSON line with every kernel's numbers (the bf16
   instantiations beside the float32 ones), and write the runs' numbers
   to ``chiprun_out/chip_smoke_train.json``.

Float32 matrix products run in full float32 (TF32 off, set below); under
AMP an executor asks cuBLAS for float32 sums of bf16 products
(``core/executor.py``).

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
printed only when every phase passed. Without a card, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

SEED = 0
WEIGHT_SEED = 11    # serve-base's random weights
TOL = 1e-4         # kernel vs plain version: f32 summation order + expf
# backward kernels vs the plain backward: |a - b| <= BWD_TOL (1 + |b|).
# dQ, dK and dV are sums over T of products of f32 sums over D, taken in
# another order than cuBLAS takes the plain version's
BWD_TOL = 1e-4
LOGIT_TOL = 1e-3    # card vs host prefill logits through 6 layers
# card vs host losses of train-base: f32 summation order through ~1000 ops
# a step, amplified by Adam's division by sqrt(v) for the smallest grads
LOSS_RTOL = 1e-3
PEAK_F32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12    # H100 SXM, TF32 on the tensor cores, dense
# the flash kernels take each f32 product as three TF32 products
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
SERVE_BASE = dict(vocab=30000, d_model=512, n_heads=8, n_layers=6,
                  max_slots=8, block_size=16, max_context=1024,
                  prefill_rows=(1, 2, 4), prefill_seq_rungs=(128, 256, 512),
                  kv_dtype="fp32")
N_REQUESTS, NEW_TOKENS = 8, 32
# serve-base-int8: serve-base's widths with the int8 KV residency; its
# cache is sized from serve-base's float32 byte budget, which seats 32
# slots at the full context
INT8_SLOTS = INT8_REQUESTS = 32
# Card vs host over an int8 cache. The card's GEMMs sum in another order
# than the host's, so a K/V value within ~1e-6 of a rounding boundary takes
# the neighbouring int8 bin on one side: the two caches differ by one bin
# in a small share of their values, where float32 caches differ by ~1e-6.
# A greedy pick at a near-tie can then differ. The longest request, and
# every request whose tokens differ, is replayed on both teacher-forced on
# the host's tokens: the logits must agree within this (the float32 path's
# LOGIT_TOL; on an H100 a 500-token request read 2e-7, with 43 of 3.3 M
# cached values one bin apart), and where tokens differ the host's logits
# of the two picks at the first differing step must lie within twice this.
Q8_LOGIT_TOL = LOGIT_TOL
Q8_MAX_BIN_DIFF = 2     # a flip, and a flip carried through a requantize
TRAIN_BASE = dict(src_vocab_size=30000, trg_vocab_size=30000, seq_len=256,
                  n_layer=6, n_head=8, d_model=512, d_inner=2048,
                  dropout_rate=0.1, fused_attention=True)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 32, 10, 1e-3
# a card-vs-host parity step runs the model's step on the host too, the
# script's largest host cost beside the serving references: two steps,
# the second from the first's optimizer state
PARITY_BATCH, PARITY_STEPS = 2, 2
DATA_SEED = 21      # the fixed training batch
ATTN_SEED = 12345   # attention-dropout seed of the kernel checks
# train-resnet50: the JAX package's headline benchmark as bench.py builds
# it (bench_resnet: depth 50, 1000 classes, 224 x 224 x 3 NHWC, batch 128,
# Momentum(0.1, 0.9)), in float32 with TF32 off
RESNET50 = dict(class_dim=1000, depth=50, data_format="NHWC",
                image_shape=(3, 224, 224))
RESNET_BATCH, RESNET_STEPS, RESNET_LR, RESNET_MOMENTUM = 128, 10, 0.1, 0.9
# card vs host: ResNet-50 at batch 2, PARITY_STEPS steps on one batch at a
# learning rate at which no loss falls below 0.1 (at 0.1 a batch of 2
# reaches cross_entropy's clamp, -log(1e-8) = 18.42 a sample, within a few
# steps, and relative errors say nothing there); the MNIST CNN
# at batch 16 with Adam. Each step starts both sides from the host's state
# after the step before. A free run would compare chaos: ResNet-50's grads
# jump where a ReLU input or a small-variance batch norm lies within
# rounding of its edge: on the JAX package alone (CPU, 224 x 224, batch
# 2; tools/resnet_float32_sensitivity.py) scaling the stem's filter by
# (1 + 1e-7) moves the third step's loss by 1.0 % at lr 1e-3 and 0.2 % at
# 1e-4, the first step's by 2.2e-6.
RESNET_PARITY_BATCH, RESNET_PARITY_LR = 2, 1e-3
MNIST_PARITY_BATCH, MNIST_LR = 16, 1e-3
# card vs host after each parity step. Running means and variances, as
# the losses (each an average of a layer's batch statistics):
# |card - host| <= BN_STAT_ATOL + LOSS_RTOL * |host|. Every other
# persistable (parameters, velocities, Adam moments): relative L2 distance
# at most STATE_L2_RTOL; a velocity is the step's grad, which moves by
# 2.5 % (median over ResNet-50's 161; the largest 3.2 %) on the JAX
# package alone under the perturbation above.
BN_STAT_ATOL = 1e-4
STATE_L2_RTOL = 0.1
# bf16 mixed precision (Executor(amp=True)), the configuration bench.py
# measures. bf16 kernels vs their bf16 plain versions, per element: the
# forward kernel rounds P to bf16 against its key tile's running max, the
# plain version against the row's, so each term of P V lands up to half a
# bf16 ulp apart, and an output sums them at its row's scale; dS and W_drop
# round from float32 values summed in another order; and the output's own
# rounding can fall an ulp apart. So an element may lie BF16_ULPS bf16 ulps
# of |plain| plus BF16_ROW_TOL times its row's max |plain| (a row: one
# query's, or one key's, D values) from the plain value, plus BF16_ATOL
# times the tensor's max |plain| where float32 cancellation leaves the
# plain value 0 (a causal first row's dQ: the kernel reads ~1e-6). On an
# H100 at B 64 the largest error over its row's max was 0.0087, and the
# largest share of this tolerance 0.47. lse is float32 from exact bf16
# products
PEAK_BF16_FLOPS = 989e12    # H100 SXM, bf16 on the tensor cores, dense
BF16_ULPS, BF16_ROW_TOL, BF16_ATOL = 1, 2.0 ** -6, 2.0 ** -16
# A head dim padded into a wider bf16 kernel (phase 7v: D 8 in the width
# 32) has rows of few outputs: where they cancel far below the terms of
# P V, the row term above no longer scales with the terms' rounding. On
# an H100 one forward element at D 8 of 4.2 M (B 32, H 64, T 256, rate 0)
# lay at 1.06 of the rule: kernel -0.00872803, plain -0.00909424, float64
# -0.00890895, its row's largest |O| 0.0162; the kernel was bit-equal to
# the exact D 32 kernel on zero-padded inputs. At those head dims an
# element beyond the rule passes when it lies no further from the float64
# value than the plain version does, at most this share of the elements
BF16_BY_ACCURACY_SHARE = 1e-6
LSE_TOL = 1e-4
# train-base-amp: bench.py's batch (64), at which the bf16 kernels are
# also checked; the pallas run is shorter. Of its gated dropout ops, the
# two right after the embeddings stay float32 under AMP (their input, an
# embedding plus the position table, meets no op of the policy's bf16
# set) and launch the float32 kernel, as the JAX package runs them
TRAIN_AMP_BATCH, TRAIN_AMP_PALLAS_STEPS = 64, 4
AMP_FLOAT32_DROPOUT_OPS = 2
# card vs host under AMP, per step from the host's state: each bf16
# product's output rounds to bf16 after a float32 sum taken in another
# order on each side, so one in a few hundred outputs lands one bf16 ulp
# (2^-8) apart, and the step carries that through every layer. How far
# that goes depends on the model, so both are held to bf16's own effect
# on the host: the host also takes each step in float32 from the same
# state. The card's losses lie within AMP_NOISE_FACTOR times the host's
# AMP-vs-float32 loss distance of the host's (or within AMP_LOSS_RTOL,
# about 4 x the Transformer's reading): on an H100, Transformer-base at
# batch 2 read 1.2e-5 against a host distance of 8.7e-6, ResNet-50 at
# batch 2 (224 x 224, where batch norm sees 2 images) 1.1e-2 against
# 2.3e-2. The loss cannot tell a card that ran float32 from one that ran
# bf16 (the Transformer's float32 step lies 7.2e-6 from its AMP step),
# so the output of every op of the policy's bf16 set is held to bf16 on
# the card's AMP step (and to float32 on its float32 step). For each kind
# of state (parameters, running stats, each optimizer slot), the largest
# relative L2 distance between card and host lies within AMP_NOISE_FACTOR
# times the largest between the host's AMP and float32 steps: bf16 moves a
# grad far from its float32 value where it is a sum that cancels (the
# JAX package's own AMP grads of a small ResNet lie 13 % from its
# float32 ones at the median, 26 % at worst), and an Adam step flips the
# sign of an update wherever a grad is near 0. tests/test_torch_amp.py
# holds the port against the JAX package so (largest ratio seen: 1.5)
AMP_LOSS_RTOL = 5e-5
AMP_NOISE_FACTOR = 2.0
# the AMP parity's steps (PARITY_STEPS, 2, until phase 7v's card-vs-host
# parity came: 14 s of the script on an H100's host)
AMP_PARITY_STEPS = 1
# forward, dQ and dK/dV x D 32/64/128 x rate 0/dropout x float32/bf16,
# the bf16 forward's causal instantiations (D x rate 0/dropout), the float32
# kernels' padded ones (widths 8/16/32/64/96/128/256 x rate 0/dropout, dK/dV
# at 256 as its dV and dK launches) and the bf16 kernels' width 256 (the
# forward causal and not, dK/dV as two launches): 20 + 20 + 22 float32,
# 16 + 8 + 10 bf16
FLASH_INSTANTIATIONS = 96
# the JAX package computes delta in XLA, outside its Pallas kernels
DELTA_REPLACES = "paddle_tpu/ops/pallas_attention.py:387 (XLA, no Pallas kernel)"
# the delta kernel vs its plain version: the same float32 sum of D exact
# (bf16) or once rounded (float32) products, in another order, so a row
# lies within this share of its sum of |dO O|
DELTA_TOL = 1e-5
# train-base-unfused: Transformer-base with fused_attention=False, at
# train-base's batches (float32 32, AMP 64) and steps under both dropout
# flags. Each of its 18 attentions keeps [B, 8, 256, 256] scores, weights
# and dropped weights, and under `pallas` its weight dropout (a minor dim
# of 256) launches the dropout kernel in the forward and again in the grad
# (3 steps: 10 until phase 7t came, 5 until phase 7v came; the gates hold
# a step). Its card-vs-host parity takes one step a precision
# (PARITY_STEPS, 2, until phase 7v came: 28.8 s of the script on an H100's
# host)
UNFUSED_STEPS = 3
UNFUSED_PARITY_STEPS = 1
# train-se_resnext50: SE-ResNeXt-50 32x4d as the JAX package builds it,
# 224 x 224 NHWC, 1000 classes, float32 with TF32 off, at train-resnet50's
# batch; trained by the PaddlePaddle/models image-classification recipe,
# Momentum(0.9) on piecewise_decay with L2Decay(1e-4): the smoke's 10
# steps cross both boundaries, so `increment`, the comparisons and the
# regularizer run on the card
SE_RESNEXT50 = dict(class_dim=1000, depth=50, image_shape=(3, 224, 224),
                    data_format="NHWC")
SE_BATCH, SE_STEPS = 128, 10
SE_LR_BOUNDARIES, SE_LR_VALUES = [3, 6], [0.1, 0.01, 0.001]
SE_L2, SE_MOMENTUM = 1e-4, 0.9
# train-vgg16: VGG-16 with batch norm on CIFAR-10's shape, batch 128, with
# Adam(1e-3) as the reference's benchmark/fluid/models/vgg.py trains it;
# its dropouts are downgrade_in_infer, which the dropout kernel's gate
# refuses: it runs under `pallas` and no kernel may launch
VGG16 = dict(class_dim=10, image_shape=(3, 32, 32))
VGG_BATCH, VGG_STEPS, VGG_LR = 128, 10, 1e-3
# train-deepfm: models.deepfm.build() at its defaults (26 fields, 1e5
# features, embedding 16, 13 dense features, 400 x 3) with Adagrad(0.01)
# under GradientClipByGlobalNorm(10); batch 512 is this smoke's choice
DEEPFM_BATCH, DEEPFM_STEPS, DEEPFM_LR, DEEPFM_CLIP = 512, 10, 0.01, 10.0
# the optimizer sweep: a three-layer fc net 512 wide (512 -> 512 -> 512 ->
# 10), batch 64, SWEEP_STEPS steps from one state on the card and on the
# host, through every optimizer class, ModelAverage, every schedule,
# append_LARS, every clip and a per-parameter learning rate. Both sides
# take float32 products (TF32 off) summed in another order: losses within
# SWEEP_LOSS_RTOL relative, each persistable within SWEEP_STATE_L2 relative
# L2 (an Adagrad-family update divides a grad by about its own size, so a
# grad within ~1e-6 of 0 carries the summation noise into a few of its
# elements' updates; tests/test_torch_optim.py shows the same on the host)
SWEEP_WIDTH, SWEEP_BATCH, SWEEP_STEPS = 512, 64, 3
SWEEP_LOSS_RTOL, SWEEP_STATE_L2 = 1e-5, 1e-4
# train-stacked-lstm: BASELINE.json's "Stacked dynamic LSTM LM" as bench.py
# measures it (bench_stacked_lstm): models.stacked_dynamic_lstm.build() at
# its defaults (dict 30000, embedding 512, 3 LSTMs of 512 with peepholes,
# max pooling, 2 classes), Adam(1e-3), batch 64 padded to 100 steps, ids
# and lengths (uniform in [50, 100]) from RandomState(0), float32 and
# under AMP. No kernel of csrc/ lies on this path: the LSTM's time loop
# is PyTorch ops, one step at a time (ops/rnn.py)
LSTM = dict(dict_size=30000, emb_dim=512, hidden_dim=512, stacked_num=3)
LSTM_BATCH, LSTM_SEQ, LSTM_LR, LSTM_DATA_SEED = 64, 100, 1e-3, 0
LSTM_WARMUP, LSTM_STEPS = 3, 10
# card vs host, PARITY_STEPS steps each from the host's state (LOSS_RTOL,
# STATE_L2_RTOL): embedding 64, 2 LSTM layers 64 wide, the second
# reversed, batch 4 padded to 12 steps, lengths 1, 12 and two between
LSTM_PARITY_DICT, LSTM_PARITY_WIDTH = 200, 64
LSTM_PARITY_LENS = (1, 12, 5, 9)
# each sequence op and gru / lstmp / lstm_unit / gru_unit: card vs host
# from one state, one step with its grads, each element within
# SEQ_OP_TOL (1 + |host|) (float32 sums of a few dozen terms, another
# order on each side); integer outputs exactly
SEQ_OP_TOL = 1e-5
# train-mt: BASELINE.json's "Fluid machine_translation" at the reference's
# Fluid benchmark widths (benchmark/fluid/models/machine_translation.py:
# embedding, encoder and decoder 512, dictionary 30000), not the JAX
# defaults; Adam(1e-3), float32 with TF32 off, batch 64, source lengths
# uniform in [10, 50] from RandomState(0), target and label padded to 50
MT = dict(dict_size=30000, emb_dim=512, hidden_dim=512)
MT_BATCH, MT_SRC_MIN, MT_SRC_MAX, MT_TRG = 64, 10, 50, 50
MT_LR, MT_DATA_SEED, MT_WARMUP, MT_STEPS = 1e-3, 0, 3, 10
# infer-mt-beam: beam 4, max_len 50, 16 sources; card vs host, ids exact,
# scores within MT_SCORE_RTOL relative; a diverging row passes only where
# both sides' scores at that step lie within MT_TIE of each other
MT_BEAM, MT_MAX_LEN, MT_DECODE_BATCH, MT_DECODE_RUNS = 4, 50, 16, 3
MT_SCORE_RTOL, MT_TIE = 1e-4, 1e-5
# serve-resnet50: bench.py's ResNet-50 (RESNET50) built for inference
# (`is_test`), random weights from SEED, batch-norm running statistics a
# calibration batch's perturbed from RandomState(DATA_SEED)
# (serve_resnet50_model), served one-shot
# on the card by InferenceServer's MicroBatcher: rows ladder 1..32, the
# default 2 ms batch window, a closed loop of 16 client threads issuing 640
# requests of 1-8 images (sizes and images from RandomState(DATA_SEED); the
# images are rows of a pool of SERVE_RN50_POOL). In the same traffic v2
# (every parameter x 1.01) is staged with prepare_swap and published with
# commit_swap halfway, and v3 (x 1.02) is saved over the served dir and
# picked up by the dir watcher
SERVE_RN50_LADDER = (1, 2, 4, 8, 16, 32)
SERVE_RN50_CLIENTS, SERVE_RN50_REQUESTS, SERVE_RN50_MAX_IMAGES = 16, 640, 8
SERVE_RN50_POOL, SERVE_RN50_CALIB = 256, 8
SERVE_RN50_SCALES = (1.0, 1.01, 1.02)       # v1, v2, v3
# the probes: run solo on the card and on the host, and coalesced (with
# filler rows) into one batch of the top rung on the card
SERVE_RN50_PROBES, SERVE_RN50_FILLERS = (1, 3, 8, 2, 5, 1), (8, 4)
SERVE_RN50_SWAP_PROBE = 1                   # the probe resubmitted after a flip
# card vs host, and a probe's rows coalesced vs solo: softmax
# probabilities over 1000 classes through 53 float32 convs (TF32 off),
# summed in another order on each side and by another cuDNN algorithm at
# another batch size. With random weights the softmax is near one-hot
# (logits about +-200, top-1 gaps above 20), so beside the probabilities
# (within SERVE_RN50_PROB_TOL) the log-probabilities above 1e-30, which
# carry the logits less their log-sum-exp, are held to
# SERVE_RN50_LOGP_TOL (1 + |log p|). On an H100 the largest readings were
# 1.2e-11 and 1.1e-5 (1 + |log p|) (card vs host and coalesced vs solo);
# v2 against v1 reads 2.6 (1 + |log p|) on the log-probabilities while
# its probabilities differ by only 1.2e-7
SERVE_RN50_PROB_TOL, SERVE_RN50_LOGP_TOL, SERVE_RN50_LOGP_FLOOR = \
    1e-6, 1e-4, 1e-30
# serve-base-swap: serve-base (v1) and a v2 from SWAP_WEIGHT_SEED; 4
# requests on v1 generating SWAP_V1_TOKENS each (long enough that they
# still decode when v2 is committed), then 4 on v2
SWAP_WEIGHT_SEED = WEIGHT_SEED + 1
SWAP_V1_LENS, SWAP_V2_LENS = (40, 100, 160, 220), (60, 120, 180, 240)
SWAP_V1_TOKENS, SWAP_V2_TOKENS = 200, NEW_TOKENS
# the book (tools/torch_book.py): BOOK_WARMUP + BOOK_STEPS steps a
# chapter at torch_book.CARD's widths; card vs host BOOK_PARITY_STEPS
# steps from the host's state, the image chapters (batch-norm networks,
# chaotic at small batches; see train-resnet50's parity) at
# BOOK_PARITY_BATCH; a classifier's top-1 may differ from the host's only
# in a row whose host top-two lie within BOOK_TIE of each other
BOOK_WARMUP, BOOK_STEPS, BOOK_PARITY_STEPS = 3, 20, 3
BOOK_PARITY_BATCH = {"recognize_digits": 8, "image_classification": 8}
BOOK_TIE = 1e-5
# phase 7k (a): train-deepfm (DEEPFM_* above) with `layers.auc` at its
# defaults (200 thresholds) on its prediction, DEEPFM_STEPS steps on the
# host from one state, a new batch each step (DATA_SEED + step), each
# step also on the card from the host's state before it. A free run
# drifts (the card's run from the same state is reported beside the
# host's: a prediction a few 1e-6 from a bucket's edge crosses it within
# a few steps), so the histograms are held per step. Each step's histograms
# must be equal on both sides; a prediction may fall in another bucket
# only where the host's p * 200 lies within AUC_BUCKET_TIE of a bucket's
# edge (reported as a tie)
AUC_TOL, AUC_BUCKET_TIE = 1e-6, 1e-4
# phase 7k (b): the breadth bank. Elementwise, activation, reduction and
# loss ops on [BREADTH_ROWS, BREADTH_WIDTH] float32 (B 32 x T 256 rows at
# Transformer-base's FFN width); gather / scatter / gather_nd / one_hot
# on a [30000, 512] table with BREADTH_IDS ids; the shape ops on
# [32, 8, 256, 64]; the vision ops at ResNet-50 / AlexNet stage widths.
# Inputs carry exact zeros and ties (a quarter of each float tensor lies
# on multiples of 0.5). Two runs on the card bit-equal at full size; card
# vs host with the rows (or the batch) cut by BREADTH_CUT, widths kept:
# floats within BREADTH_RTOL relative / BREADTH_ATOL absolute, or, for the
# ops that sum in another order on the card (BREADTH_SUM_ORDER), within
# BREADTH_SCALE_TOL of the tensor's largest magnitude; integers equal;
# finite wherever the host is. Under AMP (the two convs) the card within
# AMP_NOISE_FACTOR x the host's own AMP-vs-float32 distance (relative L2)
BREADTH_ROWS, BREADTH_WIDTH, BREADTH_TABLE, BREADTH_IDS = \
    8192, 2048, (30000, 512), 8192
BREADTH_4D = (32, 8, 256, 64)
BREADTH_CUT, BREADTH_TIMED = 8, 3
BREADTH_RTOL, BREADTH_ATOL, BREADTH_SCALE_TOL = 1e-4, 1e-6, 1e-5
BREADTH_SUM_ORDER = {"cumsum", "cumsum_exclusive_reverse", "scatter_add",
                     "pad2d_reflect", "pad2d_edge", "depthwise_conv2d",
                     "conv2d_transpose", "depthwise_conv2d_amp",
                     "conv2d_transpose_amp", "gather", "gather_nd",
                     "grid_sampler",
                     # phase 7l's cases (below): cuDNN's 3-D convs and
                     # their grads, the grads that add into a gathered
                     # table or image, log-space and precision sums
                     "conv3d", "conv3d_transpose", "pool3d_avg",
                     "bilinear_up", "bilinear_down", "roi_pool", "nce",
                     "hierarchical_sigmoid", "warpctc", "im2sequence",
                     "detection_map", "softmax_ce_no_reduce",
                     "box_encode_per_prior"}
# phase 7l: the rest of the op families. train-mobilenet-ssd
# (tools/torch_mobilenet_ssd.py: MobileNet-v1 SSD at 300 x 300, its
# published widths, 21 classes, 2278 priors, RMSProp(0.001) + L2Decay
# (5e-5), float32 with TF32 off): SSD_WARMUP + SSD_STEPS steps of batch
# SSD_BATCH cycling over SSD_DATA_BATCHES synthetic batches from
# DATA_SEED; card vs host SSD_PARITY_STEPS steps at SSD_PARITY_BATCH from
# one state, each step from the host's state (losses within LOSS_RTOL,
# the match indices and mined negatives equal), beside the card's free
# run from the same state (drift reported, not gated); the is_test
# program's detection_output + detection_map over SSD_EVAL_BATCHES
# batches, the NMS and detection_map fed the card's inputs equal on both
# sides, and the end-to-end mAP on the host within SSD_MAP_ATOL: the
# card's scores lie ~1e-6 from the host's (cuDNN's sum order), which can
# reorder detections at near-ties only (the rows whose label or box
# differs are reported), and such a row near the tail of an image's 200
# moves AP by far less; an AMP run of SSD_AMP_STEPS steps at
# SSD_AMP_BATCH (run_step_parity)
SSD_BATCH, SSD_WARMUP, SSD_STEPS, SSD_DATA_BATCHES = 32, 3, 20, 4
SSD_PARITY_BATCH, SSD_PARITY_STEPS = 8, 3
SSD_EVAL_BATCHES, SSD_AMP_BATCH, SSD_AMP_STEPS = 4, 4, 5
SSD_MAP_ATOL = 1e-3
# phase 7m: the transpilers. infer-base-bf16: Transformer-base at
# TRAIN_BASE's widths built `is_test` with fused attention, saved by
# save_inference_model (target `logits`) from SEED, loaded on the card and
# rewritten by Float16Transpiler (bfloat16), INFER_BASE_BATCHES timed
# batches of INFER_BASE_BATCH against the untranspiled float32 program in
# the same call (alternated: float32, bf16, bf16, float32). Each fused
# attention launches the flash forward instantiation of its Q's dtype on
# a host run of the same transpiled dir (the position table's float32
# makes that float32 in both packages: ROADMAP Queue 3). The first
# INFER_BASE_HOST_ROWS rows' logits lie within INFER_BF16_TOL of the
# largest |host logit| of the host's run of the same transpiled dir (one
# bf16 ulp at 1: what a bf16 product path may move; the float32 path reads
# far inside it), top-1 equal wherever the host's top-2 gap exceeds it
INFER_BASE_BATCH, INFER_BASE_BATCHES, INFER_BASE_HOST_ROWS = 64, 8, 4
INFER_BF16_TOL = 2.0 ** -8
# serve-resnet50-folded: serve_resnet50_model's program and state, saved,
# loaded on the card, folded there by InferenceTranspiler (53 pairs), saved
# and served one-shot beside the unfolded dir by one InferenceServer
# (SERVE_RN50_LADDER, the default window): the probes folded vs unfolded on
# the card, top-1 equal where the unfolded top-2 probability gap exceeds
# FOLD_TIE, probabilities within FOLD_PROB_TOL and log-probabilities above
# SERVE_RN50_LOGP_FLOOR within FOLD_LOGP_TOL (1 + |log p|): the fold
# reassociates each conv's float32 products with gamma / std (1.5e-06 of
# the logits' scale on a small ResNet-50 on the host,
# tests/test_torch_transpiler.py); then FOLD_REQUESTS requests of 1-8
# images from SERVE_RN50_CLIENTS closed-loop clients on each model
# (unfolded, folded, folded, unfolded), and FOLD_BATCHES prepared runs of a
# batch of SERVE_RN50_LADDER[-1] images on each
FOLD_TIE, FOLD_PROB_TOL, FOLD_LOGP_TOL = 1e-4, 1e-5, 1e-3
FOLD_REQUESTS, FOLD_BATCHES = 320, 10
# train-base with memory_optimize (level 1: the activations, mul and
# matmul marked): MEMOPT_STEPS steps at MEMOPT_BATCH from one state with
# the marks and without, losses bit-equal and the launch counts equal
MEMOPT_BATCH, MEMOPT_STEPS = 8, 3


def log(*a):
    print(*a, flush=True)


def _l2_flusher(torch):
    buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    return lambda: buf.zero_()


HOLD_CYCLES = 4_000_000    # ~2 ms spin at the H100's clocks


def time_ms(torch, fn, flush, iters=20, warmup=3):
    """Median CUDA-event time of one call of `fn` on a cold L2. Before each
    timed call the stream is flushed and then held by a ~2 ms spin
    (`torch.cuda._sleep`), so the host has enqueued the whole call before
    the first event fires: the interval holds the device work of `fn`, not
    the Python and launch overhead of enqueueing it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(HOLD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def check_flash(torch, fa, flush, rows, T, H=8, D=64):
    """One flash case: returns its numbers."""
    g = torch.Generator(device="cuda").manual_seed(SEED + rows * 1000 + T)
    q, k, v = (torch.randn(rows, H, T, D, device="cuda", generator=g)
               for _ in range(3))
    sm = D ** -0.5
    out, lse = fa._flash_forward(q, k, v, True, sm)
    ref = fa._attention_reference(q, k, v, True, sm)
    ref_lse = fa._lse_reference(q, k, True, sm)
    torch.cuda.synchronize()
    err = max(float((out - ref).abs().max()), float((lse - ref_lse).abs().max()))
    if not err <= TOL:
        raise AssertionError(f"flash rows={rows} T={T}: max error {err} > {TOL}")
    _assert_repeats(torch, f"flash_fwd rows={rows} T={T}", (out, lse),
                    fa._flash_forward(q, k, v, True, sm))
    ms = time_ms(torch, lambda: fa._flash_forward(q, k, v, True, sm), flush)
    plain = time_ms(torch, lambda: fa._attention_reference(q, k, v, True, sm),
                    flush)
    lib = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=sm), flush)
    flops = 2.0 * rows * H * T * T * D                      # causal half
    nbytes = (4.0 * rows * H * T * D + rows * H * T) * 4     # q,k,v,o + lse
    bound, by = _bound(flops, nbytes, PEAK_3XTF32_FLOPS)
    return dict(rows=rows, T=T, err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bound, bound_by=by,
                bound_cuda_core_ms=_bound(flops, nbytes)[0])


def _assert_repeats(torch, tag, first, second):
    """Two launches on the same inputs must give equal bits."""
    for a, b in zip(first, second):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{tag}: two launches on the same inputs "
                                 f"differ")


FORWARD_EDGE_CASES = (("peaked", TRAIN_BATCH, 256, 64, 4.0),
                      ("ragged_d32", 4, 200, 32, 1.0),
                      ("ragged_d64", 4, 200, 64, 1.0),
                      ("ragged_d128", 4, 200, 128, 1.0))


def check_flash_forward_edges(torch, fa, cases=FORWARD_EDGE_CASES):
    """The forward where its tiling and its arithmetic are pressed: by
    default peaked scores (q and k scaled by 4, so W is near one-hot and
    S's error goes through exp() at 16 times the spread) at the train
    shape, and a ragged T 200 (a multiple of neither the 64-row query tile
    nor the 32-row K/V tile) at D 32, 64 and 128; causal and not, rate 0.1.
    `cases`: (name, B, T, D, scale) each. Each within TOL on out and lse,
    two launches bit-equal. Returns the max errors."""
    errs = {}
    for name, B, T, D, scale in cases:
        for causal in (False, True):
            g = torch.Generator(device="cuda").manual_seed(SEED + 11 * D + T)
            q, k, v = (torch.randn(B, 8, T, D, device="cuda", generator=g)
                       for _ in range(3))
            q, k = q * scale, k * scale
            sm = D ** -0.5
            out, lse = fa._flash_forward(q, k, v, causal, sm, 0.1, ATTN_SEED)
            ref = fa._attention_reference(q, k, v, causal, sm, 0.1, ATTN_SEED)
            ref_lse = fa._lse_reference(q, k, causal, sm)
            torch.cuda.synchronize()
            tag = f"flash_fwd {name} B={B} T={T} D={D} causal={causal}"
            err = max(float((out - ref).abs().max()),
                      float((lse - ref_lse).abs().max()))
            if not err <= TOL:
                raise AssertionError(f"{tag}: max error {err} > {TOL}")
            _assert_repeats(torch, tag, (out, lse), fa._flash_forward(
                q, k, v, causal, sm, 0.1, ATTN_SEED))
            errs[f"{name}{'_causal' if causal else ''}"] = err
    return errs


def _bound(flops, nbytes, peak=PEAK_F32_FLOPS):
    """(ms, what bounds it) for `flops` operations at `peak` per second
    (f32 on the CUDA cores unless told otherwise) and `nbytes`."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                        else "bytes")


def check_delta(torch, fa, flush, out, do, timed=True):
    """The delta kernel on one (O, dO) pair against its plain version: each
    row within DELTA_TOL of its sum of |dO O|, two launches bit-equal;
    returns its numbers (the largest share of that tolerance and, when
    `timed`, times, the byte bound and, for float32, `torch.linalg.vecdot`
    as the one PyTorch call that computes the same function; in bf16 none
    returns float32)."""
    got = fa.flash_delta(out, do)
    want = fa._flash_delta_reference(out, do)
    torch.cuda.synchronize()
    scale = (do.float() * out.float()).abs().sum(-1)
    share = float(((got - want).abs() / scale.clamp_min(1e-30)).max()
                  / DELTA_TOL)
    tag = f"flash_delta {tuple(out.shape)} {out.dtype}"
    if not share <= 1.0:
        raise AssertionError(f"{tag}: a row at {share:.3g} of its tolerance "
                             f"({DELTA_TOL} x sum |dO O|)")
    _assert_repeats(torch, tag, (got,), (fa.flash_delta(out, do),))
    res = dict(delta_err=float((got - want).abs().max()), delta_share=share)
    if not timed:
        return res
    res["delta_ms"] = time_ms(torch, lambda: fa.flash_delta(out, do), flush)
    res["delta_plain_ms"] = time_ms(
        torch, lambda: fa._flash_delta_reference(out, do), flush)
    res["delta_library_ms"] = (time_ms(torch, lambda: torch.linalg.vecdot(
        do, out), flush) if out.dtype == torch.float32 else None)
    rows = out.numel() // out.shape[-1]
    # a multiply-add an element on the f32 CUDA cores; each input read
    # once, a float32 a row written
    res["delta_bound_ms"], res["delta_bound_by"] = _bound(
        2.0 * out.numel(), 2.0 * out.numel() * out.element_size()
        + 4.0 * rows)
    return res


def check_train_kernels(torch, fa, flush, B, H, T, D, causal, rate,
                        timed=True):
    """The training path's three kernels at one shape: the forward with
    attention dropout, dQ and dK/dV, each against its plain version on the
    same inputs; returns their numbers (the times and bounds only when
    `timed`)."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(SEED + 7 * T + int(causal))
    q, k, v, do = (torch.randn(B, H, T, D, device="cuda", generator=g)
                   for _ in range(4))
    sm, seed = D ** -0.5, ATTN_SEED
    out, lse = fa._flash_forward(q, k, v, causal, sm, rate, seed)
    ref = fa._attention_reference(q, k, v, causal, sm, rate, seed)
    ref_lse = fa._lse_reference(q, k, causal, sm)
    delta = (do * out).sum(-1)
    dq = fa._flash_dq(q, k, v, do, lse, delta, causal, sm, rate, seed)
    dk, dv = fa._flash_dkv(q, k, v, do, lse, delta, causal, sm, rate, seed)
    refs = fa._flash_backward_reference(q, k, v, out, lse, do, causal, sm,
                                        rate, seed)
    torch.cuda.synchronize()
    tag = f"B={B} H={H} T={T} D={D} causal={causal} rate={rate}"
    fwd_err = max(float((out - ref).abs().max()),
                  float((lse - ref_lse).abs().max()))
    if not fwd_err <= TOL:
        raise AssertionError(f"flash_fwd {tag}: max error {fwd_err} > {TOL}")
    _assert_repeats(torch, f"flash_fwd {tag}", (out, lse), fa._flash_forward(
        q, k, v, causal, sm, rate, seed))
    again = (fa._flash_dq(q, k, v, do, lse, delta, causal, sm, rate, seed),
             *fa._flash_dkv(q, k, v, do, lse, delta, causal, sm, rate, seed))
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{name} {tag}: two launches on the same "
                                 f"inputs differ")
    bwd_err = {}
    for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        bwd_err[name] = float((a - b).abs().max())
        excess = float(((a - b).abs() - BWD_TOL * (1 + b.abs())).max())
        if not excess <= 0:
            raise AssertionError(
                f"{name} {tag}: max error {bwd_err[name]} exceeds "
                f"{BWD_TOL} * (1 + |plain|)")
    res = dict(B=B, H=H, T=T, D=D, causal=causal, rate=rate,
               fwd_err=fwd_err, dq_err=bwd_err["dq"],
               dkv_err=max(bwd_err["dk"], bwd_err["dv"]))
    res.update(check_delta(torch, fa, flush, out, do, timed))
    if not timed:
        return res
    res["fwd_ms"] = time_ms(torch, lambda: fa._flash_forward(
        q, k, v, causal, sm, rate, seed), flush)
    res["fwd_plain_ms"] = time_ms(torch, lambda: fa._attention_reference(
        q, k, v, causal, sm, rate, seed), flush)
    res["fwd_library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=sm, dropout_p=rate), flush)
    res["dq_ms"] = time_ms(torch, lambda: fa._flash_dq(
        q, k, v, do, lse, delta, causal, sm, rate, seed), flush)
    res["dkv_ms"] = time_ms(torch, lambda: fa._flash_dkv(
        q, k, v, do, lse, delta, causal, sm, rate, seed), flush)
    res["bwd_plain_ms"] = time_ms(torch, lambda: fa._flash_backward_reference(
        q, k, v, out, lse, do, causal, sm, rate, seed), flush)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                             scale=sm)
    res["bwd_library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, leaves, do, retain_graph=True), flush)
    half = 0.5 if causal else 1.0
    bht, bhtd = B * H * T, B * H * T * D
    # the forward: 2 products of 2 B H T^2 D, at 3xTF32 and on the f32
    # CUDA cores
    fwd_work = (4.0 * bhtd * T * half, (4.0 * bhtd + bht) * 4)
    res["fwd_bound_ms"], res["fwd_bound_by"] = _bound(*fwd_work,
                                                      PEAK_3XTF32_FLOPS)
    res["fwd_bound_f32_ms"], _ = _bound(*fwd_work)
    # dQ: 3 products of 2 B H T^2 D, dK/dV 4; at the rate they run at and,
    # for comparison with a CUDA-core version, on the f32 CUDA cores
    for name, n_products, n_tensors in (("dq", 3, 5), ("dkv", 4, 6)):
        work = (n_products * 2.0 * bhtd * T * half,
                (n_tensors * bhtd + 2 * bht) * 4)
        res[f"{name}_bound_ms"], res[f"{name}_bound_by"] = _bound(
            *work, PEAK_3XTF32_FLOPS)
        res[f"{name}_bound_f32_ms"], _ = _bound(*work)
    return res


def _flash_instantiation(mangled):
    """'flash_dq<64,drop>' (float32) or 'flash_dq_bf16<64,drop>' for a
    mangled flash kernel name ('flash_fwd_bf16<64,drop,causal>' for the
    bf16 forward's causal instantiation, 'flash_fwd<96,rate0,pad>' for a
    padded one of the float32 kernels, which serves the head dims up to
    its width; 'flash_dkv<256,drop,pad,dv>' and '...,dk>' for the two
    launches of dK/dV at width 256, in either dtype), else None."""
    m = re.search(r"flash_(fwd|dq|dkv)(_bf16)?_kernelILi(\d+)ELb([01])E"
                  r"(?:Lb([01])E)?(?:Li(\d)E)?", mangled)
    if m is None:
        return None
    flag = (",causal" if m.group(2) else ",pad") if m.group(5) == "1" else ""
    part = {"1": ",dv", "2": ",dk"}.get(m.group(6), "")
    return (f"flash_{m.group(1)}{m.group(2) or ''}<{m.group(3)},"
            f"{'drop' if m.group(4) == '1' else 'rate0'}{flag}{part}>")


def flash_build_report(native, n_expected=FLASH_INSTANTIATIONS):
    """Per instantiation of the forward, dQ and dK/dV kernels: registers
    and spill bytes (the build's -Xptxas -v report), dynamic shared memory
    a block (the library's own count), and the tensor-core instructions
    in `cuobjdump -sass` of the built library: HMMA (`mma.sync`) and
    HGMMA (`wgmma`). Raises if one has neither (the products must run on
    the tensor cores), if the forward spills at D <= 64, or if there are
    not `n_expected` instantiations (None: any number, for a tool that
    reports another checkout's build)."""
    rep = {}
    current = None
    for line in native.build_info.log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = _flash_instantiation(m.group(1))
            if current:
                rep[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            rep[current]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rep[current]["registers"] = int(m.group(1))
            current = None
    cuobjdump = os.path.join(os.path.dirname(native._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", native.build_info.path],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)",
                                 sass, re.S):
        inst = _flash_instantiation(name)
        if inst:
            rep.setdefault(inst, {}).update(hmma=body.count("HMMA"),
                                            hgmma=body.count("HGMMA"))
    lib = native.lib()
    for inst, r in rep.items():
        d = int(inst.split("<")[1].split(",")[0])
        bf16 = "_bf16<" in inst
        if inst.startswith("flash_fwd"):
            r["smem_bytes"] = (
                lib.ptt_flash_fwd_bf16_causal_smem_bytes(d)
                if inst.endswith(",causal>") else
                lib.ptt_flash_fwd_bf16_smem_bytes(d) if bf16
                else lib.ptt_flash_fwd_smem_bytes(d))
        else:
            dkv = int(inst.startswith("flash_dkv"))
            r["smem_bytes"] = (lib.ptt_flash_bwd_bf16_smem_bytes(dkv, d)
                               if bf16 else
                               lib.ptt_flash_bwd_smem_bytes(dkv, d))
        if not (r.get("hmma") or r.get("hgmma")):
            raise AssertionError(f"{inst}: no HMMA or HGMMA instruction in "
                                 f"the built library: its products do not "
                                 f"run on the tensor cores")
        if inst.startswith("flash_fwd") and d <= 64 \
                and r.get("spill_bytes", 0) != 0:
            raise AssertionError(f"{inst} spills {r['spill_bytes']} bytes")
    if n_expected is not None and len(rep) != n_expected:
        raise AssertionError(f"expected {n_expected} flash instantiations "
                             f"(forward, dQ and dK/dV x D 32/64/128 x rate "
                             f"0/dropout x float32/bf16, the bf16 "
                             f"forward's causal ones, the float32 kernels' "
                             f"padded ones and the bf16 kernels' width "
                             f"256), found {sorted(rep)}")
    return rep


def check_dropout_mask(torch, fa, T=128, B=2, H=8, rate=0.5,
                       dtype="float32"):
    """With T == D, identity matrices expose each kernel's dropout mask:
    the forward's out with V = I, dQ with K = I and delta = 0, and dV
    with dO = I are zero exactly where a weight was dropped. All three
    instantiations of `dtype` must equal the plain version's mask bit
    for bit."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    q, k, v, do = (torch.randn(B, H, T, T, device="cuda", generator=g)
                   .to(dt) for _ in range(4))
    eye = torch.eye(T, device="cuda", dtype=dt).expand(B, H, T,
                                                       T).contiguous()
    zero = torch.zeros(B, H, T, device="cuda")
    dropped = ~fa._attention_keep(ATTN_SEED, B * H, T, T, rate,
                                  "cuda").reshape(B, H, T, T)
    out, lse = fa._flash_forward(q, k, eye, False, 0.1, rate, ATTN_SEED)
    dq = fa._flash_dq(q, eye, v, do, lse, zero, False, 0.1, rate, ATTN_SEED)
    _, dv = fa._flash_dkv(q, k, v, eye, lse, zero, False, 0.1, rate,
                          ATTN_SEED)
    sfx = "" if dtype == "float32" else "_bf16"
    for name, got, want in ((f"flash_fwd{sfx}", out == 0, dropped),
                            (f"flash_dq{sfx}", dq == 0, dropped),
                            (f"flash_dkv{sfx}", dv == 0,
                             dropped.transpose(-1, -2))):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: dropout mask differs from the "
                                 f"plain version's in "
                                 f"{int((got != want).sum())} weights")
    return float(dropped.float().mean())


def _bf16_err(torch, tag, got, want, exact=None):
    """(max |got - want|, the largest share of its tolerance an element
    used, the elements passed by accuracy) for two bf16 tensors [..., D];
    raises where an element lies further from the plain value than
    BF16_ULPS bf16 ulps of |plain| plus BF16_ROW_TOL times its row's
    largest |plain| plus BF16_ATOL times the largest of all. `exact` (a
    head dim padded into a wider kernel only, phase 7v): a callable giving
    the same function in float64 on the same inputs; then up to
    BF16_BY_ACCURACY_SHARE of the elements beyond the rule pass where each
    lies no further from the float64 value than the plain version's, plus
    BF16_ULPS ulps (its own rounding), and are logged with their three
    values; more raise. The share is over the elements not so passed."""
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        raise AssertionError(f"{tag}: dtypes {got.dtype}, {want.dtype}")
    err = (got.float() - want.float()).abs()
    mag = want.float().abs()
    # one bf16 ulp at |plain|: 2^(e - 8) for |plain| = m 2^e, m in [0.5, 1)
    _, e = torch.frexp(mag.clamp_min(2.0 ** -126))
    ulp = torch.ldexp(torch.ones_like(mag), e - 8)
    tol = (BF16_ULPS * ulp + BF16_ROW_TOL * mag.amax(-1, keepdim=True)
           + BF16_ATOL * mag.max())
    ratio = err / tol.clamp_min(2.0 ** -126)
    over = ratio > 1.0
    by_accuracy = 0
    if bool(over.any()) and exact is not None:
        x = exact()
        closer = ((got.double() - x).abs()
                  <= (want.double() - x).abs() + BF16_ULPS * ulp.double())
        by_accuracy = int((over & closer).sum())
        if by_accuracy > BF16_BY_ACCURACY_SHARE * got.numel():
            raise AssertionError(
                f"{tag}: {by_accuracy} of {got.numel()} elements beyond the "
                f"rule, more than {BF16_BY_ACCURACY_SHARE} of them, though "
                f"each no further from the float64 value than the plain "
                f"version's")
        if by_accuracy:
            i = int(torch.where(over & closer, ratio,
                                torch.zeros_like(ratio)).argmax())
            log(f"{tag}: {by_accuracy} element(s) beyond the rule, each no "
                f"further from the float64 value than the plain version's; "
                f"the largest at {float(ratio.flatten()[i]):.3g} of the rule: "
                f"kernel {float(got.flatten()[i]):.6g}, plain "
                f"{float(want.flatten()[i]):.6g}, float64 "
                f"{float(x.flatten()[i]):.6g}, its row's largest |plain| "
                f"{float(mag.amax(-1, keepdim=True).expand_as(mag).flatten()[i]):.6g}")
        ratio = torch.where(closer, torch.zeros_like(ratio), ratio)
    share = float(ratio.max())
    if not share <= 1.0:
        raise AssertionError(f"{tag}: an element at {share:.3g} of its "
                             f"tolerance ({BF16_ULPS} bf16 ulps of |plain| "
                             f"+ {BF16_ROW_TOL} x its row's max |plain| + "
                             f"{BF16_ATOL} x max|plain|), and further from "
                             f"the float64 value than the plain version; "
                             f"max abs error {float(err.max())}")
    return float(err.max()), share, by_accuracy


def check_train_kernels_bf16(torch, fa, flush, B, H, T, D, causal, rate,
                             timed=True):
    """The bf16 instantiations of the training path's three kernels at one
    shape, each against its bf16 plain version on the same inputs, two
    launches bit-equal; returns their numbers: each output's max abs error,
    the largest share of its per-element tolerance used and, at a head dim
    padded into a wider kernel, the elements passed instead by lying no
    further from the float64 value than the plain version (`_bf16_err`;
    lse: absolute), and when `timed` the times and bounds."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(SEED + 9 * T + int(causal))
    q, k, v, do = (torch.randn(B, H, T, D, device="cuda", generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    sm, seed = D ** -0.5, ATTN_SEED
    out, lse = fa._flash_forward(q, k, v, causal, sm, rate, seed)
    delta = fa._flash_delta_reference(out, do)
    dq = fa._flash_dq(q, k, v, do, lse, delta, causal, sm, rate, seed)
    dk, dv = fa._flash_dkv(q, k, v, do, lse, delta, causal, sm, rate, seed)
    ref = fa._attention_reference(q, k, v, causal, sm, rate, seed)
    ref_lse = fa._lse_reference(q, k, causal, sm)
    refs = fa._flash_backward_reference(q, k, v, out, lse, do, causal, sm,
                                        rate, seed)
    torch.cuda.synchronize()
    tag = f"B={B} H={H} T={T} D={D} causal={causal} rate={rate} bf16"
    res = dict(B=B, H=H, T=T, D=D, causal=causal, rate=rate)
    # the same functions in float64 on the same inputs, for an element
    # beyond the rule (`_bf16_err`); the backward's from the kernel's out
    # and lse, as the kernels and the plain backward take them
    exact64 = {}
    padded = D not in (32, 64, 128, 256)

    def exact(i):
        if not padded:
            return None

        def get():
            if not exact64:
                q64, k64, v64 = (t.double() for t in (q, k, v))
                exact64["fwd"] = fa._attention_reference(
                    q64, k64, v64, causal, sm, rate, seed)
                exact64["bwd"] = fa._flash_backward_reference(
                    q64, k64, v64, out.double(), lse.double(), do.double(),
                    causal, sm, rate, seed)
            return exact64["fwd"] if i is None else exact64["bwd"][i]
        return get

    res["fwd_err"], res["fwd_share"], res["fwd_by_accuracy"] = _bf16_err(
        torch, f"flash_fwd_bf16 {tag}", out, ref, exact(None))
    res["lse_err"] = float((lse - ref_lse).abs().max())
    if not res["lse_err"] <= LSE_TOL:
        raise AssertionError(f"flash_fwd_bf16 {tag}: lse max error "
                             f"{res['lse_err']} > {LSE_TOL}")
    res["dq_err"], res["dq_share"], res["dq_by_accuracy"] = _bf16_err(
        torch, f"flash_dq_bf16 {tag}", dq, refs[0], exact(0))
    dk_err = _bf16_err(torch, f"flash_dkv_bf16 {tag} dk", dk, refs[1],
                       exact(1))
    dv_err = _bf16_err(torch, f"flash_dkv_bf16 {tag} dv", dv, refs[2],
                       exact(2))
    res["dkv_err"] = max(dk_err[0], dv_err[0])
    res["dkv_share"] = max(dk_err[1], dv_err[1])
    res["dkv_by_accuracy"] = dk_err[2] + dv_err[2]
    exact64.clear()
    res.update(check_delta(torch, fa, flush, out, do, timed))
    again = (*fa._flash_forward(q, k, v, causal, sm, rate, seed),
             fa._flash_dq(q, k, v, do, lse, delta, causal, sm, rate, seed),
             *fa._flash_dkv(q, k, v, do, lse, delta, causal, sm, rate, seed))
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"),
                          (out, lse, dq, dk, dv), again):
        view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        if not torch.equal(a.view(view), b.view(view)):
            raise AssertionError(f"{name} {tag}: two launches on the same "
                                 f"inputs differ")
    if not timed:
        return res
    res["fwd_ms"] = time_ms(torch, lambda: fa._flash_forward(
        q, k, v, causal, sm, rate, seed), flush)
    res["fwd_plain_ms"] = time_ms(torch, lambda: fa._attention_reference(
        q, k, v, causal, sm, rate, seed), flush)
    res["fwd_library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=sm, dropout_p=rate), flush)
    res["dq_ms"] = time_ms(torch, lambda: fa._flash_dq(
        q, k, v, do, lse, delta, causal, sm, rate, seed), flush)
    res["dkv_ms"] = time_ms(torch, lambda: fa._flash_dkv(
        q, k, v, do, lse, delta, causal, sm, rate, seed), flush)
    res["bwd_plain_ms"] = time_ms(torch, lambda: fa._flash_backward_reference(
        q, k, v, out, lse, do, causal, sm, rate, seed), flush)
    # what the autograd backward launches: the delta kernel (timed alone
    # by check_delta), dQ and dK/dV; SDPA's backward (all three grads, its
    # own delta included) at this case's dropout_p and at 0
    res["backward_ms"] = time_ms(torch, lambda: fa._flash_backward(
        q, k, v, out, lse, do, causal, sm, rate, seed), flush)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    for key, p in (("bwd_library_ms", rate), ("bwd_library_rate0_ms", 0.0)):
        lib_out = F.scaled_dot_product_attention(
            *leaves, is_causal=causal, scale=sm, dropout_p=p)
        res[key] = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True), flush)
    half = 0.5 if causal else 1.0
    bht, bhtd = B * H * T, B * H * T * D
    # 2 bytes an element of q, k, v, o, do and the grads, 4 of lse and
    # delta; products at the bf16 tensor-core rate
    for name, n_products, n_tensors, n_rows in (("fwd", 2, 4, 1),
                                                ("dq", 3, 5, 2),
                                                ("dkv", 4, 6, 2)):
        work = (n_products * 2.0 * bhtd * T * half,
                n_tensors * bhtd * 2.0 + n_rows * bht * 4.0)
        res[f"{name}_bound_ms"], res[f"{name}_bound_by"] = _bound(
            *work, PEAK_BF16_FLOPS)
    return res


def _split_numbers(P, pa, H, Dh, BS, max_b, seq):
    """The split launch of one paged case at P positions a chunk: NSPLIT
    (from shapes), the grid's blocks and the live ones among them (from
    this run's seq_lens, which only this script reads on the host)."""
    nsplit, _ = pa.decode_split_plan(len(seq), H, Dh, BS, max_b, P)
    live = H * sum(-(-min(int(x), max_b * BS) // P) for x in seq)
    return dict(P=P, nsplit=nsplit, grid_blocks=H * len(seq) * nsplit,
                live_blocks=live)


def _paged_inputs(torch, seq, H, Dh, BS, max_b, seed):
    """A float32 paged case: block tables drawn from a shuffled pool,
    positions a slot must not read (past its seq_len, and the trash block)
    NaN."""
    import numpy as np
    rng = np.random.RandomState(seed)
    S = len(seq)
    NB = 1 + S * max_b
    pool = rng.permutation(np.arange(1, NB)).astype(np.int32)
    bt = np.zeros((S, max_b), np.int32)
    for s in range(S):
        n = -(-int(seq[s]) // BS)
        bt[s, :n] = pool[s * max_b: s * max_b + n]
    kc = torch.full((NB, BS, H, Dh), float("nan"), device="cuda")
    vc = torch.full((NB, BS, H, Dh), float("nan"), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    # data in exactly the rows the slots may read
    live_blk, live_off = [], []
    for s in range(S):
        for p in range(int(seq[s])):
            live_blk.append(bt[s, p // BS])
            live_off.append(p % BS)
    lb = torch.tensor(live_blk, dtype=torch.long, device="cuda")
    lo = torch.tensor(live_off, dtype=torch.long, device="cuda")
    kc[lb, lo] = torch.randn(len(live_blk), H, Dh, device="cuda", generator=g)
    vc[lb, lo] = torch.randn(len(live_blk), H, Dh, device="cuda", generator=g)
    q = torch.randn(S, H, Dh, device="cuda", generator=g)
    btt = torch.from_numpy(bt).cuda()
    sl = torch.from_numpy(np.asarray(seq, np.int32)).cuda()
    return q, kc, vc, btt, sl, int(sum(-(-int(x) // BS) for x in seq))


def check_paged(torch, pa, flush, seq=(0, 1, 17, 300, 555, 777, 1000, 1024),
                H=8, Dh=64, BS=16, max_ctx=1024, seed=SEED):
    """One float32 paged case (by default serve-base's 8 slots at ragged
    seq_lens, 0 and the full context among them): within TOL of the plain
    version, finite under the NaN poison, zeros for seq_len 0, two launches
    bit-equal; kernel and plain times, the bound, the split launch."""
    max_b = max_ctx // BS
    S = len(seq)
    q, kc, vc, btt, sl, n_entries = _paged_inputs(torch, seq, H, Dh, BS,
                                                  max_b, seed)
    sm = Dh ** -0.5
    out = pa._paged_attention_cuda(q, kc, vc, btt, sl, sm)
    # the plain version gathers whole blocks: give it the NaN-free copy
    kz, vz = torch.nan_to_num(kc), torch.nan_to_num(vc)
    ref = pa.paged_attention_reference(q, kz, vz, btt, sl, sm)
    torch.cuda.synchronize()
    tag = f"paged_decode S={S}"
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{tag}: read a position it must not")
    for s in range(S):
        if seq[s] == 0 and bool(out[s].abs().max() != 0):
            raise AssertionError(f"{tag}: seq_len 0 slot is not zeros")
    err = float((out - ref).abs().max())
    if not err <= TOL:
        raise AssertionError(f"{tag}: max error {err} > {TOL}")
    _assert_repeats(torch, tag, (out,),
                    (pa._paged_attention_cuda(q, kc, vc, btt, sl, sm),))
    ms = time_ms(torch, lambda: pa._paged_attention_cuda(q, kz, vz, btt, sl, sm),
                 flush)
    plain = time_ms(torch, lambda: pa.paged_attention_reference(
        q, kz, vz, btt, sl, sm), flush)
    total = int(sum(seq))
    nbytes = (total * H * Dh * 2 + 2 * S * H * Dh) * 4.0 + 4.0 * (S + n_entries)
    bound, by = _bound(4.0 * total * H * Dh, nbytes)
    return dict(S=S, seq_lens=list(seq), total=total, err=err, ms=ms,
                plain_ms=plain, library_ms=None, bound_ms=bound, bound_by=by,
                split=_split_numbers(pa.DECODE_SPLIT, pa, H, Dh, BS, max_b,
                                     seq))


def check_paged_q8(torch, pa, flush, S=INT8_SLOTS, H=8, Dh=64, BS=16,
                   max_ctx=1024, NB=2050, seq=None):
    """One int8 paged case, by default at serve-base-int8's shapes:
    seq_lens spread over 0..max_ctx (one 0, one full), random int8 caches
    with random positive scales, block tables from a shuffled pool. What a
    slot must not read is poisoned: table entries past ceil(seq_len / BS)
    point at block 0, and the scale of every block that no live entry
    names is NaN. Within TOL of the plain version, finite, zeros for
    seq_len 0, two launches bit-equal; times, bound, the split launch."""
    import numpy as np
    rng = np.random.RandomState(SEED + 5)
    max_b = max_ctx // BS
    seq = (np.linspace(0, max_ctx, S) if seq is None else
           np.asarray(seq)).astype(np.int32)
    S = len(seq)
    pool = rng.permutation(np.arange(1, NB)).astype(np.int32)
    bt = np.zeros((S, max_b), np.int32)
    live, used = [], 0
    for s in range(S):
        n = -(-int(seq[s]) // BS)
        bt[s, :n] = pool[used: used + n]
        live.extend(bt[s, :n].tolist())
        used += n
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    kc, vc = (torch.randint(-127, 128, (NB, BS, H, Dh), device="cuda",
                            generator=g, dtype=torch.int8) for _ in range(2))
    ks = torch.full((NB,), float("nan"), device="cuda")
    vs = torch.full((NB,), float("nan"), device="cuda")
    lb = torch.tensor(live, dtype=torch.long, device="cuda")
    ks[lb] = torch.empty(len(live), device="cuda").uniform_(
        0.002, 0.03, generator=g)
    vs[lb] = torch.empty(len(live), device="cuda").uniform_(
        0.002, 0.03, generator=g)
    q = torch.randn(S, H, Dh, device="cuda", generator=g)
    btt = torch.from_numpy(bt).cuda()
    sl = torch.from_numpy(seq).cuda()
    sm = Dh ** -0.5
    args = (q, kc, vc, ks, vs, btt, sl, sm)
    out = pa._paged_attention_q8_cuda(*args)
    ref = pa.paged_attention_q8_reference(*args)
    torch.cuda.synchronize()
    tag = f"paged_decode_q8 S={S}"
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{tag}: read a dead block or its scale")
    for s in range(S):
        if seq[s] == 0 and bool(out[s].abs().max() != 0):
            raise AssertionError(f"{tag}: seq_len 0 slot is not zeros")
    err = float((out - ref).abs().max())
    if not err <= TOL:
        raise AssertionError(f"{tag}: max error {err} > {TOL}")
    _assert_repeats(torch, tag, (out,), (pa._paged_attention_q8_cuda(*args),))
    ms = time_ms(torch, lambda: pa._paged_attention_q8_cuda(*args), flush)
    plain = time_ms(torch, lambda: pa.paged_attention_q8_reference(*args),
                    flush)
    total = int(seq.sum())
    # int8 K and V rows, the live table entries with their two scales, the
    # seq_lens, q in and out out
    nbytes = total * H * Dh * 2 * 1.0 + len(live) * (4 + 2 * 4) + 4 * S \
        + 2 * S * H * Dh * 4
    bound, by = _bound(4.0 * total * H * Dh, nbytes)
    return dict(S=S, total=total, seq_min=int(seq.min()),
                seq_max=int(seq.max()), err=err, ms=ms, plain_ms=plain,
                library_ms=None, bound_ms=bound, bound_by=by,
                split=_split_numbers(pa.DECODE_SPLIT_Q8, pa, H, Dh, BS, max_b,
                                     seq))


def _paged_instantiation(src, mangled):
    """'paged_decode.cu:paged_split_kernel<64>' for a mangled paged kernel
    name compiled from `src` ('...<64,pad>' for a padded instantiation,
    which serves the head dims up to its width), else None."""
    m = re.search(r"(paged_(?:q8_)?split_kernel|paged_merge_kernel)ILi(\d+)E"
                  r"(?:Lb([01])E)?", mangled)
    if m is None:
        return None
    return (f"{src}:{m.group(1)}<{m.group(2)}"
            f"{',pad' if m.group(3) == '1' else ''}>")


def paged_build_report(native, n_expected=36):
    """Per instantiation of the two paged decode sources' split and merge
    kernels: registers, spill bytes and static shared memory a block, from
    the build's -Xptxas -v report. Raises unless all `n_expected` are there
    (None: any number, for a tool that reports another checkout's build)."""
    rep, src, current = {}, None, None
    for line in native.build_info.log.splitlines():
        m = re.match(r"== nvcc (\S+)", line)
        if m:
            src, current = m.group(1), None
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = _paged_instantiation(src, m.group(1))
            if current:
                rep[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            rep[current]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rep[current]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            rep[current]["smem_bytes"] = int(sm.group(1)) if sm else 0
            current = None
    if n_expected is not None and len(rep) != n_expected:
        raise AssertionError(f"expected {n_expected} paged instantiations "
                             f"(split and "
                             f"merge x (D 32/64/128, and the padded widths "
                             f"8/16/32/64/128/256) x float32 and int8), "
                             f"found {sorted(rep)}")
    return rep


def check_dropout_kernel(torch, dk, flush, shape, rate=0.1,
                         dtype="float32"):
    """The dropout kernel's `dtype` instantiation at one of the train
    path's shapes: the forward with Mask (Out and Mask in one pass, as a
    fetched Mask takes it), the forward as train-base's op runs it (no
    Mask: nothing reads it) and the backward's launch on a `dy`, each
    equal to the plain version bit for bit, and in bf16 the keep bits of
    the float32 kernel; times of all three, of the plain version and of
    `torch.nn.functional.dropout`."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(SEED + shape[-1])
    x32 = torch.randn(*shape, device="cuda", generator=g)
    x = x32.to(dt)
    dy = torch.randn(*shape, device="cuda", generator=g).to(dt)
    seed = ATTN_SEED
    out, mask = dk.dropout_forward(x, seed, rate, want_mask=True)
    op_out, _ = dk.dropout_forward(x, seed, rate)
    dx, _ = dk.dropout_forward(dy, seed, rate)
    ref_out, ref_mask = dk.dropout_reference(x, seed, rate)
    ref_dx, _ = dk.dropout_reference(dy, seed, rate)
    torch.cuda.synchronize()
    bits = torch.int32 if x.element_size() == 4 else torch.int16
    for name, a, b in (("Out", out, ref_out), ("Mask", mask, ref_mask),
                       ("Out without Mask", op_out, ref_out),
                       ("dX", dx, ref_dx)):
        if not torch.equal(a.view(bits), b.view(bits)):
            raise AssertionError(
                f"dropout {tuple(shape)} {dtype} rate {rate}: {name} differs "
                f"from the plain version's in "
                f"{int((a.view(bits) != b.view(bits)).sum())} elements")
    if dt != torch.float32 and not torch.equal(
            mask.float(), dk.dropout_forward(x32, seed, rate,
                                             want_mask=True)[1]):
        raise AssertionError(f"dropout {tuple(shape)} {dtype}: its keep bits "
                             f"differ from the float32 kernel's")
    n = x.numel()
    res = dict(shape=list(shape), dtype=dtype, rate=rate, err=0.0,
               kept=float(mask.float().mean()),
               scale=dk.drop_scale(rate, dt))
    res["fwd_ms"] = time_ms(torch, lambda: dk.dropout_forward(
        x, seed, rate, want_mask=True), flush)
    res["op_ms"] = time_ms(torch, lambda: dk.dropout_forward(x, seed, rate),
                           flush)
    res["bwd_ms"] = time_ms(torch, lambda: dk.dropout_forward(dy, seed, rate),
                            flush)
    res["plain_ms"] = time_ms(torch, lambda: dk.dropout_reference(
        x, seed, rate), flush)
    res["library_ms"] = time_ms(torch, lambda: torch.nn.functional.dropout(
        x, rate, training=True), flush)
    # about 20 integer operations an element, against one read and one
    # write of the tensor, and one more write with Mask
    e = x.element_size()
    res["fwd_bound_ms"], res["fwd_bound_by"] = _bound(0.0, 3.0 * e * n)
    res["bwd_bound_ms"], res["bwd_bound_by"] = _bound(0.0, 2.0 * e * n)
    return res


def prompts_for(vocab, lens=None, n=N_REQUESTS):
    """Random prompts from SEED; by default serve-base's traffic, `n`
    prompts of 40..500 tokens."""
    import numpy as np
    rng = np.random.RandomState(SEED)
    if lens is None:
        lens = np.linspace(40, 500, n).astype(int)
    return [rng.randint(0, vocab, size=int(n)).tolist() for n in lens]


def serve_all(srv, name, prompts, timeout):
    futs = [srv.submit_generate(name, p, max_new_tokens=NEW_TOKENS)
            for p in prompts]
    return [f.result(timeout=timeout) for f in futs]


def teacher_forced(ver, prompt, forced, slots):
    """Replay one request on an idle server with the generated tokens
    given: a prefill of `prompt` into blocks 1.. of slot 0, then one
    decode step per token of `forced` but the last. Returns the logits
    that picked each of the len(forced) tokens, [len(forced), vocab], and
    the sequence's K/V residency per cache var (the int8 values of its
    written positions, the scales of their blocks)."""
    import numpy as np
    sig = ver.decode.signature
    bs, max_b = sig["block_size"], sig["max_blocks_per_seq"]
    n_blocks = -(-(len(prompt) + len(forced)) // bs)
    table = np.zeros((max_b,), np.int32)
    table[:n_blocks] = np.arange(1, n_blocks + 1)
    rung = min(r for r in sig["prefill_seq_rungs"] if r >= len(prompt))
    tokens = np.zeros((1, rung), np.int64)
    tokens[0, :len(prompt)] = prompt
    logits = [ver.prepared.run({
        "tokens": tokens, "block_tables": table[None, :],
        "seq_lens": np.array([len(prompt)], np.int32)})[0][0]]
    bt = np.zeros((slots, max_b), np.int32)
    bt[0] = table
    for i, tok in enumerate(forced[:-1]):
        step_tokens = np.zeros((slots, 1), np.int64)
        step_tokens[0, 0] = tok
        seq = np.zeros((slots,), np.int32)
        seq[0] = len(prompt) + i + 1
        logits.append(ver.decode.prepared.run({
            "tokens": step_tokens, "block_tables": bt, "seq_lens": seq})[0][0])
    # the positions written: the prompt and every forced token but the last
    # (what lies past them in the last block is an earlier sequence's)
    n_written = len(prompt) + len(forced) - 1
    blocks = slice(1, -(-n_written // bs) + 1)
    resident = {}
    for cname, sname in sig["scale_vars"].items():
        values = ver.scope.find_var(cname)[blocks].cpu().numpy()
        resident[cname] = (
            values.reshape((-1,) + values.shape[2:])[:n_written].astype(
                np.int32),
            ver.scope.find_var(sname)[blocks].cpu().numpy())
    return np.stack(logits), resident


def compare_teacher_forced(i, prompt, card_tokens, host_tokens, ver, hver,
                           slots, host_forced=None):
    """Replay request `i` on the card and on the host, both teacher-forced
    on the host's tokens, and hold the two to what int8 rounding flips can
    explain: logits within Q8_LOGIT_TOL, block scales equal to summation
    order, int8 values at most Q8_MAX_BIN_DIFF bins apart. Where the card
    generated other tokens than the host, the host's logits of the two
    picks at the first differing step must be a near-tie. Raises
    otherwise; returns a one-line account. `host_forced`: the host's
    replay (logits, residency) made elsewhere, in place of `hver`'s."""
    import numpy as np
    card_logits, card_kv = teacher_forced(ver, prompt, host_tokens, slots)
    host_logits, host_kv = (teacher_forced(hver, prompt, host_tokens, slots)
                            if host_forced is None else host_forced)
    if host_logits.argmax(-1).tolist() != list(host_tokens):
        raise AssertionError(f"request {i}: the host's teacher-forced replay "
                             f"does not reproduce its own tokens")
    err = float(np.abs(card_logits - host_logits).max())
    bin_diff, differing, n = 0, 0, 0
    for cname in card_kv:
        (cq, cs), (hq, hs) = card_kv[cname], host_kv[cname]
        bin_diff = max(bin_diff, int(np.abs(cq - hq).max()))
        differing += int((cq != hq).sum())
        n += cq.size
        if not np.allclose(cs, hs, rtol=1e-4, atol=0):
            raise AssertionError(f"request {i}: block scales of {cname} "
                                 f"differ between card and host beyond "
                                 f"summation order")
    account = (f"request {i} ({len(prompt)}-token prompt) teacher-forced on "
               f"the host's tokens: logits max_abs_err {err:.3g} (tol "
               f"{Q8_LOGIT_TOL}); int8 residency differs in {differing} of "
               f"{n} values, by at most {bin_diff} bin(s)")
    ok = err <= Q8_LOGIT_TOL and bin_diff <= Q8_MAX_BIN_DIFF
    if list(card_tokens) != list(host_tokens):
        step = next(k for k, (a, b) in enumerate(zip(card_tokens,
                                                     host_tokens)) if a != b)
        gap = float(host_logits[step, host_tokens[step]]
                    - host_logits[step, card_tokens[step]])
        account += (f"; first differing token at step {step} (card "
                    f"{card_tokens[step]}, host {host_tokens[step]}), host "
                    f"logit gap between the two picks {gap:.3g}")
        ok = ok and 0 <= gap <= 2 * Q8_LOGIT_TOL
    if not ok:
        raise AssertionError("card and host int8 generations differ by more "
                             "than rounding flips: " + account)
    return account


def save_serve_int8(ptt, tiny_lm, tmp):
    """Save serve-base-int8 under `tmp`: serve-base's widths and weights
    with the int8 KV residency, INT8_SLOTS slots, and as many blocks as
    serve-base's float32 cache bytes afford. Returns (dir, signature,
    cache bytes, the float32 budget in bytes)."""
    fp_sig = tiny_lm.default_signature(**SERVE_BASE)
    budget = fp_sig["num_blocks"] * ptt.serve.block_residency_nbytes(fp_sig)
    kw = dict(SERVE_BASE, kv_dtype="int8", max_slots=INT8_SLOTS)
    num_blocks = 1 + ptt.serve.blocks_for_budget(
        tiny_lm.default_signature(**kw), budget)
    mdir = os.path.join(tmp, "serve_base_int8")
    sig = tiny_lm.save_tiny_lm(mdir, seed=WEIGHT_SEED, num_blocks=num_blocks,
                               **kw)
    cache_bytes = num_blocks * ptt.serve.block_residency_nbytes(sig)
    seats = (num_blocks - 1) // sig["max_blocks_per_seq"]
    log(f"serve-base-int8: {num_blocks} blocks of "
        f"{ptt.serve.block_residency_nbytes(sig)} B = {cache_bytes} B of "
        f"cache ({seats} full contexts) inside serve-base's "
        f"{fp_sig['num_blocks']} blocks of "
        f"{ptt.serve.block_residency_nbytes(fp_sig)} B = {budget} B "
        f"({(fp_sig['num_blocks'] - 1) // fp_sig['max_blocks_per_seq']} "
        f"full contexts)")
    if cache_bytes > budget or seats < INT8_SLOTS:
        raise AssertionError("the int8 cache does not seat its slots inside "
                             "the float32 budget")
    return mdir, sig, cache_bytes, budget


def run_serve_int8(torch, ptt, native, tiny_lm, tmp, card, fp32_tokens):
    """serve-base-int8 on the card and on the host; returns the numbers.
    `fp32_tokens`: the float32 serve-base run's tokens for the same
    prompts."""
    mdir, sig, cache_bytes, budget = save_serve_int8(ptt, tiny_lm, tmp)
    prompts = prompts_for(sig["vocab"], n=INT8_REQUESTS)
    n_layers = sig["n_layers"]
    srv = ptt.serve.InferenceServer(ptt.CUDAPlace(0))
    host = ptt.serve.InferenceServer(ptt.CPUPlace())
    try:
        t0 = time.perf_counter()
        ver = srv.add_model("lm8", mdir)
        torch.cuda.synchronize()
        log(f"int8 load + verify + warm on the card: "
            f"{time.perf_counter() - t0:.2f} s")
        for cname in sig["cache_vars"]:
            if ver.scope.find_var(cname).dtype != torch.int8:
                raise AssertionError(f"{cname} is not resident as int8")
        before = srv.stats()["models"]["lm8"]
        native.reset_launches()
        t0 = time.perf_counter()
        results = serve_all(srv, "lm8", prompts, timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(native.launches)
        after = srv.stats()["models"]["lm8"]
        n_prefill = after["prefill_steps"] - before["prefill_steps"]
        n_decode = after["steps"] - before["steps"]
        requants = after["kv_requant_events"] - before["kv_requant_events"]
        log(f"served {INT8_REQUESTS} requests over the int8 cache: "
            f"{n_prefill} prefill steps, {n_decode} decode steps, "
            f"{requants} requantize events, launches {launches}")
        want = dict.fromkeys(launches, 0)
        want.update(flash_fwd=n_layers * n_prefill,
                    paged_decode_q8=n_layers * n_decode)
        if launches != want or n_prefill < 1 or n_decode < 1:
            raise AssertionError(f"serve-base-int8 launches {launches}, "
                                 f"expected {want}")
        for p, r in zip(prompts, results):
            if len(r.tokens) != NEW_TOKENS or r.finish_reason != "length" \
                    or not all(0 <= t < sig["vocab"] for t in r.tokens):
                raise AssertionError(f"bad generation for a {len(p)}-token "
                                     f"prompt: {r}")
        ttft = sorted(r.ttft_us / 1e3 for r in results)
        gen_tokens = sum(len(r.tokens) for r in results)
        log(f"serve-base-int8 on the card [{card}]: TTFT median "
            f"{ttft[len(ttft) // 2]:.1f} ms max {ttft[-1]:.1f} ms; "
            f"{gen_tokens} tokens in {wall:.3f} s = "
            f"{gen_tokens / wall:.1f} tokens/s; decode steps {n_decode} "
            f"({(wall * 1e3) / max(n_decode, 1):.2f} ms/step incl. prefills)")

        t0 = time.perf_counter()
        hver = host.add_model("lm8_host", mdir, warm=False)
        host_results = serve_all(host, "lm8_host", prompts, timeout=900)
        host_requants = host.stats()["models"]["lm8_host"]["kv_requant_events"]
        log(f"int8 host reference run: {time.perf_counter() - t0:.1f} s, "
            f"{host_requants} requantize events")
        differing = [i for i, (a, b) in enumerate(zip(results, host_results))
                     if a.tokens != b.tokens]
        # the longest prompt always, and every request whose tokens differ
        for i in sorted({INT8_REQUESTS - 1, *differing}):
            log("  " + compare_teacher_forced(
                i, prompts[i], results[i].tokens, host_results[i].tokens,
                ver, hver, INT8_SLOTS))
    finally:
        srv.close()
        host.close()
    if differing:
        log(f"tokens equal to the host run for "
            f"{INT8_REQUESTS - len(differing)} of {INT8_REQUESTS} requests; "
            f"{len(differing)} differ at a near-tie moved by int8 rounding "
            f"flips (above)")
    else:
        log(f"tokens equal to the host run for all {INT8_REQUESTS} requests")
    same_fp32 = sum(r.tokens == t for r, t in zip(results, fp32_tokens))
    first_fp32 = sum(r.tokens[0] == t[0] for r, t in zip(results, fp32_tokens))
    log(f"int8 vs float32 residency: {same_fp32} of {INT8_REQUESTS} requests "
        f"generate the float32 run's tokens ({first_fp32} of "
        f"{INT8_REQUESTS} first tokens, which prefill computes exactly)")
    if first_fp32 != INT8_REQUESTS:
        raise AssertionError("an int8 request's first token differs from the "
                             "float32 run's: prefill attends over exact K/V")
    return dict(launches=launches, n_prefill=n_prefill, n_decode=n_decode,
                requants=requants, host_requants=host_requants,
                ttft_ms_median=ttft[len(ttft) // 2], ttft_ms_max=ttft[-1],
                tokens_per_s=gen_tokens / wall, wall_s=wall,
                cache_bytes=cache_bytes, budget_bytes=budget,
                num_blocks=sig["num_blocks"], host_token_mismatches=len(differing),
                equal_to_fp32=same_fp32,
                # phase 7s serves the same dir and prompts through a fleet
                torrent_arm=dict(name="lm8", mdir=mdir, sig=sig,
                                 prompts=prompts,
                                 tokens=[r.tokens for r in results]))


def prefill_logits(ver, prompt, rung):
    """One prefill step on an all-zero block table: every K/V write lands
    in the trash block, so the served cache is untouched."""
    import numpy as np
    sig = ver.decode.signature
    tokens = np.zeros((1, rung), np.int64)
    tokens[0, :len(prompt)] = prompt
    return ver.prepared.run({
        "tokens": tokens,
        "block_tables": np.zeros((1, sig["max_blocks_per_seq"]), np.int32),
        "seq_lens": np.array([len(prompt)], np.int32)})[0]


def build_train(ptt, **overrides):
    """Transformer-base (TRAIN_BASE with `overrides`) + Adam(TRAIN_LR):
    (main, startup, loss)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import transformer
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = transformer.build(**dict(TRAIN_BASE, **overrides))
        optimizer.Adam(learning_rate=TRAIN_LR).minimize(fetches["loss"])
    return main, startup, fetches["loss"]


def train_batch(batch):
    """One fixed batch of source, target and label ids from DATA_SEED."""
    import numpy as np
    rng = np.random.RandomState(DATA_SEED)
    shape = (batch, TRAIN_BASE["seq_len"])
    return {n: rng.randint(0, TRAIN_BASE["trg_vocab_size"],
                           shape).astype(np.int64)
            for n in ("src_word", "trg_word", "lbl_word")}


def gated_dropout_ops(program):
    """The training-mode `dropout` ops of `program` that pass the dropout
    kernel's gate (upscale_in_train, 0 < rate < 1, minor dim a multiple of
    128), counted from the Program itself."""
    block = program.global_block()
    n = 0
    for op in block.ops:
        if op.type != "dropout" or op.attrs.get("is_test", False):
            continue
        shape = block.var(op.inputs["X"][0]).shape
        if op.attrs.get("dropout_implementation") == "upscale_in_train" \
                and 0.0 < op.attrs.get("dropout_prob", 0.5) < 1.0 \
                and shape and shape[-1] % 128 == 0:
            n += 1
    return n


def run_train_base(torch, ptt, native, impl, amp=False, batch=TRAIN_BATCH,
                   steps=TRAIN_STEPS, fused=True, model=None):
    """`steps` steps of train-base at `batch` on the card with
    ``FLAGS_dropout_impl`` at `impl`, under bf16 mixed precision when
    `amp`, its attentions the fused op (the flash kernels) or, unless
    `fused`, the op chain of train-base-unfused (no flash kernel; under
    `pallas` the dropout kernel at each attention's weights too), with
    `model`'s overrides of TRAIN_BASE (phase 7v's heads); returns the
    numbers, with the launch counts of exactly those steps."""
    import numpy as np
    from paddle_tpu_torch.ops import flash_attention as fa
    main, startup, loss = build_train(
        ptt, **({} if fused else {"fused_attention": False}),
        **(model or {}))
    n_gated = gated_dropout_ops(main)
    n_f32 = AMP_FLOAT32_DROPOUT_OPS if amp else n_gated
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0), amp=amp)
    exe.run(startup, scope=scope)
    feed = train_batch(batch)
    # an earlier phase's executor and its prepared programs refer to each
    # other: collect them, or their scope's tensors count towards this peak
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    ptt.flags.set_flag("dropout_impl", impl)
    try:
        native.reset_launches()
        for _ in range(steps):
            t0 = time.perf_counter()
            out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(out).reshape(-1)[0]))
        launches = dict(native.launches)
    finally:
        ptt.flags.set_flag("dropout_impl", "auto")
    peak = torch.cuda.max_memory_allocated()
    tag = f"train-base{'' if fused else '-unfused'}{'-amp' if amp else ''} " \
        f"({impl}{', ' + str(model) if model else ''})"
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag} losses not finite: {losses}")
    k = min(3, steps // 2)
    if not max(losses[-k:]) < min(losses[:k]):
        raise AssertionError(f"{tag} loss did not fall: {losses}")
    cfg = dict(TRAIN_BASE, **(model or {}))
    n_attn = 3 * cfg["n_layer"]
    sfx = "_bf16" if amp else ""
    want = dict.fromkeys(launches, 0)
    if fused:
        want.update({f"flash_fwd{sfx}": 2 * n_attn * steps,
                     f"flash_dq{sfx}": n_attn * steps,
                     f"flash_dkv{sfx}": n_attn * steps * fa.dkv_grids(
                         cfg["d_model"] // cfg["n_head"]),
                     f"flash_delta{sfx}": n_attn * steps})
    if impl == "pallas":        # the forward and the grad of every gated op
        if n_gated < 1:
            raise AssertionError("no dropout op of train-base passes the gate")
        want["dropout"] = 2 * n_f32 * steps
        if amp:
            want["dropout_bf16"] = 2 * (n_gated - n_f32) * steps
    # nothing in a step reads a dropout op's Mask: no launch writes it
    want["dropout_mask"] = 0
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")
    last = sorted(step_ms[1:][-5:])     # the first step sets up cuBLAS
    med = last[len(last) // 2]
    # model work as model_macs counts it (the products of `mul`; the
    # attention inside the flash kernels is not counted), forward and two
    # backward products, against the bf16 tensor-core peak
    step_flop = 3 * 2 * model_macs(main) * batch
    bound_ms = step_flop / PEAK_BF16_FLOPS * 1e3
    return dict(impl=impl, amp=amp, fused=fused, batch=batch, steps=steps,
                model=model, losses=losses,
                step_ms=step_ms, step_ms_median=med,
                tokens_per_s=batch * TRAIN_BASE["seq_len"] / med * 1e3,
                peak_bytes=peak, launches=launches, gated_dropout_ops=n_gated,
                float32_dropout_ops=n_f32 if amp else None,
                step_flop=step_flop, bf16_bound_ms=bound_ms,
                bf16_bound_share=bound_ms / med)


def run_train_parity(torch, ptt, dropout_rate, impl):
    """The same startup state, as numpy, on the card and on the host:
    PARITY_STEPS steps of train-base at `dropout_rate` with
    ``FLAGS_dropout_impl`` at `impl`; returns both losses."""
    import numpy as np
    from paddle_tpu_torch.core.executor import fetch_var
    main, startup, loss = build_train(ptt, dropout_rate=dropout_rate)
    scope0 = ptt.Scope()
    ptt.Executor(ptt.CUDAPlace(0)).run(startup, scope=scope0)
    arrays = {n: fetch_var(n, scope0) for n in scope0.local_var_names()}
    del scope0
    feed = train_batch(PARITY_BATCH)
    losses = {}
    ptt.flags.set_flag("dropout_impl", impl)
    try:
        for name, place in (("card", ptt.CUDAPlace(0)),
                            ("host", ptt.CPUPlace())):
            scope = ptt.io.state_from_numpy(arrays, place)
            exe = ptt.Executor(place)
            losses[name] = [float(np.asarray(exe.run(
                main, feed=feed, fetch_list=[loss],
                scope=scope)[0]).reshape(-1)[0])
                for _ in range(PARITY_STEPS)]
            del scope
    finally:
        ptt.flags.set_flag("dropout_impl", "auto")
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                  losses["host"]))
    if not rel <= LOSS_RTOL:
        raise AssertionError(f"train parity (dropout {dropout_rate}, {impl}): "
                             f"card losses {losses['card']} vs host "
                             f"{losses['host']}: relative error {rel} > "
                             f"{LOSS_RTOL}")
    return dict(losses=losses, rel_err=rel, dropout_rate=dropout_rate,
                impl=impl)


def build_resnet(ptt, lr=RESNET_LR, **overrides):
    """ResNet-50 (RESNET50 with `overrides`) + Momentum(lr,
    RESNET_MOMENTUM): (main, startup, fetches)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import resnet
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = resnet.build(**dict(RESNET50, **overrides))
        optimizer.Momentum(learning_rate=lr,
                           momentum=RESNET_MOMENTUM).minimize(fetches["loss"])
    return main, startup, fetches


def resnet_batch(batch, seed=DATA_SEED):
    """Synthetic images in [0, 1) and labels in [0, 1000), as bench.py
    makes them, from `seed`."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(batch, 224, 224, 3).astype(np.float32),
            "label": rng.randint(0, RESNET50["class_dim"],
                                 (batch, 1)).astype(np.int64)}


def model_macs(program):
    """Multiply-adds a sample of the program's forward convs and matrix
    products, counted from their var shapes: a conv's output elements
    times its filter's (C / groups) * kh * kw, a `mul`'s K * N."""
    import math
    block = program.global_block()
    macs = 0
    for op in block.ops:
        if op.type == "conv2d":
            out = block.var(op.outputs["Output"][0]).shape
            w = block.var(op.inputs["Filter"][0]).shape
            macs += math.prod(out[1:]) * math.prod(w[1:])
        elif op.type == "mul":
            x = block.var(op.inputs["X"][0]).shape
            y = block.var(op.inputs["Y"][0]).shape
            k = op.attrs.get("x_num_col_dims", 1)
            macs += (math.prod(x[k:]) * math.prod(y[op.attrs.get(
                "y_num_col_dims", 1):]) * math.prod(x[1:k]))
    return macs


def run_train_resnet50(torch, ptt, native, amp=False):
    """RESNET_STEPS steps of train-resnet50 on the card on one fixed batch,
    staged on the card first (bench.py stages its batches so), under bf16
    mixed precision when `amp` (`run_train_model`)."""
    main, startup, fetches = build_resnet(ptt)
    return run_train_model(
        torch, ptt, native, f"train-resnet50{'-amp' if amp else ''}", main,
        startup, fetches["loss"], resnet_batch(RESNET_BATCH), RESNET_STEPS,
        RESNET_BATCH, amp=amp)


# train-resnet50-reader: train-resnet50 fed as a Fluid user feeds it, from
# a RecordIO file: READER_SAMPLES uint8 HWC images of 224 x 224 x 3
# (150,528 bytes each, as a decoded JPEG) with int64 labels from
# RandomState(0), decoded by READER_WORKERS xmap_readers threads to
# float32 (/ 255, minus ImageNet's per-channel mean) and batched by 128:
# 8 steps a pass
READER_SAMPLES = 1024
READER_WORKERS = 4
READER_MEAN = (0.485, 0.456, 0.406)
# (a) Trainer.train for 2 epochs with an ark checkpoint every
# READER_CKPT_STEPS steps; the checkpoint dir is copied just before step
# READER_SNAP_STEP, as a crash there would leave it, and a second Trainer
# resumes from that copy's newest serial (step 4, mid-epoch). Both runs
# take cuDNN's deterministic algorithms (torch.backends.cudnn.deterministic),
# so the resumed run's losses must equal the uninterrupted run's bit for
# bit, not within a tolerance
READER_CKPT_STEPS, READER_SNAP_STEP = 4, 6
# (b) AsyncFeeder, float32 and AMP: READER_WARMUP steps (allocator and
# cuDNN warm-up), READER_FILL steps while the pipeline fills its buffers
# (xmap's 2 x 256 samples, the feeder's queue), READER_STEPS steady steps
# (the feed's cost), then READER_DRAIN steps on what those buffers hold
# once the source is spent (the producer idle), each phase's median kept
# apart; then READER_STAGED_STEPS steps on the last batch, staged on the
# card, for the same call's comparison
READER_WARMUP, READER_FILL, READER_STEPS, READER_DRAIN = 2, 6, 16, 10
READER_STAGED_STEPS = 8
READER_CAPACITY = 4


def write_reader_data(ptt, path):
    """READER_SAMPLES (image, label) samples from RandomState(0) written
    with convert_reader_to_recordio_file (default compressor); returns
    seconds, bytes and the codec path that ran."""
    import numpy as np
    from paddle_tpu_torch import recordio

    def samples():
        rng = np.random.RandomState(0)
        for _ in range(READER_SAMPLES):
            yield (rng.randint(0, 256, (224, 224, 3), dtype=np.uint8),
                   rng.randint(0, RESNET50["class_dim"], (1,)).astype(
                       np.int64))

    t0 = time.perf_counter()
    n = ptt.convert_reader_to_recordio_file(path, samples)
    seconds = time.perf_counter() - t0
    assert n == READER_SAMPLES, n
    return dict(seconds=seconds, bytes=os.path.getsize(path),
                codec="native" if recordio._load_native() else "python")


def reader_pipeline(ptt, path, passes=1, batches=None):
    """recordio -> xmap_readers (decode to float32 in numpy) -> batch(128,
    drop_last): the batched reader a Fluid user builds; `passes` over the
    file, cut to `batches` batches at the source (so that no decode
    thread is left blocked on a reader nobody drains)."""
    import numpy as np
    mean = np.asarray(READER_MEAN, np.float32)
    scale = np.float32(1.0 / 255.0)

    def decode(sample):
        image, label = sample
        return image.astype(np.float32) * scale - mean, label

    source = ptt.reader.creator.recordio(path)
    if passes > 1:
        source = ptt.reader.chain(*[source] * passes)
    if batches is not None:
        source = ptt.reader.firstn(source, batches * RESNET_BATCH)
    return ptt.reader.batch(
        ptt.reader.xmap_readers(decode, source, READER_WORKERS,
                                2 * RESNET_BATCH, order=True),
        RESNET_BATCH, drop_last=True)


def _resnet_train_func():
    from paddle_tpu_torch.models import resnet
    return resnet.build(**RESNET50)[1]["loss"]


def _resnet_optimizer():
    from paddle_tpu_torch import optimizer
    return optimizer.Momentum(learning_rate=RESNET_LR,
                              momentum=RESNET_MOMENTUM)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def run_reader_trainer(torch, ptt, path, tmp):
    """(a): Trainer.train, 2 epochs from the RecordIO file with ark
    checkpoints; a second Trainer resumes from the copy taken before step
    READER_SNAP_STEP: its losses must equal the first run's from the
    resumed step on, bit for bit (cuDNN deterministic)."""
    import shutil
    import numpy as np
    ckpt, snap = os.path.join(tmp, "ckpt"), os.path.join(tmp, "snap")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for name, ckdir in (("full", ckpt), ("resumed", snap)):
            t0 = time.perf_counter()
            trainer = ptt.Trainer(_resnet_train_func, _resnet_optimizer,
                                  place=ptt.CUDAPlace(0))
            build_s = time.perf_counter() - t0
            losses, steps, ends = [], [], []

            def handler(e):
                if isinstance(e, ptt.BeginStepEvent):
                    steps.append(e.step)
                    if name == "full" and e.step == READER_SNAP_STEP:
                        shutil.copytree(ckpt, snap)
                elif isinstance(e, ptt.EndStepEvent):
                    losses.append(float(np.asarray(e.metrics[0]).reshape(
                        -1)[0]))
                    ends.append(time.perf_counter())

            t0 = time.perf_counter()
            trainer.train(num_epochs=2, event_handler=handler,
                          reader=reader_pipeline(ptt, path),
                          feed_order=["image", "label"],
                          checkpoint=ptt.ark.CheckpointConfig(
                              checkpoint_dir=ckdir,
                              step_interval=READER_CKPT_STEPS,
                              max_num_checkpoints=3))
            train_s = time.perf_counter() - t0
            step_ms = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
            runs[name] = dict(build_s=build_s, train_s=train_s,
                              first_step=steps[0], steps=len(steps),
                              losses=losses, step_ms=step_ms,
                              serials=[s for s, _ in ptt.ark.list_checkpoints(
                                  ckdir)])
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = det
    full, resumed = runs["full"], runs["resumed"]
    for r in runs.values():
        if not all(np.isfinite(r["losses"])):
            raise AssertionError(f"train-resnet50-reader Trainer losses not "
                                 f"finite: {r['losses']}")
    if full["steps"] != 2 * READER_SAMPLES // RESNET_BATCH:
        raise AssertionError(f"Trainer ran {full['steps']} steps")
    k = resumed["first_step"]
    if k != READER_SNAP_STEP - READER_SNAP_STEP % READER_CKPT_STEPS \
            or resumed["losses"] != full["losses"][k:]:
        raise AssertionError(
            f"the resumed Trainer (from step {k}) parts from the "
            f"uninterrupted run: {resumed['losses']} vs "
            f"{full['losses'][k:]}")
    return runs


def _h2d_ms(torch, host, reps=5):
    """One batch's image array host to device: from pageable memory on the
    current stream, and from a pinned buffer on a side stream with
    non_blocking=True (CUDA events, median of `reps`)."""
    dev = torch.device("cuda", 0)
    src = torch.from_numpy(host)
    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    pinned.copy_(src)
    out = torch.empty(src.shape, dtype=src.dtype, device=dev)
    side = torch.cuda.Stream()
    res = {}
    for name, stream, buf, nb in (("pageable", torch.cuda.current_stream(),
                                   src, False),
                                  ("pinned", side, pinned, True)):
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                e0.record()
                out.copy_(buf, non_blocking=nb)
                e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        res[name] = _median(times)
    t0 = time.perf_counter()
    pinned.copy_(src)
    res["host_to_pinned"] = (time.perf_counter() - t0) * 1e3
    res["bytes"] = src.numel() * src.element_size()
    return res


def run_reader_async(torch, ptt, path, amp):
    """(b): AsyncFeeder(DataFeeder, reader, capacity, prepared=handle),
    READER_WARMUP + READER_FILL + READER_STEPS + READER_DRAIN steps; each
    feed on the card before its step; then READER_STAGED_STEPS steps on
    the last feed, staged. The steady steps give the feed's cost."""
    import numpy as np
    from paddle_tpu_torch.async_feeder import AsyncFeeder
    main, startup, fetches = build_resnet(ptt)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0), amp=amp)
    exe.run(startup, scope=scope)
    handle = exe.prepare(main, fetch_list=[fetches["loss"]], scope=scope)
    n_steps = READER_WARMUP + READER_FILL + READER_STEPS + READER_DRAIN
    per_pass = READER_SAMPLES // RESNET_BATCH
    feeder = AsyncFeeder(
        ptt.DataFeeder(["image", "label"], program=main),
        reader_pipeline(ptt, path, passes=-(-n_steps // per_pass),
                        batches=n_steps),
        capacity=READER_CAPACITY, prepared=handle)
    losses, step_ms, other_cpu_ms = [], [], []
    feed = None
    it = iter(feeder)
    torch.cuda.synchronize()
    while True:
        t0 = time.perf_counter()
        cpu0, own0 = time.process_time(), time.thread_time()
        try:
            feed = next(it)
        except StopIteration:
            break
        if not all(t.is_cuda for t in feed.values()):
            raise AssertionError("AsyncFeeder handed the step a host feed")
        out, = handle.run(feed)
        losses.append(float(np.asarray(out).reshape(-1)[0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        # CPU time the process's other threads took during the step: the
        # pipeline's decode, stacking and copies, which share the
        # interpreter lock with the step's thread
        other_cpu_ms.append(((time.process_time() - cpu0)
                             - (time.thread_time() - own0)) * 1e3)
    staged_ms = []
    for _ in range(READER_STAGED_STEPS):
        t0 = time.perf_counter()
        out, = handle.run(feed)
        staged_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(out).reshape(-1)[0]))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train-resnet50-reader AsyncFeeder losses not "
                             f"finite: {losses}")
    if len(step_ms) != n_steps:
        raise AssertionError(f"AsyncFeeder delivered {len(step_ms)} batches")
    a = READER_WARMUP + READER_FILL
    b = a + READER_STEPS
    steady = step_ms[a:b]
    res = dict(amp=amp, losses=losses, step_ms=step_ms,
               step_ms_median=_median(steady),
               images_per_s=RESNET_BATCH * len(steady) / sum(steady) * 1e3,
               wait_ms=[x * 1e3 for x in feeder.waits_s],
               wait_ms_mean=float(np.mean(feeder.waits_s[a:b])) * 1e3,
               starved_steady=int(sum(feeder.starved[a:b])),
               produce_ms=[x * 1e3 for x in feeder.produce_s],
               produce_ms_mean=float(np.mean(feeder.produce_s[a:b])) * 1e3,
               pinned_allocs=feeder.stager.pinned_allocs,
               depths=list(feeder.depths), other_cpu_ms=other_cpu_ms,
               fill_ms_median=_median(step_ms[READER_WARMUP:a]),
               drain_ms_median=_median(step_ms[b:]),
               fill_other_cpu_ms=_median(other_cpu_ms[READER_WARMUP:a]),
               steady_other_cpu_ms=_median(other_cpu_ms[a:b]),
               drain_other_cpu_ms=_median(other_cpu_ms[b:]),
               staged_ms=staged_ms, staged_ms_median=_median(staged_ms))
    # the feed's cost: steady steps against the staged ones; the fill
    # phase's is kept apart, as a start-up cost
    res["loss_to_staged_ms"] = res["step_ms_median"] - res["staged_ms_median"]
    res["fill_to_staged_ms"] = res["fill_ms_median"] - res["staged_ms_median"]
    del handle, exe, scope, feed, it, feeder
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_reader_py_reader(torch, ptt, path):
    """(c): layers.py_reader feeding ResNet-50; exe.run(feed=None) until
    EOFException, two passes with reset() between, each feed popped on
    the card."""
    import numpy as np
    from paddle_tpu_torch import layers, optimizer
    from paddle_tpu_torch.models import resnet
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        reader, (image, label) = layers.py_reader(
            capacity=READER_CAPACITY, shapes=[[-1, 224, 224, 3], [-1, 1]],
            dtypes=["float32", "int64"])
        predict = resnet.resnet_imagenet(
            image, class_dim=RESNET50["class_dim"], depth=RESNET50["depth"],
            data_format=RESNET50["data_format"])
        loss = layers.mean(layers.cross_entropy(input=predict, label=label))
        optimizer.Momentum(learning_rate=RESNET_LR,
                           momentum=RESNET_MOMENTUM).minimize(loss)
    reader.decorate_paddle_reader(reader_pipeline(ptt, path))
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    pop = reader.next_feed
    host_pops = []

    def checked_pop(device=None):
        feed = pop(device)
        host_pops.extend(n for n, t in feed.items() if not t.is_cuda)
        return feed

    reader.next_feed = checked_pop
    passes = []
    for _ in range(2):
        reader.start()
        losses, step_ms = [], []
        while True:
            t0 = time.perf_counter()
            try:
                out, = exe.run(main, feed=None, fetch_list=[loss],
                               scope=scope)
            except ptt.EOFException:
                reader.reset()
                break
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(out).reshape(-1)[0]))
        passes.append(dict(losses=losses, step_ms=step_ms,
                           step_ms_median=_median(step_ms[1:])))
    if host_pops:
        raise AssertionError(f"py_reader handed the step host feeds: "
                             f"{host_pops}")
    for p in passes:
        if len(p["losses"]) != READER_SAMPLES // RESNET_BATCH or \
                not all(np.isfinite(p["losses"])):
            raise AssertionError(f"py_reader pass: {p['losses']}")
    pinned = reader._stager.pinned_allocs
    del exe, scope, reader
    gc.collect()
    torch.cuda.empty_cache()
    return dict(passes=passes, pinned_allocs=pinned)


def run_train_resnet50_reader(torch, ptt, native, staged_fp32_ms):
    """Phase 6c: train-resnet50 from a RecordIO file through the user's
    entry points, no kernel of csrc/ launched."""
    import numpy as np
    res = {}
    native.reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_reader_") as tmp:
        path = os.path.join(tmp, "train.recordio")
        res["write"] = write_reader_data(ptt, path)
        t0 = time.perf_counter()
        res["trainer"] = run_reader_trainer(torch, ptt, path, tmp)
        res["trainer_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch = next(iter(reader_pipeline(ptt, path, batches=1)()))
        # the stacking DataFeeder does on the step's thread in the
        # synchronous Trainer (np.asarray of the batch's 128 images)
        t1 = time.perf_counter()
        images = np.asarray([b[0] for b in batch], dtype=np.float32)
        stack_ms = (time.perf_counter() - t1) * 1e3
        res["h2d"] = dict(_h2d_ms(torch, images), stack_ms=stack_ms)
        res["async"] = {}
        for amp in (False, True):
            res["async"]["amp" if amp else "fp32"] = run_reader_async(
                torch, ptt, path, amp)
        res["async_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["py_reader"] = run_reader_py_reader(torch, ptt, path)
        res["py_reader_s"] = time.perf_counter() - t0
    res["launches"] = dict(native.launches)
    if any(res["launches"].values()):
        raise AssertionError(f"train-resnet50-reader launched a kernel of "
                             f"csrc/: {res['launches']}")
    res["staged_6b_ms"] = staged_fp32_ms
    return res


def _state_kind(name):
    """A persistable's kind: an optimizer slot, or a parameter."""
    for slot in ("moment1", "moment2", "velocity", "pow_acc"):
        if slot in name:
            return slot
    return "parameters"


def _rel_l2(np, a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def run_step_parity(torch, ptt, name, main, startup, loss, feed, steps,
                    amp=False, init=None, sign_updates=False):
    """`steps` steps of `main` on `feed` (or on the list's feed of each
    step), each on the card and on the host from the host's state after
    the step before (the first from one startup state, run on the card,
    with `init`'s values set over it), under bf16 mixed precision when
    `amp`; returns both sides' losses and the largest share of its
    tolerance that a persistable used. Fails unless every loss stays
    above 0.1, the card's agree with the host's within LOSS_RTOL, the
    running stats within BN_STAT_ATOL + LOSS_RTOL * |host| and every other
    persistable within STATE_L2_RTOL (relative L2). Under AMP each side
    also takes each step in float32 from the same state, and the card is
    held to bf16's own effect on the host (AMP_NOISE_FACTOR above), and
    the output of each op of the policy's bf16 set must be bf16 in every
    AMP step and float32 in every float32 one; the card's float32 losses
    are for the record. With `sign_updates` (an optimizer that divides a
    grad by its own size, Adam's or Adagrad's first steps) an update is
    about lr * sign(grad), so where a grad lies within rounding of 0 the
    two sides step a parameter lr the opposite way: on an H100 80GB
    HBM3 (700 W) a zero-initialized bias of 16 lay 0.5 relative L2 from
    the host's with every grad in agreement. The parameters are then
    held through their optimizer slots, which carry the grads, and
    their largest share is reported (`param_share`), not gated."""
    import numpy as np
    from paddle_tpu_torch.core.executor import fetch_var
    from paddle_tpu_torch.core.registry import AMP_BF16_OPS
    scope0 = ptt.Scope()
    ptt.Executor(ptt.CUDAPlace(0)).run(startup, scope=scope0)
    state = {n: fetch_var(n, scope0) for n in scope0.local_var_names()}
    state.update(init or {})
    del scope0
    feeds = feed if isinstance(feed, list) else [feed] * steps
    stats = {op.inputs[s][0] for op in main.global_block().ops
             if op.type == "batch_norm" for s in ("Mean", "Variance")}
    # the first output of every forward product, convolution and attention
    probes = [op.output_arg_names[0] for op in main.global_block().ops
              if op.type in AMP_BF16_OPS] if amp else []
    losses = {"card": [], "host": []}
    stat_share = l2_share = param_share = 0.0
    l2_worst = None
    params = {p.name for p in main.global_block().all_parameters()}
    sides = [("card", ptt.CUDAPlace(0), amp), ("host", ptt.CPUPlace(), amp)]
    if amp:
        losses.update(card_float32=[], host_float32=[])
        sides += [("card_float32", ptt.CUDAPlace(0), False),
                  ("host_float32", ptt.CPUPlace(), False)]
    for step in range(steps):
        after = {}
        for side, place, side_amp in sides:
            scope = ptt.io.state_from_numpy(state, place)
            out, *probed = ptt.Executor(place, amp=side_amp).run(
                main, feed=feeds[step], fetch_list=[loss] + probes,
                scope=scope, return_numpy=False)
            want = torch.bfloat16 if side_amp else torch.float32
            wrong = {n: t.dtype for n, t in zip(probes, probed)
                     if t.dtype != want}
            if wrong:
                raise AssertionError(f"{name} parity: {side} step made "
                                     f"{wrong}, not {want}")
            del probed
            losses[side].append(float(out.reshape(-1)[0]))
            after[side] = {n: fetch_var(n, scope) for n in state}
            del scope
        dist, noise = {}, {}
        for n, b in after["host"].items():
            a = after["card"][n]
            if not np.issubdtype(b.dtype, np.floating):
                continue
            if amp:
                kind = "running stats" if n in stats else _state_kind(n)
                dist[kind] = max(dist.get(kind, 0.0), _rel_l2(np, a, b))
                noise[kind] = max(noise.get(kind, 0.0), _rel_l2(
                    np, after["host_float32"][n], b))
            elif n in stats:
                stat_share = max(stat_share, float((np.abs(a - b) / (
                    BN_STAT_ATOL + LOSS_RTOL * np.abs(b))).max()))
            else:
                share = _rel_l2(np, a, b) / STATE_L2_RTOL
                if sign_updates and n in params:
                    param_share = max(param_share, share)
                elif share > l2_share:
                    l2_share, l2_worst = share, f"{n} at step {step}"
        for kind, d in dist.items():
            share = d / max(AMP_NOISE_FACTOR * noise[kind], 1e-30)
            if kind == "running stats":
                stat_share = max(stat_share, share)
            else:
                l2_share = max(l2_share, share)
        state = after["host"]
    torch.cuda.empty_cache()

    def rel_of(x, y):
        return max(abs(a - b) / abs(b) for a, b in zip(losses[x],
                                                       losses[y]))

    rel = rel_of("card", "host")
    loss_rtol = LOSS_RTOL
    if amp:
        host_noise = rel_of("host", "host_float32")
        loss_rtol = max(AMP_LOSS_RTOL, AMP_NOISE_FACTOR * host_noise)
        log(f"{name} parity: losses {losses}; card vs host {rel:.3g}, "
            f"card vs its float32 step {rel_of('card', 'card_float32'):.3g}, "
            f"host vs its float32 step {host_noise:.3g}")
    if not min(losses["card"] + losses["host"]) > 0.1:
        raise AssertionError(f"{name} parity: a loss fell below 0.1, where "
                             f"relative errors say little: {losses}")
    if not rel <= loss_rtol:
        raise AssertionError(f"{name} parity: card losses {losses['card']} "
                             f"vs host {losses['host']}: relative error "
                             f"{rel} > {loss_rtol}")
    l2_tol = (f"{AMP_NOISE_FACTOR} x the host's AMP-vs-float32 distance"
              if amp else f"{STATE_L2_RTOL} relative L2")
    if not (stat_share <= 1.0 and l2_share <= 1.0):
        raise AssertionError(f"{name} parity: running stats at {stat_share} "
                             f"of their tolerance, other state at "
                             f"{l2_share} of {l2_tol} (the largest: "
                             f"{l2_worst})")
    return dict(losses=losses, rel_err=rel, n_stats=len(stats),
                n_state=len(state), stat_share=stat_share,
                l2_share=l2_share, param_share=param_share, steps=steps,
                amp=amp, loss_rtol=loss_rtol, l2_tol=l2_tol,
                bf16_probes=len(probes))


def run_amp_parity(torch, ptt):
    """Card against host under AMP, per step from the host's state:
    train-base at the parity batch and dropout 0, and ResNet-50 at batch
    2."""
    main, startup, loss = build_train(ptt, dropout_rate=0.0)
    out = {"transformer": run_step_parity(
        torch, ptt, "transformer-amp", main, startup, loss,
        train_batch(PARITY_BATCH), AMP_PARITY_STEPS, amp=True)}
    main, startup, fetches = build_resnet(ptt, lr=RESNET_PARITY_LR)
    out["resnet50"] = run_step_parity(
        torch, ptt, "resnet50-amp", main, startup, fetches["loss"],
        resnet_batch(RESNET_PARITY_BATCH), AMP_PARITY_STEPS, amp=True)
    return out


def run_resnet50_and_mnist_parity(torch, ptt):
    import numpy as np
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import mnist
    main, startup, fetches = build_resnet(ptt, lr=RESNET_PARITY_LR)
    out = {"resnet50": run_step_parity(
        torch, ptt, "resnet50", main, startup, fetches["loss"],
        resnet_batch(RESNET_PARITY_BATCH), PARITY_STEPS)}
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = mnist.build()
        optimizer.Adam(learning_rate=MNIST_LR).minimize(fetches["loss"])
    rng = np.random.RandomState(DATA_SEED)
    feed = {"pixel": rng.rand(MNIST_PARITY_BATCH, 1, 28, 28).astype(
                np.float32),
            "label": rng.randint(0, 10, (MNIST_PARITY_BATCH, 1)).astype(
                np.int64)}
    out["mnist"] = run_step_parity(torch, ptt, "mnist", main, startup,
                                     fetches["loss"], feed, PARITY_STEPS)
    return out


def run_unfused_parity(torch, ptt):
    """train-base-unfused at the parity batch and dropout 0: card against
    host, UNFUSED_PARITY_STEPS steps each from the host's state, in float32 and
    under AMP; then, on the card from one startup state, the unfused
    step's loss against the fused one's (the flash kernels), within the
    flash forward's tolerance TOL, relative."""
    import numpy as np
    from paddle_tpu_torch.core.executor import fetch_var
    main, startup, loss = build_train(ptt, dropout_rate=0.0,
                                      fused_attention=False)
    feed = train_batch(PARITY_BATCH)
    out = {"float32": run_step_parity(torch, ptt, "train-base-unfused", main,
                                      startup, loss, feed,
                                      UNFUSED_PARITY_STEPS),
           "amp": run_step_parity(torch, ptt, "train-base-unfused-amp", main,
                                  startup, loss, feed, UNFUSED_PARITY_STEPS,
                                  amp=True)}
    fmain, _, floss = build_train(ptt, dropout_rate=0.0)
    exe = ptt.Executor(ptt.CUDAPlace(0))
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    state = {n: fetch_var(n, scope) for n in scope.local_var_names()}
    del scope
    step = {}
    for name, prog, lv in (("unfused", main, loss), ("fused", fmain, floss)):
        sc = ptt.io.state_from_numpy(state, ptt.CUDAPlace(0))
        step[name] = float(np.asarray(exe.run(
            prog, feed=feed, fetch_list=[lv], scope=sc)[0]).reshape(-1)[0])
        del sc
    torch.cuda.empty_cache()
    rel = abs(step["unfused"] - step["fused"]) / abs(step["fused"])
    if not rel <= TOL:
        raise AssertionError(f"train-base unfused vs fused from the same "
                             f"parameters: {step}, relative error {rel} > "
                             f"{TOL}")
    out["unfused_vs_fused"] = dict(losses=step, rel_err=rel, tol=TOL)
    return out


def run_train_model(torch, ptt, native, tag, main, startup, loss, feed,
                    steps, batch, amp=False, impl="auto"):
    """`steps` steps of one of the zoo's models on `feed` (staged on the
    card) with ``FLAGS_dropout_impl`` at `impl`, under bf16 mixed
    precision when `amp`: losses finite, no kernel of the attention or
    dropout paths launched; returns step ms (median of the last 5), peak
    memory and the step's share of its bound (3 x 2 x model_macs x the
    batch at the float32 or bf16 peak)."""
    import numpy as np
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0), amp=amp)
    exe.run(startup, scope=scope)
    feed = {k: torch.from_numpy(v).cuda() for k, v in feed.items()}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    ptt.flags.set_flag("dropout_impl", impl)
    try:
        native.reset_launches()
        for _ in range(steps):
            t0 = time.perf_counter()
            out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(out).reshape(-1)[0]))
        launches = dict(native.launches)
    finally:
        ptt.flags.set_flag("dropout_impl", "auto")
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag} losses not finite: {losses}")
    if any(launches.values()):
        raise AssertionError(f"{tag} launched a kernel of the attention or "
                             f"dropout paths: {launches}")
    last = sorted(step_ms[-5:])
    med = last[len(last) // 2]
    macs = model_macs(main)
    step_flop = 3 * 2 * macs * batch
    bound_ms = step_flop / (PEAK_BF16_FLOPS if amp else PEAK_F32_FLOPS) * 1e3
    types = [op.type for op in main.global_block().ops]
    del scope, exe, feed
    gc.collect()
    torch.cuda.empty_cache()
    return dict(tag=tag, amp=amp, impl=impl, batch=batch, steps=steps,
                losses=losses, step_ms=step_ms, step_ms_median=med,
                samples_per_s=batch / med * 1e3, peak_bytes=peak,
                launches=launches, macs_per_sample=macs, step_flop=step_flop,
                bound_ms=bound_ms, bound_share=bound_ms / med, ops=len(types),
                ops_by_type={t: types.count(t) for t in sorted(set(types))})


def build_se_resnext(ptt, values=SE_LR_VALUES):
    """SE-ResNeXt-50 (SE_RESNEXT50) + Momentum on
    piecewise_decay(SE_LR_BOUNDARIES, `values`) with L2Decay:
    (main, startup, fetches)."""
    from paddle_tpu_torch import optimizer, regularizer
    from paddle_tpu_torch.models import se_resnext
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = se_resnext.build(**SE_RESNEXT50)
        lr = ptt.layers.piecewise_decay(SE_LR_BOUNDARIES, values)
        optimizer.Momentum(
            learning_rate=lr, momentum=SE_MOMENTUM,
            regularization=regularizer.L2Decay(SE_L2)).minimize(
                fetches["loss"])
    return main, startup, fetches


def build_vgg(ptt):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import vgg
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = vgg.build(**VGG16)
        optimizer.Adam(learning_rate=VGG_LR).minimize(fetches["loss"])
    return main, startup, fetches


def build_deepfm(ptt):
    from paddle_tpu_torch import clip, optimizer
    from paddle_tpu_torch.models import deepfm
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = deepfm.build()
        clip.set_gradient_clip(clip.GradientClipByGlobalNorm(DEEPFM_CLIP))
        try:
            optimizer.Adagrad(learning_rate=DEEPFM_LR).minimize(
                fetches["loss"])
        finally:
            clip.set_gradient_clip(None)
    return main, startup, fetches


def deepfm_batch(batch, seed=DATA_SEED):
    """Synthetic CTR rows from `seed`: 13 dense features in [0, 1), 26
    feature ids in [0, 1e5), click labels."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return {"dense_input": rng.rand(batch, 13).astype(np.float32),
            "sparse_input": rng.randint(0, 100000, (batch, 26)).astype(
                np.int64),
            "label": rng.randint(0, 2, (batch, 1)).astype(np.int64)}


# The optimizers that scale a grad by about its own size (Adagrad,
# Adamax, DecayedAdagrad, RMSProp) take 1e-4, a step under which the loss
# falls as in training. At 1e-2 the net blows up (loss 2.7 -> 7.7..84 in
# 3 steps) and Adagrad's second step puts one ReLU input of fc_0 2.3e-7
# from 0: the card's sum lands it on the other side (-1.2e-8), so that
# element's grad, 0.88 % of the layer's, is dropped, and fc_0's Adagrad
# moment parts by 0.97 %: a kink within rounding, not the program (every
# other optimizer at 1e-2 agrees to 5e-6, and a +-1e-7 change of the
# inputs moves the host's own run by 2e-6;
# tools/torch_sweep_sensitivity.py --card, PERF.md section 6)
SWEEP_OPTIMIZERS = {
    "SGD": lambda o: o.SGD(learning_rate=0.1),
    "Adagrad": lambda o: o.Adagrad(learning_rate=1e-4),
    "Adamax": lambda o: o.Adamax(learning_rate=1e-4),
    "DecayedAdagrad": lambda o: o.DecayedAdagrad(learning_rate=1e-4),
    "Adadelta": lambda o: o.Adadelta(learning_rate=1.0),
    "RMSProp": lambda o: o.RMSProp(learning_rate=1e-4),
    "RMSProp-centered": lambda o: o.RMSProp(learning_rate=1e-4, momentum=0.9,
                                            centered=True),
    "Ftrl": lambda o: o.Ftrl(learning_rate=1e-4),
}
SWEEP_SCHEDULES = {
    "exponential_decay": lambda L: L.exponential_decay(0.1, 2, 0.5),
    "natural_exp_decay": lambda L: L.natural_exp_decay(0.1, 2, 0.5),
    "inverse_time_decay": lambda L: L.inverse_time_decay(0.1, 2, 0.5),
    "polynomial_decay": lambda L: L.polynomial_decay(0.1, 4, 0.001, 2.0),
    "piecewise_decay": lambda L: L.piecewise_decay([1, 2], [0.1, 0.05, 0.01]),
    "noam_decay": lambda L: L.noam_decay(SWEEP_WIDTH, 2),
    "exponential_decay-staircase": lambda L: L.exponential_decay(
        0.1, 2, 0.5, staircase=True),
    "polynomial_decay-cycle": lambda L: L.polynomial_decay(
        0.1, 2, 0.001, 2.0, cycle=True),
}
SWEEP_CLIPS = {
    "GradientClipByValue": lambda c: c.GradientClipByValue(0.002),
    "GradientClipByNorm": lambda c: c.GradientClipByNorm(0.05),
    "GradientClipByGlobalNorm": lambda c: c.GradientClipByGlobalNorm(0.1),
}
SWEEP_CASES = ([f"optimizer:{n}" for n in SWEEP_OPTIMIZERS]
               + ["ModelAverage"]
               + [f"schedule:{n}" for n in SWEEP_SCHEDULES]
               + ["append_LARS"]
               + [f"clip:{n}" for n in SWEEP_CLIPS]
               + ["ErrorClipByValue", "per-parameter learning rate"])


def build_sweep(ptt, case, width=SWEEP_WIDTH, optimizers=SWEEP_OPTIMIZERS):
    """The sweep's net (`width` -> `width` -> `width` -> 10) trained as
    `case` says, an "optimizer:<name>" case by `optimizers[name]`:
    (main, startup, loss, ModelAverage or None)."""
    from paddle_tpu_torch import clip, optimizer
    from paddle_tpu_torch.core.backward import append_backward
    L = ptt.layers
    main, startup = ptt.Program(), ptt.Program()
    kind, _, arg = case.partition(":")
    average = None
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = L.data("x", shape=[width], dtype="float32")
        label = L.data("label", shape=[1], dtype="int64")
        attr = ptt.ParamAttr(name="sweep_w0", learning_rate=0.25) \
            if case == "per-parameter learning rate" else None
        h = L.fc(x, width, act="relu", param_attr=attr)
        h = L.fc(h, width, act="relu")
        loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, 10), label))
        if kind == "optimizer":
            optimizers[arg](optimizer).minimize(loss)
        elif kind == "schedule":
            optimizer.SGD(learning_rate=SWEEP_SCHEDULES[arg](L)).minimize(loss)
        elif kind == "clip":
            clip.set_gradient_clip(SWEEP_CLIPS[arg](clip))
            try:
                optimizer.SGD(learning_rate=0.1).minimize(loss)
            finally:
                clip.set_gradient_clip(None)
        elif case in ("append_LARS", "ErrorClipByValue"):
            params_grads = append_backward(loss)
            if case == "append_LARS":
                L.append_LARS(params_grads, L.fill_constant(
                    [1], "float32", 0.01), weight_decay=1e-4)
            else:
                for _, g in params_grads:
                    clip.ErrorClipByValue(0.002).append_clip_op(
                        main.global_block(), g.name)
            optimizer.SGD(learning_rate=0.1)._create_optimization_pass(
                params_grads, loss)
        else:               # ModelAverage, per-parameter learning rate
            optimizer.SGD(learning_rate=0.1).minimize(loss)
            if case == "ModelAverage":
                average = optimizer.ModelAverage(
                    0.5, min_average_window=2, max_average_window=3)
    return main, startup, loss, average


def run_sweep_case(torch, ptt, case, width=SWEEP_WIDTH, batch=SWEEP_BATCH):
    """One case of the sweep: SWEEP_STEPS steps on the card and on the host
    from one startup state (run on the host) and the same feeds; with
    ModelAverage also its apply (the averaged parameters compared) and
    restore (the trained ones back, bit for bit). Returns the largest
    relative loss error and relative L2 distance of a persistable."""
    import numpy as np
    from paddle_tpu_torch.core.executor import fetch_var
    main, startup, loss, average = build_sweep(ptt, case, width)
    scope0 = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope0)
    state = {n: fetch_var(n, scope0) for n in scope0.local_var_names()}
    rng = np.random.RandomState(DATA_SEED)
    feeds = [{"x": rng.randn(batch, width).astype(np.float32),
              "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}
             for _ in range(SWEEP_STEPS)]
    params = [p.name for p in main.global_block().all_parameters()]
    res = {}
    for side, place in (("card", ptt.CUDAPlace(0)), ("host", ptt.CPUPlace())):
        scope = ptt.io.state_from_numpy(state, place)
        exe = ptt.Executor(place)
        losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                           scope=scope)[0]).reshape(-1)[0])
                  for f in feeds]
        after = {n: fetch_var(n, scope) for n in scope.local_var_names()}
        if average is not None:
            with average.apply(exe, scope=scope):
                after.update({f"{n}@averaged": fetch_var(n, scope)
                              for n in params})
            for n in params:
                if not np.array_equal(fetch_var(n, scope), after[n]):
                    raise AssertionError(f"sweep {case} ({side}): restore "
                                         f"did not bring {n} back")
        res[side] = (losses, after)
        del scope
    (cl, ca), (hl, ha) = res["card"], res["host"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(cl, hl))
    state_err, worst = 0.0, None
    for n, b in ha.items():
        if not np.issubdtype(b.dtype, np.floating):
            if not np.array_equal(ca[n], b):
                raise AssertionError(f"sweep {case}: {n} {ca[n]} on the card, "
                                     f"{b} on the host")
            continue
        d = _rel_l2(np, ca[n], b)
        if d > state_err:
            state_err, worst = d, n
    if not (all(np.isfinite(cl)) and loss_err <= SWEEP_LOSS_RTOL
            and state_err <= SWEEP_STATE_L2):
        raise AssertionError(f"sweep {case}: card losses {cl} vs host {hl} "
                             f"(relative error {loss_err}, tol "
                             f"{SWEEP_LOSS_RTOL}); largest state distance "
                             f"{state_err} at {worst} (tol {SWEEP_STATE_L2})")
    return dict(case=case, losses=cl, loss_err=loss_err,
                state_err=state_err, worst=worst, n_state=len(ha))


def run_sweep(torch, ptt, native):
    """Every case of the sweep; none may launch a kernel."""
    native.reset_launches()
    out = [run_sweep_case(torch, ptt, case) for case in SWEEP_CASES]
    if any(native.launches.values()):
        raise AssertionError(f"the optimizer sweep launched a kernel: "
                             f"{dict(native.launches)}")
    torch.cuda.empty_cache()
    return out


def lstm_batch(batch=LSTM_BATCH, seq=LSTM_SEQ, vocab=LSTM["dict_size"],
               seed=LSTM_DATA_SEED):
    """bench.py's stacked_lstm batch: ids [B, T, 1] in [1, vocab), lengths
    uniform in [T / 2, T], labels in {0, 1}, drawn in that order."""
    import numpy as np
    rng = np.random.RandomState(seed)
    words = rng.randint(1, vocab, (batch, seq, 1)).astype(np.int64)
    lens = rng.randint(seq // 2, seq + 1, (batch,)).astype(np.int32)
    label = rng.randint(0, 2, (batch, 1)).astype(np.int64)
    return words, lens, label


def build_stacked_lstm(ptt):
    """models.stacked_dynamic_lstm at LSTM + Adam(LSTM_LR):
    (main, startup, fetches)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import stacked_dynamic_lstm
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = stacked_dynamic_lstm.build(**LSTM)
        optimizer.Adam(learning_rate=LSTM_LR).minimize(fetches["loss"])
    return main, startup, fetches


def traced_busy(torch, fn):
    """Run `fn` once under torch.profiler: (wall s, device busy us, device
    events), busy the union of kernel, copy and set intervals
    (`tools/torch_serve_profile.py::device_breakdown`)."""
    from tools.torch_serve_profile import device_breakdown
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        dev = device_breakdown(path, wall)
    return wall, dev["busy_us"], dev["device_events"]


def run_train_stacked_lstm(torch, ptt, native, amp=False):
    """train-stacked-lstm on the card: LSTM_WARMUP + LSTM_STEPS steps on
    bench.py's fixed batch, staged on the card as a `(words, lengths)`
    pair, under bf16 mixed precision when `amp`. Losses finite and
    falling, no kernel of csrc/ launched; returns step ms (median of the
    timed steps), examples/s, padded and valid tokens/s, peak memory
    above what the card held before the model was built, and under
    "step" the step itself, which `trace_train_stacked_lstm` runs once
    traced. The phase times every run before it traces any: a
    torch.profiler session leaves a cost on each later launch
    (`tools/torch_lstm_step_probe.py`)."""
    import numpy as np
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    main, startup, fetches = build_stacked_lstm(ptt)
    loss = fetches["loss"]
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0), amp=amp)
    exe.run(startup, scope=scope)
    words, lens, label = lstm_batch()
    feed = {"words": (torch.from_numpy(words).cuda(),
                      torch.from_numpy(lens).cuda()),
            "label": torch.from_numpy(label).cuda()}
    gc.collect()
    torch.cuda.synchronize()

    def step():
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        return float(np.asarray(out).reshape(-1)[0])

    losses, step_ms = [], []
    native.reset_launches()
    for _ in range(LSTM_WARMUP + LSTM_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(native.launches)
    peak = torch.cuda.max_memory_allocated() - base
    tag = f"train-stacked-lstm{'-amp' if amp else ''}"
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag} losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag} loss did not fall on its fixed batch: "
                             f"{losses}")
    if any(launches.values()):
        raise AssertionError(f"{tag} launched a kernel of csrc/: {launches}")
    timed = sorted(step_ms[LSTM_WARMUP:])
    med = timed[len(timed) // 2]
    types = [op.type for op in main.global_block().ops]
    return dict(tag=tag, amp=amp, batch=LSTM_BATCH, seq=LSTM_SEQ,
                valid_tokens=int(lens.sum()), warmup=LSTM_WARMUP,
                steps=LSTM_STEPS, losses=losses, step_ms=step_ms,
                step_ms_median=med, examples_per_s=LSTM_BATCH / med * 1e3,
                padded_tokens_per_s=LSTM_BATCH * LSTM_SEQ / med * 1e3,
                valid_tokens_per_s=int(lens.sum()) / med * 1e3,
                peak_bytes=peak, launches=launches, ops=len(types),
                lstm_ops=types.count("lstm"), step=step)


def trace_train_stacked_lstm(torch, run):
    """One step of a `run_train_stacked_lstm` run under torch.profiler:
    adds the traced step's wall, the device busy time, its share of the
    traced step and of the untraced median, and the device events; drops
    the step, and with it the run's model and state."""
    traced_s, busy_us, n_events = traced_busy(torch, run.pop("step"))
    run.update(traced_step_ms=traced_s * 1e3, busy_us=busy_us,
               busy_share=busy_us / (traced_s * 1e6),
               busy_over_untraced=busy_us / (run["step_ms_median"] * 1e3),
               device_events=n_events)
    gc.collect()
    torch.cuda.empty_cache()
    return run


def run_stacked_lstm_parity(torch, ptt):
    """Card against host, PARITY_STEPS steps each from the host's state
    (`run_step_parity`): a two-layer stacked LSTM LSTM_PARITY_WIDTH wide,
    its second layer reversed, batch 4 padded to 12 steps with the
    lengths LSTM_PARITY_LENS."""
    import numpy as np
    from paddle_tpu_torch import optimizer
    L = ptt.layers
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        words = L.data("words", shape=[1], dtype="int64", lod_level=1)
        label = L.data("label", shape=[1], dtype="int64")
        inp = L.embedding(words, size=[LSTM_PARITY_DICT, LSTM_PARITY_WIDTH])
        for reverse in (False, True):
            proj = L.fc(inp, size=4 * LSTM_PARITY_WIDTH, num_flatten_dims=2)
            inp, _ = L.dynamic_lstm(proj, size=4 * LSTM_PARITY_WIDTH,
                                    is_reverse=reverse)
        prob = L.fc(L.sequence_pool(inp, "max"), size=2, act="softmax")
        loss = L.mean(L.cross_entropy(prob, label))
        optimizer.Adam(learning_rate=LSTM_LR).minimize(loss)
    lens = np.array(LSTM_PARITY_LENS, np.int32)
    words_np, _, label_np = lstm_batch(len(lens), max(lens),
                                       LSTM_PARITY_DICT, DATA_SEED)
    return run_step_parity(torch, ptt, "stacked-lstm", main, startup, loss,
                           {"words": (words_np, lens), "label": label_np},
                           PARITY_STEPS)


def _seq_op_cases():
    """{name: (build(L, helper_cls) -> (loss or None, [fetch names]),
    feed)}: each sequence op and the recurrent rules the stacked LSTM
    does not run, at B 4, T 6, D 4 (lengths 1 and 6 among them), nested
    where the rule takes it."""
    import numpy as np
    rng = np.random.RandomState(DATA_SEED)
    B, T, D = 4, 6, 4
    lens = np.array([1, 6, 3, 5], np.int32)
    x = rng.randn(B, T, D).astype(np.float32)
    y = rng.randn(B, T + 2, D).astype(np.float32)
    xn = rng.randn(2, 3, 5, D).astype(np.float32)
    nested = (np.array([3, 3], np.int32),
              np.array([[2, 5, 1], [4, 1, 3]], np.int32))
    g = rng.randn(B, T, 4 * D).astype(np.float32)
    ids = rng.randint(0, 4, (B, T, 1)).astype(np.int64)

    def seq(L, name="x", width=D, lod_level=1, dtype="float32"):
        return L.data(name, shape=[width], dtype=dtype, lod_level=lod_level,
                      stop_gradient=dtype != "float32")

    def head(L, out, name="head_w"):
        return L.mean(L.fc(out, 1, num_flatten_dims=len(out.shape) - 1,
                           bias_attr=False, param_attr=name))

    def one(fn, lod_level=1):
        def build(L, H):
            out = fn(L, seq(L, lod_level=lod_level))
            return head(L, out), [out.name]
        return build

    cases = {f"sequence_pool-{p}": (one(lambda L, v, p=p:
                                        L.sequence_pool(v, p)),
                                    {"x": (x, lens)})
             for p in ("average", "sum", "sqrt", "max", "last", "first")}
    cases["sequence_pool-max-nested"] = (
        one(lambda L, v: L.sequence_pool(v, "max"), 2), {"x": (xn, nested)})
    cases["sequence_softmax"] = (one(lambda L, v: L.sequence_softmax(v)),
                                 {"x": (x, lens)})
    cases["sequence_softmax-nested"] = (
        one(lambda L, v: L.sequence_softmax(v), 2), {"x": (xn, nested)})
    cases["sequence_reshape"] = (one(lambda L, v: L.sequence_reshape(v, 2)),
                                 {"x": (x, lens)})
    cases["sequence_conv"] = (one(lambda L, v: L.sequence_conv(
        v, num_filters=5, filter_size=3, act="sigmoid")), {"x": (x, lens)})
    cases["sequence_conv-nested"] = (one(lambda L, v: L.sequence_conv(
        v, num_filters=5, filter_size=4), 2), {"x": (xn, nested)})
    cases["row_conv"] = (one(lambda L, v: L.row_conv(v, 2)),
                         {"x": (x, lens)})

    def concat(L, H):
        a, b = seq(L), seq(L, "y")
        out = L.sequence_concat([a, L.scale(b, 2.0)])
        return head(L, out), [out.name, out.name + "@SEQLEN"]
    cases["sequence_concat"] = (concat, {"x": (x, lens), "y": (
        y, np.array([8, 2, 1, 7], np.int32))})

    def expand(L, H):
        xd = L.data("xd", shape=[D], stop_gradient=False)
        out = L.sequence_expand(xd, seq(L, "y", dtype="float32"))
        return head(L, out), [out.name]
    cases["sequence_expand"] = (expand, {"xd": x[:, 0].copy(),
                                         "y": (x, lens)})

    def expand_as(L, H):
        xd = L.data("xd", shape=[D], stop_gradient=False)
        helper = H("sequence_expand_as")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op("sequence_expand_as",
                         inputs={"X": [xd.name], "Y": [seq(L, "y").name]},
                         outputs={"Out": [out.name]})
        return head(L, out), [out.name]
    cases["sequence_expand_as"] = (expand_as, {"xd": x[:, 0].copy(),
                                               "y": (x, lens)})

    def slice_(L, H):
        off = L.data("off", shape=[1], dtype="int64")
        ln = L.data("len", shape=[1], dtype="int64")
        out = L.sequence_slice(seq(L), off, ln)
        return head(L, out), [out.name, out.name + "@SEQLEN"]
    cases["sequence_slice"] = (slice_, {
        "x": (x, lens), "off": np.array([[0], [2], [-1], [4]], np.int64),
        "len": np.array([[1], [3], [2], [9]], np.int64)})

    def erase(L, H):
        out = L.sequence_erase(seq(L, width=1, dtype="int64"), [0, 2])
        return None, [out.name, out.name + "@SEQLEN"]
    cases["sequence_erase"] = (erase, {"x": (ids, lens)})

    def mask(L, H):
        out = L.sequence_mask(L.data("n", shape=[], dtype="int64"),
                              maxlen=T)
        return None, [out.name]
    cases["sequence_mask"] = (mask, {"n": lens.astype(np.int64)})

    def gru(L, H):
        h0 = L.data("h0", shape=[D], stop_gradient=False)
        h = L.dynamic_gru(seq(L, width=3 * D), size=D, is_reverse=True,
                          h_0=h0)
        return head(L, h), [h.name]
    cases["gru-reverse-h0"] = (gru, {"x": (g[..., :3 * D], lens),
                                     "h0": x[:, 1].copy()})

    def lstmp(L, H):
        p, c = L.dynamic_lstmp(seq(L, width=4 * D), size=4 * D, proj_size=3,
                               is_reverse=True)
        return L.elementwise_add(head(L, p), head(L, c, "head_c")), \
            [p.name, c.name]
    cases["lstmp-peepholes-reverse"] = (lstmp, {"x": (g, lens)})

    def lstm(L, H):
        h0 = L.data("h0", shape=[D], stop_gradient=False)
        c0 = L.data("c0", shape=[D], stop_gradient=False)
        h, c = L.dynamic_lstm(seq(L, width=4 * D), size=4 * D,
                              use_peepholes=False, is_reverse=True,
                              h_0=h0, c_0=c0)
        return L.elementwise_add(head(L, h), head(L, c, "head_c")), \
            [h.name, c.name]
    cases["lstm-reverse-h0-c0"] = (lstm, {"x": (g, lens),
                                          "h0": x[:, 1].copy(),
                                          "c0": x[:, 2].copy()})

    def units(L, H):
        xu, hp, cp = (L.data(n, shape=[D], stop_gradient=False)
                      for n in ("xu", "hp", "cp"))
        h, c = L.lstm_unit(xu, hp, cp, forget_bias=0.5)
        gh, _, _ = L.gru_unit(L.data("gx", shape=[3 * D],
                                     stop_gradient=False), h, size=3 * D)
        return L.elementwise_add(head(L, c), head(L, gh, "head_g")), \
            [h.name, c.name, gh.name]
    cases["lstm_unit-gru_unit"] = (units, {
        "xu": x[:, 0].copy(), "hp": x[:, 1].copy(), "cp": x[:, 2].copy(),
        "gx": g[:, 0, :3 * D].copy()})
    return cases


def run_seq_op_sweep(torch, ptt, native):
    """Each case of `_seq_op_cases` with its backward, on the card and on
    the host from one startup state: every output, companion and grad (of
    each float input and parameter) within SEQ_OP_TOL (1 + |host|),
    integers equal; no kernel of csrc/ launched."""
    import numpy as np
    from paddle_tpu_torch.core.backward import append_backward
    from paddle_tpu_torch.core.executor import fetch_var
    from paddle_tpu_torch.layer_helper import LayerHelper
    out = []
    native.reset_launches()
    for name, (build, feed) in _seq_op_cases().items():
        main, startup = ptt.Program(), ptt.Program()
        with ptt.program_guard(main, startup), ptt.unique_name.guard():
            loss, fetch = build(ptt.layers, LayerHelper)
            if loss is not None:
                append_backward(loss)
                gb = main.global_block()
                fetch += sorted(
                    n for n in gb.vars if n.endswith("@GRAD")
                    and n[:-5] in gb.vars
                    and (gb.vars[n[:-5]].is_data
                         or gb.vars[n[:-5]].persistable))
        scope = ptt.Scope()
        ptt.Executor(ptt.CPUPlace()).run(startup, scope=scope)
        state = {n: fetch_var(n, scope) for n in scope.local_var_names()}
        got = {}
        for side, place in (("card", ptt.CUDAPlace(0)),
                            ("host", ptt.CPUPlace())):
            got[side] = ptt.Executor(place).run(
                main, feed=feed, fetch_list=fetch,
                scope=ptt.io.state_from_numpy(state, place))
        share = 0.0
        for n, a, b in zip(fetch, got["card"], got["host"]):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"sequence op sweep {name}: {n} is "
                                     f"{a.dtype}{a.shape} on the card, "
                                     f"{b.dtype}{b.shape} on the host")
            if not np.issubdtype(b.dtype, np.floating):
                if not np.array_equal(a, b):
                    raise AssertionError(f"sequence op sweep {name}: {n} "
                                         f"differs: {a} vs {b}")
                continue
            share = max(share, float((np.abs(a - b) / (
                SEQ_OP_TOL * (1 + np.abs(b)))).max(initial=0.0)))
        if not share <= 1.0:
            raise AssertionError(f"sequence op sweep {name}: card vs host "
                                 f"at {share:.3g} of SEQ_OP_TOL")
        out.append(dict(case=name, fetched=len(fetch), tol_share=share))
    if any(native.launches.values()):
        raise AssertionError(f"the sequence op sweep launched a kernel: "
                             f"{dict(native.launches)}")
    return out


def mt_batch(batch=MT_BATCH, seed=MT_DATA_SEED, vocab=MT["dict_size"]):
    """A machine_translation batch: sources [B, MT_SRC_MAX, 1] with
    lengths uniform in [MT_SRC_MIN, MT_SRC_MAX]; targets of lengths in
    the same range, each `<s> w1 .. wn` with label `w1 .. wn </s>` (start
    id 0, end id 1), padded to MT_TRG with the end id. Drawn in that
    order from RandomState(seed)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    lens = rng.randint(MT_SRC_MIN, MT_SRC_MAX + 1, batch).astype(np.int32)
    src = rng.randint(2, vocab, (batch, MT_SRC_MAX, 1)).astype(np.int64)
    src[np.arange(MT_SRC_MAX)[None, :] >= lens[:, None]] = 0
    trg_lens = rng.randint(MT_SRC_MIN, MT_TRG, batch)
    words = rng.randint(2, vocab, (batch, MT_TRG)).astype(np.int64)
    trg = np.ones((batch, MT_TRG, 1), np.int64)
    lbl = np.ones((batch, MT_TRG, 1), np.int64)
    for b, n in enumerate(trg_lens):
        trg[b, 0, 0] = 0
        trg[b, 1:n + 1, 0] = words[b, :n]
        lbl[b, :n, 0] = words[b, :n]
    return src, lens, trg, lbl, int(trg_lens.sum() + batch)


def build_mt(ptt):
    """models.machine_translation.build at MT + Adam(MT_LR):
    (main, startup, fetches)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import machine_translation
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = machine_translation.build(**MT)
        optimizer.Adam(learning_rate=MT_LR).minimize(fetches["loss"])
    return main, startup, fetches


def run_train_mt(torch, ptt, native):
    """train-mt on the card: MT_WARMUP + MT_STEPS steps on one batch,
    staged on the card. Losses finite and falling, no kernel of csrc/
    launched; returns step ms (median of the timed steps), examples/s,
    target tokens/s (padded and valid), peak memory above what the card
    held before, the scope and program (infer-mt-beam decodes with the
    trained parameters) and under "step" the step itself, traced once by
    `trace_train_stacked_lstm` after the timed runs."""
    import numpy as np
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("train-mt runs float32 with TF32 off")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    main, startup, fetches = build_mt(ptt)
    loss = fetches["loss"]
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    src, lens, trg, lbl, valid = mt_batch()
    feed = {"src_word": (torch.from_numpy(src).cuda(),
                         torch.from_numpy(lens).cuda()),
            "trg_word": torch.from_numpy(trg).cuda(),
            "lbl_word": torch.from_numpy(lbl).cuda()}
    gc.collect()
    torch.cuda.synchronize()

    def step():
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        return float(np.asarray(out).reshape(-1)[0])

    losses, step_ms = [], []
    native.reset_launches()
    for _ in range(MT_WARMUP + MT_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(native.launches)
    peak = torch.cuda.max_memory_allocated() - base
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train-mt losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train-mt loss did not fall on its fixed "
                             f"batch: {losses}")
    if any(launches.values()):
        raise AssertionError(f"train-mt launched a kernel of csrc/: "
                             f"{launches}")
    timed = sorted(step_ms[MT_WARMUP:])
    med = timed[len(timed) // 2]
    gb = main.global_block()
    types = [op.type for op in gb.ops]
    return dict(tag="train-mt", batch=MT_BATCH, src_max=MT_SRC_MAX,
                trg=MT_TRG, src_tokens=int(lens.sum()), valid_trg=valid,
                warmup=MT_WARMUP, steps=MT_STEPS, losses=losses,
                step_ms=step_ms, step_ms_median=med,
                examples_per_s=MT_BATCH / med * 1e3,
                trg_tokens_per_s=MT_BATCH * MT_TRG / med * 1e3,
                valid_trg_tokens_per_s=valid / med * 1e3,
                peak_bytes=peak, launches=launches, ops=len(types),
                body_ops=len(main.blocks[1].ops),
                static_rnn_ops=types.count("static_rnn"), step=step,
                scope=scope, main=main)


def _mt_tie_rows(card_hist, host_hist, tie=MT_TIE):
    """Rows whose (ids, parents) histories part between card and host,
    each with the first step they part at and whether both sides' scores
    at that step lie within `tie` of each other (a near tie the two
    sides' float32 sums may break either way). Histories: (ids, parents,
    scores), each [B, T, beam]."""
    import numpy as np
    rows = []
    for b in range(card_hist[0].shape[0]):
        differ = ((card_hist[0][b] != host_hist[0][b])
                  | (card_hist[1][b] != host_hist[1][b])).any(axis=-1)
        if not differ.any():
            continue
        t = int(np.argmax(differ))
        gap = float(np.abs(np.sort(card_hist[2][b, t])
                           - np.sort(host_hist[2][b, t])).max())
        rows.append({"row": b, "step": t, "score_gap": gap,
                     "tie": gap <= tie})
    return rows


def _count_runs(native, prepared, tally, before_run=None):
    """Wrap `prepared.run` so each run adds its kernel launches (the
    native counters' advance across the run) and one `runs` to `tally`.
    Only the engine thread launches while a phase is counted, so the
    deltas belong to this program."""
    run = prepared.run

    def counted(feed, *a, **k):
        if before_run is not None:
            before_run()
        snap = dict(native.launches)
        out = run(feed, *a, **k)
        for n, v in native.launches.items():
            tally[n] = tally.get(n, 0) + v - snap.get(n, 0)
        tally["runs"] = tally.get("runs", 0) + 1
        return out

    prepared.run = counted


def run_serve_base_swap(torch, ptt, native, tiny_lm, tmp, mdir, sig):
    """serve-base-swap: serve-base (v1, `mdir`) and a v2 from
    SWAP_WEIGHT_SEED. Four requests start on v1 (their first tokens out);
    v2 is staged with prepare_swap and published with commit_swap while
    they decode; four more requests follow. The first finish on v1 with
    the host's v1 tokens, the later on v2 with the host's v2 tokens; no v2
    prefill runs before v1's slots drain; v1 retires; kernels 1 and 4
    launch on both versions. Returns the numbers."""
    import numpy as np
    v2dir = os.path.join(tmp, "serve_base_v2")
    tiny_lm.save_tiny_lm(v2dir, seed=SWAP_WEIGHT_SEED, **SERVE_BASE)
    p1 = prompts_for(sig["vocab"], lens=SWAP_V1_LENS)
    p2 = prompts_for(sig["vocab"], lens=SWAP_V2_LENS)
    n_layers = sig["n_layers"]
    tally = {"v1": {}, "v1_decode": {}, "v2": {}, "v2_decode": {}}
    v2_prefills_after_drain = []
    srv = ptt.serve.InferenceServer(ptt.CUDAPlace(0))
    try:
        v1 = srv.add_model("lm", mdir)
        _count_runs(native, v1.prepared, tally["v1"])
        _count_runs(native, v1.decode.prepared, tally["v1_decode"])
        native.reset_launches()
        t0 = time.perf_counter()
        streams = [srv.submit_stream("lm", p, max_new_tokens=SWAP_V1_TOKENS)
                   for p in p1]
        first = [next(iter(s)) for s in streams]
        t_first = time.perf_counter() - t0
        t1 = time.perf_counter()
        staged = srv.prepare_swap("lm", v2dir)
        prepare_s = time.perf_counter() - t1
        _count_runs(native, staged.prepared, tally["v2"], before_run=lambda:
                    v2_prefills_after_drain.append(
                        all(s.future.done() for s in streams)))
        _count_runs(native, staged.decode.prepared, tally["v2_decode"])
        active_at_commit = sum(not s.future.done() for s in streams)
        t_commit = time.perf_counter()
        v2 = srv.commit_swap("lm")
        futs = [srv.submit_generate("lm", p, max_new_tokens=SWAP_V2_TOKENS)
                for p in p2]
        r1 = [s.future.result(timeout=600) for s in streams]
        t_drained = time.perf_counter()
        r2 = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        retired = v1.wait_retired(60)
        ttft_v2 = sorted(r.ttft_us / 1e3 for r in r2)
    finally:
        srv.close()
    if active_at_commit < 1:
        raise AssertionError(
            f"serve-base-swap: every v1 request had finished before "
            f"commit_swap (prepare_swap took {prepare_s:.2f} s): the drill "
            f"did not swap under load; raise SWAP_V1_TOKENS")
    if not v2_prefills_after_drain or not all(v2_prefills_after_drain):
        raise AssertionError(f"serve-base-swap: a v2 prefill ran before v1's "
                             f"slots drained: {v2_prefills_after_drain}")
    if not retired:
        raise AssertionError("serve-base-swap: v1 did not retire")
    if [r.tokens[0] for r in r1] != first \
            or {r.version_id for r in r1} != {v1.version_id} \
            or {r.version_id for r in r2} != {v2.version_id}:
        raise AssertionError("serve-base-swap: a request finished on the "
                             "wrong version")
    # the same requests on the host: v1, then v2 by a hot swap there too
    t0 = time.perf_counter()
    host = ptt.serve.InferenceServer(ptt.CPUPlace())
    try:
        host.add_model("lm", mdir, warm=False)
        h1 = [f.result(timeout=1200) for f in [
            host.submit_generate("lm", p, max_new_tokens=SWAP_V1_TOKENS)
            for p in p1]]
        host.add_model("lm", v2dir, warm=False)
        h2 = [f.result(timeout=1200) for f in [
            host.submit_generate("lm", p, max_new_tokens=SWAP_V2_TOKENS)
            for p in p2]]
    finally:
        host.close()
    host_s = time.perf_counter() - t0
    for tag, got, want in (("v1", r1, h1), ("v2", r2, h2)):
        for i, (a, b) in enumerate(zip(got, want)):
            if a.tokens != b.tokens:
                raise AssertionError(
                    f"serve-base-swap {tag} request {i}: card tokens "
                    f"{a.tokens} != host tokens {b.tokens}")
    # each version's runs launch their kernels once a layer. v2 is held to
    # that exactly; v1's decode steps overlap v2's warm runs, which
    # prepare_swap makes on this thread while v1 decodes, so a v1 step's
    # count may include them
    for key, kern in (("v1", "flash_fwd"), ("v2", "flash_fwd"),
                      ("v1_decode", "paged_decode"),
                      ("v2_decode", "paged_decode")):
        t = tally[key]
        n, want = t.get(kern, 0), n_layers * t.get("runs", 0)
        if want < 1 or n < want or (key.startswith("v2") and n != want):
            raise AssertionError(f"serve-base-swap {key}: {kern} launched "
                                 f"{n} times over {t.get('runs')} runs of "
                                 f"{n_layers} layers")
    return {"prepare_s": prepare_s, "first_tokens_s": t_first,
            "active_at_commit": active_at_commit,
            "drain_s": t_drained - t_commit,
            "swap_to_v2_done_s": t_end - t_commit,
            "v2_ttft_ms": ttft_v2, "host_s": host_s,
            "tokens": {"v1": sum(len(r.tokens) for r in r1),
                       "v2": sum(len(r.tokens) for r in r2)},
            "runs": {k: v.get("runs", 0) for k, v in tally.items()},
            "launches_by_version": {
                "v1": {"flash_fwd": tally["v1"].get("flash_fwd", 0),
                       "paged_decode": tally["v1_decode"].get(
                           "paged_decode", 0)},
                "v2": {"flash_fwd": tally["v2"].get("flash_fwd", 0),
                       "paged_decode": tally["v2_decode"].get(
                           "paged_decode", 0)}}}


def serve_resnet50_model(ptt):
    """bench.py's ResNet-50 built for inference: the program, its
    `predict`, and the host scope of its startup (SEED). Each batch norm's
    running statistics are a calibration batch's, perturbed from
    RandomState(DATA_SEED): the batch's channel means plus N(0, 0.1) of
    its standard deviations, its variances times U[0.5, 1.5]. (Drawn
    outright, means ~N(0, 0.1) and variances in [0.5, 1.5] leave the 53
    layers unnormalized: on an H100 the logits reached +-3,800 with a
    top-1 gap of 77 or more, every softmax one-hot, and no probability
    could show an error.) The calibration batch is SERVE_RN50_CALIB images
    through the same weights in training mode on the host, which
    normalizes by the batch's own statistics (SavedMean, and SavedVariance
    = 1 / sqrt(var + eps))."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import resnet
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = resnet.build(**RESNET50, is_test=True)
    calib = ptt.Program()
    with ptt.program_guard(calib, ptt.Program()), ptt.unique_name.guard():
        resnet.build(**RESNET50)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    bns = [op for op in calib.global_block().ops if op.type == "batch_norm"]
    rng = np.random.RandomState(DATA_SEED)
    c, h, w = RESNET50["image_shape"]
    images = rng.rand(SERVE_RN50_CALIB, h, w, c).astype(np.float32)
    scratch = ptt.Scope()
    for n in scope.local_var_names():
        scratch.set_var(n, scope.find_var(n).clone())
    stats = exe.run(calib, feed={"image": images, "label": np.zeros(
        (SERVE_RN50_CALIB, 1), np.int64)}, scope=scratch,
        fetch_list=[op.output(k)[0] for op in bns
                    for k in ("SavedMean", "SavedVariance")])
    for i, op in enumerate(bns):
        mean, inv = stats[2 * i], stats[2 * i + 1]
        var = inv.astype(np.float64) ** -2 - op.attrs.get("epsilon", 1e-5)
        mean = mean + rng.randn(*mean.shape) * 0.1 * np.sqrt(var)
        var = var * rng.uniform(0.5, 1.5, var.shape)
        scope.set_var(op.input("Mean")[0],
                      torch.from_numpy(mean.astype(np.float32)))
        scope.set_var(op.input("Variance")[0],
                      torch.from_numpy(var.astype(np.float32)))
    return main, fetches["predict"], exe, scope


def save_serve_resnet50(ptt, model, path, scale):
    """Save `model` (serve_resnet50_model's) with every parameter times
    `scale` (atomically, over whatever `path` holds)."""
    main, predict, exe, base = model
    scope = ptt.Scope()
    params = {p.name for p in main.global_block().all_parameters()}
    for n in base.local_var_names():
        v = base.find_var(n)
        scope.set_var(n, v * scale if n in params else v)
    ptt.io.save_inference_model(path, ["image"], [predict], exe,
                                main_program=main, scope=scope)


def _rn50_check(tag, got, want):
    """Top-1 ids equal, probabilities within SERVE_RN50_PROB_TOL and
    log-probabilities above SERVE_RN50_LOGP_FLOOR within
    SERVE_RN50_LOGP_TOL (1 + |log p|); returns the largest share of either
    tolerance."""
    import numpy as np
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"serve-resnet50 {tag}: shape {got.shape} vs "
                             f"{want.shape} or not finite")
    if (got.argmax(-1) != want.argmax(-1)).any():
        raise AssertionError(f"serve-resnet50 {tag}: top-1 ids "
                             f"{got.argmax(-1)} != {want.argmax(-1)}")
    live = want > SERVE_RN50_LOGP_FLOOR
    logw = np.log(want[live])
    logg = np.log(np.maximum(got[live], np.finfo(np.float32).tiny))
    shares = (float(np.abs(got - want).max()) / SERVE_RN50_PROB_TOL,
              float((np.abs(logg - logw) / (1 + np.abs(logw))).max())
              / SERVE_RN50_LOGP_TOL)
    if not max(shares) <= 1.0:
        raise AssertionError(f"serve-resnet50 {tag}: {shares} of the "
                             f"probability and log-probability tolerances")
    return max(shares)


def run_serve_resnet50(torch, ptt, native, tmp):
    """serve-resnet50 (see SERVE_RN50_*): returns the numbers."""
    import numpy as np
    from paddle_tpu_torch.observe import metrics
    t0 = time.perf_counter()
    model = serve_resnet50_model(ptt)
    dirs = [os.path.join(tmp, f"resnet50_v{i + 1}") for i in range(2)]
    for path, scale in zip(dirs, SERVE_RN50_SCALES):
        save_serve_resnet50(ptt, model, path, scale)
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(DATA_SEED)
    c, h, w = RESNET50["image_shape"]
    pool = rng.rand(SERVE_RN50_POOL, h, w, c).astype(np.float32)
    sizes = rng.randint(1, SERVE_RN50_MAX_IMAGES + 1, SERVE_RN50_REQUESTS)
    feeds = [pool[rng.randint(0, SERVE_RN50_POOL, n)] for n in sizes]
    probes = [pool[rng.randint(0, SERVE_RN50_POOL, n)]
              for n in SERVE_RN50_PROBES]
    fillers = [pool[rng.randint(0, SERVE_RN50_POOL, n)]
               for n in SERVE_RN50_FILLERS]
    swap_probe = probes[SERVE_RN50_SWAP_PROBE]

    def host_outputs(path, inputs):
        with ptt.serve.InferenceServer(ptt.CPUPlace()) as host:
            host.add_model("rn50", path, warm=False,
                           ladder=ptt.serve.BucketLadder(
                               rows=SERVE_RN50_LADDER))
            return [host.infer("rn50", {"image": x})[0] for x in inputs]

    t0 = time.perf_counter()
    host_v1 = host_outputs(dirs[0], probes)
    host_v2 = host_outputs(dirs[1], [swap_probe])[0]
    host_s = time.perf_counter() - t0

    occ_h = metrics.histogram("serve_batch_occupancy")
    waste_h = metrics.histogram("serve_padding_waste_ratio")
    rows_h = metrics.histogram("serve_batch_rows")

    def hist(h):
        s = h.summary(model="rn50")
        return (s["count"], s["count"] * s["mean"]) if s else (0, 0.0)

    peaks = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = ptt.serve.InferenceServer(ptt.CUDAPlace(0))
    try:
        t0 = time.perf_counter()
        v1 = srv.add_model("rn50", dirs[0], ladder=ptt.serve.BucketLadder(
            rows=SERVE_RN50_LADDER))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peaks["load"] = torch.cuda.max_memory_allocated()
        # the probes alone, then coalesced into one batch of the top rung
        solo = [srv.infer("rn50", {"image": x})[0] for x in probes]
        errs = {"card_vs_host": max(
            _rn50_check(f"probe {i} card vs host", a, b)
            for i, (a, b) in enumerate(zip(solo, host_v1)))}
        batcher = srv._batchers["rn50"]
        batcher.reconfigure(batch_timeout_ms=1000.0)
        before = hist(rows_h)
        futs = [srv.submit("rn50", {"image": x}) for x in probes + fillers]
        coalesced = [f.result(timeout=300)[0] for f in futs]
        after = hist(rows_h)
        batcher.reconfigure(batch_timeout_ms=ptt.serve.ServeConfig()
                            .batch_timeout_ms)
        if (after[0] - before[0], after[1] - before[1]) != \
                (1, SERVE_RN50_LADDER[-1]):
            raise AssertionError(f"serve-resnet50: the probes took "
                                 f"{after[0] - before[0]} batches of "
                                 f"{after[1] - before[1]} rows, expected one "
                                 f"of {SERVE_RN50_LADDER[-1]}")
        errs["coalesced_vs_solo"] = max(
            _rn50_check(f"probe {i} coalesced vs solo", a, b)
            for i, (a, b) in enumerate(zip(coalesced, solo)))

        # the traffic, gated by the controller below
        n = SERVE_RN50_REQUESTS
        cond = threading.Condition()
        state = {"allowed": 0, "next": 0, "done": 0}
        results = [None] * n
        errors = []

        def release(k):
            with cond:
                state["allowed"] = k
                cond.notify_all()

        def wait_done(k, timeout=600):
            with cond:
                if not cond.wait_for(lambda: state["done"] >= k or errors,
                                     timeout):
                    raise AssertionError(f"serve-resnet50: {state['done']} "
                                         f"of {k} requests done in {timeout} s")

        def client():
            while True:
                with cond:
                    cond.wait_for(lambda: state["next"] < state["allowed"]
                                  or state["next"] >= n)
                    if state["next"] >= n:
                        return
                    i = state["next"]
                    state["next"] += 1
                t_sub = time.perf_counter()
                try:
                    fut = srv.submit("rn50", {"image": feeds[i]})
                    out, = fut.result(timeout=300)
                    results[i] = (out, fut.version_id,
                                  time.perf_counter() - t_sub,
                                  time.perf_counter())
                except Exception as e:      # noqa: BLE001
                    errors.append(f"request {i}: {e!r}")
                with cond:
                    state["done"] += 1
                    cond.notify_all()

        native.reset_launches()
        occ0, waste0 = hist(occ_h), hist(waste_h)
        torch.cuda.reset_peak_memory_stats()
        threads = [threading.Thread(target=client, name=f"rn50-client-{k}")
                   for k in range(SERVE_RN50_CLIENTS)]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        try:
            release(n // 2)
            wait_done(n // 2 - 2 * SERVE_RN50_CLIENTS)
            steady = (state["done"], time.perf_counter() - t_start)
            peaks["steady"] = torch.cuda.max_memory_allocated()
            # v2: staged under load, then published
            torch.cuda.reset_peak_memory_stats()
            release(n * 3 // 4)
            t0 = time.perf_counter()
            staged = srv.prepare_swap("rn50", dirs[1])
            prepare_s = time.perf_counter() - t0
            v2 = srv.commit_swap("rn50")
            probe_fut = srv.submit("rn50", {"image": swap_probe})
            errs["after_v2_flip"] = _rn50_check(
                "probe after the v2 flip vs host v2",
                probe_fut.result(timeout=300)[0], host_v2)
            if probe_fut.version_id != v2.version_id or staged is not v2:
                raise AssertionError("serve-resnet50: the probe after the "
                                     "v2 flip ran on another version")
            release(n * 7 // 8)
            wait_done(n * 3 // 4)
            peaks["swap"] = torch.cuda.max_memory_allocated()
            # v3: saved over the served dir, picked up by the watcher
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            save_serve_resnet50(ptt, model, dirs[1], SERVE_RN50_SCALES[2])
            srv.start_watch(0.5)
            while srv.registry.get("rn50").version_id == v2.version_id:
                if time.perf_counter() - t0 > 300 or errors:
                    raise AssertionError("serve-resnet50: the watcher did "
                                         "not swap in v3")
                time.sleep(0.05)
            watch_s = time.perf_counter() - t0
            v3 = srv.registry.get("rn50")
            probe_fut = srv.submit("rn50", {"image": swap_probe})
            v3_probe = probe_fut.result(timeout=300)[0]
            if probe_fut.version_id != v3.version_id:
                raise AssertionError("serve-resnet50: the probe after the "
                                     "v3 flip ran on another version")
            peaks["watch"] = torch.cuda.max_memory_allocated()
            release(n)
            wait_done(n)
        finally:
            release(n)
            with cond:
                state["next"] = n
                cond.notify_all()
            for t in threads:
                t.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = dict(native.launches)
        retired = {"v1": v1.wait_retired(60), "v2": v2.wait_retired(60)}
        occ1, waste1 = hist(occ_h), hist(waste_h)
    finally:
        srv.close()
    t0 = time.perf_counter()
    errs["after_v3_flip"] = _rn50_check(
        "probe after the v3 flip vs host v3", v3_probe,
        host_outputs(dirs[1], [swap_probe])[0])
    host_s += time.perf_counter() - t0
    if errors or any(r is None for r in results) \
            or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve-resnet50: {len(errors)} failed "
                             f"requests: {errors[:3]}")
    if any(launches.values()):
        raise AssertionError(f"serve-resnet50 launched a hand-written "
                             f"kernel: {launches}")
    if not all(retired.values()):
        raise AssertionError(f"serve-resnet50: not retired: {retired}")
    served = {}
    for (out, vid, _, _), x in zip(results, feeds):
        if out.shape != (len(x), RESNET50["class_dim"]) \
                or not np.isfinite(out).all() \
                or not np.allclose(out.sum(-1), 1.0, atol=1e-4):
            raise AssertionError(f"serve-resnet50: a bad output "
                                 f"{out.shape}")
        served[vid] = served.get(vid, 0) + 1
    by_version = {tag: served.get(v.version_id, 0)
                  for tag, v in (("v1", v1), ("v2", v2), ("v3", v3))}
    if sum(by_version.values()) != n or min(by_version.values()) < 1:
        raise AssertionError(f"serve-resnet50: requests by version "
                             f"{by_version}")
    lat = sorted(r[2] * 1e3 for r in results)
    images = int(sizes.sum())
    batches = occ1[0] - occ0[0]
    return {"images": images, "requests": n, "wall_s": wall,
            "images_per_s": images / wall,
            "steady_images_per_s": float(sum(
                len(feeds[i]) for i in range(n) if results[i][3] - t_start
                <= steady[1])) / steady[1],
            "p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "batches": batches,
            "avg_occupancy": (occ1[1] - occ0[1]) / max(batches, 1),
            "avg_padding_waste": (waste1[1] - waste0[1]) / max(batches, 1),
            "peak_bytes": peaks,
            "load_s": load_s, "prepare_s": prepare_s, "watch_s": watch_s,
            "build_s": build_s, "host_s": host_s, "errors": errs,
            "by_version": by_version, "launches": launches}


def run_infer_mt_beam(torch, ptt, native, trained, tmp):
    """infer-mt-beam: the trained parameters saved and loaded into
    `build_infer`'s program (beam MT_BEAM, max_len MT_MAX_LEN), that
    program saved by `save_inference_model` and loaded by
    `load_inference_model` into a fresh scope on the card and on the
    host; MT_DECODE_BATCH sources decoded on each. Ids equal (rows that
    part at a near tie reported), scores within MT_SCORE_RTOL; ms a batch
    (median of MT_DECODE_RUNS after a warm-up) and generated tokens/s
    (the best beam's MT_MAX_LEN tokens a source); no kernel of csrc/
    launched. Under "step", one card decode, traced once after every
    timed run."""
    import numpy as np
    from paddle_tpu_torch import io
    from paddle_tpu_torch.models import machine_translation
    card_exe = ptt.Executor(ptt.CUDAPlace(0))
    params = os.path.join(tmp, "mt_params")
    io.save_persistables(card_exe, params, trained["main"],
                         scope=trained["scope"])
    infer, infer_start = ptt.Program(), ptt.Program()
    with ptt.program_guard(infer, infer_start), ptt.unique_name.guard():
        _, f = machine_translation.build_infer(beam_size=MT_BEAM,
                                               max_len=MT_MAX_LEN, **MT)
    scope = ptt.Scope()
    card_exe.run(infer_start, scope=scope)
    io.load_persistables(card_exe, params, infer, scope=scope)
    model = os.path.join(tmp, "mt_beam")
    io.save_inference_model(model, ["src_word"], [f["ids"], f["scores"]],
                            card_exe, main_program=infer, scope=scope)
    rnn = next(op for op in infer.global_block().ops
               if op.type == "static_rnn")
    hist = list(rnn.outputs["Out"])        # ids, parents, scores [B, T, K]
    src, lens, _, _, _ = mt_batch(MT_DECODE_BATCH, seed=MT_DATA_SEED + 1)
    feed = {"src_word": (src, lens)}
    out = {}
    for side, exe in (("card", card_exe),
                      ("host", ptt.Executor(ptt.CPUPlace()))):
        fresh = ptt.Scope()
        prog, feed_names, fetch_vars = io.load_inference_model(
            model, exe, scope=fresh)
        if feed_names != ["src_word"] or len(prog.blocks) != 2:
            raise AssertionError(f"infer-mt-beam loaded {feed_names}, "
                                 f"{len(prog.blocks)} blocks")
        fetch = [v.name for v in fetch_vars] + hist
        runs, ms = (MT_DECODE_RUNS + 1, []) if side == "card" else (1, [])
        native.reset_launches()
        for _ in range(runs):
            t0 = time.perf_counter()
            res = exe.run(prog, feed=feed, fetch_list=fetch, scope=fresh)
            if side == "card":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        if side == "card" and any(native.launches.values()):
            raise AssertionError(f"infer-mt-beam launched a kernel of "
                                 f"csrc/: {dict(native.launches)}")
        out[side] = dict(ids=res[0], scores=res[1], hist=res[2:], ms=ms,
                         run=lambda exe=exe, prog=prog, fresh=fresh,
                         fetch=fetch: exe.run(prog, feed=feed,
                                              fetch_list=fetch, scope=fresh))
    card, host = out["card"], out["host"]
    if card["ids"].shape != (MT_DECODE_BATCH, MT_BEAM, MT_MAX_LEN):
        raise AssertionError(f"infer-mt-beam ids {card['ids'].shape}")
    if not np.isfinite(card["scores"]).all():
        raise AssertionError("infer-mt-beam scores not finite")
    ties = _mt_tie_rows(card["hist"], host["hist"])
    if any(not r["tie"] for r in ties):
        raise AssertionError(f"infer-mt-beam: card ids part from the "
                             f"host's away from a tie: {ties}")
    same = np.array([b not in {r["row"] for r in ties}
                     for b in range(MT_DECODE_BATCH)])
    if not np.array_equal(card["ids"][same], host["ids"][same]):
        raise AssertionError("infer-mt-beam: card ids differ from the "
                             "host's in a row whose history agrees")
    rel = float(np.max(np.abs(card["scores"][same] - host["scores"][same])
                       / np.maximum(np.abs(host["scores"][same]), 1e-30),
                       initial=0.0))
    if rel > MT_SCORE_RTOL:
        raise AssertionError(f"infer-mt-beam scores {rel:.3g} from the "
                             f"host's (tol {MT_SCORE_RTOL})")
    timed = sorted(card["ms"][1:])
    med = timed[len(timed) // 2]
    return dict(tag="infer-mt-beam", batch=MT_DECODE_BATCH, beam=MT_BEAM,
                max_len=MT_MAX_LEN, src_tokens=int(lens.sum()),
                ms=card["ms"], ms_median=med, host_ms=host["ms"][0],
                tokens_per_s=MT_DECODE_BATCH * MT_MAX_LEN / med * 1e3,
                ties=ties, rows_compared=int(same.sum()),
                score_rel_err=rel, ids_equal_rows=int(same.sum()),
                best=card["ids"][:2, 0, :12].tolist(), step=card["run"])


def _count_rule_calls(fn):
    """Run `fn`, counting the op rules the executor runs (forward and
    grad ops, sub-blocks' included); returns (fn's result, count)."""
    from paddle_tpu_torch.core import lowering
    run_op, run_grad_op = lowering._run_op, lowering._run_grad_op
    n = [0]

    def count(inner):
        def wrapped(*a, **k):
            n[0] += 1
            return inner(*a, **k)
        return wrapped

    lowering._run_op, lowering._run_grad_op = count(run_op), count(
        run_grad_op)
    try:
        out = fn()
    finally:
        lowering._run_op, lowering._run_grad_op = run_op, run_grad_op
    return out, n[0]


def _book_agree(np, name, agree, card, host):
    """The inference outputs of a chapter on the card against the host's:
    floats within LOSS_RTOL of the host's scale; "equal" exactly; "top1"
    the argmax equal but in a row whose host top-two lie within BOOK_TIE
    (relative to the row's scale) of each other. Returns (the largest
    float error over its scale, the tied rows)."""
    err, ties = 0.0, []
    for c, h in zip(card, host):
        c, h = np.asarray(c), np.asarray(h)
        if c.shape != h.shape:
            raise AssertionError(f"book {name}: inference shape {c.shape} "
                                 f"on the card, {h.shape} on the host")
        if agree == "equal":
            if not np.array_equal(c, h):
                raise AssertionError(f"book {name}: Viterbi paths differ: "
                                     f"card {c.tolist()} host {h.tolist()}")
            continue
        scale = max(float(np.abs(h).max()), 1e-30)
        e = float(np.abs(c.astype(np.float64) - h).max()) / scale
        err = max(err, e)
        if e > LOSS_RTOL:
            raise AssertionError(f"book {name}: inference outputs {e} of "
                                 f"the host's scale apart (tol {LOSS_RTOL})")
        if agree == "top1":
            h2 = h.reshape(-1, h.shape[-1])
            c2 = c.reshape(-1, c.shape[-1])
            for r in np.nonzero(c2.argmax(-1) != h2.argmax(-1))[0]:
                top = np.sort(h2[r])[-2:]
                if top[1] - top[0] > BOOK_TIE * max(abs(top[1]), 1e-30):
                    raise AssertionError(
                        f"book {name}: row {r}'s top-1 is "
                        f"{c2[r].argmax()} on the card, {h2[r].argmax()} "
                        f"on the host, not at a tie: {h2[r].tolist()}")
                ties.append(int(r))
    return err, ties


def run_book_chapter(torch, ptt, native, book, name, tmp):
    """One chapter of the book on the card (the docstring's 7j): returns
    its numbers, with a `step` closure for the traced step later."""
    import numpy as np
    w = book.CARD[name]
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        ch = book.build(ptt, name, w)
    place = ptt.CUDAPlace(0)
    exe, scope = ptt.Executor(place), ptt.Scope()
    exe.run(startup, scope=scope)
    init = book.init_values(ptt, name)
    ptt.io.state_from_numpy(init, place, scope)
    df = book.feeder(ptt, ch, place, main)
    batches = book.batches(ptt, name, w, BOOK_WARMUP + BOOK_STEPS + 1)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    losses, step_ms = [], []
    for i, rows in enumerate(batches[:-1]):
        t0 = time.perf_counter()
        out, = exe.run(main, feed=book.feed(ch, df, rows),
                       fetch_list=[ch.loss], scope=scope)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        losses.append(float(np.asarray(out).reshape(-1)[0]))
        if i >= BOOK_WARMUP:
            step_ms.append(dt)
    peak = torch.cuda.max_memory_allocated() - before
    # one more step, counted: the rule calls, and where the feeds and the
    # persistables live while the chapter trains
    last = book.feed(ch, df, batches[-1])
    feed_names = [v.name for v in ch.feeds]
    outs, calls = _count_rule_calls(lambda: exe.run(
        main, feed=last, fetch_list=[ch.loss] + feed_names, scope=scope,
        return_numpy=False))
    losses.append(float(outs[0].reshape(-1)[0]))
    launches = dict(native.launches)
    if any(launches.values()):
        raise AssertionError(f"book {name}: a kernel of csrc/ launched: "
                             f"{launches}")
    off = [n for n, t in zip(feed_names, outs[1:]) if t.device.type != "cuda"]
    off += [n for n in scope.local_var_names()
            if isinstance(scope.find_var(n), torch.Tensor)
            and scope.find_var(n).device.type != "cuda"]
    if off:
        raise AssertionError(f"book {name}: not on the card: {off}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"book {name}: losses {losses}")

    # the inference model: saved, loaded on the card and on the host
    path = os.path.join(tmp, name)
    ptt.io.save_inference_model(path, ch.infer_feeds, ch.targets, exe,
                                main_program=main, scope=scope)
    infer = book.infer_feed(ch, book.feed(ch, df, batches[0]))
    res = {}
    for side, pl in (("card", place), ("host", ptt.CPUPlace())):
        e, sc = ptt.Executor(pl), ptt.Scope()
        prog, names, fetches = ptt.io.load_inference_model(path, e, scope=sc)
        if names != ch.infer_feeds:
            raise AssertionError(f"book {name}: loaded feeds {names}")
        res[side] = e.run(prog, feed=infer, fetch_list=fetches, scope=sc)
    infer_err, ties = _book_agree(np, name, ch.agree, res["card"],
                                  res["host"])

    # card vs host from one state, each step from the host's
    pw = dict(w, batch=BOOK_PARITY_BATCH.get(name, w["batch"]))
    pfeeds = [book.feed(ch, df, rows)
              for rows in book.batches(ptt, name, pw, BOOK_PARITY_STEPS)]
    sign_updates = any(op.type in ("adam", "adagrad")
                       for op in main.global_block().ops)
    parity = run_step_parity(torch, ptt, f"book {name}", main, startup,
                             ch.loss, pfeeds, BOOK_PARITY_STEPS, init=init,
                             sign_updates=sign_updates)

    def step():
        exe.run(main, feed=last, fetch_list=[ch.loss], scope=scope)

    med = _median(step_ms)
    # the float32 bound of the image chapters' convs and products (the
    # sequence chapters' shapes carry a time dim unknown at build time)
    macs = model_macs(main) if name in BOOK_PARITY_BATCH else None
    return dict(
        name=name, widths=w, batch=w["batch"], losses=losses,
        step_ms=step_ms, step_ms_median=med,
        examples_per_s=w["batch"] / med * 1e3, peak_bytes=peak,
        rule_calls=calls, ops=len(main.global_block().ops),
        macs_per_sample=macs,
        bound_ms=(3 * 2 * macs * w["batch"] / PEAK_F32_FLOPS * 1e3
                  if macs else None),
        launches=launches, infer_err=infer_err, infer_ties=ties,
        infer_agree=ch.agree, infer_shapes=[list(np.asarray(o).shape)
                                            for o in res["card"]],
        parity=parity, step=step)


def run_book(torch, ptt, native, tmp):
    """Phase 7j: every chapter of the book on the card."""
    from tools import torch_book as book
    return {name: run_book_chapter(torch, ptt, native, book, name, tmp)
            for name in book.CHAPTERS}


# ---------------------------------------------------------------------------
# phase 7k: the common op breadth
# ---------------------------------------------------------------------------

def build_deepfm_auc(ptt):
    """train-deepfm's program with `layers.auc` on its prediction (added
    before the optimizer, as a training script does): (main, startup,
    fetches) with "auc" and "auc_stats" [StatPos, StatNeg]."""
    from paddle_tpu_torch import clip, optimizer
    from paddle_tpu_torch.models import deepfm
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        feeds, fetches = deepfm.build()
        fetches["auc"], fetches["auc_stats"] = ptt.layers.auc(
            fetches["predict"], feeds["label"])
        clip.set_gradient_clip(clip.GradientClipByGlobalNorm(DEEPFM_CLIP))
        try:
            optimizer.Adagrad(learning_rate=DEEPFM_LR).minimize(
                fetches["loss"])
        finally:
            clip.set_gradient_clip(None)
    return main, startup, fetches


def _buckets(torch, np, p, nt=200):
    """The `auc` rule's bucket of each prediction, as the rule computes
    it in float32."""
    t = torch.from_numpy(np.ascontiguousarray(p, np.float32)).reshape(-1)
    return (t * nt).to(torch.int64).clamp(0, nt).numpy()


def _timed_pair(torch, ptt, progs, startup_state, feeds):
    """Two programs on the card, each from `startup_state` in a scope of
    its own, a step of each on every feed, in turns (A B, B A, ...); each
    one's step ms (host clock, after a sync), fetches, executor and
    scope."""
    runs = []
    for main, fetch in progs:
        runs.append(dict(main=main, fetch=fetch, ms=[], outs=[],
                         exe=ptt.Executor(ptt.CUDAPlace(0)),
                         scope=ptt.io.state_from_numpy(startup_state,
                                                       ptt.CUDAPlace(0))))
    for k, feed in enumerate(feeds):
        for r in (runs if k % 2 == 0 else runs[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r["outs"].append(r["exe"].run(r["main"], feed=feed,
                                          fetch_list=r["fetch"],
                                          scope=r["scope"]))
            torch.cuda.synchronize()
            r["ms"].append((time.perf_counter() - t0) * 1e3)
    return runs


def run_deepfm_auc(torch, ptt, native, tmp):
    """Phase 7k (a): train-deepfm with a streaming `auc`, DEEPFM_STEPS
    steps on the host from one state, a batch a step, and each step on
    the card from the host's state before it (histograms included): the
    histograms' counts, the AUC and the loss each step. A free run on
    the card from the same state times the step with and without the
    `auc` op, and is held to the host's run (losses within LOSS_RTOL; the
    predictions that drift into another bucket are counted, not gated);
    `io.save_params` / `load_params` into a fresh card scope and one more
    step, bit-equal to the step without the round trip."""
    import numpy as np
    from paddle_tpu_torch.core.executor import fetch_var
    main, startup, f = build_deepfm_auc(ptt)
    pos, neg = f["auc_stats"]
    fetch = [f["loss"], f["auc"], pos, neg, f["predict"]]
    dev = ptt.CUDAPlace(0).torch_device()
    feeds = [deepfm_batch(DEEPFM_BATCH, seed=DATA_SEED + step)
             for step in range(DEEPFM_STEPS + 1)]
    card_feeds = [{k: torch.from_numpy(v).to(dev) for k, v in feed.items()}
                  for feed in feeds]
    host_exe, host = ptt.Executor(ptt.CPUPlace()), ptt.Scope()
    host_exe.run(startup, scope=host)
    # copies: the optimizer updates the host scope's tensors in place
    state0 = {n: np.array(fetch_var(n, host))
              for n in host.local_var_names()}
    card_exe = ptt.Executor(ptt.CUDAPlace(0))
    losses = {"card": [], "host": []}
    aucs = {"card": [], "host": []}
    ties, auc_err, loss_err, host_outs = [], 0.0, 0.0, []
    native.reset_launches()
    for step in range(DEEPFM_STEPS):
        state = {n: fetch_var(n, host) for n in host.local_var_names()}
        card = card_exe.run(main, feed=card_feeds[step], fetch_list=fetch,
                            scope=ptt.io.state_from_numpy(
                                state, ptt.CUDAPlace(0)))
        out = host_exe.run(main, feed=feeds[step], fetch_list=fetch,
                           scope=host)
        host_outs.append(out)
        if not (np.array_equal(card[2], out[2])
                and np.array_equal(card[3], out[3])):
            # only a prediction on a bucket's edge may count elsewhere
            hp = np.asarray(out[4]).reshape(-1)
            moved = np.nonzero(_buckets(torch, np, card[4])
                               != _buckets(torch, np, hp))[0]
            frac = np.abs(hp[moved] * 200 - np.round(hp[moved] * 200))
            if not len(moved) or (frac > AUC_BUCKET_TIE).any():
                d_pos, d_neg = card[2] - out[2], card[3] - out[3]
                raise AssertionError(
                    f"deepfm-auc step {step}: histogram counts differ (card "
                    f"- host at buckets {np.nonzero(d_pos)[0].tolist()}: "
                    f"{d_pos[d_pos != 0].tolist()}, "
                    f"{np.nonzero(d_neg)[0].tolist()}: "
                    f"{d_neg[d_neg != 0].tolist()}) beyond predictions on a "
                    f"bucket's edge: {len(moved)} predictions changed "
                    f"bucket, host p * 200 at "
                    f"{(hp[moved] * 200).tolist()}")
            ties += [(step, int(r)) for r in moved]
        for side, o in (("card", card), ("host", out)):
            losses[side].append(float(o[0].reshape(-1)[0]))
            aucs[side].append(float(o[1].reshape(-1)[0]))
        e = abs(aucs["card"][-1] - aucs["host"][-1])
        auc_err = max(auc_err, e)
        if not ties and e > AUC_TOL:
            raise AssertionError(f"deepfm-auc step {step}: AUC card "
                                 f"{aucs['card'][-1]} host "
                                 f"{aucs['host'][-1]} (tol {AUC_TOL})")
        le = abs(losses["card"][-1] - losses["host"][-1]) / abs(
            losses["host"][-1])
        loss_err = max(loss_err, le)
        if le > LOSS_RTOL:
            raise AssertionError(f"deepfm-auc step {step}: loss card "
                                 f"{losses['card'][-1]} host "
                                 f"{losses['host'][-1]} (tol {LOSS_RTOL})")
    counts = float(out[2].sum() + out[3].sum())
    if counts != DEEPFM_STEPS * DEEPFM_BATCH or not 0 <= aucs["card"][-1] \
            <= 1:
        raise AssertionError(f"deepfm-auc: the histograms hold {counts} "
                             f"predictions ({DEEPFM_STEPS} x "
                             f"{DEEPFM_BATCH} expected), AUC "
                             f"{aucs['card'][-1]}")
    # the card alone from the startup state, with and without the auc op
    plain_main, _, plain_f = build_deepfm(ptt)
    with_auc, plain = _timed_pair(
        torch, ptt, [(main, fetch), (plain_main, [plain_f["loss"]])],
        state0, card_feeds[:DEEPFM_STEPS])
    step_ms, plain_ms = with_auc["ms"], plain["ms"]
    exe, scope = with_auc["exe"], with_auc["scope"]
    # the free run against the host's (a free run itself, from the same
    # state on the same batches)
    free = dict(moved=[], p_err=[], parted_at=None, loss_err=0.0)
    for step, (c, h) in enumerate(zip(with_auc["outs"], host_outs)):
        free["moved"].append(int((_buckets(torch, np, c[4])
                                  != _buckets(torch, np, h[4])).sum()))
        free["p_err"].append(float(np.abs(c[4] - h[4]).max()))
        if free["parted_at"] is None and not (
                np.array_equal(c[2], h[2]) and np.array_equal(c[3], h[3])):
            free["parted_at"] = step
        free["loss_err"] = max(free["loss_err"], abs(
            float(c[0][0]) - float(h[0][0])) / abs(float(h[0][0])))
    if free["loss_err"] > LOSS_RTOL:
        raise AssertionError(f"deepfm-auc free run: losses {free['loss_err']}"
                             f" apart (tol {LOSS_RTOL})")
    # save_params / load_params into a fresh scope, then one more step
    params = {p.name for p in main.global_block().all_parameters()}
    pdir = os.path.join(tmp, "deepfm_params")
    ptt.io.save_params(exe, pdir, main, scope=scope)
    fresh = ptt.Scope()
    for n in scope.local_var_names():
        if n not in params:
            fresh.set_var(n, scope.find_var(n).clone())
    ptt.io.load_params(exe, pdir, main, scope=fresh)
    if sorted(fresh.local_var_names()) != sorted(scope.local_var_names()):
        raise AssertionError("deepfm-auc: the reloaded scope's vars differ")
    after = [exe.run(main, feed=card_feeds[-1], fetch_list=fetch, scope=sc)
             for sc in (scope, fresh)]
    for n, a, b in zip(["loss", "auc", "stat_pos", "stat_neg", "predict"],
                       *after):
        if not np.array_equal(a, b):
            raise AssertionError(f"deepfm-auc: the step after save_params / "
                                 f"load_params differs in {n}")
    for n in scope.local_var_names():
        if not torch.equal(scope.find_var(n), fresh.find_var(n)):
            raise AssertionError(f"deepfm-auc: {n} differs after the step "
                                 f"from the reloaded parameters")
    launches = dict(native.launches)
    if any(launches.values()):
        raise AssertionError(f"deepfm-auc launched a kernel: {launches}")
    return dict(losses=losses, aucs=aucs, auc_err=auc_err,
                loss_err=loss_err, ties=ties, step_ms=step_ms,
                step_ms_median=_median(step_ms[1:]), plain_step_ms=plain_ms,
                plain_step_ms_median=_median(plain_ms[1:]), counts=counts,
                free_run=free,
                n_params=len(params), n_state=len(scope.local_var_names()))


def _lattice(torch, x, every=4):
    """A quarter of x's elements rounded to multiples of 0.5: exact
    zeros, bounds and ties among ordinary values."""
    flat = x.reshape(-1)
    flat[::every] = torch.round(flat[::every] * 2) / 2
    return x


def _breadth_cases():
    """The bank: (name, op type, make(torch, n, gen, dev) -> inputs,
    attrs, output slots, backward, the scaled dim at full size). `n` is
    the rows, the id count or the batch; everything else keeps its
    width."""
    W = BREADTH_WIDTH
    R = BREADTH_ROWS

    def u(torch, shape, gen, dev, scale=1.0):
        return _lattice(torch, torch.randn(*shape, generator=gen,
                                           device=dev) * scale)

    def pos(torch, shape, gen, dev):
        return 0.5 + u(torch, shape, gen, dev).abs()

    def bits(torch, shape, gen, dev):
        return (torch.rand(*shape, generator=gen, device=dev) > 0.5).float()

    def act(name, attrs=None, positive=False):
        return (name, name, lambda t, n, g, d: {
            "X": (pos if positive else u)(t, (n, W), g, d)},
            attrs or {}, ("Out",), True, R)

    cases = [act("abs"), act("cos"), act("sin"), act("round"), act("sign"),
             act("logsigmoid"), act("tanh_shrink"), act("softplus"),
             act("softsign"), act("gelu"), act("elu", {"alpha": 0.5}),
             act("brelu", {"t_min": -1.0, "t_max": 1.0}),
             act("hard_shrink", {"threshold": 0.5}),
             act("hard_sigmoid", {"slope": 0.5, "offset": 0.5}),
             act("leaky_relu", {"alpha": 0.1}),
             act("relu6", {"threshold": 1.0}),
             act("soft_relu", {"threshold": 1.0}),
             act("softshrink", {"lambda": 0.5}),
             act("swish", {"beta": 1.0}),
             act("thresholded_relu", {"threshold": 0.5}),
             act("log", positive=True), act("rsqrt", positive=True),
             act("reciprocal", positive=True),
             act("pow", {"factor": 2.5}, positive=True),
             act("clip", {"min": -1.0, "max": 1.0}),
             act("clip_by_norm", {"max_norm": 100.0}),
             act("l2_normalize", {"axis": 1}),
             act("cumsum", {"axis": 1}),
             ("cumsum_exclusive_reverse", "cumsum",
              lambda t, n, g, d: {"X": u(t, (n, W), g, d)},
              {"axis": 1, "exclusive": True, "reverse": True}, ("Out",),
              True, R),
             act("reduce_max", {"dim": [1]}), act("reduce_min", {"dim": [1]}),
             act("reduce_mean", {"dim": [1]}),
             ("reduce_prod", "reduce_prod", lambda t, n, g, d: {
                 "X": _prod_input(t, n, W, g, d)}, {"dim": [1]}, ("Out",),
              True, R),
             ("arg_max", "arg_max", lambda t, n, g, d: {
                 "X": u(t, (n, W), g, d)}, {"axis": 1}, ("Out",), False, R),
             ("arg_min", "arg_min", lambda t, n, g, d: {
                 "X": u(t, (n, W), g, d)}, {"axis": 1}, ("Out",), False, R),
             ("isfinite", "isfinite", lambda t, n, g, d: {
                 "X": u(t, (n, W), g, d)}, {}, ("Out",), False, R),
             ("argsort", "argsort", lambda t, n, g, d: {
                 "X": u(t, (n, W), g, d)}, {"axis": -1},
              ("Out", "Indices"), True, R),
             ("prelu", "prelu", lambda t, n, g, d: {
                 "X": u(t, (n, W), g, d),
                 "Alpha": t.full((1,), 0.25, device=d)}, {"mode": "all"},
              ("Out",), True, R),
             ("maximum", "maximum", lambda t, n, g, d: {
                 "X": u(t, (n, W), g, d), "Y": u(t, (n, W), g, d)}, {},
              ("Out",), True, R),
             ("elementwise_mod", "elementwise_mod", lambda t, n, g, d: {
                 "X": u(t, (n, W), g, d, 3.0),
                 "Y": pos(t, (n, W), g, d) * t.sign(
                     t.randn(n, W, generator=g, device=d))}, {},
              ("Out",), True, R),
             ("elementwise_floordiv", "elementwise_floordiv",
              lambda t, n, g, d: {
                  "X": u(t, (n, W), g, d, 3.0),
                  "Y": pos(t, (n, W), g, d) * t.sign(
                      t.randn(n, W, generator=g, device=d))}, {},
              ("Out",), False, R),
             ("sigmoid_cross_entropy_with_logits",
              "sigmoid_cross_entropy_with_logits", lambda t, n, g, d: {
                  "X": u(t, (n, W), g, d), "Label": bits(t, (n, W), g, d)},
              {}, ("Out",), True, R),
             ("smooth_l1_loss", "smooth_l1_loss", lambda t, n, g, d: {
                 "X": u(t, (n, W), g, d), "Y": u(t, (n, W), g, d)},
              {"sigma": 1.0}, ("Out", "Diff"), True, R),
             ("huber_loss", "huber_loss", lambda t, n, g, d: {
                 "X": u(t, (n, W), g, d), "Y": u(t, (n, W), g, d)},
              {"delta": 1.0}, ("Out", "Residual"), True, R),
             ("log_loss", "log_loss", lambda t, n, g, d: {
                 "Predicted": _lattice(t, t.rand(n, W, generator=g,
                                                 device=d) * 0.98 + 0.01),
                 "Labels": bits(t, (n, W), g, d)}, {}, ("Loss",), True, R),
             ("rank_loss", "rank_loss", lambda t, n, g, d: {
                 "Label": bits(t, (n, W), g, d), "Left": u(t, (n, W), g, d),
                 "Right": u(t, (n, W), g, d)}, {}, ("Out",), True, R),
             ("margin_rank_loss", "margin_rank_loss", lambda t, n, g, d: {
                 "Label": bits(t, (n, W), g, d) * 2 - 1,
                 "X1": u(t, (n, W), g, d), "X2": u(t, (n, W), g, d)},
              {"margin": 0.5}, ("Out", "Activated"), True, R),
             ("hinge_loss", "hinge_loss", lambda t, n, g, d: {
                 "Logits": u(t, (n, W), g, d),
                 "Labels": bits(t, (n, W), g, d)}, {}, ("Loss",), True, R)]

    V, E = BREADTH_TABLE

    def ids(t, n, g, d, lo=0, hi=V):
        i = t.randint(lo, hi, (n,), generator=g, device=d)
        i[::3] = i[0]                       # an id repeated n / 3 times
        return i

    cases += [
        ("gather", "gather", lambda t, n, g, d: {
            "X": u(t, (V, E), g, d), "Index": ids(t, n, g, d)}, {},
         ("Out",), True, BREADTH_IDS),
        ("scatter", "scatter", lambda t, n, g, d: {
            "X": u(t, (V, E), g, d), "Ids": ids(t, n, g, d),
            "Updates": u(t, (n, E), g, d)}, {"overwrite": True}, ("Out",),
         True, BREADTH_IDS),
        ("scatter_add", "scatter", lambda t, n, g, d: {
            "X": u(t, (V, E), g, d), "Ids": ids(t, n, g, d),
            "Updates": u(t, (n, E), g, d)}, {"overwrite": False}, ("Out",),
         True, BREADTH_IDS),
        ("gather_nd", "gather_nd", lambda t, n, g, d: {
            "X": u(t, (V, E), g, d), "Index": t.stack(
                [ids(t, n, g, d), ids(t, n, g, d, hi=E)], -1)}, {},
         ("Out",), True, BREADTH_IDS),
        ("one_hot", "one_hot", lambda t, n, g, d: {
            "X": ids(t, n, g, d, lo=-5, hi=V + 5).reshape(n, 1)},
         {"depth": V}, ("Out",), False, BREADTH_IDS)]

    B4 = BREADTH_4D

    def x4(t, n, g, d):
        return u(t, (n,) + B4[1:], g, d)

    cases += [
        ("stack", "stack", lambda t, n, g, d: {
            "X": [x4(t, n, g, d), x4(t, n, g, d)]}, {"axis": 1}, ("Y",),
         True, B4[0]),
        ("unstack", "unstack", lambda t, n, g, d: {"X": x4(t, n, g, d)},
         {"axis": 1}, ("Y",), True, B4[0]),
        ("expand", "expand", lambda t, n, g, d: {"X": x4(t, n, g, d)},
         {"expand_times": [1, 2, 1, 1]}, ("Out",), True, B4[0]),
        ("pad", "pad", lambda t, n, g, d: {"X": x4(t, n, g, d)},
         {"paddings": [0, 0, 0, 0, 1, 2, 3, 4], "pad_value": 0.5},
         ("Out",), True, B4[0]),
        *((f"pad2d_{mode}", "pad2d", lambda t, n, g, d: {
            "X": x4(t, n, g, d)}, {"paddings": [1, 2, 3, 4], "mode": mode,
                                   "pad_value": 0.5}, ("Out",), True, B4[0])
          for mode in ("constant", "reflect", "edge")),
        ("flatten", "flatten", lambda t, n, g, d: {"X": x4(t, n, g, d)},
         {"axis": 2}, ("Out",), True, B4[0]),
        ("reverse", "reverse", lambda t, n, g, d: {"X": x4(t, n, g, d)},
         {"axis": [1, 3]}, ("Out",), True, B4[0])]

    def conv_in(t, n, g, d, c, hw, f):
        return {"Input": u(t, (n, c, hw, hw), g, d),
                "Filter": u(t, f, g, d, 0.1)}

    dw = ("depthwise_conv2d", lambda t, n, g, d: conv_in(
        t, n, g, d, 256, 56, (256, 1, 3, 3)),
        {"strides": [1, 1], "paddings": [1, 1]}, ("Output",), True, 32)
    ct = ("conv2d_transpose", lambda t, n, g, d: conv_in(
        t, n, g, d, 256, 14, (256, 128, 4, 4)),
        {"strides": [2, 2], "paddings": [1, 1]}, ("Output",), True, 32)
    cases += [
        ("depthwise_conv2d",) + dw, ("conv2d_transpose",) + ct,
        ("depthwise_conv2d_amp",) + dw, ("conv2d_transpose_amp",) + ct,
        ("lrn", "lrn", lambda t, n, g, d: {"X": u(t, (n, 96, 55, 55), g, d)},
         {"n": 5}, ("Out", "MidOut"), True, 32),
        ("grid_sampler", "grid_sampler", lambda t, n, g, d: {
            "X": u(t, (n, 64, 56, 56), g, d),
            "Grid": _lattice(t, t.rand(n, 56, 56, 2, generator=g, device=d)
                             * 2.2 - 1.1)}, {}, ("Output",), True, 32)]
    return cases


def _prod_input(torch, n, w, gen, dev):
    """Values near 1 (so a row's product of 2048 stays finite), a row in
    seven with one exact zero and a row in eleven with two."""
    x = 1.0 + 0.001 * torch.randn(n, w, generator=gen, device=dev)
    x[::7, 5] = 0.0
    x[::11, 9:11] = 0.0
    return x


def _breadth_program(ptt, op_type, inputs, attrs, outs, backward):
    """A Program of one op on data vars built with the port's own
    LayerHelper, its first output cast to float32 and averaged, and the
    grads of every float input when `backward`; returns (main, fetch)."""
    from paddle_tpu_torch.core.backward import append_backward
    from paddle_tpu_torch.layer_helper import LayerHelper
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()), ptt.unique_name.guard():
        blk = main.global_block()
        helper = LayerHelper(op_type)
        slots = {}
        for slot, v in inputs.items():
            vs = v if isinstance(v, list) else [v]
            slots[slot] = [f"{slot}_{k}" for k in range(len(vs))]
            for name, a in zip(slots[slot], vs):
                blk.create_var(name=name, shape=tuple(a.shape),
                               dtype=str(a.dtype).replace("torch.", ""),
                               is_data=True,
                               stop_gradient=not a.is_floating_point())
        out = {}
        for slot in outs:
            count = (inputs["X"].shape[attrs.get("axis", 0)]
                     if op_type == "unstack" else 1)
            out[slot] = [helper.create_variable_for_type_inference().name
                         for _ in range(count)]
        helper.append_op(op_type, inputs=slots, outputs=out, attrs=attrs)
        fetch = [n for slot in outs for n in out[slot][:1]]
        if backward:
            first = ptt.layers.cast(blk.var(out[outs[0]][0]), "float32")
            append_backward(ptt.layers.mean(first))
            fetch += [n + "@GRAD" for names in slots.values() for n in names
                      if n + "@GRAD" in blk.vars]
    return main, fetch, {n: a for slot, v in inputs.items() for n, a in zip(
        slots[slot], v if isinstance(v, list) else [v])}


def _bits_equal(torch, a, b):
    """Bit for bit, NaN payloads included."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
                torch.float16: torch.int16, torch.float64: torch.int64}
        return torch.equal(a.view(view[a.dtype]), b.view(view[b.dtype]))
    return torch.equal(a, b)


def run_breadth_case(torch, ptt, case, seed):
    """One case of the bank: at full size two card runs (bit-equal) and
    BREADTH_TIMED timed ones; at the cut size the card against the host
    (and, for an `_amp` case, the host's float32 run for bf16's own
    distance)."""
    import numpy as np
    name, op_type, make, attrs, outs, backward, full_n = case
    amp = name.endswith("_amp")
    dev = ptt.CUDAPlace(0).torch_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    inputs = make(torch, full_n, gen, dev)
    main, fetch, feed = _breadth_program(ptt, op_type, inputs, attrs, outs,
                                         backward)
    card = ptt.Executor(ptt.CUDAPlace(0), amp=amp)
    runs = [card.run(main, feed=feed, fetch_list=fetch, scope=ptt.Scope(),
                     return_numpy=False) for _ in range(2)]
    for n, a, b in zip(fetch, *runs):
        if not _bits_equal(torch, a, b):
            raise AssertionError(f"breadth {name}: two card runs differ in "
                                 f"{n}")
    shapes = {n: list(a.shape) for n, a in zip(fetch, runs[0])}
    del runs
    ms = []
    for _ in range(BREADTH_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card.run(main, feed=feed, fetch_list=fetch, scope=ptt.Scope(),
                 return_numpy=False)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    del feed, inputs
    # the cut: the same program at rows (or batch) / BREADTH_CUT
    gen.manual_seed(seed)
    inputs = make(torch, full_n // BREADTH_CUT, gen, dev)
    main, fetch, feed = _breadth_program(ptt, op_type, inputs, attrs, outs,
                                         backward)
    host_feed = {n: a.cpu() for n, a in feed.items()}
    got = card.run(main, feed=feed, fetch_list=fetch, scope=ptt.Scope())
    want = ptt.Executor(ptt.CPUPlace(), amp=amp).run(
        main, feed=host_feed, fetch_list=fetch, scope=ptt.Scope())
    share = 0.0
    if amp:
        f32 = ptt.Executor(ptt.CPUPlace()).run(
            main, feed=host_feed, fetch_list=fetch, scope=ptt.Scope())
    for i, (n, c, h) in enumerate(zip(fetch, got, want)):
        if c.shape != h.shape or c.dtype != h.dtype:
            raise AssertionError(f"breadth {name}: {n} is {c.dtype} "
                                 f"{c.shape} on the card, {h.dtype} "
                                 f"{h.shape} on the host")
        if h.dtype.kind != "f":
            if not np.array_equal(c, h):
                raise AssertionError(f"breadth {name}: {n} differs")
            continue
        fin = np.isfinite(h)
        if not np.isfinite(c[fin]).all():
            raise AssertionError(f"breadth {name}: {n} not finite on the "
                                 f"card where the host's is")
        if not np.array_equal(np.isnan(c), np.isnan(h)):
            raise AssertionError(f"breadth {name}: {n} NaN apart")
        c, h = np.where(fin, c, 0.0), np.where(fin, h, 0.0)
        if amp:
            noise = _rel_l2(np, h, np.asarray(f32[i]))
            e = _rel_l2(np, c, h) / max(AMP_NOISE_FACTOR * noise, 1e-30)
        elif name in BREADTH_SUM_ORDER:
            e = float(np.abs(c.astype(np.float64) - h).max(initial=0)) / (
                BREADTH_SCALE_TOL * max(float(np.abs(h).max(initial=0)),
                                        1e-30))
        else:
            e = float((np.abs(c.astype(np.float64) - h) / (
                BREADTH_ATOL + BREADTH_RTOL * np.abs(h))).max(initial=0))
        share = max(share, e)
        if e > 1.0:
            raise AssertionError(f"breadth {name}: {n} card vs host at "
                                 f"{e:.3g} of its tolerance")
    return dict(name=name, op=op_type, amp=amp, ms=ms,
                ms_median=_median(ms), shapes=shapes, tol_share=share,
                gate=("amp" if amp else "scale" if name in BREADTH_SUM_ORDER
                      else "elementwise"))


def run_breadth(torch, ptt, native):
    """Phase 7k (b): every case of `_breadth_cases`, cuDNN deterministic
    (its default algorithms may add a conv's weight grad in another order
    each run); no kernel of csrc/ may launch."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    native.reset_launches()
    try:
        out = [run_breadth_case(torch, ptt, case, SEED + 1000 + i)
               for i, case in enumerate(_breadth_cases())]
    finally:
        torch.backends.cudnn.deterministic = det
    launches = dict(native.launches)
    if any(launches.values()):
        raise AssertionError(f"breadth bank launched a kernel: {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7l: the rest of the op families (structured ops, detection,
# quantization)
# ---------------------------------------------------------------------------

def build_ssd(ptt, is_test=False, **kw):
    """train-mobilenet-ssd's program (tools/torch_mobilenet_ssd.py), or
    its is_test twin with `detection_output`, `detection_map` and an
    `evaluator.DetectionMAP`; the two share their parameters' names."""
    from tools import torch_mobilenet_ssd as mssd
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        v = mssd.build(ptt, is_test=is_test, **kw)
        if is_test:
            v["evaluator"] = ptt.evaluator.DetectionMAP(
                v["nmsed"], v["gt"], class_num=mssd.CLASSES)
    return main, startup, v


def _ssd_feeds(torch, dev, seed, n, batch, test=False):
    from tools import torch_mobilenet_ssd as mssd
    out = []
    for i in range(n):
        f = mssd.batch(seed + i, batch)[1 if test else 0]
        out.append(f if dev is None else
                   {k: torch.from_numpy(a).to(dev) for k, a in f.items()})
    return out


def run_train_mobilenet_ssd(torch, ptt, native):
    """Phase 7l (a): train-mobilenet-ssd on the card, then card vs host
    per step from the host's state, the is_test program's detections and
    mAP on both, and a short AMP run (the module's constants above)."""
    import numpy as np
    from paddle_tpu_torch.core.executor import fetch_var
    from tools import torch_mobilenet_ssd as mssd
    main, startup, v = build_ssd(ptt)
    priors = int(v["boxes"].shape[0])
    if priors != mssd.PRIORS:
        raise AssertionError(f"train-mobilenet-ssd: {priors} priors, "
                             f"{mssd.PRIORS} expected")
    match = mssd.op_output(main, "bipartite_match", "ColToRowMatchIndices")
    negs = mssd.op_output(main, "mine_hard_examples", "NegMask")
    dev = ptt.CUDAPlace(0).torch_device()
    t0 = time.perf_counter()
    feeds = _ssd_feeds(torch, dev, DATA_SEED, SSD_DATA_BATCHES, SSD_BATCH)
    data_s = time.perf_counter() - t0
    exe, scope = ptt.Executor(ptt.CUDAPlace(0)), ptt.Scope()
    exe.run(startup, scope=scope)
    state0 = {n: np.array(fetch_var(n, scope))
              for n in scope.local_var_names()}
    native.reset_launches()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for step in range(SSD_WARMUP + SSD_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, = exe.run(main, feed=feeds[step % SSD_DATA_BATCHES],
                       fetch_list=[v["loss"]], scope=scope,
                       return_numpy=False)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out.reshape(-1)[0]))
    peak = torch.cuda.max_memory_allocated() - base
    _, calls = _count_rule_calls(lambda: exe.run(
        main, feed=feeds[0], fetch_list=[v["loss"]], scope=scope))
    launches = dict(native.launches)
    if any(launches.values()):
        raise AssertionError(f"train-mobilenet-ssd launched a kernel: "
                             f"{launches}")
    # the batches cycle: the last cycle's mean below the first's
    first, last = (np.mean(losses[:SSD_DATA_BATCHES]),
                   np.mean(losses[-SSD_DATA_BATCHES:]))
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"train-mobilenet-ssd losses {losses}")
    timed = ms[SSD_WARMUP:]
    res = dict(tag="train-mobilenet-ssd", batch=SSD_BATCH, priors=priors,
               losses=losses, step_ms=timed, step_ms_median=_median(timed),
               images_per_s=SSD_BATCH / _median(timed) * 1e3,
               rule_calls=calls, ops=len(main.global_block().ops),
               peak_bytes=peak, data_s=data_s,
               n_params=len(main.global_block().all_parameters()))
    res["step"] = lambda: exe.run(main, feed=feeds[0],
                                  fetch_list=[v["loss"]], scope=scope)
    res["parity"] = _ssd_parity(torch, ptt, main, v["loss"], match, negs,
                                state0)
    res["eval"] = _ssd_eval(torch, ptt, native, scope)
    t0 = time.perf_counter()
    res["amp"] = run_step_parity(
        torch, ptt, "train-mobilenet-ssd-amp", main, startup, v["loss"],
        _ssd_feeds(torch, None, DATA_SEED + 200, SSD_AMP_STEPS,
                   SSD_AMP_BATCH), SSD_AMP_STEPS, amp=True,
        sign_updates=True)
    res["amp"]["seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _ssd_parity(torch, ptt, main, loss, match, negs, state0):
    """Card vs host at SSD_PARITY_BATCH from `state0`: each step on the
    card from the host's state (losses within LOSS_RTOL, the match
    indices and the mined negatives equal), and the card's free run from
    the same state beside the host's (drift reported, not gated)."""
    import numpy as np
    from paddle_tpu_torch.core.executor import fetch_var
    t0 = time.perf_counter()
    feeds = _ssd_feeds(torch, None, DATA_SEED + 100, SSD_PARITY_STEPS,
                       SSD_PARITY_BATCH)
    fetch = [loss, match, negs]
    card_exe, host_exe = ptt.Executor(ptt.CUDAPlace(0)), ptt.Executor(
        ptt.CPUPlace())
    host = ptt.io.state_from_numpy(state0, ptt.CPUPlace())
    free = ptt.io.state_from_numpy(state0, ptt.CUDAPlace(0))
    out = dict(losses={"card": [], "host": [], "free": []}, rel_err=0.0,
               free_rel_err=[], free_match_equal=[], free_neg_equal=[],
               positives=[], negatives=[])
    for step, feed in enumerate(feeds):
        state = {n: fetch_var(n, host) for n in host.local_var_names()}
        c = card_exe.run(main, feed=feed, fetch_list=fetch,
                         scope=ptt.io.state_from_numpy(state,
                                                       ptt.CUDAPlace(0)))
        h = host_exe.run(main, feed=feed, fetch_list=fetch, scope=host)
        f = card_exe.run(main, feed=feed, fetch_list=fetch, scope=free)
        cl, hl, fl = (float(x[0].reshape(-1)[0]) for x in (c, h, f))
        rel = abs(cl - hl) / abs(hl)
        out["rel_err"] = max(out["rel_err"], rel)
        for side, x in (("card", cl), ("host", hl), ("free", fl)):
            out["losses"][side].append(x)
        if rel > LOSS_RTOL or not (np.array_equal(c[1], h[1])
                                   and np.array_equal(c[2], h[2])):
            raise AssertionError(
                f"train-mobilenet-ssd parity step {step}: loss card {cl} "
                f"host {hl} ({rel:.3g}, tol {LOSS_RTOL}); match indices "
                f"differ at {int((c[1] != h[1]).sum())}, mined negatives "
                f"at {int((c[2] != h[2]).sum())} priors")
        out["positives"].append(int((h[1] >= 0).sum()))
        out["negatives"].append(int(h[2].sum()))
        out["free_rel_err"].append(abs(fl - hl) / abs(hl))
        out["free_match_equal"].append(bool(np.array_equal(f[1], h[1])))
        out["free_neg_equal"].append(bool(np.array_equal(f[2], h[2])))
    out["seconds"] = time.perf_counter() - t0
    return out


def _ssd_eval(torch, ptt, native, scope):
    """The is_test program on the trained card scope: SSD_EVAL_BATCHES
    batches of detection_output + detection_map (11point and integral)
    and the DetectionMAP evaluator on the card; on the first batch the
    host's run from the same parameters, the NMS fed the card's decoded
    boxes and scores on both sides (Out and Count equal), and the
    end-to-end mAP against the host's."""
    import numpy as np
    from paddle_tpu_torch.core.executor import fetch_var
    tmain, _, tv = build_ssd(ptt, is_test=True)
    nms_op = [op for op in tmain.global_block().ops
              if op.type == "multiclass_nms"][0]
    decoded, probs = nms_op.input("BBoxes")[0], nms_op.input("Scores")[0]
    ev = tv["evaluator"]
    fetch = [tv["nmsed"], tv["count"], tv["map_11point"],
             tv["map_integral"], ev.metrics[0], decoded, probs]
    dev = ptt.CUDAPlace(0).torch_device()
    host_feeds = _ssd_feeds(torch, None, DATA_SEED + 300, SSD_EVAL_BATCHES,
                            SSD_BATCH, test=True)
    exe = ptt.Executor(ptt.CUDAPlace(0))
    native.reset_launches()
    ms, maps, counts, cards = [], {"11point": [], "integral": []}, [], []
    for feed in host_feeds:
        card_feed = {k: torch.from_numpy(a).to(dev) for k, a in feed.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = exe.run(tmain, feed=card_feed, fetch_list=fetch, scope=scope)
        ms.append((time.perf_counter() - t0) * 1e3)
        ev.update(got[4], 1)            # weight 1 a batch: a plain mean
        maps["11point"].append(float(got[2][0]))
        maps["integral"].append(float(got[3][0]))
        counts.append(got[1].tolist())
        cards.append(got)
    if any(native.launches.values()):
        raise AssertionError(f"mobilenet-ssd eval launched a kernel: "
                             f"{dict(native.launches)}")
    # the host from the same parameters, first batch
    state = {n: np.array(fetch_var(n, scope)) for n in scope.local_var_names()}
    t0 = time.perf_counter()
    host = ptt.Executor(ptt.CPUPlace()).run(
        tmain, feed=host_feeds[0], fetch_list=fetch,
        scope=ptt.io.state_from_numpy(state, ptt.CPUPlace()))
    host_s = time.perf_counter() - t0
    card = cards[0]
    # the NMS alone, fed the card's decoded boxes and scores
    nms_prog, nms_fetch, nms_feed = _breadth_program(
        ptt, "multiclass_nms",
        {"BBoxes": torch.from_numpy(card[5]),
         "Scores": torch.from_numpy(card[6])},
        dict(nms_op.attrs), ("Out", "Count"), False)
    nms = {side: ptt.Executor(place).run(
        nms_prog, feed={k: a.to(place.torch_device())
                        for k, a in nms_feed.items()},
        fetch_list=nms_fetch, scope=ptt.Scope())
        for side, place in (("card", ptt.CUDAPlace(0)),
                            ("host", ptt.CPUPlace()))}
    for a, b in zip(nms["card"], nms["host"]):
        if not np.array_equal(a, b):
            raise AssertionError("mobilenet-ssd eval: the NMS fed the same "
                                 "boxes and scores differs card vs host")
    gt = host_feeds[0]["gt"]
    same_input = {}
    for ap in ("11point", "integral"):
        prog, pf, pfeed = _breadth_program(
            ptt, "detection_map", {"DetectRes": torch.from_numpy(card[0]),
                                   "Label": torch.from_numpy(gt)},
            {"class_num": 21, "ap_version": ap}, ("MAP",), False)
        c, h = (float(ptt.Executor(place).run(
            prog, feed={k: a.to(place.torch_device())
                        for k, a in pfeed.items()},
            fetch_list=pf, scope=ptt.Scope())[0][0])
            for place in (ptt.CUDAPlace(0), ptt.CPUPlace()))
        if abs(c - h) > 1e-6 * max(abs(h), 1e-30):
            raise AssertionError(f"mobilenet-ssd eval: detection_map fed "
                                 f"the same detections: card {c} host {h}")
        same_input[ap] = c
    # end to end: rows whose label or box differs, and the mAP
    rows = int(np.sum((card[0][..., 0] != host[0][..., 0])
                      | (np.abs(card[0][..., 2:] - host[0][..., 2:])
                         > 1e-4).any(-1)))
    errs = {ap: abs(float(card[i][0]) - float(host[i][0]))
            for ap, i in (("11point", 2), ("integral", 3))}
    if max(errs.values()) > SSD_MAP_ATOL:
        raise AssertionError(f"mobilenet-ssd eval: mAP card "
                             f"{card[2][0]}, {card[3][0]} host "
                             f"{host[2][0]}, {host[3][0]}: {errs} > "
                             f"{SSD_MAP_ATOL} ({rows} detection rows "
                             f"differ)")
    # detection_map's own check: the ground truth as its detections
    # (score 1) scores 1 on the card
    det = gt[..., [0, 1, 2, 3, 4, 5]].copy()
    det[..., 1] = np.where(gt[..., 0] > 0, 1.0, -1.0)
    perfect = {}
    for ap in ("11point", "integral"):
        prog, pf, pfeed = _breadth_program(
            ptt, "detection_map",
            {"DetectRes": torch.from_numpy(det).to(dev),
             "Label": torch.from_numpy(gt).to(dev)},
            {"class_num": 21, "ap_version": ap}, ("MAP",), False)
        perfect[ap] = float(ptt.Executor(ptt.CUDAPlace(0)).run(
            prog, feed=pfeed, fetch_list=pf, scope=ptt.Scope())[0][0])
    if min(perfect.values()) != 1.0:
        raise AssertionError(f"mobilenet-ssd eval: the ground truth as its "
                             f"detections scores {perfect}, not 1")
    return dict(batch=SSD_BATCH, ms=ms, ms_median=_median(ms), maps=maps,
                perfect_map=perfect,
                counts=counts, evaluator_map=float(ev.eval()),
                host_map={"11point": float(host[2][0]),
                          "integral": float(host[3][0])},
                host_count=host[1].tolist(), map_err=errs,
                rows_differ=rows, same_input_map=same_input, host_s=host_s,
                nms_equal=True, kept=int(np.sum(card[1])))


def _item6_cases():
    """The bank's new cases, in `_breadth_cases`' format: every op of
    phase 7l at a full-width shape (the module docstring lists them)."""
    W = BREADTH_WIDTH

    def u(torch, shape, gen, dev, scale=1.0):
        return _lattice(torch, torch.randn(*shape, generator=gen,
                                           device=dev) * scale)

    def ints(torch, lo, hi, shape, gen, dev):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    def boxes(torch, shape, gen, dev):
        p = torch.rand(*shape, 2, 2, generator=gen, device=dev).sort(
            dim=-2).values
        return p.reshape(*shape, 4)[..., [0, 2, 1, 3]].contiguous()

    c3d = ("conv3d", lambda t, n, g, d: {
        "Input": u(t, (4, 64, n, 56, 56), g, d),
        "Filter": u(t, (128, 64, 3, 3, 3), g, d, 0.05)},
        {"strides": [1, 1, 1], "paddings": [1, 1, 1]}, ("Output",), True,
        16)
    cases = [("conv3d",) + c3d,
             ("conv3d_transpose", "conv3d_transpose", lambda t, n, g, d: {
                 "Input": u(t, (4, 64, n, 56, 56), g, d),
                 "Filter": u(t, (64, 128, 3, 3, 3), g, d, 0.05)},
              {"strides": [1, 1, 1], "paddings": [1, 1, 1]}, ("Output",),
              True, 16),
             ("pool3d_max", "pool3d", lambda t, n, g, d: {
                 "X": u(t, (4, 64, n, 56, 56), g, d)},
              {"pooling_type": "max", "ksize": [2, 2, 2],
               "strides": [2, 2, 2]}, ("Out",), True, 16),
             ("pool3d_avg", "pool3d", lambda t, n, g, d: {
                 "X": u(t, (4, 64, n, 56, 56), g, d)},
              {"pooling_type": "avg", "ksize": [3, 3, 3],
               "strides": [2, 2, 2], "paddings": [1, 1, 1]}, ("Out",), True,
              16)]
    for name, size in (("bilinear_up", 128), ("bilinear_down", 32)):
        cases.append((name, "bilinear_interp", lambda t, n, g, d: {
            "X": u(t, (n, 256, 64, 64), g, d)},
            {"out_h": size, "out_w": size}, ("Out",), True, 16))
    cases += [
        ("nearest_down", "bilinear_interp", lambda t, n, g, d: {
            "X": u(t, (n, 256, 64, 64), g, d)},
         {"out_h": 32, "out_w": 48, "interp_method": "nearest"}, ("Out",),
         True, 16),
        ("roi_pool", "roi_pool", lambda t, n, g, d: {
            "X": u(t, (2, 512, 38, 50), g, d),
            "ROIs": t.cat([ints(t, 0, 2, (n, 1), g, d).float(),
                           boxes(t, (n,), g, d) * t.tensor(
                               [800.0, 608.0, 800.0, 608.0], device=d)],
                          1)},
         {"pooled_height": 7, "pooled_width": 7,
          "spatial_scale": 1.0 / 16}, ("Out",), True, 256),
        ("crop", "crop", lambda t, n, g, d: {
            "X": u(t, (n, 3, 256, 256), g, d),
            "Y": t.zeros(n, 3, 224, 224, device=d)},
         {"offsets": [0, 0, 16, 16]}, ("Out",), True, 128),
        ("label_smooth", "label_smooth", lambda t, n, g, d: {
            "X": t.nn.functional.one_hot(ints(t, 0, 30000, (n,), g, d),
                                         30000).float()},
         {"epsilon": 0.1}, ("Out",), True, 4096),
        ("multiplex", "multiplex", lambda t, n, g, d: {
            "X": [u(t, (n, W), g, d) for _ in range(3)],
            "Ids": ints(t, 0, 3, (n, 1), g, d)}, {}, ("Out",), True,
         BREADTH_ROWS),
        ("lod_reset", "lod_reset", lambda t, n, g, d: {
            "X": u(t, (n, W), g, d),
            "Y": t.full((n // 64,), 64, dtype=t.int32, device=d)}, {},
         ("Out",), True, BREADTH_ROWS),
        ("mean_iou", "mean_iou", lambda t, n, g, d: {
            "Predictions": ints(t, 0, 21, (n, 512, 512), g, d).int(),
            "Labels": ints(t, 0, 21, (n, 512, 512), g, d).int()},
         {"num_classes": 21}, ("OutMeanIou", "OutWrong", "OutCorrect"),
         False, 16),
        ("hierarchical_sigmoid", "hierarchical_sigmoid", lambda t, n, g, d: {
            "X": u(t, (n, 512), g, d), "W": u(t, (29999, 512), g, d, 0.05),
            "Label": ints(t, 0, 30000, (n, 1), g, d),
            "Bias": u(t, (29999, 1), g, d, 0.1)}, {"num_classes": 30000},
         ("Out",), True, BREADTH_IDS),
        ("warpctc", "warpctc", lambda t, n, g, d: {
            "Logits": u(t, (n, 96, 96), g, d),
            "Label": ints(t, 1, 96, (n, 24), g, d),
            "LogitsLen": ints(t, 48, 97, (n,), g, d),
            "LabelLen": ints(t, 0, 25, (n,), g, d)}, {"blank": 0},
         ("Loss",), True, 32),
        ("ctc_greedy_decoder", "ctc_greedy_decoder", lambda t, n, g, d: {
            "X": u(t, (n, 96, 96), g, d),
            "SeqLen": ints(t, 48, 97, (n,), g, d).int()}, {"blank": 0},
         ("Out", "OutLen"), False, 32),
        ("edit_distance", "edit_distance", lambda t, n, g, d: {
            "Hyps": ints(t, 1, 8, (n, 96), g, d),
            "Refs": ints(t, 1, 8, (n, 24), g, d),
            "HypsLen": ints(t, 0, 40, (n,), g, d),
            "RefsLen": ints(t, 1, 25, (n,), g, d)}, {"normalized": True},
         ("Out", "SequenceNum"), False, 32),
        ("im2sequence", "im2sequence", lambda t, n, g, d: {
            "X": u(t, (n, 128, 6, 96), g, d)},
         {"kernels": [6, 1], "strides": [1, 1]}, ("Out",), True, 32),
        ("chunk_eval", "chunk_eval", lambda t, n, g, d: {
            "X": ints(t, 0, 9, (n, 100), g, d),
            "Label": ints(t, 0, 9, (n, 100), g, d),
            "SeqLen": ints(t, 20, 101, (n,), g, d).int()},
         {"num_chunk_types": 4, "chunk_scheme": "IOB"},
         ("NumInferChunks", "NumLabelChunks", "NumCorrectChunks",
          "Precision", "Recall", "F1-Score"), False, 64),
        ("fake_quantize_abs_max", "fake_quantize_abs_max",
         lambda t, n, g, d: {"X": u(t, (n, W), g, d)}, {"bit_length": 8},
         ("Out", "OutScale"), True, BREADTH_ROWS),
        ("fake_quantize_range_abs_max", "fake_quantize_range_abs_max",
         lambda t, n, g, d: {"X": u(t, (n, 1024, 14, 14), g, d),
                             "InScale": t.full((1,), 3.0, device=d)},
         {"bit_length": 8}, ("Out", "OutScale"), True, 128),
        ("fake_dequantize_max_abs", "fake_dequantize_max_abs",
         lambda t, n, g, d: {"X": t.round(u(t, (n, W), g, d, 40.0)),
                             "Scale": t.full((1,), 2.5, device=d)},
         {"max_range": 127.0}, ("Out",), True, BREADTH_ROWS)]

    # detection at SSD's shapes (batch n, 2278 priors, 21 classes, 16
    # ground-truth rows) and Faster R-CNN's anchors over a 38 x 50 map
    P, C, G = 2278, 21, 16
    cases += [
        ("prior_box", "prior_box", lambda t, n, g, d: {
            "Input": t.zeros(n, 1, 19, 19, device=d),
            "Image": t.zeros(n, 1, 300, 300, device=d)},
         {"min_sizes": [60.0], "max_sizes": [111.0],
          "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True},
         ("Boxes", "Variances"), False, 32),
        ("anchor_generator", "anchor_generator", lambda t, n, g, d: {
            "Input": t.zeros(n, 1, 38, 50, device=d)},
         {"anchor_sizes": [32.0, 64.0, 128.0, 256.0, 512.0],
          "aspect_ratios": [0.5, 1.0, 2.0], "stride": [16.0, 16.0]},
         ("Anchors", "Variances"), False, 8),
        ("iou_similarity", "iou_similarity", lambda t, n, g, d: {
            "X": boxes(t, (n, G), g, d), "Y": boxes(t, (P,), g, d)}, {},
         ("Out",), False, 32),
        ("box_coder_decode", "box_coder", lambda t, n, g, d: {
            "PriorBox": boxes(t, (P,), g, d),
            "PriorBoxVar": t.tensor([0.1, 0.1, 0.2, 0.2],
                                    device=d).expand(P, 4).contiguous(),
            "TargetBox": u(t, (n, P, 4), g, d)},
         {"code_type": "decode_center_size"}, ("OutputBox",), True, 32),
        ("bipartite_match", "bipartite_match", lambda t, n, g, d: {
            "DistMat": t.round(t.rand(n, G, P, generator=g, device=d)
                               ** 4 * 16) / 16},
         {"match_type": "per_prediction", "dist_threshold": 0.5},
         ("ColToRowMatchIndices", "ColToRowMatchDist"), False, 32),
        ("target_assign", "target_assign", lambda t, n, g, d: {
            "X": boxes(t, (n, G), g, d),
            "MatchIndices": ints(t, -1, G, (n, P), g, d)},
         {"mismatch_value": 0.0}, ("Out", "OutWeight"), True, 32),
        ("box_encode_per_prior", "box_encode_per_prior", lambda t, n, g, d: {
            "TargetBox": boxes(t, (n, P), g, d),
            "PriorBox": boxes(t, (P,), g, d)}, {}, ("OutputBox",), True, 32),
        ("smooth_l1_elementwise", "smooth_l1_elementwise",
         lambda t, n, g, d: {"X": u(t, (n, P, 4), g, d)}, {"sigma": 1.0},
         ("Out",), True, 32),
        ("softmax_ce_no_reduce", "softmax_ce_no_reduce", lambda t, n, g, d: {
            "Logits": u(t, (n, P, C), g, d),
            "Label": ints(t, 0, C, (n, P, 1), g, d)}, {}, ("Out",), True,
         32),
        ("greater_equal_scalar0", "greater_equal_scalar0",
         lambda t, n, g, d: {"X": ints(t, -1, G, (n, P), g, d).float()},
         {}, ("Out",), False, 32),
        ("mine_hard_examples", "mine_hard_examples", lambda t, n, g, d: {
            "ClsLoss": t.round(t.rand(n, P, generator=g, device=d) * 64)
            / 16,
            "MatchIndices": t.where(t.rand(n, P, generator=g, device=d)
                                    < 0.02, ints(t, 0, G, (n, P), g, d),
                                    -1),
            "MatchDist": t.rand(n, P, generator=g, device=d) * 0.7},
         {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5},
         ("NegMask", "UpdatedMatchIndices"), False, 32),
        ("multiclass_nms", "multiclass_nms", lambda t, n, g, d: {
            "BBoxes": boxes(t, (n, P), g, d),
            "Scores": t.round(t.softmax(u(t, (n, P, C), g, d, 3.0), -1)
                              .transpose(1, 2) * 256) / 256},
         dict(score_threshold=0.01, nms_top_k=400, keep_top_k=200,
              nms_threshold=0.45), ("Out", "Count"), False, 32),
        ("detection_map", "detection_map", lambda t, n, g, d: {
            "DetectRes": t.cat([ints(t, -1, C, (n, 200, 1), g, d).float(),
                                t.round(t.rand(n, 200, 1, generator=g,
                                               device=d) * 64) / 64,
                                boxes(t, (n, 200), g, d)], -1),
            "Label": t.cat([ints(t, -1, C, (n, G, 1), g, d).float(),
                            (t.rand(n, G, 1, generator=g, device=d)
                             < 0.1).float(), boxes(t, (n, G), g, d)], -1)},
         {"class_num": C, "overlap_threshold": 0.1}, ("MAP",), False, 32),
        ("rpn_target_assign", "rpn_target_assign", lambda t, n, g, d: {
            "Anchor": t.zeros(38 * 50 * 15, 4, device=d),
            "GtBox": t.zeros(G, 4, device=d),
            "DistMat": t.round(t.rand(n, G, 38 * 50 * 15, generator=g,
                                      device=d) * 32) / 32},
         {"rpn_batch_size_per_im": 256}, ("Labels", "MatchIndices"), False,
         8),
        ("polygon_box_transform", "polygon_box_transform",
         lambda t, n, g, d: {"Input": u(t, (n, 8, 128, 128), g, d)}, {},
         ("Output",), True, 32)]
    return cases


def _window_at(torch, x, out):
    """The (row, column) at which `out` is a window of `x`'s last two
    dims, or None."""
    h, w = out.shape[-2:]
    for i in range(x.shape[-2] - h + 1):
        for j in range(x.shape[-1] - w + 1):
            if torch.equal(x[..., i:i + h, j:j + w], out):
                return i, j
    return None


def run_item6_random_case(torch, ptt, name, seed):
    """The bank's random ops, whose card and host draw from different
    generators: two card runs from fresh executors bit-equal, and each
    side's output what the draw must satisfy. `random_crop`: a window
    of its input ([128, 3, 256, 256] -> 224). `nce` (the [30000, 512]
    table, 8192 ids, 10 negatives): Cost and SampleLogits the rule's
    formula on the card's own SampleLabels, evaluated on the host in
    float64 (within BREADTH_SCALE_TOL of the scale), the labels first
    and every negative in [0, 30000)."""
    import numpy as np
    dev = ptt.CUDAPlace(0).torch_device()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if name == "random_crop":
        inputs = {"X": torch.randn(128, 3, 256, 256, generator=gen,
                                   device=dev)}
        op, attrs, outs = "random_crop", {"shape": [224, 224]}, ("Out",)
    else:
        inputs = {"Input": torch.randn(BREADTH_IDS, 512, generator=gen,
                                       device=dev),
                  "Label": torch.randint(0, 30000, (BREADTH_IDS, 1),
                                         generator=gen, device=dev),
                  "Weight": torch.randn(30000, 512, generator=gen,
                                        device=dev) * 0.05,
                  "Bias": torch.randn(30000, generator=gen, device=dev)}
        op = "nce"
        attrs = {"num_total_classes": 30000, "num_neg_samples": 10}
        outs = ("Cost", "SampleLogits", "SampleLabels")
    main, fetch, feed = _breadth_program(ptt, op, inputs, attrs, outs,
                                         op == "nce")
    runs = [ptt.Executor(ptt.CUDAPlace(0)).run(
        main, feed=feed, fetch_list=fetch, scope=ptt.Scope(),
        return_numpy=False) for _ in range(2)]
    for n, a, b in zip(fetch, *runs):
        if not _bits_equal(torch, a, b):
            raise AssertionError(f"bank {name}: two card runs differ in {n}")
    ms = []
    exe = ptt.Executor(ptt.CUDAPlace(0))
    for _ in range(BREADTH_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=fetch, scope=ptt.Scope(),
                return_numpy=False)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    got = runs[0]
    share = 0.0
    if name == "random_crop":
        if _window_at(torch, inputs["X"], got[0]) is None:
            raise AssertionError("bank random_crop: the card's output is "
                                 "no window of its input")
        cut = inputs["X"][:128 // BREADTH_CUT].cpu()
        host, = ptt.Executor(ptt.CPUPlace()).run(
            main, feed={"X_0": cut}, fetch_list=fetch[:1],
            scope=ptt.Scope(), return_numpy=False)
        if _window_at(torch, cut, host) is None:
            raise AssertionError("bank random_crop: the host's output is "
                                 "no window of its input")
    else:
        x = inputs["Input"].double().cpu()
        w = inputs["Weight"].double().cpu()
        b = inputs["Bias"].double().cpu()
        ids = got[2].cpu()
        if not (torch.equal(ids[:, :1], inputs["Label"].cpu())
                and int(ids.min()) >= 0 and int(ids.max()) < 30000):
            raise AssertionError("bank nce: SampleLabels out of range")
        logits = torch.einsum("bd,bkd->bk", x, w[ids]) + b[ids]
        shift = np.log(10) + np.log(1.0 / 30000)
        cost = (torch.nn.functional.softplus(-(logits[:, :1] - shift)).sum(1)
                + torch.nn.functional.softplus(logits[:, 1:] - shift).sum(1))
        for want, have in ((logits, got[1]), (cost[:, None], got[0])):
            e = float((have.double().cpu() - want).abs().max()) / (
                BREADTH_SCALE_TOL * float(want.abs().max()))
            share = max(share, e)
        if share > 1.0:
            raise AssertionError(f"bank nce: the card's Cost / SampleLogits "
                                 f"at {share:.3g} of the tolerance from "
                                 f"the formula on its own SampleLabels")
    return dict(name=name, op=op, amp=False, ms=ms, ms_median=_median(ms),
                shapes={n: list(a.shape) for n, a in zip(fetch, got)},
                tol_share=share, gate="random")


def run_item6_bank(torch, ptt, native):
    """Phase 7l (b): every case of `_item6_cases` through
    `run_breadth_case`, and the two random ops; cuDNN deterministic; no
    kernel of csrc/ may launch."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    native.reset_launches()
    try:
        out = [run_breadth_case(torch, ptt, case, SEED + 2000 + i)
               for i, case in enumerate(_item6_cases())]
        out += [run_item6_random_case(torch, ptt, name, SEED + 3000 + i)
                for i, name in enumerate(("random_crop", "nce"))]
    finally:
        torch.backends.cudnn.deterministic = det
    launches = dict(native.launches)
    if any(launches.values()):
        raise AssertionError(f"phase 7l bank launched a kernel: {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7m: the transpilers
# ---------------------------------------------------------------------------

def _median_ms(torch, fn, n):
    """fn() n times, each timed on the host clock after a sync: (median
    ms, all ms)."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return _median(ms), ms


def _on_card(torch, scope, program):
    """The program's persistables in `scope`: {name: tensor}, each
    checked to lie on the card."""
    out = {}
    for v in program.global_block().vars.values():
        val = scope.find_var(v.name) if v.persistable else None
        if val is None:
            continue
        if not (isinstance(val, torch.Tensor) and val.device.type == "cuda"):
            raise AssertionError(f"{v.name} is not a tensor on the card")
        out[v.name] = val
    return out


def save_infer_base(ptt, path):
    """infer-base: Transformer-base at TRAIN_BASE's widths built `is_test`
    with fused attention, initialized on the host from SEED and saved by
    save_inference_model to `path` (target `logits`)."""
    from paddle_tpu_torch.models import transformer
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = transformer.build(**dict(TRAIN_BASE, is_test=True,
                                              fused_attention=True))
    host = ptt.Executor(ptt.CPUPlace())
    hscope = ptt.Scope()
    host.run(startup, scope=hscope)
    ptt.io.save_inference_model(path, ["src_word", "trg_word"],
                                [fetches["logits"]], host, main_program=main,
                                scope=hscope)


def run_infer_base_bf16(torch, ptt, native, tmp):
    """infer-base-bf16 (INFER_BASE_*) on the infer-base dir it saves under
    `tmp` (phase 7t reads it too): returns the numbers and the two
    prepared runs (for the traced batches)."""
    import numpy as np
    from paddle_tpu_torch.core.executor import to_numpy
    t0 = time.perf_counter()
    host = ptt.Executor(ptt.CPUPlace())
    path = os.path.join(tmp, "infer_base")
    save_infer_base(ptt, path)
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(DATA_SEED)
    feed = {n: rng.randint(0, TRAIN_BASE["trg_vocab_size"],
                           (INFER_BASE_BATCH, TRAIN_BASE["seq_len"])
                           ).astype(np.int64)
            for n in ("src_word", "trg_word")}

    # the host's run of the transpiled dir: its logits on the first rows,
    # and the dtype each attention's Q takes there
    t0 = time.perf_counter()
    hs = ptt.Scope()
    hprog, feeds, targets = ptt.io.load_inference_model(path, host,
                                                        scope=hs)
    ptt.transpiler.Float16Transpiler().transpile(hprog, scope=hs)
    attn_q = [op.input("Q")[0] for op in hprog.global_block().ops
              if op.type == "fused_attention"]
    hres = host.run(hprog, feed={n: v[:INFER_BASE_HOST_ROWS]
                                 for n, v in feed.items()},
                    fetch_list=list(targets) + attn_q, scope=hs,
                    return_numpy=False)
    host_logits = to_numpy(hres[0])
    q_dtypes = [str(t.dtype).replace("torch.", "") for t in hres[1:]]
    expected = {}
    for dt in q_dtypes:
        name = "flash_fwd" + ("_bf16" if dt == "bfloat16" else "")
        expected[name] = expected.get(name, 0) + 1
    del hs, hres
    host_s = time.perf_counter() - t0

    exe = ptt.Executor(ptt.CUDAPlace(0))
    runs = {}
    peak = {}
    for tag in ("float32", "bfloat16"):
        scope = ptt.Scope()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        prog, feeds, targets = ptt.io.load_inference_model(path, exe,
                                                           scope=scope)
        if tag == "bfloat16":
            ptt.transpiler.Float16Transpiler().transpile(prog, scope=scope)
        params = _on_card(torch, scope, prog)
        want = torch.bfloat16 if tag == "bfloat16" else torch.float32
        odd = [n for n, t in params.items()
               if t.is_floating_point() and t.dtype != want]
        if odd:
            raise AssertionError(f"infer-base {tag}: {len(odd)} parameters "
                                 f"not {want} on the card: {odd[:4]}")
        # (d): the static verifier passes the float32 program; on the
        # transpiled one it reports, as the JAX package's does on its own
        # (tests/test_torch_transpiler.py), the vars re-typed bf16 whose
        # rules still give float32 (ROADMAP Queue 3), and nothing else
        try:
            exe.prepare(prog, fetch_list=targets, scope=scope,
                        feed_names=feeds, validate="error")
            mismatches = 0
        except ptt.ProgramVerificationError as e:
            errors = [d for d in e.diagnostics
                      if d.severity == ptt.analysis.Severity.ERROR]
            if tag == "float32" or {d.code for d in errors} != \
                    {"dtype-mismatch"}:
                raise
            mismatches = len(errors)
        if tag == "bfloat16" and not mismatches:
            raise AssertionError("infer-base-bf16: the verifier found no "
                                 "dtype-mismatch on the transpiled program")
        handle = exe.prepare(prog, fetch_list=targets, scope=scope)
        torch.cuda.synchronize()
        param_bytes = torch.cuda.memory_allocated() - base
        runs[tag] = dict(handle=handle, scope=scope, prog=prog,
                         param_bytes=param_bytes, n_params=len(params),
                         mismatches=mismatches)
    for tag in ("float32", "bfloat16"):          # warm-up
        runs[tag]["handle"].run(feed)
    # a batch with its logits fetched to host numpy (the [64, 256, 30000]
    # float32 logits are 1.97 GB), then the timed batches with the logits
    # left on the card, whose time the fetch would otherwise swamp
    fetch_ms = {tag: _median_ms(torch, lambda: runs[tag]["handle"].run(feed),
                                1)[0] for tag in ("float32", "bfloat16")}
    ms = {"float32": [], "bfloat16": []}
    launches = {"float32": {}, "bfloat16": {}}
    for tag in ("float32", "bfloat16", "bfloat16", "float32"):
        h = runs[tag]["handle"]
        native.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        _, all_ms = _median_ms(torch, lambda: h.run(
            feed, return_numpy=False), INFER_BASE_BATCHES // 2)
        peak[tag] = max(peak.get(tag, 0),
                        torch.cuda.max_memory_allocated() - before)
        ms[tag] += all_ms
        for k, v in native.launches.items():
            if v:
                launches[tag][k] = launches[tag].get(k, 0) + v
    per_batch = {tag: {k: v / INFER_BASE_BATCHES for k, v in l.items()}
                 for tag, l in launches.items()}
    if per_batch["bfloat16"] != {k: float(v) for k, v in expected.items()}:
        raise AssertionError(f"infer-base-bf16: launches a batch "
                             f"{per_batch['bfloat16']}, expected {expected} "
                             f"from the host's attention dtypes {q_dtypes}")
    if per_batch["float32"] != {"flash_fwd": float(len(attn_q))}:
        raise AssertionError(f"infer-base float32: launches a batch "
                             f"{per_batch['float32']}")
    out = {tag: to_numpy(runs[tag]["handle"].run(
        feed, return_numpy=False)[0]) for tag in ("float32", "bfloat16")}
    _, rule_calls = _count_rule_calls(
        lambda: runs["bfloat16"]["handle"].run(feed, return_numpy=False))
    card = out["bfloat16"][:INFER_BASE_HOST_ROWS]
    if card.shape != host_logits.shape or not np.isfinite(out["bfloat16"]
                                                          ).all():
        raise AssertionError(f"infer-base-bf16: logits {card.shape} vs host "
                             f"{host_logits.shape}, or not finite")
    scale = float(np.abs(host_logits).max())
    err = float(np.abs(card - host_logits).max())
    if not err <= INFER_BF16_TOL * scale:
        raise AssertionError(f"infer-base-bf16: card vs host {err} > "
                             f"{INFER_BF16_TOL} x {scale}")
    top2 = np.sort(host_logits, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > INFER_BF16_TOL * scale
    if (card.argmax(-1) != host_logits.argmax(-1))[clear].any():
        raise AssertionError("infer-base-bf16: top-1 differs from the "
                             "host's where the host's gap is clear")
    agree = float((out["bfloat16"].argmax(-1)
                   == out["float32"].argmax(-1)).mean())
    return {
        "build_s": build_s, "host_s": host_s, "q_dtypes": q_dtypes,
        "launches_per_batch": per_batch, "attentions": len(attn_q),
        "ms": ms, "ms_median": {k: _median(v) for k, v in ms.items()},
        "with_fetch_ms": fetch_ms,
        "tokens_per_s": {k: INFER_BASE_BATCH * TRAIN_BASE["seq_len"]
                         / (_median(v) / 1e3) for k, v in ms.items()},
        "peak_bytes": peak, "param_bytes": {k: r["param_bytes"]
                                            for k, r in runs.items()},
        "n_params": runs["bfloat16"]["n_params"],
        "dtype_mismatches": runs["bfloat16"]["mismatches"],
        "rule_calls": rule_calls, "host_err": err, "host_scale": scale,
        "tol_share": err / (INFER_BF16_TOL * scale),
        "clear_rows": int(clear.sum()), "top1_vs_float32": agree,
        "handles": {k: r["handle"] for k, r in runs.items()}, "feed": feed}


def _numpy_fold(np, program, state):
    """The fold of every conv2d -> batch_norm pair of `program` over the
    host arrays `state`, in numpy, as the transpiler's docstring states
    it: {name: array} of the filters and the new biases."""
    ops = program.global_block().ops
    out = {}
    for op, nxt in zip(ops, ops[1:]):
        if op.type == "conv2d" and nxt.type == "batch_norm" \
                and op.output("Output")[0] == nxt.input("X")[0]:
            w_name = op.input("Filter")[0]
            scale, bias, mean, var = (state[nxt.input(k)[0]] for k in (
                "Scale", "Bias", "Mean", "Variance"))
            std = np.sqrt(var + nxt.attrs.get("epsilon", 1e-5))
            out[w_name] = state[w_name] * (scale / std).reshape(-1, 1, 1, 1)
            out[w_name + "@bn_folded_bias"] = \
                ((0.0 - mean) * scale / std + bias).astype(np.float32)
    return out


def _closed_loop(srv, name, feeds, clients):
    """Every feed submitted once by `clients` closed-loop threads: (wall
    s, latencies ms, outputs)."""
    lock = threading.Lock()
    state = {"next": 0}
    lat, outs, errors = [None] * len(feeds), [None] * len(feeds), []

    def client():
        while True:
            with lock:
                i = state["next"]
                state["next"] += 1
            if i >= len(feeds):
                return
            t0 = time.perf_counter()
            try:
                outs[i] = srv.submit(name, {"image": feeds[i]}).result(
                    timeout=300)[0]
            except Exception as e:      # reported below, not swallowed
                errors.append(repr(e))
                return
            lat[i] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"{name}: {len(errors)} failed requests: "
                             f"{errors[:2]}")
    return wall, lat, outs


def run_serve_resnet50_folded(torch, ptt, native, tmp):
    """serve-resnet50-folded (FOLD_*): returns the numbers and the two
    prepared batch runs (for the traced batches)."""
    import numpy as np
    t0 = time.perf_counter()
    model = serve_resnet50_model(ptt)
    dirs = {"unfolded": os.path.join(tmp, "rn50_unfolded"),
            "folded": os.path.join(tmp, "rn50_folded")}
    save_serve_resnet50(ptt, model, dirs["unfolded"], 1.0)
    exe = ptt.Executor(ptt.CUDAPlace(0))
    scope = ptt.Scope()
    prog, feeds, targets = ptt.io.load_inference_model(dirs["unfolded"],
                                                       exe, scope=scope)
    state = {n: t.cpu().numpy() for n, t in
             _on_card(torch, scope, prog).items()}
    n_bn = sum(op.type == "batch_norm" for op in prog.global_block().ops)
    ops = {"unfolded": len(prog.global_block().ops)}
    want = _numpy_fold(np, prog, state)
    pairs = ptt.InferenceTranspiler()._fuse_batch_norm(prog, scope)
    left = sum(op.type == "batch_norm" for op in prog.global_block().ops)
    if (pairs, left) != (53, 0):
        raise AssertionError(f"serve-resnet50-folded: {pairs} pairs folded "
                             f"of {n_bn} batch norms, {left} left")
    folded = _on_card(torch, scope, prog)
    for n, w in want.items():
        got = folded[n].cpu().numpy()
        if got.dtype != w.dtype or not np.array_equal(got.view(np.uint32),
                                                      w.view(np.uint32)):
            raise AssertionError(f"serve-resnet50-folded: {n} is not the "
                                 f"numpy fold bit for bit")
    ptt.io.save_inference_model(dirs["folded"], feeds, targets, exe,
                                main_program=prog, scope=scope)
    ops["folded"] = len(prog.global_block().ops)
    del scope, folded
    fold_s = time.perf_counter() - t0

    rng = np.random.RandomState(DATA_SEED + 1)
    c, h, w = RESNET50["image_shape"]
    pool = rng.rand(SERVE_RN50_POOL, h, w, c).astype(np.float32)
    sizes = rng.randint(1, SERVE_RN50_MAX_IMAGES + 1, FOLD_REQUESTS)
    reqs = [pool[rng.randint(0, SERVE_RN50_POOL, n)] for n in sizes]
    probes = [pool[rng.randint(0, SERVE_RN50_POOL, n)]
              for n in SERVE_RN50_PROBES]
    batch = pool[:SERVE_RN50_LADDER[-1]]

    res = {"fold_s": fold_s, "pairs": pairs, "ops": ops,
           "params": {k: sum(os.path.getsize(os.path.join(d, f))
                             for f in os.listdir(d) if f.endswith(".npy"))
                      for k, d in dirs.items()}}
    native.reset_launches()
    with ptt.serve.InferenceServer(ptt.CUDAPlace(0)) as srv:
        for tag, d in dirs.items():
            srv.add_model(tag, d, ladder=ptt.serve.BucketLadder(
                rows=SERVE_RN50_LADDER))
        outs = {tag: [srv.infer(tag, {"image": x})[0] for x in probes]
                for tag in dirs}
        shares, ties = [], 0
        for i, (f, u) in enumerate(zip(outs["folded"], outs["unfolded"])):
            if f.shape != u.shape or not np.isfinite(f).all():
                raise AssertionError(f"serve-resnet50-folded probe {i}: "
                                     f"shape or not finite")
            top2 = np.sort(u, -1)[..., -2:]
            clear = (top2[..., 1] - top2[..., 0]) > FOLD_TIE
            ties += int((~clear).sum())
            if (f.argmax(-1) != u.argmax(-1))[clear].any():
                raise AssertionError(f"serve-resnet50-folded probe {i}: "
                                     f"top-1 differs at a clear gap")
            live = u > SERVE_RN50_LOGP_FLOOR
            logu = np.log(u[live])
            logf = np.log(np.maximum(f[live], np.finfo(np.float32).tiny))
            shares.append(max(
                float(np.abs(f - u).max()) / FOLD_PROB_TOL,
                float((np.abs(logf - logu) / (1 + np.abs(logu))).max())
                / FOLD_LOGP_TOL))
        if not max(shares) <= 1.0:
            raise AssertionError(f"serve-resnet50-folded: {max(shares)} of "
                                 f"the fold's tolerances")
        res.update(tol_share=max(shares), ties=ties)
        traffic = {"unfolded": [], "folded": []}
        for tag in ("unfolded", "folded", "folded", "unfolded"):
            wall, lat, _ = _closed_loop(srv, tag, reqs, SERVE_RN50_CLIENTS)
            traffic[tag].append({
                "wall_s": wall, "images_per_s": int(sizes.sum()) / wall,
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99))})
        res["traffic"] = traffic
    res["launches"] = {k: v for k, v in native.launches.items() if v}
    if res["launches"]:
        raise AssertionError(f"serve-resnet50-folded launched "
                             f"{res['launches']}")
    # prepared runs of one top-rung batch on each model
    handles = {}
    for tag, d in dirs.items():
        scope = ptt.Scope()
        p, f, t = ptt.io.load_inference_model(d, exe, scope=scope)
        handles[tag] = exe.prepare(p, fetch_list=t, scope=scope)
        handles[tag].run({"image": batch})
    ms = {"unfolded": [], "folded": []}
    calls = {}
    for tag in ("unfolded", "folded", "folded", "unfolded"):
        _, all_ms = _median_ms(torch, lambda: handles[tag].run(
            {"image": batch}), FOLD_BATCHES // 2)
        ms[tag] += all_ms
    for tag, h in handles.items():
        _, calls[tag] = _count_rule_calls(lambda: h.run({"image": batch}))
    res.update(batch_ms=ms, batch_ms_median={k: _median(v)
                                             for k, v in ms.items()},
               rule_calls=calls, handles=handles, batch=batch)
    return res


def run_train_base_memopt(torch, ptt, native):
    """train-base, MEMOPT_STEPS steps with memory_optimize's marks and
    without, from one state (MEMOPT_*)."""
    main, startup, loss = build_train(ptt)
    marked = main.clone()
    ptt.memory_optimize(marked, level=1)
    n_marked = sum(bool(op.attrs.get("__remat__"))
                   for op in marked.global_block().ops)
    exe = ptt.Executor(ptt.CUDAPlace(0))
    s0 = ptt.Scope()
    exe.run(startup, scope=s0)
    state = {n: s0.find_var(n).clone() for n in s0.local_var_names()}
    del s0
    feed = train_batch(MEMOPT_BATCH)
    out = {}
    for tag, prog in (("plain", main), ("marked", marked)):
        scope = ptt.Scope()
        for n, t in state.items():
            scope.set_var(n, t.clone())
        e = ptt.Executor(ptt.CUDAPlace(0))
        native.reset_launches()
        losses = [e.run(prog, feed=feed, fetch_list=[loss], scope=scope)[0]
                  for _ in range(MEMOPT_STEPS)]
        torch.cuda.synchronize()
        out[tag] = {"losses": [float(x) for x in losses],
                    "bits": [x.tobytes() for x in losses],
                    "launches": {k: v for k, v in native.launches.items()
                                 if v}}
    if out["plain"]["bits"] != out["marked"]["bits"]:
        raise AssertionError(f"memory_optimize moved the losses: "
                             f"{out['plain']['losses']} vs "
                             f"{out['marked']['losses']}")
    if out["plain"]["launches"] != out["marked"]["launches"]:
        raise AssertionError(f"memory_optimize moved the launches: "
                             f"{out['plain']['launches']} vs "
                             f"{out['marked']['launches']}")
    return {"marked_ops": n_marked, "losses": out["plain"]["losses"],
            "launches": out["plain"]["launches"]}


# phase 7n: the parallel plane. Transformer-base (TRAIN_BASE, Adam
# TRAIN_LR, float32, batch TRAIN_BATCH) through ParallelExecutor: (a)
# pe-base-1 over the one-rank mesh, PE_STEPS steps, against the Executor
# from the same state in the same call (bit-equal losses, equal launch
# counts a step); then one world of two ranks that share the card (gloo:
# NCCL takes one rank a device), each rank this script run with
# `--pe-rank JOB`, runs (b) pe-base-dp2 (the batch split 16 / 16, dropout
# 0.1), (c) pe-base-sp2 (dropout 0, ring attention: no flash launch) and
# (d) pe-base-mp2 (every `mp`-annotated weight held in halves), each
# PE_RANK_STEPS steps against the Executor's trajectory within
# PE_RTOL / PE_ATOL (the JAX package's parallel tests' tolerance); (e)
# Trainer(parallel=True) against Trainer(parallel=False), PE_TRAINER_STEPS
# steps, bit-equal. The kernels also run at a rank's offsets (bh0, base).
# pe-base-1's steps: 5 (10 until phase 7s came), a rank's: 2 (3 until
# phase 7t came); the gates hold a step
PE_STEPS, PE_RANK_STEPS, PE_TRAINER_STEPS = 5, 2, 3
PE_RTOL, PE_ATOL = 2e-4, 2e-5
PE_RANK_TIMEOUT = 300
PE_CASES = (("pe-base-dp2", "dp", 0.1), ("pe-base-sp2", "sp", 0.0),
            ("pe-base-mp2", "mp", 0.1))
# phase 7p (c)'s two ranks run in this world, after PE_CASES:
# pe-base-dp2 with BuildStrategy.comm_quant "bf16", WIRE_DP2_STEPS steps
WIRE_DP2_STEPS = 5
WIRE_PE_CASES = (("pe-base-wire-dp2", "dp", 0.1, "bf16", WIRE_DP2_STEPS),)
# the planner's H100 profile: one bf16 product at 8192^3 and one copy of
# 2 GiB, each the median of PEAK_ITERS timed calls
PEAK_MATMUL_N, PEAK_COPY_BYTES, PEAK_ITERS = 8192, 2 << 30, 10


def measure_h100_rates(torch):
    """(bf16 matmul FLOP/s at 8192^3, device copy bytes/s counting the
    read and the write), each from the median of PEAK_ITERS calls."""
    def med(fn):
        for _ in range(3):
            fn()
        ts = []
        for _ in range(PEAK_ITERS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) / 1e3)
        return sorted(ts)[len(ts) // 2]
    n = PEAK_MATMUL_N
    x = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    y = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    out = torch.empty(n, n, device="cuda", dtype=torch.bfloat16)
    flops = 2 * n ** 3 / med(lambda: torch.matmul(x, y, out=out))
    del x, y, out
    src = torch.empty(PEAK_COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    bw = 2 * PEAK_COPY_BYTES / med(lambda: dst.copy_(src))
    del src, dst
    torch.cuda.empty_cache()
    return flops, bw


def check_offsets(torch, fa, dk):
    """The kernels at a rank's offsets: rows 16.. of train-base's batch
    (bh0 = 16 H for the flash kernels, base = 16 x 256 x 512 for the
    dropout kernel) give the whole batch's rows bit for bit, in float32
    and bf16, and the float32 flash kernels at bh0 agree with their plain
    versions there (TOL / BWD_TOL)."""
    B, H, T, D, rate, seed = TRAIN_BATCH, 8, 256, 64, 0.1, ATTN_SEED
    half = B // 2
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(B, H, T, D, device="cuda",
                                   generator=g).to(dtype) for _ in range(4))
        for causal in (False, True):
            sm = D ** -0.5
            out, lse = fa._flash_forward(q, k, v, causal, sm, rate, seed)
            delta = fa.flash_delta(out, do)
            full = (out, lse,
                    fa._flash_dq(q, k, v, do, lse, delta, causal, sm, rate,
                                 seed),
                    *fa._flash_dkv(q, k, v, do, lse, delta, causal, sm, rate,
                                   seed))
            hq, hk, hv, hdo, hout, hlse, hdelta = (
                t[half:].contiguous() for t in (q, k, v, do, out, lse, delta))
            bh0 = half * H
            o2, l2 = fa._flash_forward(hq, hk, hv, causal, sm, rate, seed,
                                       bh0)
            part = (o2, l2,
                    fa._flash_dq(hq, hk, hv, hdo, hlse, hdelta, causal, sm,
                                 rate, seed, bh0),
                    *fa._flash_dkv(hq, hk, hv, hdo, hlse, hdelta, causal,
                                   sm, rate, seed, bh0))
            for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), part,
                                  full):
                if not torch.equal(a, b[half:]):
                    raise AssertionError(
                        f"flash {name} {dtype} causal={causal} at bh0 "
                        f"{bh0}: not the whole batch's rows bit for bit")
            tag = f"{str(dtype)[6:]}-{'causal' if causal else 'full'}"
            if dtype == torch.float32:
                ref_o = fa._attention_reference(hq, hk, hv, causal, sm, rate,
                                                seed, bh0)
                ref = fa._flash_backward_reference(hq, hk, hv, hout, hlse,
                                                   hdo, causal, sm, rate,
                                                   seed, bh0)
                errs = {"fwd": float((o2 - ref_o).abs().max())}
                for name, a, b in zip(("dq", "dk", "dv"), part[2:], ref):
                    errs[name] = float(((a - b).abs()
                                        / (1 + b.abs())).max())
                if errs["fwd"] > TOL or max(errs[n] for n in
                                            ("dq", "dk", "dv")) > BWD_TOL:
                    raise AssertionError(f"flash at bh0 {bh0} {tag}: {errs}")
                res[tag] = errs
            else:
                res[tag] = "bit-equal to the whole batch's rows"
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(B, 256, 512, device="cuda", generator=g).to(dtype)
        base = half * 256 * 512
        out, mask = dk.dropout_forward(x, seed, rate, want_mask=True)
        out2, mask2 = dk.dropout_forward(x[half:], seed, rate,
                                         want_mask=True, base=base)
        ref, ref_mask = dk.dropout_reference(x[half:], seed, rate, base)
        if not (torch.equal(out2, out[half:]) and torch.equal(mask2,
                                                              mask[half:])
                and torch.equal(out2, ref) and torch.equal(mask2,
                                                           ref_mask)):
            raise AssertionError(f"dropout {dtype} at base {base}: not the "
                                 f"whole tensor's bits / the plain version's")
        res[f"dropout-{str(dtype)[6:]}"] = "bit-equal"
    return res


def _state_checksum(torch, scope):
    """One float64 number over a scope's tensors: two states equal in
    every element give the same sum, in any process."""
    return float(sum(scope.find_var(n).double().sum().item()
                     for n in sorted(scope.local_var_names())))


def run_pe_base_1(torch, ptt, native, spmd):
    """(a): the Executor and a one-rank ParallelExecutor(use_cuda=True),
    PE_STEPS steps each from one saved state on one batch; also the
    Executor's trajectory at dropout 0 (PE_RANK_STEPS steps) for (c)."""
    import numpy as np
    feed = train_batch(TRAIN_BATCH)
    out = {}
    for dropout in (TRAIN_BASE["dropout_rate"], 0.0):
        main, startup, loss = build_train(ptt, dropout_rate=dropout)
        scope = ptt.Scope()
        ptt.Executor(ptt.CUDAPlace(0)).run(startup, scope=scope)
        saved = {n: scope.find_var(n).clone()
                 for n in scope.local_var_names()}
        out.setdefault("checksum", _state_checksum(torch, scope))
        del scope
        kinds = ("executor", "parallel") if dropout else ("executor",)
        for kind in kinds:
            s = ptt.Scope()
            for n, t in saved.items():
                s.set_var(n, t.clone())
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            if kind == "executor":
                exe = ptt.Executor(ptt.CUDAPlace(0))

                def step():
                    return exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=s)[0]
            else:
                pe = ptt.ParallelExecutor(loss_name=loss.name,
                                          main_program=main, scope=s)

                def step():
                    return pe.run(feed=feed, fetch_list=[loss.name])[0]
            steps = PE_STEPS if dropout else PE_RANK_STEPS
            native.reset_launches()
            spmd.reset_collectives()
            losses, ms = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                v = step()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(np.asarray(v).reshape(-1)[0]))
            tag = kind if dropout else "executor-dropout0"
            last = sorted(ms[1:])
            out[tag] = dict(losses=losses, step_ms=ms,
                            step_ms_median=last[len(last) // 2],
                            launches=dict(native.launches),
                            collectives=dict(spmd.collectives),
                            peak_bytes=torch.cuda.max_memory_allocated())
            if kind == "parallel":
                out[tag]["inventory"] = ptt.parallel.collective_inventory(
                    pe.compiled_text(feed))
                del pe
            else:
                del exe
            del s
        del saved
    gc.collect()
    torch.cuda.empty_cache()
    ex, par = out["executor"], out["parallel"]
    if par["losses"] != ex["losses"]:
        raise AssertionError(f"pe-base-1 losses {par['losses']} are not the "
                             f"Executor's {ex['losses']} bit for bit")
    n_attn = 3 * TRAIN_BASE["n_layer"]
    want = dict.fromkeys(ex["launches"], 0)
    want.update(flash_fwd=2 * n_attn * PE_STEPS,
                flash_dq=n_attn * PE_STEPS, flash_dkv=n_attn * PE_STEPS,
                flash_delta=n_attn * PE_STEPS)
    for tag in ("executor", "parallel"):
        if out[tag]["launches"] != want:
            raise AssertionError(f"pe-base-1 {tag} launches "
                                 f"{out[tag]['launches']}, expected {want}")
    if par["collectives"]:
        raise AssertionError(f"pe-base-1 issued collectives "
                             f"{par['collectives']}")
    return out


def _pe_rank_main(job_path):
    """One rank of phase 7n's world: every case of the job, written to
    ``rank{r}.json`` beside it."""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.ops import native
    from paddle_tpu_torch.parallel import make_mesh, spmd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = json.load(open(job_path))
    distributed.init()              # a card each rank; gloo: they share it
    native.lib()                    # the parent's build, loaded
    rank = distributed.get_rank()
    feed = train_batch(TRAIN_BATCH)
    res = {"backend": distributed.backend(),
           "device": str(distributed.device()), "cases": {}}
    # a case is (name, axis, dropout), or (name, axis, dropout, codec,
    # steps) for BuildStrategy.comm_quant = codec (phase 7p)
    for case in job["cases"]:
        name, axis, dropout = case[:3]
        codec, steps = case[3:] if len(case) > 3 else (None, PE_RANK_STEPS)
        main, startup, loss = build_train(ptt, dropout_rate=dropout)
        scope = ptt.Scope()
        ptt.Executor(ptt.CUDAPlace(0)).run(startup, scope=scope)
        checksum = _state_checksum(torch, scope)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        bs = ptt.BuildStrategy()
        bs.comm_quant = codec
        t0 = time.perf_counter()
        pe = ptt.ParallelExecutor(loss_name=loss.name, main_program=main,
                                  scope=scope, mesh=make_mesh([2], [axis]),
                                  build_strategy=bs)
        bcast_s = time.perf_counter() - t0
        native.reset_launches()
        losses, ms, per_step = [], [], []
        for _ in range(steps):
            spmd.reset_collectives()
            t0 = time.perf_counter()
            v, = pe.run(feed=feed, fetch_list=[loss.name])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(v).reshape(-1)[0]))
            per_step.append({k: {"count": c,
                                 "bytes": spmd.collective_bytes[k]}
                             for k, c in spmd.collectives.items()})
        launches = dict(native.launches)
        colls = {k: {"count": sum(p[k]["count"] for p in per_step),
                     "bytes": sum(p[k]["bytes"] for p in per_step)}
                 for k in per_step[0]}
        halves = {n: [list(pe.state_placement(n)),
                      list(scope.find_var(n).shape)]
                  for n in scope.local_var_names()
                  if n.endswith("_ffn1.w_0")}
        last = sorted(ms[1:])
        text = pe.compiled_text(feed)
        res["cases"][name] = dict(
            losses=losses, step_ms=ms, step_ms_median=last[len(last) // 2],
            launches=launches, collectives=colls,
            collectives_per_step=per_step, checksum=checksum,
            bcast_s=bcast_s, peak_bytes=torch.cuda.max_memory_allocated(),
            ffn1=halves, inventory=ptt.parallel.collective_inventory(text),
            ran_whole=[ln for ln in text.splitlines()
                       if "ran whole" in ln],
            replicated_ops=pe._plan_for(feed, "plan").replicated_ops(),
            comm_quant_ops=sum(op.type == "comm_quant_dequant"
                               for op in main.global_block().ops),
            residuals={n: float(scope.find_var(n).abs().max())
                       for n in scope.local_var_names()
                       if n.endswith("@COMM_RES")})
        del pe, scope
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(os.path.dirname(job_path), f"rank{rank}.json"),
              "w") as f:
        json.dump(res, f)
    distributed.barrier()
    return 0


def _free_endpoints(n):
    """`n` localhost endpoints on ports free a moment ago."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    for sk in socks:
        sk.bind(("127.0.0.1", 0))
    eps = [f"127.0.0.1:{sk.getsockname()[1]}" for sk in socks]
    for sk in socks:
        sk.close()
    return eps


def run_pe_world(torch, tmp, cases=PE_CASES + WIRE_PE_CASES):
    """(b)-(d), and phase 7p's pe-base-wire-dp2: two ranks of this script
    on the card, one world for the cases; a rank's failure fails the
    phase."""
    job = os.path.join(tmp, "pe_job.json")
    with open(job, "w") as f:
        json.dump({"cases": cases}, f)
    eps = ",".join(_free_endpoints(2))
    procs, logs = [], []
    for r in range(2):
        env = dict(os.environ, PADDLE_TRAINER_ID=str(r), PADDLE_TRAINERS="2",
                   PADDLE_TRAINER_ENDPOINTS=eps)
        logs.append(os.path.join(tmp, f"rank{r}.log"))
        with open(logs[-1], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--pe-rank", job],
                env=env, stdout=out, stderr=subprocess.STDOUT))
    # a rank that fails leaves the other waiting in a collective: stop
    # both as soon as one fails, or at the deadline
    deadline = time.perf_counter() + PE_RANK_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) \
                    or time.perf_counter() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(
            f"phase 7n: rank(s) {bad} failed or were stopped:\n" + "\n".join(
                f"--- rank {r} ---\n{open(logs[r]).read()[-4000:]}"
                for r in bad))
    return [json.load(open(os.path.join(tmp, f"rank{r}.json")))
            for r in range(2)]


def check_pe_world(ranks, base1):
    """(b)-(d) against the Executor: every rank's losses within PE_RTOL /
    PE_ATOL of the trajectory at the case's dropout, the same state
    (checksum), flash launches on every rank under dp and mp and none
    under sp, the ring's permutes, the ffn1 weights held in halves."""
    import numpy as np
    n_attn = 3 * TRAIN_BASE["n_layer"]
    for r, res in enumerate(ranks):
        if res["backend"] != "gloo" or res["device"] != "cuda:0":
            raise AssertionError(f"rank {r}: {res['backend']} on "
                                 f"{res['device']}, expected gloo on cuda:0")
        for name, axis, dropout in PE_CASES:
            c = res["cases"][name]
            ref = (base1["executor"] if dropout
                   else base1["executor-dropout0"])["losses"][:PE_RANK_STEPS]
            if c["checksum"] != base1["checksum"]:
                raise AssertionError(f"{name} rank {r}: startup state "
                                     f"checksum {c['checksum']} != "
                                     f"{base1['checksum']}")
            if not np.allclose(c["losses"], ref, rtol=PE_RTOL, atol=PE_ATOL):
                raise AssertionError(f"{name} rank {r}: losses {c['losses']} "
                                     f"vs the Executor's {ref}")
            flash = {k: v for k, v in c["launches"].items()
                     if k.startswith("flash_")}
            if axis == "sp":
                if any(flash.values()):
                    raise AssertionError(f"{name} rank {r}: flash launches "
                                         f"under sp: {flash}")
                if not c["inventory"].get("collective-permute"):
                    raise AssertionError(f"{name}: no ring permute")
            else:
                want = {"flash_fwd": 2 * n_attn * PE_RANK_STEPS,
                        "flash_dq": n_attn * PE_RANK_STEPS,
                        "flash_dkv": n_attn * PE_RANK_STEPS,
                        "flash_delta": n_attn * PE_RANK_STEPS}
                if {k: flash.get(k, 0) for k in want} != want:
                    raise AssertionError(f"{name} rank {r}: flash launches "
                                         f"{flash}, expected {want}")
            if axis == "mp":
                if not c["ffn1"]:
                    raise AssertionError(f"{name}: no _ffn1 weight")
                for n, (pl, shape) in c["ffn1"].items():
                    if pl != [1] or shape[1] * 2 != TRAIN_BASE["d_inner"]:
                        raise AssertionError(
                            f"{name} rank {r}: {n} held at {pl} {shape}, "
                            f"expected half of the columns")


def run_trainer_parallel(torch, ptt, native):
    """(e): Trainer(parallel=True) and Trainer(parallel=False) on the
    card, PE_TRAINER_STEPS steps of train-base from the same seeded
    startup on the same batches: losses bit-equal."""
    import numpy as np
    from paddle_tpu_torch.models import transformer
    feed = train_batch(TRAIN_BATCH)
    rows = [tuple(feed[n][i] for n in ("src_word", "trg_word", "lbl_word"))
            for i in range(TRAIN_BATCH)]

    def reader():
        for _ in range(PE_TRAINER_STEPS):
            yield rows

    def train_func():
        _, fetches = transformer.build(**TRAIN_BASE)
        return fetches["loss"]

    out = {}
    for parallel in (False, True):
        got = []

        def handler(ev, got=got):
            if isinstance(ev, ptt.EndStepEvent):
                got.append(float(np.asarray(ev.metrics[0]).reshape(-1)[0]))
        native.reset_launches()
        t0 = time.perf_counter()
        trainer = ptt.Trainer(train_func,
                              lambda: ptt.optimizer.Adam(
                                  learning_rate=TRAIN_LR),
                              parallel=parallel)
        trainer.train(1, handler, reader=reader,
                      feed_order=["src_word", "trg_word", "lbl_word"])
        torch.cuda.synchronize()
        out["parallel" if parallel else "serial"] = dict(
            losses=got, s=time.perf_counter() - t0,
            launches=dict(native.launches))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    if out["parallel"]["losses"] != out["serial"]["losses"] \
            or len(out["serial"]["losses"]) != PE_TRAINER_STEPS:
        raise AssertionError(f"Trainer(parallel=True) {out['parallel']} vs "
                             f"parallel=False {out['serial']}")
    return out


# phase 7o: the health plane. (a) train-base-observed: train-base
# (TRAIN_BASE, Adam TRAIN_LR, float32, batch TRAIN_BATCH) through
# Trainer(pulse_port=0) with the `observe` flag on, OBS_STEPS steps while
# a Scraper reads /metrics every OBS_SCRAPE_S, then OBS_OFF_STEPS steps
# with the flag off and as many on again (the flag's cost, back to back),
# launches a step equal; (b) one step with the output projection's weight
# set to inf: the non-finite
# detector fires, /healthz answers 503, the alert is in /flight; (c)
# serve-base-pulse: serve-base (SERVE_BASE, 8 requests) through
# InferenceServer(ServeConfig(pulse_port=0)), /readyz 200 while it
# serves, no unexpected plan event, launches as phase 4 counts them; (d)
# a child process (this script, `--flight-child`) under a context from
# `xray.to_wire`: the flight recorder installed, a span around work on
# the card, its chrome trace written, then an allocation past the card's
# memory left unhandled; its dump names the OutOfMemoryError and carries
# the card's live memory, and its trace stitches under the parent's span;
# (e) tools/torch_op_profile.py --measured-check at train-base's widths
# and batch, tools/torch_paddle_plan.py --full-size --devices 1 on the
# card's model
OBS_STEPS, OBS_OFF_STEPS, OBS_SCRAPE_S = 10, 5, 0.5
# the executor hooks' cost a run, where train-base's host spread (tens of
# ms a step) cannot show it: OBS_FLAG_PAIRS pairs of runs of a one-fc
# step on the card (B 32, 64 -> 64, SGD), the flag on in one and off in
# the other, the order alternating from pair to pair
OBS_FLAG_PAIRS = 200
OBS_CHILD_TIMEOUT, OBS_CLI_TIMEOUT = 300, 600


def _http(port, path):
    """(status, body) of GET http://127.0.0.1:port/path."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _median(xs):
    s = sorted(xs)
    return s[len(s) // 2]


def measure_flag_cost(ptt):
    """Median host wall of a prepared run with the `observe` flag on and
    off (OBS_FLAG_PAIRS interleaved pairs); each run fetches its loss."""
    import numpy as np
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data(name="x", shape=[64], dtype="float32")
        loss = ptt.layers.mean(ptt.layers.fc(input=x, size=64))
        ptt.optimizer.SGD(learning_rate=0.01).minimize(loss)
    exe = ptt.Executor(ptt.CUDAPlace(0))
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    prepared = exe.prepare(main, fetch_list=[loss], scope=scope)
    feed = {"x": np.ones((32, 64), np.float32)}
    for _ in range(20):
        prepared.run(feed)
    walls = {True: [], False: []}
    for k in range(OBS_FLAG_PAIRS):
        for flag in ((True, False) if k % 2 else (False, True)):
            ptt.set_flag("observe", flag)
            t0 = time.perf_counter()
            prepared.run(feed)
            walls[flag].append((time.perf_counter() - t0) * 1e6)
    on, off = _median(walls[True]), _median(walls[False])
    return dict(on_us=on, off_us=off, cost_us=on - off,
                on_p25_p75=sorted(walls[True])[OBS_FLAG_PAIRS // 4::
                                                 OBS_FLAG_PAIRS // 2][:2],
                off_p25_p75=sorted(walls[False])[OBS_FLAG_PAIRS // 4::
                                                   OBS_FLAG_PAIRS // 2][:2])


def run_train_base_observed(torch, ptt, native):
    """(a) and (b): returns the numbers; fails on any contract of the
    plane (the /metrics grammar, step and loss counts, live memory, the
    launches with the flag on and off, the alarm)."""
    import numpy as np
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.observe.metrics import parse_prometheus_text
    feed = train_batch(TRAIN_BATCH)
    rows = [tuple(feed[n][i] for n in ("src_word", "trg_word", "lbl_word"))
            for i in range(TRAIN_BATCH)]

    def train_func():
        _, fetches = transformer.build(**TRAIN_BASE)
        return fetches["loss"]

    observe.reset_all()
    ptt.set_flag("observe", True)
    gc.collect()
    torch.cuda.empty_cache()
    trainer = ptt.Trainer(train_func, lambda: ptt.optimizer.Adam(
        learning_rate=TRAIN_LR), pulse_port=0)
    port = trainer.pulse_port
    uid = trainer.train_program._uid

    def segment(steps):
        """`steps` steps; each step's wall (BeginStep to EndStep, whose
        fetched loss is on the host), its loss, and the launches."""
        walls, losses, t = [], [], {}

        def handler(ev):
            if isinstance(ev, ptt.BeginStepEvent):
                t["begin"] = time.perf_counter()
            elif isinstance(ev, ptt.EndStepEvent):
                walls.append((time.perf_counter() - t["begin"]) * 1e3)
                losses.append(float(np.asarray(ev.metrics[0]).reshape(-1)[0]))
        native.reset_launches()
        trainer.train(1, handler, reader=lambda: iter([rows] * steps),
                      feed_order=["src_word", "trg_word", "lbl_word"])
        torch.cuda.synchronize()
        return walls, losses, dict(native.launches)

    scraper = observe.Scraper([("trainer", f"http://127.0.0.1:{port}")],
                              interval_s=OBS_SCRAPE_S).start()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        on_ms, on_losses, on_launches = segment(OBS_STEPS)
        background_rounds = scraper.rounds()
        scraper.poll_once()     # a last read after the last step
    finally:
        scraper.stop()
    code, body = _http(port, "/metrics")
    parsed = parse_prometheus_text(body.decode())
    code_h, health_body = _http(port, "/healthz")
    code_s, status = _http(port, "/status")
    status = json.loads(status)
    max_alloc = torch.cuda.max_memory_allocated()
    steps_total = {",".join(f"{k}={v}" for k, v in sorted(lab.items())):
                   v for _, lab, v in parsed["executor_steps_total"]["samples"]}
    last_loss = parsed["trainer_last_loss"]["samples"][0][2]
    mem = status["memory"]
    shares = {}
    recent = [s for s in observe.get_steplog().recent(OBS_STEPS + 4)
              if s.program_uid == uid]
    for s in recent:
        if "bind" in s.phases:
            continue
        for p, v in s.phases.items():
            shares[p] = shares.get(p, 0.0) + v
    total = sum(shares.values())
    shares = {p: v / total for p, v in shares.items()}
    scraped = scraper.store.latest("executor_steps_total", agg="sum")
    estimate = observe.memory.get_observatory().estimate_peak_bytes()
    # the runs made with the flag on: the startup program's and each step
    want_steps = {"source=executor": 1.0 + OBS_STEPS}
    if code != 200 or steps_total != want_steps:
        raise AssertionError(f"/metrics {code}: executor_steps_total "
                             f"{steps_total}, expected {want_steps}")
    if last_loss != on_losses[-1] or not np.isfinite(on_losses).all():
        raise AssertionError(f"trainer_last_loss {last_loss} against the "
                             f"last loss fetched {on_losses[-1]}")
    if code_h != 200:
        raise AssertionError(f"/healthz {code_h}: {health_body[:2000]}")
    if code_s != 200 or not mem["live"] \
            or not observe.memory.get_observatory().live_available() \
            or mem["peak_bytes_in_use"] != max_alloc:
        raise AssertionError(f"/status memory {mem} against "
                             f"max_memory_allocated {max_alloc}")
    if scraped != 1.0 + OBS_STEPS:
        raise AssertionError(f"the scraper read executor_steps_total "
                             f"{scraped} in {scraper.rounds()} rounds")
    if set(shares) != {"feed_convert", "state_gather", "device_compute",
                       "write_back", "fetch"}:
        raise AssertionError(f"step log phases {shares}")
    unexpected = [e for e in observe.observatory().unexpected()
                  if e.program_uid == uid]
    if unexpected:
        raise AssertionError(f"unexpected plan events {unexpected}")

    # the flag's cost: OBS_OFF_STEPS steps off, then as many on, from the
    # state the steps above left (host speed drifts within a call, so the
    # two are compared back to back)
    ptt.set_flag("observe", False)
    off_ms, off_losses, off_launches = segment(OBS_OFF_STEPS)
    if observe.get_steplog().phase_summary()["steps"] != 1 + OBS_STEPS:
        raise AssertionError("the step log recorded a run with the flag off")
    ptt.set_flag("observe", True)
    on2_ms, on2_losses, on2_launches = segment(OBS_OFF_STEPS)
    n_attn = 3 * TRAIN_BASE["n_layer"]
    per_step = {"flash_fwd": 2 * n_attn, "flash_dq": n_attn,
                "flash_dkv": n_attn, "flash_delta": n_attn}
    for tag, launches, n in (("on", on_launches, OBS_STEPS),
                             ("off", off_launches, OBS_OFF_STEPS),
                             ("on again", on2_launches, OBS_OFF_STEPS)):
        want = dict.fromkeys(launches, 0)
        want.update({k: v * n for k, v in per_step.items()})
        if launches != want:
            raise AssertionError(f"flag {tag}: launches {launches}, "
                                 f"expected {want}")

    # (b) the non-finite alarm
    ptt.set_flag("observe", True)
    block = trainer.train_program.global_block()
    w = [v.name for v in block.vars.values()
         if isinstance(v, ptt.Parameter) and v.name.endswith(".w_0")][-1]
    trainer.scope.find_var(w).fill_(float("inf"))
    _, inf_losses, _ = segment(1)
    code_h2, health2 = _http(port, "/healthz")
    flight_doc = json.loads(_http(port, "/flight")[1])
    alerts = [e for e in flight_doc["events"] if e["kind"] == "alert"]
    if np.isfinite(inf_losses[-1]) or code_h2 != 503 \
            or "non_finite_loss" not in [a.get("rule") for a in alerts]:
        raise AssertionError(f"the non-finite alarm: loss {inf_losses}, "
                             f"/healthz {code_h2} {health2[:2000]}, "
                             f"alerts {alerts}")
    out = dict(
        steps=OBS_STEPS, off_steps=OBS_OFF_STEPS,
        step_ms_on=on_ms, step_ms_off=off_ms, step_ms_on_again=on2_ms,
        step_ms_median_on=_median(on_ms[1:]),
        step_ms_median_off=_median(off_ms[1:]),
        step_ms_median_on_again=_median(on2_ms[1:]),
        losses_on=on_losses, losses_off=off_losses, losses_on_again=on2_losses,
        launches_on=on_launches, launches_off=off_launches,
        launches_on_again=on2_launches,
        phase_shares=shares, phase_summary=observe.get_steplog()
        .phase_summary(), estimate_peak_bytes=estimate,
        peak_bytes=max_alloc, estimate_over_peak=estimate / max_alloc,
        memory_devices=mem.get("devices"),
        scrape_rounds=background_rounds, scraped_steps=scraped,
        executor_steps_total=steps_total, last_loss=last_loss,
        poisoned=w, inf_loss=inf_losses[-1], healthz_after=code_h2,
        alerts=[a.get("rule") for a in alerts],
        families=len(parsed))
    out["on_over_off"] = out["step_ms_median_on_again"] \
        / out["step_ms_median_off"]
    out["flag_cost"] = measure_flag_cost(ptt)
    ptt.set_flag("observe", False)
    observe.reset_all()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_serve_base_pulse(torch, ptt, native, tiny_lm, tmp):
    """(c): serve-base through ServeConfig(pulse_port=0)."""
    from paddle_tpu_torch import observe
    mdir = os.path.join(tmp, "serve_base_pulse")
    sig = tiny_lm.save_tiny_lm(mdir, seed=WEIGHT_SEED, **SERVE_BASE)
    prompts = prompts_for(sig["vocab"])
    observe.reset_all()
    ptt.set_flag("observe", True)
    srv = ptt.serve.InferenceServer(
        ptt.CUDAPlace(0), ptt.serve.ServeConfig(pulse_port=0))
    try:
        port = srv.pulse_port
        srv.add_model("lm", mdir)
        torch.cuda.synchronize()
        before = srv.stats()["models"]["lm"]
        native.reset_launches()
        futs = [srv.submit_generate("lm", p, max_new_tokens=NEW_TOKENS)
                for p in prompts]
        ready_during, body = _http(port, "/readyz")
        results = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        launches = dict(native.launches)
        after = srv.stats()["models"]["lm"]
        ready_after, _ = _http(port, "/readyz")
        checks = sorted(json.loads(body)["checks"])
        events = [(e.cause, e.source) for e in observe.observatory().events()]
        unexpected = observe.observatory().unexpected()
    finally:
        srv.close()
        ptt.set_flag("observe", False)
        observe.reset_all()
    n_layers = sig["n_layers"]
    n_prefill = after["prefill_steps"] - before["prefill_steps"]
    n_decode = after["steps"] - before["steps"]
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd=n_layers * n_prefill,
                paged_decode=n_layers * n_decode)
    if launches != want or n_prefill < 1 or n_decode < 1:
        raise AssertionError(f"serve-base-pulse launches {launches}, "
                             f"expected {want}")
    if ready_during != 200 or ready_after != 200 \
            or not any(c.startswith("serve_queues@") for c in checks):
        raise AssertionError(f"/readyz {ready_during} / {ready_after}: "
                             f"{body[:2000]}")
    if unexpected or ("warmup", "serving") not in events:
        raise AssertionError(f"plan events {events}; unexpected "
                             f"{unexpected}")
    if any(len(r.tokens) != NEW_TOKENS for r in results):
        raise AssertionError("a generation was cut short")
    return dict(launches=launches, prefill_steps=n_prefill,
                decode_steps=n_decode, readyz=[ready_during, ready_after],
                checks=checks, plan_events=events)


def run_flight_stitch(torch, ptt, tmp):
    """(d): a child process's flight dump and chrome trace."""
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.observe import xray
    observe.reset_all()
    prev_name = xray.process_name()
    xray.set_process_name("chip_smoke")
    flight_path = os.path.join(tmp, "child_flight.json")
    child_trace = os.path.join(tmp, "child_trace.json")
    parent_trace = os.path.join(tmp, "parent_trace.json")
    log_path = os.path.join(tmp, "child.log")
    ptt.set_flag("observe", True)
    try:
        with xray.span("chip_smoke:spawn_child", cat="xray") as root:
            wire = json.dumps(xray.to_wire(root))
            with open(log_path, "w") as out:
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__),
                     "--flight-child", wire, child_trace, flight_path],
                    stdout=out, stderr=subprocess.STDOUT,
                    timeout=OBS_CHILD_TIMEOUT)
        observe.get_tracer().export_chrome(parent_trace)
        trace_id = root.trace_id
    finally:
        ptt.set_flag("observe", False)
        xray.set_process_name(prev_name)
    child_log = open(log_path).read()
    if proc.returncode == 0 or "OutOfMemoryError" not in child_log:
        raise AssertionError(f"the child exited {proc.returncode} without "
                             f"the OutOfMemoryError:\n{child_log[-4000:]}")
    dump = json.load(open(flight_path))
    devices = (dump.get("memory") or {}).get("devices") or []
    if "OutOfMemoryError" not in (dump.get("reason") or "") \
            or not devices or devices[0].get("platform") != "gpu" \
            or not devices[0].get("bytes_in_use"):
        raise AssertionError(f"the child's flight dump: reason "
                             f"{dump.get('reason')}, memory "
                             f"{dump.get('memory')}")
    doc, stats = observe.stitch_traces([parent_trace, child_trace])
    tree = observe.trace_tree(doc["traceEvents"], trace_id)
    if stats["edges"] < 1 or stats["orphans"] or len(tree["roots"]) != 1 \
            or len(tree["pids"]) != 2 or tree["orphans"]:
        raise AssertionError(f"stitched trace: {stats}, roots "
                             f"{len(tree['roots'])}, pids {tree['pids']}")
    observe.reset_all()
    return dict(reason=dump["reason"], devices=devices,
                events=len(dump.get("events", [])), edges=stats["edges"],
                orphans=stats["orphans"], skew_us=stats["skew_us"],
                pids=sorted(tree["pids"]), spans=len(tree["spans"]),
                processes=stats["processes"])


def _flight_child_main(wire, trace_path, flight_path):
    """The child of phase 7o (d): under the parent's trace context, a span
    around work on the card, the trace written, then an allocation past
    the card's memory that nothing catches."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import observe
    from paddle_tpu_torch.observe import flight, xray
    ptt.set_flag("observe", True)
    xray.set_process_name("flight-child")
    flight.install(flight_path)
    flight.set_stage("phase 7o (d)")
    parent = xray.from_wire(json.loads(wire))
    with xray.activate(parent):
        with xray.span("flight-child:work", cat="xray"):
            a = torch.randn(4096, 4096, device="cuda")
            (a @ a).sum().item()
    # what /status would read: the live stats the dump serves from
    observe.memory.report()
    observe.get_tracer().export_chrome(trace_path)
    total = torch.cuda.get_device_properties(0).total_memory
    torch.empty(2 * total, dtype=torch.uint8, device="cuda")
    return 0


def _stop(procs):
    for _, _, proc, _, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _note_end(proc, ended):
    proc.wait()
    ended["t"] = time.perf_counter()


def start_clis(runs):
    """Each CLI of `runs` (name -> its arguments to python, from the
    checkout) in its own process, all started at once; their output goes
    to temporary files, and a thread a process notes when it ends. An exit of this
    script before `finish_clis` stops them."""
    import atexit
    here = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    for name, args in runs.items():
        files = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
        proc = subprocess.Popen([sys.executable, *args], cwd=here,
                                stdout=files[0], stderr=files[1])
        ended = {}
        threading.Thread(target=_note_end, args=(proc, ended),
                         daemon=True).start()
        procs[name] = (args, time.perf_counter(), proc, files, ended)
    atexit.register(_stop, procs)
    return procs


def finish_clis(procs, want, timeout):
    """Wait for `start_clis`' processes, each within `timeout` s of its
    start; fail unless each exits with `want[name]`. Returns, a CLI, its
    exit code, seconds from its start to its end and output's tails, and
    `waited_s`, the seconds spent here."""
    out, t_wait = {}, time.perf_counter()
    try:
        for name, (args, t0, proc, files, ended) in procs.items():
            try:
                proc.wait(timeout=max(
                    1.0, t0 + timeout - time.perf_counter()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{' '.join(args)} ran past "
                                     f"{timeout} s")
            text = []
            for f in files:
                f.seek(0)
                text.append(f.read())
                f.close()
            while "t" not in ended:
                time.sleep(0.01)
            out[name] = dict(rc=proc.returncode, s=ended["t"] - t0,
                             stdout=text[0][-6000:], stderr=text[1][-3000:])
    finally:
        _stop(procs)
    for name, rc in want.items():
        if out[name]["rc"] != rc:
            raise AssertionError(f"{' '.join(procs[name][0])} exited "
                                 f"{out[name]['rc']}, expected {rc}:\n"
                                 f"{out[name]['stdout'][-3000:]}\n"
                                 f"{out[name]['stderr']}")
    out["waited_s"] = time.perf_counter() - t_wait
    return out


def run_observe_clis(torch):
    """(e): the two CLIs on the card, each in its own process, the two at
    once."""
    gc.collect()
    torch.cuda.empty_cache()
    out = finish_clis(start_clis({
        "op_profile": ["tools/torch_op_profile.py", "--model",
                       "transformer", "--full-size", "--batch",
                       str(TRAIN_BATCH), "--steps", "2", "--measured-check",
                       "--topk", "5"],
        "paddle_plan": ["tools/torch_paddle_plan.py", "--model",
                        "transformer", "--full-size", "--devices", "1"]}),
        {"op_profile": 0, "paddle_plan": 0}, OBS_CLI_TIMEOUT)
    check = [ln for ln in out["op_profile"]["stderr"].splitlines()
             if ln.startswith("measured-check:")]
    if not check or "OK" not in check[0]:
        raise AssertionError(f"op_profile: {out['op_profile']['stderr']}")
    out["op_profile"]["check"] = check[0]
    if "hw=h100-sxm-80gb" not in out["paddle_plan"]["stdout"] \
            or "PLAN:" not in out["paddle_plan"]["stdout"]:
        raise AssertionError(f"paddle_plan: {out['paddle_plan']['stdout']}")
    out["paddle_plan"]["plan"] = [
        ln for ln in out["paddle_plan"]["stdout"].splitlines()
        if ln.startswith(("model=", "PLAN:"))]
    return out


# phase 7p: the wire plane. (a) train-base-wire-int8: train-base
# (TRAIN_BASE, Adam TRAIN_LR, float32, batch TRAIN_BATCH) from one saved
# startup state (io.state_from_numpy), WIRE_STEPS steps on the fixed batch
# unquantized and WIRE_STEPS through a second build transpiled by
# DistributeTranspiler with comm_quant "int8" (its startup zero-inits the
# residuals; the saved state is loaded over the rest), their steps in
# turn, the observe flag on; then one traced step of it; (b) one more
# step fetches every gradient the quantizer reads, and the host codec
# encodes each (int8 at WIRE_CHUNK, bf16); (c) pe-base-1 with
# BuildStrategy.comm_quant "int8" against the Executor on the same
# rewritten Program, WIRE_PE1_STEPS steps each (pe-base-wire-dp2 runs in
# phase 7n's world: WIRE_PE_CASES); (d) the observe CLIs (WIRE_CLIS),
# started after phase 7o (a) and read at this phase's end
WIRE_STEPS, WIRE_PE1_STEPS, WIRE_CHUNK = 10, 3, 2048
# tests/test_wire.py:591, the JAX tests' band of a quantized run around
# the unquantized one: |q - ref| <= WIRE_BAND[0] |ref[0]| + WIRE_BAND[1]
WIRE_BAND = (0.1, 0.05)
WIRE_CLI_TIMEOUT = 600
WIRE_CLIS = {"telemetry_dump": ["tools/torch_telemetry_dump.py",
                                "--assert-no-recompiles"],
             "telemetry_dump_two_shapes": ["tools/torch_telemetry_dump.py",
                                           "--assert-no-recompiles",
                                           "--two-shapes"],
             "step_profile": ["tools/torch_step_profile.py", "--top", "40"]}


def _wire_band(ref, q):
    """The largest |q[i] - ref[i]| over the steps both ran, and the band."""
    dev = max(abs(a - b) for a, b in zip(q, ref))
    return dev, WIRE_BAND[0] * abs(ref[0]) + WIRE_BAND[1]


def _traced_op(torch, fn, op_type):
    """Run `fn` once under torch.profiler with every `op_type` op inside a
    `record_function`: the ops' count, their device and host time, and the
    step's device busy time (the union of its kernel, copy and set
    intervals, `tools/torch_serve_profile.py::device_breakdown`), in µs."""
    from paddle_tpu_torch.core import lowering
    from tools.torch_serve_profile import device_breakdown
    run_op = lowering._run_op

    def op_(op, *a, **k):
        if op.type != op_type:
            return run_op(op, *a, **k)
        with torch.profiler.record_function("op::" + op_type):
            return run_op(op, *a, **k)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    lowering._run_op = op_
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        lowering._run_op = run_op
    out = dict(wall_ms=wall * 1e3, count=0, device_us=0.0, host_us=0.0)
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        dev = e.cuda_time_total if dev is None else dev
        if e.key == "op::" + op_type and e.cpu_time_total > 0:
            out.update(count=e.count, device_us=dev,
                       host_us=e.cpu_time_total)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        busy = device_breakdown(path, wall)
    out.update(step_busy_us=busy["busy_us"], busy_share=busy["busy_share"])
    return out


def run_train_base_wire(torch, ptt, native):
    """(a): returns the numbers and, for (b), the quantized run's handles;
    fails on any contract (the op count, the verified Program, the
    residuals, the band, the launches, an unexpected plan build). The
    two runs take their steps in turn, each on its own scope, so the
    host's drift within the call falls on both medians alike."""
    import numpy as np
    from paddle_tpu_torch import observe
    feed = train_batch(TRAIN_BATCH)
    place = ptt.CUDAPlace(0)
    exe = ptt.Executor(place)
    main, startup, loss = build_train(ptt)
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    checksum = _state_checksum(torch, scope)
    state = {n: scope.find_var(n).cpu().numpy()
             for n in scope.local_var_names()}
    del scope
    n_attn = 3 * TRAIN_BASE["n_layer"]
    per_step = {"flash_fwd": 2 * n_attn, "flash_dq": n_attn,
                "flash_dkv": n_attn, "flash_delta": n_attn}
    main_q, startup_q, loss_q = build_train(ptt)
    cfg = ptt.DistributeTranspilerConfig()
    cfg.comm_quant = "int8"
    t = ptt.DistributeTranspiler(cfg)
    t.transpile(0, program=main_q, trainers=1, sync_mode=True,
                startup_program=startup_q)
    prog = t.get_trainer_program()       # verified (analysis/)
    ops = [op.type for op in prog.global_block().ops]
    n_adam, n_q = ops.count("adam"), ops.count("comm_quant_dequant")
    if not n_q or n_q != n_adam or loss_q.name != loss.name:
        raise AssertionError(f"{n_q} comm_quant_dequant for {n_adam} Adam "
                             f"ops")
    if any(ops[i + 1] != "adam" for i, o in enumerate(ops)
           if o == "comm_quant_dequant"):
        raise AssertionError("a comm_quant_dequant not just before its "
                             "Adam op")
    sq = ptt.Scope()
    exe.run(startup_q, scope=sq)
    res_names = sorted(n for n in sq.local_var_names()
                       if n.endswith("@COMM_RES"))
    if len(res_names) != n_q or any(bool(sq.find_var(n).any())
                                    for n in res_names):
        raise AssertionError(f"{len(res_names)} residuals after the "
                             f"startup, not {n_q} zero ones")
    ptt.io.state_from_numpy(state, place, sq)
    if _state_checksum(torch, sq) != checksum:
        raise AssertionError("the quantized run's state is not the "
                             "unquantized run's")
    runs = {"ref": dict(prepared=exe.prepare(
                main, fetch_list=[loss],
                scope=ptt.io.state_from_numpy(state, place))),
            "q": dict(prepared=exe.prepare(prog, fetch_list=[loss],
                                           scope=sq))}
    for r in runs.values():
        r.update(losses=[], ms=[], launches={})
    moved = 0
    observe.reset_all()
    ptt.set_flag("observe", True)
    gc.collect()
    torch.cuda.synchronize()
    try:
        for i in range(WIRE_STEPS):
            for r in runs.values():
                before = dict(native.launches)
                t0 = time.perf_counter()
                v = r["prepared"].run(feed)[0]
                torch.cuda.synchronize()
                r["ms"].append((time.perf_counter() - t0) * 1e3)
                r["losses"].append(float(np.asarray(v).reshape(-1)[0]))
                for k, n in native.launches.items():
                    r["launches"][k] = r["launches"].get(k, 0) + n \
                        - before.get(k, 0)
            if i == 0:
                moved = sum(bool(sq.find_var(n).abs().max() > 0)
                            for n in res_names)
        unexpected = [e for e in observe.observatory().unexpected()
                      if e.program_uid in (main._uid, prog._uid)]
        causes = [e.cause for e in observe.observatory().events()
                  if e.program_uid in (main._uid, prog._uid)]
    finally:
        ptt.set_flag("observe", False)
        observe.reset_all()
    for tag, r in runs.items():
        want = dict.fromkeys(r["launches"], 0)
        want.update({k: v * WIRE_STEPS for k, v in per_step.items()})
        if r["launches"] != want:
            raise AssertionError(f"train-base-wire {tag} launches "
                                 f"{r['launches']}, expected {want}")
    if unexpected:
        raise AssertionError(f"unexpected plan builds {unexpected}")
    if not moved:
        raise AssertionError("no residual moved after the first step")
    ref, q = runs["ref"]["losses"], runs["q"]["losses"]
    dev, band = _wire_band(ref, q)
    if not (np.isfinite(q).all() and q[-1] < q[0]
            and abs(q[-1] - ref[-1]) <= band):
        raise AssertionError(f"train-base-wire-int8 losses {q} against the "
                             f"unquantized {ref} (band {band})")
    del runs["ref"]["prepared"]
    prepared_q = runs["q"].pop("prepared")
    gc.collect()
    torch.cuda.empty_cache()
    traced = _traced_op(torch, lambda: prepared_q.run(feed),
                        "comm_quant_dequant")
    if traced["count"] != n_q:
        raise AssertionError(f"traced {traced['count']} comm_quant_dequant "
                             f"ranges, expected {n_q}")
    res_bytes = sum(sq.find_var(n).numel() * sq.find_var(n).element_size()
                    for n in res_names)
    param_bytes = sum(
        sq.find_var(n).numel() * sq.find_var(n).element_size()
        for n, v in prog.global_block().vars.items()
        if isinstance(v, ptt.Parameter))
    ref_ms, q_ms = runs["ref"]["ms"], runs["q"]["ms"]
    return dict(
        steps=WIRE_STEPS, ref_losses=ref, losses=q, ref_step_ms=ref_ms,
        step_ms=q_ms, ref_step_ms_median=_median(ref_ms[1:]),
        step_ms_median=_median(q_ms[1:]),
        ref_launches=runs["ref"]["launches"],
        launches=runs["q"]["launches"], n_comm_quant=n_q, n_adam=n_adam,
        residuals_moved_after_step1=moved, residual_bytes=res_bytes,
        param_bytes=param_bytes, band=band, last_dev=abs(q[-1] - ref[-1]),
        max_dev=dev, plan_causes=causes, traced=traced, checksum=checksum,
        handles=dict(exe=exe, prog=prog, scope=sq, feed=feed,
                     grads=[op.input("Grad")[0]
                            for op in prog.global_block().ops
                            if op.type == "comm_quant_dequant"]))


def run_wire_codec(torch, ptt, handles):
    """(b): one step's gradients through the host codec."""
    import numpy as np
    from paddle_tpu_torch import wire
    exe, prog, scope = handles["exe"], handles["prog"], handles["scope"]
    grads = exe.run(prog, feed=handles["feed"], fetch_list=handles["grads"],
                    scope=scope)
    raw = sum(g.nbytes for g in grads)
    out = {"tensors": len(grads), "elements": sum(g.size for g in grads),
           "raw_bytes": raw}
    for codec in ("int8", "bf16"):
        t0 = time.perf_counter()
        enc, worst = 0, 0.0
        for name, g in zip(handles["grads"], grads):
            payload, deq = wire.encode_with_dequant(g, codec, name=name,
                                                    chunk=WIRE_CHUNK)
            if wire.decode_tensor(payload).tobytes() != deq.tobytes():
                raise AssertionError(f"{codec} {name}: decode_tensor is not "
                                     f"the returned dequant bit for bit")
            err = np.abs(g - deq).ravel()
            if codec == "int8":
                n = g.size
                half = np.repeat(payload["scale"], WIRE_CHUNK)[:n] * 0.5
                # to float32 rounding: the quotient x / scale and the
                # product q scale each round, by at most 127 2^-24 of the
                # scale
                bound = half * np.float32(1.0 + 2.0 ** -15)
            else:
                # half a bf16 ulp: 2^-8 of |x| for a normal x, half the
                # least bf16 subnormal (2^-134) below
                half = np.abs(g).ravel() * np.float32(2.0 ** -8)
                bound = half + np.float32(2.0 ** -134)
            if (err > bound).any():
                i = int(np.argmax(err - bound))
                raise AssertionError(f"{codec} {name}: element {i} off by "
                                     f"{err[i]}, past {bound[i]}")
            share = err[half > 0] / half[half > 0]
            worst = max(worst, float(share.max()) if share.size else 0.0)
            enc += wire.payload_nbytes(payload)
        out[codec] = dict(encoded_bytes=enc,
                          ratio=wire.compression_ratio(raw, enc),
                          max_err_over_half_quantum=worst,
                          s=time.perf_counter() - t0)
    return out


def run_pe_base_wire_1(torch, ptt, native):
    """(c), one rank: ParallelExecutor(build_strategy.comm_quant="int8")
    over the one-rank mesh and the Executor on the Program it rewrote,
    WIRE_PE1_STEPS steps each from one saved state."""
    import numpy as np
    feed = train_batch(TRAIN_BATCH)
    main, startup, loss = build_train(ptt)
    scope = ptt.Scope()
    ptt.Executor(ptt.CUDAPlace(0)).run(startup, scope=scope)
    saved = {n: scope.find_var(n).clone() for n in scope.local_var_names()}
    bs = ptt.BuildStrategy()
    bs.comm_quant = "int8"
    pe = ptt.ParallelExecutor(loss_name=loss.name, main_program=main,
                              scope=scope, build_strategy=bs)
    n_q = sum(op.type == "comm_quant_dequant"
              for op in main.global_block().ops)
    res_shapes = {n: scope.find_var(n).shape for n in scope.local_var_names()
                  if n.endswith("@COMM_RES")}
    out = {}
    for kind in ("parallel", "executor"):
        if kind == "executor":
            del pe
            scope = ptt.Scope()
            for n, t in saved.items():
                scope.set_var(n, t.clone())
            for n, shape in res_shapes.items():
                scope.set_var(n, torch.zeros(shape, device="cuda"))
            exe = ptt.Executor(ptt.CUDAPlace(0))

            def step():
                return exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope)[0]
        else:
            def step():
                return pe.run(feed=feed, fetch_list=[loss.name])[0]
        native.reset_launches()
        losses = [float(np.asarray(step()).reshape(-1)[0])
                  for _ in range(WIRE_PE1_STEPS)]
        torch.cuda.synchronize()
        out[kind] = dict(losses=losses, launches=dict(native.launches))
    del scope, saved
    gc.collect()
    torch.cuda.empty_cache()
    if out["parallel"] != out["executor"] or not n_q \
            or len(res_shapes) != n_q:
        raise AssertionError(f"pe-base-wire-1 {out['parallel']} against the "
                             f"Executor's {out['executor']} ({n_q} ops, "
                             f"{len(res_shapes)} residuals)")
    out["n_comm_quant"] = n_q
    return out


def check_pe_wire(ranks, wire_a):
    """(c), two ranks: pe-base-wire-dp2's losses in the band of (a)'s
    unquantized run from the same state, its collectives a step those of
    pe-base-dp2, the op run whole, the launches a step train-base's."""
    import numpy as np
    n_attn = 3 * TRAIN_BASE["n_layer"]
    out = []
    for r, res in enumerate(ranks):
        for name, _, _, codec, steps in WIRE_PE_CASES:
            c, dp2 = res["cases"][name], res["cases"]["pe-base-dp2"]
            if c["checksum"] != wire_a["checksum"]:
                raise AssertionError(f"{name} rank {r}: startup checksum "
                                     f"{c['checksum']} != (a)'s")
            dev, band = _wire_band(wire_a["ref_losses"], c["losses"])
            if not np.isfinite(c["losses"]).all() or dev > band:
                raise AssertionError(f"{name} rank {r}: losses {c['losses']} "
                                     f"off (a)'s unquantized "
                                     f"{wire_a['ref_losses'][:steps]} by "
                                     f"{dev} (band {band})")
            per = c["collectives_per_step"]
            if any(p != per[0] for p in per) or {
                    k: {"count": v["count"] * PE_RANK_STEPS,
                        "bytes": v["bytes"] * PE_RANK_STEPS}
                    for k, v in per[0].items()} != dp2["collectives"]:
                raise AssertionError(f"{name} rank {r}: collectives a step "
                                     f"{per} against pe-base-dp2's "
                                     f"{dp2['collectives']} over "
                                     f"{PE_RANK_STEPS} steps")
            n_q = c["comm_quant_ops"]
            if not n_q or c["replicated_ops"].get("comm_quant_dequant") \
                    != n_q or not any("comm_quant_dequant" in ln
                                      for ln in c["ran_whole"]):
                raise AssertionError(f"{name} rank {r}: {n_q} ops, run whole "
                                     f"{c['replicated_ops']}")
            if len(c["residuals"]) != n_q \
                    or not max(c["residuals"].values()) > 0:
                raise AssertionError(f"{name} rank {r}: residuals "
                                     f"{len(c['residuals'])}")
            want = {"flash_fwd": 2 * n_attn * steps,
                    "flash_dq": n_attn * steps, "flash_dkv": n_attn * steps,
                    "flash_delta": n_attn * steps}
            if {k: c["launches"].get(k, 0) for k in want} != want:
                raise AssertionError(f"{name} rank {r}: launches "
                                     f"{c['launches']}, expected {want}")
            out.append(dict(rank=r, codec=codec, losses=c["losses"],
                            max_dev=dev, band=band,
                            step_ms_median=c["step_ms_median"],
                            dp2_step_ms_median=dp2["step_ms_median"],
                            collectives_per_step=per[0],
                            ran_whole=c["ran_whole"], n_comm_quant=n_q))
    return out


def finish_wire_clis(procs):
    """(d): wait for the CLIs (`finish_clis`) and hold their output: the
    dump's OK, the two-shape run's `feed_shape` cause, the three flash
    kernels among the profile's top device ops."""
    out = finish_clis(procs, {"telemetry_dump": 0,
                              "telemetry_dump_two_shapes": 1,
                              "step_profile": 0}, WIRE_CLI_TIMEOUT)
    if "OK" not in out["telemetry_dump"]["stderr"]:
        raise AssertionError(out["telemetry_dump"]["stderr"])
    causes = [ln for ln in out["telemetry_dump_two_shapes"][
        "stderr"].splitlines() if "cause(s):" in ln]
    if not causes or not causes[0].rstrip().endswith("feed_shape"):
        raise AssertionError(out["telemetry_dump_two_shapes"]["stderr"])
    out["telemetry_dump_two_shapes"]["causes"] = causes[0]
    lines = out["step_profile"]["stdout"].splitlines()
    start = next((i for i, ln in enumerate(lines)
                  if ln.startswith("top ") and "self CUDA" in ln), None)
    if start is None:
        raise AssertionError(f"step_profile: no device table:\n"
                             f"{out['step_profile']['stdout'][-3000:]}")
    top = [ln for ln in lines[start + 2:] if not ln.startswith("TOTAL")]
    found = {k: next((ln.strip() for ln in top if k + "_" in ln), None)
             for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    if not all(found.values()):
        raise AssertionError(f"step_profile's top device ops lack "
                             f"{[k for k, v in found.items() if not v]}:\n"
                             + "\n".join(top))
    out["step_profile"]["flash_rows"] = found
    out["step_profile"]["top"] = top[:10]
    return out


# phase 7q: the parameter-server plane (``pserver/``, ``haven/``,
# ``ark/``). (a) train-base-ps-sync: train-base (TRAIN_BASE, Adam
# TRAIN_LR, float32) through DistributeTranspiler(runtime="pserver") on
# two pserver processes (this script's `--pserver-child`, which runs
# `Executor(CPUPlace()).run(get_pserver_program(ep))`), PS_TRAINERS
# SyncPSTrainers in threads of this process, each on CUDAPlace(0) with
# its half of TRAIN_BATCH: PS_PARITY_STEPS steps at dropout 0 against the
# Executor at TRAIN_BATCH from one saved state, then, on two more
# pservers, PS_TIMED_STEPS from that state at TRAIN_BASE's dropout; (b)
# the same timed steps with comm_quant "int8" on a third pair, the two
# jobs' steps in turn; (c) train-deepfm-ps-async:
# DeepFM (`build(distributed=True)` at its defaults, Adagrad
# PS_DEEPFM_LR, batch DEEPFM_BATCH, `_ctr_batch`'s clicks) through
# AsyncPSTrainer against (a)'s two pservers,
# PS_DEEPFM_STEPS steps; (d) train-deepfm-ps-haven: the same job with
# one shard a primary/backup pair in this process (lease
# PS_HAVEN_LEASE_S, tools/haven_bench.py's), the primary killed by
# `ark.chaos.kill_server` after PS_HAVEN_KILL_AT of PS_HAVEN_STEPS steps
PS_TRAINERS = 2
# one parity step (two until phase 7s came): its losses, pulled
# parameters and launches keep every gate of the comparison
PS_PARITY_STEPS, PS_TIMED_STEPS = 1, 3
# the pulled parameters against the servers' rule replayed on the host
# (the Executor's grads on each trainer's rows, averaged, under the
# servers' numpy Adam): relative L2 a parameter. Against the Executor's
# own parameters (its in-graph `adam` op, which places epsilon
# elsewhere, and the whole batch's sums, where Adam turns a sign that
# rounds the other way into a whole step) the relative L2 and
# tests/test_pserver.py:250,254's element-wise rtol / atol are printed
PS_PARAM_RTOL = 1e-4
PS_ELEM_RTOL, PS_ELEM_ATOL = 1e-4, 1e-5
PS_DEEPFM_STEPS, PS_DEEPFM_LR = 20, 0.003
PS_HAVEN_STEPS, PS_HAVEN_KILL_AT, PS_HAVEN_LEASE_S = 24, 10, 1.0
PS_CHILD_TIMEOUT = 300


def _pserver_child_main(endpoint, endpoints, trainers):
    """A pserver process of phase 7q: train-base's pserver Program for
    `endpoint`, served by `Executor(CPUPlace()).run` until a client stops
    it; then one JSON line: what run returned and whether this process
    initialized CUDA (it must not: a server is numpy)."""
    import torch
    import paddle_tpu_torch as ptt
    main, startup, _ = build_train(ptt)
    cfg = ptt.DistributeTranspilerConfig()
    cfg.runtime = "pserver"
    t = ptt.DistributeTranspiler(cfg)
    t.transpile(0, program=main, pservers=endpoints, trainers=int(trainers),
                sync_mode=True, startup_program=startup)
    served = ptt.Executor(ptt.CPUPlace()).run(t.get_pserver_program(endpoint))
    print(json.dumps({"endpoint": endpoint, "served": served,
                      "cuda_initialized": torch.cuda.is_initialized()}),
          flush=True)
    return 0


def start_pservers(n, trainers, tmp, tag):
    """`n` pserver processes on free localhost ports: (endpoints, procs,
    log path stems: `.out` gets the JSON line, `.err` the rest)."""
    eps = _free_endpoints(n)
    procs, logs = [], []
    for i, ep in enumerate(eps):
        logs.append(os.path.join(tmp, f"pserver_{tag}{i}"))
        with open(logs[-1] + ".out", "w") as out, \
                open(logs[-1] + ".err", "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--pserver-child",
                 ep, ",".join(eps), str(trainers)], stdout=out, stderr=err))
    return eps, procs, logs


def wait_pservers(eps, procs, logs, timeout=PS_CHILD_TIMEOUT):
    import socket
    deadline = time.perf_counter() + timeout
    for ep, p, path in zip(eps, procs, logs):
        host, port = ep.rsplit(":", 1)
        while True:
            try:
                socket.create_connection((host, int(port)), timeout=1).close()
                break
            except OSError:
                if p.poll() is not None or time.perf_counter() > deadline:
                    raise AssertionError(
                        f"pserver {ep} never served (exit {p.poll()}):\n"
                        f"{open(path + '.err').read()[-3000:]}")
                time.sleep(0.1)


def stop_pservers(ptt, eps, procs, logs):
    """Stop the pservers over the wire; each must exit 0 with run's []
    and CUDA never initialized."""
    c = ptt.pserver.PSClient(eps)
    c.stop_all()
    c.close()
    out = []
    for ep, p, path in zip(eps, procs, logs):
        p.wait(timeout=120)
        recs = [json.loads(ln) for ln in open(path + ".out")
                if ln.startswith("{")]
        if p.returncode != 0 or not recs or recs[-1]["served"] != [] \
                or recs[-1]["cuda_initialized"] is not False:
            raise AssertionError(f"pserver {ep}: exit {p.returncode}, "
                                 f"{recs[-1:]}:\n"
                                 f"{open(path + '.err').read()[-3000:]}")
        out.append(recs[-1])
    return out


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _instrument(torch, tr, device):
    """Time one trainer's step by phase, wrapping its client's calls and
    its executor: `pull` (`_recv_dense`: the RPC `pull_rpc` plus the
    copies into the scope's card tensors), `step` (the Executor's run,
    to the card's last kernel), `fetch` (every fetched tensor to host
    numpy), `push` / `barrier_apply` (sync), `prefetch` / `push_sparse`
    (async tables); and the wire's bytes by command (`_call_one`'s sent
    and received frames). `close()` ends a step and returns its record."""
    from paddle_tpu_torch.core.executor import to_numpy
    cur = {"bytes": {}}

    def timed(obj, attr, name):
        orig = getattr(obj, attr)

        def w(*a, **k):
            t0 = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                cur[name] = cur.get(name, 0.0) + time.perf_counter() - t0
        setattr(obj, attr, w)

    c = tr.client
    for attr, name in (("get_params_parallel", "pull_rpc"),
                       ("push_grads_sync", "push"),
                       ("push_grads_parallel", "push"),
                       ("sync_apply", "barrier_apply"),
                       ("prefetch_rows", "prefetch"),
                       ("push_sparse_grad", "push_sparse")):
        timed(c, attr, name)
    timed(tr, "_recv_dense", "pull")
    call_one = c._call_one

    def counted(endpoint, cmd, *a, **k):
        reply, tx, rx = call_one(endpoint, cmd, *a, **k)
        cur["bytes"][cmd] = cur["bytes"].get(cmd, 0) + tx + rx
        return reply, tx, rx
    c._call_one = counted
    exe = tr.exe

    class _TimedExe:
        def run(self, program, feed=None, fetch_list=None, scope=None):
            t0 = time.perf_counter()
            outs = exe.run(program, feed=feed, fetch_list=fetch_list,
                           scope=scope, return_numpy=False)
            if device.type == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            host = [to_numpy(o) for o in outs]
            cur["step"] = cur.get("step", 0.0) + t1 - t0
            cur["fetch"] = cur.get("fetch", 0.0) + time.perf_counter() - t1
            return host
    tr.exe = _TimedExe()

    def close():
        rec = {k: (v * 1e3 if k != "bytes" else v) for k, v in cur.items()}
        if "pull" in rec:
            rec["h2d"] = rec["pull"] - rec.get("pull_rpc", 0.0)
        cur.clear()
        cur["bytes"] = {}
        return rec
    return close


def _ps_sync_trainers(ptt, eps, state, place, dropout, clocks,
                      comm_quant=None):
    """PS_TRAINERS SyncPSTrainers of train-base on `eps`, each with its
    own Executor and a scope on `place` holding what its Program reads
    from `state` and the learning rates its servers take (the Adam slots
    live on the servers)."""
    import torch
    from paddle_tpu_torch.pserver import SyncPSTrainer
    out = []
    for tid in range(PS_TRAINERS):
        main, startup, loss = build_train(ptt, dropout_rate=dropout)
        cfg = ptt.DistributeTranspilerConfig()
        cfg.runtime = "pserver"
        cfg.comm_quant = comm_quant
        t = ptt.DistributeTranspiler(cfg)
        t.transpile(tid, program=main, pservers=",".join(eps),
                    trainers=PS_TRAINERS, sync_mode=True,
                    startup_program=startup)
        ops = t.get_trainer_program().global_block().ops
        if any(op.type == "adam" for op in ops) or not t.param_specs:
            raise AssertionError(f"train-base-ps trainer program: "
                                 f"{[op.type for op in ops].count('adam')} "
                                 f"adam ops, {len(t.param_specs)} "
                                 f"parameters on the servers")
        reads = {n for op in ops for n in op.input_arg_names} | {
            spec["lr_name"] for spec in t.param_specs.values()}
        tr = SyncPSTrainer(t, ptt.Executor(place),
                           scope=ptt.io.state_from_numpy(
                               {n: v for n, v in state.items()
                                if n in reads}, place))
        clocks.append(_instrument(torch, tr, place.torch_device()))
        tr.init_params()
        out.append((tr, loss))
    return out


def _ps_sync_step(trainers, feed):
    """One sync step: every trainer on its rows of `feed`, in threads;
    (the trainers' losses, the step's wall ms)."""
    import numpy as np
    n = len(trainers)
    rows = len(next(iter(feed.values()))) // n
    losses, errs = [None] * n, []

    def one(i):
        tr, loss = trainers[i]
        try:
            v, = tr.step({k: a[i * rows:(i + 1) * rows]
                          for k, a in feed.items()}, fetch_list=[loss])
            losses[i] = float(np.asarray(v).reshape(-1)[0])
        except BaseException as e:          # noqa: BLE001
            errs.append(f"trainer {i}: {e!r}")
    ths = [threading.Thread(target=one, args=(i,), daemon=True)
           for i in range(n)]
    t0 = time.perf_counter()
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=900)
    ms = (time.perf_counter() - t0) * 1e3
    if errs or any(th.is_alive() for th in ths):
        raise AssertionError(f"train-base-ps step: {errs or 'hung'}")
    return losses, ms


def _pulled(trainer):
    t = trainer.t
    by_ep = {}
    for p, spec in t.param_specs.items():
        by_ep.setdefault(spec["endpoint"], []).append(p)
    out = {}
    for vals in trainer.client.get_params_parallel(by_ep).values():
        out.update(vals)
    return out


def run_train_base_ps(torch, ptt, native, pairs, place=None,
                      ready=lambda: None):
    """(a) on the pservers `pairs["parity"]`, then (a)'s timed steps and
    (b) on `pairs["raw"]` and `pairs["int8"]` from the startup state, in
    turn (`ready()` returns once every pserver serves); fails on any
    gate. Returns the numbers."""
    import numpy as np
    from paddle_tpu_torch.core.executor import to_numpy
    from paddle_tpu_torch.pserver import optim as ps_optim
    place = place or ptt.CUDAPlace(0)
    dev = place.torch_device()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    exe = ptt.Executor(place)
    walls = {}
    t_sub = time.perf_counter()
    main, startup, loss = build_train(ptt, dropout_rate=0.0)
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    state = {n: to_numpy(scope.find_var(n)).copy()
             for n in scope.local_var_names()}
    del scope
    feed = train_batch(TRAIN_BATCH)
    n_attn = 3 * TRAIN_BASE["n_layer"]
    per_step = {"flash_fwd": 2 * n_attn, "flash_dq": n_attn,
                "flash_dkv": n_attn, "flash_delta": n_attn}
    # the Executor at the whole batch, its in-graph Adam
    ref_scope = ptt.io.state_from_numpy(state, place)
    ref_losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=ref_scope)[0])
                  for _ in range(PS_PARITY_STEPS)]
    graph = {n: to_numpy(ref_scope.find_var(n)) for n in state}
    del ref_scope
    # the servers' rule replayed on the host: the Executor's grads on
    # each trainer's rows, summed and averaged as a server averages its
    # pending grads, under the servers' numpy Adam
    m2, s2, _ = build_train(ptt, dropout_rate=0.0)
    cfg = ptt.DistributeTranspilerConfig()
    cfg.runtime = "pserver"
    t2 = ptt.DistributeTranspiler(cfg)
    t2.transpile(0, program=m2, pservers=",".join(pairs["parity"]),
                 trainers=1, sync_mode=True, startup_program=s2)
    specs = t2.param_specs
    host = {p: state[p].copy() for p in specs}
    opts = {p: ps_optim.make_optimizer(
        s["opt_type"], float(state[s["lr_name"]].reshape(-1)[0]),
        s["attrs"]) for p, s in specs.items()}
    hscope = ptt.io.state_from_numpy(state, place)
    prog2 = t2.get_trainer_program()
    rows = TRAIN_BATCH // PS_TRAINERS
    halves = [{k: v[i * rows:(i + 1) * rows] for k, v in feed.items()}
              for i in range(PS_TRAINERS)]
    t0 = time.perf_counter()
    for _ in range(PS_PARITY_STEPS):
        for p in specs:
            hscope.find_var(p).copy_(torch.from_numpy(host[p]))
        parts = [exe.run(prog2, feed=f, scope=hscope,
                         fetch_list=[t2.grad_names[p] for p in specs])
                 for f in halves]
        for i, p in enumerate(specs):
            g = parts[0][i]
            for part in parts[1:]:
                g = g + part[i]
            opts[p].dense(host[p], g / len(parts))
    host_adam_s = time.perf_counter() - t0
    del hscope, parts
    gc.collect()
    walls["references"] = time.perf_counter() - t_sub
    # the PS job at dropout 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_sub = time.perf_counter()
    ready()
    walls["pservers_ready_wait"] = time.perf_counter() - t_sub
    clocks = []
    trs = _ps_sync_trainers(ptt, pairs["parity"], state, place, 0.0, clocks)
    walls["parity_trainers"] = time.perf_counter() - t_sub
    t_sub = time.perf_counter()
    losses, launches = [], []
    for _ in range(PS_PARITY_STEPS):
        before = dict(native.launches)
        ls, _ = _ps_sync_step(trs, feed)
        for c in clocks:
            c()
        launches.append({k: native.launches[k] - before.get(k, 0)
                         for k in native.launches})
        losses.append(ls)
    walls["parity_steps"] = time.perf_counter() - t_sub
    want = {k: (PS_TRAINERS * per_step.get(k, 0)
                if dev.type == "cuda" else 0) for k in native.launches}
    if any(lc != want for lc in launches):
        raise AssertionError(f"train-base-ps-sync launches a step "
                             f"{launches}, expected {want}")
    mean = [sum(ls) / len(ls) for ls in losses]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(mean, ref_losses))
    if loss_err > LOSS_RTOL:
        raise AssertionError(f"train-base-ps-sync mean losses {mean} against "
                             f"the Executor's {ref_losses} (rtol {LOSS_RTOL})")
    pulled = _pulled(trs[0][0])

    def rel_l2(a, b):
        return {p: float(np.linalg.norm(a[p] - b[p])
                         / max(np.linalg.norm(b[p]), 1e-30)) for p in specs}

    def worst3(d):
        return sorted(d.items(), key=lambda kv: -kv[1])[:3]
    rel = rel_l2(pulled, host)
    rel_graph = rel_l2(pulled, graph)
    bit_equal = sum(pulled[p].tobytes() == host[p].tobytes() for p in specs)
    # tests/test_pserver.py's element-wise check, against the Executor's
    # own parameters: reported
    n_el = sum(v.size for v in pulled.values())
    out_el, worst = 0, (0.0, None)
    for p in specs:
        d = np.abs(pulled[p] - graph[p])
        bad = d > PS_ELEM_ATOL + PS_ELEM_RTOL * np.abs(graph[p])
        out_el += int(bad.sum())
        if d.size and float(d.max()) > worst[0]:
            worst = (float(d.max()), p)
    if max(rel.values()) > PS_PARAM_RTOL:
        raise AssertionError(f"train-base-ps-sync parameters: relative L2 "
                             f"{worst3(rel)} off the Executor's grads on "
                             f"the trainers' rows under the servers' Adam "
                             f"(tol {PS_PARAM_RTOL})")
    for tr, _ in trs:
        tr.close()
    del trs, pulled, graph
    gc.collect()
    # (a)'s timed steps and (b): two jobs from the startup state, in turn
    t_sub = time.perf_counter()
    jobs = {}
    for tag, q in (("raw", None), ("int8", "int8")):
        clocks_j = []
        jobs[tag] = dict(trainers=_ps_sync_trainers(
            ptt, pairs[tag], state, place, TRAIN_BASE["dropout_rate"],
            clocks_j, comm_quant=q), clocks=clocks_j, losses=[], ms=[],
            recs=[], launches=dict.fromkeys(native.launches, 0))
    walls["timed_trainers"] = time.perf_counter() - t_sub
    t_sub = time.perf_counter()
    for i in range(PS_TIMED_STEPS):
        for j in jobs.values():
            before = dict(native.launches)
            ls, ms = _ps_sync_step(j["trainers"], feed)
            j["losses"].append(ls)
            j["ms"].append(ms)
            j["recs"].append([c() for c in j["clocks"]])
            for k in native.launches:
                j["launches"][k] += native.launches[k] - before.get(k, 0)
    sync()
    walls["timed_steps"] = time.perf_counter() - t_sub
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    for tag, j in jobs.items():
        want = {k: (PS_TRAINERS * PS_TIMED_STEPS * per_step.get(k, 0)
                    if dev.type == "cuda" else 0) for k in native.launches}
        if j["launches"] != want:
            raise AssertionError(f"train-base-ps-sync {tag} launches "
                                 f"{j['launches']}, expected {want}")
        for tr, _ in j["trainers"]:
            tr.close()
        del j["trainers"], j["clocks"]
    raw, q = jobs["raw"], jobs["int8"]
    mean_raw = [sum(ls) / len(ls) for ls in raw["losses"]]
    mean_q = [sum(ls) / len(ls) for ls in q["losses"]]
    dev_q, band = _wire_band(mean_raw, mean_q)
    if not (np.isfinite(mean_q).all() and dev_q <= band):
        raise AssertionError(f"train-base-ps-int8 losses {mean_q} against "
                             f"raw {mean_raw} (band {band})")

    def split(recs):
        """A trainer's phases, the median over its steps."""
        keys = sorted({k for step in recs for r in step for k in r
                       if k != "bytes"})
        return {k: _median([r.get(k, 0.0) for step in recs for r in step])
                for k in keys}

    def wire(recs):
        """Bytes a step on the wire, all trainers, by command."""
        cmds = {}
        for r in recs[-1]:
            for k, v in r["bytes"].items():
                cmds[k] = cmds.get(k, 0) + v
        return cmds
    param_bytes = sum(v.nbytes for p, v in state.items() if p in specs)
    return dict(
        steps=PS_PARITY_STEPS, timed_steps=PS_TIMED_STEPS,
        launches={k: sum(lc[k] for lc in launches) for k in launches[0]},
        n_params=len(specs), param_bytes=param_bytes,
        losses=losses, mean_losses=mean, ref_losses=ref_losses,
        loss_rel_err=loss_err, launches_a_step=launches[0],
        param_rel_l2_max=max(rel.values()), param_rel_l2_worst=worst3(rel),
        params_bit_equal=bit_equal,
        param_rel_l2_in_graph_adam_max=max(rel_graph.values()),
        param_rel_l2_in_graph_adam_worst=worst3(rel_graph),
        elements=n_el, elements_outside_test_tol=out_el,
        share_outside_test_tol=out_el / n_el, largest_element_diff=worst,
        host_adam_reference_s=host_adam_s, walls_s=walls,
        raw=dict(losses=raw["losses"], mean_losses=mean_raw,
                 step_ms=raw["ms"], step_ms_median=_median(raw["ms"]),
                 split_ms=split(raw["recs"]), bytes=wire(raw["recs"]),
                 launches=raw["launches"]),
        int8=dict(losses=q["losses"], mean_losses=mean_q, step_ms=q["ms"],
                  step_ms_median=_median(q["ms"]),
                  split_ms=split(q["recs"]), bytes=wire(q["recs"]),
                  launches=q["launches"], max_dev=dev_q, band=band),
        peak_bytes=peak)


def _deepfm_ps_build(ptt):
    main, startup = ptt.Program(), ptt.Program()
    from paddle_tpu_torch.models import deepfm
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        _, fetches = deepfm.build(distributed=True)
        ptt.optimizer.Adagrad(learning_rate=PS_DEEPFM_LR).minimize(
            fetches["loss"])
    return main, startup, fetches["loss"]


def _ctr_batch(rng, batch=DEEPFM_BATCH):
    """DEEPFM_BATCH rows of 26 ids over 1e5 and 13 dense features in
    [0, 1); a click where the first two dense features sum past 1 (a rule
    the dense tower learns within PS_DEEPFM_STEPS, so the loss falls)."""
    import numpy as np
    dense = rng.rand(batch, 13).astype(np.float32)
    return {"dense_input": dense,
            "sparse_input": rng.randint(0, 100000, (batch, 26)).astype(
                np.int64),
            "label": (dense[:, 0] + dense[:, 1] > 1.0).astype(
                np.int64).reshape(batch, 1)}


def _deepfm_ps_trainer(ptt, eps, place, replicas=None):
    main, startup, loss = _deepfm_ps_build(ptt)
    cfg = ptt.DistributeTranspilerConfig()
    cfg.sparse_prefetch_cap = DEEPFM_BATCH * 26
    if replicas:
        cfg.haven_replicas = replicas
    t = ptt.DistributeTranspiler(cfg)
    t.transpile(0, program=main, pservers=",".join(eps), trainers=1,
                sync_mode=False, startup_program=startup)
    if set(t.sparse_specs) != {"fm_v", "fm_w"}:
        raise AssertionError(f"train-deepfm-ps tables {set(t.sparse_specs)}")
    exe = ptt.Executor(place)
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    tr = ptt.pserver.AsyncPSTrainer(t, exe, scope=scope)
    tr.init_params()
    return tr, loss


def run_train_deepfm_ps(torch, ptt, native, eps, place=None):
    """(c): returns the numbers; fails when the loss does not fall, a
    push's rows are not its batch's unique ids, or a kernel launches."""
    import numpy as np
    place = place or ptt.CUDAPlace(0)
    tr, loss = _deepfm_ps_trainer(ptt, eps, place)
    close = _instrument(torch, tr, place.torch_device())
    pushed = []
    push = tr.client.push_sparse_grad

    def record(name, ids, rows):
        pushed.append((name, np.array(ids)))
        return push(name, ids, rows)
    tr.client.push_sparse_grad = record
    rng = np.random.RandomState(DATA_SEED)
    native.reset_launches()
    losses, ms, recs, bad, uniq_counts = [], [], [], [], []
    for i in range(PS_DEEPFM_STEPS):
        feed = _ctr_batch(rng)
        del pushed[:]
        t0 = time.perf_counter()
        v, = tr.step(feed, fetch_list=[loss])
        ms.append((time.perf_counter() - t0) * 1e3)
        recs.append(close())
        losses.append(float(np.asarray(v).reshape(-1)[0]))
        uniq = np.unique(feed["sparse_input"])
        uniq_counts.append(int(uniq.size))
        if sorted(n for n, _ in pushed) != ["fm_v", "fm_w"] or any(
                not np.array_equal(ids, uniq) for _, ids in pushed):
            bad.append(i)
    tr.close()
    if bad:
        raise AssertionError(f"train-deepfm-ps-async steps {bad}: a push's "
                             f"rows are not the batch's unique ids")
    if any(native.launches.values()):
        raise AssertionError(f"train-deepfm-ps-async launched "
                             f"{native.launches}")
    if not (np.isfinite(losses).all()
            and np.mean(losses[-5:]) < np.mean(losses[:5])):
        raise AssertionError(f"train-deepfm-ps-async losses {losses} do "
                             f"not fall")
    keys = sorted({k for r in recs[1:] for k in r if k != "bytes"})
    return dict(steps=PS_DEEPFM_STEPS, losses=losses, step_ms=ms,
                step_ms_median=_median(ms[1:]),
                split_ms={k: _median([r.get(k, 0.0) for r in recs[1:]])
                          for k in keys},
                unique_ids=uniq_counts, bytes=recs[-1]["bytes"],
                cap=DEEPFM_BATCH * 26)


def haven_failover_budget_ms(calls=1):
    """tools/haven_bench.py's bound on a failover's blip: lease expiry +
    the promotion monitor's poll + the client's retry budget (the default
    RetryPolicy's backoffs at full jitter and the resolver's poll grid) +
    1 s. The bench's model makes one call to the dead primary before the
    client re-resolves the shard; `calls` counts them where a step makes
    more (each read retries the dead primary, then reads the backup,
    until a write moves the client's mapping)."""
    from paddle_tpu_torch.ark import RetryPolicy
    p = RetryPolicy()
    retry_s = sum(min(p.max_delay, p.base_delay * 2.0 ** k)
                  * (1.0 + p.jitter)
                  for k in range(p.max_attempts + 1)) + 2 * 0.25
    return (PS_HAVEN_LEASE_S + PS_HAVEN_LEASE_S / 3.0 + calls * retry_s
            + 1.0) * 1e3


def run_train_deepfm_ps_haven(torch, ptt, native, place=None):
    """(d): returns the numbers; fails when a step fails, the backup does
    not take over, a push is applied twice on a server, or the blip
    exceeds the budget."""
    import numpy as np
    from paddle_tpu_torch.ark import chaos
    from paddle_tpu_torch.pserver import ParameterServer
    place = place or ptt.CUDAPlace(0)
    backup = ParameterServer("127.0.0.1:0").start()
    backup.start_standby(lease_s=PS_HAVEN_LEASE_S)
    primary = ParameterServer("127.0.0.1:0").start()
    primary.start_replication(backup.endpoint, lease_s=PS_HAVEN_LEASE_S)
    solo = ParameterServer("127.0.0.1:0").start()
    marks = {}
    for name, srv in (("primary", primary), ("backup", backup),
                      ("solo", solo)):
        marks[name] = []
        mark = srv._async_mark

        def note(seq, trainer_id, mark=mark, log=marks[name]):
            if seq is not None:
                log.append((trainer_id, seq))
            return mark(seq, trainer_id)
        srv._async_mark = note
    try:
        tr, loss = _deepfm_ps_trainer(
            ptt, [primary.endpoint, solo.endpoint], place,
            replicas={primary.endpoint: [backup.endpoint]})
        # the calls that meet the dead primary (each with its retries)
        dead, dead_calls = [], []
        call_one = tr.client._call_one

        def counted(endpoint, cmd, *a, **k):
            try:
                return call_one(endpoint, cmd, *a, **k)
            except (ConnectionError, EOFError, OSError):
                if endpoint in dead:
                    dead_calls.append(cmd)
                raise
        tr.client._call_one = counted
        rng = np.random.RandomState(DATA_SEED + 1)
        native.reset_launches()
        done, losses = [time.perf_counter()], []
        for i in range(PS_HAVEN_STEPS):
            if i == PS_HAVEN_KILL_AT:
                lag = primary._haven.log.lag()
                dead.append(primary.endpoint)
                chaos.kill_server(primary)
            v, = tr.step(_ctr_batch(rng), fetch_list=[loss])
            done.append(time.perf_counter())
            losses.append(float(np.asarray(v).reshape(-1)[0]))
        tr.close()
        role = backup._haven.role
    finally:
        for s in (primary, backup, solo):
            s.stop()
    gaps = np.diff(done) * 1e3
    healthy = float(np.median(gaps[1:PS_HAVEN_KILL_AT]))
    blip = float(gaps.max() - healthy)
    budget = haven_failover_budget_ms(max(1, len(dead_calls)))
    twice = {k: len(v) - len(set(v)) for k, v in marks.items()}
    if role != "primary":
        raise AssertionError(f"train-deepfm-ps-haven: the backup is "
                             f"{role!r} after the kill")
    if any(twice.values()):
        raise AssertionError(f"train-deepfm-ps-haven: pushes applied twice "
                             f"{twice}")
    if not np.isfinite(losses).all() or blip > budget:
        raise AssertionError(f"train-deepfm-ps-haven: blip {blip:.1f} ms "
                             f"(budget {budget:.1f}), losses {losses}")
    if any(native.launches.values()):
        raise AssertionError(f"train-deepfm-ps-haven launched "
                             f"{native.launches}")
    after = set(marks["backup"])
    lost = [m for m in marks["primary"] if m not in after]
    return dict(steps=PS_HAVEN_STEPS, kill_at=PS_HAVEN_KILL_AT,
                lease_s=PS_HAVEN_LEASE_S, losses=losses,
                healthy_step_ms=healthy, blip_ms=blip, budget_ms=budget,
                one_call_budget_ms=haven_failover_budget_ms(),
                calls_to_the_dead_primary=dead_calls,
                gap_ms_max=float(gaps.max()), backup_role=role,
                applied=({k: len(v) for k, v in marks.items()}),
                applied_twice=twice, lag_at_kill=lag,
                lost_at_kill=len(lost))


def run_ps_plane(torch, ptt, native, tmp, place=None):
    """Phase 7q: (a)-(d), the six pserver processes (a pair each for the
    parity job, the raw and the int8 jobs) started first and stopped over
    the wire at the end (each must report it never initialized CUDA);
    any left running is killed."""
    pairs, procs, logs = {}, [], []
    for tag in ("parity", "raw", "int8"):
        eps, ps, ls = start_pservers(2, PS_TRAINERS, tmp, tag)
        pairs[tag] = eps
        procs += ps
        logs += ls
    eps = [ep for tag in pairs for ep in pairs[tag]]
    t0 = time.perf_counter()
    walls = {}
    try:
        a = run_train_base_ps(torch, ptt, native, pairs, place=place,
                              ready=lambda: wait_pservers(eps, procs, logs))
        walls["sync"] = time.perf_counter() - t0
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        c = run_train_deepfm_ps(torch, ptt, native, pairs["parity"],
                                place=place)
        walls["deepfm_async"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        d = run_train_deepfm_ps_haven(torch, ptt, native, place=place)
        walls["deepfm_haven"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        served = stop_pservers(ptt, eps, procs, logs)
        walls["stop"] = time.perf_counter() - t1
    finally:
        _kill(procs)
    return dict(sync=a, deepfm_async=c, deepfm_haven=d, pservers=served,
                walls_s=walls, s=time.perf_counter() - t0)

# phase 7r: the coordination plane (``quorum/``, ``master/``).
# train-base-elastic: train-base (TRAIN_BASE, Adam TRAIN_LR, float32) at
# TRAIN_BATCH, one trainer thread stepping it through the Executor on
# CUDAPlace(0), fed by `MasterClient.records` from a primary / standby
# `Master` pair fenced by three in-process `QuorumNode`s
# (tools/torch_chaos_drill.py's `_master_ha_world`, at lease
# ELASTIC_LEASE_S and task timeout ELASTIC_TIMEOUT_S) over
# ELASTIC_BATCHES batch ids, one a task; the primary killed by
# `ark.chaos.kill_master` once ELASTIC_KILL_AFTER tasks are done there.
# Then the delivered ids, in their order, through a fresh Executor from
# the same saved state: the losses must be the same bits.
ELASTIC_BATCHES, ELASTIC_KILL_AFTER = 12, 4
ELASTIC_LEASE_S, ELASTIC_TIMEOUT_S = 0.5, 5.0
ELASTIC_TIMEOUT = 600       # the trainer's whole pass, seconds


def elastic_batch(i, batch=TRAIN_BATCH, seq_len=TRAIN_BASE["seq_len"],
                  vocab=TRAIN_BASE["trg_vocab_size"]):
    """Train-base batch `i` of the elastic pass: source, target and label
    ids from (DATA_SEED, i)."""
    import numpy as np
    rng = np.random.RandomState([DATA_SEED, int(i)])
    return {n: rng.randint(0, vocab, (batch, seq_len)).astype(np.int64)
            for n in ("src_word", "trg_word", "lbl_word")}


def _fresh_scope(ptt, state):
    """A scope holding a copy of each of `state`'s values (a tensor
    stays on its device)."""
    scope = ptt.Scope()
    for n, v in state.items():
        scope.set_var(n, v.clone() if hasattr(v, "clone") else v.copy())
    return scope


def run_train_base_elastic(torch, ptt, native, tmp, place=None,
                           build_kw=None, batch=TRAIN_BATCH,
                           n_batches=ELASTIC_BATCHES,
                           kill_after=ELASTIC_KILL_AFTER):
    """Phase 7r: returns the numbers; fails when the standby does not
    take over within the drill's lease budget, the trainer sees a
    failure, the pass is not complete at the promoted master, a batch id
    is missing or a single-issue task was delivered twice, two masters
    issued at one sample, the promotion is not metered and in the flight
    recorder, the flash kernels did not launch 2 / 1 / 1 / 1 times an
    attention a step (on the card; none on the host), or the replay's
    losses are not the same bits."""
    import numpy as np
    from paddle_tpu_torch.ark import chaos
    from paddle_tpu_torch.master import MasterClient
    from paddle_tpu_torch.observe import flight as obs_flight
    from paddle_tpu_torch.observe import metrics as obs_metrics
    from tools.torch_chaos_drill import (ISSUING_SAMPLE_S, MASTER_RESOURCE,
                                         _check_master_exactly_once,
                                         _lease_budget_s, _master_ha_world,
                                         _start_issuing_sampler)
    place = place or ptt.CUDAPlace(0)
    budget_s = _lease_budget_s(ELASTIC_LEASE_S)
    cfg = dict(TRAIN_BASE, **(build_kw or {}))
    main, startup, loss = build_train(ptt, **(build_kw or {}))
    vocab, seq_len = cfg["trg_vocab_size"], cfg["seq_len"]
    t_phase = time.perf_counter()
    dev = place.torch_device()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    scope0 = ptt.Scope()
    ptt.Executor(place).run(startup, scope=scope0)
    state = {n: scope0.find_var(n) for n in scope0.local_var_names()}
    del scope0

    def load_chunk(i):
        yield i, elastic_batch(i, batch, seq_len, vocab)

    def steps_of(exe, scope, feeds, out):
        """Each (id, feed) of `feeds` one step: the id, the loss, the
        step's ms and its end on the host's clock into `out`."""
        for i, feed in feeds:
            t0 = time.perf_counter()
            v, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            sync()
            t1 = time.perf_counter()
            out["ids"].append(int(i))
            out["losses"].append(float(np.asarray(v).reshape(-1)[0]))
            out["step_ms"].append((t1 - t0) * 1e3)
            out["ends"].append(t1)

    prev_observe = ptt.get_flag("observe")
    ptt.set_flag("observe", True)
    obs_metrics.default_registry().reset()
    obs_flight.get_flight().clear()
    nodes, qeps, primary, standby = _master_ha_world(
        tmp, lease_s=ELASTIC_LEASE_S, timeout_dur=ELASTIC_TIMEOUT_S)
    t_world = time.perf_counter() - t_phase
    stop_sampling = threading.Event()
    run = dict(ids=[], losses=[], step_ms=[], ends=[], failures=[])
    try:
        admin = MasterClient(primary.endpoint)
        admin.set_dataset(list(range(n_batches)), chunks_per_task=1)
        admin.close()

        def trainer():
            mc = MasterClient(primary.endpoint, standbys=[standby.endpoint],
                              quorum_endpoints=qeps,
                              quorum_resource=MASTER_RESOURCE,
                              failover_s=20.0)
            try:
                steps_of(ptt.Executor(place), _fresh_scope(ptt, state),
                         mc.records(load_chunk), run)
            except Exception as e:      # noqa: BLE001 - a gate reads it
                run["failures"].append(repr(e))
            finally:
                mc.close()

        samples, violations = _start_issuing_sampler([primary, standby],
                                                     stop_sampling)
        native.reset_launches()
        th = threading.Thread(target=trainer, daemon=True)
        th.start()
        deadline = time.monotonic() + ELASTIC_TIMEOUT
        while True:
            with primary._lock:
                done_at_kill = len(primary._done)
            if done_at_kill >= kill_after or not th.is_alive():
                break
            if time.monotonic() > deadline:
                raise AssertionError("train-base-elastic: no progress at "
                                     "the primary")
            time.sleep(0.005)
        steps_at_kill = len(run["ids"])
        kill_at = time.perf_counter()
        chaos.kill_master(primary)
        while standby.ha_status()["role"] != "primary":
            if time.perf_counter() - kill_at > budget_s + 10:
                break
            time.sleep(0.005)
        promote_s = time.perf_counter() - kill_at
        th.join(timeout=ELASTIC_TIMEOUT)
        launches = dict(native.launches)
        stop_sampling.set()
        if th.is_alive():
            raise AssertionError("train-base-elastic: the trainer never "
                                 "drained the pass")
        st = standby.ha_status()
        with standby._lock:
            done = [(t.epoch, list(t.payload)) for t in standby._done]
        promoted = obs_metrics.default_registry().get(
            "master_promotions_total")
        promoted = promoted.value(kind="quorum") if promoted else 0
        promos = [e for e in obs_flight.get_flight().events(
            "master_promotion") if e.get("endpoint") == standby.endpoint]
    finally:
        stop_sampling.set()
        ptt.set_flag("observe", prev_observe)
        primary.stop()
        standby.stop()
        for n in nodes:
            n.stop()
    tag = "train-base-elastic"
    if run["failures"]:
        raise AssertionError(f"{tag}: the trainer failed {run['failures']}")
    if promote_s > budget_s:
        raise AssertionError(f"{tag}: the standby took {promote_s:.2f} s "
                             f"to promote (budget {budget_s:.2f} s; {st})")
    if not (st["role"] == "primary" and st["done"] == n_batches
            and st["todo"] == 0 and st["pending"] == 0):
        raise AssertionError(f"{tag}: pass not complete at the promoted "
                             f"master {st}")
    _check_master_exactly_once(standby, run["ids"], n_batches)
    reissued = [p for e, p in done if e > 1]
    if violations:
        raise AssertionError(f"{tag}: two issuing masters at "
                             f"{len(violations)} samples")
    if promoted < 1 or not promos:
        raise AssertionError(f"{tag}: promotion metered {promoted}, in the "
                             f"flight recorder {len(promos)}")
    n_steps = len(run["ids"])
    n_attn = 3 * cfg["n_layer"]
    per_step = {"flash_fwd": 2 * n_attn, "flash_dq": n_attn,
                "flash_dkv": n_attn, "flash_delta": n_attn}
    want = {k: (per_step.get(k, 0) * n_steps if dev.type == "cuda" else 0)
            for k in launches}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")
    if not np.isfinite(run["losses"]).all():
        raise AssertionError(f"{tag}: losses {run['losses']}")
    # the replay: the delivered ids, duplicates included, from the state
    t_replay = time.perf_counter()
    replay = dict(ids=[], losses=[], step_ms=[], ends=[])
    native.reset_launches()
    steps_of(ptt.Executor(place), _fresh_scope(ptt, state),
             ((i, elastic_batch(i, batch, seq_len, vocab))
              for i in run["ids"]), replay)
    replay_launches = dict(native.launches)
    replay_s = time.perf_counter() - t_replay
    del state
    differ = [k for k, (a, b) in enumerate(zip(run["losses"],
                                                replay["losses"]))
              if np.float32(a).tobytes() != np.float32(b).tobytes()]
    if differ or len(replay["losses"]) != n_steps:
        raise AssertionError(f"{tag}: losses {run['losses']} against the "
                             f"replay's {replay['losses']} (steps {differ} "
                             f"differ)")
    ms = run["step_ms"]
    gaps = np.diff(run["ends"]) * 1e3
    med = _median(ms[1:] or ms)
    # the gap that spans the kill (the step that met the dead primary)
    before = [e for e in run["ends"] if e <= kill_at]
    after = [e for e in run["ends"] if e > kill_at]
    kill_gap = (after[0] - before[-1]) * 1e3 if before and after else 0.0
    periods = np.diff(samples) * 1e3 if len(samples) > 1 else np.zeros(1)
    return dict(batches=n_batches, batch=batch, n_layer=cfg["n_layer"],
                steps=n_steps, ids=run["ids"], losses=run["losses"],
                replay_losses=replay["losses"], bit_equal=True,
                kill_after=kill_after, done_at_kill=done_at_kill,
                steps_at_kill=steps_at_kill, lease_s=ELASTIC_LEASE_S,
                timeout_dur=ELASTIC_TIMEOUT_S, promote_s=promote_s,
                budget_s=budget_s, step_ms=ms,
                step_ms_median=med,
                gap_ms_max=float(gaps.max()) if len(gaps) else 0.0,
                stall_ms=(float(gaps.max()) - med) if len(gaps) else 0.0,
                gap_ms_at_kill=kill_gap, stall_ms_at_kill=kill_gap - med,
                reissued=reissued, promotions=promoted,
                samples=len(samples),
                sample_ms_mean=float(np.mean(periods)),
                sample_ms_max=float(np.max(periods)),
                sample_ms_asked=ISSUING_SAMPLE_S * 1e3,
                launches=launches, launches_a_step=per_step
                if dev.type == "cuda" else {},
                replay_launches=replay_launches, replay_s=replay_s,
                world_s=t_world, master_status=st,
                s=time.perf_counter() - t_phase)


# phase 7s: disaggregated serving and the fleet (``fleet/``, ``torrent/``).
# serve-base-torrent: three in-process ReplicaServers behind one
# FleetRouter, each over its own InferenceServer(CUDAPlace(0)) on phase
# 4b's int8 serve-base dir: p0 (role prefill), d0 and d1 (role decode).
# 4b's INT8_REQUESTS prompts go through `FleetRouter.generate_torrent` from
# TORRENT_CLIENTS threads; d1 is killed (`ReplicaServer.kill()`, its RPC
# front dies, its engine finishes what it holds) once TORRENT_KILL_AFTER
# generations completed, and the sequences pinned to it fail over by
# re-prefill. Before the traffic, one request alone (the longest prompt)
# has its rows read on both sides. The fp32 arm: phase 4's N_REQUESTS
# prompts over a fresh p0 / d0 pair on phase 4's float32 dir; its rows
# ride the wire's lossy int8 codec.
TORRENT_CLIENTS, TORRENT_KILL_AFTER = 8, 8
TORRENT_LEASE_S = 2.0


def _metric(ptt, name, **labels):
    """A counter's or gauge's value (its total without labels), 0 when
    nothing registered it yet."""
    m = ptt.observe.metrics.default_registry().get(name)
    if m is None:
        return 0.0
    v = m.value(**labels) if labels or not hasattr(m, "total") \
        else m.total()
    return v or 0.0


def _torrent_fleet(ptt, native, router, mdir, name, roles):
    """One InferenceServer(CUDAPlace(0)) a replica, loaded in parallel,
    each behind a ReplicaServer heartbeating `router`; waits until the
    router finds them all ready. Returns ({rid: ReplicaServer}, {rid:
    run tallies of the prefill and the decode program})."""
    servers, errors = {}, []

    def load(rid):
        try:
            srv = ptt.serve.InferenceServer(ptt.CUDAPlace(0))
            srv.add_model(name, mdir)
            servers[rid] = srv
        except Exception as e:          # noqa: BLE001
            errors.append(f"{rid}: {e!r}")
    threads = [threading.Thread(target=load, args=(rid,))
               for rid, _ in roles]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        for srv in servers.values():
            srv.close()
        raise AssertionError(f"serve-base-torrent: a replica failed to "
                             f"load: {errors}")
    reps, tallies = {}, {}
    for rid, role in roles:
        ver = servers[rid].registry.get(name)
        tallies[rid] = {"prefill": {}, "decode": {}}
        _count_runs(native, ver.prepared, tallies[rid]["prefill"])
        _count_runs(native, ver.decode.prepared, tallies[rid]["decode"])
        reps[rid] = ptt.fleet.ReplicaServer(
            servers[rid], replica_id=rid,
            router_endpoint=router.control_endpoint,
            lease_s=TORRENT_LEASE_S, role=role).start()
    deadline = time.monotonic() + 120
    while len(router.ready_members(name)) < len(roles):
        if time.monotonic() > deadline:
            raise AssertionError(f"serve-base-torrent: the fleet never got "
                                 f"ready: {router.members()}")
        time.sleep(0.02)
    return reps, tallies


def _scope_rows(torch, scope, sig, ids):
    """Each cache var's and scale var's rows at block `ids`, read from
    `scope` to the host by plain indexing."""
    names = list(sig["cache_vars"]) + list(
        (sig.get("scale_vars") or {}).values())
    out = {}
    for n in names:
        var = scope.find_var(n)
        out[n] = var[torch.as_tensor(ids, device=var.device)].cpu().numpy()
    return out


def _capture_rows(torch, eng, side, target, rec):
    """Wrap the engine's `_extract_kv` (side "p") or `_inject_premat`
    (side "d") so the first call for the prompt `target` records the
    slot's block ids, the scope's rows there at that moment (on the engine
    thread, before any later step writes them) and the payload."""
    if side == "p":
        orig = eng._extract_kv

        def extract(dec, sig, slot, prompt_len):
            out = orig(dec, sig, slot, prompt_len)
            state = eng._sched.slots[slot]
            if side not in rec and state is not None \
                    and state.req.prompt == target:
                ids = dec.kvcache.slot_blocks(slot)
                rec[side] = (list(ids), _scope_rows(
                    torch, eng._ver.scope, sig, ids), out)
            return out
        eng._extract_kv = extract
    else:
        orig = eng._inject_premat

        def inject(dec, sig, slot, state):
            orig(dec, sig, slot, state)
            if side not in rec and state.req.prompt == target:
                ids = dec.kvcache.slot_blocks(slot)
                rec[side] = (list(ids), _scope_rows(
                    torch, eng._ver.scope, sig, ids), state.req.premat)
        eng._inject_premat = inject


def _torrent_traffic(router, name, prompts, kill=None):
    """Every prompt once through `generate_torrent` from TORRENT_CLIENTS
    threads (seq ids "<name>-<i>"); `kill` (a callable) runs once, on the
    thread whose generation is the TORRENT_KILL_AFTER-th to complete.
    Returns (results {i: (FleetResult, start, end)}, errors, kill time,
    wall s, {sid: [(start, end) of each torrent_prefill call]}, {sid:
    [(time, replica) of each decode failover]})."""
    prefills, fails = {}, {}
    orig_req, orig_fo = router._request, router._fail_over_decode

    def request(model, cmd, payload, role=None):
        t0 = time.perf_counter()
        try:
            return orig_req(model, cmd, payload, role)
        finally:
            if cmd == "torrent_prefill":
                prefills.setdefault(payload["seq_id"], []).append(
                    (t0, time.perf_counter()))

    def fail_over(model, sid, m, bad, err):
        fails.setdefault(sid, []).append((time.perf_counter(),
                                          m.replica_id))
        return orig_fo(model, sid, m, bad, err)
    router._request, router._fail_over_decode = request, fail_over
    todo = list(range(len(prompts)))
    results, errors, killed = {}, [], {}
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                if not todo:
                    return
                i = todo.pop(0)
            t0 = time.perf_counter()
            try:
                res = router.generate_torrent(
                    name, prompts[i], max_new_tokens=NEW_TOKENS,
                    seq_id=f"{name}-{i}")
            except Exception as e:      # noqa: BLE001
                with lock:
                    errors.append((i, repr(e)))
                continue
            t1 = time.perf_counter()
            with lock:
                results[i] = (res, t0, t1)
                fire = kill is not None and not killed \
                    and len(results) == TORRENT_KILL_AFTER
                if fire:
                    killed["t"] = time.perf_counter()
            if fire:
                kill()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client)
               for _ in range(TORRENT_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    del router._request, router._fail_over_decode
    return results, errors, killed.get("t"), wall, prefills, fails


def _wait_idle(reps, name):
    deadline = time.monotonic() + 120
    for rep in reps.values():
        eng = rep.server._engine(name)
        while True:
            st = eng.stats()
            if not st["active_slots"] and not st["queued"]:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"serve-base-torrent: "
                                     f"{rep.replica_id} never went idle")
            time.sleep(0.01)


def _torrent_arm(torch, ptt, native, arm, roles, kill_rid=None):
    """One arm of serve-base-torrent over `arm` (mdir, sig, prompts, the
    single-server card tokens): the fleet, the lone request whose rows are
    read on both sides, the traffic, the gates every arm shares. Returns
    the numbers and the still-open fleet (the caller closes it)."""
    import numpy as np
    name, sig = arm["name"], arm["sig"]
    prompts, n_layers = arm["prompts"], sig["n_layers"]
    t_arm = time.perf_counter()
    router = ptt.fleet.FleetRouter(ptt.fleet.RouterConfig(
        lease_s=TORRENT_LEASE_S, poll_interval_s=0.1)).start()
    t0 = time.perf_counter()
    reps, tallies = _torrent_fleet(ptt, native, router, arm["mdir"], name,
                                   roles)
    world_s = time.perf_counter() - t0
    # the lone request: its rows read on the prefill side at extraction
    # and on the decode side at injection
    target = prompts[-1]
    rec = {}
    _capture_rows(torch, reps["p0"].server._engine(name), "p", target, rec)
    for rid, role in roles:
        if role == "decode":
            _capture_rows(torch, reps[rid].server._engine(name), "d",
                          target, rec)
    lone = router.generate_torrent(name, target, max_new_tokens=NEW_TOKENS,
                                   seq_id=f"{name}-lone")
    if set(rec) != {"p", "d"}:
        raise AssertionError(f"serve-base-torrent {name}: the lone request's "
                             f"rows were not captured on both sides "
                             f"({sorted(rec)})")
    # the counted window: the traffic alone
    _wait_idle(reps, name)
    for t in tallies.values():
        t["prefill"].clear()
        t["decode"].clear()
    before = {k: _metric(ptt, k) for k in (
        "torrent_kv_transfer_bytes_total", "torrent_failovers_total")}
    ok_before = _metric(ptt, "torrent_generations_total", model=name,
                        outcome="ok")
    native.reset_launches()
    results, errors, kill_t, wall, prefills, fails = _torrent_traffic(
        router, name, prompts,
        kill=(reps[kill_rid].kill if kill_rid else None))
    _wait_idle(reps, name)
    torch.cuda.synchronize()
    launches = dict(native.launches)
    runs = {rid: {k: t[k].get("runs", 0) for k in t}
            for rid, t in tallies.items()}
    if errors or len(results) != len(prompts):
        raise AssertionError(f"serve-base-torrent {name}: failed requests "
                             f"{errors[:3]} ({len(errors)} in all)")
    n_prefill = runs["p0"]["prefill"]
    n_decode = sum(r["decode"] for rid, r in runs.items() if rid != "p0")
    kern = "paged_decode_q8" if sig.get("kv_dtype") == "int8" \
        else "paged_decode"
    want = dict.fromkeys(launches, 0)
    want.update({"flash_fwd": n_layers * n_prefill, kern: n_layers * n_decode})
    if launches != want or n_prefill < 1 or n_decode < 1:
        raise AssertionError(f"serve-base-torrent {name}: launches "
                             f"{launches}, expected {want} (runs {runs})")
    if runs["p0"]["decode"] or any(r["prefill"] for rid, r in runs.items()
                                   if rid != "p0"):
        raise AssertionError(f"serve-base-torrent {name}: a prefill ran on a "
                             f"decode replica or a decode step on the "
                             f"prefill replica: runs {runs}")
    for i, (res, _, _) in sorted(results.items()):
        if len(res.tokens) != NEW_TOKENS or \
                res.outs["finish_reason"] != "length" or \
                not all(0 <= t < sig["vocab"] for t in res.tokens):
            raise AssertionError(f"serve-base-torrent {name}: bad generation "
                                 f"{i}: {res.tokens}")
    if _metric(ptt, "fleet_affinity_sessions") != 0:
        raise AssertionError(f"serve-base-torrent {name}: session pins "
                             f"left: {_metric(ptt, 'fleet_affinity_sessions')}")
    n_ok = _metric(ptt, "torrent_generations_total", model=name,
                   outcome="ok") - ok_before
    kv_bytes = _metric(ptt, "torrent_kv_transfer_bytes_total") \
        - before["torrent_kv_transfer_bytes_total"]
    failovers = _metric(ptt, "torrent_failovers_total") \
        - before["torrent_failovers_total"]
    if n_ok != len(prompts) or kv_bytes <= 0:
        raise AssertionError(f"serve-base-torrent {name}: "
                             f"torrent_generations_total ok +{n_ok} (want "
                             f"{len(prompts)}), kv bytes +{kv_bytes}")
    # end-to-end TTFT: the generation's start to the end of the prefill
    # call whose stream fed the decode that finished it
    ttft = sorted((prefills[f"{name}-{i}"][-1][1] - t0) * 1e3
                  for i, (_, t0, _) in results.items())
    tokens = sum(len(r.tokens) for r, _, _ in results.values())
    stream_ms = sorted((r.outs["prefill"]["stream_us"]
                        - r.outs["prefill"]["ttft_us"]) / 1e3
                       for r, _, _ in results.values())
    reprefill = []
    for sid, events in fails.items():
        t_fail = events[0][0]
        after = [(a, b) for a, b in prefills.get(sid, []) if a >= t_fail]
        if after:
            reprefill.append(dict(sid=sid, frm=events[0][1],
                                  prefill_ms=(after[-1][1] - after[-1][0])
                                  * 1e3,
                                  recovery_ms=(after[-1][1] - t_fail) * 1e3))
    p_ids, p_rows, p_payload = rec["p"]
    d_ids, d_rows, d_payload = rec["d"]
    out = dict(
        requests=len(prompts), clients=TORRENT_CLIENTS, world_s=world_s,
        wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall,
        tokens_per_s_replica=tokens / wall / len(roles),
        ttft_ms_median=ttft[len(ttft) // 2],
        ttft_ms_p99=ttft[min(len(ttft) - 1, int(0.99 * len(ttft)))],
        stream_ms_median=stream_ms[len(stream_ms) // 2],
        stream_ms_max=stream_ms[-1],
        bytes_per_request=float(np.mean([r.outs["prefill"]["bytes"]
                                         for r, _, _ in results.values()])),
        kv_bytes_total=kv_bytes, failovers=failovers, reprefill=reprefill,
        killed=kill_rid, kill_after=TORRENT_KILL_AFTER if kill_rid else None,
        kill_t=(kill_t - t_arm) if kill_t else None, launches=launches,
        runs=runs, lone_tokens=lone.tokens,
        lone_blocks={"prefill": p_ids, "decode": d_ids},
        tokens_by_request={i: r.tokens for i, (r, _, _) in results.items()})
    return out, dict(router=router, reps=reps, rows=(p_rows, p_payload,
                                                     d_rows, d_payload))


def log_serve_base_torrent(tor, card):
    q8, fp = tor["int8"], tor["fp32"]
    for tag, a in (("serve-base-torrent (int8)", q8),
                   ("serve-base-torrent-fp32", fp)):
        log(f"{tag} [{card}]: {a['requests']} requests x {NEW_TOKENS} tokens "
            f"from {a['clients']} client threads through "
            f"FleetRouter.generate_torrent over {len(a['runs'])} in-process "
            f"replicas (p0 prefill; {', '.join(r for r in a['runs'] if r != 'p0')} "
            f"decode), world up in {a['world_s']:.2f} s; end-to-end TTFT "
            f"median {a['ttft_ms_median']:.1f} ms p99 {a['ttft_ms_p99']:.1f} "
            f"ms; {a['tokens']} tokens in {a['wall_s']:.3f} s = "
            f"{a['tokens_per_s']:.1f} tokens/s, "
            f"{a['tokens_per_s_replica']:.1f} a replica; KV bytes shipped a "
            f"request {a['bytes_per_request']:.0f} (all streams, retransmits "
            f"and re-prefills included: {a['kv_bytes_total']:.0f}); stream "
            f"(prefill end to commit) median {a['stream_ms_median']:.2f} ms "
            f"max {a['stream_ms_max']:.2f} ms; runs {a['runs']}; launches "
            f"{ {k: v for k, v in a['launches'].items() if v} }; lone "
            f"request's blocks {a['lone_blocks']['prefill'][:3]}... on p0, "
            f"{a['lone_blocks']['decode'][:3]}... on the decode side")
    log(f"serve-base-torrent kill [{card}]: {q8['killed']} killed "
        f"{q8['kill_t']:.2f} s into the arm, after {q8['kill_after']} "
        f"generations; {q8['failovers']:.0f} decode failover(s) metered; "
        f"re-prefills "
        + ", ".join(f"{r['sid']} off {r['frm']}: prefill {r['prefill_ms']:.1f} "
                    f"ms, {r['recovery_ms']:.1f} ms from the failover"
                    for r in q8["reprefill"])
        + f"; tokens equal to 4b's card run for {q8['equal_to_4b']} of "
        f"{q8['requests'] + 1} (the lone request counted), near ties "
        f"{q8['near_ties']}; injected rows and scales equal p0's bit for bit")
    log(f"serve-base-torrent-fp32 [{card}]: first tokens equal phase 4's for "
        f"all {fp['requests']} (and the lone request); later tokens equal "
        f"{fp['later_equal_share']:.3f} of them (not gated: the int8 wire "
        f"codec is lossy); first divergence by request "
        f"{fp['first_divergence']}; injected rows equal the host codec's "
        f"decode of p0's bit for bit; bytes a request int8 "
        f"{q8['bytes_per_request']:.0f} against fp32 "
        f"{fp['bytes_per_request']:.0f}")
    log(f"phase 7s: {tor['s']:.1f} s")


def _close_fleet(fleet):
    for rep in fleet["reps"].values():
        rep.close()
    fleet["router"].close()


def run_serve_base_torrent(torch, ptt, native, q8, fp):
    """Phase 7s: the int8 arm with the kill, then the fp32 arm. `q8` and
    `fp`: phase 4b's and phase 4's (name, mdir, sig, prompts, card
    tokens). Returns the numbers."""
    import numpy as np
    t_phase = time.perf_counter()
    codec = ptt.wire.codec
    out = {}
    # the int8 arm
    arm, fleet = _torrent_arm(torch, ptt, native, q8,
                              (("p0", "prefill"), ("d0", "decode"),
                               ("d1", "decode")), kill_rid="d1")
    try:
        if arm["failovers"] < 1:
            raise AssertionError("serve-base-torrent: the kill of d1 metered "
                                 "no decode failover")
        p_rows, p_payload, d_rows, d_payload = fleet["rows"]
        sig = q8["sig"]
        # the rows extracted on p0 are its scope's at its block ids, and
        # the decode replica's scope holds them, bit for bit, at its own
        for n in p_rows:
            extracted = p_payload["cache"].get(n) if n in sig["cache_vars"] \
                else p_payload["scales"][next(
                    c for c, s in sig["scale_vars"].items() if s == n)]
            if p_rows[n].tobytes() != np.asarray(extracted).tobytes() \
                    or d_rows[n].tobytes() != p_rows[n].tobytes():
                raise AssertionError(f"serve-base-torrent: {n}'s rows on the "
                                     f"decode replica differ from p0's")
        # tokens against 4b's single-server run (the lone request is the
        # last prompt's); a difference passes only as a near tie under
        # 4b's teacher-forced rule
        n = len(q8["prompts"])
        cases = [(i, q8["prompts"][i], arm["tokens_by_request"][i],
                  q8["tokens"][i]) for i in range(n)]
        cases.append(("lone", q8["prompts"][-1], arm["lone_tokens"],
                      q8["tokens"][-1]))
        differ = [c for c in cases if c[2] != c[3]]
        ties = []
        ver = fleet["reps"]["d0"].server.registry.get(q8["name"])
        for i, prompt, got, want in differ:
            logits, _ = teacher_forced(ver, prompt, want, INT8_SLOTS)
            step = next(k for k, (a, b) in enumerate(zip(got, want))
                        if a != b)
            gap = float(logits[step, want[step]] - logits[step, got[step]])
            ties.append(dict(request=i, step=step, gap=gap))
            if abs(gap) > 2 * Q8_LOGIT_TOL:
                raise AssertionError(
                    f"serve-base-torrent request {i}: tokens differ from 4b's "
                    f"at step {step} ({got[step]} against {want[step]}) with "
                    f"a logit gap {gap:.3g} > {2 * Q8_LOGIT_TOL}: not a near "
                    f"tie")
        arm["near_ties"] = ties
        arm["equal_to_4b"] = len(cases) - len(differ)
    finally:
        _close_fleet(fleet)
    out["int8"] = arm
    # the fp32 arm: the rows ride the lossy int8 codec
    arm, fleet = _torrent_arm(torch, ptt, native, fp,
                              (("p0", "prefill"), ("d0", "decode")))
    try:
        p_rows, p_payload, d_rows, _ = fleet["rows"]
        for n in p_rows:
            if p_rows[n].tobytes() != p_payload["cache"][n].tobytes():
                raise AssertionError(f"serve-base-torrent fp32: {n}'s "
                                     f"extracted rows are not p0's")
            decoded = np.stack([codec.maybe_decode(codec.encode_tensor(
                row, "int8", name=n)) for row in p_rows[n]])
            if d_rows[n].tobytes() != decoded.astype(np.float32).tobytes():
                raise AssertionError(f"serve-base-torrent fp32: {n}'s "
                                     f"injected rows are not the host codec's "
                                     f"decode of p0's")
        got = arm["tokens_by_request"]
        firsts = [got[i][0] == fp["tokens"][i][0] for i in sorted(got)]
        if not all(firsts) or arm["lone_tokens"][0] != fp["tokens"][-1][0]:
            raise AssertionError(f"serve-base-torrent fp32: first tokens "
                                 f"differ from phase 4's: {firsts}")
        later = [sum(a == b for a, b in zip(got[i][1:], fp["tokens"][i][1:]))
                 for i in sorted(got)]
        arm["later_equal_share"] = sum(later) / (len(got) * (NEW_TOKENS - 1))
        arm["first_divergence"] = {
            i: next((k for k, (a, b) in enumerate(zip(got[i], fp["tokens"][i]))
                     if a != b), None) for i in sorted(got)}
    finally:
        _close_fleet(fleet)
    out["fp32"] = arm
    out["s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 7t: the C inference ABI (``capi/``, ``capi_runtime``)
# ---------------------------------------------------------------------------
# infer-base (7m's saved float32 dir) through libpaddle_tpu_capi.so, built
# from the checkout's capi.cc: in this process by ctypes, CAPI_BATCHES
# batches of CAPI_BATCH x seq from DATA_SEED, each through PD_PredictorRun,
# capi_runtime.Predictor.run and the Executor's prepared run of the loaded
# program, their logits bit for bit alike, and each ABI run launching one
# flash forward a fused attention (18) and no other kernel of csrc/; then
# CAPI_CLIENT_SRC, a pure-C client compiled with gcc against the port's
# header, which starts its own interpreter, creates the predictor on its
# main thread, runs the first batch from a second pthread and writes that
# batch's first row of logits to a file: equal to the in-process run's
CAPI_BATCH, CAPI_BATCHES = 8, 3
CAPI_CLIENT_TIMEOUT = 300
CAPI_CLIENT_SRC = r"""
#include "paddle_tpu_capi.h"
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <time.h>

/* usage: client MODEL_DIR FEED_FILE BATCH SEQ OUT_FILE
   FEED_FILE: src_word then trg_word, int64 [BATCH, SEQ] each */
static PD_Predictor pred;
static int64_t shape[2];
static int64_t* feed;
static const char* out_path;
static int worker_rc = 1;

static double now(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec + t.tv_nsec * 1e-9;
}

static void* worker(void* arg) {
  (void)arg;
  size_t n = (size_t)(shape[0] * shape[1]);
  PD_Tensor in[2] = {{"src_word", PD_INT64, shape, 2, feed},
                     {"trg_word", PD_INT64, shape, 2, feed + n}};
  PD_Results r = PD_PredictorRun(pred, in, 2);
  if (!r) { fprintf(stderr, "run: %s\n", PD_LastError()); return 0; }
  if (PD_ResultsNum(r) != 1 || PD_ResultsDType(r, 0) != PD_FLOAT32 ||
      PD_ResultsRank(r, 0) != 3) {
    fprintf(stderr, "unexpected results\n");
    PD_DestroyResults(r);
    return 0;
  }
  const int64_t* s = PD_ResultsShape(r, 0);
  printf("logits %s [%lld, %lld, %lld]\n", PD_ResultsName(r, 0),
         (long long)s[0], (long long)s[1], (long long)s[2]);
  size_t row = (size_t)(s[1] * s[2]) * sizeof(float);
  FILE* f = fopen(out_path, "wb");
  if (f && fwrite(PD_ResultsData(r, 0), 1, row, f) == row) worker_rc = 0;
  if (f) fclose(f);
  PD_DestroyResults(r);
  return 0;
}

int main(int argc, char** argv) {
  if (argc != 6) { fprintf(stderr, "usage\n"); return 2; }
  double t0 = now();
  shape[0] = atoll(argv[3]);
  shape[1] = atoll(argv[4]);
  out_path = argv[5];
  size_t n = (size_t)(shape[0] * shape[1]);
  feed = (int64_t*)malloc(2 * n * sizeof(int64_t));
  FILE* f = fopen(argv[2], "rb");
  if (!f || fread(feed, sizeof(int64_t), 2 * n, f) != 2 * n) return 2;
  fclose(f);
  pred = PD_CreatePredictor(argv[1]);
  if (!pred) { fprintf(stderr, "create: %s\n", PD_LastError()); return 3; }
  printf("created %.3f s\n", now() - t0);
  pthread_t th;
  pthread_create(&th, 0, worker, 0);
  pthread_join(th, 0);
  printf("first result %.3f s\n", now() - t0);
  PD_DestroyPredictor(pred);
  free(feed);
  return worker_rc;
}
"""


def _capi_run(lib, pred, feed):
    """One PD_PredictorRun of `feed` ({name: int64 [B, T]}): (its
    seconds, the logits copied out of the results)."""
    import ctypes
    import numpy as np
    from paddle_tpu_torch.capi import PD_FLOAT32, PD_INT64, PDTensor

    names = ("src_word", "trg_word")
    shape = (ctypes.c_int64 * 2)(*feed[names[0]].shape)
    tensors = (PDTensor * 2)(*[PDTensor(n.encode(), PD_INT64, shape, 2,
                                        feed[n].ctypes.data) for n in names])
    t0 = time.perf_counter()
    res = lib.PD_PredictorRun(pred, ctypes.addressof(tensors), 2)
    s = time.perf_counter() - t0
    if not res:
        raise AssertionError(f"PD_PredictorRun: {lib.PD_LastError()}")
    try:
        if lib.PD_ResultsNum(res) != 1 or \
                lib.PD_ResultsDType(res, 0) != PD_FLOAT32:
            raise AssertionError("PD_PredictorRun: not one float32 result")
        shp = lib.PD_ResultsShape(res, 0)
        dims = [shp[i] for i in range(lib.PD_ResultsRank(res, 0))]
        out = np.empty(dims, np.float32)
        if lib.PD_ResultsByteSize(res, 0) != out.nbytes:
            raise AssertionError("PD_ResultsByteSize disagrees with the "
                                 "shape")
        ctypes.memmove(out.ctypes.data, lib.PD_ResultsData(res, 0),
                       out.nbytes)
    finally:
        lib.PD_DestroyResults(res)
    return s, out


def _bits_or_diff(np, tag, got, want):
    if got.shape != want.shape or not np.array_equal(got, want):
        diff = (float(np.abs(got - want).max())
                if got.shape == want.shape else "shapes differ")
        raise AssertionError(f"phase 7t: {tag}: {got.shape} against "
                             f"{want.shape}, max abs difference {diff}")


def run_capi(torch, ptt, native, model_dir, root, tmp):
    """Phase 7t on the infer-base dir `model_dir`; `root` is the checkout
    (the client's interpreter imports paddle_tpu_torch from it)."""
    import sysconfig

    import numpy as np
    from paddle_tpu_torch import capi, capi_runtime
    from paddle_tpu_torch.capi.build import python_link_flags
    from paddle_tpu_torch.core.executor import to_numpy
    out = {}
    try:
        python_link_flags()
        out["embed_missing"] = None
    except capi.BuildError as e:
        out["embed_missing"] = str(e)
    t0 = time.perf_counter()
    so = capi.build(embed=out["embed_missing"] is None)
    out["build_s"] = time.perf_counter() - t0
    out["library"] = os.path.relpath(so, root)
    lib = capi.load(so)
    # the C signature has no place: the default, CUDAPlace(0)
    os.environ.pop(capi_runtime.PLACE_ENV, None)
    T, V = TRAIN_BASE["seq_len"], TRAIN_BASE["trg_vocab_size"]
    rng = np.random.RandomState(DATA_SEED)
    batches = [{n: rng.randint(0, V, (CAPI_BATCH, T)).astype(np.int64)
                for n in ("src_word", "trg_word")}
               for _ in range(CAPI_BATCHES)]
    t0 = time.perf_counter()
    pred = lib.PD_CreatePredictor(model_dir.encode())
    if not pred:
        raise AssertionError(f"PD_CreatePredictor: {lib.PD_LastError()}")
    out["create_s"] = time.perf_counter() - t0
    try:
        rt = capi_runtime.Predictor(model_dir)
        if rt.exe.place.torch_device().type != "cuda":
            raise AssertionError(f"capi_runtime placed on {rt.exe.place}")
        exe, scope = ptt.Executor(ptt.CUDAPlace(0)), ptt.Scope()
        prog, _, targets = ptt.io.load_inference_model(model_dir, exe,
                                                       scope=scope)
        attentions = sum(op.type == "fused_attention"
                         for op in prog.global_block().ops)
        handle = exe.prepare(prog, fetch_list=targets, scope=scope)

        def runtime(feed):
            return rt.run([(n, v.shape, "int64", v.tobytes())
                           for n, v in feed.items()])[0][2]

        # warm-up: each path once on the first batch
        _capi_run(lib, pred, batches[0])
        runtime(batches[0])
        handle.run(batches[0])
        abi_ms, fetch_ms, card_ms, launches, first = [], [], [], [], None
        for feed in batches:
            native.reset_launches()
            torch.cuda.synchronize()
            s, got = _capi_run(lib, pred, feed)
            launches.append({k: v for k, v in native.launches.items() if v})
            abi_ms.append(s * 1e3)
            first = got if first is None else first
            if got.shape != (CAPI_BATCH, T, V) or not np.isfinite(got).all():
                raise AssertionError(f"phase 7t: logits {got.shape}, or not "
                                     f"finite")
            _bits_or_diff(np, "the ABI against capi_runtime.Predictor.run",
                          got, runtime(feed))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = handle.run(feed)[0]
            fetch_ms.append((time.perf_counter() - t0) * 1e3)
            _bits_or_diff(np, "the ABI against the prepared run", got, want)
            t0 = time.perf_counter()
            handle.run(feed, return_numpy=False)
            torch.cuda.synchronize()
            card_ms.append((time.perf_counter() - t0) * 1e3)
        if attentions != 18 or any(l != {"flash_fwd": attentions}
                                   for l in launches):
            raise AssertionError(f"phase 7t: launches a batch {launches}, "
                                 f"expected flash_fwd x {attentions} (18)")
        out.update(abi_ms=abi_ms, prepared_fetch_ms=fetch_ms,
                   prepared_card_ms=card_ms, launches=launches,
                   attentions=attentions, logits_bytes=first.nbytes)
        del rt, handle, scope
    finally:
        lib.PD_DestroyPredictor(pred)
    if out["embed_missing"] is not None:
        return out
    # the pure-C client, in a process of its own
    src = os.path.join(tmp, "client.c")
    with open(src, "w") as f:
        f.write(CAPI_CLIENT_SRC)
    exe_path = os.path.join(tmp, "client")
    t0 = time.perf_counter()
    subprocess.run(["gcc", "-O2", src, f"-I{capi.INCLUDE_DIR}", so,
                    "-lpthread", "-o", exe_path], check=True,
                   capture_output=True, text=True)
    out["client_build_s"] = time.perf_counter() - t0
    feed_path = os.path.join(tmp, "feed.bin")
    with open(feed_path, "wb") as f:
        f.write(batches[0]["src_word"].tobytes())
        f.write(batches[0]["trg_word"].tobytes())
    rows_path = os.path.join(tmp, "rows.bin")
    site = [p for p in sys.path if p.endswith(("site-packages",
                                               "dist-packages"))]
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [root] + site + [os.environ.get("PYTHONPATH", "")]),
               LD_LIBRARY_PATH=os.pathsep.join(
                   [os.path.dirname(so),
                    sysconfig.get_config_var("LIBDIR") or "",
                    os.environ.get("LD_LIBRARY_PATH", "")]))
    t0 = time.perf_counter()
    proc = subprocess.run([exe_path, model_dir, feed_path, str(CAPI_BATCH),
                           str(T), rows_path], env=env, capture_output=True,
                          text=True, timeout=CAPI_CLIENT_TIMEOUT)
    out["client_wall_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 7t: the C client exited "
                             f"{proc.returncode}:\n{proc.stdout}\n"
                             f"{proc.stderr[-4000:]}")
    said = dict(re.findall(r"^(created|first result) ([\d.]+) s$",
                           proc.stdout, re.M))
    out["client_create_s"] = float(said["created"])
    out["client_first_result_s"] = float(said["first result"])
    rows = np.fromfile(rows_path, np.float32).reshape(T, V)
    _bits_or_diff(np, "the C client's first row against the in-process "
                  "ABI's", rows, first[0])
    out["client_rows"] = 1
    return out


# phase 7u: the serving kernels at every head dim the JAX kernels take.
# serve-base with its heads changed only: serve-base-d8 (64 heads of 8, the
# JAX package's tiny LM's head dim) and serve-base-d256 (2 heads of 256),
# each with fp32 KV (phase 4's requests) and int8 KV (serve-base-int8's
# slots, blocks and requests), under phase 4's and 4b's gates. Their host
# references (the saves, the host's tokens and prefill logits, and the
# host side of the int8 arms' teacher-forced replay of the longest
# request) run in child processes on the host's cores alone
# (SERVE_HEADS_CHILD_THREADS torch threads in all), started before the build
# and waited for before phase 4: they overlap only the build and phase 3,
# whose times are CUDA-event times of the card, and no phase that times
# the host. The kernel checks run at SERVE_CHECK_DIMS: the widths of the
# padded instantiations (8, 16, 96, 256) and head dims padded into one
# (24 -> 32, 80 -> 96, 136 -> 256), at serve-base's width (H = 512 // D)
# and at T 8192 / seq_lens up to 8192 at D 8 and 256.
SERVE_HEADS = {8: 64, 256: 2}
SERVE_CHECK_DIMS = (8, 16, 24, 80, 96, 136, 256)
SERVE_LONG_T = 8192
# The host child is one process a head dim of SERVE_HEADS (their host
# serving is interpreter-bound, so two processes take about the time of
# the longer one where one took the sum: 93.7 s of waiting after phase 3
# on an H100's host with one), each at half the threads
SERVE_HEADS_CHILD_THREADS = 6
SERVE_HEADS_CHILD_TIMEOUT = 900


def _serve_heads_kw(head_dim, kv_dtype):
    """serve-base's signature with `head_dim`'s heads and `kv_dtype`'s
    residency (the int8 arm at serve-base-int8's slots)."""
    kw = dict(SERVE_BASE, n_heads=SERVE_HEADS[head_dim], kv_dtype=kv_dtype)
    if kv_dtype == "int8":
        kw["max_slots"] = INT8_SLOTS
    return kw


def _serve_heads_child_main(workdir, head_dim):
    """The host side of phase 7u, in processes of their own (no card),
    this one `head_dim`'s: save its arms' dirs under `workdir` (written to
    saved_d{head_dim}.json when both are), then serve each on CPUPlace:
    the tokens, the fp32 arm's prefill logits, the int8 arm's requantize
    events and the host side of the teacher-forced replay of the longest
    request (host_d{head_dim}.json and one .npz an arm)."""
    import numpy as np
    import torch
    torch.set_num_threads(SERVE_HEADS_CHILD_THREADS // len(SERVE_HEADS))
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import tiny_lm
    arms = {}
    fp_kw = _serve_heads_kw(head_dim, "fp32")
    fp_sig = tiny_lm.default_signature(**fp_kw)
    budget = fp_sig["num_blocks"] * ptt.serve.block_residency_nbytes(fp_sig)
    for kv in ("fp32", "int8"):
        kw = _serve_heads_kw(head_dim, kv)
        if kv == "int8":
            kw["num_blocks"] = 1 + ptt.serve.blocks_for_budget(
                tiny_lm.default_signature(**kw), budget)
        name = f"d{head_dim}_{kv}"
        mdir = os.path.join(workdir, name)
        sig = tiny_lm.save_tiny_lm(mdir, seed=WEIGHT_SEED, **kw)
        arms[name] = dict(mdir=mdir, head_dim=head_dim, kv_dtype=kv,
                          num_blocks=sig["num_blocks"],
                          budget_bytes=budget,
                          cache_bytes=sig["num_blocks"]
                          * ptt.serve.block_residency_nbytes(sig))
    _write_child_json(workdir, f"saved_d{head_dim}", arms)
    out = {}
    for name, arm in arms.items():
        t0 = time.perf_counter()
        int8 = arm["kv_dtype"] == "int8"
        prompts = prompts_for(SERVE_BASE["vocab"],
                              n=INT8_REQUESTS if int8 else N_REQUESTS)
        host = ptt.serve.InferenceServer(ptt.CPUPlace())
        try:
            hver = host.add_model(name, arm["mdir"], warm=False)
            res = serve_all(host, name, prompts, timeout=1800)
            rec = dict(tokens=[r.tokens for r in res])
            arrays = {}
            if int8:
                rec["requants"] = host.stats()["models"][name][
                    "kv_requant_events"]
                i = len(prompts) - 1
                logits, kv = teacher_forced(hver, prompts[i], res[i].tokens,
                                            INT8_SLOTS)
                arrays["tf_logits"] = logits
                rec["tf_vars"] = sorted(kv)
                for j, cname in enumerate(rec["tf_vars"]):
                    arrays[f"tf_q_{j}"], arrays[f"tf_s_{j}"] = kv[cname]
            else:
                arrays["prefill_logits"] = prefill_logits(hver, prompts[0],
                                                          128)
        finally:
            host.close()
        np.savez(os.path.join(workdir, f"{name}.npz"), **arrays)
        rec["s"] = time.perf_counter() - t0
        out[name] = rec
    _write_child_json(workdir, f"host_d{head_dim}", out)
    return 0


def _write_child_json(workdir, what, obj):
    """`obj` as workdir/what.json, whole or not at all."""
    with open(os.path.join(workdir, f"{what}.json.tmp"), "w") as f:
        json.dump(obj, f)
    os.replace(os.path.join(workdir, f"{what}.json.tmp"),
               os.path.join(workdir, f"{what}.json"))


def start_serve_heads_child():
    """Start phase 7u's host child, a process a head dim of
    SERVE_HEADS (no card visible to them), on a temporary directory; the
    exit of this script stops them and removes the directory. Returns
    ([(process, its log file)], directory)."""
    import atexit
    import shutil
    workdir = tempfile.mkdtemp(prefix="chip_smoke_heads_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = []
    for hd in SERVE_HEADS:
        logf = tempfile.TemporaryFile("w+")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--serve-heads-child", workdir, str(hd)],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=logf,
            stderr=subprocess.STDOUT, env=env), logf))

    def stop():
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    atexit.register(stop)
    return procs, workdir


def _read_serve_heads_child(child, what):
    """Wait for the child's `what` ('saved_d8', 'host_d256', ...);
    raise with a process's output if one failed."""
    procs, workdir = child
    path = os.path.join(workdir, f"{what}.json")
    deadline = time.perf_counter() + SERVE_HEADS_CHILD_TIMEOUT
    while not os.path.exists(path):
        for proc, logf in procs:
            if proc.poll() not in (None, 0):
                logf.seek(0)
                raise AssertionError(f"phase 7u: a host child exited "
                                     f"{proc.returncode}:\n"
                                     f"{logf.read()[-4000:]}")
        if all(proc.poll() is not None for proc, _ in procs) \
                and not os.path.exists(path):
            raise AssertionError(f"phase 7u: the host child ended without "
                                 f"{what}.json")
        if time.perf_counter() > deadline:
            for proc, _ in procs:
                proc.kill()
            raise AssertionError("phase 7u: the host child timed out")
        time.sleep(0.2)
    with open(path) as f:
        return json.load(f)


def _serve_heads_arm(torch, ptt, native, name, arm, host, fp32_tokens):
    """One arm of phase 7u on the card, held to phase 4's (fp32) or 4b's
    (int8) gates against the child's host run `host`. Returns its numbers
    and, for an fp32 arm, its tokens for serve-base-int8's prompts."""
    import numpy as np
    int8 = arm["kv_dtype"] == "int8"
    prompts = prompts_for(SERVE_BASE["vocab"],
                          n=INT8_REQUESTS if int8 else N_REQUESTS)
    kname = "paged_decode_q8" if int8 else "paged_decode"
    srv = ptt.serve.InferenceServer(ptt.CUDAPlace(0))
    try:
        ver = srv.add_model(name, arm["mdir"])
        sig = ver.decode.signature
        if int8:
            for cname in sig["cache_vars"]:
                if ver.scope.find_var(cname).dtype != torch.int8:
                    raise AssertionError(f"{name}: {cname} is not resident "
                                         f"as int8")
        before = srv.stats()["models"][name]
        native.reset_launches()
        t0 = time.perf_counter()
        results = serve_all(srv, name, prompts, timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(native.launches)
        after = srv.stats()["models"][name]
        n_prefill = after["prefill_steps"] - before["prefill_steps"]
        n_decode = after["steps"] - before["steps"]
        want = dict.fromkeys(launches, 0)
        want.update({"flash_fwd": sig["n_layers"] * n_prefill,
                     kname: sig["n_layers"] * n_decode})
        if launches != want or n_prefill < 1 or n_decode < 1:
            raise AssertionError(f"{name}: launches {launches}, expected "
                                 f"{want}")
        for p, r in zip(prompts, results):
            if len(r.tokens) != NEW_TOKENS or r.finish_reason != "length" \
                    or not all(0 <= t < sig["vocab"] for t in r.tokens):
                raise AssertionError(f"{name}: bad generation for a "
                                     f"{len(p)}-token prompt: {r}")
        out = dict(launches=launches, n_prefill=n_prefill, n_decode=n_decode,
                   wall_s=wall, head_dim=sig["head_dim"],
                   heads=sig["num_heads"],
                   tokens_per_s=sum(len(r.tokens) for r in results) / wall,
                   ttft_ms_median=sorted(r.ttft_us / 1e3 for r in results)[
                       len(results) // 2],
                   host_s=host["s"])
        arrays = np.load(os.path.join(os.path.dirname(arm["mdir"]),
                                      f"{name}.npz"))
        differing = [i for i, (r, h) in enumerate(zip(results,
                                                      host["tokens"]))
                     if r.tokens != h]
        if not int8:
            if differing:
                raise AssertionError(f"{name}: card tokens differ from the "
                                     f"host's for requests {differing}")
            card_logits = prefill_logits(ver, prompts[0], 128)
            if not np.isfinite(card_logits).all() \
                    or card_logits.shape != (1, sig["vocab"]):
                raise AssertionError(f"{name}: prefill logits not finite / "
                                     f"wrong shape")
            out["logit_err"] = float(np.abs(
                card_logits - arrays["prefill_logits"]).max())
            if not out["logit_err"] <= LOGIT_TOL:
                raise AssertionError(f"{name}: prefill logits card vs host "
                                     f"{out['logit_err']} > {LOGIT_TOL}")
            # what the float32 residency generates for the int8 prompts
            out["int8_prompt_tokens"] = [r.tokens for r in serve_all(
                srv, name, prompts_for(SERVE_BASE["vocab"],
                                       n=INT8_REQUESTS), timeout=600)]
            return out
        out["requants"] = after["kv_requant_events"] \
            - before["kv_requant_events"]
        out["host_requants"] = host["requants"]
        out["host_token_mismatches"] = len(differing)
        i = INT8_REQUESTS - 1
        hkv = {cname: (arrays[f"tf_q_{j}"], arrays[f"tf_s_{j}"])
               for j, cname in enumerate(host["tf_vars"])}
        accounts = [compare_teacher_forced(
            i, prompts[i], results[i].tokens, host["tokens"][i], ver, None,
            INT8_SLOTS, host_forced=(arrays["tf_logits"], hkv))]
        if differing:
            # a near-tie moved by an int8 rounding flip: replay it on a
            # host server here
            hsrv = ptt.serve.InferenceServer(ptt.CPUPlace())
            try:
                hver = hsrv.add_model(name + "_host", arm["mdir"], warm=False)
                accounts += [compare_teacher_forced(
                    k, prompts[k], results[k].tokens, host["tokens"][k], ver,
                    hver, INT8_SLOTS) for k in differing if k != i]
            finally:
                hsrv.close()
        out["teacher_forced"] = accounts
        firsts = sum(r.tokens[0] == t[0]
                     for r, t in zip(results, fp32_tokens))
        out["equal_to_fp32"] = sum(r.tokens == t
                                   for r, t in zip(results, fp32_tokens))
        if firsts != INT8_REQUESTS:
            raise AssertionError(f"{name}: an int8 request's first token "
                                 f"differs from the float32 run's: prefill "
                                 f"attends over exact K/V")
        return out
    finally:
        srv.close()


def finish_serve_heads_child(child):
    """Wait for phase 7u's host child to end; returns (arms, host): the
    saved arms and the host runs."""
    arms, host = {}, {}
    for hd in SERVE_HEADS:
        arms.update(_read_serve_heads_child(child, f"saved_d{hd}"))
        host.update(_read_serve_heads_child(child, f"host_d{hd}"))
    for proc, _ in child[0]:
        proc.wait(timeout=60)
    return arms, host


def run_serve_heads(torch, ptt, native, arms, host):
    """Phase 7u's serving: each arm on the card against the child's host
    run. Returns {arm: numbers}."""
    out = {}
    for hd in SERVE_HEADS:
        fp = _serve_heads_arm(torch, ptt, native, f"d{hd}_fp32",
                              arms[f"d{hd}_fp32"], host[f"d{hd}_fp32"],
                              None)
        q8 = _serve_heads_arm(torch, ptt, native, f"d{hd}_int8",
                              arms[f"d{hd}_int8"], host[f"d{hd}_int8"],
                              fp.pop("int8_prompt_tokens"))
        q8.update(cache_bytes=arms[f"d{hd}_int8"]["cache_bytes"],
                  budget_bytes=arms[f"d{hd}_int8"]["budget_bytes"])
        out[f"serve-base-d{hd}"] = fp
        out[f"serve-base-d{hd}-int8"] = q8
    return out


def check_serving_head_dims(torch, fa, pa, flush):
    """The three serving kernels at SERVE_CHECK_DIMS, as phase 3 checks
    them at D 64: the flash forward at serve-base's prefill shape (4 rows,
    T 512, causal, H = 512 // D) and on a ragged T 200 causal and not
    (rate 0.1); the paged pair at serve-base's and serve-base-int8's
    slots; then the long cases at D 8 and 256 (flash at T 8192, the paged
    pair over seq_lens up to 8192). Returns {kernel: {case: numbers}}."""
    out = {"flash_fwd": {}, "paged_decode": {}, "paged_decode_q8": {}}
    for D in SERVE_CHECK_DIMS:
        H = max(1, 512 // D)
        out["flash_fwd"][f"D{D}"] = dict(
            check_flash(torch, fa, flush, 4, 512, H=H, D=D), D=D, H=H)
        out["paged_decode"][f"D{D}"] = dict(
            check_paged(torch, pa, flush, H=H, Dh=D), D=D, H=H)
        out["paged_decode_q8"][f"D{D}"] = dict(
            check_paged_q8(torch, pa, flush, H=H, Dh=D), D=D, H=H)
    edges = check_flash_forward_edges(
        torch, fa, cases=tuple((f"ragged_d{D}", 4, 200, D, 1.0)
                               for D in SERVE_CHECK_DIMS))
    out["flash_fwd"]["ragged_T200"] = edges
    for D, H in ((8, 8), (256, 2)):
        out["flash_fwd"][f"D{D}_T{SERVE_LONG_T}"] = dict(
            check_flash(torch, fa, flush, 1, SERVE_LONG_T, H=H, D=D), D=D,
            H=H)
        H = 512 // D
        long_seq = (0, 1, 1000, 2049, 4096, 6000, 8000, SERVE_LONG_T)
        out["paged_decode"][f"D{D}_ctx{SERVE_LONG_T}"] = dict(
            check_paged(torch, pa, flush, seq=long_seq, H=H, Dh=D,
                        max_ctx=SERVE_LONG_T), D=D, H=H)
        out["paged_decode_q8"][f"D{D}_ctx{SERVE_LONG_T}"] = dict(
            check_paged_q8(torch, pa, flush, S=8, H=H, Dh=D,
                           max_ctx=SERVE_LONG_T,
                           NB=1 + 8 * (SERVE_LONG_T // 16)), D=D, H=H)
    return out


# phase 7v: the training kernels at every head dim the JAX kernels take.
# The four training kernels (the forward, dQ, dK/dV and delta) in float32
# and bf16 at TRAIN_CHECK_DIMS, as phase 3 and 3b check them at D 64:
# each against its plain version at train-base's attention (B 32, T 256,
# H = 512 // D; the times, plain and SDPA times and bounds of the first
# case, non-causal at rate 0.1, the others untimed), causal and not, rate
# 0 and 0.1, and on a ragged T 200 (B 4, causal, rate 0.1). Then
# train-base-d8 (64 heads of 8) and train-base-d256 (2 heads of 256),
# train-base with its heads changed only, TRAIN_HEADS_STEPS steps in
# float32 and under AMP through run_train_base (loss falling, launches
# exact); then card against host by run_step_parity at
# TRAIN_HEADS_PARITY's depth and batch: one step from one state, its loss
# and every persistable after it (the Adam slots carry the grads). Its
# host side runs here, not in phase 7u's child: the child would ship the
# host's state after the step, about 0.6 GB at the 30000-word
# vocabularies, for each side, and two free-running steps are no check
# under AMP (on an H100 at 700 W the d256 AMP losses' second step lay
# 9.2e-5 from the host's, at 5e-5 allowed, its first 2.3e-6: Adam's first
# update is lr x the sign of each grad, which bf16 rounding flips where a
# grad is near 0).
TRAIN_HEADS = {8: 64, 256: 2}
TRAIN_CHECK_DIMS = SERVE_CHECK_DIMS
TRAIN_CHECK_CASES = ((False, 0.1), (True, 0.1), (False, 0.0), (True, 0.0))
TRAIN_HEADS_STEPS = 5
TRAIN_HEADS_PARITY = dict(n_layer=1, batch=PARITY_BATCH, steps=1)


def _train_heads_model(head_dim, depth=False):
    """train-base's overrides at `head_dim` (and, with `depth`, at
    TRAIN_HEADS_PARITY's depth, dropout 0)."""
    kw = {"n_head": TRAIN_HEADS[head_dim]}
    if depth:
        kw.update(n_layer=TRAIN_HEADS_PARITY["n_layer"], dropout_rate=0.0)
    return kw


def check_training_head_dims(torch, fa, flush):
    """The training kernels at TRAIN_CHECK_DIMS in both dtypes (phase 7v,
    above). Returns {dtype: {D: {case: numbers}}}."""
    out = {"float32": {}, "bfloat16": {}}
    for D in TRAIN_CHECK_DIMS:
        H = max(1, 512 // D)
        for dtype, check in (("float32", check_train_kernels),
                             ("bfloat16", check_train_kernels_bf16)):
            cases = {}
            for i, (causal, rate) in enumerate(TRAIN_CHECK_CASES):
                cases[f"{'causal' if causal else 'full'}_rate{rate}"] = \
                    check(torch, fa, flush, TRAIN_BATCH, H, 256, D, causal,
                          rate, timed=i == 0)
            cases["ragged_T200"] = check(torch, fa, flush, 4, H, 200, D,
                                         True, 0.1, timed=False)
            out[dtype][f"D{D}"] = cases
            torch.cuda.empty_cache()
    return out


def run_train_heads(torch, ptt, native):
    """train-base-d8 and -d256, TRAIN_HEADS_STEPS steps in float32 and
    under AMP each (run_train_base's gates). Returns {name: numbers}."""
    out = {}
    for hd in TRAIN_HEADS:
        for amp in (False, True):
            out[f"train-base-d{hd}{'-amp' if amp else ''}"] = run_train_base(
                torch, ptt, native, "auto", amp=amp, steps=TRAIN_HEADS_STEPS,
                model=_train_heads_model(hd))
            gc.collect()
            torch.cuda.empty_cache()
    return out


def run_train_heads_parity(torch, ptt):
    """train-base-d8 and -d256 at TRAIN_HEADS_PARITY's depth and batch,
    dropout 0, card against host by run_step_parity, in float32 and under
    AMP (an Adam step: sign_updates). Returns {head dim: {float32, amp}}."""
    out = {}
    feed = train_batch(TRAIN_HEADS_PARITY["batch"])
    for hd in TRAIN_HEADS:
        main, startup, loss = build_train(ptt, **_train_heads_model(hd, True))
        out[hd] = {side: run_step_parity(
            torch, ptt, f"train-base-d{hd}{'-amp' if amp else ''}", main,
            startup, loss, feed, TRAIN_HEADS_PARITY["steps"], amp=amp,
            sign_updates=True)
            for side, amp in (("float32", False), ("amp", True))}
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch as ptt
        from paddle_tpu_torch.models import tiny_lm
        from paddle_tpu_torch.ops import dropout_kernel as dk
        from paddle_tpu_torch.ops import flash_attention as fa
        from paddle_tpu_torch.ops import native
        from paddle_tpu_torch.ops import paged_attention as pa
    except ImportError as e:
        print(f"chip_smoke: paddle_tpu_torch is not importable here ({e}); "
              f"run from the root of a checkout", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(ptt.__file__)))
    if pkg_root != here:
        print(f"chip_smoke: imported paddle_tpu_torch from {pkg_root}, not "
              f"from the checkout beside this script ({here})",
              file=sys.stderr)
        return 2
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")

    # phase 7u's host side, beside the build and the kernel checks and
    # over before phase 4
    heads_child = start_serve_heads_child()

    # 2. build
    native.lib()
    info = native.build_info
    log(f"build: {info.seconds:.2f} s -> {os.path.relpath(info.path)}")
    for line in info.log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error", "==")):
            log("  " + line.strip())
    flash_build = flash_build_report(native)
    for inst, r in sorted(flash_build.items()):
        log(f"{inst}: {r.get('registers', 'not reported')} registers, "
            f"{r.get('spill_bytes', 'not reported')} bytes spilled, "
            f"{r['smem_bytes']} bytes of shared memory a block, {r['hmma']} "
            f"HMMA and {r['hgmma']} HGMMA instructions (cuobjdump -sass)")
    # the bf16 flash kernels run their products as wgmma, none as
    # mma.sync
    for inst, r in flash_build.items():
        if inst.startswith(("flash_fwd_bf16", "flash_dq_bf16",
                            "flash_dkv_bf16")) \
                and not (r["hgmma"] > 0 and r["hmma"] == 0):
            raise AssertionError(f"{inst}: {r['hmma']} HMMA and {r['hgmma']} "
                                 f"HGMMA instructions, expected wgmma only")
    # ptxas serializes every wgmma of a kernel where it cannot keep them
    # asynchronous (C7500-C7519: a wgmma on a conditional path, an
    # accumulator or register-A operand touched between issue and wait)
    wgmma_warnings = [line.strip() for line in info.log.splitlines()
                      if re.search(r"C75[01]\d", line)]
    log(f"ptxas wgmma serialization warnings: {len(wgmma_warnings)}")
    for line in wgmma_warnings:
        log("  " + line)
    paged_build = paged_build_report(native)
    for inst, r in sorted(paged_build.items()):
        log(f"{inst}: {r.get('registers', 'not reported')} registers, "
            f"{r.get('spill_bytes', 'not reported')} bytes spilled, "
            f"{r['smem_bytes']} bytes of static shared memory a block")

    t_phase3 = time.perf_counter()

    # 3. kernels vs their plain versions
    flush = _l2_flusher(torch)
    flash_cases = [check_flash(torch, fa, flush, r, T)
                   for r in (1, 2, 4) for T in (128, 256, 512)]
    flash_cases.append(check_flash(torch, fa, flush, 3, 200))   # ragged T
    for c in flash_cases:
        log(f"flash_fwd rows={c['rows']} T={c['T']} H=8 D=64 causal: "
            f"max_abs_err {c['err']:.3g} (tol {TOL}), two launches bit-equal, "
            f"kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms sdpa "
            f"{c['library_ms']:.4f} ms bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']} at 3xTF32; {c['bound_cuda_core_ms']:.4f} ms on "
            f"the f32 CUDA cores) [{card}]")
    fwd_edges = check_flash_forward_edges(torch, fa)
    log(f"flash_fwd on peaked scores and at T 200 for D 32/64/128, causal and "
        f"not, rate 0.1: max_abs_err {fwd_edges} (tol {TOL}), two launches "
        f"bit-equal")
    paged = check_paged(torch, pa, flush)
    paged_s1 = check_paged(torch, pa, flush, seq=(1024,), seed=SEED + 100)
    paged_q8 = check_paged_q8(torch, pa, flush)
    paged_q8_s1 = check_paged_q8(torch, pa, flush, seq=(1024,))
    # below what no time of this method goes: one launch of a one-element
    # kernel, and each paged pair over its grid with every chunk dead
    tiny = torch.zeros(1, device="cuda")
    floor_ms = time_ms(torch, lambda: tiny.zero_(), flush)
    paged_dead = check_paged(torch, pa, flush, seq=(0,) * 8)
    paged_q8_dead = check_paged_q8(torch, pa, flush, seq=(0,) * INT8_SLOTS)
    log(f"timing floor: one launch of a one-element kernel {floor_ms:.4f} "
        f"ms; the paged kernels with every chunk dead (seq_lens 0): "
        f"paged_decode S=8 {paged_dead['ms']:.4f} ms "
        f"({paged_dead['split']['grid_blocks']} split blocks), "
        f"paged_decode_q8 S={INT8_SLOTS} {paged_q8_dead['ms']:.4f} ms "
        f"({paged_q8_dead['split']['grid_blocks']} split blocks) [{card}]")
    for name, c in (("paged_decode", paged), ("paged_decode", paged_s1),
                    ("paged_decode_q8", paged_q8),
                    ("paged_decode_q8", paged_q8_s1)):
        sp = c["split"]
        lens = (f"seq_lens={c['seq_lens']}" if "seq_lens" in c else
                f"seq_lens {c['seq_min']}..{c['seq_max']}")
        log(f"{name} S={c['S']} H=8 Dh=64 BS=16 {lens} (sum {c['total']})"
            f"{', dead blocks scales NaN' if name.endswith('q8') else ''}: "
            f"max_abs_err {c['err']:.3g} (tol {TOL}), two launches "
            f"bit-equal, kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms "
            f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}); P {sp['P']}, "
            f"NSPLIT {sp['nsplit']}, {sp['live_blocks']} live of "
            f"{sp['grid_blocks']} split blocks [{card}]")
    drop_cases = [check_dropout_kernel(torch, dk, flush, shape)
                  for shape in ((TRAIN_BATCH, 256, 512),
                                (TRAIN_BATCH, 256, 2048),
                                (TRAIN_BATCH, 8, 256, 256))]
    for c in drop_cases:
        log(f"dropout {c['shape']} rate {c['rate']} f32, Out, Mask and dX "
            f"equal to the plain version's bit for bit ({c['kept']:.4f} "
            f"kept): forward as train-base runs it (no Mask) "
            f"{c['op_ms']:.4f} ms (bound {c['bwd_bound_ms']:.4f} ms, "
            f"{c['bwd_bound_by']}), with Mask {c['fwd_ms']:.4f} ms (bound "
            f"{c['fwd_bound_ms']:.4f} ms, {c['fwd_bound_by']}), on dy "
            f"{c['bwd_ms']:.4f} ms (bound {c['bwd_bound_ms']:.4f} ms), plain "
            f"{c['plain_ms']:.4f} ms, F.dropout {c['library_ms']:.4f} ms "
            f"[{card}]")
    train_cases = [check_train_kernels(torch, fa, flush, TRAIN_BATCH, 8, T, 64,
                                       causal, rate)
                   for T, causal, rate in ((256, False, 0.1), (256, True, 0.1),
                                           (256, False, 0.0), (256, True, 0.0),
                                           (200, True, 0.1))]
    for c in train_cases:
        log(f"train kernels B={c['B']} H={c['H']} T={c['T']} D={c['D']} "
            f"causal={c['causal']} rate={c['rate']} [{card}]:")
        log(f"  flash_fwd max_abs_err {c['fwd_err']:.3g} (tol {TOL}), two "
            f"launches bit-equal, kernel {c['fwd_ms']:.4f} ms plain "
            f"{c['fwd_plain_ms']:.4f} ms sdpa {c['fwd_library_ms']:.4f} ms "
            f"bound {c['fwd_bound_ms']:.4f} ms ({c['fwd_bound_by']} at "
            f"3xTF32; {c['fwd_bound_f32_ms']:.4f} ms on the f32 CUDA cores)")
        for name in ("dq", "dkv"):
            log(f"  flash_{name} max_abs_err {c[name + '_err']:.3g} (tol "
                f"{BWD_TOL}*(1+|plain|)), two launches bit-equal, kernel "
                f"{c[name + '_ms']:.4f} ms bound {c[name + '_bound_ms']:.4f} "
                f"ms ({c[name + '_bound_by']} at 3xTF32, 495/3 TFLOP/s; "
                f"{c[name + '_bound_f32_ms']:.4f} ms on the f32 CUDA cores)")
        log(f"  flash_delta {c['delta_share']:.3g} of its tolerance "
            f"({DELTA_TOL} x sum |dO O| a row), two launches bit-equal, "
            f"kernel {c['delta_ms']:.4f} ms plain {c['delta_plain_ms']:.4f} "
            f"ms vecdot {c['delta_library_ms']:.4f} ms bound "
            f"{c['delta_bound_ms']:.4f} ms ({c['delta_bound_by']})")
        log(f"  dq + dkv {c['dq_ms'] + c['dkv_ms']:.4f} ms; backward plain "
            f"(dq, dk, dv) {c['bwd_plain_ms']:.4f} ms; sdpa backward at rate "
            f"0 (dq, dk, dv) {c['bwd_library_ms']:.4f} ms")
    dropped = check_dropout_mask(torch, fa)
    log(f"dropout mask of flash_fwd, flash_dq and flash_dkv equal to the plain "
        f"version's bit for bit (rate 0.5, {dropped:.4f} dropped)")

    # 3b. the bf16 instantiations (bf16 mixed precision)
    bf16_cases = [check_train_kernels_bf16(torch, fa, flush, TRAIN_AMP_BATCH,
                                           8, 256, 64, causal, rate)
                  for causal, rate in ((False, 0.1), (True, 0.1),
                                       (False, 0.0), (True, 0.0))]
    for c in bf16_cases:
        log(f"bf16 train kernels B={c['B']} H={c['H']} T={c['T']} D={c['D']} "
            f"causal={c['causal']} rate={c['rate']} [{card}]:")
        log(f"  flash_fwd_bf16 max_abs_err {c['fwd_err']:.3g} "
            f"({c['fwd_share']:.3g} of its tolerance), lse "
            f"{c['lse_err']:.3g} (tol {LSE_TOL}), two launches bit-equal, "
            f"kernel {c['fwd_ms']:.4f} ms plain {c['fwd_plain_ms']:.4f} ms "
            f"sdpa bf16 {c['fwd_library_ms']:.4f} ms bound "
            f"{c['fwd_bound_ms']:.4f} ms ({c['fwd_bound_by']}, bf16 at 989 "
            f"TFLOP/s)")
        for name in ("dq", "dkv"):
            log(f"  flash_{name}_bf16 max_abs_err {c[name + '_err']:.3g} "
                f"({c[name + '_share']:.3g} of its tolerance), "
                f"two launches bit-equal, kernel {c[name + '_ms']:.4f} ms "
                f"bound {c[name + '_bound_ms']:.4f} ms "
                f"({c[name + '_bound_by']})")
        log(f"  flash_delta_bf16 {c['delta_share']:.3g} of its tolerance "
            f"({DELTA_TOL} x sum |dO O| a row), two launches bit-equal, "
            f"kernel {c['delta_ms']:.4f} ms plain (three PyTorch passes) "
            f"{c['delta_plain_ms']:.4f} ms bound {c['delta_bound_ms']:.4f} "
            f"ms ({c['delta_bound_by']})")
        log(f"  dq + dkv bf16 {c['dq_ms'] + c['dkv_ms']:.4f} ms, + delta "
            f"{c['dq_ms'] + c['dkv_ms'] + c['delta_ms']:.4f} ms; "
            f"_flash_backward (delta, dq, dkv as autograd launches them) "
            f"{c['backward_ms']:.4f} ms; backward plain "
            f"{c['bwd_plain_ms']:.4f} ms; sdpa bf16 backward at dropout_p "
            f"{c['rate']} {c['bwd_library_ms']:.4f} ms, at 0 "
            f"{c['bwd_library_rate0_ms']:.4f} ms")
    dropped_bf16 = check_dropout_mask(torch, fa, dtype="bfloat16")
    log(f"dropout mask of flash_fwd_bf16, flash_dq_bf16 and flash_dkv_bf16 "
        f"equal to the plain version's bit for bit (rate 0.5, "
        f"{dropped_bf16:.4f} dropped)")
    drop_cases_bf16 = [check_dropout_kernel(torch, dk, flush, shape,
                                            dtype="bfloat16")
                       for shape in ((TRAIN_AMP_BATCH, 256, 512),
                                     (TRAIN_AMP_BATCH, 256, 2048),
                                     (TRAIN_AMP_BATCH, 8, 256, 256))]
    for c in drop_cases_bf16:
        log(f"dropout {c['shape']} rate {c['rate']} bf16 (scale "
            f"{c['scale']}), Out, Mask and dX equal to the plain version's "
            f"bit for bit, keep bits equal to the float32 kernel's "
            f"({c['kept']:.4f} kept): forward without Mask {c['op_ms']:.4f} "
            f"ms (bound {c['bwd_bound_ms']:.4f} ms, {c['bwd_bound_by']}), "
            f"with Mask {c['fwd_ms']:.4f} ms (bound {c['fwd_bound_ms']:.4f} "
            f"ms), on dy {c['bwd_ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
            f"F.dropout bf16 {c['library_ms']:.4f} ms [{card}]")

    t0 = time.perf_counter()
    heads_arms, heads_host = finish_serve_heads_child(heads_child)
    log(f"phase 3: {t0 - t_phase3:.1f} s; phase 7u's host child, started "
        f"before the build, ended {time.perf_counter() - t0:.1f} s after it "
        f"(arms "
        + ", ".join(f"{k} {v['s']:.1f} s" for k, v in heads_host.items())
        + f"); total so far {time.perf_counter() - t_start:.1f} s")

    # 4. the serving path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        mdir = os.path.join(tmp, "serve_base")
        t0 = time.perf_counter()
        sig = tiny_lm.save_tiny_lm(mdir, seed=WEIGHT_SEED, **SERVE_BASE)
        log(f"saved serve-base tiny_lm in {time.perf_counter() - t0:.1f} s")
        prompts = prompts_for(sig["vocab"])

        srv = ptt.serve.InferenceServer(ptt.CUDAPlace(0))
        try:
            t0 = time.perf_counter()
            ver = srv.add_model("lm", mdir)
            torch.cuda.synchronize()
            log(f"load + verify + warm on the card: "
                f"{time.perf_counter() - t0:.2f} s")
            before = srv.stats()["models"]["lm"]
            native.reset_launches()
            t0 = time.perf_counter()
            results = serve_all(srv, "lm", prompts, timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(native.launches)
            if launches["flash_dq"] or launches["flash_dkv"] \
                    or launches["flash_delta"]:
                raise AssertionError(f"serving launched a backward kernel: "
                                     f"{launches}")
            after = srv.stats()["models"]["lm"]
            card_logits = prefill_logits(ver, prompts[0], 128)
            # what the float32 residency generates for the int8 phase's
            # prompts (outside the counted and timed window)
            fp32_tokens = [r.tokens for r in serve_all(
                srv, "lm", prompts_for(sig["vocab"], n=INT8_REQUESTS),
                timeout=600)]
        finally:
            srv.close()
        n_prefill = after["prefill_steps"] - before["prefill_steps"]
        n_decode = after["steps"] - before["steps"]
        n_layers = sig["n_layers"]
        log(f"served {N_REQUESTS} requests: {n_prefill} prefill steps, "
            f"{n_decode} decode steps, launches {launches}")
        if launches["flash_fwd"] != n_layers * n_prefill or n_prefill < 1:
            raise AssertionError(
                f"flash_fwd launched {launches['flash_fwd']} times, expected "
                f"{n_layers} x {n_prefill} prefill steps")
        if launches["paged_decode"] != n_layers * n_decode or n_decode < 1:
            raise AssertionError(
                f"paged_decode launched {launches['paged_decode']} times, "
                f"expected {n_layers} x {n_decode} decode steps")
        for p, r in zip(prompts, results):
            if len(r.tokens) != NEW_TOKENS or r.finish_reason != "length" \
                    or not all(0 <= t < sig["vocab"] for t in r.tokens):
                raise AssertionError(f"bad generation for a {len(p)}-token "
                                     f"prompt: {r}")
        if not np.isfinite(card_logits).all() \
                or card_logits.shape != (1, sig["vocab"]):
            raise AssertionError("prefill logits not finite / wrong shape")
        ttft = sorted(r.ttft_us / 1e3 for r in results)
        gen_tokens = sum(len(r.tokens) for r in results)
        log(f"serve-base on the card [{card}]: TTFT median "
            f"{ttft[len(ttft) // 2]:.1f} ms max {ttft[-1]:.1f} ms; "
            f"{gen_tokens} tokens in {wall:.3f} s = "
            f"{gen_tokens / wall:.1f} tokens/s; decode steps "
            f"{n_decode} ({(wall * 1e3) / max(n_decode, 1):.2f} ms/step "
            f"incl. prefills)")

        # the same dir on the host: tokens must agree
        t0 = time.perf_counter()
        host = ptt.serve.InferenceServer(ptt.CPUPlace())
        try:
            hver = host.add_model("lm_host", mdir, warm=False)
            host_results = serve_all(host, "lm_host", prompts, timeout=900)
            host_logits = prefill_logits(hver, prompts[0], 128)
        finally:
            host.close()
        log(f"host reference run: {time.perf_counter() - t0:.1f} s")
        for i, (a, b) in enumerate(zip(results, host_results)):
            if a.tokens != b.tokens:
                raise AssertionError(
                    f"request {i}: card tokens {a.tokens} != host tokens "
                    f"{b.tokens}")
        logit_err = float(np.abs(card_logits - host_logits).max())
        if not logit_err <= LOGIT_TOL:
            raise AssertionError(f"prefill logits card vs host: max error "
                                 f"{logit_err} > {LOGIT_TOL}")
        log(f"tokens equal to the host run for all {N_REQUESTS} requests; "
            f"prefill logits max_abs_err {logit_err:.3g} (tol {LOGIT_TOL})")

        # 4b. the int8 residency
        serve8 = run_serve_int8(torch, ptt, native, tiny_lm, tmp, card,
                                fp32_tokens)
        q8_arm = serve8.pop("torrent_arm")

        # 4c. serve-base-swap: a generative hot swap under load
        t0 = time.perf_counter()
        swap = run_serve_base_swap(torch, ptt, native, tiny_lm, tmp, mdir, sig)
        log(f"serve-base-swap on the card [{card}]: {len(SWAP_V1_LENS)} "
            f"requests x {SWAP_V1_TOKENS} tokens on v1, first tokens out in "
            f"{swap['first_tokens_s']:.2f} s; prepare_swap (v2 load + verify "
            f"+ warm, under load) {swap['prepare_s']:.2f} s; "
            f"{swap['active_at_commit']} v1 requests still decoding at "
            f"commit_swap, drained {swap['drain_s']:.2f} s after it; "
            f"{len(SWAP_V2_LENS)} v2 requests x {SWAP_V2_TOKENS} tokens done "
            f"{swap['swap_to_v2_done_s']:.2f} s after the commit (v2 TTFT "
            f"{[round(x, 1) for x in swap['v2_ttft_ms']]} ms); runs "
            f"{swap['runs']}; launches by version "
            f"{swap['launches_by_version']}; tokens equal to the host's on "
            f"both versions (host {swap['host_s']:.1f} s); v1 retired; "
            f"{time.perf_counter() - t0:.1f} s")

        # 7s. disaggregated serving and the fleet, over 4b's int8 dir and
        # phase 4's float32 dir (run here, while phase 4's dirs exist)
        gc.collect()
        torch.cuda.empty_cache()
        tor = run_serve_base_torrent(
            torch, ptt, native, q8_arm,
            dict(name="lm", mdir=mdir, sig=sig, prompts=prompts,
                 tokens=[r.tokens for r in results]))
        log_serve_base_torrent(tor, card)

    # 4d. serve-resnet50: one-shot serving at ResNet-50's full width, with
    # a staged swap and a watcher swap in the same traffic
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rn50_") as tmp:
        rn50 = run_serve_resnet50(torch, ptt, native, tmp)
    gib = {k: round(v / 2**30, 3) for k, v in rn50["peak_bytes"].items()}
    log(f"serve-resnet50 on the card [{card}]: {rn50['requests']} requests "
        f"({rn50['images']} images of 224 x 224 x 3, 1-"
        f"{SERVE_RN50_MAX_IMAGES} a request) from {SERVE_RN50_CLIENTS} "
        f"closed-loop clients in {rn50['wall_s']:.2f} s = "
        f"{rn50['images_per_s']:.1f} images/s ({rn50['steady_images_per_s']:.1f} "
        f"over the first half, before any swap); latency p50 "
        f"{rn50['p50_ms']:.1f} ms p99 {rn50['p99_ms']:.1f} ms; "
        f"{rn50['batches']} batches, average occupancy "
        f"{rn50['avg_occupancy']:.2f} requests, average padding waste "
        f"{rn50['avg_padding_waste']:.4f}; peak device memory GiB {gib} "
        f"(torch.cuda.max_memory_allocated; steady traffic, the v2 swap "
        f"window, the v3 watcher window); requests by version "
        f"{rn50['by_version']}; load + verify + warm {rn50['load_s']:.2f} s, "
        f"prepare_swap under load {rn50['prepare_s']:.2f} s, save + watcher "
        f"swap {rn50['watch_s']:.2f} s; launches {rn50['launches']}")
    log(f"serve-resnet50 checks: probes {SERVE_RN50_PROBES} card vs host, "
        f"coalesced (one batch of {SERVE_RN50_LADDER[-1]}) vs solo, and "
        f"after each flip vs the host's version: top-1 equal, largest share "
        f"of the tolerances (probabilities {SERVE_RN50_PROB_TOL}, "
        f"log-probabilities above {SERVE_RN50_LOGP_FLOOR} "
        f"{SERVE_RN50_LOGP_TOL} (1 + |log p|)) "
        f"{ {k: float(f'{v:.3g}') for k, v in rn50['errors'].items()} }; "
        f"0 failed requests; v1 and v2 retired; "
        f"host {rn50['host_s']:.1f} s, build and saves {rn50['build_s']:.1f} "
        f"s; {time.perf_counter() - t0:.1f} s")

    # 5. train-base on the card, with the bits dropout and with the kernel
    trains = {}
    for impl in ("auto", "pallas"):
        t0 = time.perf_counter()
        trains[impl] = train = run_train_base(torch, ptt, native, impl)
        log(f"train-base (dropout_impl={impl}): {TRAIN_STEPS} steps of batch "
            f"{TRAIN_BATCH} x {TRAIN_BASE['seq_len']} in "
            f"{time.perf_counter() - t0:.1f} s (build and startup included); "
            f"losses {[round(x, 4) for x in train['losses']]}")
        log(f"train-base (dropout_impl={impl}) on the card [{card}]: step "
            f"{train['step_ms_median']:.1f} ms (median of the last 5; all: "
            f"{[round(x, 1) for x in train['step_ms']]}), "
            f"{train['tokens_per_s']:.0f} tokens/s, peak memory "
            f"{train['peak_bytes'] / 2**30:.2f} GiB "
            f"(torch.cuda.max_memory_allocated), launches "
            f"{train['launches']} over {TRAIN_STEPS} steps "
            f"({train['gated_dropout_ops']} dropout ops pass the gate; "
            f"{train['launches']['dropout_mask']} launches wrote a Mask)")
    train = trains["auto"]
    log(f"train-base, dropout_impl pallas against auto [{card}]: step "
        f"{trains['pallas']['step_ms_median']:.1f} vs "
        f"{train['step_ms_median']:.1f} ms, "
        f"{trains['pallas']['tokens_per_s']:.0f} vs "
        f"{train['tokens_per_s']:.0f} tokens/s, peak "
        f"{trains['pallas']['peak_bytes'] / 2**30:.2f} vs "
        f"{train['peak_bytes'] / 2**30:.2f} GiB")

    # 6. train parity, card vs host
    parities = []
    for rate, impl in ((0.0, "auto"), (TRAIN_BASE["dropout_rate"], "pallas")):
        t0 = time.perf_counter()
        parity = run_train_parity(torch, ptt, rate, impl)
        parities.append(parity)
        log(f"train parity at dropout {rate} (dropout_impl={impl}), batch "
            f"{PARITY_BATCH}: card {parity['losses']['card']} host "
            f"{parity['losses']['host']}, max relative error "
            f"{parity['rel_err']:.3g} (tol {LOSS_RTOL}); "
            f"{time.perf_counter() - t0:.1f} s")

    # 6b. train-resnet50 on the card, then card vs host for ResNet-50 and
    # the MNIST CNN
    t0 = time.perf_counter()
    resnet = run_train_resnet50(torch, ptt, native)
    log(f"train-resnet50: {RESNET_STEPS} steps of batch {RESNET_BATCH} x "
        f"224 x 224 x 3 NHWC, Momentum({RESNET_LR}, {RESNET_MOMENTUM}), "
        f"{resnet['ops']} ops a step, in {time.perf_counter() - t0:.1f} s "
        f"(build and startup included); losses "
        f"{[round(x, 4) for x in resnet['losses']]}; launches "
        f"{resnet['launches']}")
    log(f"train-resnet50 on the card [{card}]: step "
        f"{resnet['step_ms_median']:.1f} ms (median of the last 5; all: "
        f"{[round(x, 1) for x in resnet['step_ms']]}), "
        f"{resnet['samples_per_s']:.1f} images/s, peak memory "
        f"{resnet['peak_bytes'] / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); float32 bound "
        f"{resnet['bound_ms']:.1f} ms ({resnet['step_flop'] / 1e12:.3f} "
        f"TFLOP a step = 3 x 2 x {resnet['macs_per_sample'] / 1e9:.3f} G "
        f"multiply-adds an image x {RESNET_BATCH}, at 67 TFLOP/s), "
        f"{resnet['bound_share']:.3f} of it")
    t0 = time.perf_counter()
    vision_parity = run_resnet50_and_mnist_parity(torch, ptt)
    for name, par in vision_parity.items():
        log(f"{name} parity, {par['steps']} steps from the host's state: "
            f"card {par['losses']['card']} host {par['losses']['host']}, "
            f"max relative error {par['rel_err']:.3g} (tol {LOSS_RTOL}); "
            f"{par['n_stats']} running stats at {par['stat_share']:.3g} of "
            f"their tolerance ({BN_STAT_ATOL} + {LOSS_RTOL} |host|), the "
            f"other persistables at {par['l2_share']:.3g} of "
            f"{STATE_L2_RTOL} relative L2")
    log(f"vision parity: {time.perf_counter() - t0:.1f} s")

    # 6c. train-resnet50-reader: train-resnet50 from a RecordIO file through
    # Trainer.train, AsyncFeeder (float32 and AMP) and py_reader
    t0 = time.perf_counter()
    rdr = run_train_resnet50_reader(torch, ptt, native,
                                    resnet["step_ms_median"])
    rdr["phase_s"] = time.perf_counter() - t0
    w = rdr["write"]
    log(f"train-resnet50-reader: wrote {READER_SAMPLES} samples "
        f"({w['bytes'] / 1e6:.1f} MB) with convert_reader_to_recordio_file "
        f"in {w['seconds']:.2f} s, {w['codec']} codec")
    for name, r in rdr["trainer"].items():
        log(f"train-resnet50-reader Trainer.train ({name}, from step "
            f"{r['first_step']}, cuDNN deterministic) on the card [{card}]: "
            f"{r['steps']} steps in {r['train_s']:.1f} s (build and startup "
            f"{r['build_s']:.1f} s), step {_median(r['step_ms']):.1f} ms "
            f"(median; all: {[round(x, 1) for x in r['step_ms']]}); serials "
            f"kept {r['serials']}; losses {[round(x, 4) for x in r['losses']]}")
    log(f"train-resnet50-reader resume: the Trainer resumed from step "
        f"{rdr['trainer']['resumed']['first_step']} fetched the "
        f"uninterrupted run's losses bit for bit")
    h = rdr["h2d"]
    log(f"train-resnet50-reader H2D of one batch's images "
        f"({h['bytes'] / 1e6:.1f} MB) on the card [{card}]: pageable "
        f"{h['pageable']:.2f} ms ({h['bytes'] / h['pageable'] / 1e6:.1f} "
        f"GB/s), pinned on a side stream {h['pinned']:.2f} ms "
        f"({h['bytes'] / h['pinned'] / 1e6:.1f} GB/s) (CUDA events, median "
        f"of 5); host copy into the pinned buffer {h['host_to_pinned']:.2f} "
        f"ms; DataFeeder's stacking of the batch {h['stack_ms']:.1f} ms")
    for name, r in rdr["async"].items():
        log(f"train-resnet50-reader AsyncFeeder ({name}) on the card "
            f"[{card}]: steady step {r['step_ms_median']:.1f} ms (median of "
            f"{READER_STEPS} after {READER_WARMUP} warm-up and "
            f"{READER_FILL} fill steps; all: "
            f"{[round(x, 1) for x in r['step_ms']]}), "
            f"{r['images_per_s']:.1f} images/s; consumer wait "
            f"{r['wait_ms_mean']:.2f} ms a step, starved "
            f"{r['starved_steady']} of {READER_STEPS}; producer "
            f"{r['produce_ms_mean']:.1f} ms a batch (DataFeeder + pinned "
            f"copy + H2D issue); {r['pinned_allocs']} pinned buffers; the "
            f"same step on a staged batch {r['staged_ms_median']:.1f} ms: "
            f"the feed costs {r['loss_to_staged_ms']:+.1f} ms a steady "
            f"step; fill / steady / drain medians "
            f"{r['fill_ms_median']:.1f} / {r['step_ms_median']:.1f} / "
            f"{r['drain_ms_median']:.1f} ms (fill "
            f"{r['fill_to_staged_ms']:+.1f} over staged), the other "
            f"threads' CPU time in them {r['fill_other_cpu_ms']:.1f} / "
            f"{r['steady_other_cpu_ms']:.1f} / "
            f"{r['drain_other_cpu_ms']:.1f} ms a step (all: "
            f"{[round(x, 1) for x in r['other_cpu_ms']]}); queue depth at "
            f"each arrival {r['depths']}")
    log(f"train-resnet50-reader AsyncFeeder fp32 against 6b's staged step "
        f"of this call ({rdr['staged_6b_ms']:.1f} ms): "
        f"{rdr['async']['fp32']['step_ms_median'] - rdr['staged_6b_ms']:+.1f}"
        f" ms a step")
    for i, p in enumerate(rdr["py_reader"]["passes"]):
        log(f"train-resnet50-reader py_reader pass {i + 1} on the card "
            f"[{card}]: {len(p['losses'])} steps to EOFException, step "
            f"{p['step_ms_median']:.1f} ms (median after the first; all: "
            f"{[round(x, 1) for x in p['step_ms']]}); losses "
            f"{[round(x, 4) for x in p['losses']]}")
    log(f"train-resnet50-reader: no kernel of csrc/ launched "
        f"({rdr['launches']}); phase {rdr['phase_s']:.1f} s (Trainer "
        f"{rdr['trainer_s']:.1f}, AsyncFeeder {rdr['async_s']:.1f}, py_reader "
        f"{rdr['py_reader_s']:.1f})")

    # 7. bf16 mixed precision: train-base-amp (bits dropout, then the
    # dropout kernel), train-resnet50-amp, card vs host
    amp_trains = {}
    for impl, steps in (("auto", TRAIN_STEPS),
                        ("pallas", TRAIN_AMP_PALLAS_STEPS)):
        t0 = time.perf_counter()
        amp_trains[impl] = tr = run_train_base(
            torch, ptt, native, impl, amp=True, batch=TRAIN_AMP_BATCH,
            steps=steps)
        log(f"train-base-amp (dropout_impl={impl}): {steps} steps of batch "
            f"{TRAIN_AMP_BATCH} x {TRAIN_BASE['seq_len']} in "
            f"{time.perf_counter() - t0:.1f} s (build and startup included); "
            f"losses {[round(x, 4) for x in tr['losses']]}")
        log(f"train-base-amp (dropout_impl={impl}) on the card [{card}]: "
            f"step {tr['step_ms_median']:.1f} ms (median of the last 5; all: "
            f"{[round(x, 1) for x in tr['step_ms']]}), "
            f"{tr['tokens_per_s']:.0f} tokens/s, peak memory "
            f"{tr['peak_bytes'] / 2**30:.2f} GiB, bf16 bound "
            f"{tr['bf16_bound_ms']:.2f} ms ({tr['step_flop'] / 1e12:.3f} "
            f"TFLOP a step, the `mul` products x 3, at 989 TFLOP/s), "
            f"{tr['bf16_bound_share']:.3f} of it; launches {tr['launches']} "
            f"({tr['gated_dropout_ops']} dropout ops pass the gate, "
            f"{tr['float32_dropout_ops']} of them float32)")
    t0 = time.perf_counter()
    resnet_amp = run_train_resnet50(torch, ptt, native, amp=True)
    log(f"train-resnet50-amp: {RESNET_STEPS} steps in "
        f"{time.perf_counter() - t0:.1f} s; losses "
        f"{[round(x, 4) for x in resnet_amp['losses']]}; launches "
        f"{resnet_amp['launches']}")
    log(f"train-resnet50-amp on the card [{card}]: step "
        f"{resnet_amp['step_ms_median']:.1f} ms (median of the last 5; all: "
        f"{[round(x, 1) for x in resnet_amp['step_ms']]}), "
        f"{resnet_amp['samples_per_s']:.1f} images/s, peak memory "
        f"{resnet_amp['peak_bytes'] / 2**30:.2f} GiB; bf16 bound "
        f"{resnet_amp['bound_ms']:.2f} ms at 989 TFLOP/s, "
        f"{resnet_amp['bound_share']:.3f} of it")
    t0 = time.perf_counter()
    amp_parity = run_amp_parity(torch, ptt)
    for name, par in amp_parity.items():
        log(f"{name} AMP parity, {par['steps']} steps from the host's state: "
            f"card {par['losses']['card']} host {par['losses']['host']}, "
            f"max relative error {par['rel_err']:.3g} (tol "
            f"{par['loss_rtol']:.3g}: {AMP_NOISE_FACTOR} x the host's "
            f"AMP-vs-float32 distance, at least {AMP_LOSS_RTOL}); "
            f"{par['n_stats']} running stats at {par['stat_share']:.3g} and "
            f"the other persistables at {par['l2_share']:.3g} of "
            f"{par['l2_tol']}")
    log(f"AMP parity: {time.perf_counter() - t0:.1f} s")

    # 7b. train-base-unfused: the unfused attention path, float32 at
    # train-base's batch and under AMP at train-base-amp's, each under the
    # bits dropout and under the dropout kernel, beside the fused path's
    # readings of this call; then card vs host and unfused vs fused
    unfused = {}
    for amp, batch in ((False, TRAIN_BATCH), (True, TRAIN_AMP_BATCH)):
        for impl in ("auto", "pallas"):
            t0 = time.perf_counter()
            key = f"{'amp' if amp else 'float32'}-{impl}"
            unfused[key] = tr = run_train_base(
                torch, ptt, native, impl, amp=amp, batch=batch,
                steps=UNFUSED_STEPS, fused=False)
            fused = (amp_trains if amp else trains)[impl]
            log(f"train-base-unfused{'-amp' if amp else ''} "
                f"(dropout_impl={impl}): {UNFUSED_STEPS} steps of batch "
                f"{batch} in {time.perf_counter() - t0:.1f} s; losses "
                f"{[round(x, 4) for x in tr['losses']]}; launches "
                f"{tr['launches']} ({tr['gated_dropout_ops']} dropout ops "
                f"pass the gate)")
            log(f"train-base-unfused{'-amp' if amp else ''} "
                f"(dropout_impl={impl}) on the card [{card}]: step "
                f"{tr['step_ms_median']:.1f} ms (all: "
                f"{[round(x, 1) for x in tr['step_ms']]}), "
                f"{tr['tokens_per_s']:.0f} tokens/s, peak "
                f"{tr['peak_bytes'] / 2**30:.2f} GiB; the fused path in this "
                f"call: {fused['step_ms_median']:.1f} ms, "
                f"{fused['tokens_per_s']:.0f} tokens/s, peak "
                f"{fused['peak_bytes'] / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    unfused_parity = run_unfused_parity(torch, ptt)
    for name in ("float32", "amp"):
        par = unfused_parity[name]
        log(f"train-base-unfused {name} parity, {par['steps']} steps from "
            f"the host's state: card {par['losses']['card']} host "
            f"{par['losses']['host']}, max relative error "
            f"{par['rel_err']:.3g} (tol {par['loss_rtol']:.3g}); other "
            f"persistables at {par['l2_share']:.3g} of {par['l2_tol']}")
    uvf = unfused_parity["unfused_vs_fused"]
    log(f"train-base unfused vs fused from the same parameters (dropout 0, "
        f"batch {PARITY_BATCH}): {uvf['losses']}, relative error "
        f"{uvf['rel_err']:.3g} (tol {TOL}); {time.perf_counter() - t0:.1f} s")

    # 7c. train-se_resnext50, float32 and AMP, then card vs host
    zoo = {}
    for amp in (False, True):
        t0 = time.perf_counter()
        main_se, startup_se, fetches_se = build_se_resnext(ptt)
        zoo[f"se_resnext50{'-amp' if amp else ''}"] = tr = run_train_model(
            torch, ptt, native, "train-se_resnext50", main_se, startup_se,
            fetches_se["loss"], resnet_batch(SE_BATCH), SE_STEPS, SE_BATCH,
            amp=amp)
        del main_se, startup_se, fetches_se
        log(f"train-se_resnext50{'-amp' if amp else ''}: {SE_STEPS} steps of "
            f"batch {SE_BATCH} x 224 x 224 x 3 NHWC, Momentum(piecewise "
            f"{SE_LR_VALUES} at {SE_LR_BOUNDARIES}, {SE_MOMENTUM}), "
            f"L2Decay({SE_L2}), {tr['ops']} ops a step, in "
            f"{time.perf_counter() - t0:.1f} s; losses "
            f"{[round(x, 4) for x in tr['losses']]}")
        log(f"train-se_resnext50{'-amp' if amp else ''} on the card "
            f"[{card}]: step {tr['step_ms_median']:.1f} ms (all: "
            f"{[round(x, 1) for x in tr['step_ms']]}), "
            f"{tr['samples_per_s']:.1f} images/s, peak "
            f"{tr['peak_bytes'] / 2**30:.2f} GiB; "
            f"{'bf16' if amp else 'float32'} bound {tr['bound_ms']:.1f} ms "
            f"(3 x 2 x {tr['macs_per_sample'] / 1e9:.3f} G multiply-adds an "
            f"image x {SE_BATCH}), {tr['bound_share']:.3f} of it")
    t0 = time.perf_counter()
    parity_values = [RESNET_PARITY_LR * f for f in (1.0, 0.1, 0.01)]
    main_se, startup_se, fetches_se = build_se_resnext(
        ptt, values=parity_values)
    se_parity = {
        name: run_step_parity(torch, ptt, f"se_resnext50{sfx}", main_se,
                              startup_se, fetches_se["loss"],
                              resnet_batch(RESNET_PARITY_BATCH),
                              PARITY_STEPS, amp=amp)
        for name, sfx, amp in (("float32", "", False), ("amp", "-amp", True))}
    del main_se, startup_se, fetches_se
    for name, par in se_parity.items():
        log(f"se_resnext50 {name} parity, {par['steps']} steps from the "
            f"host's state at batch {RESNET_PARITY_BATCH}: card "
            f"{par['losses']['card']} host {par['losses']['host']}, max "
            f"relative error {par['rel_err']:.3g} (tol "
            f"{par['loss_rtol']:.3g}); {par['n_stats']} running stats at "
            f"{par['stat_share']:.3g} of their tolerance, the other "
            f"persistables at {par['l2_share']:.3g} of {par['l2_tol']}")
    log(f"se_resnext50 parity: {time.perf_counter() - t0:.1f} s")

    # 7d. train-vgg16 under the dropout kernel's flag: no kernel launches
    t0 = time.perf_counter()
    rng = np.random.RandomState(DATA_SEED)
    vgg_feed = {"image": rng.rand(VGG_BATCH, *VGG16["image_shape"]).astype(
                    np.float32),
                "label": rng.randint(0, VGG16["class_dim"],
                                     (VGG_BATCH, 1)).astype(np.int64)}
    main_v, startup_v, fetches_v = build_vgg(ptt)
    zoo["vgg16"] = tr = run_train_model(
        torch, ptt, native, "train-vgg16", main_v, startup_v,
        fetches_v["loss"], vgg_feed, VGG_STEPS, VGG_BATCH, impl="pallas")
    n_drop = sum(op.type == "dropout" for op in main_v.global_block().ops)
    del main_v, startup_v, fetches_v
    log(f"train-vgg16: {VGG_STEPS} steps of batch {VGG_BATCH} x 3 x 32 x 32, "
        f"Adam({VGG_LR}), under dropout_impl=pallas ({n_drop} "
        f"downgrade_in_infer dropouts, no kernel launch) in "
        f"{time.perf_counter() - t0:.1f} s; losses "
        f"{[round(x, 4) for x in tr['losses']]}")
    log(f"train-vgg16 on the card [{card}]: step {tr['step_ms_median']:.1f} "
        f"ms (all: {[round(x, 1) for x in tr['step_ms']]}), "
        f"{tr['samples_per_s']:.1f} images/s, peak "
        f"{tr['peak_bytes'] / 2**30:.2f} GiB; float32 bound "
        f"{tr['bound_ms']:.2f} ms, {tr['bound_share']:.3f} of it")

    # 7e. train-deepfm
    t0 = time.perf_counter()
    main_d, startup_d, fetches_d = build_deepfm(ptt)
    zoo["deepfm"] = tr = run_train_model(
        torch, ptt, native, "train-deepfm", main_d, startup_d,
        fetches_d["loss"], deepfm_batch(DEEPFM_BATCH), DEEPFM_STEPS,
        DEEPFM_BATCH)
    del main_d, startup_d, fetches_d
    if not tr["losses"][-1] < tr["losses"][0]:
        raise AssertionError(f"train-deepfm loss did not fall: "
                             f"{tr['losses']}")
    log(f"train-deepfm: {DEEPFM_STEPS} steps of batch {DEEPFM_BATCH} (26 "
        f"fields over 1e5 features, embedding 16, 13 dense, 400 x 3), "
        f"Adagrad({DEEPFM_LR}) under GradientClipByGlobalNorm({DEEPFM_CLIP}),"
        f" in {time.perf_counter() - t0:.1f} s; losses "
        f"{[round(x, 4) for x in tr['losses']]}")
    log(f"train-deepfm on the card [{card}]: step {tr['step_ms_median']:.2f} "
        f"ms (all: {[round(x, 2) for x in tr['step_ms']]}), "
        f"{tr['samples_per_s']:.0f} examples/s, peak "
        f"{tr['peak_bytes'] / 2**30:.3f} GiB")

    # 7f. the optimizer sweep, card vs host
    t0 = time.perf_counter()
    sweep = run_sweep(torch, ptt, native)
    for c in sweep:
        log(f"sweep {c['case']}: losses {[round(x, 5) for x in c['losses']]}"
            f", card vs host {c['loss_err']:.3g} (tol {SWEEP_LOSS_RTOL}), "
            f"largest state distance {c['state_err']:.3g} at {c['worst']} "
            f"(tol {SWEEP_STATE_L2}) over {c['n_state']} persistables")
    log(f"optimizer sweep: {len(sweep)} cases in "
        f"{time.perf_counter() - t0:.1f} s")

    # 7g. train-stacked-lstm, float32 and AMP; card vs host; the sequence
    # op sweep
    lstm_trains = {}
    for amp in (False, True):
        t0 = time.perf_counter()
        lstm_trains["amp" if amp else "float32"] = tr = \
            run_train_stacked_lstm(torch, ptt, native, amp=amp)
        log(f"{tr['tag']}: {LSTM_WARMUP} + {LSTM_STEPS} steps of batch "
            f"{LSTM_BATCH} padded to {LSTM_SEQ} ({tr['valid_tokens']} valid "
            f"tokens), {LSTM['stacked_num']} LSTMs of "
            f"{LSTM['hidden_dim']} with peepholes, dict "
            f"{LSTM['dict_size']}, Adam({LSTM_LR}), {tr['ops']} ops a step, "
            f"in {time.perf_counter() - t0:.1f} s; losses "
            f"{[round(x, 4) for x in tr['losses']]}")
        log(f"{tr['tag']} on the card [{card}]: step "
            f"{tr['step_ms_median']:.1f} ms (all: "
            f"{[round(x, 1) for x in tr['step_ms']]}), "
            f"{tr['examples_per_s']:.1f} examples/s, "
            f"{tr['padded_tokens_per_s']:.0f} padded tokens/s, "
            f"{tr['valid_tokens_per_s']:.0f} valid tokens/s, peak "
            f"{tr['peak_bytes'] / 2**30:.3f} GiB above what the card held "
            f"before")
    # 7h. train-mt; 7i. infer-mt-beam from its trained parameters (timed
    # before any traced step: a profiler session slows every later launch)
    t0 = time.perf_counter()
    mt = run_train_mt(torch, ptt, native)
    log(f"train-mt: {MT_WARMUP} + {MT_STEPS} steps of batch {MT_BATCH}, "
        f"sources {MT_SRC_MIN}-{MT_SRC_MAX} ({mt['src_tokens']} tokens), "
        f"targets padded to {MT_TRG} ({mt['valid_trg']} valid), dict "
        f"{MT['dict_size']}, widths {MT['emb_dim']}/{MT['hidden_dim']}, "
        f"Adam({MT_LR}), float32, {mt['ops']} ops a step ({mt['body_ops']} "
        f"in the decoder's step body), in {time.perf_counter() - t0:.1f} s; "
        f"losses {[round(x, 4) for x in mt['losses']]}")
    log(f"train-mt on the card [{card}]: step {mt['step_ms_median']:.1f} ms "
        f"(all: {[round(x, 1) for x in mt['step_ms']]}), "
        f"{mt['examples_per_s']:.1f} examples/s, "
        f"{mt['trg_tokens_per_s']:.0f} target tokens/s padded, "
        f"{mt['valid_trg_tokens_per_s']:.0f} valid, peak "
        f"{mt['peak_bytes'] / 2**30:.3f} GiB above what the card held before")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mt_") as tmp:
        beam = run_infer_mt_beam(torch, ptt, native, mt, tmp)
    log(f"infer-mt-beam on the card [{card}]: {MT_DECODE_BATCH} sources "
        f"({beam['src_tokens']} tokens), beam {MT_BEAM}, max_len "
        f"{MT_MAX_LEN}, from a saved and reloaded inference model: "
        f"{beam['ms_median']:.1f} ms a batch (all: "
        f"{[round(x, 1) for x in beam['ms']]}), {beam['tokens_per_s']:.0f} "
        f"generated tokens/s; host {beam['host_ms']:.0f} ms; ids equal in "
        f"{beam['ids_equal_rows']} of {MT_DECODE_BATCH} rows, "
        f"{len(beam['ties'])} parted at a tie {beam['ties']}; scores within "
        f"{beam['score_rel_err']:.3g} of the host's (tol {MT_SCORE_RTOL}); "
        f"best beams {beam['best']}; {time.perf_counter() - t0:.1f} s")
    for k in ("scope", "main"):
        mt.pop(k)

    # 7j. the book: the nine chapters at the book's widths on the card
    # (timed before the traced steps below: a profiler session slows every
    # later launch), card vs host, their inference models on both
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_book_") as tmp:
        book = run_book(torch, ptt, native, tmp)
    book_s = time.perf_counter() - t0
    for name, b in book.items():
        par = b["parity"]
        log(f"book {name} (widths {b['widths']}) on the card [{card}]: "
            f"{BOOK_WARMUP} + {BOOK_STEPS} steps, step "
            f"{b['step_ms_median']:.2f} ms (median; all: "
            f"{[round(x, 2) for x in b['step_ms']]}), "
            f"{b['examples_per_s']:.1f} examples/s, peak memory "
            f"{b['peak_bytes'] / 2**20:.1f} MiB above what the card held "
            f"before, {b['rule_calls']} rule calls a step ({b['ops']} ops "
            f"in the main block); losses "
            f"{[round(x, 4) for x in b['losses']]}; no kernel of csrc/ "
            f"launched; every feed and persistable on the card")
        log(f"book {name}: inference model reloaded on the card and on "
            f"the host, outputs {b['infer_shapes']} agree "
            f"({b['infer_agree']}; float error {b['infer_err']:.3g} of the "
            f"host's scale, tol {LOSS_RTOL}; near-tie rows "
            f"{b['infer_ties']}); card vs host, {par['steps']} steps from "
            f"the host's state at batch "
            f"{BOOK_PARITY_BATCH.get(name, b['batch'])}: card "
            f"{par['losses']['card']} host {par['losses']['host']}, max "
            f"relative error {par['rel_err']:.3g} (tol {LOSS_RTOL}); "
            f"{par['n_stats']} running stats at {par['stat_share']:.3g} "
            f"and the other persistables at {par['l2_share']:.3g} of their "
            f"tolerance"
            + (f" (Adam / Adagrad: the parameters, not gated, at "
               f"{par['param_share']:.3g})" if par["param_share"] else ""))
    ic = book["image_classification"]
    log(f"book image_classification float32 bound {ic['bound_ms']:.3f} ms "
        f"(3 x 2 x {ic['macs_per_sample'] / 1e6:.2f} M multiply-adds an "
        f"image x {ic['batch']}, at 67 TFLOP/s), "
        f"{ic['bound_ms'] / ic['step_ms_median']:.3f} of its step")
    log(f"book: phase {book_s:.1f} s; total so far "
        f"{time.perf_counter() - t_start:.1f} s")

    # 7k. the common op breadth: train-deepfm with a streaming auc, card
    # vs host; then the breadth bank at full width (timed before the
    # traced steps below)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_auc_") as tmp:
        dauc = run_deepfm_auc(torch, ptt, native, tmp)
    log(f"train-deepfm-auc: {DEEPFM_STEPS} steps of batch {DEEPFM_BATCH} "
        f"(a new batch each step) with layers.auc(predict, label) at its "
        f"defaults on the host, each also on the card from the host's "
        f"state: losses card "
        f"{[round(x, 5) for x in dauc['losses']['card']]} host "
        f"{[round(x, 5) for x in dauc['losses']['host']]} (max relative "
        f"error {dauc['loss_err']:.3g}, tol {LOSS_RTOL}); AUC card "
        f"{[round(x, 6) for x in dauc['aucs']['card']]} (max error "
        f"{dauc['auc_err']:.3g}, tol {AUC_TOL}); StatPos / StatNeg counts "
        f"equal every step ({int(dauc['counts'])} predictions; "
        f"{len(dauc['ties'])} on a bucket's edge {dauc['ties']}); "
        f"save_params ({dauc['n_params']} parameters) -> load_params into "
        f"a fresh scope -> one more step: {dauc['n_state']} persistables "
        f"and every fetch bit-equal; no kernel launched; the card's free "
        f"run against the host's: losses within "
        f"{dauc['free_run']['loss_err']:.3g} (tol {LOSS_RTOL}), predictions "
        f"apart by at most {[f'{x:.2g}' for x in dauc['free_run']['p_err']]}"
        f" a step, {dauc['free_run']['moved']} in another bucket, "
        f"histograms parted at step {dauc['free_run']['parted_at']} (not "
        f"gated: a free run drifts)")
    log(f"train-deepfm-auc on the card [{card}], free runs from the "
        f"startup state, a step of each in turns: step "
        f"{dauc['step_ms_median']:.2f} ms with the auc op (all: "
        f"{[round(x, 2) for x in dauc['step_ms']]}), "
        f"{dauc['plain_step_ms_median']:.2f} ms without (all: "
        f"{[round(x, 2) for x in dauc['plain_step_ms']]}); "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    breadth = run_breadth(torch, ptt, native)
    breadth_s = time.perf_counter() - t0
    for b in breadth:
        log(f"breadth {b['name']} ({b['op']}{', AMP' if b['amp'] else ''}) "
            f"at {b['shapes']}: card {b['ms_median']:.3f} ms a run "
            f"(forward and grad, wall after a sync; all: "
            f"{[round(x, 3) for x in b['ms']]}) [{card}], two card runs "
            f"bit-equal; card vs host at 1/{BREADTH_CUT} of the rows or "
            f"batch: {b['tol_share']:.3g} of its tolerance ({b['gate']})")
    log(f"breadth bank: {len(breadth)} cases held ({len(set(b['op'] for b in breadth))} "
        f"op types), no kernel of csrc/ launched; phase 7k "
        f"{breadth_s:.1f} s for the bank; total so far "
        f"{time.perf_counter() - t_start:.1f} s")

    # 7l. the rest of the op families: train-mobilenet-ssd (train, card vs
    # host, evaluation with NMS and mAP, AMP), then the bank of the new
    # ops at full width (timed before the traced steps below); no kernel
    # of csrc/ may launch anywhere in the phase
    t0 = time.perf_counter()
    native.reset_launches()
    ssd = run_train_mobilenet_ssd(torch, ptt, native)
    par, ev, amp = ssd["parity"], ssd["eval"], ssd["amp"]
    log(f"train-mobilenet-ssd (MobileNet-v1 SSD 300 x 300, 21 classes, "
        f"{ssd['priors']} priors, {ssd['n_params']} parameters, RMSProp + "
        f"L2Decay, float32) on the card [{card}]: {SSD_WARMUP} + "
        f"{SSD_STEPS} steps of batch {SSD_BATCH}, step "
        f"{ssd['step_ms_median']:.2f} ms (median; all: "
        f"{[round(x, 2) for x in ssd['step_ms']]}), "
        f"{ssd['images_per_s']:.1f} images/s, {ssd['rule_calls']} rule "
        f"calls a step ({ssd['ops']} ops in the main block), peak memory "
        f"{ssd['peak_bytes'] / 2**20:.1f} MiB above what the card held "
        f"before; losses {[round(x, 3) for x in ssd['losses']]}; no kernel "
        f"of csrc/ launched; synthetic data {ssd['data_s']:.1f} s")
    log(f"train-mobilenet-ssd card vs host, {SSD_PARITY_STEPS} steps at "
        f"batch {SSD_PARITY_BATCH}, each from the host's state: losses card "
        f"{par['losses']['card']} host {par['losses']['host']} (max "
        f"relative error {par['rel_err']:.3g}, tol {LOSS_RTOL}); match "
        f"indices ({par['positives']} positives) and mined negatives "
        f"({par['negatives']}) equal every step; the card's free run from "
        f"the same state: losses {par['losses']['free']}, "
        f"{[f'{x:.3g}' for x in par['free_rel_err']]} from the host's, "
        f"matches equal {par['free_match_equal']}, negatives equal "
        f"{par['free_neg_equal']} (not gated: RMSProp's first updates are "
        f"about lr * sign(grad)); {par['seconds']:.1f} s")
    log(f"mobilenet-ssd is_test on the card: detection_output (NMS 0.45, "
        f"top 400, keep 200, score 0.01) + detection_map over "
        f"{SSD_EVAL_BATCHES} batches of {ev['batch']}: "
        f"{ev['ms_median']:.2f} ms a batch (all: "
        f"{[round(x, 2) for x in ev['ms']]}), mAP 11point "
        f"{ev['maps']['11point']} integral {ev['maps']['integral']}, "
        f"DetectionMAP evaluator (mean over the batches) "
        f"{ev['evaluator_map']:.6f}, detections "
        f"kept {ev['counts'][0]} (first batch); host on the first batch "
        f"({ev['host_s']:.1f} s): mAP {ev['host_map']}, counts "
        f"{ev['host_count']}; NMS fed the card's decoded boxes and scores "
        f"equal card vs host (Out and Count bit for bit), detection_map "
        f"fed the card's detections equal to 1e-6 ({ev['same_input_map']}); "
        f"end-to-end mAP error {ev['map_err']} (tol {SSD_MAP_ATOL}; "
        f"{ev['rows_differ']} of {SSD_BATCH * 200} detection rows differ); "
        f"the ground truth as its detections scores {ev['perfect_map']}")
    log(f"train-mobilenet-ssd AMP, {amp['steps']} steps at batch "
        f"{SSD_AMP_BATCH} from the host's state: losses {amp['losses']}; "
        f"card vs host {amp['rel_err']:.3g} (tol {amp['loss_rtol']:.3g}); "
        f"state at {amp['l2_share']:.3g} and running stats at "
        f"{amp['stat_share']:.3g} of {amp['l2_tol']}; {amp['bf16_probes']} "
        f"bf16 products checked; {amp['seconds']:.1f} s")
    ssd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    item6 = run_item6_bank(torch, ptt, native)
    item6_s = time.perf_counter() - t0
    for b in item6:
        log(f"bank {b['name']} ({b['op']}) at {b['shapes']}: card "
            f"{b['ms_median']:.3f} ms a run (forward{' and grad' if any('@GRAD' in n for n in b['shapes']) else ''}, "
            f"wall after a sync; all: {[round(x, 3) for x in b['ms']]}) "
            f"[{card}], two card runs bit-equal; card vs host "
            f"{'at 1/' + str(BREADTH_CUT) + ' of the rows or batch' if b['gate'] != 'random' else '(each its own draw)'}: "
            f"{b['tol_share']:.3g} of its tolerance ({b['gate']})")
    launches_7l = dict(native.launches)
    if any(launches_7l.values()):
        raise AssertionError(f"phase 7l launched a kernel: {launches_7l}")
    log(f"phase 7l: {len(item6)} bank cases ({len(set(b['op'] for b in item6))} "
        f"op types), no kernel of csrc/ launched in the phase; "
        f"train-mobilenet-ssd {ssd_s:.1f} s, bank {item6_s:.1f} s; total "
        f"so far {time.perf_counter() - t_start:.1f} s")
    # 7m. the transpilers: infer-base-bf16 (Float16Transpiler) against
    # the float32 program, serve-resnet50 folded (InferenceTranspiler)
    # against unfolded, train-base with memory_optimize's marks, and
    # validate="error" on the transpiled program (inside run_infer_base_bf16)
    t0 = time.perf_counter()
    # the infer-base dir lives on to phase 7t, which reads it too
    infer_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_infer_base_")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_7m_") as tmp:
        infer16 = run_infer_base_bf16(torch, ptt, native, infer_tmp.name)
        log(f"infer-base-bf16 (Transformer-base is_test, fused attention, "
            f"saved, loaded on the card, Float16Transpiler bfloat16; "
            f"{infer16['n_params']} parameters, every one bf16 on the card; "
            f"prepare(validate='error') passes the float32 program and "
            f"finds {infer16['dtype_mismatches']} dtype-mismatch errors, and "
            f"nothing else, on the transpiled one) [{card}]: batch "
            f"{INFER_BASE_BATCH} x {TRAIN_BASE['seq_len']}, "
            f"{infer16['ms_median']['bfloat16']:.2f} ms a batch (median; "
            f"all: {[round(x, 2) for x in infer16['ms']['bfloat16']]}) "
            f"against the float32 program's "
            f"{infer16['ms_median']['float32']:.2f} (all: "
            f"{[round(x, 2) for x in infer16['ms']['float32']]}), the "
            f"logits left on the card; with them fetched to numpy "
            f"{infer16['with_fetch_ms']['bfloat16']:.1f} against "
            f"{infer16['with_fetch_ms']['float32']:.1f} ms; "
            f"{infer16['tokens_per_s']['bfloat16']:.0f} against "
            f"{infer16['tokens_per_s']['float32']:.0f} tokens/s; "
            f"{infer16['rule_calls']} rule calls a batch; parameters "
            f"{infer16['param_bytes']['bfloat16'] / 2**20:.1f} against "
            f"{infer16['param_bytes']['float32'] / 2**20:.1f} MiB, a batch's "
            f"peak {infer16['peak_bytes']['bfloat16'] / 2**20:.1f} against "
            f"{infer16['peak_bytes']['float32'] / 2**20:.1f} MiB above them; "
            f"launches a batch {infer16['launches_per_batch']} (the host's "
            f"attention Q dtypes: {sorted(set(infer16['q_dtypes']))} x "
            f"{infer16['attentions']}); card vs host on the first "
            f"{INFER_BASE_HOST_ROWS} rows {infer16['host_err']:.3g} of a "
            f"{infer16['host_scale']:.3g} scale ({infer16['tol_share']:.3g} "
            f"of INFER_BF16_TOL), top-1 equal on {infer16['clear_rows']} "
            f"clear rows; top-1 equal to the float32 program's on "
            f"{infer16['top1_vs_float32']:.4f} of the tokens; build "
            f"{infer16['build_s']:.1f} s, host run {infer16['host_s']:.1f} s")
        folded = run_serve_resnet50_folded(torch, ptt, native, tmp)
    tr = folded["traffic"]
    log(f"serve-resnet50-folded (serve_resnet50_model folded on the card by "
        f"InferenceTranspiler: {folded['pairs']} pairs, no batch_norm left, "
        f"the folded parameters the numpy fold's bit for bit; ops "
        f"{folded['ops']['unfolded']} -> {folded['ops']['folded']}; the "
        f"saved dirs' .npy bytes {folded['params']}, the batch norms' "
        f"parameters kept as the JAX package keeps them) [{card}]: probes "
        f"folded vs "
        f"unfolded at {folded['tol_share']:.3g} of the fold's tolerances "
        f"({folded['ties']} near-tied rows); a prepared batch of "
        f"{SERVE_RN50_LADDER[-1]}: unfolded "
        f"{folded['batch_ms_median']['unfolded']:.2f} ms, folded "
        f"{folded['batch_ms_median']['folded']:.2f} ms (all: "
        f"{ {k: [round(x, 2) for x in v] for k, v in folded['batch_ms'].items()} }"
        f"), rule calls a batch {folded['rule_calls']}; served "
        f"{FOLD_REQUESTS} requests x 2 each (unfolded, folded, folded, "
        f"unfolded): images/s "
        f"{ {k: [round(r['images_per_s'], 1) for r in v] for k, v in tr.items()} }"
        f", p50 ms { {k: [round(r['p50_ms'], 1) for r in v] for k, v in tr.items()} }"
        f", p99 ms { {k: [round(r['p99_ms'], 1) for r in v] for k, v in tr.items()} }"
        f"; no kernel of csrc/ launched; fold {folded['fold_s']:.1f} s")
    memopt = run_train_base_memopt(torch, ptt, native)
    log(f"train-base with memory_optimize (level 1, {memopt['marked_ops']} "
        f"ops marked) [{card}]: {MEMOPT_STEPS} steps at batch "
        f"{MEMOPT_BATCH} from one state, losses {memopt['losses']} bit-equal "
        f"with and without the marks, launches {memopt['launches']} equal")
    phase7m_s = time.perf_counter() - t0
    log(f"phase 7m: {phase7m_s:.1f} s; total so far "
        f"{time.perf_counter() - t_start:.1f} s")
    # 7n. the parallel plane: Transformer-base through ParallelExecutor on
    # one rank, then two ranks that share the card; the kernels at a
    # rank's offsets; the planner's H100 rates
    t0 = time.perf_counter()
    from paddle_tpu_torch.parallel import spmd
    peak_flops, copy_bw = measure_h100_rates(torch)
    log(f"H100 rates for analysis.planner.H100 [{card}]: bf16 torch.matmul "
        f"at {PEAK_MATMUL_N}^3 {peak_flops / 1e12:.1f} TFLOP/s, device copy "
        f"of {PEAK_COPY_BYTES >> 30} GiB {copy_bw / 1e12:.3f} TB/s (read + "
        f"write), medians of {PEAK_ITERS}")
    offsets = check_offsets(torch, fa, dk)
    log(f"kernels at rank 1's offsets of train-base's batch (B {TRAIN_BATCH} "
        f"split 16 / 16: flash bh0 {TRAIN_BATCH // 2 * 8}, dropout base "
        f"{TRAIN_BATCH // 2 * 256 * 512}): the whole batch's rows bit for "
        f"bit; against the plain versions at the offset {offsets}")
    pe1 = run_pe_base_1(torch, ptt, native, spmd)
    ex1, par1 = pe1["executor"], pe1["parallel"]
    log(f"pe-base-1 (ParallelExecutor(use_cuda=True), one-rank mesh, "
        f"{PE_STEPS} steps of train-base at batch {TRAIN_BATCH} from the "
        f"Executor's saved state) [{card}]: losses bit-equal to the "
        f"Executor's {par1['losses']}; launches {par1['launches']} equal to "
        f"the Executor's; no collective; step {par1['step_ms_median']:.1f} "
        f"ms (median) against the Executor's {ex1['step_ms_median']:.1f} ms; "
        f"peak {par1['peak_bytes'] / 2**30:.2f} GiB against "
        f"{ex1['peak_bytes'] / 2**30:.2f} GiB")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_7n_") as tmp:
        pe_ranks = run_pe_world(torch, tmp)
    check_pe_world(pe_ranks, pe1)
    for name, axis, dropout in PE_CASES:
        cs = [r["cases"][name] for r in pe_ranks]
        ref = (ex1 if dropout else pe1["executor-dropout0"])["losses"]
        log(f"{name} (2 ranks sharing the card, gloo, mesh {axis}=2, dropout "
            f"{dropout}, batch {TRAIN_BATCH}, {PE_RANK_STEPS} steps) "
            f"[{card}]: losses {[c['losses'] for c in cs]} against the "
            f"Executor's {ref[:PE_RANK_STEPS]} (rtol {PE_RTOL}, atol "
            f"{PE_ATOL}); step {[round(c['step_ms_median'], 1) for c in cs]} "
            f"ms a rank (median; all: "
            f"{[[round(x, 1) for x in c['step_ms']] for c in cs]}) against "
            f"the Executor's {ex1['step_ms_median']:.1f} ms; collectives "
            f"(rank 0, {PE_RANK_STEPS} steps) {cs[0]['collectives']}; "
            f"flash launches {[{k: v for k, v in c['launches'].items() if k.startswith('flash_')} for c in cs]}; "
            f"plan {cs[0]['inventory']}, ran whole "
            f"{cs[0]['replicated_ops']}; peak "
            f"{[round(c['peak_bytes'] / 2**30, 2) for c in cs]} GiB a rank; "
            f"broadcast and shard {[round(c['bcast_s'], 1) for c in cs]} s"
            + (f"; ffn1 held at {cs[0]['ffn1']}" if axis == "mp" else ""))
    trainer_pe = run_trainer_parallel(torch, ptt, native)
    log(f"Trainer(parallel=True) against Trainer(parallel=False), "
        f"{PE_TRAINER_STEPS} steps of train-base [{card}]: losses "
        f"{trainer_pe['parallel']['losses']} bit-equal; launches "
        f"{trainer_pe['parallel']['launches']} against "
        f"{trainer_pe['serial']['launches']}; "
        f"{trainer_pe['parallel']['s']:.1f} s against "
        f"{trainer_pe['serial']['s']:.1f} s with set-up")
    phase7n_s = time.perf_counter() - t0
    log(f"phase 7n: {phase7n_s:.1f} s; total so far "
        f"{time.perf_counter() - t_start:.1f} s")
    # 7o. the health plane: train-base through Trainer(pulse_port=0) with
    # the observe flag on and off, the non-finite alarm, serve-base with
    # its pulse, a flight dump and a stitched trace across processes, the
    # analysis CLIs on the card
    t0 = time.perf_counter()
    obs_train = run_train_base_observed(torch, ptt, native)
    # phase 7p (d)'s CLIs run beside the rest of 7o and 7p (a)-(c): none
    # of those times a step against the host clock in a way they would
    # skew but 7p (a), whose two runs take their steps in turn
    gc.collect()
    torch.cuda.empty_cache()
    wire_clis = start_clis(WIRE_CLIS)
    sh = obs_train["phase_shares"]
    log(f"train-base-observed (Trainer(pulse_port=0), {OBS_STEPS} steps "
        f"with the observe flag on, then {OBS_OFF_STEPS} off, batch "
        f"{TRAIN_BATCH}, then {OBS_OFF_STEPS} on again) [{card}]: step "
        f"{obs_train['step_ms_median_on']:.1f} ms on, "
        f"{obs_train['step_ms_median_off']:.1f} off, "
        f"{obs_train['step_ms_median_on_again']:.1f} on again (medians "
        f"after a segment's first; on again over off "
        f"{obs_train['on_over_off']:.4f}; all on "
        f"{[round(x, 1) for x in obs_train['step_ms_on']]}, off "
        f"{[round(x, 1) for x in obs_train['step_ms_off']]}, on again "
        f"{[round(x, 1) for x in obs_train['step_ms_on_again']]}); launches "
        f"a step equal on and off ({obs_train['launches_on']} over "
        f"{OBS_STEPS} steps); /metrics ({obs_train['families']} families) "
        f"parses strictly, executor_steps_total "
        f"{obs_train['executor_steps_total']}, trainer_last_loss "
        f"{obs_train['last_loss']} = the last loss fetched; /healthz 200; "
        f"the scraper read {obs_train['scrape_rounds']} rounds while it "
        f"trained and {obs_train['scraped_steps']} steps at the end; step log "
        f"phase shares "
        + ", ".join(f"{p} {v:.4f}" for p, v in sorted(sh.items()))
        + f"; /status memory live, peak_bytes_in_use "
        f"{obs_train['peak_bytes']} = max_memory_allocated; the estimate "
        f"{obs_train['estimate_peak_bytes']:.0f} B = "
        f"{obs_train['estimate_over_peak']:.4f} of the measured peak")
    fc = obs_train["flag_cost"]
    log(f"the executor hooks' cost a run [{card}]: a one-fc step (B 32, 64 "
        f"-> 64) {fc['on_us']:.1f} us with the flag on, {fc['off_us']:.1f} "
        f"off (medians of {OBS_FLAG_PAIRS} interleaved pairs; quartiles on "
        f"{[round(x, 1) for x in fc['on_p25_p75']]}, off "
        f"{[round(x, 1) for x in fc['off_p25_p75']]}): "
        f"{fc['cost_us']:.1f} us a run")
    log(f"the non-finite alarm: {obs_train['poisoned']} set to inf, the "
        f"step's loss {obs_train['inf_loss']}, /healthz "
        f"{obs_train['healthz_after']}, alerts in /flight "
        f"{obs_train['alerts']}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_7o_") as tmp:
        obs_serve = run_serve_base_pulse(torch, ptt, native, tiny_lm, tmp)
        log(f"serve-base-pulse (ServeConfig(pulse_port=0), {N_REQUESTS} "
            f"requests) [{card}]: /readyz {obs_serve['readyz']} (during, "
            f"after) with {obs_serve['checks']}; plan events "
            f"{obs_serve['plan_events']}, none unexpected; launches "
            f"{obs_serve['launches']} for {obs_serve['prefill_steps']} "
            f"prefill and {obs_serve['decode_steps']} decode steps")
        obs_flight = run_flight_stitch(torch, ptt, tmp)
    log(f"flight and stitch [{card}]: the child's dump reason "
        f"{obs_flight['reason']!r}, its memory section {obs_flight['devices']}"
        f", {obs_flight['events']} events; stitched: "
        f"{obs_flight['edges']} cross-process edge(s), "
        f"{obs_flight['orphans']} orphans, {obs_flight['spans']} spans of "
        f"one trace over pids {obs_flight['pids']} "
        f"({obs_flight['processes']}); skew applied {obs_flight['skew_us']}")
    obs_clis = run_observe_clis(torch)
    log(f"tools/torch_op_profile.py --full-size --batch {TRAIN_BATCH} "
        f"--measured-check [{card}]: {obs_clis['op_profile']['check']} "
        f"({obs_clis['op_profile']['s']:.1f} s); tools/torch_paddle_plan.py "
        f"--full-size --devices 1: {obs_clis['paddle_plan']['plan']} "
        f"({obs_clis['paddle_plan']['s']:.1f} s)")
    phase7o_s = time.perf_counter() - t0
    log(f"phase 7o: {phase7o_s:.1f} s; total so far "
        f"{time.perf_counter() - t_start:.1f} s")
    # 7p. the wire plane: train-base through DistributeTranspiler's
    # collective path with comm_quant int8 against the unquantized run,
    # the host codec on its gradients, pe-base-1 with comm_quant, the two
    # ranks of phase 7n's world with comm_quant bf16, the observe CLIs
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    wire_a = run_train_base_wire(torch, ptt, native)
    wire_handles = wire_a.pop("handles")
    wire_tr = wire_a["traced"]
    log(f"train-base-wire-int8 (train-base, batch {TRAIN_BATCH}, "
        f"{WIRE_STEPS} steps unquantized and {WIRE_STEPS} through "
        f"DistributeTranspiler(comm_quant='int8') from one saved state, "
        f"their steps in turn, the observe flag on) [{card}]: "
        f"{wire_a['n_comm_quant']} "
        f"comm_quant_dequant for {wire_a['n_adam']} Adam ops, the trainer "
        f"Program verified; residuals zero after the startup, "
        f"{wire_a['residuals_moved_after_step1']} of them non-zero after "
        f"step 1; losses {[round(x, 4) for x in wire_a['losses']]} against "
        f"unquantized {[round(x, 4) for x in wire_a['ref_losses']]}: last "
        f"{wire_a['last_dev']:.4g} apart, at most {wire_a['max_dev']:.4g} "
        f"(band {wire_a['band']:.4g}); launches {wire_a['launches']} equal "
        f"to the unquantized run's; plan events {wire_a['plan_causes']}, "
        f"none unexpected; step {wire_a['step_ms_median']:.1f} ms with "
        f"comm_quant, {wire_a['ref_step_ms_median']:.1f} without (medians "
        f"after the first, the two runs' steps in turn; with "
        f"{[round(x, 1) for x in wire_a['step_ms']]}, "
        f"without {[round(x, 1) for x in wire_a['ref_step_ms']]}); one "
        f"traced step {wire_tr['wall_ms']:.1f} ms: {wire_tr['count']} "
        f"comm_quant ops {wire_tr['device_us'] / 1e3:.3f} ms of device time "
        f"({wire_tr['host_us'] / 1e3:.1f} ms on the host); the step's "
        f"device busy {wire_tr['step_busy_us'] / 1e3:.1f} ms = "
        f"{wire_tr['busy_share']:.3f} of it; "
        f"residuals {wire_a['residual_bytes']} B beside "
        f"{wire_a['param_bytes']} B of parameters")
    gc.collect()
    torch.cuda.empty_cache()
    wire_b = run_wire_codec(torch, ptt, wire_handles)
    del wire_handles
    gc.collect()
    torch.cuda.empty_cache()
    log(f"the host codec on one step's gradients ({wire_b['tensors']} "
        f"tensors, {wire_b['elements']} elements, {wire_b['raw_bytes']} B "
        f"raw) [{card}]: decode_tensor equal to the returned dequant "
        f"bit for bit; int8 (chunk {WIRE_CHUNK}) "
        f"{wire_b['int8']['encoded_bytes']} B, "
        f"{wire_b['int8']['ratio']:.4f}x, each element within half its "
        f"chunk's scale to float32 rounding (the largest error "
        f"{wire_b['int8']['max_err_over_half_quantum']:.4f} of it), "
        f"{wire_b['int8']['s']:.1f} s; bf16 "
        f"{wire_b['bf16']['encoded_bytes']} B, "
        f"{wire_b['bf16']['ratio']:.4f}x, the largest error "
        f"{wire_b['bf16']['max_err_over_half_quantum']:.4f} of half a "
        f"bf16 ulp, {wire_b['bf16']['s']:.1f} s")
    wire_pe1 = run_pe_base_wire_1(torch, ptt, native)
    log(f"pe-base-wire-1 (ParallelExecutor, BuildStrategy.comm_quant "
        f"'int8', one-rank mesh, {WIRE_PE1_STEPS} steps) [{card}]: "
        f"losses {wire_pe1['parallel']['losses']} bit-equal to the "
        f"Executor's on the rewritten Program "
        f"({wire_pe1['n_comm_quant']} comm_quant_dequant), launches "
        f"{wire_pe1['parallel']['launches']} equal")
    wire_dp2 = check_pe_wire(pe_ranks, wire_a)
    for c in wire_dp2:
        log(f"pe-base-wire-dp2 rank {c['rank']} (comm_quant "
            f"'{c['codec']}', phase 7n's world, two ranks sharing the "
            f"card over gloo) [{card}]: losses "
            f"{[round(x, 4) for x in c['losses']]}, at most "
            f"{c['max_dev']:.4g} off the unquantized run (band "
            f"{c['band']:.4g}); collectives a step "
            f"{c['collectives_per_step']} = pe-base-dp2's; "
            f"{c['ran_whole']}; step {c['step_ms_median']:.1f} ms "
            f"against pe-base-dp2's {c['dp2_step_ms_median']:.1f}")
    wire_cli = finish_wire_clis(wire_clis)
    log(f"the observe CLIs on the card, started after phase 7o (a) "
        f"[{card}]: torch_telemetry_dump --assert-no-recompiles exit 0 "
        f"({wire_cli['telemetry_dump']['s']:.1f} s), with --two-shapes "
        f"exit 1 ({wire_cli['telemetry_dump_two_shapes']['s']:.1f} s): "
        f"{wire_cli['telemetry_dump_two_shapes']['causes'].strip()!r}; "
        f"torch_step_profile exit 0 ({wire_cli['step_profile']['s']:.1f} s), "
        f"its flash rows {wire_cli['step_profile']['flash_rows']}; waited "
        f"{wire_cli['waited_s']:.1f} s for them here")
    phase7p_s = time.perf_counter() - t0
    log(f"phase 7p: {phase7p_s:.1f} s; total so far "
        f"{time.perf_counter() - t_start:.1f} s")
    # 7q. the parameter-server plane: train-base through sync pservers
    # (raw, then int8 on the wire), DeepFM through async pservers, then
    # a replicated shard's primary killed mid-run
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ps_") as ps_tmp:
        ps = run_ps_plane(torch, ptt, native, ps_tmp)
    psa, psc, psd = ps["sync"], ps["deepfm_async"], ps["deepfm_haven"]

    def _split(sp):
        return ", ".join(f"{k} {v:.1f}" for k, v in sp.items())
    log(f"train-base-ps-sync (train-base through DistributeTranspiler("
        f"runtime='pserver'), {psa['n_params']} parameters, "
        f"{psa['param_bytes']} B, on 2 pserver processes that "
        f"Executor(CPUPlace()).run their pserver Program; "
        f"{PS_TRAINERS} SyncPSTrainers in threads, each on CUDAPlace(0) "
        f"with {TRAIN_BATCH // PS_TRAINERS} rows; no adam op in a trainer "
        f"Program) [{card}]: dropout 0, {psa['steps']} steps: mean losses "
        f"{psa['mean_losses']} against the Executor's {psa['ref_losses']} at "
        f"batch {TRAIN_BATCH} ({psa['loss_rel_err']:.3g} relative, tol "
        f"{LOSS_RTOL}); the pulled parameters within relative L2 "
        f"{psa['param_rel_l2_max']:.3g} (tol {PS_PARAM_RTOL}; worst "
        f"{psa['param_rel_l2_worst']}; {psa['params_bit_equal']} of "
        f"{psa['n_params']} bit-equal) of the Executor's grads on the "
        f"trainers' rows, averaged, under the servers' Adam (replayed on "
        f"the host in {psa['host_adam_reference_s']:.1f} s); "
        f"{psa['param_rel_l2_in_graph_adam_max']:.3g} of the Executor's "
        f"own, its in-graph Adam (worst "
        f"{psa['param_rel_l2_in_graph_adam_worst']}): against those, "
        f"{psa['elements_outside_test_tol']} of {psa['elements']} elements "
        f"({psa['share_outside_test_tol']:.3g}) outside rtol {PS_ELEM_RTOL} "
        f"atol {PS_ELEM_ATOL}, the largest difference "
        f"{psa['largest_element_diff']}; launches a step "
        f"{ {k: v for k, v in psa['launches_a_step'].items() if v} } "
        f"({PS_TRAINERS} trainers)")
    for tag in ("raw", "int8"):
        r = psa[tag]
        log(f"train-base-ps-sync{'' if tag == 'raw' else '-int8'} "
            f"(dropout {TRAIN_BASE['dropout_rate']}, {psa['timed_steps']} "
            f"steps, the raw and int8 jobs' steps in turn from one state, "
            f"each on its own pair of pservers) [{card}]: step "
            f"{r['step_ms_median']:.1f} "
            f"ms (median; all {[round(x, 1) for x in r['step_ms']]}); a "
            f"trainer's split (median ms): {_split(r['split_ms'])}; wire "
            f"bytes a step {r['bytes']}; mean losses "
            f"{[round(x, 4) for x in r['mean_losses']]}"
            + (f", at most {r['max_dev']:.3g} off the raw job's (band "
               f"{r['band']:.4g})" if tag == "int8" else "")
            + f"; launches {({k: v for k, v in r['launches'].items() if v})}")
    raw_push = psa["raw"]["bytes"].get("push_grads_sync", 0)
    q_push = psa["int8"]["bytes"].get("push_grads_sync", 0)
    log(f"train-base-ps-sync wire [{card}]: push_grads_sync {raw_push} B "
        f"raw against {q_push} B int8 a step ({raw_push / q_push:.4f}x); "
        f"peak {psa['peak_bytes'] / 2**30:.2f} GiB on the card")
    log(f"train-deepfm-ps-async (DeepFM, distributed tables, batch "
        f"{DEEPFM_BATCH}, Adagrad({PS_DEEPFM_LR}), AsyncPSTrainer on the "
        f"two pservers, sparse_prefetch_cap {psc['cap']}) [{card}]: "
        f"{psc['steps']} steps, losses {[round(x, 4) for x in psc['losses']]}"
        f"; each push's rows the batch's unique ids "
        f"({min(psc['unique_ids'])}..{max(psc['unique_ids'])}); step "
        f"{psc['step_ms_median']:.1f} ms (median; split "
        f"{_split(psc['split_ms'])}); wire bytes a step {psc['bytes']}; no "
        f"kernel launched")
    log(f"train-deepfm-ps-haven (the same job, one shard a primary/backup "
        f"pair in this process, lease {psd['lease_s']} s, the primary "
        f"killed before step {psd['kill_at']} of {psd['steps']}) [{card}]: "
        f"every step done, the backup {psd['backup_role']}; pushes applied "
        f"{psd['applied']}, none twice; {psd['lost_at_kill']} lost at the "
        f"kill (log lag {psd['lag_at_kill']}); blip {psd['blip_ms']:.1f} ms "
        f"over a {psd['healthy_step_ms']:.1f} ms step; "
        f"{len(psd['calls_to_the_dead_primary'])} calls met the dead "
        f"primary ({psd['calls_to_the_dead_primary']}): budget "
        f"{psd['budget_ms']:.1f} ms, tools/haven_bench.py's for that many "
        f"calls ({psd['one_call_budget_ms']:.1f} for its one)")
    log(f"pservers stopped over the wire: {ps['pservers']}; phase walls "
        f"{ps['walls_s']}, train-base-ps-sync's {psa['walls_s']}")
    phase7q_s = time.perf_counter() - t0
    log(f"phase 7q: {phase7q_s:.1f} s; total so far "
        f"{time.perf_counter() - t_start:.1f} s")

    # 7r. the coordination plane: train-base fed by a quorum-fenced master
    # pair whose primary is killed mid-pass, then its replay
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_") as el_tmp:
        el = run_train_base_elastic(torch, ptt, native, el_tmp)
    log(f"train-base-elastic (train-base at batch {el['batch']}, one "
        f"trainer thread on CUDAPlace(0) fed by MasterClient.records from "
        f"a primary/standby Master pair fenced by 3 in-process "
        f"QuorumNodes, lease {el['lease_s']} s, task timeout "
        f"{el['timeout_dur']} s, {el['batches']} batch ids one a task; the "
        f"primary killed by ark.chaos.kill_master at {el['done_at_kill']} "
        f"tasks done, {el['steps_at_kill']} steps taken) [{card}]: the "
        f"standby promoted in {el['promote_s'] * 1e3:.1f} ms (budget "
        f"{el['budget_s'] * 1e3:.1f} ms), {el['promotions']} quorum "
        f"promotion metered and in the flight recorder; no trainer "
        f"failure; pass complete at the promoted master "
        f"({el['master_status']['done']} done, 0 todo, 0 pending); ids "
        f"delivered in order {el['ids']} (re-issued tasks "
        f"{el['reissued']}), a single-issue task once; no two issuing "
        f"masters in {el['samples']} samples (period "
        f"{el['sample_ms_mean']:.2f} ms "
        f"mean, {el['sample_ms_max']:.2f} ms max, {el['sample_ms_asked']:g} "
        f"asked); step {el['step_ms_median']:.1f} ms (median; all "
        f"{[round(x, 1) for x in el['step_ms']]}); the trainer's stall "
        f"{el['stall_ms']:.1f} ms (largest gap {el['gap_ms_max']:.1f} ms "
        f"less the median step), {el['stall_ms_at_kill']:.1f} ms at the "
        f"kill (the gap spanning it {el['gap_ms_at_kill']:.1f} ms); losses "
        f"{[round(x, 4) for x in el['losses']]}, the replay's the same bits "
        f"({el['steps']} steps from the same saved state in "
        f"{el['replay_s']:.1f} s); launches a step "
        f"{el['launches_a_step']}, "
        f"{ {k: v for k, v in el['launches'].items() if v} } in all "
        f"(replay {({k: v for k, v in el['replay_launches'].items() if v})})"
        f"; world up in {el['world_s']:.2f} s, the run {el['s']:.1f} s")
    phase7r_s = time.perf_counter() - t0
    log(f"phase 7r: {phase7r_s:.1f} s; total so far "
        f"{time.perf_counter() - t_start:.1f} s")

    # 7t. the C inference ABI: infer-base through PD_PredictorRun, in this
    # process and from a pure-C client
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capi_") as c_tmp:
        cab = run_capi(torch, ptt, native,
                       os.path.join(infer_tmp.name, "infer_base"), here,
                       c_tmp)
    infer_tmp.cleanup()
    cab["s"] = time.perf_counter() - t0
    if cab["embed_missing"] is not None:
        log(f"phase 7t: this machine's Python cannot be embedded "
            f"({cab['embed_missing']}): the pure-C client was not run")
    log(f"C inference ABI (infer-base, 7m's saved dir, through "
        f"{cab['library']} by ctypes on CUDAPlace(0), the place variable "
        f"unset) [{card}]: {CAPI_BATCHES} batches of {CAPI_BATCH} x "
        f"{TRAIN_BASE['seq_len']}, logits {cab['logits_bytes'] / 1e6:.1f} MB "
        f"a batch, bit for bit those of capi_runtime.Predictor.run and of "
        f"the Executor's prepared run of the loaded program; launches a "
        f"batch {cab['launches']} ({cab['attentions']} fused attentions); "
        f"ms a batch through the ABI "
        f"{[round(x, 2) for x in cab['abi_ms']]} against the prepared "
        f"run's {[round(x, 2) for x in cab['prepared_fetch_ms']]} with the "
        f"logits fetched to numpy and "
        f"{[round(x, 2) for x in cab['prepared_card_ms']]} with them left "
        f"on the card; library built in {cab['build_s']:.2f} s, "
        f"PD_CreatePredictor {cab['create_s']:.2f} s")
    if cab["embed_missing"] is None:
        log(f"C inference ABI, pure-C client (gcc against the port's "
            f"header, its own embedded interpreter; predictor made on its "
            f"main thread, the first batch run from a second pthread) "
            f"[{card}]: its first row of logits bit for bit the in-process "
            f"run's; built in {cab['client_build_s']:.2f} s, predictor "
            f"made at {cab['client_create_s']:.2f} s and first result at "
            f"{cab['client_first_result_s']:.2f} s of its run, "
            f"{cab['client_wall_s']:.2f} s wall")
    log(f"phase 7t: {cab['s']:.1f} s; total so far "
        f"{time.perf_counter() - t_start:.1f} s")

    # 7u. the serving kernels at every head dim the JAX kernels take
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    heads_checks = check_serving_head_dims(torch, fa, pa, flush)
    for kname, cases in heads_checks.items():
        for case, c in cases.items():
            if case == "ragged_T200":
                log(f"{kname} at T 200, causal and not, rate 0.1, B 4 H 8: "
                    f"max_abs_err {c} (tol {TOL}), two launches bit-equal")
                continue
            extra = (f" sdpa {c['library_ms']:.4f} ms"
                     if c.get("library_ms") is not None else "")
            shape = (f"rows={c['rows']} H={c['H']} T={c['T']} D={c['D']} "
                     f"causal" if kname == "flash_fwd" else
                     f"S={c['S']} H={c['H']} Dh={c['D']} BS=16 seq_lens "
                     f"sum {c['total']}, seq_len 0 zeros, poisoned rows "
                     f"unread")
            log(f"{kname} {shape}: max_abs_err {c['err']:.3g} (tol {TOL}), "
                f"two launches bit-equal, kernel {c['ms']:.4f} ms plain "
                f"{c['plain_ms']:.4f} ms{extra} bound {c['bound_ms']:.4f} ms "
                f"({c['bound_by']}) [{card}]")
    t_serve = time.perf_counter()
    heads_serve = run_serve_heads(torch, ptt, native, heads_arms,
                                  heads_host)
    for name, r in heads_serve.items():
        log(f"{name} ({r['heads']} heads of {r['head_dim']}) on the card "
            f"[{card}]: TTFT median {r['ttft_ms_median']:.1f} ms; "
            f"{r['tokens_per_s']:.1f} tokens/s; {r['n_prefill']} prefill "
            f"and {r['n_decode']} decode steps, launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }; tokens equal "
            f"to the host's"
            + (f" for {INT8_REQUESTS - r['host_token_mismatches']} of "
               f"{INT8_REQUESTS} requests ({r['requants']} requantize "
               f"events, host {r['host_requants']}); "
               + "; ".join(r["teacher_forced"]) + f"; first tokens equal to "
               f"the float32 run's ({r['equal_to_fp32']} of {INT8_REQUESTS} "
               f"requests whole)" if "requants" in r else
               f"; prefill logits max_abs_err {r['logit_err']:.3g} (tol "
               f"{LOGIT_TOL})")
            + f"; host child {r['host_s']:.1f} s")
    log(f"phase 7u: {time.perf_counter() - t0:.1f} s (kernel checks "
        f"{t_serve - t0:.1f} s, serving {time.perf_counter() - t_serve:.1f} "
        f"s); total so far {time.perf_counter() - t_start:.1f} s")

    # 7v. the training kernels at every head dim the JAX kernels take
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    train_checks = check_training_head_dims(torch, fa, flush)
    for dtype, dims in train_checks.items():
        sfx = "" if dtype == "float32" else "_bf16"
        tol = (f"tol {TOL}, dq/dkv {BWD_TOL}*(1+|plain|)"
               if dtype == "float32" else "share of the bf16 tolerance")
        for dkey, cases in dims.items():
            errs = {name: {k: round(v, 6) for k, v in c.items()
                           if k.endswith(("_err", "_share", "_by_accuracy"))}
                    for name, c in cases.items()}
            log(f"train kernels {dtype} {dkey} (H {cases['ragged_T200']['H']})"
                f", B 32 T 256 causal and not, rate 0 and 0.1, and B 4 T 200 "
                f"causal rate 0.1: max errors ({tol}) {errs}; two launches "
                f"bit-equal [{card}]")
            c = cases["full_rate0.1"]
            log(f"  timed at B 32 T 256 non-causal rate 0.1: flash_fwd{sfx} "
                f"{c['fwd_ms']:.4f} ms (plain {c['fwd_plain_ms']:.4f}, sdpa "
                f"{c['fwd_library_ms']:.4f}, bound {c['fwd_bound_ms']:.4f} "
                f"{c['fwd_bound_by']}); flash_dq{sfx} {c['dq_ms']:.4f} ms "
                f"(bound {c['dq_bound_ms']:.4f} {c['dq_bound_by']}); "
                f"flash_dkv{sfx} {c['dkv_ms']:.4f} ms (bound "
                f"{c['dkv_bound_ms']:.4f} {c['dkv_bound_by']}); plain "
                f"backward {c['bwd_plain_ms']:.4f} ms; sdpa backward "
                f"{c['bwd_library_ms']:.4f} ms; flash_delta{sfx} "
                f"{c['delta_ms']:.4f} ms (plain {c['delta_plain_ms']:.4f}, "
                f"bound {c['delta_bound_ms']:.4f})")
    t_train = time.perf_counter()
    train_heads = run_train_heads(torch, ptt, native)
    for name, r in train_heads.items():
        log(f"{name} ({r['model']}, B {r['batch']}, {r['steps']} steps) on the "
            f"card [{card}]: losses {[round(x, 4) for x in r['losses']]}, "
            f"median {r['step_ms_median']:.1f} ms a step, "
            f"{r['tokens_per_s']:.0f} tokens/s, peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB, launches "
            f"{ {k: v for k, v in r['launches'].items() if v} } (exact)")
    t_par = time.perf_counter()
    train_heads_parity = run_train_heads_parity(torch, ptt)
    for hd, sides in train_heads_parity.items():
        for side, par in sides.items():
            log(f"train-base-d{hd} {side} parity ({TRAIN_HEADS_PARITY}), "
                f"{par['steps']} step from the host's state: card "
                f"{par['losses']['card']} host {par['losses']['host']}, max "
                f"relative error {par['rel_err']:.3g} (tol "
                f"{par['loss_rtol']:.3g}); the persistables at "
                f"{par['l2_share']:.3g} of {par['l2_tol']}, the parameters "
                f"at {par['param_share']:.3g} (Adam's first update, not "
                f"gated)")
    log(f"phase 7v: {time.perf_counter() - t0:.1f} s (kernel checks "
        f"{t_train - t0:.1f} s, training {t_par - t_train:.1f} s, parity "
        f"{time.perf_counter() - t_par:.1f} s); total so far "
        f"{time.perf_counter() - t_start:.1f} s")
    for tr in lstm_trains.values():
        trace_train_stacked_lstm(torch, tr)
        log(f"{tr['tag']}, one traced step after every timed one: "
            f"{tr['traced_step_ms']:.1f} ms, device busy "
            f"{tr['busy_us'] / 1e3:.1f} ms = {tr['busy_share']:.3f} of it "
            f"({tr['device_events']} device events; "
            f"{tr['busy_over_untraced']:.3f} of the untraced median)")
    traced_s, busy_us, n_events = traced_busy(torch, ssd.pop("step"))
    ssd.update(traced_ms=traced_s * 1e3, busy_us=busy_us,
               busy_share=busy_us / (traced_s * 1e6),
               busy_over_untraced=busy_us / (ssd["step_ms_median"] * 1e3),
               device_events=n_events)
    log(f"train-mobilenet-ssd, one traced step after every timed one: "
        f"{ssd['traced_ms']:.1f} ms, device busy {busy_us / 1e3:.1f} ms = "
        f"{ssd['busy_share']:.3f} of it ({n_events} device events; "
        f"{ssd['busy_over_untraced']:.3f} of the untraced median)")
    trace_train_stacked_lstm(torch, mt)
    log(f"train-mt, one traced step after every timed one: "
        f"{mt['traced_step_ms']:.1f} ms, device busy "
        f"{mt['busy_us'] / 1e3:.1f} ms = {mt['busy_share']:.3f} of it "
        f"({mt['device_events']} device events; "
        f"{mt['busy_over_untraced']:.3f} of the untraced median)")
    traced_s, busy_us, n_events = traced_busy(torch, beam.pop("step"))
    beam.update(traced_ms=traced_s * 1e3, busy_us=busy_us,
                busy_share=busy_us / (traced_s * 1e6),
                busy_over_untraced=busy_us / (beam["ms_median"] * 1e3),
                device_events=n_events)
    log(f"infer-mt-beam, one traced decode: {beam['traced_ms']:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms = {beam['busy_share']:.3f} of "
        f"it ({n_events} device events; {beam['busy_over_untraced']:.3f} "
        f"of the untraced median)")
    for name, b in book.items():
        traced_s, busy_us, n_events = traced_busy(torch, b.pop("step"))
        b.update(traced_ms=traced_s * 1e3, busy_us=busy_us,
                 busy_share=busy_us / (traced_s * 1e6),
                 busy_over_untraced=busy_us / (b["step_ms_median"] * 1e3),
                 device_events=n_events)
        log(f"book {name}, one traced step: {b['traced_ms']:.2f} ms, device "
            f"busy {busy_us / 1e3:.2f} ms = {b['busy_share']:.3f} of it "
            f"({n_events} device events; {b['busy_over_untraced']:.3f} of "
            f"the untraced median)")
    for tag, h in infer16.pop("handles").items():
        feed16 = infer16["feed"]
        traced_s, busy_us, n_events = traced_busy(
            torch, lambda: h.run(feed16, return_numpy=False))
        infer16.setdefault("traced", {})[tag] = dict(
            ms=traced_s * 1e3, busy_us=busy_us,
            busy_share=busy_us / (traced_s * 1e6), device_events=n_events)
        log(f"infer-base {tag}, one traced batch: {traced_s * 1e3:.1f} ms, "
            f"device busy {busy_us / 1e3:.1f} ms = "
            f"{busy_us / (traced_s * 1e6):.3f} of it ({n_events} device "
            f"events)")
    infer16.pop("feed")
    rn50_batch = folded.pop("batch")
    for tag, h in folded.pop("handles").items():
        traced_s, busy_us, n_events = traced_busy(
            torch, lambda: h.run({"image": rn50_batch}))
        folded.setdefault("traced", {})[tag] = dict(
            ms=traced_s * 1e3, busy_us=busy_us,
            busy_share=busy_us / (traced_s * 1e6), device_events=n_events)
        log(f"serve-resnet50 {tag}, one traced batch of "
            f"{SERVE_RN50_LADDER[-1]}: {traced_s * 1e3:.1f} ms, device busy "
            f"{busy_us / 1e3:.1f} ms = {busy_us / (traced_s * 1e6):.3f} of "
            f"it ({n_events} device events)")
    t0 = time.perf_counter()
    lstm_parity = run_stacked_lstm_parity(torch, ptt)
    log(f"stacked-lstm parity, {lstm_parity['steps']} steps from the host's "
        f"state (2 layers x {LSTM_PARITY_WIDTH}, the second reversed, "
        f"lengths {LSTM_PARITY_LENS}): card {lstm_parity['losses']['card']} "
        f"host {lstm_parity['losses']['host']}, max relative error "
        f"{lstm_parity['rel_err']:.3g} (tol {lstm_parity['loss_rtol']:.3g}); "
        f"persistables at {lstm_parity['l2_share']:.3g} of "
        f"{lstm_parity['l2_tol']}; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    seq_sweep = run_seq_op_sweep(torch, ptt, native)
    log(f"sequence op sweep, card vs host: {len(seq_sweep)} cases, "
        f"largest share of SEQ_OP_TOL ({SEQ_OP_TOL} (1 + |host|)) "
        f"{max(c['tol_share'] for c in seq_sweep):.3g}: "
        + ", ".join(f"{c['case']} {c['tol_share']:.2g}" for c in seq_sweep)
        + f"; {time.perf_counter() - t0:.1f} s")

    # 8. the kernels line: flash_fwd's headline numbers at the train path's
    # shape, its serving case beside them
    def pe_launches(kname):
        """A kernel's launches on phase 7n's paths (each rank apart)."""
        out = {"pe_base_1": par1["launches"].get(kname, 0),
               "trainer_parallel": trainer_pe["parallel"]["launches"].get(
                   kname, 0)}
        for name, _, _ in PE_CASES:
            for r, res in enumerate(pe_ranks):
                out[f"{name.replace('-', '_')}_rank{r}"] = \
                    res["cases"][name]["launches"].get(kname, 0)
        return out

    def obs_launches(kname):
        """A kernel's launches on phase 7o's paths."""
        return {"train_base_observed": obs_train["launches_on"].get(kname, 0),
                "train_base_observed_flag_off":
                    obs_train["launches_off"].get(kname, 0),
                "train_base_observed_on_again":
                    obs_train["launches_on_again"].get(kname, 0),
                "serve_base_pulse": obs_serve["launches"].get(kname, 0)}

    def wire_launches(kname):
        """A kernel's launches on phase 7p's paths."""
        out = {"train_base_wire_unquantized":
                   wire_a["ref_launches"].get(kname, 0),
               "train_base_wire_int8": wire_a["launches"].get(kname, 0),
               "pe_base_wire_1": wire_pe1["parallel"]["launches"].get(
                   kname, 0)}
        for name, _, _, _, _ in WIRE_PE_CASES:
            for r, res in enumerate(pe_ranks):
                out[f"{name.replace('-', '_')}_rank{r}"] = \
                    res["cases"][name]["launches"].get(kname, 0)
        return out

    def ps_launches(kname):
        """A kernel's launches on phase 7q's paths (both trainers)."""
        return {"train_base_ps_sync": psa["launches"].get(kname, 0),
                "train_base_ps_sync_timed":
                    psa["raw"]["launches"].get(kname, 0),
                "train_base_ps_sync_int8":
                    psa["int8"]["launches"].get(kname, 0),
                "train_deepfm_ps_async": 0, "train_deepfm_ps_haven": 0}

    def el_launches(kname):
        """A kernel's launches on phase 7r's path (the replay apart)."""
        return {"train_base_elastic": el["launches"].get(kname, 0)}

    def heads_launches(kname):
        """A kernel's launches on phase 7u's serving arms."""
        return {name.replace("-", "_"): r["launches"].get(kname, 0)
                for name, r in heads_serve.items()}

    def train_heads_launches(kname):
        """A kernel's launches on phase 7v's train-base-d8 / -d256 runs."""
        return {name.replace("-", "_"): r["launches"].get(kname, 0)
                for name, r in train_heads.items()}

    def train_heads_dims(dtype, name):
        """Kernel `name` ('fwd', 'dq', 'dkv' or 'delta') over phase 7v's
        checks in `dtype`: a head dim's largest error over its cases, and
        its timed case's times and bound."""
        plain = {"fwd": "fwd_plain_ms",
                 "delta": "delta_plain_ms"}.get(name, "bwd_plain_ms")
        lib = {"fwd": "fwd_library_ms",
               "delta": "delta_library_ms"}.get(name, "bwd_library_ms")
        out = {}
        for dkey, cases in train_checks[dtype].items():
            c = cases["full_rate0.1"]
            out[dkey] = dict(
                H=c["H"], max_abs_err=max(x[f"{name}_err"]
                                          for x in cases.values()),
                by_accuracy=sum(x.get(f"{name}_by_accuracy", 0)
                                for x in cases.values()),
                ms=c[f"{name}_ms"], plain_ms=c[plain],
                library_ms=c.get(lib), bound_ms=c[f"{name}_bound_ms"],
                bound_by=c[f"{name}_bound_by"],
                shape=f"B={c['B']} H={c['H']} T={c['T']} D={c['D']} "
                      f"non-causal rate {c['rate']} {dtype}")
        return out

    def train_heads_err(dtype, name):
        """Kernel `name`'s largest error over phase 7v's checks."""
        return max(v["max_abs_err"]
                   for v in train_heads_dims(dtype, name).values())

    def heads_err(kname):
        """A kernel's largest error over phase 7u's checks."""
        return max(max(c.values()) if k == "ragged_T200" else c["err"]
                   for k, c in heads_checks[kname].items())

    big = max(flash_cases, key=lambda c: (c["rows"] * c["T"] ** 2))
    head = train_cases[0]          # B 32, T 256, non-causal, rate 0.1
    causal_head = train_cases[1]   # the same, causal
    rate0 = train_cases[2]         # the same at rate 0, as SDPA's backward
    train_shape = (f"B={head['B']} H={head['H']} T={head['T']} D={head['D']} "
                   f"non-causal rate {head['rate']} f32")
    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "paddle_tpu/ops/pallas_attention.py:152",
         "launches": train["launches"]["flash_fwd"],
         "launches_by_path": {"train": train["launches"]["flash_fwd"],
                              "train_pallas":
                                  trains["pallas"]["launches"]["flash_fwd"],
                              "serve": launches["flash_fwd"],
                              "serve_int8": serve8["launches"]["flash_fwd"],
                              "serve_swap_v1": swap["launches_by_version"][
                                  "v1"]["flash_fwd"],
                              "serve_swap_v2": swap["launches_by_version"][
                                  "v2"]["flash_fwd"],
                              "serve_base_torrent_p0":
                                  tor["int8"]["launches"]["flash_fwd"],
                              "serve_base_torrent_fp32_p0":
                                  tor["fp32"]["launches"]["flash_fwd"],
                              "serve_resnet50": rn50["launches"]["flash_fwd"],
                              "infer_base_bf16_a_batch":
                                  infer16["launches_per_batch"][
                                      "bfloat16"].get("flash_fwd", 0),
                              "infer_base_float32_a_batch":
                                  infer16["launches_per_batch"][
                                      "float32"].get("flash_fwd", 0),
                              "train_base_memopt":
                                  memopt["launches"].get("flash_fwd", 0),
                              **pe_launches("flash_fwd"),
                              **obs_launches("flash_fwd"),
                              **wire_launches("flash_fwd"),
                              **ps_launches("flash_fwd"),
                              **el_launches("flash_fwd"),
                              "capi_infer_base_a_batch":
                                  cab["launches"][0]["flash_fwd"],
                              **heads_launches("flash_fwd"),
                              **train_heads_launches("flash_fwd")},
         "max_abs_err": max([c["err"] for c in flash_cases]
                            + [c["fwd_err"] for c in train_cases]
                            + list(fwd_edges.values())
                            + [heads_err("flash_fwd"),
                               train_heads_err("float32", "fwd")]),
         "ms": head["fwd_ms"], "plain_ms": head["fwd_plain_ms"],
         "bound_ms": head["fwd_bound_ms"], "bound_by": head["fwd_bound_by"],
         "bound_rate": "3xTF32 on the tensor cores, 495e12 / 3 op/s",
         "bound_cuda_core_ms": head["fwd_bound_f32_ms"],
         "library_ms": head["fwd_library_ms"], "shape": train_shape,
         "causal_ms": causal_head["fwd_ms"],
         "causal_library_ms": causal_head["fwd_library_ms"],
         "build": {k: v for k, v in flash_build.items()
                   if k.startswith("flash_fwd<64,")},
         "serve": {"ms": big["ms"], "plain_ms": big["plain_ms"],
                   "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
                   "bound_cuda_core_ms": big["bound_cuda_core_ms"],
                   "library_ms": big["library_ms"],
                   "shape": f"rows={big['rows']} H=8 T={big['T']} D=64 "
                            f"causal f32"},
         "head_dims": heads_checks["flash_fwd"],
         "train_head_dims": train_heads_dims("float32", "fwd")},
        *({"name": f"flash_{name}", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/flash_bwd_f32.cuh",
           "replaces": f"paddle_tpu/ops/pallas_attention.py:{line}",
           "launches": train["launches"][f"flash_{name}"],
           "launches_by_path": {"train": train["launches"][f"flash_{name}"],
                                **pe_launches(f"flash_{name}"),
                                **obs_launches(f"flash_{name}"),
                                **wire_launches(f"flash_{name}"),
                                **ps_launches(f"flash_{name}"),
                                **el_launches(f"flash_{name}"),
                                **train_heads_launches(f"flash_{name}")},
           "max_abs_err": max([c[f"{name}_err"] for c in train_cases]
                              + [train_heads_err("float32", name)]),
           "head_dims": train_heads_dims("float32", name),
           "ms": head[f"{name}_ms"], "plain_ms": head["bwd_plain_ms"],
           "bound_ms": head[f"{name}_bound_ms"],
           "bound_by": head[f"{name}_bound_by"],
           "bound_rate": "3xTF32 on the tensor cores, 495e12 / 3 op/s",
           "bound_cuda_core_ms": head[f"{name}_bound_f32_ms"],
           "library_ms": head["bwd_library_ms"], "shape": train_shape,
           "causal_ms": train_cases[1][f"{name}_ms"],
           "rate0": {"ms": rate0[f"{name}_ms"],
                     "pair_ms": rate0["dq_ms"] + rate0["dkv_ms"],
                     "library_ms": rate0["bwd_library_ms"],
                     "bound_ms": rate0[f"{name}_bound_ms"],
                     "bound_cuda_core_ms": rate0[f"{name}_bound_f32_ms"]},
           "build": {k: v for k, v in flash_build.items()
                     if k.startswith(f"flash_{name}<64,")},
           "note": "plain_ms and library_ms compute dq, dk and dv together; "
                   "library_ms is SDPA's backward at rate 0, rate0 compares "
                   "like with like"}
          for name, line in (("dq", 215), ("dkv", 266))),
        {"name": "flash_delta", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_delta.cu",
         "replaces": DELTA_REPLACES,
         "launches": train["launches"]["flash_delta"],
         "launches_by_path": {"train": train["launches"]["flash_delta"],
                              "train_pallas":
                                  trains["pallas"]["launches"]["flash_delta"],
                              **pe_launches("flash_delta"),
                              **obs_launches("flash_delta"),
                              **wire_launches("flash_delta"),
                              **ps_launches("flash_delta"),
                              **el_launches("flash_delta"),
                              **train_heads_launches("flash_delta")},
         "max_abs_err": max([c["delta_err"] for c in train_cases]
                            + [train_heads_err("float32", "delta")]),
         "head_dims": train_heads_dims("float32", "delta"),
         "tol_share": max(c["delta_share"] for c in train_cases),
         "tol": f"a row, {DELTA_TOL} x sum |dO O|",
         "ms": head["delta_ms"], "plain_ms": head["delta_plain_ms"],
         "bound_ms": head["delta_bound_ms"], "bound_by": head["delta_bound_by"],
         "library_ms": head["delta_library_ms"], "shape": train_shape,
         "note": "library_ms is torch.linalg.vecdot(dO, O); plain_ms the "
                 "port's former delta, (dO.float() * O).sum(-1)"},
        {"name": "paged_decode", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_decode.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:138",
         "launches": launches["paged_decode"],
         "launches_by_path": {
             "serve": launches["paged_decode"],
             "serve_swap_v1": swap["launches_by_version"]["v1"][
                 "paged_decode"],
             "serve_swap_v2": swap["launches_by_version"]["v2"][
                 "paged_decode"],
             "serve_base_torrent_fp32":
                 tor["fp32"]["launches"]["paged_decode"],
             "serve_resnet50": rn50["launches"]["paged_decode"],
             **obs_launches("paged_decode"),
             **heads_launches("paged_decode")},
         "max_abs_err": max(paged["err"], paged_s1["err"],
                            heads_err("paged_decode")),
         "ms": paged["ms"], "plain_ms": paged["plain_ms"],
         "bound_ms": paged["bound_ms"], "bound_by": paged["bound_by"],
         "library_ms": None, "split": paged["split"],
         "shape": f"S=8 H=8 Dh=64 BS=16 seq_lens={paged['seq_lens']} "
                  f"(sum {paged['total']}) f32",
         "s1": {k: paged_s1[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "split", "seq_lens")},
         "dead_grid_ms": paged_dead["ms"], "timing_floor_ms": floor_ms,
         "build": {k: v for k, v in paged_build.items()
                   if k.startswith("paged_decode.cu:")},
         "head_dims": heads_checks["paged_decode"],
         "note": "library_ms null: no single PyTorch call computes "
                 "attention through a block table"},
        {"name": "paged_decode_q8", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_decode_q8.cu",
         "replaces": "paddle_tpu/ops/paged_attention.py:421",
         "launches": serve8["launches"]["paged_decode_q8"],
         "launches_by_path": {
             "serve_int8": serve8["launches"]["paged_decode_q8"],
             "serve_base_torrent":
                 tor["int8"]["launches"]["paged_decode_q8"],
             **heads_launches("paged_decode_q8")},
         "max_abs_err": max(paged_q8["err"], paged_q8_s1["err"],
                            heads_err("paged_decode_q8")),
         "ms": paged_q8["ms"], "plain_ms": paged_q8["plain_ms"],
         "bound_ms": paged_q8["bound_ms"], "bound_by": paged_q8["bound_by"],
         "library_ms": None, "split": paged_q8["split"],
         "shape": f"S={paged_q8['S']} H=8 Dh=64 BS=16 seq_lens "
                  f"{paged_q8['seq_min']}..{paged_q8['seq_max']} (sum "
                  f"{paged_q8['total']}) int8 cache, f32 scales",
         "s1": {k: paged_q8_s1[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "split")},
         "dead_grid_ms": paged_q8_dead["ms"], "timing_floor_ms": floor_ms,
         "build": {k: v for k, v in paged_build.items()
                   if k.startswith("paged_decode_q8.cu:")},
         "head_dims": heads_checks["paged_decode_q8"],
         "note": "library_ms null: no single PyTorch call computes "
                 "attention through a block table"},
        {"name": "dropout", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/dropout.cu",
         "replaces": "paddle_tpu/ops/pallas_dropout.py:42",
         "launches": trains["pallas"]["launches"]["dropout"],
         "launches_by_path": {
             "train_pallas": trains["pallas"]["launches"]["dropout"],
             "train_unfused_pallas":
                 unfused["float32-pallas"]["launches"]["dropout"],
             "train_amp_pallas": amp_trains["pallas"]["launches"]["dropout"],
             "train_unfused_amp_pallas":
                 unfused["amp-pallas"]["launches"]["dropout"]},
         "mask_writes": trains["pallas"]["launches"]["dropout_mask"],
         "op_ms": drop_cases[0]["op_ms"],
         "max_abs_err": max(c["err"] for c in drop_cases),
         "ms": drop_cases[0]["fwd_ms"], "plain_ms": drop_cases[0]["plain_ms"],
         "bound_ms": drop_cases[0]["fwd_bound_ms"],
         "bound_by": drop_cases[0]["fwd_bound_by"],
         "library_ms": drop_cases[0]["library_ms"],
         "shape": f"{drop_cases[0]['shape']} f32 rate 0.1, forward with Mask",
         "cases": drop_cases,
         "note": "max_abs_err 0: Out, Mask and dX equal the plain version's "
                 "bit for bit; library_ms is torch.nn.functional.dropout; "
                 "ms writes Mask as a fetched Mask makes it, op_ms is the "
                 "launch train-base's forward makes (no Mask)"},
    ]
    bf16_head = bf16_cases[0]      # B 64, T 256, non-causal, rate 0.1
    bf16_shape = (f"B={bf16_head['B']} H={bf16_head['H']} T={bf16_head['T']} "
                  f"D={bf16_head['D']} non-causal rate {bf16_head['rate']} "
                  f"bf16")
    amp_auto, amp_pallas = amp_trains["auto"], amp_trains["pallas"]
    kernels += [
        {"name": f"flash_{name}_bf16", "route": "cuda",
         "source": f"paddle_tpu_torch/csrc/{src}",
         "replaces": f"paddle_tpu/ops/pallas_attention.py:{line}",
         "dtype": "bfloat16",
         "launches": amp_auto["launches"][f"flash_{name}_bf16"],
         "launches_by_path": {
             "train_amp": amp_auto["launches"][f"flash_{name}_bf16"],
             "train_amp_pallas": amp_pallas["launches"][f"flash_{name}_bf16"],
             "infer_base_bf16_a_batch": infer16["launches_per_batch"][
                 "bfloat16"].get(f"flash_{name}_bf16", 0),
             **train_heads_launches(f"flash_{name}_bf16")},
         "max_abs_err": max([c[f"{name}_err"] for c in bf16_cases]
                            + [train_heads_err("bfloat16", name)]),
         "head_dims": train_heads_dims("bfloat16", name),
         "tol_share": max(c[f"{name}_share"] for c in bf16_cases),
         "tol": f"per element, {BF16_ULPS} bf16 ulps of |plain| + "
                f"{BF16_ROW_TOL} x the row's max |plain| + {BF16_ATOL} x "
                f"max|plain|, or no further from the float64 value than "
                f"the plain version (+ {BF16_ULPS} ulp)",
         "by_accuracy": sum(c.get(f"{name}_by_accuracy", 0)
                            for c in bf16_cases)
                        + sum(v["by_accuracy"] for v in train_heads_dims(
                            "bfloat16", name).values()),
         "ms": bf16_head[f"{name}_ms"],
         "plain_ms": bf16_head["fwd_plain_ms" if name == "fwd"
                              else "bwd_plain_ms"],
         "bound_ms": bf16_head[f"{name}_bound_ms"],
         "bound_by": bf16_head[f"{name}_bound_by"],
         "bound_rate": "bf16 on the tensor cores, 989e12 op/s; 3.35e12 B/s",
         "library_ms": bf16_head["fwd_library_ms" if name == "fwd"
                                else "bwd_library_ms"],
         "shape": bf16_shape,
         "causal_ms": bf16_cases[1][f"{name}_ms"],
         "rate0": {"ms": bf16_cases[2][f"{name}_ms"],
                   "library_ms": bf16_cases[2]["fwd_library_ms"
                                               if name == "fwd"
                                               else "bwd_library_ms"],
                   "bound_ms": bf16_cases[2][f"{name}_bound_ms"]},
         "rate0_causal": {"ms": bf16_cases[3][f"{name}_ms"],
                          "library_ms": bf16_cases[3]["fwd_library_ms"
                                                      if name == "fwd"
                                                      else "bwd_library_ms"],
                          "bound_ms": bf16_cases[3][f"{name}_bound_ms"]},
         "build": {k: v for k, v in flash_build.items()
                   if k.startswith(f"flash_{name}_bf16<64,")},
         **({} if name == "fwd" else {
             "delta_ms": bf16_head["delta_ms"],
             "backward_ms": bf16_head["backward_ms"],
             "library_rate0_ms": bf16_head["bwd_library_rate0_ms"]}),
         "note": ("library_ms is SDPA in bf16 at the same rate"
                  if name == "fwd" else
                  "plain_ms computes dq, dk and dv together; library_ms is "
                  "SDPA's bf16 backward at the same dropout_p (all three "
                  "grads, its own delta included), library_rate0_ms at 0; "
                  "backward_ms is what _flash_backward launches: "
                  "flash_delta (delta_ms), dQ and dK/dV")}
        for name, src, line in (("fwd", "flash_fwd.cu", 152),
                                ("dq", "flash_bwd_bf16.cu", 215),
                                ("dkv", "flash_bwd_bf16.cu", 266))]
    kernels.append(
        {"name": "flash_delta_bf16", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_delta.cu",
         "replaces": DELTA_REPLACES, "dtype": "bfloat16",
         "launches": amp_auto["launches"]["flash_delta_bf16"],
         "launches_by_path": {
             "train_amp": amp_auto["launches"]["flash_delta_bf16"],
             "train_amp_pallas": amp_pallas["launches"]["flash_delta_bf16"],
             **train_heads_launches("flash_delta_bf16")},
         "max_abs_err": max([c["delta_err"] for c in bf16_cases]
                            + [train_heads_err("bfloat16", "delta")]),
         "head_dims": train_heads_dims("bfloat16", "delta"),
         "tol_share": max(c["delta_share"] for c in bf16_cases),
         "tol": f"a row, {DELTA_TOL} x sum |dO O|",
         "ms": bf16_head["delta_ms"], "plain_ms": bf16_head["delta_plain_ms"],
         "bound_ms": bf16_head["delta_bound_ms"],
         "bound_by": bf16_head["delta_bound_by"], "library_ms": None,
         "shape": bf16_shape,
         "note": "library_ms null: no one PyTorch call sums bf16 products "
                 "into a float32 result; plain_ms is the port's former "
                 "delta, three PyTorch passes"})
    kernels.append(
        {"name": "dropout_bf16", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/dropout.cu",
         "replaces": "paddle_tpu/ops/pallas_dropout.py:42",
         "dtype": "bfloat16",
         "launches": amp_pallas["launches"]["dropout_bf16"],
         "launches_by_path": {
             "train_amp_pallas": amp_pallas["launches"]["dropout_bf16"],
             "train_unfused_amp_pallas":
                 unfused["amp-pallas"]["launches"]["dropout_bf16"]},
         "mask_writes": amp_pallas["launches"]["dropout_mask"],
         "op_ms": drop_cases_bf16[0]["op_ms"],
         "max_abs_err": max(c["err"] for c in drop_cases_bf16),
         "ms": drop_cases_bf16[0]["fwd_ms"],
         "plain_ms": drop_cases_bf16[0]["plain_ms"],
         "bound_ms": drop_cases_bf16[0]["fwd_bound_ms"],
         "bound_by": drop_cases_bf16[0]["fwd_bound_by"],
         "library_ms": drop_cases_bf16[0]["library_ms"],
         "shape": f"{drop_cases_bf16[0]['shape']} bf16 rate 0.1, forward "
                  f"with Mask",
         "cases": drop_cases_bf16,
         "note": "launches: train-base-amp under pallas, "
                 f"{TRAIN_AMP_PALLAS_STEPS} steps; its two float32 sites "
                 "launch the float32 kernel; max_abs_err 0: bit for bit"})
    total_s = time.perf_counter() - t_start
    log(f"total {total_s:.1f} s")
    out_dir = os.path.join(here, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_book.json"), "w") as f:
        json.dump({"card": card, "phase_s": book_s, "total_s": total_s,
                   "chapters": book}, f, indent=1)
    with open(os.path.join(out_dir, "chip_smoke_train.json"), "w") as f:
        json.dump({"card": card, "total_s": total_s, "train": trains,
                   "parity": parities, "serve_int8": serve8,
                   "serve_base_swap": swap, "serve_resnet50": rn50,
                   "train_resnet50": resnet, "vision_parity": vision_parity,
                   "train_resnet50_reader": rdr,
                   "train_amp": amp_trains, "train_resnet50_amp": resnet_amp,
                   "amp_parity": amp_parity, "bf16_kernels": bf16_cases,
                   "train_unfused": unfused, "unfused_parity": unfused_parity,
                   "zoo": zoo, "se_resnext50_parity": se_parity,
                   "sweep": sweep, "train_stacked_lstm": lstm_trains,
                   "stacked_lstm_parity": lstm_parity,
                   "seq_op_sweep": seq_sweep, "train_mt": mt,
                   "train_deepfm_auc": dauc, "breadth": breadth,
                   "train_mobilenet_ssd": ssd, "item6_bank": item6,
                   "infer_base_bf16": infer16,
                   "serve_resnet50_folded": folded,
                   "train_base_memopt": memopt,
                   "infer_mt_beam": beam,
                   "parallel": {"h100_rates": {"bf16_matmul_flops": peak_flops,
                                               "copy_bytes_per_s": copy_bw},
                                "offsets": offsets, "pe_base_1": pe1,
                                "ranks": pe_ranks, "trainer": trainer_pe,
                                "phase_s": phase7n_s},
                   "health_plane": {"train_base_observed": obs_train,
                                    "serve_base_pulse": obs_serve,
                                    "flight_stitch": obs_flight,
                                    "clis": obs_clis, "phase_s": phase7o_s},
                   "wire_plane": {"train_base_wire_int8": wire_a,
                                  "host_codec": wire_b,
                                  "pe_base_wire_1": wire_pe1,
                                  "pe_base_wire_dp2": wire_dp2,
                                  "clis": wire_cli, "phase_s": phase7p_s},
                   "ps_plane": dict(ps, phase_s=phase7q_s),
                   "coordination_plane": {"train_base_elastic": el,
                                          "phase_s": phase7r_s},
                   "fleet_plane": {"serve_base_torrent": tor,
                                   "phase_s": tor["s"]},
                   "capi": cab,
                   "serve_head_dims": {"checks": heads_checks,
                                       "serve": heads_serve},
                   "train_head_dims": {"checks": train_checks,
                                       "train": train_heads,
                                       "parity": train_heads_parity},
                   "flash_build": flash_build, "kernels": kernels}, f,
                  indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--pe-rank":
        sys.exit(_pe_rank_main(sys.argv[2]))
    if len(sys.argv) == 5 and sys.argv[1] == "--flight-child":
        sys.exit(_flight_child_main(*sys.argv[2:]))
    if len(sys.argv) == 5 and sys.argv[1] == "--pserver-child":
        sys.exit(_pserver_child_main(*sys.argv[2:]))
    if len(sys.argv) == 4 and sys.argv[1] == "--serve-heads-child":
        sys.exit(_serve_heads_child_main(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
