#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py               # every phase (needs one card)
    python3 chip_smoke.py --phases train,train_agree,kernels
    python3 chip_smoke.py --phases finetune,finetune_agree,kernels
    python3 chip_smoke.py --phases longctx,longctx_agree,kernels
    python3 chip_smoke.py --phases dp,dp_packed,dp_agree,kernels
    python3 chip_smoke.py --phases sp,sp_agree,kernels
    python3 chip_smoke.py --phases sp_graph,sp_graph_agree,kernels
    python3 chip_smoke.py --phases zero,zero_agree,dp_graph,kernels
    python3 chip_smoke.py --phases eval,eval_agree,kernels
    python3 chip_smoke.py --phases serve_opts,serve_opts_agree,beam,kernels
    python3 chip_smoke.py --phases lenet,lenet_agree,checkpoint,kernels
    python3 chip_smoke.py --phases transfer,transfer_agree,kernels
    python3 chip_smoke.py --phases mlm,mlm_agree,resnet,resnet_agree
    python3 chip_smoke.py --phases charrnn,charrnn_agree
    python3 chip_smoke.py --phases attn_dims,dp_resnet,dp_resnet_agree,inference,kernels
    python3 chip_smoke.py --phases capture,capture_agree,attn_dims,kernels
    python3 chip_smoke.py --phases profile    # device-time breakdown

Drives ``deeplearning4j_tpu_torch`` (never JAX, never the JAX package):

1. device — card name, count, and ``nvidia-smi`` name/power limit; then
   every ported CUDA kernel of ``ops/kernel_registry.py`` is built from
   the checkout's sources (one ``nvcc`` per CUDA source, all started
   together), whatever the phases, and ptxas' registers, spills and
   stack are printed for every kernel instantiation (with the dynamic
   shared memory of the tensor-core ones);
2. serve — the full-width GPT-2-small-class LM (vocab 50257, hidden 768,
   12 layers, 6 heads of 128, SwiGLU 8/3, tied embeddings, bfloat16,
   random weights from a seed) behind ``ServingGateway(max_slots=32,
   block=16, max_context=2048)``: 32 seeded requests, prompts of 16 to
   1500 tokens, 64 new tokens each;
3. agree — the same model in float32: the card's prefill logits and 8
   teacher-forced decode steps against the port on the CPU (the plain
   versions), for one 300-token prompt;
4. serve_opts — four gateways at the serve width (bfloat16,
   ``max_slots=32``, ``block=16``, ``max_context=2048``) each run one
   burst of the port's ``gen_shared_prefix_requests`` (32 requests, a
   1 024-token system prompt and 16-256-token suffixes, 64 new tokens)
   through ``run_trace(mode="burst")``: (a) no options, (b)
   ``prefix_sharing=True, spec_k=4``, (c) ``serve_quant="int8",
   cache_quant="int8"``, (d) all four. Each stream 64 in-vocab tokens,
   the pager's invariants and every page freed, exact launches (K1 12 a
   dense admission, K2 25 an admission and a step); (b) and (d) hit the
   prefix index and draft. (b) may leave (a)'s tokens, and (d) (c)'s,
   only at a near tie: where the reference's top two logits (from a
   second, untimed burst) lie within twice the measured bf16 difference
   of the two paths, which must itself stay within the paths' float32
   difference plus twice the single-token path's bf16 error. Then the
   request-at-a-time baseline on the same traffic, and the decode step
   with the int8 cache and with int8 weights against bf16;
5. serve_opts_agree — the serve model in float32 with int8 weights and
   the int8 cache (TF32 off), card against CPU within ``AGREE_TOL``: a
   300-token prefill and 8 decode steps, the verify step against 4
   single-token steps from one pool, the suffix prefill of a sharer
   against the same suffix run token by token (and, with the float
   cache, against the dense prefill); the quantisers give the same bits
   on both devices;
6. beam — ``generate_beam`` at the serve width in bfloat16, B = 4
   prompts of 300 tokens, 32 new tokens, 4 beams, without and with both
   int8 options: two calls equal, ``beams=1`` equal to greedy
   ``generate``, K1 12 and K2 800 launches a call;
7. train — the same model built by ``CausalTransformerLM(...).init(1024)``
   (bfloat16 compute, the model's AdamW) trained by ``net.fit(x, y)`` on
   one fixed batch of 16 x 1024 random tokens: 2 warm steps, then 8
   timed steps; every loss finite and the last below the first, and each
   training kernel launched its expected number of times per step;
8. train_agree — the same model in float32 (TF32 off), one step at
   B = 2, T = 256: the card's loss and every gradient against the port
   on the CPU;
9. finetune — BERT-base at full width and depth (vocab 30522, hidden
   768, 12 layers, 12 heads of 64, FFN x4, max_len 512, dropout 0.1,
   bfloat16 compute, the model's AdamW, random weights from a seed)
   built by ``BertBase(...).init_classifier(2, 128)`` and trained by
   ``ComputationGraph.fit([tokens, segments], [labels],
   features_masks=[mask, mask])`` on one fixed padded sentence-pair
   batch of 64 x 128 (lengths 32..128): 2 warm steps, then 8 timed
   steps; every loss finite, and the mean of the last two below the
   mean of the first two (under dropout a single step's loss is noisy);
   each kernel launched exactly its registry count per step; then one
   ``output(...)`` whose rows each sum to 1;
10. finetune_agree — BERT-base in float32 with dropout 0 (a CUDA and a
   CPU ``torch.Generator`` draw different masks) and TF32 off, one step
   at B = 4, T = 128 with a key mask: the card's loss and every gradient
   against the port on the CPU;
11. longctx — the serve phase's LM at a 32 768-token context, built by
   ``CausalTransformerLM(..., max_len=32768).init(32768)`` (bfloat16
   compute, the model's AdamW) and trained by ``net.fit(x, y)`` on one
   fixed batch of 1 x 32 768 random tokens: 1 warm step, then 3 timed
   steps. Past 24 576 query rows the attention backward takes the split
   pair K4 (dq) + K5 (dk/dv) instead of the fused K3, by the JAX
   package's own test; every loss finite and the last below the first,
   each kernel launched exactly its registry count per step (K3 none);
12. longctx_agree — the same model in float32 (TF32 off), one step at
   B = 2, T = 256 with the fused backward's budget set to 0, so the
   card's backward runs K4 + K5: its loss and every gradient against
   the port on the CPU;
13. dp — ``initialize_distributed()`` (this process alone, a
   ``"cpu:gloo,cuda:nccl"`` group: NCCL for CUDA tensors, gloo for CPU
   ones), then the train phase's LM and batch through
   ``SharedTrainingMaster().make_wrapper(net, data_parallel_mesh())`` →
   ``ParallelWrapper.fit`` (ENCODED: threshold-encoded gradients, the
   decoded update summed over the group): 2 warm steps, then 8 timed;
   every loss finite and the last below the first, the train kernels'
   launches exactly, K10 and K11 none;
14. dp_packed — the same LM and batch in a step loop over the data group:
   ``loss_and_grads`` → ``EncodedGradientsAccumulator.exchange_packed``
   (K10 once a parameter leaf, the packed words all-gathered, K11 once a
   leaf and rank) → ``apply_updates``; 2 warm and 8 timed steps, the
   launches exactly (K10 = the net's parameter leaves, K11 = leaves ×
   ranks);
15. dp_agree — one f32 step (TF32 off) of ENCODED and of the packed
   exchange at B = 2, T = 256 from the same weights, card against CPU in
   the same group (the CPU tensors over gloo): the loss, the decoded
   updates (all but the codes flipped at |g| ≈ τ equal) and the
   residuals (where the codes agree, to 1e-3 of the leaf's largest
   gradient);
16. sp — ``initialize_distributed()`` (this process alone), then
   ``make_mesh({"seq": 1})`` and ``distributed_context``: the longctx
   phase's LM built with ``sequence_parallel="zigzag_ring"`` and trained
   by ``net.fit(x, y)`` on the same 1 x 32 768 batch, 1 warm and 3
   timed steps. Each layer's attention is the zigzag ring at one rank:
   four half-chunk block pairs of 16 384 rows a step through
   ``flash_block_fwd`` (K1) and ``flash_block_bwd`` (K3: the half's rows
   fit the fused budget), one pair wholly above the diagonal; every loss
   finite and the last below the first, each kernel launched exactly its
   registry count per step;
17. sp_agree — one f32 step (TF32 off) of the train phase's model at
   B = 2, T = 256 under the seq-1 context for each of ``ring``,
   ``zigzag_ring`` and ``ulysses``: the card's loss and every gradient
   against the same step without the context on the card, and against
   the same step under the context on the CPU;
   sp_graph — BERT-base's classifier (``BertBase(...).conf_classifier(2,
   512)``, bfloat16 compute, dropout 0.1, the model's AdamW) with every
   encoder block's ``sequence_parallel="ring"``, a ``ComputationGraph``
   trained by ``fit([tokens, segments], [labels], features_masks=[m,
   m])`` under the seq-1 context on one fixed padded batch of 16 x 512
   (``_finetune_batch(4, 16, 512)``: lengths 68..502, 3 850 live
   tokens): 2 warm and 8 timed steps between zeroed and read
   launch counters (K1 12, K3 12, K8 26, K9 26 a step: the ring's one
   block pair a layer, the LayerNorms), the loss finite and falling, ms
   a step, samples/s and the peak memory; then the context's cost at one
   rank: ``SP_GRAPH_PAIRS`` pairs of one step with the context and one
   without, alternating which goes first, each pair's difference and
   their mean with two standard errors (the host's spread moves both
   steps of a pair alike, so the pairs separate a cost of about 1 %);
   ``output`` under the context gives rows summing to 1;
   sp_graph_agree — in f32 (TF32 off, dropout 0), one step of that
   classifier at B = 2, T = 512 for each of ``ring`` and ``ulysses``,
   and of three pooled ``MultiLayerNetwork``s on [2, 256, 128] inputs
   (a causal ``zigzag_ring`` encoder block, then: masked average
   ``GlobalPoolingLayer`` → ``OutputLayer``; ``LearnedSelfAttentionLayer``
   → ``DenseLayer`` on [B, Q, F] → ``OutputLayer``; an ``OutputLayer``
   flattening [B, T, F]): the card under the context against the card
   without it and against the CPU under it, the loss and every gradient
   in train_agree's bands, K1 and K3 launched;
18. zero — the train phase's LM and batch through ``ParallelWrapper(net,
   mesh=data_parallel_mesh(), sharded_update=True)`` on the one-rank
   group of the dp phases (the ZeRO sharded update: one reduce-scatter a
   flat gradient leaf, the update on the rank's slice against its 1/N
   optimizer state, one all-gather a leaf), then the same with
   ``gather_overlap=True``: each 2 warm and 8 timed steps, the step ms,
   tokens/s, peak GB and the ``OPT_STATE_BYTES`` reading, every loss
   finite and the last below the first, the train kernels' launches
   exactly;
19. zero_agree — the train model in float32 (TF32 off) at B = 2,
   T = 256: replicated SYNC, the sharded update and the overlap take two
   steps each from one gradient and must end bit for bit alike (params
   and the gathered optimizer state); then one sharded step through
   ``fit`` on the card against the CPU: the loss and the
   reduce-scattered gradient in train_agree's bands;
20. dp_graph — BERT-base's classifier (the finetune phase's model)
   through ``ParallelWrapper(graph, sharded_update=True)`` on the same
   group, the fine-tune batch as full-length rows (no masks, so K1 and
   K3 run unmasked): 2 warm and 8 timed steps, the loss falling, the
   launches exactly, then one ``output`` whose rows each sum to 1;
21. eval — the finetune phase's model (BERT-base, bfloat16 compute)
   evaluated by ``net.evaluate`` over 16 fixed full-length batches of
   64 x 128 (1 024 samples, no masks): one warm pass, then 3 timed
   passes, each between zeroed and read launch counters (exactly K1 12
   and K8 26 a batch, no other kernel), in turns with the bare
   ``output`` loop over the same batches (samples/s of both, the median
   of 3 passes after one warm, each from a synchronised card to a
   synchronised card, and the peak memory); then in the dp phases'
   one-rank group
   ``SparkComputationGraph(net, master).evaluate(batches,
   num_classes=2)`` and ``do_evaluation`` with all seven evaluation
   classes, each with the local confusion matrix; then the dense net of
   ``tests/test_multiprocess.py`` trained 8 epochs on the card and put
   through ``evaluate`` and ``evaluate_regression``;
22. eval_agree — BERT-base in float32 (dropout 0, TF32 off), 2 batches
   of 16 x 128: the card's probabilities against the port on the CPU
   within ``AGREE_TOL``, any argmax that differs on a row whose top two
   lie within twice the observed error, and the seven classes fed the
   card's tensors equal to the bit to the same fed numpy arrays;
23. kernels — holds each ported kernel against its plain PyTorch version
   on the card at its main paths' shapes, in bfloat16 (for K1, K3, K4
   and K5 the tensor-core kernels of ``csrc/flash_mma.cuh``) and float32
   (their CUDA-core kernels), including operands whose base and strides
   are not whole 16-byte chunks, and times the kernel, the plain version
   and a PyTorch library call that computes the same function (a
   yardstick the port never calls). K1 is timed at the serve, train,
   fine-tune and long-context shapes beside SDPA, K3, K4 and K5 at the
   train and long-context shapes (K3 also at the fine-tune shape, with a
   key mask and without) beside SDPA's backward, each with its achieved
   TFLOP/s and share of its bound (for K3, K5 in bf16 the key-stationary
   tensor-core loop of ``csrc/flash_mma.cuh``). At the long-context
   shape the split pair is also held against K3, and K4's dq and K5's
   dk, dv must be the same to the bit over two runs; K10 and K11 are
   held to the bit (words, residuals, decoded values, and four emulated
   ranks' decode-sum), K11 also at every leaf shape of the packed step
   and at ragged sizes, and it fails over ``K11_BAR_MS`` at the
   embedding leaf. The ring's block
   entries ``flash_block_fwd``/``flash_block_bwd`` (K1; K3), and K4 and
   K5 through their ``offsets``, are held against their plain versions
   at T_loc = 2048, H = 6, D = 128 for all 16 (rank, source) block pairs
   of a 4-rank causal ring and the four half-chunk pairs of a 2-rank
   zigzag ring, bf16 and f32, without and with a ragged key mask, and
   once with GQA; a block wholly above the diagonal must give exact
   zeros and a −inf lse. The
   kernels and SDPA are timed by the replay of a CUDA graph of their
   calls (20 for the small ones), which keeps the host's launch path out
   of the time; the plain versions of K3, K4 and K5 by CUDA events
   around their calls. For the small norm kernels (K2, K6, K7, K8, K9)
   the host-side time per launch (CUDA events around 20 launches) is
   printed beside it as ``host_ms``. The norm backwards K6 and K9 (the
   CUDA kernel of ``csrc/norm_bwd.cu``) are held at their main paths'
   shapes (K6 also at the long-context [32768, 768]), at a row whose
   byte length is not a multiple of 16 and at wide rows (``NORM_BWD_CASES``),
   their dγ and dβ must be the same to the bit over two calls, and each
   case prints its share of the bound; the phase fails where one is
   slower than its PyTorch call (but at those off-path rows; each side
   the median of ``NORM_BAR_PAIRS`` alternating turns), or below half of
   its bound at the main path's shape. This phase runs last, so that
   nothing it leaves behind in the process can slow the host-bound serve
   step (``PERF.md`` records such a slowdown, cause not isolated).

Before kernels, after the training-runtime phases (train_opts,
train_opts_agree, finetune_opts — which profiles its K = 4 region once
more with a ``ScoreIterationListener(1)`` attached: still one
device-to-host copy and no host wait — and serve_fault):

- lenet — LeNet at its published widths (1 256 080 parameters,
  Nesterovs) on synthetic MNIST, 2048 training and 512 test examples,
  batch 64, 2 epochs behind ``AsyncDataSetIterator(queue_size=4)`` with
  the five listeners (Score, Performance, CollectScores, Evaluative a
  epoch, Checkpoint a epoch keeping 2): the loss finite and falling,
  test accuracy above 0.97, exactly 2 checkpoints that verify, the
  newest restored on the card with the same output; the small CNN of
  ``tests/test_real_digits.py`` to ≥ 0.95 on the real 8×8 digits; no
  ported kernel launched; the mean step with listeners and without
  (median of 3 turns), one checkpoint write and the zip's size, the
  peak memory;
- lenet_agree — LeNet in float32 (TF32 off) from a JAX-shaped numpy
  weight tree: one step's loss and gradients and the output, card vs
  the port on the CPU, in ``train_agree``'s bands; a zip written on the
  card restored through the CPU port to the same output;
- checkpoint — BERT-base's classifier at full width in float32 (TF32
  off) on the finetune phase's batches: 2 steps, ``write_model`` with
  the updater state, a restore on the card and 2 more steps against 4
  uninterrupted, each loss within 1e-5 relative and each parameter
  within 1e-3 of its largest value; K1, K3, K8 and K9 launch as in
  finetune; the zip's size and the write and restore times;
- transfer — transfer learning on the train LM: the source trained as
  phase train trains it (2 warm and 8 timed steps: the full fine-tune's
  figures in this run), then ``TransferLearning.builder(net)`` with
  ``FineTuneConfiguration(updater=Adam(1e-4), learning_rate=5e-5,
  weight_decay=0.01, l2=1e-6)`` and ``set_feature_extractor(6)``: the
  embedding and blocks 1–6 frozen (the tie to the embedding kept), 1
  warm and 8 timed ``fit`` steps: the frozen groups equal to the bit,
  every other group moved, the loss finite and falling, the launches
  exactly K1 12, K2 13, K7 12 and — the backward stopping at block 7 —
  K3 6 and K6 13 a step; the step ms, tokens/s, peak memory and
  optimizer-state bytes beside the full fine-tune's. Then
  ``TransferLearningHelper`` refusing the tie across the split, and, on
  a head-swapped copy in f32 (TF32 off), one ``fit_featurized`` Sgd step
  against one full-net step (train_agree's bands); then the net's zip
  written and restored on the card and 2 more f32 steps on each (at
  128 tokens, where K3's dq atomics commute) equal to the bit, the
  parameters and every group's optimizer state;
- transfer_agree — the LM at full width cut to 4 blocks (2 frozen), f32,
  TF32 off, B = 2, T = 256, the same transfer with an l1 term and a
  ``MaxNormConstraint(0.9)`` on the first trainable block: loss and
  every gradient card vs CPU, the update of the card's gradient on both
  (train_agree's bands), a ``fit`` step on the card (frozen equal,
  the constraint held, launches K1 4, K2 5, K3 2, K6 5, K7 4 a step over
  the two), weight noise on the card by its statistics (mean, standard
  deviation, DropConnect's keep rate within 5 standard errors) and the
  masters untouched by a noisy step;
- mlm — BERT-base's masked-LM head at full width built by
  ``BertBase(...).init_mlm(128)`` (bfloat16 compute on f32 masters,
  AdamW at BERT pretraining's 1e-4, dropout 0.1) and trained by
  ``fit(BertIterator(...))`` at B = 32, T = 128 over a synthetic
  WordPiece vocabulary of exactly 30 522 entries (Zipf-drawn words from
  a seed; one-hot [B, T, V] labels, key masks, labels masks): 2 warm and
  8 timed steps between zeroed and read launch counters (K1 12, K3 12,
  K8 26, K9 26 a step, as finetune), then the same 8 steps from batches
  built beforehand; the loss per scored position finite and falling,
  the step ms and samples/s both ways, the iterator's batch build
  alone, the peak memory, one profiled step's top kernels, the head's
  three GEMMs (N = 30 522) alone with their cuBLAS kernels; ``output``
  gives [B, T, V] rows summing to 1;
- mlm_agree — the same head in f32 (dropout 0, TF32 off), one step at
  B = 4 on an iterator batch: loss and every gradient card vs CPU in
  train_agree's bands;
- resnet — ``ResNet50(num_classes=1000, input_shape=(224, 224, 3),
  compute_dtype="bfloat16").init()`` (25 557 032 parameters, the zoo's
  Nesterovs 0.1/0.9) trained by ``fit(x, y)`` on one synthetic ImageNet
  batch of 128 from a seed: 2 warm and 8 timed steps, every loss
  finite, no ported kernel launched, images/s, the peak memory, one
  batch norm's running statistics moved; ``output`` in eval mode rows
  summing to 1; the trained net's zip restored on the card equal to the
  bit (params, state, updater state); one profiled step's device time
  split into convolution, batch norm/elementwise and the rest, the SAME
  pads and cuDNN layout conversions counted, and the memory format
  around every convolution of one forward and backward;
- resnet_agree — ResNet-50 at 224², one step at B = 2 (TF32 off): in
  f64, loss, every gradient and every running statistic card vs CPU
  (train_agree's bands, the statistics within 1e-5 relative); in f32 the
  loss and the statistics in the same bands and each device's gradient
  against the CPU's f64 one, the card's no farther than twice the CPU's
  (the f32 gradient is ill-conditioned at B = 2: either device's lies up
  to ~20 % of a leaf's largest element from f64); then the eval output
  and pooled features reading the step's statistics within
  ``AGREE_TOL``;
- charrnn — the BASELINE's config #3, the GravesLSTM char-RNN built by
  ``TextGenerationLSTM(vocab_size=77, hidden=512, layers=2,
  tbptt=50).init()`` (f32, the zoo's Adam 1e-3) and trained by
  ``fit(x, y)`` with truncated BPTT on one-hot [64, 200, 77] batches of
  a seeded Markov text (4 segments a batch): 2 warm and 8 timed batches,
  synchronised card to card, between zeroed and read launch counters
  (no ported kernel); the loss finite and falling; ms a batch and a
  segment, chars/s, the peak memory; one profiled batch: the kernel
  launches, GEMM against elementwise device time, busy against idle;
  then ``rnn_clear_previous_state`` and 200 greedy characters through
  ``rnn_time_step``, one at a time (ms a step, chars/s, two runs equal);
- charrnn_agree — in f32 (TF32 off): one tBPTT batch of the char-RNN at
  hidden 512 (B = 4, T = 100, k = 50; Sgd in place of Adam) on the card
  and on the CPU from the same weights, the last segment's loss within
  1e-5 relative and every parameter within 1e-3 of its leaf's largest
  value, then 16 ``rnn_time_step`` steps within ``CHARRNN_STEP_TOL``;
  the golden ``TextGenerationLSTM`` zip restored on the card against its
  minting forward within ``CHARRNN_GOLDEN_TOL``; and a
  ``SelfAttentionLayer`` → LSTM → ``RecurrentAttentionLayer`` →
  ``LearnedSelfAttentionLayer`` net (n_out 256, 4 heads of 64, a key
  mask) whose forward and backward on the card launch K1 and K3 exactly
  ``CHARRNN_ATT_T + 2`` times each (Tq = 1 in the recurrent layer's
  steps, Tq = 4 learned queries), its loss and gradients against the CPU
  in train_agree's bands;
- dp_resnet — the resnet phase's ResNet-50 (224², bf16 on f32 masters)
  under ``ParallelWrapper(net, mesh=data_parallel_mesh())`` in SYNC at
  one rank, ``fit`` on one host batch of 128: 2 warm and 8 timed steps
  in turns with plain ``fit`` on a second net (no ported kernel), ms a
  step, images/s, peak memory, the wrapper's overhead, one profiled step
  of each; the trained net stays for inference;
- dp_resnet_agree — in f32 (TF32 off, cuDNN deterministic) at B = 16,
  3 steps of the wrapper against plain ``fit`` from the same weights:
  the parameters and one batch norm's running statistics within
  ``DP_AGREE_TOL`` of their largest value;
- inference — ``ParallelInference`` BATCHED serving the net dp_resnet
  trained, in f32: 64 one-image requests from 8 threads, each result
  against ``output`` on the stacked batch (rtol 1e-4, atol 1e-5), p50
  and p99 latency and images/s; an injected ``serving`` fault answered
  fast while the same worker serves on;
- attn_dims — K1, K3 and K4 + K5 at head dims 2, 24, 48, 80, 96, 160
  and 256 (zero-padded to the next of 16, 32, 64, 128 and 256) in bf16
  and f32, causal and key-masked, against their plain versions, each
  case launching exactly K1, K3, K4 and K5 once; K1 timed beside
  SDPA; the reference's ``SelfAttentionLayer(n_out=4, n_heads=2)`` (head
  dim 2) forward and backward on the card against the CPU, launching
  exactly K1 once and K3 once.

Every phase drives the entry points as a user calls them: on the card
their programs capture a CUDA graph per signature at its first call (or
at ``warmup``) and replay it after (``perf/sentry.py``); the steps that
run a collective over a process group, and every program under a
sequence-parallel context, stay eager. Runs whose measurement hooks
sit inside a program's body (serve_opts' recorded margins and logits,
its patched divisor; serve_opts_agree's recorded suffix start) run the
functions (``perf.sentry.eager()``), since a replay runs no Python.
Then the compile lifecycle (``perf/``) itself, warmed paths against the
same paths run eagerly:

- capture — three paths at full width, each warmed and then driven
  through the entry points a user calls, their programs replaying CUDA
  graphs: the serve phase's gateway warmed over prompts of 1..28
  tokens, then a burst of ``CAPTURE_REQS`` such requests, greedy and
  then sampled (seed ``CAPTURE_SAMPLE_SEED``): no trace after the
  warmups, the decode step and the prefill served by warmed graphs
  (aot_hits > 0, compiles 0), the launches exactly K1 12 an admission
  and K2 25 an admission and a step; BERT-base's classifier (B = 64,
  T = 128, dropout 0.1) warmed at the batch's shapes, then
  ``CAPTURE_FT_STEPS`` ``fit`` steps (the registry's launches exactly)
  and one ``output`` whose rows sum to 1; the char-RNN of phase charrnn,
  ``CAPTURE_RNN_BATCHES`` tBPTT batches; each path's peak memory, and
  every entry point's build (capture) time and the compile report;
  then admissions at the temperatures ``CAPTURE_TEMPS`` through the
  warmed sampled gateway: no trace, one prefill graph a bucket;
- capture_agree — the same three paths eagerly (``perf.sentry.eager()``)
  from the same seeds: the
  bursts' tokens equal token for token, the fine-tune and char-RNN
  parameters equal to the bit (or, printed, within
  ``CAPTURE_PARAM_TOL`` of each leaf's largest value), the launches
  equal; each path's eager peak memory; then each path's step (a decode
  step, a fine-tune step, a char-RNN batch) timed captured and eager in
  ``CAPTURE_TURNS`` turns in this process, and one of each (for serve,
  a whole burst) profiled for the device's busy time and idle share.

Each main path (serve, serve_opts, beam, train, finetune, longctx, dp,
dp_packed, sp, zero, dp_graph, eval, lenet, checkpoint, transfer,
transfer_agree, mlm, resnet, charrnn, charrnn_agree, dp_resnet,
attn_dims) zeroes
the launch counters of the kernels just before it runs and reads them
just after; it fails if a kernel the registry lists for that path was
not launched, and on a stepped path (all but serve; eval counts its
batches) if any ported kernel was launched other than its registry
count per step (0 for a kernel the path does not list); serve_opts
counts from its admissions and steps.

``profile`` (not in the default run) prints the device busy time, idle
share and top kernels of one 2048-bucket prefill, of 8 decode steps with
32 active slots, of one training step, of one fine-tune step, of one
long-context step, of one sp step, of one dp_packed step, of its
exchange alone, of one zero step, of one dp_graph step, and of one eval
pass and its bare output loop, from ``torch.profiler``. Each window's
wall time is taken before the first profiled window, and the decode
window's wall once more after the last one, to show whether profiling
changed it.

Any failed phase exits non-zero before the result lines. The last two
lines are the ``kernels`` JSON object (when the kernels phase and a path
ran) and the device JSON object.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

PHASES = ("device", "serve", "agree", "serve_opts", "serve_opts_agree",
          "beam", "train", "train_agree", "finetune",
          "finetune_agree", "longctx", "longctx_agree", "dp", "dp_packed",
          "dp_agree", "sp", "sp_agree", "sp_graph", "sp_graph_agree",
          "zero", "zero_agree", "dp_graph",
          "eval", "eval_agree", "train_opts", "train_opts_agree",
          "finetune_opts", "serve_fault", "lenet", "lenet_agree",
          "checkpoint", "transfer", "transfer_agree", "mlm", "mlm_agree",
          "resnet", "resnet_agree", "dp_resnet", "dp_resnet_agree",
          "inference", "charrnn", "charrnn_agree", "attn_dims", "capture",
          "capture_agree", "kernels")

# published peaks of one H100 SXM (dense): the bound of a kernel is the
# larger of its operations over the peak rate for their type and its
# bytes over the memory rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# tolerances, kernel vs plain version on the same card inputs:
# flash f32 — the same f32 math in another summation order, __expf;
# flash bf16 — both accumulate in f32 from the same bf16 inputs and
# round the output once: at most one bf16 ulp of |o| < 4;
# rms f32 — f32 math both sides; rms bf16 — the plain version rounds in
# bf16 at every op, the kernel once: 8 bf16 ulps (2^-8 relative each)
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
RMS_TOL_F32 = 1e-4
RMS_TOL_BF16_ULPS = 8
# flash backward (K3), max |err| over max |plain|: f32 — the same f32
# math in another order (and dq's atomics in a run-dependent order);
# bf16 — both sides compute in f32 from the same bf16 inputs and round
# each output once: at most one bf16 ulp (2^-8) of the largest value
K3_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# K1's f32 row logsumexp (values < 16): both sides sum the same f32
# scores in another order (the kernel with __expf), whatever the input
# dtype
LSE_TOL = 1e-4
# RMSNorm backward (K6): both sides f32 math; bf16 rounds once on each
# side, dγ summed in another order — 2 bf16 ulps
K6_TOL_F32 = 1e-4
K6_TOL_BF16_ULPS = 2
# LayerNorm forward (K8): f32 — f32 math both sides; bf16 — the plain
# version rounds in bf16 at every op, the kernel once: 8 bf16 ulps, as
# for K2 (the CPU tests measure ≤ 4 between the two formulas)
LN_TOL_F32 = 1e-4
LN_TOL_BF16_ULPS = 8
# LayerNorm backward (K9): f32 — max |err| over max |plain| per output;
# bf16 — both sides f32 math rounded once, dγ and dβ summed in another
# order: 2 bf16 ulps, as for K6
K9_TOL_F32 = 1e-4
K9_TOL_BF16_ULPS = 2
AGREE_TOL = 2e-3     # f32 logits, card vs CPU, 12 layers deep
# train_agree, f32 with TF32 off: the loss to 1e-5 relative; each
# gradient tensor to 1e-3 of its largest magnitude (f32 sums in another
# order through 12 layers and back)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-3
# the classifier's output rows sum to 1: in f32 within 1e-3; under bf16
# compute the softmax rounds each of the 2 probabilities (each < 1) to
# bf16 once, half an ulp ≤ 2^-9 apiece, so within 2 · 2^-9
PROB_SUM_TOL = {"float32": 1e-3, "bfloat16": 2 * 2.0 ** -9}
# dp_agree: the share of decoded-update elements allowed to differ, card
# vs CPU — the encoding is discontinuous at |g| = τ, so an element whose
# f32 gradient lies within the two devices' rounding of ±τ may take
# another code; every other element is equal
DP_FLIP_TOL = 1e-4

SERVE = dict(vocab_size=50257, hidden=768, n_layers=12, n_heads=6,
             max_len=2048, ffn_mult=8 / 3, tie_embeddings=True)
# serve_opts: the shared-prefix burst (requests, system-prompt tokens,
# suffix lengths, new tokens) and the gateways' slots; the four
# gateways as (tag, model options, gateway options)
OPTS_REQUESTS, OPTS_PREFIX, OPTS_SUFFIX, OPTS_NEW = 32, 1024, (16, 256), 64
OPTS_SLOTS = 32
_INT8 = {"serve_quant": "int8", "cache_quant": "int8"}
_SPEC_SHARE = {"prefix_sharing": True, "spec_k": 4}
OPTS_GATEWAYS = (("a", {}, {}), ("b", {}, _SPEC_SHARE), ("c", _INT8, {}),
                 ("d", _INT8, _SPEC_SHARE))
# beam: prompts and their length (the new tokens: the registry's
# BEAM_NEW), and the calls timed
BEAM_B, BEAM_T0 = 4, 300
BEAM_TIMED = 5
# serve_opts: turns of the decode-step comparison (one warm turn more)
STEP_TURNS = 5
TRAIN = dict(SERVE, max_len=1024)
TRAIN_B, TRAIN_T = 16, 1024
# BERT-base fine-tune: the BASELINE's config #4 (B = 64, T = 128, bf16)
BERT_B, BERT_T, BERT_HEADS, BERT_D = 64, 128, 12, 64
# long context: the model of the JAX package's long-context row
# (tools/perf_dossier.py gpt8k, remat off) at 32 768 tokens, one sequence
# a step: past 24 576 query rows its backward takes the split pair
LONGCTX = dict(SERVE, max_len=32768)
LONGCTX_B, LONGCTX_T = 1, 32768
# sequence parallelism: the long-context LM, zigzag ring over one rank
SP = dict(LONGCTX, sequence_parallel="zigzag_ring")
SP_MODES = ("ring", "zigzag_ring", "ulysses")
# sp_graph: BERT-base's classifier sequence-parallel (ring, one rank) at
# its max_len, on padded rows; pairs of single steps with and without
# the context
SP_GRAPH_B, SP_GRAPH_T = 16, 512
SP_GRAPH_PAIRS = 64
# sp_graph_agree: BERT-base's rows, and the pooled nets' width, heads
# (head dim 64, one of K1's), steps and learned queries
SP_AGREE_B = 2
SP_POOL_F, SP_POOL_HEADS, SP_POOL_T, SP_POOL_Q = 128, 2, 256, 4
# the ring's block pairs in the kernels phase: T_loc rows a rank, the
# causal ring of SP_RING ranks, the zigzag ring of SP_ZIGZAG ranks
SP_T_LOC, SP_RING, SP_ZIGZAG = 2048, 4, 2
# the K6/K9 library bars: kernel and library call timed in this many
# alternating turns each (kernel, library, library, kernel, ...) and
# compared by their medians
NORM_BAR_PAIRS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Device time per call: ``iters`` calls of ``fn`` captured in one
    CUDA graph and replayed between CUDA events, so the host's launch
    path is not in the window (the graph launches the work back to
    back). ``fn`` may not synchronise with the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm up off the capture
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


# -- phase 1 ---------------------------------------------------------------
def phase_device(state):
    import torch
    state["kind"] = torch.cuda.get_device_name(0)
    state["count"] = torch.cuda.device_count()
    log(f"device: {state['kind']} count={state['count']} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    state["smi"] = smi.stdout.strip().splitlines()[0]
    log(state["smi"])
    state["card"] = f"[{state['smi']}]"


# -- the builds; phase 23, kernels -----------------------------------------
def _build_all():
    """Build every ported CUDA library at once, one nvcc each, and print
    ptxas' report for each kernel instantiation: registers, spills and
    stack, and for the tensor-core kernels the dynamic shared memory
    their launcher asks for."""
    from pathlib import Path
    from deeplearning4j_tpu_torch.ops import cuda_build, kernel_registry
    # a CUDA row's library is named after its source file
    libs = {Path(e.source).stem: (Path(e.source).name,)
            for e in kernel_registry.ported() if e.route == "cuda"}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs) or 1) as ex:
        futs = {name: ex.submit(cuda_build.build, name, srcs)
                for name, srcs in libs.items()}
        for name, fut in futs.items():
            path = fut.result()
            log(f"built {name} -> {path.name} "
                f"({time.perf_counter() - t0:.1f}s)")
            for line in _ptxas_report(path.with_suffix(".log").read_text()):
                log(f"  ptxas {name}: {line}")


def _ptxas_report(text: str):
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its demangled
    name, registers, spill stores and loads, stack frame; for the bf16
    tensor-core kernels (``fmma::``, ``csrc/flash_mma.cuh``) also their
    dynamic shared memory: for the query-stationary ones 2 * (64 * D *
    resident + 4 * 64 * D) + 512 bytes (Q, and for the dq pass dO,
    resident; two stages of K and V; the stages' key masks), for the
    key-stationary ``flash_bwd_kv_mma_kernel<D, DQ>`` 2 * 6 * 64 * D +
    1024 bytes (K and V resident, two stages of Q and dO, two of lse and
    Delta) and, with DQ, 8192 more (the dS^T tile)."""
    import re
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = {}
            continue
        if name is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("stack", r"(\d+) bytes stack frame")):
            m = re.search(pat, line)
            if m:
                kernels[name][key] = int(m.group(1))
    try:
        demangled = subprocess.run(
            ["c++filt"], input="\n".join(kernels), capture_output=True,
            text=True, timeout=60).stdout.splitlines()
    except OSError:
        demangled = list(kernels)
    lines = []
    for raw, pretty in zip(kernels, demangled):
        stats = kernels[raw]
        short = pretty.replace("(anonymous namespace)::", "")
        short = short.removeprefix("void ").split("(")[0]
        line = (f"{short}: registers={stats.get('registers')} "
                f"spill_stores={stats.get('spill_stores')} "
                f"spill_loads={stats.get('spill_loads')} "
                f"stack={stats.get('stack')}")
        m = re.search(r"fmma::(\w+)<(\d+)(?:, (\w+))?>", short)
        if m and m.group(1) == "flash_bwd_kv_mma_kernel":
            d, with_dq = int(m.group(2)), m.group(3) == "true"
            line += (f" dynamic_smem="
                     f"{2 * 6 * 64 * d + 1024 + (8192 if with_dq else 0)}")
        elif m:
            d, resident = int(m.group(2)), 2 if "dq" in m.group(1) else 1
            line += (f" dynamic_smem="
                     f"{2 * (64 * d * resident + 4 * 64 * d) + 512}")
        lines.append(line)
    return lines


def _flash_case(dt, tb, h, h_kv, causal, masked, seed, unaligned=False,
                b=1):
    """q, k, v [b, tb, heads, 128] and a key mask (``masked``) on the
    card; ``unaligned``: each a view one element into a [.., 129] tensor,
    so that its base and strides are not whole 16-byte chunks and the
    tensor-core kernels fill their tiles by element copies."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    extra = 1 if unaligned else 0
    mk = lambda hh: torch.randn((b, tb, hh, 128 + extra), generator=g,
                                device="cuda").to(dt)[..., extra:]
    q, k, v = mk(h), mk(h_kv), mk(h_kv)
    mask = None
    if masked:
        mask = (torch.rand((b, tb), generator=g, device="cuda") > 0.3)
        mask[:, 0] = True
        mask = mask.float()
    return q, k, v, mask


def _flash_flops(tb, h, causal, mask, b=1):
    """Two products (q·k and p·v) of 2·D flops per live (query, key)
    pair and head — the pairs these inputs make live."""
    if causal:
        pairs = b * tb * (tb + 1) / 2
    else:
        pairs = tb * (b * tb if mask is None else float(mask.sum()))
    return 4 * pairs * 128 * h


def _rate(flops: float, ms: float, b_ms: float) -> str:
    """A kernel's achieved TFLOP/s and the share of its bound it
    reaches (bound time over its time)."""
    return f"tflops={flops / ms / 1e9:.1f} bound_share={b_ms / ms:.3f}"


def phase_kernels(state):
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import kernel_registry
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ents = {e.key: e for e in kernel_registry.ported()}
    card = state["card"]
    rows = {}

    # K1 flash attention forward: bf16 is the tensor-core kernel, f32 the
    # CUDA-core one; both timed by CUDA-graph replay, as SDPA is
    e = ents["K1"]
    flash, plain = e.port_fn(), e.plain_fn()
    # (tb, h, h_kv, causal, masked, unaligned, batch): the serve paths'
    # prefills are [1, 2048] (serve, serve_opts) and [BEAM_B, 512] (beam)
    cases = [(tb, 6, 6, True, False, False, 1)
             for tb in (16, 200, 1024, 2048)]
    cases += [(512, 6, 6, True, False, False, BEAM_B),
              (200, 6, 2, True, False, False, 1),
              (2048, 6, 2, True, False, False, 1),
              (200, 6, 6, False, True, False, 1),
              (1024, 6, 6, False, True, False, 1),
              (333, 6, 3, True, False, True, 1),
              (200, 6, 6, False, True, True, 1)]
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for i, (tb, h, h_kv, causal, masked, unal, nb) in enumerate(cases):
            q, k, v, mask = _flash_case(dt, tb, h, h_kv, causal, masked, i,
                                        unal, b=nb)
            out = flash(q, k, v, causal=causal, mask=mask)
            ref = plain(q, k, v, causal=causal, mask=mask)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= FLASH_TOL[dname] and torch.isfinite(out).all()
            line = (f"K1 flash {dname} B={nb} Tb={tb} H={h} Hkv={h_kv} "
                    f"causal={causal} mask={masked} unaligned={unal}: "
                    f"max_abs_err={err:.3e} tol={FLASH_TOL[dname]:.0e}")
            t_k = device_ms(lambda: flash(q, k, v, causal=causal, mask=mask))
            t_p = device_ms(lambda: plain(q, k, v, causal=causal,
                                          mask=mask), iters=5)
            # the yardstick on [B, H, T, D] views (SDPA's kernels refuse
            # the unaligned views: those cases give it dense copies)
            qt, kt, vt = ((x.contiguous() if unal else x).transpose(1, 2)
                          for x in (q, k, v))
            lib_kw = {"enable_gqa": True} if h != h_kv else {}
            if mask is not None:
                lib_kw["attn_mask"] = mask.bool()[:, None, None, :]
            t_l = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, **lib_kw))
            nbytes = (2 * q.numel() + k.numel() + v.numel()
                      ) * q.element_size()
            if mask is not None:
                nbytes += mask.numel() * mask.element_size()
            flops = _flash_flops(tb, h, causal, mask, b=nb)
            b_ms, b_by = bound_ms(
                flops, nbytes,
                PEAK_BF16_FLOPS if dname == "bfloat16" else PEAK_F32_FLOPS)
            line += (f" kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
                     f"sdpa_ms={t_l:.4f} kernel/sdpa={t_k / t_l:.2f} "
                     f"bound_ms={b_ms:.5f}({b_by}) "
                     f"{_rate(flops, t_k, b_ms)} {card}")
            if (dname, nb, tb, h_kv, masked) == ("bfloat16", 1, 2048, 6,
                                                 False):
                rows["K1"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                  bound_ms=b_ms, bound_by=b_by)
            log(line)
            if not ok:
                raise AssertionError(f"K1 disagrees with its plain "
                                     f"version: {line}")
            rows.setdefault("K1_err", 0.0)
            rows["K1_err"] = max(rows["K1_err"], err)

    # K2 RMSNorm forward, at the serve paths' row counts: beam's decode
    # (BEAM_B x 4 beams), the decode step (32 slots), the suffix prefill
    # buckets (16-256 rows), the k = 4 verify step (32 x 4), the
    # prefills (2048), and the train step's
    e = ents["K2"]
    rms, rms_plain = e.port_fn(), e.plain_fn()
    f = 768
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for n in (16, 32, 64, 128, 256, 2048, TRAIN_B * TRAIN_T):
            g = torch.Generator(device="cuda").manual_seed(n)
            x = torch.randn((n, f), generator=g, device="cuda").to(dt)
            gamma = (1 + 0.1 * torch.randn((f,), generator=g,
                                           device="cuda")).to(dt)
            out = rms(x, gamma)
            ref = rms_plain(x, gamma)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            if dname == "bfloat16":
                ulps = (diff / (ref.float().abs() * 2.0 ** -8 + 1e-3)
                        ).max().item()
                ok = ulps <= RMS_TOL_BF16_ULPS
                tol = f"max_ulps={ulps:.2f} tol={RMS_TOL_BF16_ULPS}ulps"
            else:
                ok = err <= RMS_TOL_F32
                tol = f"tol={RMS_TOL_F32:.0e}"
            ok = ok and bool(torch.isfinite(out).all())
            t_h = time_ms(lambda: rms(x, gamma))
            t_k = device_ms(lambda: rms(x, gamma))
            t_p = device_ms(lambda: rms_plain(x, gamma))
            t_l = device_ms(lambda: F.rms_norm(x, (f,), gamma, eps=1e-6))
            nbytes = (2 * x.numel() + f) * x.element_size()
            b_ms, b_by = bound_ms(4 * x.numel(), nbytes,
                                  PEAK_F32_FLOPS)
            line = (f"K2 rms {dname} rows={n} F={f}: max_abs_err={err:.3e}"
                    f" {tol} kernel_ms={t_k:.4f} host_ms={t_h:.4f} "
                    f"plain_ms={t_p:.4f} F.rms_norm_ms={t_l:.4f} "
                    f"bound_ms={b_ms:.5f}({b_by}) {card}")
            log(line)
            if not ok:
                raise AssertionError(f"K2 disagrees with its plain "
                                     f"version: {line}")
            if (dname, n) == ("bfloat16", 2048):
                rows["K2"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                  bound_ms=b_ms, bound_by=b_by)
            rows.setdefault("K2_err", 0.0)
            rows["K2_err"] = max(rows["K2_err"], err)
    _check_flash_bwd(ents["K3"], rows, card)
    _check_flash_finetune(ents["K1"], ents["K3"], rows, card)
    _check_flash_split(ents, rows, card)
    _check_norm_bwd_cases(ents["K6"], rows, card)
    _check_add_norm(ents["K7"], rows, card)
    _check_layer_norm(ents["K8"], ents["K9"], rows, card)
    _check_codec(ents["K10"], ents["K11"], rows, card)
    _check_flash_blocks(rows, card)
    state["kernel_rows"] = rows


def _rel_err(out, ref) -> float:
    return ((out.double() - ref.double()).abs().max()
            / ref.double().abs().max().clamp_min(1e-30)).item()


def _lengths_mask(b, t, g):
    """A padded batch's key mask [b, t] on the card: row i live on its
    first lengths[i] keys, lengths uniform in 32..t (the fine-tune
    batch's)."""
    import torch
    lens = torch.randint(32, t + 1, (b, 1), generator=g, device="cuda")
    return (torch.arange(t, device="cuda")[None, :] < lens).float()


def _flash_bwd_case(dt, b, t, h, h_kv, causal, masked, seed, d=128,
                    tk=None, unaligned=False):
    """Inputs of one backward case: q, k, v, the output gradient and the
    key mask (``masked``: False, True for a random 70 % of the keys, or
    "lengths" for padded rows), with the forward's out and lse from
    K1; ``tk`` keys (default ``t``); ``unaligned`` as for
    :func:`_flash_case`."""
    import torch
    from deeplearning4j_tpu_torch.ops.cuda_kernels import flash_attention
    tk = tk or t
    g = torch.Generator(device="cuda").manual_seed(seed)
    extra = 1 if unaligned else 0
    mk = lambda n, hh: torch.randn((b, n, hh, d + extra), generator=g,
                                   device="cuda").to(dt)[..., extra:]
    q, k, v, do = mk(t, h), mk(tk, h_kv), mk(tk, h_kv), mk(t, h)
    mask = None
    if masked == "lengths":
        mask = _lengths_mask(b, tk, g)
    elif masked:
        mask = (torch.rand((b, tk), generator=g, device="cuda") > 0.3)
        mask[:, 0] = True
        mask = mask.float()
    out, lse = flash_attention(q, k, v, causal=causal, mask=mask,
                               return_lse=True)
    return q, k, v, out, lse, do, mask


def _check_flash_bwd(e, rows, card):
    """K3 against its plain version at [1, T, 6, 128]; then, at the
    training shape [16, 1024, 6, 128] bf16 causal, K1 with its lse and
    K3 against their plain versions, and K3 timed."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops.cuda_kernels import (
        flash_attention_reference)
    bwd, plain = e.port_fn(), e.plain_fn()
    cases = [(t, 6, True, False) for t in (200, 1024, 2048)]
    cases += [(2048, 2, True, False), (1024, 6, False, True)]
    err_max = 0.0
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for i, (t, h_kv, causal, masked) in enumerate(cases):
            q, k, v, out, lse, do, mask = _flash_bwd_case(
                dt, 1, t, 6, h_kv, causal, masked, 100 + i)
            got = bwd(q, k, v, out, lse, do, causal=causal, mask=mask)
            ref = plain(q, k, v, out, lse, do, causal=causal, mask=mask)
            torch.cuda.synchronize()
            errs = [(a.float() - r.float()).abs().max().item()
                    for a, r in zip(got, ref)]
            rels = [_rel_err(a, r) for a, r in zip(got, ref)]
            ok = (max(rels) <= K3_TOL[dname]
                  and all(bool(torch.isfinite(a).all()) for a in got))
            line = (f"K3 flash_bwd {dname} T={t} H=6 Hkv={h_kv} "
                    f"causal={causal} mask={masked}: max_abs_err(dq,dk,dv)"
                    f"={','.join(f'{x:.3e}' for x in errs)} rel="
                    f"{max(rels):.3e} tol={K3_TOL[dname]:.0e} {card}")
            log(line)
            if not ok:
                raise AssertionError(f"K3 disagrees with its plain "
                                     f"version: {line}")
            err_max = max(err_max, *errs)
    # the training path's shape: K1's out and lse, then K3 on them, held
    # against their plain versions, then timed
    b, t, h = TRAIN_B, TRAIN_T, 6
    q, k, v, out, lse, do, _ = _flash_bwd_case(torch.bfloat16, b, t, h, h,
                                               True, False, 7)
    ref_out, ref_lse = flash_attention_reference(q, k, v, causal=True,
                                                 return_lse=True)
    got = bwd(q, k, v, out, lse, do, causal=True)
    ref = plain(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    o_err = (out.float() - ref_out.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    errs = [(a.float() - r.float()).abs().max().item()
            for a, r in zip(got, ref)]
    rel = max(_rel_err(a, r) for a, r in zip(got, ref))
    line = (f"K1+K3 bfloat16 [{b},{t},{h},128] causal: K1 out "
            f"max_abs_err={o_err:.3e} tol={FLASH_TOL['bfloat16']:.0e} lse "
            f"max_abs_err={lse_err:.3e} tol={LSE_TOL:.0e}; K3 max_abs_err"
            f"(dq,dk,dv)={','.join(f'{x:.3e}' for x in errs)} rel="
            f"{rel:.3e} tol={K3_TOL['bfloat16']:.0e} {card}")
    log(line)
    finite = all(bool(torch.isfinite(x).all()) for x in (out, lse, *got))
    if not (o_err <= FLASH_TOL["bfloat16"] and lse_err <= LSE_TOL
            and rel <= K3_TOL["bfloat16"] and finite):
        raise AssertionError(f"K1 or K3 disagrees with its plain version "
                             f"at the training shape: {line}")
    del ref_out, ref_lse, ref
    rows["K1_err"] = max(rows["K1_err"], o_err)
    rows["K3_err"] = max(err_max, *errs)
    _time_k1_causal(q, k, v, "train", card)
    t_k = device_ms(lambda: bwd(q, k, v, out, lse, do, causal=True),
                    iters=10)
    t_p = time_ms(lambda: plain(q, k, v, out, lse, do, causal=True),
                  iters=3, warm=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    t_l = device_ms(sdpa_fwd_bwd) - device_ms(sdpa_fwd)
    pairs = b * t * (t + 1) / 2
    flops = 5 * 2 * 128 * pairs * h
    nbytes = 8 * q.numel() * q.element_size() + lse.numel() * 4
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"K3 flash_bwd bfloat16 [{b},{t},{h},128] causal: "
        f"kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
        f"sdpa_bwd_ms={t_l:.4f} kernel/sdpa_bwd={t_k / t_l:.2f} "
        f"bound_ms={b_ms:.5f}({b_by}) {_rate(flops, t_k, b_ms)} {card}")
    rows["K3"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                      bound_ms=b_ms, bound_by=b_by)


def _time_k1_causal(q, k, v, path: str, card, iters: int = 20) -> None:
    """K1 at a causal training shape against SDPA, both by CUDA-graph
    replay, with K1's achieved TFLOP/s and share of its bound."""
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops.cuda_kernels import flash_attention
    b, t, h, d = q.shape
    t_k = device_ms(lambda: flash_attention(q, k, v, causal=True),
                    iters=iters)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    t_l = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), iters=iters)
    flops = 4 * d * b * h * t * (t + 1) / 2
    b_ms, b_by = bound_ms(flops, 4 * q.numel() * q.element_size(),
                          PEAK_BF16_FLOPS)
    log(f"K1 flash bfloat16 [{b},{t},{h},{d}] causal ({path}): kernel_ms="
        f"{t_k:.4f} sdpa_ms={t_l:.4f} kernel/sdpa={t_k / t_l:.2f} "
        f"bound_ms={b_ms:.5f}({b_by}) {_rate(flops, t_k, b_ms)} {card}")


def _check_flash_finetune(e1, e3, rows, card):
    """K1 (out and lse) and K3 at the fine-tune shape [64, 128, 12, 64],
    not causal, keys masked by padded lengths (the finetune path) and
    unmasked (``mask=None``: the dp_graph path's full-length rows), in
    bfloat16 and float32, against their plain versions; then both timed
    against SDPA in bfloat16."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops.cuda_kernels import (
        flash_attention_reference)
    flash, bwd, plain = e1.port_fn(), e3.port_fn(), e3.plain_fn()
    b, t, h, d = BERT_B, BERT_T, BERT_HEADS, BERT_D
    for masked, what in (("lengths", "key-masked"), (False, "unmasked")):
        for dname in ("bfloat16", "float32"):
            dt = getattr(torch, dname)
            q, k, v, out, lse, do, mask = _flash_bwd_case(
                dt, b, t, h, h, False, masked, 300, d=d)
            ref_out, ref_lse = flash_attention_reference(
                q, k, v, mask=mask, return_lse=True)
            got = bwd(q, k, v, out, lse, do, mask=mask)
            ref = plain(q, k, v, out, lse, do, mask=mask)
            torch.cuda.synchronize()
            o_err = (out.float() - ref_out.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            errs = [(a.float() - r.float()).abs().max().item()
                    for a, r in zip(got, ref)]
            rel = max(_rel_err(a, r) for a, r in zip(got, ref))
            finite = all(bool(torch.isfinite(x).all())
                         for x in (out, lse, *got))
            line = (f"K1+K3 {dname} [{b},{t},{h},{d}] {what}: K1 out "
                    f"max_abs_err={o_err:.3e} tol={FLASH_TOL[dname]:.0e} "
                    f"lse max_abs_err={lse_err:.3e} tol={LSE_TOL:.0e}; K3 "
                    f"max_abs_err(dq,dk,dv)="
                    f"{','.join(f'{x:.3e}' for x in errs)} rel={rel:.3e} "
                    f"tol={K3_TOL[dname]:.0e}")
            if dname == "bfloat16":
                # live (query, key) pairs
                live = (float(mask.sum()) if mask is not None
                        else float(b * t)) * t
                qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                              for x in (q, k, v))
                am = None if mask is None else mask.bool()[:, None, None, :]
                dot = do.transpose(1, 2)

                def sdpa_fwd():
                    with torch.no_grad():
                        F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=am)

                def sdpa_fwd_bwd():
                    o = F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=am)
                    torch.autograd.grad(o, (qt, kt, vt), dot)

                t_k1 = device_ms(lambda: flash(q, k, v, mask=mask))
                t_k3 = device_ms(lambda: bwd(q, k, v, out, lse, do,
                                             mask=mask), iters=10)
                t_l1 = device_ms(sdpa_fwd)
                t_l3 = device_ms(sdpa_fwd_bwd) - t_l1
                el = q.element_size()
                mask_bytes = 0 if mask is None else mask.numel() * 4
                b1, by1 = bound_ms(4 * d * h * live,
                                   4 * q.numel() * el + mask_bytes,
                                   PEAK_BF16_FLOPS)
                b3, by3 = bound_ms(10 * d * h * live,
                                   8 * q.numel() * el + lse.numel() * 4,
                                   PEAK_BF16_FLOPS)
                line += (f"; K1 kernel_ms={t_k1:.4f} sdpa_ms={t_l1:.4f} "
                         f"kernel/sdpa={t_k1 / t_l1:.2f} bound_ms={b1:.5f}"
                         f"({by1}) {_rate(4 * d * h * live, t_k1, b1)}; K3 "
                         f"kernel_ms={t_k3:.4f} "
                         f"sdpa_bwd_ms={t_l3:.4f} kernel/sdpa_bwd="
                         f"{t_k3 / t_l3:.2f} bound_ms={b3:.5f}({by3}) "
                         f"{_rate(10 * d * h * live, t_k3, b3)}")
            log(f"{line} {card}")
            if not (o_err <= FLASH_TOL[dname] and lse_err <= LSE_TOL
                    and rel <= K3_TOL[dname] and finite):
                raise AssertionError(
                    f"K1 or K3 disagrees with its plain version at the "
                    f"fine-tune shape: {line}")
            rows["K1_err"] = max(rows["K1_err"], o_err)
            rows["K3_err"] = max(rows["K3_err"], *errs)


# the split pair's cases: (b, tq, tk, h, h_kv, causal, masked, d,
# offsets, unaligned); the first two are the train and long-context
# paths' shapes
SPLIT_CASES = [
    (TRAIN_B, TRAIN_T, TRAIN_T, 6, 6, True, False, 128, None, False),
    (LONGCTX_B, LONGCTX_T, LONGCTX_T, 6, 6, True, False, 128, None, False),
    (BERT_B, BERT_T, BERT_T, BERT_HEADS, BERT_HEADS, False, "lengths",
     BERT_D, None, False),
    (1, 2048, 2048, 6, 2, True, False, 128, None, False),          # GQA
    (2, 300, 1000, 6, 2, True, True, 64, None, False),  # Tq < Tk, key mask
    # ring-style offsets: row i sees key j when 200 + j <= 100 + i, so
    # the first 100 rows see no key
    (1, 1000, 1000, 6, 2, True, False, 128, (100, 200), False),
    # element copies instead of 16-byte ones; head dims 32 and 16
    (1, 333, 333, 6, 3, True, False, 128, None, True),
    (2, 130, 130, 4, 2, True, True, 32, None, False),
    (1, 130, 130, 4, 4, False, False, 16, None, False),
]


def _check_flash_split(ents, rows, card):
    """K4 and K5 against their plain versions at ``SPLIT_CASES``, in
    bfloat16 and float32, with K3's tolerances. At the long-context shape
    [1, 32768, 6, 128] bf16 causal: K1's out and lse against its plain
    version, the split pair against K3 on the same inputs, K4's dq the
    same to the bit over two runs, and K5's dk and dv too. Then K4, K5,
    K4 + K5 and K3 timed at both causal shapes, with the plain versions
    and SDPA's backward."""
    import torch
    from deeplearning4j_tpu_torch.ops.cuda_kernels import (
        flash_attention_reference)
    e4, e5 = ents["K4"], ents["K5"]
    dq_k, dkv_k, dq_p, dkv_p = (e4.port_fn(), e5.port_fn(), e4.plain_fn(),
                                e5.plain_fn())
    bwd = ents["K3"].port_fn()               # the dispatching backward
    errs = {"K4": 0.0, "K5": 0.0}
    timed = {}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for i, (b, tq, tk, h, h_kv, causal, masked, d, offs, unal) in \
                enumerate(SPLIT_CASES):
            q, k, v, out, lse, do, mask = _flash_bwd_case(
                dt, b, tq, h, h_kv, causal, masked, 500 + i, d=d, tk=tk,
                unaligned=unal)
            kw = dict(causal=causal, mask=mask, offsets=offs)
            dq = dq_k(q, k, v, out, lse, do, **kw)
            dk, dv = dkv_k(q, k, v, out, lse, do, **kw)
            got = (dq, dk, dv)
            ref = (dq_p(q, k, v, out, lse, do, **kw),
                   *dkv_p(q, k, v, out, lse, do, **kw))
            torch.cuda.synchronize()
            abs_errs = [(a.float() - r.float()).abs().max().item()
                        for a, r in zip(got, ref)]
            rel = max(_rel_err(a, r) for a, r in zip(got, ref))
            ok = (rel <= K3_TOL[dname]
                  and all(bool(torch.isfinite(a).all()) for a in got))
            line = (f"K4+K5 flash_bwd_split {dname} [{b},{tq},{h},{d}] "
                    f"Tk={tk} Hkv={h_kv} causal={causal} mask={masked} "
                    f"offsets={offs} unaligned={unal}: max_abs_err(dq,dk,dv)="
                    f"{','.join(f'{x:.3e}' for x in abs_errs)} rel="
                    f"{rel:.3e} tol={K3_TOL[dname]:.0e}")
            errs["K4"] = max(errs["K4"], abs_errs[0])
            errs["K5"] = max(errs["K5"], *abs_errs[1:])
            del ref
            if (dname, i) == ("bfloat16", 1):
                line += "; " + _check_longctx_pair(
                    bwd, dq_k, dkv_k, flash_attention_reference, q, k, v,
                    out, lse, do, got, card)
            log(f"{line} {card}")
            if not ok:
                raise AssertionError(f"K4 or K5 disagrees with its plain "
                                     f"version: {line}")
            if dname == "bfloat16" and i < 2:
                timed[(b, tq)] = _time_split(
                    bwd, dq_k, dkv_k, dq_p, dkv_p, q, k, v, out, lse, do,
                    card)
            del q, k, v, out, lse, do, got, dq, dk, dv
    rows["K4_err"], rows["K5_err"] = errs["K4"], errs["K5"]
    # the JSON rows: the long-context path's shape
    t4, t5, t_l, (b4, by4), (b5, by5) = timed[(LONGCTX_B, LONGCTX_T)]
    rows["K4"] = dict(ms=t4["k"], plain_ms=t4["p"], library_ms=t_l,
                      bound_ms=b4, bound_by=by4)
    rows["K5"] = dict(ms=t5["k"], plain_ms=t5["p"], library_ms=t_l,
                      bound_ms=b5, bound_by=by5)


def _check_longctx_pair(bwd, dq_k, dkv_k, fwd_plain, q, k, v, out, lse,
                        do, got, card) -> str:
    """At the long-context shape: K1 timed beside SDPA, and its out and
    lse (from ``_flash_bwd_case``) against the plain forward; the split
    pair's ``got`` against K3 on the same inputs, and K4's dq and K5's
    dk, dv over a second run (each must be the same to the bit). Raises
    on a disagreement; returns the log line's part."""
    import torch
    _time_k1_causal(q, k, v, "longctx", card, iters=5)
    ref_out, ref_lse = fwd_plain(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    o_err = (out.float() - ref_out.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    del ref_out, ref_lse
    with _fused_budget(1 << 62):
        fused = bwd(q, k, v, out, lse, do, causal=True)
    dq2 = dq_k(q, k, v, out, lse, do, causal=True)
    dk2, dv2 = dkv_k(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    rel3 = max(_rel_err(a, r) for a, r in zip(got, fused))
    same4 = bool(torch.equal(dq2, got[0]))
    same5 = bool(torch.equal(dk2, got[1]) and torch.equal(dv2, got[2]))
    part = (f"K1 out max_abs_err={o_err:.3e} tol="
            f"{FLASH_TOL['bfloat16']:.0e} lse max_abs_err={lse_err:.3e} "
            f"tol={LSE_TOL:.0e}; split vs K3 rel={rel3:.3e} "
            f"tol={K3_TOL['bfloat16']:.0e}; K4 dq bit-identical over two "
            f"runs={same4}; K5 dk, dv bit-identical over two runs={same5}")
    if not (o_err <= FLASH_TOL["bfloat16"] and lse_err <= LSE_TOL
            and rel3 <= K3_TOL["bfloat16"] and same4 and same5):
        raise AssertionError(f"long-context check failed: {part}")
    return part


def _time_split(bwd, dq_k, dkv_k, dq_p, dkv_p, q, k, v, out, lse, do,
                card):
    """K4 and K5 alone (Delta computed once beforehand), the pair as the
    path calls it (Delta + K4 + K5), K3, the two plain versions and
    SDPA's backward (forward + backward − forward) on the same causal
    bf16 inputs; the kernels and SDPA by CUDA-graph replay, the plain
    versions by CUDA events around their calls. Bounds: the live (query,
    key) pairs times 2·D flops a product — K4 3 (s, dp, dq), K5 4 (s,
    dp, dv, dk), the backward 5 — or each input read and each output
    written once."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops.cuda_kernels import _delta_reference
    b, t, h, d = q.shape
    long = t > 4096
    iters, p_iters = (3, 1) if long else (10, 3)
    delta = _delta_reference(out, do)
    kw = dict(causal=True, delta=delta)
    t4 = dict(k=device_ms(lambda: dq_k(q, k, v, out, lse, do, **kw),
                          iters=iters, warm=1),
              p=time_ms(lambda: dq_p(q, k, v, out, lse, do, **kw),
                        iters=p_iters, warm=1))
    t5 = dict(k=device_ms(lambda: dkv_k(q, k, v, out, lse, do, **kw),
                          iters=iters, warm=1),
              p=time_ms(lambda: dkv_p(q, k, v, out, lse, do, **kw),
                        iters=p_iters, warm=1))
    with _fused_budget(0):
        t_pair = device_ms(lambda: bwd(q, k, v, out, lse, do,
                                       causal=True), iters=iters, warm=1)
    with _fused_budget(1 << 62):
        t_k3 = device_ms(lambda: bwd(q, k, v, out, lse, do, causal=True),
                         iters=iters, warm=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    n = 5 if long else 20
    t_l = device_ms(sdpa_fwd_bwd, iters=n) - device_ms(sdpa_fwd, iters=n)
    pairs = b * h * t * (t + 1) / 2
    el, arr = q.element_size(), q.numel()
    # K4 reads q, k, v, o, dO, lse, writes dq; K5 the same, writes dk, dv
    b4 = bound_ms(3 * 2 * d * pairs, 6 * arr * el + lse.numel() * 4,
                  PEAK_BF16_FLOPS)
    b5 = bound_ms(4 * 2 * d * pairs, 7 * arr * el + lse.numel() * 4,
                  PEAK_BF16_FLOPS)
    b3 = bound_ms(5 * 2 * d * pairs, 8 * arr * el + lse.numel() * 4,
                  PEAK_BF16_FLOPS)
    log(f"K4 flash_bwd_dq bfloat16 [{b},{t},{h},{d}] causal: kernel_ms="
        f"{t4['k']:.4f} plain_ms={t4['p']:.4f} sdpa_bwd_ms={t_l:.4f} "
        f"kernel/sdpa_bwd={t4['k'] / t_l:.2f} bound_ms={b4[0]:.5f}"
        f"({b4[1]}) {_rate(3 * 2 * d * pairs, t4['k'], b4[0])} {card}")
    log(f"K5 flash_bwd_dkv bfloat16 [{b},{t},{h},{d}] causal: kernel_ms="
        f"{t5['k']:.4f} plain_ms={t5['p']:.4f} sdpa_bwd_ms={t_l:.4f} "
        f"kernel/sdpa_bwd={t5['k'] / t_l:.2f} bound_ms={b5[0]:.5f}"
        f"({b5[1]}) {_rate(4 * 2 * d * pairs, t5['k'], b5[0])} {card}")
    log(f"K3 vs K4+K5 bfloat16 [{b},{t},{h},{d}] causal: K3_ms="
        f"{t_k3:.4f} delta+K4+K5_ms={t_pair:.4f} K4+K5_ms="
        f"{t4['k'] + t5['k']:.4f} split/K3={t_pair / t_k3:.3f} "
        f"sdpa_bwd_ms={t_l:.4f} K3/sdpa_bwd={t_k3 / t_l:.2f} backward "
        f"bound_ms={b3[0]:.5f}({b3[1]}) K3 "
        f"{_rate(5 * 2 * d * pairs, t_k3, b3[0])} {card}")
    return t4, t5, t_l, b4, b5


def _check_layer_norm(e8, e9, rows, card):
    """K8 against its plain version at the fine-tune shape [8192, 768]
    and a ragged [1000, 200], bf16 and f32 (yardstick ``F.layer_norm``);
    then K9 by :func:`_check_norm_bwd_cases`."""
    import torch
    import torch.nn.functional as F
    fwd, fwd_plain = e8.port_fn(), e8.plain_fn()
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for n, f in ((BERT_B * BERT_T, 768), (1000, 200)):
            x, _, gamma, beta = _ln_inputs(dt, n, f)
            y, ry = fwd(x, gamma, beta), fwd_plain(x, gamma, beta)
            torch.cuda.synchronize()
            err = (y.float() - ry.float()).abs().max().item()
            if dname == "bfloat16":
                u8 = _ulps(y, ry)
                ok = u8 <= LN_TOL_BF16_ULPS
                tol = f"max_ulps={u8:.2f} tol={LN_TOL_BF16_ULPS}ulps"
            else:
                ok = err <= LN_TOL_F32
                tol = f"tol={LN_TOL_F32:.0e}"
            ok = ok and bool(torch.isfinite(y).all())
            t = dict(h=time_ms(lambda: fwd(x, gamma, beta)),
                     k=device_ms(lambda: fwd(x, gamma, beta)),
                     p=device_ms(lambda: fwd_plain(x, gamma, beta)),
                     l=device_ms(lambda: F.layer_norm(x, (f,), gamma,
                                                      beta, eps=1e-5)))
            # K8 reads x, γ, β and writes y
            b_ms, b_by = bound_ms(8 * x.numel(),
                                  (2 * x.numel() + 3 * f)
                                  * x.element_size(), PEAK_F32_FLOPS)
            line = (f"K8 layer_norm {dname} rows={n} F={f}: "
                    f"max_abs_err={err:.3e} {tol} kernel_ms={t['k']:.4f} "
                    f"host_ms={t['h']:.4f} plain_ms={t['p']:.4f} "
                    f"F.layer_norm_ms={t['l']:.4f} bound_ms={b_ms:.5f}"
                    f"({b_by}) {card}")
            log(line)
            if not ok:
                raise AssertionError(f"K8 disagrees with its plain "
                                     f"version: {line}")
            if (dname, n) == ("bfloat16", BERT_B * BERT_T):
                rows["K8"] = dict(ms=t["k"], plain_ms=t["p"],
                                  library_ms=t["l"], bound_ms=b_ms,
                                  bound_by=b_by)
            rows["K8_err"] = max(rows.get("K8_err", 0.0), err)
    _check_norm_bwd_cases(e9, rows, card)


def _ln_inputs(dt, n, f):
    """x, dy, γ, β of the LayerNorm cases on the card (x off-centre, so
    the mean matters), seeded by the shape."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(n + f)
    rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    x = (2 * rnd(n, f) + 0.5).to(dt)
    dy = rnd(n, f).to(dt)
    gamma = (1 + 0.1 * rnd(f)).to(dt)
    beta = (0.1 * rnd(f)).to(dt)
    return x, dy, gamma, beta


def _same_bits(a, b) -> bool:
    """Equal to the bit (NaN where NaN): the same 32-bit words."""
    import torch
    return bool(torch.equal(a.reshape(-1).view(torch.int32),
                            b.reshape(-1).view(torch.int32)))


def _codec_grad(shape, seed, dtype_name="float32"):
    """N(0, 1e-3) gradients on the card with values exactly ±τ, a NaN and
    ±inf at the front (τ = 1e-3 as f32)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    grad = torch.randn(shape, generator=g, device="cuda") * 1e-3
    tau = torch.tensor(1e-3, device="cuda")
    grad.view(-1)[:5] = torch.stack([tau, -tau, tau * float("nan"),
                                     tau * float("inf"),
                                     -tau * float("inf")])
    return grad.to(getattr(torch, dtype_name)), tau


def _check_codec(e10, e11, rows, card):
    """K10 and K11 against their plain versions, bit for bit: packed
    words, residuals and decoded values, at the embedding leaf
    [50257, 768] (f32, the path's largest) and a ragged 10 001 (f32 and
    bf16); then four emulated ranks — four gradients encoded by K10,
    decoded and summed by K11 — against the plain versions' sum. Times by
    CUDA-graph replay; bounds by bytes (each input read and each output
    written once); no PyTorch call computes either function."""
    import torch
    from deeplearning4j_tpu_torch.ops.cuda_kernels import threshold_words
    enc, enc_p = e10.port_fn(), e10.plain_fn()
    dec, dec_p = e11.port_fn(), e11.plain_fn()
    for i, (shape, dname) in enumerate((((50257, 768), "float32"),
                                        ((10001,), "float32"),
                                        ((10001,), "bfloat16"))):
        grad, tau = _codec_grad(shape, 700 + i, dname)
        n, c = grad.numel(), threshold_words(grad.numel())
        words, resid = enc(grad, tau)
        rw, rr = enc_p(grad, tau)
        out = dec(words, tau, n, shape)
        ro = dec_p(rw, tau, n, shape)
        torch.cuda.synchronize()
        same = dict(words=bool(torch.equal(words, rw)),
                    resid=_same_bits(resid, rr),
                    decoded=_same_bits(out, ro))
        enc_err = (resid - rr).abs().nan_to_num(0.0).max().item()
        dec_err = (out - ro).abs().max().item()
        line = (f"K10+K11 codec {dname} {list(shape)} words={c}: "
                f"bit-identical {same} encoded "
                f"{(out != 0).float().mean().item():.4f} of the elements")
        if (shape, dname) != ((10001,), "bfloat16"):
            t10 = device_ms(lambda: enc(grad, tau))
            p10 = device_ms(lambda: enc_p(grad, tau), iters=5)
            p11 = device_ms(lambda: dec_p(words, tau, n, shape), iters=5)
            # K10: g read, residual written (f32), words written; K11:
            # the words it needs read, n f32 written; a compare, a select
            # and a subtraction an element
            b10 = bound_ms(3 * n, 4 * n + 4 * n + 4 * c, PEAK_F32_FLOPS)
            b11 = bound_ms(2 * n, 4 * -(-n // 16) + 4 * n, PEAK_F32_FLOPS)
            line += (f"; K10 kernel_ms={t10:.4f} plain_ms={p10:.4f} "
                     f"bound_ms={b10[0]:.5f}({b10[1]}); K11 plain_ms="
                     f"{p11:.4f} bound_ms={b11[0]:.5f}({b11[1]}) (its "
                     f"kernel ms: the leaf check below)")
            if i == 0:
                rows["K10"] = dict(ms=t10, plain_ms=p10, library_ms=None,
                                   bound_ms=b10[0], bound_by=b10[1])
                rows["K11"] = dict(ms=None, plain_ms=p11, library_ms=None,
                                   bound_ms=b11[0], bound_by=b11[1])
        log(f"{line} {card}")
        if not all(same.values()):
            raise AssertionError(f"K10 or K11 disagrees with its plain "
                                 f"version: {line}")
        rows["K10_err"] = max(rows.get("K10_err", 0.0), enc_err)
        rows["K11_err"] = max(rows.get("K11_err", 0.0), dec_err)
        del grad, words, resid, rw, rr, out, ro
    # four ranks at the embedding leaf: each rank's words by K10, every
    # rank's words decoded by K11 and summed in rank order
    shape = (50257, 768)
    grads = [_codec_grad(shape, 710 + r)[0] for r in range(4)]
    tau = torch.tensor(1e-3, device="cuda")
    words = [enc(g, tau)[0] for g in grads]
    plain_words = [enc_p(g, tau)[0] for g in grads]
    got = dec(words[0], tau, grads[0].numel(), shape)
    ref = dec_p(plain_words[0], tau, grads[0].numel(), shape)
    for w, pw in zip(words[1:], plain_words[1:]):
        got += dec(w, tau, grads[0].numel(), shape)
        ref += dec_p(pw, tau, grads[0].numel(), shape)
    torch.cuda.synchronize()
    same = (all(torch.equal(a, b) for a, b in zip(words, plain_words))
            and _same_bits(got, ref))
    log(f"K10+K11 four ranks {list(shape)}: words and decoded sum "
        f"bit-identical={same} {card}")
    if not same:
        raise AssertionError("K10/K11 four-rank decode-sum disagrees with "
                             "the plain versions")
    del grads, words, plain_words, got, ref
    rows["K11"]["ms"] = _check_decode_leaves(e10, e11, card)


# K11 at every gradient leaf shape of the dp_packed step, with its
# leaves a step (1 + 48 + 36 + 37 + 1 = 123; [2048, 768] has the
# elements of [768, 2048]); ragged sizes (513 and 65 736 end mid-span,
# 17 and 10 001 mid-word too); the bar at the embedding leaf: half of
# its byte bound
DECODE_LEAVES = (((50257, 768), 1), ((768, 768), 48), ((768, 2048), 36),
                 ((768,), 37), ((50257,), 1))
DECODE_RAGGED = (17, 513, 10001, 65736)
K11_BAR_MS = 0.0980


def _decode_c(lib, words, tau, out_ptr, n):
    """K11's C entry called directly (no launch counted): its return
    code."""
    import torch
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    err = lib.dl4j_threshold_decode(
        words.data_ptr(), tau.data_ptr(), out_ptr, n,
        ck.decode_grid(n), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return err


def _check_decode_leaves(e10, e11, card) -> float:
    """K11 against its plain version, bit for bit, at every leaf shape of
    ``DECODE_LEAVES`` and at the ragged sizes of ``DECODE_RAGGED``, where
    the C entry, called into a larger buffer, must leave every element
    past the leaf untouched; and the C entry must refuse (-1, nothing
    written) an output one element off 16-byte alignment. At each leaf
    shape: the kernel's device ms (CUDA-graph replay of 100 calls), its
    byte bound and bound share, the write ceiling (``fill_(0.0)`` of an f32
    buffer of the leaf's size by CUDA-graph replay: a yardstick of the
    card's write rate in this run, not the same function), the host ms
    of eager calls, the grid; then the sum over one step's 123 leaves.
    Fails on the bar at the embedding leaf. Returns the kernel ms
    there."""
    import torch
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    enc, dec, dec_p = e10.port_fn(), e11.port_fn(), e11.plain_fn()
    lib = ck._lib("threshold_codec")
    step = dict(kernel=0.0, bound=0.0, fill=0.0)
    main_ms = None
    for i, (shape, leaves) in enumerate(DECODE_LEAVES):
        grad, tau = _codec_grad(shape, 720 + i)
        n = grad.numel()
        words, _ = enc(grad, tau)
        same = _same_bits(dec(words, tau, n, shape),
                          dec_p(words, tau, n, shape))
        buf = torch.empty(n, dtype=torch.float32, device="cuda")
        # 100 calls a reading: the small leaves take ~2 µs
        kernel = lambda: device_ms(lambda: dec(words, tau, n, shape),
                                   iters=100)
        fill = lambda: device_ms(lambda: buf.fill_(0.0), iters=100)
        # in turns: kernel, ceiling, ceiling, kernel
        t_k, t_f, t_f2, t_k2 = kernel(), fill(), fill(), kernel()
        t_k, t_f = (t_k + t_k2) / 2, (t_f + t_f2) / 2
        t_h = time_ms(lambda: dec(words, tau, n, shape))
        # the words it needs read, n f32 written; a select an element
        b_ms, b_by = bound_ms(2 * n, 4 * -(-n // 16) + 4 * n,
                              PEAK_F32_FLOPS)
        step["kernel"] += leaves * t_k
        step["bound"] += leaves * b_ms
        step["fill"] += leaves * t_f
        main = shape == (50257, 768)
        line = (f"K11 decode leaf {list(shape)} x{leaves} a step: "
                f"bit-identical={same} kernel_ms={t_k:.6f} "
                f"host_ms={t_h:.4f} bound_ms={b_ms:.4g}({b_by}) "
                f"bound_share={b_ms / t_k:.3f} write_ceiling_ms={t_f:.6f} "
                f"kernel/ceiling={t_k / t_f:.2f} grid="
                f"{ck.decode_grid(n)}x{ck.DECODE_WARPS * 32}"
                f"{f' bar={K11_BAR_MS}' if main else ''} {card}")
        log(line)
        if not same:
            raise AssertionError(f"K11 disagrees with its plain version: "
                                 f"{line}")
        if main:
            main_ms = t_k
            if t_k > K11_BAR_MS:
                raise AssertionError(f"K11 misses its bar at the embedding "
                                     f"leaf: {line}")
        del grad, words, buf
    log(f"K11 one dp_packed step, {sum(c for _, c in DECODE_LEAVES)} "
        f"leaves (leaf times x leaves): kernel_ms={step['kernel']:.6f} "
        f"bound_ms={step['bound']:.6f} bound_share="
        f"{step['bound'] / step['kernel']:.3f} write_ceiling_ms="
        f"{step['fill']:.6f} {card}")
    # ragged sizes, into a buffer a span longer than the leaf
    tau = torch.tensor(1e-3, device="cuda")
    for i, n in enumerate(DECODE_RAGGED):
        grad, _ = _codec_grad((n,), 730 + i)
        words, _ = enc(grad, tau)
        ref = dec_p(words, tau, n)
        buf = torch.full((n + ck.SPAN,), 7.0, device="cuda")
        err = _decode_c(lib, words, tau, buf.data_ptr(), n)
        same = _same_bits(dec(words, tau, n), ref)
        into = err == 0 and _same_bits(buf[:n], ref)
        past = bool((buf[n:] == 7.0).all())
        line = (f"K11 decode size={n}: bit-identical={same} (C entry "
                f"rc={err}: bit-identical={into} past_the_end_untouched="
                f"{past}) {card}")
        log(line)
        if not (same and into and past):
            raise AssertionError(f"K11 disagrees with its plain version: "
                                 f"{line}")
        del grad, words, ref, buf
    # an output one element off 16-byte alignment: refused, not written
    n = 10001
    words = torch.zeros(ck.threshold_words(n), dtype=torch.int32,
                        device="cuda")
    buf = torch.full((n + 1,), 7.0, device="cuda")
    err = _decode_c(lib, words, tau, buf.data_ptr() + 4, n)
    untouched = bool((buf == 7.0).all())
    line = (f"K11 decode into an out 4 bytes off 16-byte alignment: C "
            f"entry rc={err} (-1 expected) untouched={untouched} {card}")
    log(line)
    if err != -1 or not untouched:
        raise AssertionError(f"K11 took an unaligned out: {line}")
    return main_ms


def _norm_inputs(dt, n, f, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, f), generator=g, device="cuda").to(dt)
    d = torch.randn((n, f), generator=g, device="cuda").to(dt)
    gamma = (1 + 0.1 * torch.randn((f,), generator=g,
                                   device="cuda")).to(dt)
    return x, d, gamma


def _ulps(out, ref) -> float:
    diff = (out.float() - ref.float()).abs()
    return (diff / (ref.float().abs() * 2.0 ** -8 + 1e-3)).max().item()


def _norm_shapes():
    return [(dname, n) for dname in ("bfloat16", "float32")
            for n in (TRAIN_B * TRAIN_T, 2048)]


# the backward norm kernels' cases, (rows, F): K6 at the train and
# long-context paths' shapes and at 2048 rows; K9 at the fine-tune
# path's shape and a ragged [1000, 200]; for both, off the main paths, a
# row whose byte length is not a multiple of 16 (element loads) and two
# wide rows (the block-a-row path)
NORM_BWD_CASES = {
    "K6": ((TRAIN_B * TRAIN_T, 768), (2048, 768),
           (LONGCTX_B * LONGCTX_T, 768), (1000, 197), (64, 4096),
           (16, 16384)),
    "K9": ((BERT_B * BERT_T, 768), (1000, 200), (1000, 197), (64, 4096),
           (16, 16384)),
}
# the off-path rows: held to the plain version and to the bit like the
# rest, timed and printed beside the library call, but not held to the
# speed bars (the kernel's design takes them right, not fast)
NORM_BWD_OFF_PATH = {(1000, 197), (64, 4096), (16, 16384)}
# the main paths' shapes (bf16), where each kernel must reach half of its
# bound
NORM_BWD_MAIN = {"K6": TRAIN_B * TRAIN_T, "K9": BERT_B * BERT_T}


def _same_bytes(a, b) -> bool:
    """Equal to the bit, whatever the dtype."""
    import torch
    return bool(torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def _turns(kernel, library, pairs: int):
    """``pairs`` readings of each of two timers in alternating turns
    (kernel, library, library, kernel, kernel, library, ...), so that
    neither side always runs first: the two lists of readings."""
    ks, ls = [], []
    order = ((kernel, ks), (library, ls))
    for i in range(pairs):
        for fn, readings in (order if i % 2 == 0 else order[::-1]):
            readings.append(fn())
    return ks, ls


def _check_norm_bwd_cases(e, rows, card):
    """K6 (RMSNorm) or K9 (LayerNorm) backward against its plain version
    at every shape of ``NORM_BWD_CASES``, bf16 and f32, within the
    unchanged tolerances; dγ (and dβ) the same to the bit over two calls;
    timed beside the plain version and the backward of autograd through
    ``F.rms_norm`` / ``F.layer_norm`` (that call's forward time taken
    off; kernel and library timed in ``NORM_BAR_PAIRS`` alternating
    turns each, :func:`_turns`, and compared by their medians). The bars
    of the kernels: at every shape but the off-path rows
    (``NORM_BWD_OFF_PATH``) no slower than that library call, and at the
    main path's shape (bf16) at least half of the bound (bound time over
    kernel time)."""
    import torch
    import torch.nn.functional as F
    ln = e.key == "K9"
    bwd, plain = e.port_fn(), e.plain_fn()
    tol_f32, tol_ulps = ((K9_TOL_F32, K9_TOL_BF16_ULPS) if ln
                         else (K6_TOL_F32, K6_TOL_BF16_ULPS))
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for n, f in NORM_BWD_CASES[e.key]:
            if ln:
                x, dy, gamma, beta = _ln_inputs(dt, n, f)
            else:
                x, dy, gamma = _norm_inputs(dt, n, f, n + f + 1)
            got = bwd(x, gamma, dy)
            again = bwd(x, gamma, dy)
            ref = plain(x, gamma, dy)
            torch.cuda.synchronize()
            err = max((a.float() - r.float()).abs().max().item()
                      for a, r in zip(got, ref))
            if dname == "bfloat16":
                ulps = max(_ulps(a, r) for a, r in zip(got, ref))
                ok = ulps <= tol_ulps
                tol = f"max_ulps={ulps:.2f} tol={tol_ulps}ulps"
            else:
                rel = max(_rel_err(a, r) for a, r in zip(got, ref))
                ok = rel <= tol_f32
                tol = f"rel={rel:.3e} tol={tol_f32:.0e}"
            ok = ok and all(bool(torch.isfinite(a).all()) for a in got)
            same = all(_same_bytes(a, b) for a, b in zip(got[1:],
                                                         again[1:]))
            xr = x.detach().clone().requires_grad_()
            gr = gamma.detach().clone().requires_grad_()
            if ln:
                br = beta.detach().clone().requires_grad_()
                lib_fwd = lambda: F.layer_norm(xr, (f,), gr, br, eps=1e-5)
                leaves = (xr, gr, br)
            else:
                lib_fwd = lambda: F.rms_norm(xr, (f,), gr, eps=1e-6)
                leaves = (xr, gr)
            t_h = time_ms(lambda: bwd(x, gamma, dy))
            t_p = device_ms(lambda: plain(x, gamma, dy))
            kernel = lambda: device_ms(lambda: bwd(x, gamma, dy))
            library = lambda: (device_ms(lambda: torch.autograd.grad(
                lib_fwd(), leaves, dy)) - device_ms(lib_fwd))
            # the two sides of the bar in alternating turns, each the
            # median of its readings
            ks, ls = _turns(kernel, library, NORM_BAR_PAIRS)
            t_k, t_l = statistics.median(ks), statistics.median(ls)
            # reads x, dy, γ once and writes dx, dγ (and dβ) once; ~10
            # (K6) or ~14 (K9) f32 operations an element
            n_vec = 3 if ln else 2
            b_ms, b_by = bound_ms((14 if ln else 10) * x.numel(),
                                  (3 * x.numel() + n_vec * f)
                                  * x.element_size(), PEAK_F32_FLOPS)
            main = (dname, n) == ("bfloat16", NORM_BWD_MAIN[e.key])
            off = (n, f) in NORM_BWD_OFF_PATH
            bars = (off or t_k <= t_l) and (not main or b_ms / t_k >= 0.5)
            line = (f"{e.key} {e.name} {dname} rows={n} F={f}: "
                    f"max_abs_err={err:.3e} {tol} "
                    f"bit-identical_over_two_calls={same} "
                    f"kernel_ms={t_k:.4f} host_ms={t_h:.4f} "
                    f"plain_ms={t_p:.4f} library_ms={t_l:.4f} "
                    f"kernel/library={t_k / t_l:.2f} (turns: kernel "
                    f"{min(ks):.4f}-{max(ks):.4f}, library "
                    f"{min(ls):.4f}-{max(ls):.4f}) "
                    f"bound_ms={b_ms:.5f}({b_by}) "
                    f"bound_share={b_ms / t_k:.3f}{' main' if main else ''}"
                    f"{' off-path' if off else ''} {card}")
            log(line)
            if not ok:
                raise AssertionError(f"{e.key} disagrees with its plain "
                                     f"version: {line}")
            if not same:
                raise AssertionError(f"{e.key}'s parameter gradients differ "
                                     f"between two calls: {line}")
            if not bars:
                raise AssertionError(f"{e.key} misses a bar (no slower "
                                     f"than its library call; half of its "
                                     f"bound at the main shape): {line}")
            if main:
                rows[e.key] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                   bound_ms=b_ms, bound_by=b_by)
            rows[f"{e.key}_err"] = max(rows.get(f"{e.key}_err", 0.0), err)
            del x, dy, got, again, ref, xr, gr


def _check_add_norm(e, rows, card):
    """K7 against its plain version; yardstick: ``x + d`` then
    ``F.rms_norm``. The stored sum must equal the plain one exactly (one
    rounding of the same f32 sum)."""
    import torch
    import torch.nn.functional as F
    fused, plain = e.port_fn(), e.plain_fn()
    f = 768
    for dname, n in _norm_shapes():
        x, d, gamma = _norm_inputs(getattr(torch, dname), n, f, n + 2)
        y, s = fused(x, d, gamma)
        ry, rs = plain(x, d, gamma)
        torch.cuda.synchronize()
        err = (y.float() - ry.float()).abs().max().item()
        s_err = (s.float() - rs.float()).abs().max().item()
        if dname == "bfloat16":
            ulps = _ulps(y, ry)
            ok = ulps <= RMS_TOL_BF16_ULPS
            tol = f"max_ulps={ulps:.2f} tol={RMS_TOL_BF16_ULPS}ulps"
        else:
            ok = err <= RMS_TOL_F32
            tol = f"tol={RMS_TOL_F32:.0e}"
        ok = ok and s_err == 0 and bool(torch.isfinite(y).all())
        t_h = time_ms(lambda: fused(x, d, gamma))
        t_k = device_ms(lambda: fused(x, d, gamma))
        t_p = device_ms(lambda: plain(x, d, gamma))
        t_l = device_ms(lambda: F.rms_norm(x + d, (f,), gamma, eps=1e-6))
        nbytes = (4 * x.numel() + f) * x.element_size()
        b_ms, b_by = bound_ms(5 * x.numel(), nbytes, PEAK_F32_FLOPS)
        line = (f"K7 add_rms {dname} rows={n} F={f}: max_abs_err="
                f"{err:.3e} sum_err={s_err:.1e} {tol} kernel_ms={t_k:.4f}"
                f" host_ms={t_h:.4f} plain_ms={t_p:.4f} "
                f"add+F.rms_norm_ms={t_l:.4f} bound_ms={b_ms:.5f}({b_by})"
                f" {card}")
        log(line)
        if not ok:
            raise AssertionError(f"K7 disagrees with its plain version: "
                                 f"{line}")
        if (dname, n) == ("bfloat16", TRAIN_B * TRAIN_T):
            rows["K7"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                              bound_ms=b_ms, bound_by=b_by)
        rows["K7_err"] = max(rows.get("K7_err", 0.0), err)


# -- phase 2 ---------------------------------------------------------------
def phase_serve(state):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.obs import metrics
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.serving.gateway import ServingGateway
    from deeplearning4j_tpu_torch.zoo.gpt import (CausalTransformerLM,
                                                  prompt_bucket)
    card = state["card"]
    model = CausalTransformerLM(compute_dtype="bfloat16", **SERVE)
    params = model.init_params(seed=0, device="cuda")
    gw = ServingGateway(model, params, max_slots=32, block=16,
                        max_context=2048, queue_limit=64,
                        default_max_new=64)
    try:
        t0 = time.perf_counter()
        warm = gw.warmup()
        log(f"serve: warmup buckets={warm['buckets']} "
            f"{time.perf_counter() - t0:.1f}s")
        rng = np.random.default_rng(0)
        lens = rng.integers(16, 1501, size=32)
        buckets = [prompt_bucket(int(t), 2048) for t in lens]
        assert buckets.count(1024) >= 3 and buckets.count(2048) >= 3, \
            buckets
        prompts = [rng.integers(0, model.vocab_size, int(t)) for t in lens]
        step0 = metrics.SERVING_STEP.snapshot()[""]
        pre0 = metrics.SERVING_PREFILL.snapshot()[""]
        gw.pause()
        for e in kernel_registry.ported():
            e.reset()
        serve_kernels = kernel_registry.on_path("serve")
        t_start = time.perf_counter()
        streams = [gw.submit(p, max_new=64) for p in prompts]
        gw.resume()
        outs = [st.result(timeout=600) for st in streams]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = {e.key: e.launches() for e in kernel_registry.ported()}
        for p, st, o in zip(prompts, streams, outs):
            gen = o[len(p):]
            assert st.error() is None
            assert gen.shape == (64,), gen.shape
            assert ((gen >= 0) & (gen < model.vocab_size)).all()
        sched = gw._sched
        sched.pager.check_invariants()
        assert sched.pager.free_pages() == sched.pager.n_pages - 1
        for e in serve_kernels:
            assert launches[e.key] > 0, \
                f"{e.key} was never launched by the serving run"
        step1 = metrics.SERVING_STEP.snapshot()[""]
        pre1 = metrics.SERVING_PREFILL.snapshot()[""]
        n_steps = step1["count"] - step0["count"]
        step_ms = (step1["sum"] - step0["sum"]) / n_steps * 1e3
        prefill_ms = ((pre1["sum"] - pre0["sum"])
                      / (pre1["count"] - pre0["count"]) * 1e3)
        ttft = sorted(st.ttft_s for st in streams)
        tokens = 64 * len(streams)
        state.setdefault("launches", {})["serve"] = launches
        log(f"serve: requests={len(streams)} aborted=0 "
            f"buckets={sorted(set(buckets))} p50_ttft_s="
            f"{ttft[len(ttft) // 2]:.4f} max_ttft_s={ttft[-1]:.4f} "
            f"tokens_per_s={tokens / wall:.1f} wall_s={wall:.3f} "
            f"steps={n_steps} mean_step_ms={step_ms:.3f} "
            f"mean_prefill_ms={prefill_ms:.3f} {card}")
        log(f"serve: launches {launches} (K1 expects 12 per admission "
            f"= {12 * len(streams)}; K2 25 per admission and per step "
            f"= {25 * (len(streams) + n_steps)}) {card}")
        # the first non-kernel hot spot: the paged step's full page-table
        # gather, timed alone at the step's shape, against the step
        (pool,) = sched.pager.pool
        pt = torch.randint(1, sched.pager.n_pages,
                           (32, sched.max_pages_per_seq), device="cuda")
        hd2 = 2 * (model.hidden // model.n_heads)
        gather_ms = time_ms(lambda: pool[0, pt].permute(0, 2, 3, 1, 4)
                            .reshape(32, model.n_kv_heads, hd2, -1))
        log(f"serve: paged gather per layer ms={gather_ms:.4f} x12 = "
            f"{12 * gather_ms:.3f} ms = "
            f"{100 * 12 * gather_ms / step_ms:.1f}% of the mean step "
            f"{card}")
    finally:
        gw.shutdown(drain=False)


# -- phase 3 ---------------------------------------------------------------
def phase_agree(state):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    torch.backends.cuda.matmul.allow_tf32 = False
    model = CausalTransformerLM(**SERVE)         # float32
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, model.vocab_size, 300)
    forced = rng.integers(0, model.vocab_size, 8)
    results = {}
    for dev in ("cuda", "cpu"):
        params = model.init_params(seed=1, device=dev)
        toks = torch.zeros((1, 512), dtype=torch.int64, device=dev)
        toks[0, :300] = torch.as_tensor(prompt, device=dev)
        with torch.no_grad():
            logits, caches = model._prefill_forward(params, toks, 512 + 8,
                                                    300)
            seq = [logits.float().cpu()]
            for i, tok in enumerate(forced):
                logits, caches = model._token_logits(
                    params, torch.as_tensor([int(tok)], device=dev),
                    caches, 300 + i, 1)
                seq.append(logits.float().cpu())
        results[dev] = torch.stack(seq)
        del params, caches
    err = (results["cuda"] - results["cpu"]).abs().max().item()
    same = (results["cuda"].argmax(-1) == results["cpu"].argmax(-1)).all()
    log(f"agree: f32 prefill + 8 decode logits card vs CPU "
        f"max_abs_err={err:.3e} tol={AGREE_TOL:.0e} argmax_equal="
        f"{bool(same)} {state['card']}")
    if not (err <= AGREE_TOL and same):
        raise AssertionError("card and CPU logits disagree")


# -- phases 4-6: the serving options ------------------------------------------
def _opts_requests():
    """The serve_opts burst: the port's ``gen_shared_prefix_requests``
    at ``OPTS_REQUESTS`` requests of one ``OPTS_PREFIX``-token system
    prompt and a 16-256-token suffix, ``OPTS_NEW`` new tokens each."""
    from deeplearning4j_tpu_torch.serving.loadgen import \
        gen_shared_prefix_requests
    return gen_shared_prefix_requests(
        n_requests=OPTS_REQUESTS, prefix_len=OPTS_PREFIX,
        suffix_lens=OPTS_SUFFIX, max_new=OPTS_NEW,
        vocab_size=SERVE["vocab_size"], seed=0)


def _hooked():
    """Context for a run whose measurement hooks sit inside a program's
    body (a wrapped ``_pick``, a patched divisor, a recorded argument):
    the programs run their functions (``perf.sentry.eager()``), as a
    replay runs no Python."""
    from deeplearning4j_tpu_torch.perf import sentry
    return sentry.eager()


def _record_margins(model, sched):
    """Record, for every token the scheduler picks, the top-two logit
    margin of the row it came from: ``model._pick`` and ``sched.admit``
    are wrapped on these instances (a top-2 on the card, no sync) —
    only for an untimed pass. The returned function maps each request's
    prompt (bytes) to its margins in token order, after the run."""
    import torch
    calls, cur = [], {}
    real_pick, real_admit = model._pick, sched.admit

    def admit(req):
        cur["req"] = req
        return real_admit(req)

    def pick(logits, *a, **kw):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        if logits.shape[0] == 1:
            rows = [(cur["req"], 0)]
        else:
            rows = [(s.req, i) for i, s in enumerate(sched._slots) if s]
        calls.append((top2[:, 0] - top2[:, 1], rows))
        return real_pick(logits, *a, **kw)

    model._pick, sched.admit = pick, admit

    def margins():
        out = {}
        for gap, rows in calls:
            gap = gap.cpu().numpy()
            for req, i in rows:
                out.setdefault(req.prompt.tobytes(), []).append(
                    float(gap[i]))
        return out
    return margins


def _path_logits(params, requests, forced, dtype: str, model_kw,
                 spec: bool):
    """The serve model's logits on one of the two paths the near-tie
    rule compares, on the card: a scheduler admits the burst's first two
    requests — without options both by dense prefills, then 63
    single-token steps; with prefix sharing the second by the suffix
    prefill, then 15 verify steps of k = 4 — teacher-forced on
    ``forced`` [2, OPTS_NEW], so every position is compared. Returns
    (the second request's first-token logits [1, V], the steps' logits
    [2, n, V]), f32 on the card."""
    import torch
    from deeplearning4j_tpu_torch.serving.scheduler import DecodeScheduler
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    torch.backends.cuda.matmul.allow_tf32 = False
    model = CausalTransformerLM(compute_dtype=dtype, **SERVE, **model_kw)
    p = model._decode_params(params)
    sched = DecodeScheduler(model, params, max_slots=OPTS_SLOTS, block=16,
                            max_context=2048, prefix_sharing=spec)
    firsts = []
    hook = "_suffix_logits" if spec else "_prefill_logits_into_pages"
    real = getattr(sched, hook)
    setattr(sched, hook, lambda *a: firsts.append(real(*a)) or firsts[-1])
    with _hooked():
        for r in requests[:2]:
            sched.admit(_ForcedReq(r["prompt"], OPTS_NEW))
    assert len(firsts) == (1 if spec else 2), len(firsts)
    f = sched._ensure_feed([0, 1])
    dev = f["lengths"].device
    lengths = f["lengths"].clone()
    prev = f["prev"].clone()
    rows = []
    with torch.no_grad():
        if not spec:
            prev[:2] = torch.as_tensor(forced[:, 0], device=dev)
            for j in range(OPTS_NEW - 1):
                rows.append(sched._decode_logits(
                    p, f["pt"], lengths, f["active"], prev)[:2].float())
                lengths = lengths + f["active"].to(lengths.dtype)
                prev[:2] = torch.as_tensor(forced[:, j + 1], device=dev)
            rows = torch.stack(rows, 1)
        else:
            k = 4
            drafts = torch.zeros((OPTS_SLOTS, k - 1), dtype=torch.int64,
                                 device=dev)
            for j in range(0, OPTS_NEW - 1 - k + 1, k):
                prev[:2] = torch.as_tensor(forced[:, j], device=dev)
                drafts[:2] = torch.as_tensor(forced[:, j + 1:j + k],
                                             device=dev)
                rows.append(sched._spec_logits(
                    p, f["pt"], lengths, f["active"], prev,
                    drafts)[:2].float())
                lengths = lengths + k * f["active"].to(lengths.dtype)
            rows = torch.cat(rows, 1)
    return firsts[-1][:1].float(), rows


def _opts_path_error(params, requests, pair: str, model_kw, card) -> float:
    """The error the near-tie rule allows between a gateway without
    prefix sharing and spec decode and one with them (``model_kw``: the
    model options both share): the largest |logit difference| between
    the two paths in bf16 (``_path_logits``: first-token and step
    logits). It must stay within a limit set by the single-token path
    and by float32: the paths' float32 difference (the arithmetic the
    two paths do differently, ~1e-5 with the float cache, the shared
    keys' quantisation with the int8 cache) plus twice the single-token
    path's own bf16 error (bf16 against float32) — each bf16 path's
    distance from its float32 twin counted as the single path's. A
    bf16 fault of the verify step or the suffix prefill alone shows as
    an error past that limit."""
    import numpy as np
    forced = np.random.default_rng(3).integers(
        0, SERVE["vocab_size"], (2, OPTS_NEW))
    got = {(spec, dt): _path_logits(params, requests, forced, dt, model_kw,
                                    spec)
           for spec in (False, True) for dt in ("bfloat16", "float32")}
    n = got[(True, "float32")][1].shape[1]

    def diff(a, b):
        return max((x[..., :n, :] - y[..., :n, :]).abs().max().item()
                   if x.dim() == 3 else (x - y).abs().max().item()
                   for x, y in zip(got[a], got[b]))
    err = diff((True, "bfloat16"), (False, "bfloat16"))
    e_bf16 = diff((False, "bfloat16"), (False, "float32"))
    q = diff((True, "float32"), (False, "float32"))
    limit = q + 2 * e_bf16
    del got
    log(f"serve_opts: path error {pair} cache, single-token path (dense "
        f"prefills) vs sharing + spec (suffix prefill, k=4 verify), "
        f"first token + {n} forced positions x 2 slots: bf16 "
        f"max_abs_err={err:.4e}; limit {limit:.4e} = f32 paths' "
        f"difference {q:.4e} + 2 x single-token bf16 vs f32 "
        f"{e_bf16:.4e} {card}")
    assert err <= limit, (f"{pair}: the bf16 paths differ by {err:.4e}, "
                          f"past {limit:.4e}")
    return err


class _ForcedReq:
    """A duck-typed request for driving a scheduler directly."""

    def __init__(self, prompt, max_new):
        import numpy as np
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new = max_new
        self.temperature = None
        self.eos_id = None
        self.tokens = []

    def push(self, tok):
        self.tokens.append(int(tok))

    def finish(self):
        pass

    def fail(self, e):
        raise e


def phase_serve_opts(state):
    """Four gateways at the serve width (bfloat16, ``max_slots=32``,
    ``block=16``, ``max_context=2048``) each run the same shared-prefix
    burst through the port's ``run_trace(mode="burst")``: (a) no
    options, (b) prefix sharing + spec_k 4, (c) int8 weights + int8
    cache, (d) all four. Each: 64 in-vocab tokens a stream, no error,
    pager invariants and every page freed, exact K1 (12 a dense
    admission) and K2 (25 an admission and a step) launches, in (b) and
    (d) prefix hits and drafts. (b) is held against (a) and (d) against
    (c): a stream may leave the reference's tokens only where the
    reference's top two logits lie within twice the measured bf16 error
    between the two paths (itself held to a limit set by the
    single-token path and float32, ``_opts_path_error``), and is not
    compared after that; the reference's tokens and margins come from
    a second, untimed burst through the same gateway. Then the
    request-at-a-time baseline on the same traffic, and the decode step
    with and without the int8 options."""
    import torch
    from deeplearning4j_tpu_torch.obs import metrics
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.serving.gateway import ServingGateway
    from deeplearning4j_tpu_torch.serving.loadgen import (
        baseline_tokens_per_sec, run_trace)
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    card = state["card"]
    base = CausalTransformerLM(compute_dtype="bfloat16", **SERVE)
    params = base.init_params(seed=0, device="cuda")
    requests = _opts_requests()
    lens = [len(r["prompt"]) for r in requests]
    errs = {"a": _opts_path_error(params, requests, "float", {}, card),
            "c": _opts_path_error(params, requests, "int8", _INT8, card)}
    ported = kernel_registry.ported()
    total = {e.key: 0 for e in ported}
    outs, refs = {}, {}
    for tag, model_kw, gw_kw in OPTS_GATEWAYS:
        model = CausalTransformerLM(compute_dtype="bfloat16", **SERVE,
                                    **model_kw)
        gw = ServingGateway(model, params, max_slots=OPTS_SLOTS, block=16,
                            max_context=2048, queue_limit=64,
                            default_max_new=OPTS_NEW, **gw_kw)
        sched = gw._sched
        streams = []
        real_submit = gw.submit
        gw.submit = lambda *a, **kw: streams.append(
            real_submit(*a, **kw)) or streams[-1]
        try:
            t0 = time.perf_counter()
            warm = gw.warmup(prompt_lens=lens)
            t_warm = time.perf_counter() - t0
            snap = lambda m: m.snapshot()[""]
            entry = ('{entry="serving.spec_step"}' if gw_kw.get("spec_k")
                     else '{entry="serving.decode_step"}')
            host = lambda: [m.snapshot().get(entry, 0.0) for m in (
                metrics.H2D_SECONDS, metrics.SYNC_SECONDS)]
            host0 = host()
            before = {m: snap(m) for m in (
                metrics.SERVING_STEP, metrics.SERVING_PREFILL,
                metrics.SERVING_PREFIX_HITS, metrics.SERVING_PREFIX_SAVED,
                metrics.SERVING_PREFIX_COW, metrics.SERVING_SPEC_DRAFTED,
                metrics.SERVING_SPEC_ACCEPTED)}
            for e in ported:
                e.reset()
            stats = run_trace(gw, requests, mode="burst", timeout_s=600)
            torch.cuda.synchronize()
            launches = {e.key: e.launches() for e in ported}
            delta = {m: (snap(m)["count"] - before[m]["count"]
                         if isinstance(before[m], dict)
                         else snap(m) - before[m]) for m in before}
            step_ms = ((snap(metrics.SERVING_STEP)["sum"]
                        - before[metrics.SERVING_STEP]["sum"])
                       / delta[metrics.SERVING_STEP] * 1e3)
            prefill_ms = ((snap(metrics.SERVING_PREFILL)["sum"]
                           - before[metrics.SERVING_PREFILL]["sum"])
                          / delta[metrics.SERVING_PREFILL] * 1e3)
            assert len(streams) == OPTS_REQUESTS, len(streams)
            gens = []
            for st in streams:
                assert st.error() is None, st.error()
                gen = st.result(timeout=5)[len(st.prompt):]
                assert gen.shape == (OPTS_NEW,), gen.shape
                assert ((gen >= 0) & (gen < model.vocab_size)).all()
                gens.append(gen)
            assert stats["completed"] == OPTS_REQUESTS, stats
            sched.pager.check_invariants()
            assert sched.pager.free_pages() == sched.pager.n_pages - 1
            hits = int(delta[metrics.SERVING_PREFIX_HITS])
            steps = int(delta[metrics.SERVING_STEP])
            feed_ms, sync_ms = ((b - a) / steps * 1e3
                                for a, b in zip(host0, host()))
            want = {e.key: 0 for e in ported}
            want["K1"] = 12 * (OPTS_REQUESTS - hits)
            want["K2"] = 25 * (OPTS_REQUESTS + steps)
            log(f"serve_opts ({tag}) {model_kw or ''}{gw_kw or ''}: "
                f"launches {launches} (expected {want}: K1 12 x "
                f"{OPTS_REQUESTS - hits} dense admissions, K2 25 x "
                f"({OPTS_REQUESTS} admissions + {steps} steps)) {card}")
            assert launches == want, (launches, want)
            if gw_kw:
                assert hits > 0 and delta[metrics.SERVING_SPEC_DRAFTED] > 0
            ttft = sorted(st.ttft_s for st in streams)
            drafted = delta[metrics.SERVING_SPEC_DRAFTED]
            log(f"serve_opts ({tag}): requests={len(streams)} "
                f"p50_ttft_s={ttft[len(ttft) // 2]:.4f} "
                f"max_ttft_s={ttft[-1]:.4f} "
                f"tokens_per_s={stats['tokens'] / stats['wall_s']:.1f} "
                f"wall_s={stats['wall_s']} steps={steps} "
                f"mean_step_ms={step_ms:.3f} (host feed"
                f"{' + draft' if gw_kw else ''} {feed_ms:.3f}, sync "
                f"{sync_ms:.3f}) "
                f"mean_prefill_ms={prefill_ms:.3f} "
                f"accept_rate={stats['spec_accept_rate']} "
                f"drafted={int(drafted)} "
                f"accepted={int(delta[metrics.SERVING_SPEC_ACCEPTED])} "
                f"prefix_hits={hits} prefill_tokens_saved="
                f"{int(delta[metrics.SERVING_PREFIX_SAVED])} "
                f"cow_copies={int(delta[metrics.SERVING_PREFIX_COW])} "
                f"pool_bytes={sched.pager.pool_bytes()} "
                f"warmup_s={t_warm:.1f} suffix_buckets="
                f"{warm['suffix_buckets']} {card}")
            for k in total:
                total[k] += launches[k]
            outs[tag] = {st.prompt.tobytes(): g
                         for st, g in zip(streams, gens)}
            if tag in errs:
                refs[tag] = _margins_pass(gw, model, requests, streams,
                                          outs[tag], tag, card)
        finally:
            gw.shutdown(drain=False)
            del gw, sched
            _free_card(f"serve_opts ({tag})", card)
    state.setdefault("launches", {})["serve_opts"] = total
    # (b) against (a), (d) against (c): the near-tie rule
    for ref, tag in (("a", "b"), ("c", "d")):
        _near_ties(refs[ref], outs[tag], errs[ref], ref, tag, card)
    # the request-at-a-time baseline on (a)'s traffic
    baseline_tokens_per_sec(base, params, requests[:1])
    tps = baseline_tokens_per_sec(base, params, requests)
    log(f"serve_opts: request-at-a-time baseline (B=1 generate, "
        f"sequential) tokens_per_s={tps:.1f} on the same {OPTS_REQUESTS} "
        f"requests {card}")
    _opts_step_costs(params, requests, card)


def _margins_pass(gw, model, requests, streams, timed, tag, card):
    """A second, untimed burst of ``requests`` through ``gw`` with the
    top-two margins recorded (``_record_margins``); the pager must again
    free every page. Returns {prompt bytes: (tokens, margins)}, and
    prints how many streams equal the timed burst's ``timed``."""
    import numpy as np
    from deeplearning4j_tpu_torch.serving.loadgen import run_trace
    sched = gw._sched
    margins = _record_margins(model, sched)
    streams.clear()
    with _hooked():
        stats = run_trace(gw, requests, mode="burst", timeout_s=600)
    assert stats["completed"] == OPTS_REQUESTS, stats
    sched.pager.check_invariants()
    assert sched.pager.free_pages() == sched.pager.n_pages - 1
    got = margins()
    ref = {}
    for st in streams:
        key = st.prompt.tobytes()
        ref[key] = (st.result(timeout=5)[len(st.prompt):], got[key])
        assert len(got[key]) == OPTS_NEW, len(got[key])
    same = sum(np.array_equal(ref[k][0], timed[k]) for k in timed)
    log(f"serve_opts ({tag}): untimed burst with margins recorded: "
        f"{same} of {len(timed)} streams equal the timed burst's {card}")
    return ref


def _near_ties(ref, got, err, ref_tag, tag, card) -> None:
    """Every stream of gateway ``tag`` equals the reference's tokens up
    to its first difference, which must fall where the reference's top
    two logits lie within 2 x ``err``; the stream is not compared past
    it."""
    import numpy as np
    same, tied = 0, 0
    for key, (toks, margins) in ref.items():
        diff = np.flatnonzero(toks != got[key])
        if not diff.size:
            same += 1
            continue
        j = int(diff[0])
        assert margins[j] <= 2 * err, (
            f"({tag}) leaves ({ref_tag}) at token {j} where ({ref_tag})'s "
            f"top-two margin {margins[j]:.4e} > 2 x {err:.4e}")
        tied += 1
    log(f"serve_opts: ({tag}) vs ({ref_tag}): {same} streams equal, {tied} "
        f"leave ({ref_tag}) at a near tie (top-two margin <= 2 x "
        f"{err:.4e}) {card}")


def _opts_step_costs(params, requests, card) -> None:
    """The decode step with 32 live slots (the burst's first 32
    requests, admitted densely) at bf16, with the int8 cache, with the
    int8 cache whose quantiser copies its divisor from the host (a 0-dim
    ``torch.tensor``: a copy that waits for the stream, 12 a step), and
    with int8 weights: wall ms of 8 eager steps from a synchronised
    card (the divisor is swapped in the step's body, which a replay does
    not run), in ``STEP_TURNS`` turns after one warm turn (median, min,
    max); and the page-table gather of one layer's context with its
    conversion to bf16 (``DecodeScheduler._context``) timed alone."""
    import torch
    from deeplearning4j_tpu_torch.serving.scheduler import DecodeScheduler
    from deeplearning4j_tpu_torch.zoo import gpt
    real_div = gpt._div127

    def host_div(x):
        return x / torch.tensor(127.0, dtype=x.dtype, device=x.device)
    variants = (("bf16", {}, real_div),
                ("int8 cache", {"cache_quant": "int8"}, real_div),
                ("int8 cache, host-copied divisor", {"cache_quant": "int8"},
                 host_div),
                ("int8 weights", {"serve_quant": "int8"}, real_div))
    scheds = {}
    for tag, kw, div in variants:
        model = gpt.CausalTransformerLM(compute_dtype="bfloat16", **SERVE,
                                        **kw)
        sched = DecodeScheduler(model, params, max_slots=OPTS_SLOTS,
                                block=16, max_context=2048)
        sched.warmup(prompt_lens=[len(r["prompt"]) for r in requests])
        for r in requests[:OPTS_SLOTS]:
            sched.admit(_ForcedReq(r["prompt"], OPTS_NEW))
        scheds[tag] = (sched, div)

    def turn(tag):
        sched, div = scheds[tag]
        gpt._div127 = div
        try:
            return _wall_ms(lambda: [sched.step() for _ in range(8)]) / 8
        finally:
            gpt._div127 = real_div
    walls = {tag: [] for tag in scheds}
    with _hooked():
        for i in range(STEP_TURNS + 1):
            for tag in scheds:
                ms = turn(tag)
                if i:
                    walls[tag].append(ms)
    for tag, (sched, _) in scheds.items():
        pt = torch.as_tensor(sched._page_table, device=sched.device)
        ctx_ms = time_ms(lambda: sched._context(0, pt, torch.bfloat16))
        w = walls[tag]
        log(f"serve_opts: decode step {tag}: mean_step_ms median="
            f"{statistics.median(w):.3f} min={min(w):.3f} max={max(w):.3f}"
            f" ({STEP_TURNS} turns of 8 steps x {OPTS_SLOTS} live slots, "
            f"in turns with the other variants); context gather per layer "
            f"ms={ctx_ms:.4f} x12 = {12 * ctx_ms:.3f} ms; pool_bytes="
            f"{sched.pager.pool_bytes()} {card}")
    del scheds, sched
    _free_card("serve_opts step costs", card)


def _agree(name: str, got, ref, card) -> float:
    """``got`` against ``ref`` ([..., V] logits, host f32): max |d| <=
    ``AGREE_TOL``, and an argmax that differs only on a row whose top
    two (in ``ref``) lie within twice the observed error."""
    import numpy as np
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.abs(got - ref).max())
    top2 = np.sort(ref, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    flipped = np.argmax(got, -1) != np.argmax(ref, -1)
    log(f"serve_opts_agree: {name}: max_abs_err={err:.3e} "
        f"tol={AGREE_TOL:.0e} argmax differs on {int(flipped.sum())} of "
        f"{flipped.size} rows {card}")
    assert err <= AGREE_TOL, (name, err)
    assert (margin[flipped] <= 2 * err).all(), (name, margin[flipped])
    return err


def _sequential_suffix(model, params, donor, prompt, shared_len,
                       max_context):
    """The reference of a suffix prefill: a scheduler without sharing
    admits ``donor``; a second slot's table row takes the donor's first
    ``shared_len // 16`` pages and fresh ones, and the suffix runs one
    token at a time through the single-row decode step. Returns the
    logits [V] at the prompt's last position."""
    import torch
    from deeplearning4j_tpu_torch.serving.scheduler import DecodeScheduler
    sched = DecodeScheduler(model, params, max_slots=2, block=16,
                            max_context=max_context)
    sched.admit(_ForcedReq(donor, 16))
    npg = sched.pages_needed(len(prompt), 16)
    n_full = shared_len // 16
    row = list(sched._page_table[0][:n_full]) + sched.pager.alloc(
        npg - n_full, object())
    dev = sched.device
    pt = torch.as_tensor(sched._page_table, device=dev)
    pt[1, :npg] = torch.as_tensor(row, device=dev)
    p = model._decode_params(params)
    active = torch.tensor([False, True], device=dev)
    with torch.no_grad():
        for pos in range(shared_len, len(prompt)):
            logits = sched._decode_logits(
                p, pt, torch.tensor([0, pos], device=dev), active,
                torch.tensor([0, int(prompt[pos])], device=dev))
    return logits[1]


def phase_serve_opts_agree(state):
    """The serve model in float32 with int8 weights and the int8 cache
    (TF32 off), card against the port on the CPU within ``AGREE_TOL``:
    a 300-token prefill and 8 teacher-forced decode steps; the verify
    step over [2, 4] rows against 4 single-token steps from one pool;
    the suffix prefill of a sharer against the same suffix run token by
    token over the same shared pages (with the float cache also against
    the dense prefill of the whole prompt: the int8 cache's dense
    prefill attends its keys unquantised, as the JAX package's does, so
    there the two differ by the quantisation, printed). ``_quant_kv``
    and ``QuantizedWeight`` give the same bits on the card and the CPU
    for the same input."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.serving.scheduler import DecodeScheduler
    from deeplearning4j_tpu_torch.zoo.gpt import (CausalTransformerLM,
                                                  QuantizedWeight, _quant_kv)
    card = state["card"]
    torch.backends.cuda.matmul.allow_tf32 = False
    model = CausalTransformerLM(serve_quant="int8", cache_quant="int8",
                                **SERVE)
    fmodel = CausalTransformerLM(serve_quant="int8", **SERVE)
    V = model.vocab_size
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, V, 300)
    forced = rng.integers(0, V, (2, 8))
    prefix = rng.integers(0, V, 256)
    donor = np.r_[prefix, rng.integers(0, V, 44)].astype(np.int32)
    sharer = np.r_[prefix, rng.integers(0, V, 44)].astype(np.int32)
    kv = torch.as_tensor(rng.standard_normal((2, 6, 2, 128, 300)) * 3,
                         dtype=torch.float32)
    res = {}
    for dev in ("cuda", "cpu"):
        out = res[dev] = {}
        params = model.init_params(seed=1, device=dev)
        p = model._decode_params(params)
        out["quant"] = {path: (w.w8.cpu(), w.scale.cpu())
                        for path, w in _qw_leaves(p, QuantizedWeight)}
        out["quant_kv"] = [t.cpu() for t in _quant_kv(kv.to(dev), 3)]
        with torch.no_grad():
            toks = torch.zeros((1, 512), dtype=torch.int64, device=dev)
            toks[0, :300] = torch.as_tensor(prompt, device=dev)
            logits, caches = model._prefill_forward(p, toks, 512 + 8, 300)
            seq = [logits.float().cpu()]
            for i, tok in enumerate(forced[0]):
                logits, caches = model._token_logits(
                    p, torch.as_tensor([int(tok)], device=dev), caches,
                    300 + i, 1)
                seq.append(logits.float().cpu())
            out["dense"] = torch.cat(seq).numpy()
            out["codes0"] = caches[0][0].cpu()
            del caches
            # the verify rows against 4 single steps from one pool
            sched = DecodeScheduler(model, params, max_slots=2, block=16,
                                    max_context=512)
            for pr in (donor, sharer):
                sched.admit(_ForcedReq(pr, 16))
            f = sched._ensure_feed([0, 1])
            saved = [t.clone() for t in sched.pager.pool]
            prev = torch.as_tensor(forced[:, 0], device=dev)
            rows = sched._spec_logits(p, f["pt"], f["lengths"], f["active"],
                                      prev, torch.as_tensor(
                                          forced[:, 1:4], device=dev))
            for t, s in zip(sched.pager.pool, saved):
                t.copy_(s)
            lengths, single = f["lengths"], []
            for j in range(4):
                single.append(sched._decode_logits(
                    p, f["pt"], lengths, f["active"],
                    torch.as_tensor(forced[:, j], device=dev)))
                lengths = lengths + 1
            out["rows"] = rows.float().cpu().numpy()
            out["single"] = torch.stack(single, 1).float().cpu().numpy()
            del sched, saved
            # the suffix prefill (int8 cache, then the float cache)
            for tag, m in (("int8", model), ("float", fmodel)):
                mp = m._decode_params(params)
                # room for a third 512-token reservation: the dense
                # prefill of the sharer's whole prompt
                sched = DecodeScheduler(m, params, max_slots=2, block=16,
                                        max_context=512, n_pages=1 + 3 * 32,
                                        prefix_sharing=True)
                sched.admit(_ForcedReq(donor, 16))
                seen = []
                real = sched._suffix_logits
                # the shared length comes as a 0-d tensor on the device
                sched._suffix_logits = (lambda *a: seen.append(
                    (int(a[3]), real(*a))) or seen[-1][1])
                with _hooked():
                    sched.admit(_ForcedReq(sharer, 16))
                (shared_len, suffix), = seen
                assert shared_len == 256, shared_len
                out[f"suffix_{tag}"] = suffix.float().cpu().numpy()[0]
                out[f"seq_{tag}"] = _sequential_suffix(
                    m, params, donor, sharer, shared_len,
                    512).float().cpu().numpy()
                pages = torch.as_tensor(sched.pager.alloc(32, object()),
                                        device=dev)
                pad = torch.zeros((1, 512), dtype=torch.int64, device=dev)
                pad[0, :300] = torch.as_tensor(sharer, device=dev)
                out[f"dense_{tag}"] = sched._prefill_logits_into_pages(
                    mp, pages, pad, 300).float().cpu().numpy()[0]
                del sched
        del params, p
    cu, cpu = res["cuda"], res["cpu"]
    same_bits = all(
        torch.equal(cu["quant"][k][0], cpu["quant"][k][0])
        and torch.equal(cu["quant"][k][1].view(torch.int32),
                        cpu["quant"][k][1].view(torch.int32))
        for k in cpu["quant"])
    kv_bits = (torch.equal(cu["quant_kv"][0], cpu["quant_kv"][0])
               and torch.equal(cu["quant_kv"][1].view(torch.int32),
                               cpu["quant_kv"][1].view(torch.int32)))
    n_diff = int((cu["codes0"] != cpu["codes0"]).sum())
    log(f"serve_opts_agree: QuantizedWeight codes and scales card == CPU "
        f"for all {len(cpu['quant'])} weights: {same_bits}; _quant_kv on "
        f"one input card == CPU to the bit: {kv_bits}; layer-0 cache codes "
        f"of the two prefills (each device's own k/v) differ at {n_diff} "
        f"of {cpu['codes0'].numel()} {card}")
    assert same_bits and kv_bits
    _agree("prefill + 8 decode logits, card vs CPU", cu["dense"],
           cpu["dense"], card)
    for dev, out in res.items():
        _agree(f"verify rows vs 4 single steps ({dev})", out["rows"],
               out["single"], card)
        _agree(f"suffix prefill vs token-by-token suffix, int8 cache "
               f"({dev})", out["suffix_int8"], out["seq_int8"], card)
        _agree(f"suffix prefill vs dense prefill, float cache ({dev})",
               out["suffix_float"], out["dense_float"], card)
        gap = float(np.abs(out["suffix_int8"] - out["dense_int8"]).max())
        log(f"serve_opts_agree: suffix prefill vs dense prefill, int8 cache "
            f"({dev}): max_abs_diff={gap:.3e} (the quantisation of the "
            f"shared keys; not bounded) {card}")
    for key in ("rows", "suffix_int8", "suffix_float"):
        _agree(f"{key} card vs CPU", cu[key], cpu[key], card)


def _qw_leaves(p, cls):
    """(key path, leaf) of every ``cls`` leaf of a parameter tree."""
    from deeplearning4j_tpu_torch import tree
    found = []
    tree.map_with_path(lambda path, w: found.append((path, w))
                       if isinstance(w, cls) else None, p)
    return found


def phase_beam(state):
    """``generate_beam`` at the serve width in bfloat16: B = 4 prompts
    of 300 tokens, ``BEAM_NEW`` new tokens, 4 beams, without and with
    both int8 options. Between zeroed and read counters: two beam calls
    (equal output, the shape [4, 300 + BEAM_NEW], the prompts kept) and
    one ``beams=1`` call, which must equal greedy ``generate`` exactly;
    every kernel exactly its registry count per call. The ms per call,
    and ``_top_k``'s tie order on the card."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.ops.kernel_registry import BEAM_NEW
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM, _top_k
    card = state["card"]
    ties = torch.tensor([[1., 3., 3., 2., 3., 0.]], device="cuda")
    assert _top_k(ties, 3)[1].tolist() == [[1, 2, 4]]
    params = CausalTransformerLM(**SERVE).init_params(seed=0,
                                                      device="cuda")
    prompts = np.random.default_rng(4).integers(
        0, SERVE["vocab_size"], (BEAM_B, BEAM_T0))
    ported = kernel_registry.ported()
    total = {e.key: 0 for e in ported}
    calls = 0
    for tag, kw in (("bf16", {}), ("int8 weights + int8 cache",
                                   {"serve_quant": "int8",
                                    "cache_quant": "int8"})):
        model = CausalTransformerLM(compute_dtype="bfloat16", **SERVE, **kw)
        model.generate_beam(params, prompts, n_new=BEAM_NEW, beams=4)
        torch.cuda.synchronize()
        for e in ported:
            e.reset()
        a = model.generate_beam(params, prompts, n_new=BEAM_NEW, beams=4)
        b = model.generate_beam(params, prompts, n_new=BEAM_NEW, beams=4)
        one = model.generate_beam(params, prompts, n_new=BEAM_NEW, beams=1)
        torch.cuda.synchronize()
        launches = {e.key: e.launches() for e in ported}
        greedy = model.generate(params, prompts, n_new=BEAM_NEW)
        assert a.shape == (BEAM_B, BEAM_T0 + BEAM_NEW), a.shape
        assert (a[:, :BEAM_T0] == prompts).all()
        assert ((a >= 0) & (a < SERVE["vocab_size"])).all()
        assert np.array_equal(a, b), "two beam calls differ"
        assert np.array_equal(one, greedy), "beams=1 differs from greedy"
        _check_step_launches("beam", 3, launches, card)
        for k in total:
            total[k] += launches[k]
        calls += 3
        # the host clock over whole calls (each ends in a copy to the
        # host), past the counted window
        walls = []
        for _ in range(BEAM_TIMED):
            t0 = time.perf_counter()
            model.generate_beam(params, prompts, n_new=BEAM_NEW, beams=4)
            walls.append((time.perf_counter() - t0) * 1e3)
        log(f"beam ({tag}): B={BEAM_B} T0={BEAM_T0} n_new={BEAM_NEW} "
            f"beams=4 ms_per_call median={statistics.median(walls):.1f} "
            f"min={min(walls):.1f} max={max(walls):.1f} of {BEAM_TIMED} "
            f"calls; two calls equal, beams=1 == "
            f"greedy, beam == greedy on {int((a == greedy).all(1).sum())} "
            f"of {BEAM_B} rows {card}")
    state.setdefault("launches", {})["beam"] = total


# -- phases 7, 11 -----------------------------------------------------------
def _train_batch(seed: int, b: int, t: int, vocab: int):
    """Random tokens from ``np.random.default_rng(seed)``: inputs and
    their next-token labels, [b, t] int32 each."""
    import numpy as np
    toks = np.random.default_rng(seed).integers(0, vocab, (b, t + 1))
    return (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32))


def _fit_steps(state, path: str, model_kw, b: int, t: int, warm: int,
               steps: int, make_step=None, label=None, record=True):
    """The stepped LM path ``path``: ``CausalTransformerLM(**model_kw)``
    (bfloat16 compute) built by ``init(t)`` and trained on one fixed
    [b, t] batch by :func:`_timed_steps`. A step is ``net.fit(x, y)``,
    or the callable ``make_step(net, x, y)`` returns (it ends in a device
    sync and leaves the loss in ``net.score()``). Returns the net."""
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    model = CausalTransformerLM(compute_dtype="bfloat16", **model_kw)
    t0 = time.perf_counter()
    net = model.init(t)
    x, y = _train_batch(0, b, t, model.vocab_size)
    log(f"{label or path}: init {net.num_params()} params "
        f"{time.perf_counter() - t0:.1f}s")
    step = (make_step(net, x, y) if make_step is not None
            else lambda: net.fit(x, y))
    _timed_steps(state, path, net, step, b, t, warm, steps, label=label,
                 record=record)
    return net


def _timed_steps(state, path: str, net, step, b: int, t: int, warm: int,
                 steps: int, label=None, record=True):
    """``warm`` calls of ``step``, then ``steps`` timed ones between
    zeroed and read launch counters, from a reset peak of card memory:
    every loss finite and the last below the first, each kernel launched
    exactly its registry count for ``path`` a step (the counts kept for
    the kernels line when ``record``). Prints and returns ``(losses,
    mean_step_ms, tokens_per_s, max_memory_allocated_gb)`` under
    ``label`` (default ``path``), also kept in ``state["timed"]``."""
    import math
    import torch
    from deeplearning4j_tpu_torch.ops import kernel_registry
    card, label = state["card"], label or path
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(warm):
        step()
        losses.append(net.score())
    for e in kernel_registry.ported():
        e.reset()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for _ in range(steps):
        step()                               # ends in a device sync
        losses.append(net.score())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {e.key: e.launches() for e in kernel_registry.ported()}
    if record:
        state.setdefault("launches", {})[path] = launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms, rate = wall / steps * 1e3, b * t / wall * steps
    state.setdefault("timed", {})[label] = (losses, step_ms, rate, peak_gb)
    log(f"{label}: losses {' '.join(f'{l:.4f}' for l in losses)} {card}")
    log(f"{label}: B={b} T={t} steps={steps} mean_step_ms="
        f"{step_ms:.3f} tokens_per_s={rate:.1f}"
        f" max_memory_allocated_gb={peak_gb:.3f} {card}")
    assert all(math.isfinite(l) for l in losses), losses
    assert losses[-1] < losses[0], losses
    _check_step_launches(path, steps, launches, card)
    return losses, step_ms, rate, peak_gb


def phase_train(state):
    _fit_steps(state, "train", TRAIN, TRAIN_B, TRAIN_T, warm=2, steps=8)


def phase_longctx(state):
    _fit_steps(state, "longctx", LONGCTX, LONGCTX_B, LONGCTX_T, warm=1,
               steps=3)


def _check_step_launches(path: str, steps: int, launches, card,
                         unit: str = "steps") -> None:
    """Every ported kernel was launched exactly its registry count per
    step on the stepped ``path`` over ``steps`` steps (or requests, as
    ``unit`` says): 0 for a kernel the registry does not list for that
    path."""
    from deeplearning4j_tpu_torch.ops import kernel_registry
    per_step = {e.key: e.per_step.get(path, 0)
                for e in kernel_registry.ported()}
    log(f"{path}: launches over {steps} {unit} {launches} (per "
        f"{unit[:-1]} expected {per_step}) {card}")
    for key, n in per_step.items():
        want = steps * n
        assert launches[key] == want, \
            f"{key}: {launches[key]} launches in {steps} {unit} of " \
            f"{path}, expected {want}"


# -- phases 8, 12 -----------------------------------------------------------
def _lm_agree(state, name: str, model_kw) -> None:
    """One f32 training step (TF32 off) of ``CausalTransformerLM(
    **model_kw)`` at B = 2, T = 256: the card's loss and every gradient
    against the port on the CPU."""
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = CausalTransformerLM(**model_kw)      # float32
    x, y = _train_batch(1, 2, 256, model.vocab_size)
    results = {}
    for dev in ("cuda", "cpu"):
        net = model.init(256, device=dev)
        loss, grads, _ = net._loss_and_grads(
            torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
        results[dev] = (loss.item(), tree.map_(lambda g: g.cpu(), grads))
        del net, grads
    (l_card, g_card), (l_cpu, g_cpu) = results["cuda"], results["cpu"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    rels = tree.map_with_path(
        lambda path, a, b: (_rel_err(a, b), ".".join(path)), g_card, g_cpu)
    worst, worst_key = max(tree.leaves(rels))
    log(f"{name}: f32 B=2 T=256 one step, card vs CPU: loss "
        f"{l_card:.6f} vs {l_cpu:.6f} rel={loss_rel:.3e} "
        f"tol={TRAIN_LOSS_RTOL:.0e}; worst gradient {worst_key} "
        f"max|d|/max|g|={worst:.3e} tol={TRAIN_GRAD_TOL:.0e} "
        f"{state['card']}")
    if not (loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_TOL):
        raise AssertionError(f"card and CPU training step disagree "
                             f"({name})")


def phase_train_agree(state):
    _lm_agree(state, "train_agree", TRAIN)


@contextlib.contextmanager
def _fused_budget(nbytes: int):
    """Set the port's fused-backward budget (``cuda_kernels.
    _FUSED_BWD_DQ_VMEM``, the JAX package's test) inside the block: 0
    sends every attention backward to the split pair K4 + K5, a huge
    one to the fused K3."""
    from deeplearning4j_tpu_torch.ops import cuda_kernels
    prev = cuda_kernels._FUSED_BWD_DQ_VMEM
    cuda_kernels._FUSED_BWD_DQ_VMEM = nbytes
    try:
        yield
    finally:
        cuda_kernels._FUSED_BWD_DQ_VMEM = prev


def phase_longctx_agree(state):
    """The long-context model's step at B = 2, T = 256 with the budget at
    0, so that the card's backward runs K4 + K5, against the CPU."""
    from deeplearning4j_tpu_torch.ops import kernel_registry
    for e in kernel_registry.ported():
        e.reset()
    with _fused_budget(0):
        _lm_agree(state, "longctx_agree", LONGCTX)
    launches = {e.key: e.launches() for e in kernel_registry.ported()}
    log(f"longctx_agree: card launches {launches} {state['card']}")
    assert launches["K4"] > 0 and launches["K5"] > 0, launches
    assert launches["K3"] == 0, launches


# -- phases 13-15: data-parallel --------------------------------------------
def _dp_mesh(state):
    """The default process group (``initialize_distributed``: this
    process alone, ``"cpu:gloo,cuda:nccl"``, so CUDA tensors go over
    NCCL and CPU tensors over gloo) and its one-axis data mesh, made
    once per run."""
    if "mesh" not in state:
        import torch.distributed as dist
        from deeplearning4j_tpu_torch.parallel import (data_parallel_mesh,
                                                       initialize_distributed)
        initialize_distributed()
        state["mesh"] = data_parallel_mesh()
        log(f"dp: process group {dist.get_backend()!r} world "
            f"{dist.get_world_size()} {state['card']}")
    return state["mesh"]


def phase_dp(state):
    """The train LM through ``SharedTrainingMaster(...).make_wrapper(net,
    data_parallel_mesh())`` → ``ParallelWrapper.fit`` (ENCODED: the dense
    exchange of the decoded update, the codec kernels not launched)."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.parallel import SharedTrainingMaster
    mesh = _dp_mesh(state)
    wrappers = []

    def make_step(net, x, y):
        w = SharedTrainingMaster().make_wrapper(net, mesh)
        wrappers.append(w)
        batch = [DataSet(x, y)]
        return lambda: w.fit(batch)

    _fit_steps(state, "dp", TRAIN, TRAIN_B, TRAIN_T, warm=2, steps=8,
               make_step=make_step)
    (w,) = wrappers
    log(f"dp: mode={w.mode} world={w.n} tau after 10 steps="
        f"{w._acc_state['tau'].item():.6e} {state['card']}")


def _packed_step(mesh, net, x, y):
    """One data-parallel step with the packed exchange over the mesh's
    data group, as ``tests/test_pallas.py``'s shard_map step uses it:
    ``loss_and_grads`` of this rank's rows → ``acc.exchange_packed`` (K10
    once a leaf, the packed words all-gathered, K11 once a leaf and
    rank) → ``apply_updates``; the loss's mean over the group in
    ``net.score()``. Returns (the step, a function that gives
    ``(grads, acc state, group)`` for timing the exchange alone)."""
    from deeplearning4j_tpu_torch.nn.layers.base import fold_in
    from deeplearning4j_tpu_torch.nn.multilayer import (apply_updates,
                                                        loss_and_grads)
    from deeplearning4j_tpu_torch.parallel import EncodedGradientsAccumulator
    from deeplearning4j_tpu_torch.parallel.mesh import mean_over
    group, n, r = mesh.group("data"), mesh.size("data"), mesh.index("data")
    b = x.shape[0] // n
    xs, ys = net._as_input(x[r * b:(r + 1) * b]), net._as_input(
        y[r * b:(r + 1) * b])
    acc = EncodedGradientsAccumulator()
    carry = {"acc": acc.init_state(net.params)}

    def grads():
        rng = fold_in(net.conf.seed, net.iteration)
        return loss_and_grads(
            lambda p: net._loss_fn(p, net.state, xs, ys, None, None, rng),
            net.params)

    def step():
        loss, g, net.state = grads()
        dec, carry["acc"] = acc.exchange_packed(g, carry["acc"], group)
        net.params, net.opt_state = apply_updates(
            net._chains, net.params, dec, net.opt_state)
        net.score_ = mean_over(loss, group).item()     # device sync
        net.iteration += 1

    return step, lambda: (grads()[1], carry["acc"], group, acc)


def phase_dp_packed(state):
    """The train LM's step with ``EncodedGradientsAccumulator.
    exchange_packed`` over the data group: K10 once a parameter leaf, K11
    once a leaf and rank, beside the train step's kernels."""
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.ops import kernel_registry
    mesh = _dp_mesh(state)
    net = _fit_steps(state, "dp_packed", TRAIN, TRAIN_B, TRAIN_T, warm=2,
                     steps=8, make_step=lambda net, x, y: _packed_step(
                         mesh, net, x, y)[0])
    leaves = len(list(tree.leaves(net.params)))
    rows = {e.key: e.per_step["dp_packed"]
            for e in kernel_registry.on_path("dp_packed")}
    log(f"dp_packed: {leaves} parameter leaves, world {mesh.size()}: "
        f"K10 {rows['K10']} and K11 {rows['K11']} a step expected "
        f"{state['card']}")
    assert rows["K10"] == leaves and rows["K11"] == leaves * mesh.size()


def phase_dp_agree(state):
    """One f32 step (TF32 off) of ENCODED (the wrapper's exchanged
    gradient) and of the packed exchange, card against CPU in the same
    mixed-backend group (CPU tensors over gloo) at B = 2, T = 256, from
    the same weights: the loss, the decoded updates and the residuals."""
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.nn.layers.base import fold_in
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.parallel import SharedTrainingMaster
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = _dp_mesh(state)
    model = CausalTransformerLM(**TRAIN)          # float32
    x, y = _train_batch(1, 2, 256, model.vocab_size)
    cpu = lambda t: tree.map_(lambda a: a.detach().cpu(), t)
    results = {}
    for e in kernel_registry.ported():
        e.reset()
    for dev in ("cuda", "cpu"):
        net = model.init(256, device=dev)
        w = SharedTrainingMaster().make_wrapper(net, mesh)
        w._place()
        loss, dec, _ = w._exchanged_grads(net._as_input(x), net._as_input(y),
                                          fold_in(net.conf.seed, 0))
        enc = (loss.item(), cpu(dec), cpu(w._acc_state["residual"]))
        step, parts = _packed_step(mesh, net, x, y)
        g, acc_state, group, acc = parts()
        pdec, pst = acc.exchange_packed(g, acc_state, group)
        packed = (enc[0], cpu(pdec), cpu(pst["residual"]))
        results[dev] = {"encoded": enc, "packed": packed,
                        "gmax": [a.abs().max().item()
                                 for a in tree.leaves(g)]}
        del net, w, dec, g, pdec, pst
    launches = {e.key: e.launches() for e in kernel_registry.ported()}
    for method in ("encoded", "packed"):
        (l_card, d_card, r_card), (l_cpu, d_cpu, r_cpu) = (
            results["cuda"][method], results["cpu"][method])
        loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
        d1 = torch.cat([a.reshape(-1) for a in tree.leaves(d_card)])
        d2 = torch.cat([a.reshape(-1) for a in tree.leaves(d_cpu)])
        same = d1 == d2
        flipped = 1 - same.float().mean().item()
        # a residual is g + r − q clipped: where the codes agree its error
        # is the gradient's, held like train_agree's gradients against
        # the leaf's largest gradient
        worst, worst_key = 0.0, ""
        keys = tree.leaves(tree.map_with_path(lambda p, _: ".".join(p),
                                              r_card))
        for key, a, b, da, db, gmax in zip(
                keys,
                tree.leaves(r_card), tree.leaves(r_cpu),
                tree.leaves(d_card), tree.leaves(d_cpu),
                results["cpu"]["gmax"]):
            keep = da == db
            rel = ((a - b).abs()[keep].max().item() / max(gmax, 1e-30)
                   if keep.any() else 0.0)
            if rel > worst:
                worst, worst_key = rel, key
        log(f"dp_agree {method}: f32 B=2 T=256 one step, card vs CPU: loss "
            f"{l_card:.6f} vs {l_cpu:.6f} rel={loss_rel:.3e} "
            f"tol={TRAIN_LOSS_RTOL:.0e}; decoded updates differ in "
            f"{flipped:.3e} of {d1.numel()} elements tol={DP_FLIP_TOL:.0e};"
            f" worst residual {worst_key} max|d|/max|g|={worst:.3e} "
            f"tol={TRAIN_GRAD_TOL:.0e} {state['card']}")
        if not (loss_rel <= TRAIN_LOSS_RTOL and flipped <= DP_FLIP_TOL
                and worst <= TRAIN_GRAD_TOL):
            raise AssertionError(f"card and CPU {method} step disagree")
    log(f"dp_agree: card launches {launches} {state['card']}")
    assert launches["K10"] > 0 and launches["K11"] > 0, launches


# -- phases 18-20: the ZeRO sharded update, the graph under the wrapper ----
def _opt_bytes_line(phase: str, w, card) -> None:
    """The ``OPT_STATE_BYTES`` gauge's reading, this rank's optimizer
    bytes and the whole moments' bytes, now in host memory."""
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.obs.metrics import OPT_STATE_BYTES
    from deeplearning4j_tpu_torch.parallel import per_device_bytes
    gauge = OPT_STATE_BYTES.snapshot()
    mine = per_device_bytes(w._dp_state)
    whole = per_device_bytes(w._evicted_opt)
    devices = sorted({str(t.device) for t in tree.leaves(w._evicted_opt)})
    log(f"{phase}: OPT_STATE_BYTES {gauge} rank optimizer bytes={mine} "
        f"({mine / 2 ** 30:.3f} GiB) whole optimizer state={whole} bytes "
        f"on {devices} world={w.n} {card}")
    assert gauge['{layout="sharded"}'] == mine and devices == ["cpu"]


def _free_card(phase: str, card) -> None:
    """Collect what earlier phases left (reference cycles hold nets) and
    print the card memory still allocated, the floor under the phase's
    peak."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    gb = torch.cuda.memory_allocated() / 2 ** 30
    log(f"{phase}: memory_allocated_gb before={gb:.3f} {card}")


def phase_zero(state):
    """The train LM through ``ParallelWrapper(net, mesh=
    data_parallel_mesh(), sharded_update=True)`` on the one-rank
    ``"cpu:gloo,cuda:nccl"`` group, then with ``gather_overlap=True``:
    each 2 warm and 8 timed steps of the train batch, the train kernels'
    launches exactly a step; the layout holds one flat leaf a parameter
    leaf (the tied embedding once: ``LM_LEAVES``)."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    mesh = _dp_mesh(state)
    _free_card("zero", state["card"])
    for overlap in (False, True):
        wrappers = []

        def make_step(net, x, y):
            w = ParallelWrapper(net, mesh=mesh, sharded_update=True,
                                gather_overlap=overlap)
            wrappers.append(w)
            batch = [DataSet(x, y)]
            return lambda: w.fit(batch)

        log(f"zero: gather_overlap={overlap}")
        _fit_steps(state, "zero", TRAIN, TRAIN_B, TRAIN_T, warm=2, steps=8,
                   make_step=make_step)
        (w,) = wrappers
        leaves = len(w._layout().sizes)
        log(f"zero: {leaves} flat leaves (LM_LEAVES "
            f"{kernel_registry.LM_LEAVES}), {sum(w._layout().padded)} "
            f"padded elements {state['card']}")
        assert leaves == kernel_registry.LM_LEAVES
        _opt_bytes_line("zero", w, state["card"])
        del w, wrappers
        _free_card("zero", state["card"])


def phase_zero_agree(state):
    """One f32 step (TF32 off) at B = 2, T = 256 of the train model, from
    the same weights: (1) on the card, replicated SYNC, the sharded update
    and the overlap each take two steps from ONE gradient (K3's dq
    atomics change the last bits of a gradient from run to run; every
    op after it is elementwise and IEEE-rounded), and must end with the
    same params (and ``gather_opt_state`` the replicated moments) bit for
    bit at one rank; (2) the sharded step through ``fit`` on the card
    and on the CPU (the CPU tensors over gloo): the loss and the
    reduce-scattered gradient it applies, in train_agree's bands."""
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn.layers.base import fold_in
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = state["card"]
    mesh = _dp_mesh(state)
    model = CausalTransformerLM(**TRAIN)          # float32
    x, y = _train_batch(1, 2, 256, model.vocab_size)
    batch = [DataSet(x, y)]
    # (1) one gradient, three update paths
    ref = ParallelWrapper(model.init(256), mesh=mesh)
    fixed = ref._local_grads(ref.net.params, ref.net.state,
                             ref.net._as_input(x), ref.net._as_input(y),
                             fold_in(ref.net.conf.seed, 0))
    nets = {}
    for name, kw in (("replicated", {}), ("sharded",
                                          {"sharded_update": True}),
                     ("overlap", {"sharded_update": True,
                                  "gather_overlap": True})):
        w = ParallelWrapper(model.init(256), mesh=mesh, **kw)
        w._local_grads = lambda p, st, xs, ys, rng, w=w: (
            fixed[0], tree.map_(torch.clone, fixed[1]), w.net.state)
        w.fit(batch, epochs=2)
        nets[name] = w
    del ref, fixed
    same = lambda a, b: all(torch.equal(p, q) for p, q in
                            zip(tree.leaves(a), tree.leaves(b)))
    rep, sh, ov = (nets[k] for k in ("replicated", "sharded", "overlap"))
    checks = {
        "sharded params == replicated": same(sh.net.params,
                                             rep.net.params),
        "overlap params == sharded": same(ov.net.params, sh.net.params),
        "sharded gather_opt_state == replicated opt_state": same(
            sh.gather_opt_state(), rep.net.opt_state),
        "overlap gather_opt_state == sharded": same(
            ov.gather_opt_state(), sh.gather_opt_state()),
    }
    log(f"zero_agree: f32 B=2 T=256 two steps from one gradient, card, "
        f"bit for bit: {checks} {card}")
    del nets, rep, sh, ov
    _free_card("zero_agree", card)
    # (2) the sharded step, card against CPU
    results = {}
    for e in kernel_registry.ported():
        e.reset()
    for dev in ("cuda", "cpu"):
        net = model.init(256, device=dev)
        w = ParallelWrapper(net, mesh=mesh, sharded_update=True)
        layout, seen = w._layout(), []
        scatter = layout.scatter_mean

        def record(tree_, group=None, scatter=scatter, seen=seen):
            out = scatter(tree_, group)
            seen.append(out)
            return out

        layout.scatter_mean = record
        w.fit(batch)
        grads = tree.map_(lambda t: t.cpu(), layout.unflatten(seen[0]))
        results[dev] = (net.score(), grads)
        del net, w, layout, seen, grads
    launches = {e.key: e.launches() for e in kernel_registry.ported()}
    (l_card, g_card), (l_cpu, g_cpu) = results["cuda"], results["cpu"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    rels = tree.map_with_path(
        lambda path, a, b: (_rel_err(a, b), ".".join(path)), g_card, g_cpu)
    worst, worst_key = max(tree.leaves(rels))
    log(f"zero_agree: f32 B=2 T=256 one sharded step, card vs CPU: loss "
        f"{l_card:.6f} vs {l_cpu:.6f} rel={loss_rel:.3e} "
        f"tol={TRAIN_LOSS_RTOL:.0e}; worst reduce-scattered gradient "
        f"{worst_key} max|d|/max|g|={worst:.3e} tol={TRAIN_GRAD_TOL:.0e} "
        f"{card}")
    log(f"zero_agree: card launches {launches} {card}")
    if not all(checks.values()):
        raise AssertionError(f"zero_agree: not bit for bit: {checks}")
    if not (loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_TOL):
        raise AssertionError("card and CPU sharded step disagree")
    assert launches["K1"] > 0 and launches["K3"] > 0, launches


def phase_dp_graph(state):
    """BERT-base's classifier (the finetune phase's model, bfloat16
    compute, dropout 0.1) through ``ParallelWrapper(graph, mesh=
    data_parallel_mesh(), sharded_update=True)`` on the one-rank group:
    the finetune batch's tokens, segments and labels as full-length rows
    (no masks: the wrapper's graph adapter passes none, as the JAX one),
    2 warm and 8 timed steps; every loss finite and the mean of the last
    two below that of the first two, each kernel launched exactly its
    registry count per step (K1 and K3 unmasked), then one ``output``
    whose rows each sum to 1."""
    import math
    import torch
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.zoo.bert import BertBase
    card = state["card"]
    mesh = _dp_mesh(state)
    _free_card("dp_graph", card)
    t0 = time.perf_counter()
    net = BertBase(seed=2, compute_dtype="bfloat16").init_classifier(
        2, BERT_T)
    tokens, segments, _, labels = _finetune_batch(0, BERT_B, BERT_T)
    w = ParallelWrapper(net, mesh=mesh, sharded_update=True)
    batch = [([tokens, segments], [labels])]
    log(f"dp_graph: init {net.num_params()} params on {net.device} "
        f"{time.perf_counter() - t0:.1f}s")

    def step():
        w.fit(batch)
        return net.score()                   # fit ends in a device sync

    torch.cuda.reset_peak_memory_stats()
    losses = [step() for _ in range(2)]      # warm steps
    for e in kernel_registry.ported():
        e.reset()
    torch.cuda.synchronize()
    steps = 8
    t_start = time.perf_counter()
    losses += [step() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {e.key: e.launches() for e in kernel_registry.ported()}
    state.setdefault("launches", {})["dp_graph"] = launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"dp_graph: losses {' '.join(f'{l:.4f}' for l in losses)} {card}")
    log(f"dp_graph: B={BERT_B} T={BERT_T} steps={steps} mean_step_ms="
        f"{wall / steps * 1e3:.3f} samples_per_s="
        f"{BERT_B * steps / wall:.1f} max_memory_allocated_gb="
        f"{peak_gb:.3f} {card}")
    _opt_bytes_line("dp_graph", w, card)
    assert all(math.isfinite(l) for l in losses), losses
    first, last = sum(losses[:2]) / 2, sum(losses[-2:]) / 2
    assert last < first, (first, last, losses)
    _check_step_launches("dp_graph", steps, launches, card)
    probs = net.output(tokens, segments)[0]
    _check_prob_rows("dp_graph", probs, (BERT_B, 2),
                     PROB_SUM_TOL["bfloat16"], card)


# -- phases 9, 10 ----------------------------------------------------------
# -- phases 16-17: sequence-parallel ----------------------------------------
def _seq_mesh(state):
    """The default process group (as ``_dp_mesh`` makes it: this process
    alone) and its one-axis ``{"seq": 1}`` mesh, made once per run."""
    if "seq_mesh" not in state:
        from deeplearning4j_tpu_torch.parallel import (initialize_distributed,
                                                       make_mesh)
        initialize_distributed()
        state["seq_mesh"] = make_mesh({"seq": 1})
    return state["seq_mesh"]


def phase_sp(state):
    """The long-context LM with ``sequence_parallel="zigzag_ring"`` under
    ``distributed_context(make_mesh({"seq": 1}))``: each layer's
    attention is four half-chunk block pairs through the ring's block
    entries (K1 forward, K3 backward), at their global offsets."""
    from deeplearning4j_tpu_torch.parallel import distributed_context
    with distributed_context(_seq_mesh(state)):
        _fit_steps(state, "sp", SP, LONGCTX_B, LONGCTX_T, warm=1, steps=3)


def _sp_loss_grads(model_kw, dev, x, y, ctx):
    """One f32 step's loss and gradients (on the host) of
    ``CausalTransformerLM(**model_kw)`` on ``dev``, under ``ctx`` (a
    ``distributed_context``, or None)."""
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    net = CausalTransformerLM(**model_kw).init(x.shape[1], device=dev)
    with ctx if ctx is not None else contextlib.nullcontext():
        loss, grads, _ = net._loss_and_grads(
            torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
    return loss.item(), tree.map_(lambda g: g.cpu(), grads)


def _compare_steps(a, b):
    """(relative loss difference, worst gradient's max |d| / max |g|, its
    name) of two ``_sp_loss_grads`` results, ``b`` the reference."""
    from deeplearning4j_tpu_torch import tree
    (la, ga), (lb, gb) = a, b
    rels = tree.map_with_path(
        lambda path, x, y: (_rel_err(x, y), ".".join(path)), ga, gb)
    worst, key = max(tree.leaves(rels))
    return abs(la - lb) / abs(lb), worst, key


def phase_sp_agree(state):
    """One f32 step (TF32 off) of the train model at B = 2, T = 256 under
    the seq-1 context in each mode: against the same step without the
    context on the card (bands: the train_agree ones, ``TRAIN_LOSS_RTOL``
    and ``TRAIN_GRAD_TOL``; the ring's block pairs at one rank sum the
    same scores as the local kernel in another grouping, and K3's dq
    atomics vary in their last bits) and against the same step under the
    context on the CPU (the same bands, as train_agree)."""
    import torch
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.parallel import distributed_context
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = distributed_context(_seq_mesh(state))
    x, y = _train_batch(1, 2, 256, TRAIN["vocab_size"])
    local = _sp_loss_grads(TRAIN, "cuda", x, y, None)
    for mode in SP_MODES:
        kw = dict(TRAIN, sequence_parallel=mode)
        for e in kernel_registry.ported():
            e.reset()
        card = _sp_loss_grads(kw, "cuda", x, y, ctx)
        launches = {e.key: e.launches() for e in kernel_registry.ported()}
        cpu = _sp_loss_grads(kw, "cpu", x, y, ctx)
        ok = True
        for name, ref in (("card without the context", local),
                          ("CPU under the context", cpu)):
            loss_rel, worst, key = _compare_steps(card, ref)
            log(f"sp_agree {mode}: f32 B=2 T=256 one step, card under the "
                f"seq-1 context vs {name}: loss {card[0]:.6f} vs "
                f"{ref[0]:.6f} rel={loss_rel:.3e} tol={TRAIN_LOSS_RTOL:.0e};"
                f" worst gradient {key} max|d|/max|g|={worst:.3e} "
                f"tol={TRAIN_GRAD_TOL:.0e} {state['card']}")
            ok = ok and loss_rel <= TRAIN_LOSS_RTOL \
                and worst <= TRAIN_GRAD_TOL
        log(f"sp_agree {mode}: card launches {launches} {state['card']}")
        if not ok:
            raise AssertionError(f"sp_agree {mode}: the step disagrees")
        # the attention went through the kernels: K1 forward, K3 backward
        assert launches["K1"] > 0 and launches["K3"] > 0, launches


def _sp_bert_conf(mode, **kw):
    """``BertBase(**kw).conf_classifier(2, SP_GRAPH_T)`` with every
    encoder block's ``sequence_parallel`` set to ``mode`` (a field of the
    block, as in the JAX package: ``zoo/bert.py`` takes no option)."""
    from deeplearning4j_tpu_torch.nn.layers import TransformerEncoderBlock
    from deeplearning4j_tpu_torch.zoo.bert import BertBase
    conf = BertBase(**kw).conf_classifier(2, SP_GRAPH_T)
    for node in conf.nodes:
        if isinstance(node.obj, TransformerEncoderBlock):
            node.obj.sequence_parallel = mode
    return conf


def phase_sp_graph(state):
    """BERT-base's classifier sequence-parallel ("ring") under the seq-1
    context at B = 16, T = 512, bfloat16: 2 warm and 8 timed ``fit``
    steps with the launch counts, then the context's cost from pairs of
    one step with it and one without, then ``output``."""
    import math
    import statistics
    import torch
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.parallel import distributed_context
    card = state["card"]
    ctx = distributed_context(_seq_mesh(state))
    t0 = time.perf_counter()
    net = ComputationGraph(_sp_bert_conf(
        "ring", seed=2, compute_dtype="bfloat16")).init(
            {"tokens": (SP_GRAPH_T,), "segments": (SP_GRAPH_T,)})
    tokens, segments, mask, labels = _finetune_batch(4, SP_GRAPH_B,
                                                     SP_GRAPH_T)
    log(f"sp_graph: init {net.num_params()} params on {net.device} "
        f"{time.perf_counter() - t0:.1f}s; row lengths "
        f"{sorted(int(n) for n in mask.sum(1))}")

    def step():
        net.fit([tokens, segments], [labels], features_masks=[mask, mask])
        return net.score()                   # fit ends in a device sync

    torch.cuda.reset_peak_memory_stats()
    with ctx:
        losses = [step() for _ in range(2)]  # warm steps
        for e in kernel_registry.ported():
            e.reset()
        torch.cuda.synchronize()
        steps = 8
        t_start = time.perf_counter()
        losses += [step() for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = {e.key: e.launches() for e in kernel_registry.ported()}
    state.setdefault("launches", {})["sp_graph"] = launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"sp_graph: losses {' '.join(f'{l:.4f}' for l in losses)} {card}")
    log(f"sp_graph: B={SP_GRAPH_B} T={SP_GRAPH_T} steps={steps} "
        f"mean_step_ms={wall / steps * 1e3:.3f} samples_per_s="
        f"{SP_GRAPH_B * steps / wall:.1f} max_memory_allocated_gb="
        f"{peak_gb:.3f} {card}")
    assert all(math.isfinite(l) for l in losses), losses
    first, last = sum(losses[:2]) / 2, sum(losses[-2:]) / 2
    assert last < first, (first, last, losses)
    _check_step_launches("sp_graph", steps, launches, card)

    def timed(inside):
        with ctx if inside else contextlib.nullcontext():
            torch.cuda.synchronize()
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()         # the update after the loss
            return (time.perf_counter() - t) * 1e3
    # pairs of single steps: with, without; without, with; ...
    walls = {True: [], False: []}
    for i in range(SP_GRAPH_PAIRS):
        for inside in ((True, False) if i % 2 == 0 else (False, True)):
            walls[inside].append(timed(inside))
    diffs = [a - b for a, b in zip(walls[True], walls[False])]
    cost = statistics.fmean(diffs)
    err = 2 * statistics.stdev(diffs) / math.sqrt(len(diffs))
    without_ms = statistics.median(walls[False])
    log(f"sp_graph: {SP_GRAPH_PAIRS} pairs of one step under the seq-1 "
        f"context and one without it: medians "
        f"{statistics.median(walls[True]):.3f} and {without_ms:.3f} ms "
        f"(single steps {min(min(w) for w in walls.values()):.3f}.."
        f"{max(max(w) for w in walls.values()):.3f}); the context's cost "
        f"a step {cost:.3f} +- {err:.3f} ms (2 standard errors of the "
        f"pairs' mean), {cost / without_ms * 100:.2f} +- "
        f"{err / without_ms * 100:.2f} % of the step: "
        f"{'resolved' if abs(cost) > err else 'not resolved'} {card}")
    with ctx:
        probs = net.output(tokens, segments, features_masks=[mask, mask])[0]
    _check_prob_rows("sp_graph", probs, (SP_GRAPH_B, 2),
                     PROB_SUM_TOL["bfloat16"], card)


def _graph_like(conf, donor):
    """A ``ComputationGraph`` of ``conf`` holding ``donor``'s parameters
    and state on its device (the same tensors; a fresh optimizer)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    net = ComputationGraph(conf)
    net.params, net.state, net.device = (donor.params, donor.state,
                                         donor.device)
    net._build_optimizer()
    return net


def _host_step(net, args, ctx=None):
    """(loss, gradients on the host) of one ``_loss_and_grads(*args)`` of
    ``net``, under ``ctx`` when given."""
    from deeplearning4j_tpu_torch import tree
    with ctx if ctx is not None else contextlib.nullcontext():
        loss, grads, _ = net._loss_and_grads(*args)
    return loss.item(), tree.map_(lambda g: g.cpu(), grads)


def _sp_agree_check(name, steps, launches, card):
    """``steps``: the card's step under the context, then the references
    by name; raises unless each is within train_agree's bands and K1 and
    K3 were launched under the context."""
    got, ok = steps[0], True
    for ref_name, ref in steps[1:]:
        loss_rel, worst, key = _compare_steps(got, ref)
        log(f"sp_graph_agree {name}: card under the seq-1 context vs "
            f"{ref_name}: loss {got[0]:.6f} vs {ref[0]:.6f} "
            f"rel={loss_rel:.3e} tol={TRAIN_LOSS_RTOL:.0e}; worst gradient "
            f"{key} max|d|/max|g|={worst:.3e} tol={TRAIN_GRAD_TOL:.0e} "
            f"{card}")
        ok = ok and loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_TOL
    log(f"sp_graph_agree {name}: card launches {launches} {card}")
    if not ok:
        raise AssertionError(f"sp_graph_agree {name}: the step disagrees")
    assert launches["K1"] > 0 and launches["K3"] > 0, launches


def _pooled_nets(mode):
    """The pooled ``MultiLayerNetwork`` configurations of sp_graph_agree:
    a causal encoder block in ``mode``, then masked average pooling; the
    learned queries and a dense layer on their [B, Q, F]; an output
    layer flattening [B, T, F]."""
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)

    def net(*tail):
        b = (NeuralNetConfiguration.builder().seed(7).list()
             .layer(L.TransformerEncoderBlock(n_heads=SP_POOL_HEADS,
                                              causal=True,
                                              sequence_parallel=mode)))
        for layer in tail:
            b.layer(layer)
        b.layer(L.OutputLayer(n_out=2, activation="softmax",
                              loss="mcxent"))
        return b.set_input_type(InputType.recurrent(SP_POOL_F,
                                                    SP_POOL_T)).build()
    return {"avg_pool": net(L.GlobalPoolingLayer(pooling_type="avg")),
            "learned_dense": net(
                L.LearnedSelfAttentionLayer(n_out=SP_POOL_F,
                                            n_heads=SP_POOL_HEADS,
                                            n_queries=SP_POOL_Q),
                L.DenseLayer(n_out=32, activation="tanh")),
            "flatten_output": net()}


def phase_sp_graph_agree(state):
    """In f32 (TF32 off): one step of BERT-base's classifier at B = 2,
    T = 512 in "ring" and "ulysses", and of the pooled nets in
    "zigzag_ring": the card under the seq-1 context against the card
    without it and the CPU under it."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.parallel import distributed_context
    card = state["card"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = distributed_context(_seq_mesh(state))

    def counted(fn):
        for e in kernel_registry.ported():
            e.reset()
        out = fn()
        return out, {e.key: e.launches() for e in kernel_registry.ported()}

    tokens, segments, mask, labels = _finetune_batch(5, SP_AGREE_B,
                                                     SP_GRAPH_T)
    args = ([tokens, segments], [labels], [mask, mask])
    shapes = {"tokens": (SP_GRAPH_T,), "segments": (SP_GRAPH_T,)}
    donors = {dev: ComputationGraph(_sp_bert_conf(
        None, seed=3, dropout=0.0)).init(shapes, device=dev)
        for dev in ("cuda", "cpu")}
    local = _host_step(donors["cuda"], args)
    for mode in ("ring", "ulysses"):
        conf = lambda: _sp_bert_conf(mode, seed=3, dropout=0.0)
        got, launches = counted(lambda: _host_step(
            _graph_like(conf(), donors["cuda"]), args, ctx))
        cpu = _host_step(_graph_like(conf(), donors["cpu"]), args, ctx)
        _sp_agree_check(f"bert {mode}", [got, ("card without the context",
                                               local),
                                         ("CPU under the context", cpu)],
                        launches, card)
    del donors
    rng = np.random.default_rng(6)
    x = rng.standard_normal((SP_AGREE_B, SP_POOL_T, SP_POOL_F)).astype(
        np.float32)
    y = np.eye(2, dtype=np.float32)[[0, 1]]
    fmask = (np.arange(SP_POOL_T)[None, :]
             < np.array([[SP_POOL_T], [37]])).astype(np.float32)
    for name, conf in _pooled_nets("zigzag_ring").items():
        steps = {}
        for dev in ("cuda", "cpu"):
            net = MultiLayerNetwork(conf).init(device=dev)
            fm = fmask if name == "avg_pool" else None
            a = (net._as_input(x), net._as_input(y),
                 None if fm is None else net._as_input(fm, torch.float32))
            steps[dev] = counted(lambda: _host_step(net, a, ctx))
            if dev == "cuda":
                steps["local"] = _host_step(net, a)
        (got, launches), (cpu, _) = steps["cuda"], steps["cpu"]
        _sp_agree_check(name, [got, ("card without the context",
                                     steps["local"]),
                               ("CPU under the context", cpu)], launches,
                        card)


def _check_flash_blocks(rows, card):
    """The ring's block entries against their plain versions on the card:
    ``flash_block_fwd`` (K1) — out within ``FLASH_TOL``, the finite lse
    within ``LSE_TOL`` and its −inf rows the same — and
    ``flash_block_bwd`` (K3 at these rows) and K4, K5 through
    ``offsets`` — dq, dk, dv within ``K3_TOL`` of the largest plain
    value — from a global out and lse: the rank's diagonal block merged
    with the pair's (``_merge_blocks``, on the card).
    Cases: every (rank, source) pair of a ``SP_RING``-rank causal ring
    at T_loc = ``SP_T_LOC``, H = 6, D = 128, and the four half-chunk
    pairs of rank 0 of a ``SP_ZIGZAG``-rank zigzag ring (strided halves
    of the rank's tensors, the lse halves made contiguous); bf16 and
    f32; no mask and a ragged key mask; GQA (Hkv = 2) at one pair. Then
    the ``sp`` step's own four half-pairs: the one-rank zigzag ring at
    T = ``LONGCTX_T`` (halves of 16 384 rows, K3 fused), bf16, no mask,
    their K3 held against the blockwise plain dq and dk/dv passes (the
    fused plain version would hold [6, Tq, Tk] f32 matrices). A block
    wholly above the diagonal must give out and gradients exactly 0 and
    lse −inf."""
    import torch
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        _merge_blocks, zigzag_order)
    both = ("bfloat16", "float32")
    # (kind, query block, key block, Hkv, masked, T_loc, zigzag ring size,
    # dtypes)
    cases = [("ring", m, src, 6, masked, SP_T_LOC, None, both)
             for m in range(SP_RING) for src in range(SP_RING)
             for masked in (False, True)]
    cases.append(("ring", 2, 1, 2, False, SP_T_LOC, None, both))  # GQA
    cases += [("zigzag", qi, ki, 6, masked, SP_T_LOC, SP_ZIGZAG, both)
              for qi in (0, 1) for ki in (0, 1) for masked in (False, True)]
    cases += [("zigzag", qi, ki, 6, False, LONGCTX_T, 1, ("bfloat16",))
              for qi in (0, 1) for ki in (0, 1)]              # the sp step
    errs = {k: 0.0 for k in ("K1", "K3", "K4", "K5")}
    dead = n_cases = 0
    for dname in both:
        dt = getattr(torch, dname)
        for i, (kind, a, b, h_kv, masked, t, n_zz, dnames) in \
                enumerate(cases):
            if dname not in dnames:
                continue
            n_cases += 1
            c = t // 2
            g = torch.Generator(device="cuda").manual_seed(900 + i)
            mk = lambda hh: torch.randn((1, t, hh, 128), generator=g,
                                        device="cuda").to(dt)
            q, k, v, do = mk(6), mk(h_kv), mk(h_kv), mk(6)
            mask = None
            if masked:
                mask = (torch.rand((1, t), generator=g, device="cuda")
                        > 0.3).float()
            if kind == "ring":
                offs, diag = (a * t, b * t), (a * t, a * t)
            else:              # half-chunk views of the rank's tensors
                zz = zigzag_order(n_zz)[:2]             # rank 0's chunks
                sl = lambda x, j: x[:, j * c:(j + 1) * c]
                q, do = sl(q, a), sl(do, a)
                k, v = sl(k, b), sl(v, b)
                mask = None if mask is None else sl(mask, b)
                offs, diag = (zz[a] * c, zz[b] * c), (zz[a] * c, zz[a] * c)
            o_k, l_k = ck.flash_block_fwd(q, k, v, mask, offs, True)
            # the "global" out and lse the backward takes: the rank's
            # diagonal block (every row live) merged with this one, so
            # that no probability of this block exceeds 1
            out, lse = ck.flash_block_fwd(q, k, v, None, diag, True)
            if offs != diag:
                out, lse = _merge_blocks(out.float(), lse, o_k, l_k)
                out = out.to(dt)
            o_p, l_p = ck.flash_attention_reference(
                q, k, v, True, mask, return_lse=True, offsets=offs)
            k3_before = ck.flash_attention_bwd.launches
            grads_k = ck.flash_block_bwd(q, k, v, out, lse, do, mask, offs,
                                         True)
            fused = ck.flash_attention_bwd.launches == k3_before + 1
            kw = dict(causal=True, mask=mask, offsets=offs)
            split_k = (ck.flash_attention_bwd_dq(q, k, v, out, lse, do, **kw),
                       *ck.flash_attention_bwd_dkv(q, k, v, out, lse, do,
                                                   **kw))
            split_p = (ck.flash_attention_bwd_dq_reference(
                q, k, v, out, lse, do, **kw),
                *ck.flash_attention_bwd_dkv_reference(q, k, v, out, lse, do,
                                                      **kw))
            grads_p = (split_p if t > SP_T_LOC
                       else ck.flash_attention_bwd_reference(
                           q, k, v, out, lse, do, True, mask, offs))
            torch.cuda.synchronize()
            o_err = (o_k.float() - o_p.float()).abs().max().item()
            inf_same = bool(torch.equal(torch.isinf(l_k), torch.isinf(l_p)))
            fin = torch.isfinite(l_p)
            l_err = ((l_k - l_p).abs()[fin].max().item() if fin.any()
                     else 0.0)
            rel3 = max(_rel_err(x, y) for x, y in zip(grads_k, grads_p))
            rel45 = max(_rel_err(x, y) for x, y in zip(split_k, split_p))
            is_dead = offs[1] > offs[0] + q.shape[1] - 1
            exact = True
            if is_dead:
                dead += 1
                exact = (bool(torch.equal(o_k, torch.zeros_like(o_k)))
                         and bool(torch.isneginf(l_k).all())
                         and all(bool(torch.equal(x, torch.zeros_like(x)))
                                 for x in (*grads_k, *split_k)))
            line = (f"flash blocks {kind} {dname} pair=({a},{b}) offsets="
                    f"{offs} Tq={q.shape[1]} Hkv={h_kv} mask={masked}"
                    f"{' dead' if is_dead else ''}: K1 out "
                    f"max_abs_err={o_err:.3e} tol={FLASH_TOL[dname]:.0e} "
                    f"lse max_abs_err={l_err:.3e} tol={LSE_TOL:.0e} "
                    f"-inf rows equal={inf_same}; flash_block_bwd (K3 "
                    f"launched={fused}) "
                    f"rel={rel3:.3e}, K4+K5 rel={rel45:.3e} "
                    f"tol={K3_TOL[dname]:.0e}"
                    f"{f'; exact zeros and -inf={exact}' if is_dead else ''}"
                    f" {card}")
            log(line)
            if not (o_err <= FLASH_TOL[dname] and l_err <= LSE_TOL
                    and inf_same and fused and rel3 <= K3_TOL[dname]
                    and rel45 <= K3_TOL[dname] and exact
                    and all(bool(torch.isfinite(x).all())
                            for x in (o_k, *grads_k, *split_k))):
                raise AssertionError(f"a ring block entry disagrees with "
                                     f"its plain version: {line}")
            errs["K1"] = max(errs["K1"], o_err)
            errs["K3"] = max(errs["K3"], *(
                (x.float() - y.float()).abs().max().item()
                for x, y in zip(grads_k, grads_p)))
            errs["K4"] = max(errs["K4"], (split_k[0].float()
                                          - split_p[0].float()).abs().max()
                             .item())
            errs["K5"] = max(errs["K5"], *(
                (x.float() - y.float()).abs().max().item()
                for x, y in zip(split_k[1:], split_p[1:])))
    log(f"flash blocks: {n_cases} cases, {dead} dead blocks, all "
        f"within their tolerances {card}")
    for key, err in errs.items():
        rows[f"{key}_err"] = max(rows.get(f"{key}_err", 0.0), err)


def _finetune_batch(seed: int, b: int, t: int):
    """One padded sentence-pair batch from ``np.random.default_rng(seed)``
    as GLUE fine-tuning feeds it: tokens uniform in 0..30000, lengths
    uniform in 32..t with a key mask of ones on the live positions (the
    same mask for both inputs), segments 0 then 1 from a per-row split
    point inside the live part, one-hot labels over 2 classes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 30000, (b, t)).astype(np.int32)
    lens = rng.integers(32, t + 1, b)
    split = rng.integers(1, lens)
    pos = np.arange(t)[None, :]
    mask = (pos < lens[:, None]).astype(np.float32)
    segments = (pos >= split[:, None]).astype(np.int32)
    labels = np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]
    return tokens, segments, mask, labels


def phase_finetune(state):
    import math
    import torch
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.zoo.bert import BertBase
    card = state["card"]
    t0 = time.perf_counter()
    net = BertBase(seed=2, compute_dtype="bfloat16").init_classifier(
        2, BERT_T)
    tokens, segments, mask, labels = _finetune_batch(0, BERT_B, BERT_T)
    log(f"finetune: init {net.num_params()} params on {net.device} "
        f"{time.perf_counter() - t0:.1f}s")

    def step():
        net.fit([tokens, segments], [labels], features_masks=[mask, mask])
        return net.score()                   # fit ends in a device sync

    torch.cuda.reset_peak_memory_stats()
    losses = [step() for _ in range(2)]      # warm steps
    for e in kernel_registry.ported():
        e.reset()
    torch.cuda.synchronize()
    steps = 8
    t_start = time.perf_counter()
    losses += [step() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {e.key: e.launches() for e in kernel_registry.ported()}
    state.setdefault("launches", {})["finetune"] = launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"finetune: losses {' '.join(f'{l:.4f}' for l in losses)} {card}")
    log(f"finetune: B={BERT_B} T={BERT_T} steps={steps} mean_step_ms="
        f"{wall / steps * 1e3:.3f} samples_per_s="
        f"{BERT_B * steps / wall:.1f} max_memory_allocated_gb="
        f"{peak_gb:.3f} {card}")
    assert all(math.isfinite(l) for l in losses), losses
    first, last = sum(losses[:2]) / 2, sum(losses[-2:]) / 2
    assert last < first, (first, last, losses)
    _check_step_launches("finetune", steps, launches, card)
    probs = net.output(tokens, segments, features_masks=[mask, mask])[0]
    _check_prob_rows("finetune", probs, (BERT_B, 2),
                     PROB_SUM_TOL["bfloat16"], card)


def _check_prob_rows(phase, probs, shape, tol, card) -> None:
    """An output on the card: finite probabilities of ``shape`` whose
    rows (over the last axis) each sum to 1 within ``tol``."""
    import torch
    row_err = (probs.sum(-1) - 1).abs().max().item()
    log(f"{phase}: output {tuple(probs.shape)} on {probs.device} "
        f"max|row sum - 1|={row_err:.2e} tol={tol:.1e} {card}")
    assert tuple(probs.shape) == tuple(shape) and probs.is_cuda
    assert bool(torch.isfinite(probs).all()) and row_err <= tol


def phase_finetune_agree(state):
    from deeplearning4j_tpu_torch.zoo.bert import BertBase
    model = BertBase(seed=3, dropout=0.0)            # float32
    tokens, segments, mask, labels = _finetune_batch(1, 4, BERT_T)
    (net, *_), _ = _agree_step(
        "finetune_agree",
        lambda dev: model.init_classifier(2, BERT_T, device=dev),
        [tokens, segments], [labels], [mask, mask], None, state["card"],
        what=f"f32 B=4 T={BERT_T} key-masked")
    _check_prob_rows("finetune_agree", net.output(
        tokens, segments, features_masks=[mask, mask])[0], (4, 2),
        PROB_SUM_TOL["float32"], state["card"])


# -- phases 21, 22: evaluation ---------------------------------------------
#: the evaluate phase: this many fixed full-length batches of BERT_B rows
EVAL_BATCHES = 16
#: timed passes over them (each after one warm pass), and the median taken
EVAL_PASSES = 3
#: eval_agree: batches of this many rows, card against CPU in f32
EVAL_AGREE_BATCHES, EVAL_AGREE_B = 2, 16


def _eval_batches(seed: int, n: int, b: int):
    """``n`` full-length sentence-pair batches (no masks) of ``b`` rows:
    the fine-tune batch of ``_finetune_batch(seed + i, b, BERT_T)`` with
    its mask dropped, as ``MultiDataSet``s of host arrays."""
    from deeplearning4j_tpu_torch.data import MultiDataSet
    out = []
    for i in range(n):
        tokens, segments, _, labels = _finetune_batch(seed + i, b, BERT_T)
        out.append(MultiDataSet([tokens, segments], [labels]))
    return out


def _eval_classes():
    """One of each of the seven evaluation classes."""
    from deeplearning4j_tpu_torch.eval_ import (
        ROC, Evaluation, EvaluationBinary, EvaluationCalibration,
        RegressionEvaluation, ROCBinary, ROCMultiClass)
    return [Evaluation(), ROC(), ROCMultiClass(), ROCBinary(),
            EvaluationBinary(), EvaluationCalibration(),
            RegressionEvaluation()]


def _same_stats(a, b, path="") -> bool:
    """Two evaluations' statistics equal to the bit: the same nested
    attributes, numpy arrays of the same dtype and bytes, equal
    scalars."""
    import numpy as np
    if hasattr(a, "__dict__"):
        a, b = vars(a), vars(b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_stats(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_same_stats(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


def phase_eval(state):
    """BERT-base's classifier (the finetune phase's model: bfloat16
    compute, random weights from a seed) evaluated over ``EVAL_BATCHES``
    fixed full-length batches of 64 × 128: ``net.evaluate`` (one warm
    pass, then ``EVAL_PASSES`` timed, each between zeroed and read launch
    counters: exactly the registry's ``eval`` count a batch), in turns
    with the bare ``output`` loop over the same batches; then, in the
    one-rank group of the dp phases, ``SparkComputationGraph(...).evaluate(...,
    num_classes=2)`` and ``do_evaluation`` with all seven classes, whose
    confusion matrices must equal the local one; then the dense net of
    ``tests/test_multiprocess.py`` trained and evaluated on the card
    (``evaluate``, ``evaluate_regression``)."""
    import math
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.parallel import (
        ParameterAveragingTrainingMaster, SparkComputationGraph)
    from deeplearning4j_tpu_torch.zoo.bert import BertBase
    card = state["card"]
    mesh = _dp_mesh(state)
    _free_card("eval", card)
    t0 = time.perf_counter()
    net = BertBase(seed=2, compute_dtype="bfloat16").init_classifier(
        2, BERT_T)
    batches = _eval_batches(0, EVAL_BATCHES, BERT_B)
    samples = EVAL_BATCHES * BERT_B
    log(f"eval: init {net.num_params()} params on {net.device} "
        f"{time.perf_counter() - t0:.1f}s; {EVAL_BATCHES} batches of "
        f"{BERT_B} x {BERT_T}, numpy {np.__version__}")

    def outputs():
        for b in batches:
            net.output(*b.features)

    torch.cuda.reset_peak_memory_stats()
    local = net.evaluate(batches)            # warm pass
    _wall_ms(outputs)                        # warm pass
    launches = dict.fromkeys((e.key for e in kernel_registry.ported()), 0)
    eval_ms, out_ms = [], []
    for _ in range(EVAL_PASSES):             # in turns: evaluate, output
        for e in kernel_registry.ported():
            e.reset()
        eval_ms.append(_wall_ms(lambda: net.evaluate(batches)))
        for e in kernel_registry.ported():
            launches[e.key] += e.launches()
        out_ms.append(_wall_ms(outputs))
    state.setdefault("launches", {})["eval"] = launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    e_ms, o_ms = statistics.median(eval_ms), statistics.median(out_ms)
    log(f"eval: evaluate {e_ms:.3f} ms a pass "
        f"samples_per_s={samples / e_ms * 1e3:.1f}; output loop "
        f"{o_ms:.3f} ms a pass samples_per_s={samples / o_ms * 1e3:.1f};"
        f" evaluate - output = {e_ms - o_ms:.3f} ms a pass "
        f"({(e_ms - o_ms) / EVAL_BATCHES:.3f} ms a batch); medians of "
        f"{EVAL_PASSES} passes each, in turns, after one warm pass each "
        f"(evaluate {' '.join(f'{t:.3f}' for t in eval_ms)}; output "
        f"{' '.join(f'{t:.3f}' for t in out_ms)}); "
        f"max_memory_allocated_gb={peak_gb:.3f} {card}")
    log(f"eval: count {local.count} accuracy {local.accuracy():.4f} "
        f"confusion {local.confusion.tolist()} {card}")
    assert local.count == samples, local.count
    _check_step_launches("eval", EVAL_PASSES * EVAL_BATCHES, launches, card)

    spark = SparkComputationGraph(net, ParameterAveragingTrainingMaster(),
                                  mesh)
    pinned = spark.evaluate(batches, num_classes=2)
    evs = spark.do_evaluation(batches, *_eval_classes())
    ev, roc = evs[0], evs[1]
    log(f"eval: SparkComputationGraph.evaluate(num_classes=2) count "
        f"{pinned.count}; do_evaluation over the seven classes: count "
        f"{ev.count} ROC AUC {roc.calculate_auc():.4f} ECE "
        f"{evs[5].expected_calibration_error():.4f} MSE "
        f"{evs[6].mean_squared_error():.4f} {card}")
    for other in (pinned, ev):
        assert other.count == samples
        assert np.array_equal(other.confusion, local.confusion), \
            (other.confusion, local.confusion)

    # the MultiLayerNetwork half: tests/test_multiprocess.py's dense net
    from deeplearning4j_tpu_torch.nn import updaters as upd
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(42)
            .updater(upd.Adam(learning_rate=0.05)).list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=2, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(4)).build())
    dense = MultiLayerNetwork(conf).init()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((448, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    it = ListDataSetIterator([DataSet(x[i:i + 64], y[i:i + 64])
                              for i in range(0, 448, 64)])
    dense.fit(it, epochs=8)
    dev = dense.evaluate(it)
    reg = dense.evaluate_regression(it)
    log(f"eval: dense net on {dense.device}, 56 steps: score "
        f"{dense.score():.4f}; evaluate count {dev.count} accuracy "
        f"{dev.accuracy():.4f}; evaluate_regression n {reg.n} MSE "
        f"{reg.mean_squared_error():.6f} {card}")
    assert dense.device.type == "cuda"
    assert dev.count == reg.n == 448 and dev.accuracy() > 0.8
    assert math.isfinite(reg.mean_squared_error())


def phase_eval_agree(state):
    """BERT-base in float32 (dropout 0, TF32 off) over
    ``EVAL_AGREE_BATCHES`` full-length batches of 16 × 128: the card's
    probabilities against the port on the CPU within ``AGREE_TOL``; the
    seven classes fed the card's tensors give statistics equal to the bit
    to those fed the same values as numpy arrays; a row whose argmax
    differs between card and CPU must have its top two within twice the
    observed error."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.zoo.bert import BertBase
    card = state["card"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = BertBase(seed=3, dropout=0.0)            # float32
    batches = _eval_batches(1, EVAL_AGREE_BATCHES, EVAL_AGREE_B)
    probs = {}
    for dev in ("cuda", "cpu"):
        net = model.init_classifier(2, BERT_T, device=dev)
        probs[dev] = [net.output(*b.features)[0] for b in batches]
        del net
    card_t = torch.cat(probs["cuda"])
    card_np, cpu_np = card_t.cpu().numpy(), torch.cat(probs["cpu"]).numpy()
    err = float(np.abs(card_np - cpu_np).max())
    top2 = np.sort(cpu_np, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    flipped = np.argmax(card_np, 1) != np.argmax(cpu_np, 1)
    near = int((margin <= 2 * err).sum())
    log(f"eval_agree: f32 {EVAL_AGREE_BATCHES} x {EVAL_AGREE_B} x {BERT_T} "
        f"card vs CPU: max|dp|={err:.3e} tol={AGREE_TOL:.0e}; argmax "
        f"differs on {int(flipped.sum())} rows, {near} rows have a top-two "
        f"margin within 2 x {err:.3e} {card}")
    assert err <= AGREE_TOL, err
    assert (margin[flipped] <= 2 * err).all(), margin[flipped]
    fed_t, fed_np = _eval_classes(), _eval_classes()
    for b, p in zip(batches, probs["cuda"]):
        y = b.labels[0]
        for e in fed_t:
            e.eval(torch.as_tensor(y, device="cuda"), p)
        for e in fed_np:
            e.eval(y, p.cpu().numpy())
    same = [_same_stats(a, b) for a, b in zip(fed_t, fed_np)]
    log(f"eval_agree: the seven classes fed card tensors vs numpy, "
        f"statistics equal to the bit: "
        f"{dict(zip((type(e).__name__ for e in fed_t), same))} {card}")
    assert all(same), same


def _wall_ms(fn) -> float:
    """Host-clock time of ``fn``, from a synchronised card to a
    synchronised card."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# device names of the norm and codec kernels, and of NCCL's collectives,
# whose summed time per window ``--phases profile`` prints whatever their
# rank
PROFILE_KERNELS = ("rms_fwd", "ln_fwd", "norm_bwd_", "threshold_encode",
                   "threshold_decode", "nccl")


def _device_window(name: str, fn, wall_ms: float, card: str,
                   host_top: int = 0) -> None:
    """Run ``fn`` under ``torch.profiler`` and sum the device time of
    every kernel, memcpy and memset (user-annotation ranges are not
    counted). Prints the busy time, its idle share of ``wall_ms`` (an
    unprofiled run of the same work), the ten largest device items by
    name and every norm, codec and NCCL kernel (``PROFILE_KERNELS``) with
    its summed time and launches, and the sums of the memcpy and memset
    items and of the NCCL kernels; with ``host_top``, also that many
    host-side ops by their own CPU time under the profiler (which
    inflates them: a ranking, not a time)."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    count = collections.Counter()
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name] += e.device_time_total / 1e3
            count[e.name] += 1
    busy = sum(by_name.values())
    log(f"profile {name}: wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f}"
        f" idle_share={1 - busy / wall_ms:.3f} {card}")
    for key, ms in by_name.most_common(10):
        log(f"  {ms:9.3f} ms {_pct(ms, busy):5.1f}% x{count[key]:<5d} "
            f"{key[:90]}")
    for key in sorted(by_name):
        if any(k in key for k in PROFILE_KERNELS):
            log(f"  kernel {by_name[key]:9.3f} ms x{count[key]:<5d} "
                f"{key[:90]}")
    for what, keys in (("memcpy+memset", ("Memcpy", "Memset")),
                       ("nccl", ("nccl",))):
        sel = [k for k in by_name if any(w in k for w in keys)]
        log(f"  sum {what} {sum(by_name[k] for k in sel):9.3f} ms "
            f"x{sum(count[k] for k in sel)}")
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)
    for ev in host[:host_top]:
        log(f"  host {ev.self_cpu_time_total / 1e3:9.3f} ms self "
            f"x{ev.count:<5d} {ev.key[:80]}")


# -- phases 23-26: the training runtime -------------------------------------
#: steps_per_loop of the region phases; turns of the grouped and the
#: sequential timing, taken in alternation (G S G S G S)
OPTS_K = 4
OPTS_TURNS = 3
#: the updater sweep of train_opts_agree: the train model cut to this
#: depth at full width (the update math is elementwise; the CPU half of
#: twelve updaters x 3 steps at 12 layers would take minutes)
SWEEP_LAYERS = 2
#: the sweep's updaters: each at the LM's own rate (``SWEEP_LR``, the
#: Adam family under ``_warmup_cosine`` of it); AdaDelta fixes its rate
#: at 1 and NoOp has none
SWEEP_LR = 3e-4
SWEEP = ("Sgd", "Momentum", "Nesterovs", "RmsProp", "AdaGrad", "AdaDelta",
         "NoOp", "Adam", "AdamW", "Nadam", "AMSGrad", "AdaMax")
ADAM_FAMILY = ("Adam", "AdamW", "Nadam", "AMSGrad", "AdaMax")
#: the step fault plan of the region phases, and the serving one
STEP_PLAN = "step:error=ConnectionError:nth=2:max=1"
SERVE_PLAN = "serving:error=RuntimeError:nth=3:max=1"
FAULT_REQUESTS, FAULT_PROMPT, FAULT_NEW = 4, 64, 64
#: host runtime calls that wait for the card
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize")


def _warmup_cosine(upd, initial: float):
    """Four warmup steps into a cosine over 32."""
    return upd.WarmupSchedule(warmup_steps=4, base=upd.CosineSchedule(
        initial=initial, max_iter=32))


def _lm_opts_updater(upd):
    return upd.AdamW(learning_rate=3e-4, weight_decay=0.01,
                     schedule=_warmup_cosine(upd, 3e-4))


def _bert_opts_updater(upd):
    """BERT's default fine-tuning AdamW under the schedule."""
    return upd.AdamW(learning_rate=2e-5, weight_decay=0.01,
                     exclude_bias_and_norm=True,
                     schedule=_warmup_cosine(upd, 2e-5))


def _region_profile(phase, fit_group, scope, n_arrays, card) -> None:
    """One group's ``fit`` under ``torch.profiler``: exactly one
    device-to-host copy in the window (the K losses) and no host wait
    for the card (``_SYNC_CALLS``) inside the region's ``scope``; the
    host-to-device copies of the staging are printed against the
    group's ``n_arrays``. Then the same group once more with the sync
    debug mode set to "error" around each update of the region."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fit_group()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "region.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            evs = json.load(f)
    evs = evs.get("traceEvents", evs) if isinstance(evs, dict) else evs
    # the host range of the scope (the trace also draws it on the
    # device's timeline, as a gpu_user_annotation)
    regions = [e for e in evs if e.get("name") == scope
               and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert len(regions) == 1, f"{phase}: {len(regions)} {scope} ranges"
    r0 = regions[0]["ts"]
    r1 = r0 + regions[0]["dur"]
    memcpy = [e for e in evs if e.get("cat") == "gpu_memcpy"]
    d2h = [e for e in memcpy if "DtoH" in e.get("name", "")]
    h2d = [e for e in memcpy if "HtoD" in e.get("name", "")]
    syncs = [e for e in evs if e.get("name") in _SYNC_CALLS
             and r0 <= e["ts"] <= r1]
    log(f"{phase}: profiler window over one group of {OPTS_K}: "
        f"device-to-host copies {len(d2h)} (expected 1), host waits "
        f"inside the region {len(syncs)} (expected 0), host-to-device "
        f"copies {len(h2d)} (the group's arrays: {n_arrays}), region "
        f"{regions[0]['dur'] / 1e3:.3f} ms of host time {card}")
    assert len(d2h) == 1, [e["name"] for e in d2h]
    assert not syncs, [(e["name"], e["ts"]) for e in syncs]


def _sync_debug_updates(net):
    """Context: each update of ``net`` (``_update``) runs with
    ``torch.cuda.set_sync_debug_mode("error")``, so a host wait inside
    the region raises."""
    import torch

    @contextlib.contextmanager
    def ctx():
        orig = net._update

        def guarded(*a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return orig(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        net._update = guarded
        try:
            yield
        finally:
            del net._update
    return ctx()


def _grouped_vs_sequential(phase, net, plain, make_it, card):
    """The mean step ms of a ``steps_per_loop=OPTS_K`` group of ``net``,
    of ``OPTS_K`` single steps of ``net`` (``steps_per_loop=1``) and of
    ``OPTS_K`` single steps of ``plain`` (the same model with its
    default updater, no schedule: the train or finetune phase's step),
    each from a synchronised card to a synchronised card, in
    ``OPTS_TURNS`` turns taken in alternation; prints the medians and
    every turn."""
    import torch
    runs = (("grouped", net, OPTS_K), ("sequential", net, 1),
            ("no_schedule", plain, 1))
    rows = {name: [] for name, _, _ in runs}
    plain.fit(make_it())                      # warm the second net
    for _ in range(OPTS_TURNS):
        for name, n, spl in runs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n.fit(make_it(), steps_per_loop=spl)
            torch.cuda.synchronize()
            rows[name].append((time.perf_counter() - t0) / OPTS_K * 1e3)
    med = {name: statistics.median(v) for name, v in rows.items()}
    log(f"{phase}: mean step ms, median of {OPTS_TURNS} turns of "
        f"{OPTS_K} steps: " + " ".join(
            f"{name} {med[name]:.3f} ({' '.join(f'{x:.3f}' for x in v)})"
            for name, v in rows.items())
        + f"; grouped/sequential {med['grouped'] / med['sequential']:.4f}"
        f", sequential/no_schedule "
        f"{med['sequential'] / med['no_schedule']:.4f} {card}")


def _state_copy(net):
    return ([t.clone() for t in _leaves(net.params)],
            [t.clone() for t in _leaves(net.opt_state)], net.iteration)


def _leaves(t):
    from deeplearning4j_tpu_torch import tree
    return list(tree.leaves(t))


def _fault_leaves_state(phase, net, make_it, card) -> None:
    """``STEP_PLAN`` over two groups (two ``fit`` calls of one group
    each): the second group's fault site raises before anything is
    staged, so the params, the optimizer state and ``iteration`` equal
    those after the first, to the bit; ``FAULTS_INJECTED{site="step"}``
    goes up by one. Before the plan no site was evaluated."""
    import torch
    from deeplearning4j_tpu_torch.obs import metrics
    from deeplearning4j_tpu_torch.resilience import faults
    assert faults.evaluations() == 0, faults.evaluations()
    fired0 = metrics.FAULTS_INJECTED.labels(site="step").get()
    try:
        with faults.active(STEP_PLAN):
            net.fit(make_it(), steps_per_loop=OPTS_K)
            after_first = _state_copy(net)
            raised = None
            try:
                net.fit(make_it(), steps_per_loop=OPTS_K)
            except ConnectionError as e:
                raised = e
            stats = faults.stats()
        assert raised is not None, "the step plan did not fire"
        now = _state_copy(net)
        same = (now[2] == after_first[2] and all(
            torch.equal(a, b) for a, b in zip(now[0] + now[1],
                                              after_first[0]
                                              + after_first[1])))
        fired = metrics.FAULTS_INJECTED.labels(site="step").get() - fired0
        log(f"{phase}: plan {STEP_PLAN}: raised {type(raised).__name__} "
            f"at the second group, state after it equal to the bit to "
            f"the first group's: {same} (iteration {now[2]}), "
            f"FAULTS_INJECTED{{site=step}} +{fired:g}, rules {stats} "
            f"{card}")
        assert same and fired == 1
    finally:
        faults.reset()


def _lm_group_batches(b: int, t: int, vocab: int, seed0: int = 100):
    """``OPTS_K`` random-token batches (as ``_train_batch``)."""
    return [_train_batch(seed0 + i, b, t, vocab) for i in range(OPTS_K)]


def phase_train_opts(state):
    import math
    import torch
    from deeplearning4j_tpu_torch import obs
    from deeplearning4j_tpu_torch.data import ListDataSetIterator
    from deeplearning4j_tpu_torch.nn import updaters as upd
    from deeplearning4j_tpu_torch.nn.multilayer import REGION_SCOPE
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    card = state["card"]
    _free_card("train_opts", card)
    model = CausalTransformerLM(compute_dtype="bfloat16",
                                updater=_lm_opts_updater(upd), **TRAIN)
    t0 = time.perf_counter()
    net = model.init(TRAIN_T)
    batches = _lm_group_batches(TRAIN_B, TRAIN_T, model.vocab_size)
    log(f"train_opts: init {net.num_params()} params, AdamW under "
        f"WarmupSchedule(4, CosineSchedule(3e-4, 32)), steps_per_loop="
        f"{OPTS_K}, {time.perf_counter() - t0:.1f}s")

    def group():
        net.fit(ListDataSetIterator(batches), steps_per_loop=OPTS_K)

    torch.cuda.reset_peak_memory_stats()
    group()                                  # the warm group
    scores = [net.score()]
    ev0 = obs.trace.events_recorded()
    for e in kernel_registry.ported():
        e.reset()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for _ in range(2):
        group()
        scores.append(net.score())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {e.key: e.launches() for e in kernel_registry.ported()}
    state.setdefault("launches", {})["train_opts"] = launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = 2 * OPTS_K
    log(f"train_opts: each group's last loss {' '.join(f'{s:.4f}' for s in scores)} "
        f"iteration={net.iteration} {card}")
    log(f"train_opts: B={TRAIN_B} T={TRAIN_T} 2 groups of {OPTS_K} "
        f"mean_step_ms={wall / steps * 1e3:.3f} tokens_per_s="
        f"{TRAIN_B * TRAIN_T * steps / wall:.1f} max_memory_allocated_gb="
        f"{peak_gb:.3f} {card}")
    assert all(math.isfinite(s) for s in scores), scores
    assert scores[-1] < scores[0], scores
    assert obs.trace.events_recorded() == ev0, "tracing off recorded"
    _check_step_launches("train_opts", steps, launches, card)
    _region_profile("train_opts", group,
                    REGION_SCOPE.format("MultiLayerNetwork"), 2, card)
    with _sync_debug_updates(net):
        group()
    log(f"train_opts: one group with sync debug mode 'error' around each "
        f"update: no host wait raised {card}")
    plain = CausalTransformerLM(compute_dtype="bfloat16",
                                **TRAIN).init(TRAIN_T)
    _grouped_vs_sequential("train_opts", net, plain,
                           lambda: ListDataSetIterator(batches), card)
    del plain
    # one traced group: the step span carries steps=K, and the phases'
    # spans cover the group's wall
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_opts.jsonl")
        obs.trace.enable(path)
        try:
            t0 = obs.now()
            group()
            t1 = obs.now()
        finally:
            obs.trace.disable()
        evs = [e for e in obs.trace.read_trace(path) if e.get("ph") == "X"]
    obs.trace.reset()
    step = [e for e in evs if e["name"] == "MultiLayerNetwork.fit/step"]
    assert len(step) == 1 and step[0].get("args") == {"steps": OPTS_K}, step
    parts = [e for e in evs if e["name"].rsplit("/", 1)[-1]
             in ("h2d", "dispatch", "sync", "etl")]
    cover = _span_cover(parts, t0 * 1e6, t1 * 1e6)
    names = sorted({e["name"] for e in parts})
    log(f"train_opts: traced group: step span args {step[0]['args']}, "
        f"{len(parts)} spans {names} cover {cover:.4f} of the group's "
        f"{(t1 - t0) * 1e3:.3f} ms wall {card}")
    assert cover >= 0.9, cover
    _fault_leaves_state("train_opts", net,
                        lambda: ListDataSetIterator(batches), card)
    del net


def _span_cover(spans, w0: float, w1: float) -> float:
    """Share of [w0, w1] (µs) covered by the union of ``spans``."""
    total, end = 0.0, w0
    for e in sorted(spans, key=lambda e: e["ts"]):
        s, f = max(e["ts"], end), min(e["ts"] + e["dur"], w1)
        if f > s:
            total += f - s
            end = f
    return total / (w1 - w0)


def phase_train_opts_agree(state):
    """One group of OPTS_K against OPTS_K single fits on the card, then
    the twelve updaters card against CPU."""
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.data import ListDataSetIterator
    from deeplearning4j_tpu_torch.nn import updaters as upd
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    card = state["card"]
    _free_card("train_opts_agree", card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = CausalTransformerLM(updater=_lm_opts_updater(upd), **TRAIN)
    batches = _lm_group_batches(2, 256, model.vocab_size, seed0=200)
    a = model.init(256)
    a.fit(ListDataSetIterator(batches), steps_per_loop=OPTS_K)
    b = model.init(256)
    b.fit(ListDataSetIterator(batches))
    loss_rel = abs(a.score() - b.score()) / abs(b.score())
    worst = _worst_param(a.params, b.params)
    log(f"train_opts_agree: f32 B=2 T=256, one group of {OPTS_K} against "
        f"{OPTS_K} single fits on the card: last loss {a.score():.6f} vs "
        f"{b.score():.6f} rel={loss_rel:.3e} tol={TRAIN_LOSS_RTOL:.0e}; "
        f"worst parameter {worst[1]} max|d|/max|p|={worst[0]:.3e} "
        f"tol={TRAIN_GRAD_TOL:.0e} {card}")
    assert loss_rel <= TRAIN_LOSS_RTOL and worst[0] <= TRAIN_GRAD_TOL
    del a, b
    sweep = dict(TRAIN, n_layers=SWEEP_LAYERS)
    failed = []
    # one pair of nets for the whole sweep: each updater starts from the
    # same initial parameters on the card with a fresh state, and the
    # CPU net takes the card's parameters and state at every step
    model = CausalTransformerLM(**sweep)
    card_net, cpu_net = model.init(256), model.init(256, device="cpu")
    init_params = tree.map_(torch.clone, card_net.params)
    for name in SWEEP:
        kw = {"learning_rate": SWEEP_LR}
        if name in ADAM_FAMILY:
            kw["schedule"] = _warmup_cosine(upd, SWEEP_LR)
        card_net.conf.updater = cpu_net.conf.updater = \
            getattr(upd, name)(**kw)
        card_net.params = tree.map_(torch.clone, init_params)
        card_net._build_optimizer()
        worst = {"loss": 0.0, "grad": (0.0, ""), "update": (0.0, "")}
        for x, y in batches[:3]:
            got = _sweep_step(card_net, cpu_net, x, y)
            worst["loss"] = max(worst["loss"], got["loss"])
            worst["grad"] = max(worst["grad"], got["grad"])
            worst["update"] = max(worst["update"], got["update"])
        log(f"train_opts_agree: {name} at {SWEEP_LR}"
            f"{' under the schedule' if name in ADAM_FAMILY else ''} "
            f"({SWEEP_LAYERS} layers, full width, f32), 3 steps, each "
            f"card vs CPU from the card's params and state: worst loss "
            f"rel={worst['loss']:.3e}, worst gradient {worst['grad'][1]} "
            f"{worst['grad'][0]:.3e}, worst updated parameter or state "
            f"{worst['update'][1]} {worst['update'][0]:.3e} of its max "
            f"{card}")
        if not (worst["loss"] <= TRAIN_LOSS_RTOL
                and worst["grad"][0] <= TRAIN_GRAD_TOL
                and worst["update"][0] <= TRAIN_GRAD_TOL):
            failed.append(name)
    assert not failed, f"card and CPU disagree for {failed}"


def _sweep_step(card_net, cpu_net, x, y):
    """One step of the sweep on both devices from the same point: the
    CPU net takes the card net's parameters and optimizer state, both
    compute the loss and gradients of the batch, the card applies its
    update (``apply_updates``, as ``fit`` does) and the CPU applies the
    same update to the card's gradient. Returns the loss's relative
    difference and the worst gradient and updated leaf (parameter or
    optimizer state) against their max, with their keys. (Run free, the
    two devices' trajectories part further under the Adam family: a
    gradient element within f32 rounding of zero may take either sign,
    and Adam steps it by about the learning rate either way.)"""
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.nn.multilayer import apply_updates
    cpu_net.params = tree.map_(lambda t: t.cpu(), card_net.params)
    cpu_net.opt_state = tree.map_(lambda t: t.cpu(), card_net.opt_state)
    results = []
    for net in (card_net, cpu_net):
        xt = torch.as_tensor(x, device=net.device)
        yt = torch.as_tensor(y, device=net.device)
        results.append(net._loss_and_grads(xt, yt)[:2])
    (l_card, g_card), (l_cpu, g_cpu) = results
    chains = card_net._chains            # the sweep's updater, each group
    card_net.params, card_net.opt_state = apply_updates(
        chains, card_net.params, g_card, card_net.opt_state)
    card_net.iteration += 1
    want_p, want_s = apply_updates(
        chains, cpu_net.params, tree.map_(lambda t: t.cpu(), g_card),
        cpu_net.opt_state)
    grads = _worst_param(dict(_named(g_card)), dict(_named(g_cpu)),
                         flat=True)
    update = max(_worst_param(card_net.params, want_p),
                 _worst_param(card_net.opt_state, want_s))
    return {"loss": abs(l_card.item() - l_cpu.item()) / abs(l_cpu.item()),
            "grad": grads, "update": update}


def _named(params):
    from deeplearning4j_tpu_torch import tree
    out = []
    tree.map_with_path(lambda p, t: out.append((".".join(p),
                                                t.detach().cpu())), params)
    return out


def _worst_param(a, b, flat=False):
    """The largest max|a - b| / max|b| over the parameter tensors, and
    its key."""
    if not flat:
        a, b = dict(_named(a)), dict(_named(b))
    worst = (0.0, "")
    for k, want in b.items():
        want = want.double()
        scale = want.abs().max().item() or 1.0
        d = (a[k].double() - want).abs().max().item() / scale
        worst = max(worst, (d, k))
    return worst


def phase_finetune_opts(state):
    import math
    import torch
    from deeplearning4j_tpu_torch.data import MultiDataSet
    from deeplearning4j_tpu_torch.nn import updaters as upd
    from deeplearning4j_tpu_torch.nn.multilayer import REGION_SCOPE
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.zoo.bert import BertBase
    card = state["card"]
    _free_card("finetune_opts", card)
    t0 = time.perf_counter()
    net = BertBase(seed=2, compute_dtype="bfloat16",
                   updater=_bert_opts_updater(upd)).init_classifier(
        2, BERT_T)
    data = [MultiDataSet([tok, seg], [lab], features_masks=[mask, mask])
            for tok, seg, mask, lab in (_finetune_batch(s, BERT_B, BERT_T)
                                        for s in range(3 * OPTS_K))]
    log(f"finetune_opts: init {net.num_params()} params, AdamW under "
        f"WarmupSchedule(4, CosineSchedule(2e-5, 32)), "
        f"{len(data)} masked batches of {BERT_B} x {BERT_T}, "
        f"steps_per_loop={OPTS_K}, {time.perf_counter() - t0:.1f}s")

    class It:                    # a re-iterable source of the batches
        def __init__(self, items):
            self.items = items

        def __iter__(self):
            return iter(self.items)

    net.fit(It(data[:OPTS_K]), steps_per_loop=OPTS_K)   # the warm group
    single = []
    orig = net._fit_batch
    net._fit_batch = lambda *a, **k: (single.append(1), orig(*a, **k))[1]
    for e in kernel_registry.ported():
        e.reset()
    scores = []
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for i in range(3):
        net.fit(It(data[i * OPTS_K:(i + 1) * OPTS_K]),
                steps_per_loop=OPTS_K)
        scores.append(net.score())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    del net._fit_batch
    launches = {e.key: e.launches() for e in kernel_registry.ported()}
    state.setdefault("launches", {})["finetune_opts"] = launches
    steps = 3 * OPTS_K
    log(f"finetune_opts: each group's last loss {' '.join(f'{s:.4f}' for s in scores)}; "
        f"single-batch dispatches {len(single)} (expected 0) "
        f"mean_step_ms={wall / steps * 1e3:.3f} samples_per_s="
        f"{BERT_B * steps / wall:.1f} {card}")
    assert all(math.isfinite(s) for s in scores) and not single
    _check_step_launches("finetune_opts", steps, launches, card)

    def group():
        net.fit(It(data[:OPTS_K]), steps_per_loop=OPTS_K)

    _region_profile("finetune_opts", group,
                    REGION_SCOPE.format("ComputationGraph"), 5, card)
    # listeners run after the group's one copy: the region stays as it was
    from deeplearning4j_tpu_torch.train import ScoreIterationListener
    net.set_listeners(ScoreIterationListener(1))
    _region_profile("finetune_opts+ScoreIterationListener(1)", group,
                    REGION_SCOPE.format("ComputationGraph"), 5, card)
    net.set_listeners()
    plain = BertBase(seed=2, compute_dtype="bfloat16").init_classifier(
        2, BERT_T)
    _grouped_vs_sequential("finetune_opts", net, plain,
                           lambda: It(data[:OPTS_K]), card)
    del plain
    _fault_leaves_state("finetune_opts", net,
                        lambda: It(data[:OPTS_K]), card)
    del net


def phase_serve_fault(state):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.obs import metrics
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.resilience import faults
    from deeplearning4j_tpu_torch.serving.gateway import (SequenceAborted,
                                                          ServingGateway)
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    card = state["card"]
    _free_card("serve_fault", card)
    model = CausalTransformerLM(compute_dtype="bfloat16", **SERVE)
    params = model.init_params(seed=0, device="cuda")
    gw = ServingGateway(model, params, max_slots=32, block=16,
                        max_context=2048, queue_limit=64,
                        default_max_new=FAULT_NEW)
    try:
        gw.warmup(prompt_lens=(FAULT_PROMPT,))
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, model.vocab_size, FAULT_PROMPT)
                   for _ in range(FAULT_REQUESTS)]
        assert faults.evaluations() == 0, faults.evaluations()
        worker = gw._worker
        sched = gw._sched
        shed0 = metrics.SERVING_SHED.labels(reason="fault").get()
        steps0 = sched.steps
        gw.pause()
        for e in kernel_registry.ported():
            e.reset()
        victims = []
        with faults.active(SERVE_PLAN):
            streams = [gw.submit(p, max_new=FAULT_NEW) for p in prompts]
            gw.resume()
            for st in streams:
                try:
                    st.result(timeout=600)
                except SequenceAborted as e:
                    assert e.tokens == st._tokens, "token leakage"
                    assert e.tokens, "a victim without its tokens"
                    victims.append(len(e.tokens))
            stats = faults.stats()
        shed = metrics.SERVING_SHED.labels(reason="fault").get() - shed0
        sched.pager.check_invariants()
        free_ok = sched.pager.free_pages() == sched.pager.n_pages - 1
        fresh_prompt = rng.integers(0, model.vocab_size, FAULT_PROMPT)
        out = gw.submit(fresh_prompt, max_new=FAULT_NEW).result(timeout=600)
        torch.cuda.synchronize()
        gen = out[FAULT_PROMPT:]
        launches = {e.key: e.launches() for e in kernel_registry.ported()}
        steps = sched.steps - steps0
        admissions = FAULT_REQUESTS + 1
        want = {e.key: 0 for e in kernel_registry.ported()}
        want["K1"] = 12 * admissions
        want["K2"] = 25 * (admissions + steps)
        state.setdefault("launches", {})["serve_fault"] = launches
        log(f"serve_fault: plan {SERVE_PLAN} ({stats}): "
            f"{len(victims)} of {FAULT_REQUESTS} requests shed with "
            f"their own tokens ({victims} tokens each), "
            f"SERVING_SHED{{reason=fault}} +{shed:g}, pager invariants "
            f"hold, every page freed: {free_ok}; then the same worker "
            f"({gw._worker is worker and worker.is_alive()}) served "
            f"{gen.size} tokens in vocab: "
            f"{bool(((gen >= 0) & (gen < model.vocab_size)).all())} "
            f"{card}")
        log(f"serve_fault: launches {launches} (expected {want}: K1 12 x "
            f"{admissions} admissions, K2 25 x ({admissions} admissions "
            f"+ {steps} steps)) {card}")
        assert len(victims) == FAULT_REQUESTS and shed == len(victims)
        assert free_ok and gw._worker is worker and worker.is_alive()
        assert gen.shape == (FAULT_NEW,)
        assert ((gen >= 0) & (gen < model.vocab_size)).all()
        assert launches == want, (launches, want)
    finally:
        faults.reset()
        gw.shutdown(drain=False)


# -- phases 28-30: LeNet on MNIST, the zip bridge ----------------------------
#: the lenet phase: the reference's test_lenet_e2e on the card — synthetic
#: MNIST (the checkout holds no IDX files), its sizes, batch and epochs
LENET_TRAIN, LENET_TEST, LENET_B, LENET_EPOCHS = 2048, 512, 64, 2
#: timed epochs, with listeners and without, taken in turns
LENET_TURNS = 3
LENET_ACC = 0.97                   # test accuracy after LENET_EPOCHS
DIGITS_ACC = 0.95                  # the real-digits CNN's bar
#: the restored checkpoint's output against the live network's: the same
#: parameters through the same cuDNN calls
LENET_RESTORE_RTOL = 1e-5
LENET_RESTORE_ATOL = 1e-6
#: checkpoint: the resumed run against the uninterrupted one — each loss
#: to 1e-5 relative, each parameter tensor to 1e-3 of its largest value
CKPT_LOSS_RTOL = 1e-5
CKPT_PARAM_TOL = 1e-3


def _mnist_dir() -> str:
    """A data directory inside the checkout that holds no IDX files, so
    the MNIST iterator takes its synthetic digits (and reads nothing
    outside the checkout)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "resources", "datasets", "mnist")


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 for cuDNN convolutions and matmuls set to ``on`` inside, the
    previous settings restored after."""
    import torch
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def _lenet_listeners(train_it, test_it, ckpt_dir, perf, evals):
    from deeplearning4j_tpu_torch.train import (CheckpointListener,
                                                CollectScoresListener,
                                                EvaluativeListener,
                                                PerformanceListener,
                                                ScoreIterationListener)
    return [ScoreIterationListener(10),
            PerformanceListener(10, report=perf.append, iterator=train_it),
            CollectScoresListener(),
            EvaluativeListener(test_it, frequency_epochs=1,
                               callback=evals.append),
            CheckpointListener(ckpt_dir, save_every_n_epochs=1,
                               keep_last=2)]


def _digits_cnn(card) -> float:
    """The small CNN of ``tests/test_real_digits.py`` trained 30 epochs
    on the card; its accuracy on the real digits' test split. No ported
    kernel may launch in its steps."""
    import torch
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.data import (RealDigitsDataSetIterator,
                                               load_real_digits)
    from deeplearning4j_tpu_torch.eval_ import Evaluation
    from deeplearning4j_tpu_torch.nn import layers as pl
    from deeplearning4j_tpu_torch.nn import updaters as upd
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(5)
            .updater(upd.Adam(learning_rate=2e-3))
            .weight_init_fn("xavier").list()
            .layer(pl.ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                       padding="SAME", activation="relu"))
            .layer(pl.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(pl.DenseLayer(n_out=64, activation="relu"))
            .layer(pl.OutputLayer(n_out=10, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.convolutional(8, 8, 1)).build())
    net = MultiLayerNetwork(conf).init()
    it = RealDigitsDataSetIterator(batch_size=64, train=True)
    for e in kernel_registry.ported():
        e.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(it, epochs=30)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {e.key: e.launches() for e in kernel_registry.ported()}
    _check_step_launches("lenet_digits", net.iteration, launches, card)
    xt, yt = load_real_digits(train=False)
    ev = Evaluation()
    ev.eval(yt, net.output(xt).cpu().numpy())
    log(f"lenet: real digits (8x8, {len(yt)} test digits) small CNN on "
        f"{net.device}: {net.iteration} steps in {secs:.3f} s, test "
        f"accuracy {ev.accuracy():.4f} (bar {DIGITS_ACC}) {card}")
    return ev.accuracy()


def phase_lenet(state):
    """LeNet at its published widths on the card, the reference's
    ``test_lenet_e2e`` path: synthetic MNIST behind the prefetch
    iterator, ``fit`` with the five listeners, ``evaluate``, the
    checkpoints, a restore; then the real-digits CNN; then the step
    timed with and without listeners, the checkpoint write, the zip's
    size and the peak memory. No ported kernel may launch."""
    import math
    import tempfile
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.data import (AsyncDataSetIterator,
                                               MnistDataSetIterator)
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.resilience.checkpoint import \
        verify_checkpoint
    from deeplearning4j_tpu_torch.serialization import ModelSerializer
    from deeplearning4j_tpu_torch.zoo import LeNet
    card = state["card"]
    _free_card("lenet", card)
    torch.cuda.reset_peak_memory_stats()
    base = MnistDataSetIterator(batch_size=LENET_B, train=True,
                                n_examples=LENET_TRAIN,
                                data_dir=_mnist_dir())
    test_it = MnistDataSetIterator(batch_size=256, train=False,
                                   n_examples=LENET_TEST,
                                   data_dir=_mnist_dir())
    assert base.synthetic and test_it.synthetic
    train_it = AsyncDataSetIterator(base, queue_size=4)
    net = LeNet(num_classes=10, seed=123).init()
    assert net.num_params() == 1_256_080, net.num_params()
    perf, evals = [], []
    with tempfile.TemporaryDirectory() as tmp, _tf32(True):
        ckpt_dir = os.path.join(tmp, "ckpt")
        listeners = _lenet_listeners(train_it, test_it, ckpt_dir, perf,
                                     evals)
        net.set_listeners(*listeners)
        for e in kernel_registry.ported():
            e.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(train_it, epochs=LENET_EPOCHS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {e.key: e.launches() for e in kernel_registry.ported()}
        scores = [s for _, s in listeners[2].scores]
        steps = len(scores)
        log(f"lenet: LeNet {net.num_params()} params on {net.device}, "
            f"synthetic MNIST {LENET_TRAIN}/{LENET_TEST} batch {LENET_B}, "
            f"{LENET_EPOCHS} epochs behind AsyncDataSetIterator(4) with "
            f"Score/Performance/CollectScores/Evaluative/Checkpoint "
            f"listeners: {steps} steps in {fit_s:.3f} s; losses first "
            f"{scores[0]:.4f} last {scores[-1]:.4f}; per-epoch test "
            f"accuracy {[round(e.accuracy(), 4) for e in evals]}; "
            f"PerformanceListener: {perf[-1] if perf else None} {card}")
        assert steps == LENET_EPOCHS * LENET_TRAIN // LENET_B
        assert all(math.isfinite(s) for s in scores)
        assert np.mean(scores[-4:]) < np.mean(scores[:4]), scores
        _check_step_launches("lenet", steps, launches, card)
        acc_digits = _digits_cnn(card)
        acc = net.evaluate(test_it).accuracy()
        ckpts = sorted(os.listdir(ckpt_dir))
        verified = [verify_checkpoint(os.path.join(ckpt_dir, c))
                    for c in ckpts if c.endswith(".zip")]
        log(f"lenet: test accuracy {acc:.4f} (bar {LENET_ACC}); "
            f"checkpoint directory {ckpts}, verify {verified} {card}")
        assert acc > LENET_ACC and len(evals) == LENET_EPOCHS
        assert [c for c in ckpts if c.endswith(".zip")] == [
            "checkpoint_epoch_0.zip", "checkpoint_epoch_1.zip"]
        assert all(v == (True, "ok") for v in verified)
        assert acc_digits >= DIGITS_ACC
        newest = ModelSerializer.restore_multi_layer_network(
            os.path.join(ckpt_dir, "checkpoint_epoch_1.zip"))
        x = next(iter(test_it)).features
        out, back = net.output(x), newest.output(x)
        err = ((out - back).abs() / out.abs().clamp_min(1e-30)).max().item()
        log(f"lenet: newest checkpoint restored on {newest.device}, "
            f"iteration {newest.iteration}; output max rel diff {err:.3e} "
            f"(rtol {LENET_RESTORE_RTOL:.0e}, atol "
            f"{LENET_RESTORE_ATOL:.0e}) {card}")
        assert newest.device.type == "cuda" and newest.iteration == steps
        torch.testing.assert_close(back, out, rtol=LENET_RESTORE_RTOL,
                                   atol=LENET_RESTORE_ATOL)
        del newest
        _lenet_timing(net, train_it, listeners, tmp, card)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"lenet: max_memory_allocated_gb={peak:.3f} {card}")


def _lenet_timing(net, train_it, listeners, tmp, card) -> None:
    """One epoch of ``LENET_TRAIN`` examples with the listeners and one
    without, in ``LENET_TURNS`` turns: the mean step and samples/s of
    each (medians), TF32 as set around it; then one checkpoint write
    (ms, bytes)."""
    import torch
    from deeplearning4j_tpu_torch.serialization import ModelSerializer
    rows = {"listeners": [], "bare": []}
    steps = LENET_TRAIN // LENET_B
    for _ in range(LENET_TURNS):
        for name in rows:
            net.set_listeners(*(listeners if name == "listeners" else ()))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit(train_it)
            torch.cuda.synchronize()
            rows[name].append((time.perf_counter() - t0) / steps * 1e3)
    net.set_listeners()
    med = {k: statistics.median(v) for k, v in rows.items()}
    log("lenet: mean step ms, median of "
        f"{LENET_TURNS} turns of one epoch ({steps} steps, batch "
        f"{LENET_B}, cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}): " + " ".join(
            f"{k} {med[k]:.3f} ({' '.join(f'{x:.3f}' for x in v)}) "
            f"samples_per_s={LENET_B / med[k] * 1e3:.1f}"
            for k, v in rows.items()) + f" {card}")
    path = os.path.join(tmp, "lenet.zip")
    ModelSerializer.write_model(net, path)             # warm
    t0 = time.perf_counter()
    ModelSerializer.write_model(net, path)
    ms = (time.perf_counter() - t0) * 1e3
    log(f"lenet: ModelSerializer.write_model (updater state included) "
        f"{ms:.3f} ms, zip {os.path.getsize(path)} bytes {card}")


def _lenet_numpy_tree(seed: int):
    """LeNet's parameters in the JAX package's layout (HWIO kernels,
    [in, out] dense weights, names ``layer_<i>``/``W``/``b``) drawn from
    ``np.random.default_rng(seed)`` with the fan-in scale."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shapes = {"layer_0": (5, 5, 1, 20), "layer_2": (5, 5, 20, 50),
              "layer_4": (7 * 7 * 50, 500), "layer_5": (500, 10)}
    out = {"layer_1": {}, "layer_3": {}}
    for name, shape in shapes.items():
        fan_in = int(np.prod(shape[:-1]))
        out[name] = {
            "W": (rng.normal(size=shape) / np.sqrt(fan_in)).astype(
                np.float32),
            "b": (0.1 * rng.normal(size=shape[-1:])).astype(np.float32)}
    return out


def phase_lenet_agree(state):
    """LeNet in float32 with TF32 off, weights carried across from a
    JAX-shaped numpy tree: one step's loss and gradients and the output,
    card against the port on the CPU (``train_agree``'s bands); then a
    zip written on the card restored through the CPU port."""
    import tempfile
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.data import MnistDataSetIterator
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.serialization import ModelSerializer
    from deeplearning4j_tpu_torch.zoo import LeNet
    card = state["card"]
    for e in kernel_registry.ported():
        e.reset()
    batch = next(iter(MnistDataSetIterator(
        batch_size=LENET_B, train=True, n_examples=LENET_B,
        data_dir=_mnist_dir())))
    x, y = batch.features, batch.labels
    weights = _lenet_numpy_tree(7)
    res = {}
    with _tf32(False):
        for dev in ("cuda", "cpu"):
            net = LeNet().init(device=dev).params_from_jax(weights)
            loss, grads, _ = net._loss_and_grads(
                torch.as_tensor(x, device=dev),
                torch.as_tensor(y, device=dev))
            res[dev] = (loss.item(), tree.map_(lambda g: g.cpu(), grads),
                        net.output(x).cpu(), net)
        (l_card, g_card, o_card, card_net) = res["cuda"]
        (l_cpu, g_cpu, o_cpu, _) = res["cpu"]
        loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
        worst, key = max(tree.leaves(tree.map_with_path(
            lambda p, a, b: (_rel_err(a, b), ".".join(p)), g_card, g_cpu)))
        out_err = (o_card - o_cpu).abs().max().item()
        log(f"lenet_agree: f32 TF32 off, batch {LENET_B}, card vs CPU: "
            f"loss {l_card:.6f} vs {l_cpu:.6f} rel={loss_rel:.3e} "
            f"tol={TRAIN_LOSS_RTOL:.0e}; worst gradient {key} "
            f"max|d|/max|g|={worst:.3e} tol={TRAIN_GRAD_TOL:.0e}; output "
            f"max|d|={out_err:.3e} tol={AGREE_TOL:.0e} {card}")
        assert loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_TOL
        assert out_err <= AGREE_TOL
        card_net.fit(x, y)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "card.zip")
            ModelSerializer.write_model(card_net, path)
            cpu_net = ModelSerializer.restore_multi_layer_network(
                path, device="cpu")
            zip_err = (card_net.output(x).cpu()
                       - cpu_net.output(x)).abs().max().item()
        log(f"lenet_agree: a zip written on the card after one step, "
            f"restored through the CPU port (iteration "
            f"{cpu_net.iteration}, on {cpu_net.device}): output "
            f"max|d|={zip_err:.3e} tol={AGREE_TOL:.0e} {card}")
        assert cpu_net.device.type == "cpu" and cpu_net.iteration == 1
        assert zip_err <= AGREE_TOL
    _check_step_launches("lenet_agree", 1, {
        e.key: e.launches() for e in kernel_registry.ported()}, card)


def phase_checkpoint(state):
    """BERT-base's classifier at full width (the finetune phase's model
    and batches, float32 with TF32 off): 2 steps, ``write_model`` with
    the updater state, a restore on the card and 2 more steps, against
    4 steps uninterrupted. K1, K3, K8 and K9 launch as many times a step
    as in finetune."""
    import math
    import tempfile
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.serialization import ModelSerializer
    from deeplearning4j_tpu_torch.zoo.bert import BertBase
    card = state["card"]
    _free_card("checkpoint", card)
    batches = [_finetune_batch(s, BERT_B, BERT_T) for s in range(4)]

    def step(net, b):
        tokens, segments, mask, labels = b
        net.fit([tokens, segments], [labels], features_masks=[mask, mask])
        return net.score()

    with _tf32(False), tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bert.zip")
        net = BertBase(seed=2).init_classifier(2, BERT_T)
        for e in kernel_registry.ported():
            e.reset()
        ref = [step(net, b) for b in batches]
        ref_params = tree.map_(lambda t: t.detach().clone(), net.params)
        del net
        net = BertBase(seed=2).init_classifier(2, BERT_T)
        got = [step(net, b) for b in batches[:2]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ModelSerializer.write_model(net, path, save_updater=True)
        write_ms = (time.perf_counter() - t0) * 1e3
        nbytes = os.path.getsize(path)
        del net
        t0 = time.perf_counter()
        net = ModelSerializer.restore_computation_graph(path)
        torch.cuda.synchronize()
        read_ms = (time.perf_counter() - t0) * 1e3
        assert net.device.type == "cuda" and net.iteration == 2
        got += [step(net, b) for b in batches[2:]]
        torch.cuda.synchronize()
        launches = {e.key: e.launches() for e in kernel_registry.ported()}
    state.setdefault("launches", {})["checkpoint"] = launches
    rel = [abs(a - b) / abs(a) for a, b in zip(ref, got)]
    worst, key = max(tree.leaves(tree.map_with_path(
        lambda p, a, b: (_rel_err(b, a), ".".join(p)), ref_params,
        net.params)))
    log(f"checkpoint: BERT-base f32 (TF32 off) B={BERT_B} T={BERT_T}, "
        f"{net.num_params()} params: losses uninterrupted "
        f"{' '.join(f'{l:.6f}' for l in ref)} resumed "
        f"{' '.join(f'{l:.6f}' for l in got)} max rel={max(rel):.3e} "
        f"tol={CKPT_LOSS_RTOL:.0e}; worst parameter {key} "
        f"max|d|/max|p|={worst:.3e} tol={CKPT_PARAM_TOL:.0e} {card}")
    log(f"checkpoint: write_model(save_updater=True) {write_ms:.3f} ms, "
        f"zip {nbytes} bytes; restore_computation_graph on the card "
        f"{read_ms:.3f} ms {card}")
    assert all(math.isfinite(l) for l in ref + got)
    assert max(rel) <= CKPT_LOSS_RTOL and worst <= CKPT_PARAM_TOL
    _check_step_launches("checkpoint", 8, launches, card)
    del net, ref_params


# -- transfer learning ------------------------------------------------------
#: ``set_feature_extractor``'s last frozen layer on the LM: the embedding
#: (layer_0) and blocks 1-6 are frozen, blocks 7-12, the final norm and
#: the head's bias train (the head's W stays tied to the frozen embedding)
TRANSFER_FROZEN = 6
TRANSFER_STEPS = 8
#: the TransferLearningHelper check: one Sgd step at this rate on the
#: featurized tail against one full-net step (a fresh untied head: the tied
#: one crosses the split), both in f32 with TF32 off. The features are the
#: prefix's f32 output (``activate_selected_layers`` runs the masters);
#: under bf16 compute the full step would see the prefix's bf16 output
#: instead, and the updates part by that rounding carried through six
#: blocks (on the CPU at hidden 96, 9e-2 of a leaf's largest update),
#: which would hide a fault. In f32 both see the same features, so the
#: bands are train_agree's: the loss 1e-5 relative, each tail update
#: within 1e-3 of its largest element.
HELPER_LR = 1e-2
#: the zip round trip's resumed steps: the tokens of the batch they take
ZIP_RESUME_T = 128
#: transfer_agree: the LM at full width with 2 frozen and 2 trainable
#: blocks, f32, B = 2, T = 256; the first trainable block carries an l1
#: term and a max-norm constraint (a column of a 768-wide xavier matrix
#: has norm ~1, so 0.9 clips most of them)
AGREE_LAYERS, AGREE_FROZEN = 4, 2
AGREE_L1, AGREE_MAX_NORM = 1e-6, 0.9
#: weight noise on the card, by its statistics over n draws (a block's
#: Wg, 768 x 2048): the noise's mean, its standard deviation and
#: DropConnect's keep rate each within this many standard errors of
#: their targets (σ/√n, σ/√(2n) relative, √(p(1 − p)/n))
NOISE_SIGMAS = 5


def _transfer_ftc(upd, ftc):
    """The fine-tune of phase transfer: Adam 1e-4 as the network's
    updater, a per-layer rate of 5e-5 with decay 0.01 and l2 1e-6 on every
    layer that trains."""
    return ftc(updater=upd.Adam(learning_rate=1e-4), learning_rate=5e-5,
               weight_decay=0.01, l2=1e-6)


def _host_params(net):
    """A host copy of every parameter group of ``net``."""
    from deeplearning4j_tpu_torch import tree
    return {n: tree.map_(lambda t: t.detach().cpu(), p)
            for n, p in net.params.items()}


def _same_groups(a, b):
    """Group name → whether every leaf of ``a``'s group equals ``b``'s to
    the bit (on the host)."""
    import torch
    from deeplearning4j_tpu_torch import tree
    return {n: all(torch.equal(x.detach().cpu(), y.detach().cpu())
                   for x, y in zip(tree.leaves(a[n]), tree.leaves(b[n])))
            for n in a}


def _opt_bytes(net) -> int:
    from deeplearning4j_tpu_torch import tree
    return sum(t.numel() * t.element_size()
               for t in tree.leaves(net.opt_state))


def phase_transfer(state):
    """Transfer learning on the train LM at full width: the pretrained
    source (phase train's step, timed as the full fine-tune), the
    transferred net (``set_feature_extractor(6)`` under the fine-tune
    chain) for 1 warm and 8 timed steps, the helper's featurized step
    against a full-net step, and the zip round trip."""
    import math
    import tempfile
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.nn import (FineTuneConfiguration,
                                             TransferLearning,
                                             TransferLearningHelper)
    from deeplearning4j_tpu_torch.nn import updaters as upd
    from deeplearning4j_tpu_torch.nn.layers import RnnOutputLayer
    from deeplearning4j_tpu_torch.serialization import ModelSerializer
    card = state["card"]
    _free_card("transfer", card)
    # 1. the source, trained as phase train trains it (its kernel counts
    #    checked as train's; not recorded under transfer)
    src = _fit_steps(state, "train", TRAIN, TRAIN_B, TRAIN_T, warm=2,
                     steps=TRANSFER_STEPS, label="transfer/full",
                     record=False)
    full_opt = _opt_bytes(src)
    _, full_ms, full_rate, full_peak = state["timed"]["transfer/full"]
    x, y = _train_batch(0, TRAIN_B, TRAIN_T, TRAIN["vocab_size"])
    # 2. the transferred net
    t0 = time.perf_counter()
    net = (TransferLearning.builder(src)
           .fine_tune_configuration(_transfer_ftc(upd,
                                                  FineTuneConfiguration))
           .set_feature_extractor(TRANSFER_FROZEN).build())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    del src
    frozen = sorted(net._frozen())
    assert frozen == sorted(f"layer_{i}"
                            for i in range(TRANSFER_FROZEN + 1)), frozen
    assert net.device.type == "cuda"
    assert net.conf.tied_weights == [[TRAIN["n_layers"] + 2, "W", 0, "W",
                                      True]], net.conf.tied_weights
    n_frozen = sum(t.numel() for n in frozen
                   for t in tree.leaves(net.params[n]))
    log(f"transfer: build {build_s:.1f}s; frozen layer_0..layer_"
        f"{TRANSFER_FROZEN} ({n_frozen} of {net.num_params()} params, no "
        f"optimizer state), the tie to layer_0 kept; trainable groups' "
        f"updater {type(net._chains['layer_7'].updater).__name__} at "
        f"{net._chains['layer_7'].updater.learning_rate} after decay "
        f"{net._chains['layer_7'].weight_decay}, l2 "
        f"{net.layers[7].l2} {card}")
    _free_card("transfer", card)
    before = _host_params(net)
    # 3. the timed fine-tune
    losses, ms, rate, peak = _timed_steps(
        state, "transfer", net, lambda: net.fit(x, y), TRAIN_B, TRAIN_T,
        warm=1, steps=TRANSFER_STEPS)
    same = _same_groups(net.params, before)
    moved = sorted(n for n, s in same.items() if not s)
    log(f"transfer: groups equal to the bit after {1 + TRANSFER_STEPS} "
        f"steps: {sorted(n for n, s in same.items() if s)}; moved: "
        f"{moved} {card}")
    assert all(same[n] for n in frozen), same
    assert len(moved) == len(same) - len(frozen), moved
    log(f"transfer: frozen prefix vs the full fine-tune of phase train's "
        f"step, same run: mean_step_ms {ms:.3f} vs {full_ms:.3f}, "
        f"tokens_per_s {rate:.1f} vs {full_rate:.1f}, "
        f"max_memory_allocated_gb {peak:.3f} vs {full_peak:.3f}, "
        f"optimizer state {_opt_bytes(net) / 2 ** 30:.3f} vs "
        f"{full_opt / 2 ** 30:.3f} GB {card}")
    # 4. the helper: the tied head crosses the split and is refused; a
    #    fresh untied head's tail trained on featurized data against one
    #    full-net step from the same weights
    try:
        TransferLearningHelper(net)
    except ValueError as e:
        assert "crosses" in str(e), e
    else:
        raise AssertionError("a tie across the split was not refused")

    def helper_net():
        return (TransferLearning.builder(net)
                .fine_tune_configuration(FineTuneConfiguration(
                    updater=upd.Sgd(learning_rate=HELPER_LR),
                    learning_rate=HELPER_LR))
                .remove_output_layer()
                .add_layer(RnnOutputLayer(n_out=TRAIN["vocab_size"],
                                          activation="softmax",
                                          loss="sparse_mcxent"))
                .build())

    full, tail_net = helper_net(), helper_net()
    full.conf.compute_dtype = tail_net.conf.compute_dtype = None
    helper = TransferLearningHelper(tail_net)
    split = TRANSFER_FROZEN + 1
    tail = [f"layer_{i}" for i in range(split, len(full.layers))]
    start = {n: tree.map_(torch.clone, full.params[n]) for n in tail}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _tf32(False):
        feats = helper.featurize(DataSet(x, y))
        torch.cuda.synchronize()
        feat_s = time.perf_counter() - t0
        helper.fit_featurized(feats)
        full.fit(x, y)
    worst = max(tree.leaves(tree.map_with_path(
        lambda p, h, f, s: (((h - s) - (f - s)).abs().max().item()
                            / (f - s).abs().max().item(), ".".join(p)),
        {n: helper.net.params[n] for n in tail},
        {n: full.params[n] for n in tail}, start)))
    loss_rel = (abs(helper.unfrozen_mln().score() - full.score())
                / abs(full.score()))
    log(f"transfer: TransferLearningHelper, f32 (TF32 off): featurize "
        f"{tuple(feats.features.shape)} in {feat_s:.2f}s, one "
        f"fit_featurized Sgd step at {HELPER_LR} vs one full-net step: "
        f"loss {helper.unfrozen_mln().score():.6f} vs {full.score():.6f} "
        f"rel={loss_rel:.3e} tol={TRAIN_LOSS_RTOL:.0e}; worst tail update "
        f"{worst[1]} max|dh-df|/max|df|={worst[0]:.3e} "
        f"tol={TRAIN_GRAD_TOL:.0e} {card}")
    assert worst[0] <= TRAIN_GRAD_TOL and loss_rel <= TRAIN_LOSS_RTOL
    assert all(_same_groups(helper.net.params, full.params)[f"layer_{i}"]
               for i in range(split))
    del full, helper, feats, start
    # 5. the zip round trip: written and restored on the card, then 2 more
    #    steps on both, in f32 with TF32 off on the batch's first
    #    ZIP_RESUME_T tokens: K3 adds each dq row's share of every 64-key
    #    tile by atomics, in an order that changes from run to run once
    #    three tiles add (at T = 1024 the f32 steps part in the last bit
    #    of the loss, run A of PR 17); at 128 tokens at most two add onto
    #    zero, which commute, so the step repeats to the bit (as PR 16's
    #    checkpoint phase at T = 128)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "transfer.zip")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ModelSerializer.write_model(net, path, save_updater=True)
        write_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        back = ModelSerializer.restore_multi_layer_network(path)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
    assert back.device.type == "cuda" and back.iteration == net.iteration
    assert sorted(back._frozen()) == frozen
    assert all(back.opt_state[n] == {} for n in frozen)
    for a, b in ((net.params, back.params), (net.opt_state,
                                             back.opt_state)):
        assert all(_same_groups(a, b).values())
    got = []
    xs, ys = x[:, :ZIP_RESUME_T], y[:, :ZIP_RESUME_T]
    with _tf32(False):
        for n in (net, back):
            n.conf.compute_dtype = None
            for _ in range(2):
                n.fit(xs, ys)
                got.append(n.score())
    same_p = _same_groups(net.params, back.params)
    same_s = _same_groups(net.opt_state, back.opt_state)
    log(f"transfer: zip {nbytes} bytes written in {write_s:.1f}s, restored "
        f"on the card in {read_s:.1f}s; 2 more f32 steps each (TF32 off, "
        f"T={ZIP_RESUME_T}): "
        f"losses {got[0]:.6f} {got[1]:.6f} vs restored {got[2]:.6f} "
        f"{got[3]:.6f}; parameters equal to the bit in "
        f"{sum(same_p.values())}/{len(same_p)} groups, optimizer state in "
        f"{sum(same_s.values())}/{len(same_s)} {card}")
    assert got[:2] == got[2:] and all(same_p.values()) \
        and all(same_s.values())
    assert all(math.isfinite(l) for l in losses + got)


def phase_transfer_agree(state):
    """The transferred LM in f32 (TF32 off) at full width, 2 frozen and 2
    trainable blocks, B = 2, T = 256, from the same weights on the card
    and on the CPU: the loss and every gradient of one step (the l1 term
    on the first trainable block), then the update of the card's
    gradient on both (the per-group chains, the max-norm constraint on
    that block), in train_agree's bands; then one ``fit`` step on the
    card; weight noise on the card by its statistics."""
    import math
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.nn import (FineTuneConfiguration,
                                             TransferLearning)
    from deeplearning4j_tpu_torch.nn import updaters as upd
    from deeplearning4j_tpu_torch.nn.constraints import (
        DropConnect, MaxNormConstraint, WeightNoise)
    from deeplearning4j_tpu_torch.nn.multilayer import apply_updates
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    card = state["card"]
    _free_card("transfer_agree", card)
    model = CausalTransformerLM(**dict(TRAIN, n_layers=AGREE_LAYERS))
    x, y = _train_batch(1, 2, 256, model.vocab_size)
    first = AGREE_FROZEN + 1             # the first trainable block
    nets, results = {}, {}
    with _tf32(False):
        for dev in ("cuda", "cpu"):
            net = (TransferLearning.builder(model.init(256, device=dev))
                   .fine_tune_configuration(_transfer_ftc(
                       upd, FineTuneConfiguration))
                   .set_feature_extractor(AGREE_FROZEN).build())
            net.layers[first].l1 = AGREE_L1
            net.layers[first].constraints = [
                MaxNormConstraint(max_norm=AGREE_MAX_NORM)]
            nets[dev] = net
        card_net, cpu_net = nets["cuda"], nets["cpu"]
        before = _host_params(card_net)
        for dev, net in nets.items():
            xt, yt = (torch.as_tensor(a, device=dev) for a in (x, y))
            loss, grads, _ = net._loss_and_grads(xt, yt)
            host = tree.map_(lambda g: g.cpu(), grads)
            # both devices update from the card's gradient (an element
            # within rounding of zero may point either way on the two,
            # and Adam's first step is ~lr whatever its size), as fit's
            # update does: each group's chain, then the constraints
            g = (grads if dev == "cuda" else
                 tree.map_(lambda t: t.to(dev), results["cuda"][1]))
            net.params, net.opt_state = apply_updates(
                net._chains, net.params, g, net.opt_state)
            results[dev] = (loss.item(), host, _host_params(net))
            if dev == "cuda":
                for e in kernel_registry.ported():
                    e.reset()
                net.fit(x, y)                # the entry point, once
                torch.cuda.synchronize()
                launches = {e.key: e.launches()
                            for e in kernel_registry.ported()}
    state.setdefault("launches", {})["transfer_agree"] = launches
    _check_step_launches("transfer_agree", 1, launches, card)
    (l_card, g_card, p_card), (l_cpu, g_cpu, p_cpu) = (results["cuda"],
                                                       results["cpu"])
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    frozen = sorted(card_net._frozen())
    for n in frozen:                     # zeros, as optax's set_to_zero
        assert all(not g.any() for g in tree.leaves(g_card[n])), n
    trained = {n: g for n, g in g_card.items() if n not in frozen}
    g_worst = max(tree.leaves(tree.map_with_path(
        lambda path, a, b: (_rel_err(a, b), ".".join(path)), trained,
        {n: g_cpu[n] for n in trained})))
    p_worst = max(tree.leaves(tree.map_with_path(
        lambda path, a, b: (_rel_err(a, b), ".".join(path)), p_card,
        p_cpu)))
    fitted = _host_params(card_net)
    same = _same_groups(fitted, before)
    norms = [torch.sqrt((w ** 2).sum(0)).max().item() for k, w in
             fitted[f"layer_{first}"]["mha"].items() if w.ndim == 2]
    log(f"transfer_agree: f32 {AGREE_LAYERS} blocks ({AGREE_FROZEN} frozen) "
        f"B=2 T=256, card vs CPU: loss {l_card:.6f} vs {l_cpu:.6f} "
        f"rel={loss_rel:.3e} tol={TRAIN_LOSS_RTOL:.0e}; worst gradient "
        f"{g_worst[1]} {g_worst[0]:.3e}, worst parameter updated from the "
        f"card's gradient {p_worst[1]} {p_worst[0]:.3e} of its max, tol="
        f"{TRAIN_GRAD_TOL:.0e}; after a further fit step on the card, "
        f"frozen groups equal to the bit {[n for n in frozen if same[n]]}"
        f", layer_{first} attention column norms ≤ {max(norms):.6f} "
        f"(max_norm {AGREE_MAX_NORM}) {card}")
    assert loss_rel <= TRAIN_LOSS_RTOL and g_worst[0] <= TRAIN_GRAD_TOL
    assert p_worst[0] <= TRAIN_GRAD_TOL
    assert all(same[n] for n in frozen)
    assert max(norms) <= AGREE_MAX_NORM * (1 + 1e-6)
    # weight noise on the card: the draws differ from the CPU's, so held
    # by their statistics, and the masters untouched by a noisy step
    w = card_net.params[f"layer_{first}"]["Wg"]
    n = WeightNoise(stddev=0.05, mean=0.01).apply({"Wg": w}, 11)["Wg"] - w
    kept = (DropConnect(weight_retain_prob=0.8).apply({"Wg": w}, 12)["Wg"]
            != 0).float().mean().item()
    se = NOISE_SIGMAS / math.sqrt(w.numel())
    masters = _host_params(card_net)
    xt, yt = (torch.as_tensor(a, device="cuda") for a in (x, y))
    with _tf32(False):
        clean = card_net._loss_and_grads(xt, yt, rng=3)[0].item()
        card_net.layers[first].weight_noise = WeightNoise(stddev=0.05)
        noisy = card_net._loss_and_grads(xt, yt, rng=3)[0].item()
        again = card_net._loss_and_grads(xt, yt, rng=3)[0].item()
    log(f"transfer_agree: on the card WeightNoise(0.05, mean 0.01) over "
        f"{tuple(w.shape)}: mean {n.mean().item():.6f} std "
        f"{n.std().item():.6f}; DropConnect(0.8) keep rate {kept:.6f}; "
        f"the loss with WeightNoise(0.05) on layer_{first} {noisy:.6f} "
        f"(without {clean:.6f}), the same from the same seed: "
        f"{noisy == again}; the masters untouched {card}")
    assert abs(n.mean().item() - 0.01) <= 0.05 * se
    assert abs(n.std().item() / 0.05 - 1) <= se / math.sqrt(2)
    assert abs(kept - 0.8) <= math.sqrt(0.8 * 0.2) * se
    assert noisy != clean and noisy == again
    assert all(_same_groups(card_net.params, masters).values())


# -- the masked-LM head and ResNet-50 -----------------------------------------
#: the mlm phase: BERT-base's masked-LM head at B = 32, T = 128 over a
#: WordPiece vocabulary of exactly BERT's 30 522 entries, 2 warm and 8
#: timed steps through ``fit(BertIterator)``, then the same 8 steps from
#: batches built beforehand
MLM_B, MLM_T, MLM_VOCAB = 32, 128, 30522
MLM_WARM, MLM_STEPS = 2, 8
#: BERT pretraining's Adam learning rate (Devlin et al. 2019, with decay
#: 0.01); the zoo's default AdamW 2e-5 is the fine-tuning rate
MLM_LR = 1e-4
#: the synthetic corpus: sentence lengths in words, and the Zipf exponent
#: of the word draw (a frequency law of real text, so that the head has
#: something to learn in a few steps)
MLM_WORDS, MLM_ZIPF = (24, 140), 1.1
#: the mlm_agree batch (card against CPU, f32)
MLM_AGREE_B = 4
#: ResNet-50 at the zoo's published shape: B = 128 synthetic ImageNet
#: images (the TPU bench ran 256; the port's eager graph keeps more
#: saved tensors a batch norm than a fused one does), bf16 compute on f32
#: masters, the zoo's Nesterovs (0.1, 0.9)
RESNET_B, RESNET_HW, RESNET_CLASSES = 128, 224, 1000
RESNET_WARM, RESNET_STEPS = 2, 8
#: resnet_agree: one f32 step at 224², B = 2, card against CPU; the
#: running statistics to 1e-5 relative and the eval output to AGREE_TOL
RESNET_AGREE_B = 2
STATE_RTOL = 1e-5


def _mlm_corpus(seed: int, n_sentences: int):
    """A WordPiece vocabulary of exactly ``MLM_VOCAB`` entries and
    ``n_sentences`` sentences over it, from ``np.random.default_rng(seed)``:
    the five specials, the 26 letters and their ``##`` continuations (so
    every word decomposes), then distinct random lowercase words of 3 to
    10 letters; each sentence ``MLM_WORDS`` words long, the words drawn
    by a Zipf law over their rank."""
    import numpy as np
    from deeplearning4j_tpu_torch.nlp.bert_iterator import SPECIALS
    rng = np.random.default_rng(seed)
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    vocab = {t: i for i, t in enumerate(SPECIALS)}
    for ch in letters:
        for piece in (ch, "##" + ch):
            vocab[piece] = len(vocab)
    words = []
    while len(vocab) < MLM_VOCAB:
        w = "".join(rng.choice(letters, int(rng.integers(3, 11))))
        if w not in vocab:
            vocab[w] = len(vocab)
            words.append(w)
    p = 1.0 / np.arange(1, len(words) + 1) ** MLM_ZIPF
    p /= p.sum()
    sentences = [" ".join(words[i] for i in rng.choice(
        len(words), int(rng.integers(*MLM_WORDS)), p=p))
        for _ in range(n_sentences)]
    return vocab, sentences


class _MaskedCount:
    """An iterator of ``MultiDataSet`` batches passed through, counting
    the scored (labels-mask) positions of each batch it yields: the
    masked-LM loss is a mean over the batch of per-example sums, so a
    step's loss per scored position is ``loss · B / count``."""

    def __init__(self, it):
        self.it, self.counts = it, []

    def reset(self):
        self.it.reset()

    def __iter__(self):
        for mds in self.it:
            self.counts.append(float(mds.labels_masks[0].sum()))
            yield mds


def _kernel_split(prof):
    """(busy ms, {kernel name: (ms, launches)}) of the device kernels,
    memcpys and memsets of a ``torch.profiler`` run (user annotations
    not counted)."""
    import collections
    import torch
    ms, n = collections.Counter(), collections.Counter()
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            ms[e.name] += e.device_time_total / 1e3
            n[e.name] += 1
    return sum(ms.values()), {k: (ms[k], n[k]) for k in ms}


def _pct(part: float, busy: float) -> float:
    """``part`` as a percentage of ``busy`` (nan when the profiler saw no
    device time: a window it could not trace)."""
    return 100 * part / busy if busy else float("nan")


def _head_gemms(n_rows: int, card) -> None:
    """The masked-LM head's three GEMMs alone in bf16 at the mlm step's
    shapes — logits [n, 768] @ [768, V], dX = dZ @ Wᵀ and dW = Xᵀ @ dZ,
    V = 30 522 (not a multiple of 8) — timed by CUDA events and
    profiled once: the cuBLAS kernels they take, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(n_rows, 768, device="cuda", generator=g).bfloat16()
    w = torch.randn(768, MLM_VOCAB, device="cuda", generator=g).bfloat16()
    dz = torch.randn(n_rows, MLM_VOCAB, device="cuda",
                     generator=g).bfloat16()
    calls = {"fwd": lambda: x @ w, "dx": lambda: dz @ w.t(),
             "dw": lambda: x.t() @ dz}
    flops = 2 * n_rows * 768 * MLM_VOCAB
    for name, fn in calls.items():
        ms = time_ms(fn, iters=20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        _, kern = _kernel_split(prof)
        log(f"mlm: head GEMM {name} {n_rows}x768x{MLM_VOCAB} bf16 "
            f"{ms:.4f} ms {flops / ms / 1e9:.1f} TFLOP/s bound "
            f"{bound_ms(flops, 0, PEAK_BF16_FLOPS)[0]:.4f} ms kernels "
            f"{sorted(kern)} {card}")


def phase_mlm(state):
    """BERT-base's masked-LM head at full width trained through the
    entry points a user calls: ``BertBase(...).init_mlm(128)`` (bfloat16
    compute on f32 masters, AdamW at BERT pretraining's 1e-4, dropout
    0.1) fed by ``fit(BertIterator(...))`` over a synthetic corpus of
    BERT's vocabulary size (one-hot [B, T, V] labels, key masks, labels
    masks of the 15 % masked positions); 2 warm and 8 timed steps
    between zeroed and read launch counters (exactly the registry's
    ``mlm`` count a step), then the same 8 steps from batches built
    beforehand (the step without the iterator's batch build), the peak
    memory, the batch build alone, one profiled step and the head's
    GEMMs; ``output`` gives [B, T, V] rows summing to 1."""
    import math
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.nlp import (BertIterator,
                                              BertWordPieceTokenizer)
    from deeplearning4j_tpu_torch.nn import updaters as upd
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.train.listeners import \
        CollectScoresListener
    from deeplearning4j_tpu_torch.zoo.bert import BertBase
    card = state["card"]
    _free_card("mlm", card)
    t0 = time.perf_counter()
    n = MLM_B * (MLM_WARM + 2 * MLM_STEPS)
    vocab, sentences = _mlm_corpus(0, n)
    tok = BertWordPieceTokenizer(vocab)
    assert len(vocab) == MLM_VOCAB

    def iterator(lo, hi, seed):
        return _MaskedCount(BertIterator(
            tok, sentences[lo * MLM_B:hi * MLM_B], batch_size=MLM_B,
            seq_len=MLM_T, seed=seed))

    net = BertBase(seed=2, compute_dtype="bfloat16", updater=upd.AdamW(
        learning_rate=MLM_LR, weight_decay=0.01,
        exclude_bias_and_norm=True)).init_mlm(MLM_T)
    scores = CollectScoresListener()
    net.set_listeners(scores)
    log(f"mlm: init {net.num_params()} params on {net.device}, vocabulary "
        f"{len(vocab)}, {n} sentences {time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    its = [iterator(0, MLM_WARM, 1),
           iterator(MLM_WARM, MLM_WARM + MLM_STEPS, 2),
           iterator(MLM_WARM + MLM_STEPS, MLM_WARM + 2 * MLM_STEPS, 3)]
    net.fit(its[0])                                     # warm steps
    for e in kernel_registry.ported():
        e.reset()
    wall_it = _wall_ms(lambda: net.fit(its[1]))
    launches = {e.key: e.launches() for e in kernel_registry.ported()}
    state.setdefault("launches", {})["mlm"] = launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    t1 = time.perf_counter()
    built = list(its[2])
    build_ms = (time.perf_counter() - t1) * 1e3 / MLM_STEPS
    wall_pre = _wall_ms(lambda: net.fit(built))
    losses = [s for _, s in scores.scores]
    counts = [c for it in its for c in it.counts]
    assert len(losses) == len(counts) == MLM_WARM + 2 * MLM_STEPS
    per_pos = [l * MLM_B / c for l, c in zip(losses, counts)]
    lmask = built[0].labels_masks[0]
    log(f"mlm: losses {' '.join(f'{l:.4f}' for l in losses)}; per scored "
        f"position {' '.join(f'{l:.4f}' for l in per_pos)} {card}")
    log(f"mlm: B={MLM_B} T={MLM_T} V={MLM_VOCAB} steps={MLM_STEPS} "
        f"through fit(BertIterator): mean_step_ms="
        f"{wall_it / MLM_STEPS:.3f} samples_per_s="
        f"{MLM_B * MLM_STEPS / wall_it * 1e3:.1f}; from batches built "
        f"beforehand: mean_step_ms={wall_pre / MLM_STEPS:.3f} "
        f"samples_per_s={MLM_B * MLM_STEPS / wall_pre * 1e3:.1f}; the "
        f"iterator's batch build alone {build_ms:.3f} ms a batch (one-hot "
        f"labels {built[0].labels[0].nbytes / 2 ** 30:.3f} GB); masked "
        f"positions {int(lmask.sum())} of {lmask.size}; "
        f"max_memory_allocated_gb={peak_gb:.3f} {card}")
    assert all(math.isfinite(l) for l in losses), losses
    first, last = np.mean(per_pos[:2]), np.mean(per_pos[-2:])
    assert last < first, (first, last, per_pos)
    _check_step_launches("mlm", MLM_STEPS, launches, card)
    one = built[:1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        net.fit(one)
        torch.cuda.synchronize()
    busy, kern = _kernel_split(prof)
    wall = _wall_ms(lambda: net.fit(one))
    log(f"mlm: profiled step device_busy_ms={busy:.3f} wall_ms={wall:.3f} "
        f"idle_share={1 - busy / wall:.3f} {card}")
    for name, (ms, cnt) in sorted(kern.items(), key=lambda kv: -kv[1][0]
                                  )[:10]:
        log(f"  {ms:9.3f} ms {_pct(ms, busy):5.1f}% x{cnt:<5d} "
            f"{name[:90]}")
    _head_gemms(MLM_B * MLM_T, card)
    b = built[0]
    probs = net.output(*b.features, features_masks=b.features_masks)[0]
    _check_prob_rows("mlm", probs, (MLM_B, MLM_T, MLM_VOCAB),
                        PROB_SUM_TOL["bfloat16"], card)


def _one_step(make, xs, ys, fms=None, lms=None):
    """``(net, loss, gradients, new layer state)`` of one
    ``_loss_and_grads`` of the network ``make()`` builds, the trees
    copied to the host (the step not applied)."""
    from deeplearning4j_tpu_torch import tree
    net = make()
    loss, grads, new_state = net._loss_and_grads(xs, ys, fms, lms)
    return (net, loss.item(), tree.map_(lambda g: g.cpu(), grads),
            tree.map_(lambda g: g.cpu(), new_state))


def _worst_rel(a, b):
    """The largest error of a leaf of ``a`` against the same leaf of
    ``b``, relative to that leaf's largest magnitude, and its path."""
    from deeplearning4j_tpu_torch import tree
    return max(tree.leaves(tree.map_with_path(
        lambda path, x, y: (_rel_err(x, y), ".".join(path)), a, b)),
        default=(0.0, "(none)"))


def _agree_step(name: str, make, xs, ys, fms, lms, card, what="f32"):
    """One step of the network ``make(device)`` builds, on the card and
    on the CPU from the same weights (TF32 off): the loss, every
    gradient and the new layer state, card against CPU, in
    train_agree's bands and ``STATE_RTOL``. Returns the two steps
    (``_one_step``'s tuples), card first."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_step, cpu_step = (_one_step(lambda: make(dev), xs, ys, fms, lms)
                           for dev in ("cuda", "cpu"))
    (_, l_card, g_card, s_card), (_, l_cpu, g_cpu, s_cpu) = (card_step,
                                                             cpu_step)
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst, worst_key = _worst_rel(g_card, g_cpu)
    s_worst, s_key = _worst_rel(s_card, s_cpu)
    log(f"{name}: {what} one step, card vs CPU: loss {l_card:.6f} vs "
        f"{l_cpu:.6f} rel={loss_rel:.3e} tol={TRAIN_LOSS_RTOL:.0e}; worst "
        f"gradient {worst_key} max|d|/max|g|={worst:.3e} "
        f"tol={TRAIN_GRAD_TOL:.0e}; worst running statistic {s_key} "
        f"{s_worst:.3e} tol={STATE_RTOL:.0e} {card}")
    if not (loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_TOL
            and s_worst <= STATE_RTOL):
        raise AssertionError(f"card and CPU step disagree ({name})")
    return card_step, cpu_step


def phase_mlm_agree(state):
    """BERT-base's masked-LM head in f32 (dropout 0, TF32 off), one step
    at B = 4, T = 128 on a ``BertIterator`` batch (key masks, labels
    masks, one-hot labels over 30 522): the card's loss and every
    gradient against the port on the CPU, in train_agree's bands; then
    the card's ``output`` rows sum to 1."""
    from deeplearning4j_tpu_torch.nlp import (BertIterator,
                                              BertWordPieceTokenizer)
    from deeplearning4j_tpu_torch.zoo.bert import BertBase
    card = state["card"]
    _free_card("mlm_agree", card)
    vocab, sentences = _mlm_corpus(1, MLM_AGREE_B)
    b = next(iter(BertIterator(BertWordPieceTokenizer(vocab), sentences,
                               batch_size=MLM_AGREE_B, seq_len=MLM_T,
                               seed=5)))
    model = BertBase(seed=3, dropout=0.0)                 # float32
    (net, *_), _ = _agree_step(
        "mlm_agree", lambda dev: model.init_mlm(MLM_T, device=dev),
        b.features, b.labels, b.features_masks, b.labels_masks, card)
    probs = net.output(*b.features, features_masks=b.features_masks)[0]
    _check_prob_rows("mlm_agree", probs,
                        (MLM_AGREE_B, MLM_T, MLM_VOCAB),
                        PROB_SUM_TOL["float32"], card)


def _resnet_batch(seed: int, b: int, hw: int):
    """Synthetic ImageNet-shaped data from ``np.random.default_rng(seed)``,
    as the repository's ``bench.py`` makes it: standard-normal
    [b, hw, hw, 3] images and one-hot labels over 1000 classes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, hw, hw, 3), dtype=np.float32)
    y = np.eye(RESNET_CLASSES, dtype=np.float32)[
        rng.integers(0, RESNET_CLASSES, b)]
    return x, y


def _conv_layouts(net, x, y):
    """Every 2-D convolution of one forward and backward of ``net``
    (``loss_and_grads``, no update) checked for the channels-last memory
    format of its input and output: the counts of convolutions and of
    those whose input or output is not channels-last."""
    import torch
    from deeplearning4j_tpu_torch.nn.layers import conv as conv_mod
    seen = {"convs": 0, "input_not_cl": 0, "output_not_cl": 0}
    plain = conv_mod._CONV[2]
    cl = torch.channels_last

    def audited(xc, w, **kw):
        out = plain(xc, w, **kw)
        seen["convs"] += 1
        seen["input_not_cl"] += not xc.is_contiguous(memory_format=cl)
        seen["output_not_cl"] += not out.is_contiguous(memory_format=cl)
        return out

    conv_mod._CONV[2] = audited
    try:
        net._loss_and_grads([x], [y])
    finally:
        conv_mod._CONV[2] = plain
    return seen


def _resnet_profile(net, x, y, card) -> None:
    """One ``fit`` step under ``torch.profiler``: the device time split
    into the convolutions (the inclusive device time of
    ``aten::cudnn_convolution`` and ``aten::convolution_backward``),
    batch norm and the other elementwise and reduction kernels
    (PyTorch's ``elementwise``/``reduce`` kernels), and the rest; the
    explicit SAME pads (``aten::constant_pad_nd``, a copy each), the
    cuDNN layout conversions (kernels named ``nchwToNhwc``/``nhwcToNchw``),
    the copy ops and the device-to-device memcpys counted; then the
    memory format around every convolution."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        net.fit(x, y)
        torch.cuda.synchronize()
    busy, kern = _kernel_split(prof)
    ops = {e.key: e for e in prof.key_averages()}

    def dev_ms(key):
        e = ops.get(key)
        return 0.0 if e is None else e.device_time_total / 1e3

    conv = dev_ms("aten::cudnn_convolution") + dev_ms(
        "aten::convolution_backward")
    elem = sum(ms for name, (ms, _) in kern.items()
               if "elementwise" in name or "reduce" in name.lower())
    layout = {name: cnt for name, (_, cnt) in kern.items()
              if "nchwToNhwc" in name or "nhwcToNchw" in name}
    pads = ops.get("aten::constant_pad_nd")
    copies = {k: (ops[k].count, round(dev_ms(k), 3)) for k in (
        "aten::copy_", "aten::clone", "aten::contiguous") if k in ops}
    dtod = kern.get("Memcpy DtoD (Device -> Device)", (0.0, 0))
    wall = _wall_ms(lambda: net.fit(x, y))
    log(f"resnet: profiled step device_busy_ms={busy:.3f} wall_ms="
        f"{wall:.3f} idle_share={1 - busy / wall:.3f}; convolution "
        f"{conv:.3f} ms ({_pct(conv, busy):.1f}%), batch norm and "
        f"elementwise {elem:.3f} ms ({_pct(elem, busy):.1f}%), rest "
        f"{busy - conv - elem:.3f} ms; SAME pads (constant_pad_nd) "
        f"{0 if pads is None else pads.count} calls "
        f"{dev_ms('aten::constant_pad_nd'):.3f} ms; cuDNN layout "
        f"conversions {sum(layout.values())} {sorted(layout)}; copy ops "
        f"(calls, device ms) {copies}; device-to-device memcpys "
        f"{dtod[1]} ({dtod[0]:.3f} ms) {card}")
    for name, (ms, cnt) in sorted(kern.items(), key=lambda kv: -kv[1][0]
                                  )[:10]:
        log(f"  {ms:9.3f} ms {_pct(ms, busy):5.1f}% x{cnt:<5d} "
            f"{name[:90]}")
    log(f"resnet: memory format around the convolutions of one forward "
        f"and backward: {_conv_layouts(net, x, y)} {card}")


def phase_resnet(state):
    """ResNet-50 at the zoo's published shape through the entry points a
    user calls: ``ResNet50(num_classes=1000, input_shape=(224, 224, 3),
    compute_dtype="bfloat16").init()`` (f32 masters, the zoo's Nesterovs
    0.1/0.9) trained by ``fit(x, y)`` on one synthetic ImageNet batch of
    128 from a seed: 2 warm and 8 timed steps between zeroed and read
    launch counters (no ported kernel: convolution, batch norm and
    pooling go to cuDNN and PyTorch's ops), every loss finite, the
    images/s and peak memory, one batch norm's running statistics
    moved from their init; ``output`` in eval mode gives rows summing to
    1; the trained net's zip restored on the card equal to the bit
    (params, state and updater state); one profiled step."""
    import math
    import tempfile
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.serialization import ModelSerializer
    from deeplearning4j_tpu_torch.train.listeners import \
        CollectScoresListener
    from deeplearning4j_tpu_torch.zoo import ResNet50
    card = state["card"]
    _free_card("resnet", card)
    t0 = time.perf_counter()
    net = ResNet50(num_classes=RESNET_CLASSES,
                   input_shape=(RESNET_HW, RESNET_HW, 3),
                   compute_dtype="bfloat16").init()
    xh, yh = _resnet_batch(0, RESNET_B, RESNET_HW)
    x, y = torch.from_numpy(xh).cuda(), torch.from_numpy(yh).cuda()
    scores = CollectScoresListener()
    net.set_listeners(scores)
    log(f"resnet: init {net.num_params()} params on {net.device}, "
        f"{net.conf.updater.to_dict()} "
        f"{time.perf_counter() - t0:.1f}s")
    assert net.num_params() == 25_557_032
    init_stats = tree.map_(torch.clone, net.state["res5_2_c_bn"])
    torch.cuda.reset_peak_memory_stats()
    for _ in range(RESNET_WARM):
        net.fit(x, y)
    for e in kernel_registry.ported():
        e.reset()
    wall = _wall_ms(lambda: [net.fit(x, y) for _ in range(RESNET_STEPS)])
    launches = {e.key: e.launches() for e in kernel_registry.ported()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [s for _, s in scores.scores]
    moved = {k: (net.state["res5_2_c_bn"][k] - init_stats[k]).abs().max()
             .item() for k in ("mean", "var")}
    log(f"resnet: losses {' '.join(f'{l:.4f}' for l in losses)} {card}")
    log(f"resnet: B={RESNET_B} {RESNET_HW}x{RESNET_HW} steps="
        f"{RESNET_STEPS} mean_step_ms={wall / RESNET_STEPS:.3f} "
        f"images_per_s={RESNET_B * RESNET_STEPS / wall * 1e3:.1f} "
        f"max_memory_allocated_gb={peak_gb:.3f}; res5_2_c_bn running "
        f"statistics moved from their init by max|d mean|="
        f"{moved['mean']:.4e} max|d var|={moved['var']:.4e} {card}")
    # finite, as the reference's own ResNet test asks: at lr 0.1 with no
    # warmup the first steps on one random-label batch may climb before
    # they fall, so the losses are printed, not ordered
    assert all(math.isfinite(l) for l in losses), losses
    assert moved["mean"] > 0 and moved["var"] > 0
    assert all(t.dtype == torch.float32 for t in tree.leaves(net.state))
    _check_step_launches("resnet", RESNET_STEPS, launches, card)
    probs = net.output(xh[:32])[0]
    _check_prob_rows("resnet", probs, (32, RESNET_CLASSES),
                        PROB_SUM_TOL["bfloat16"], card)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resnet50.zip")
        t1 = time.perf_counter()
        ModelSerializer.write_model(net, path)
        t2 = time.perf_counter()
        back = ModelSerializer.restore_computation_graph(path)
        t3 = time.perf_counter()
        size = os.path.getsize(path)
    same = {what: all(torch.equal(a, b) for a, b in zip(
        tree.leaves(getattr(back, what)), tree.leaves(getattr(net, what))))
        for what in ("params", "state", "opt_state")}
    log(f"resnet: zip {size} bytes written in {t2 - t1:.3f} s, restored "
        f"on {back.device} in {t3 - t2:.3f} s; equal to the bit {same} "
        f"{card}")
    assert back.device.type == "cuda" and all(same.values())
    del back
    _resnet_profile(net, x, y, card)


def phase_resnet_agree(state):
    """ResNet-50 at 224×224×3, one step at B = 2 from the same weights on
    the card and on the CPU (TF32 off). In float64 (cuDNN's f64
    convolutions on the card): the loss, every gradient and every batch
    norm's new running statistics in train_agree's bands and
    ``STATE_RTOL``. In float32: the loss and the running statistics in
    the same bands; the gradients each device's distance to the CPU's
    f64 gradient, the card's no more than twice the CPU's — the f32
    gradient of this randomly initialised net at B = 2 is itself
    ill-conditioned (batch norm's backward over few samples a channel:
    on either device a leaf lies up to ~20 % of its largest element from
    the f64 one), so no f32 card-vs-CPU band of 1e-3 can hold. Then each
    f32 net's eval-mode ``output`` and the pooled features its head
    reads, with the step's running statistics, card against CPU within
    ``AGREE_TOL``."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.zoo import ResNet50
    card = state["card"]
    _free_card("resnet_agree", card)
    model = ResNet50(num_classes=RESNET_CLASSES,
                     input_shape=(RESNET_HW, RESNET_HW, 3))
    x, y = _resnet_batch(1, RESNET_AGREE_B, RESNET_HW)

    def f64(dev):
        """The f32 net's weights and state in float64."""
        net = model.init(device=dev)
        net.params, net.state = (tree.map_(torch.Tensor.double, t)
                                 for t in (net.params, net.state))
        return net

    _, (_, _, g64, _) = _agree_step(
        "resnet_agree", f64, [x.astype(np.float64)],
        [y.astype(np.float64)], None, None, card, what="f64")
    card32, cpu32 = (_one_step(lambda: model.init(device=dev), [x], [y])
                     for dev in ("cuda", "cpu"))
    loss_rel = abs(card32[1] - cpu32[1]) / abs(cpu32[1])
    s_worst, s_key = _worst_rel(card32[3], cpu32[3])
    (c_err, c_key), (p_err, p_key) = (_worst_rel(step[2], g64)
                                      for step in (card32, cpu32))
    log(f"resnet_agree: f32 one step, card vs CPU: loss {card32[1]:.6f} "
        f"vs {cpu32[1]:.6f} rel={loss_rel:.3e} tol={TRAIN_LOSS_RTOL:.0e}; "
        f"worst running statistic {s_key} {s_worst:.3e} "
        f"tol={STATE_RTOL:.0e}; worst gradient against the CPU's f64 one: "
        f"card {c_key} {c_err:.3e}, CPU {p_key} {p_err:.3e} (card ≤ 2 × "
        f"CPU) {card}")
    assert loss_rel <= TRAIN_LOSS_RTOL and s_worst <= STATE_RTOL
    assert c_err <= 2 * p_err
    outs, pooled = [], []
    for net, _, _, new_state in (card32, cpu32):
        net.state = tree.map_(lambda t: t.to(net.device), new_state)
        outs.append(net.output(x)[0].cpu())
        with torch.no_grad():              # the features the head reads
            acts, _ = net._forward(net.params, net.state, {
                "input": torch.as_tensor(x, device=net.device)},
                train=False, rng=None)
        pooled.append(acts["avgpool"].cpu())
    err, f_err = _rel_err(outs[0], outs[1]), _rel_err(*pooled)
    log(f"resnet_agree: f32 eval mode reading the step's running "
        f"statistics, card vs CPU: output max|d|/max|p|={err:.3e} (largest "
        f"probability {outs[1].max().item():.4f}), pooled features "
        f"{f_err:.3e}, tol={AGREE_TOL:.0e} {card}")
    assert err <= AGREE_TOL and f_err <= AGREE_TOL


# -- the data-parallel ResNet-50 and its serving (BASELINE config #5) --------
#: dp_resnet: ResNet-50 at the resnet phase's shape under ParallelWrapper
#: SYNC at one rank (the card's machine has one H100; config #5's 1 → 32
#: scaling cannot be measured on it), against plain ``fit`` in turns
DP_RESNET_WARM, DP_RESNET_STEPS = 2, 8
#: dp_resnet_agree: f32 (TF32 off, cuDNN's deterministic algorithms) at
#: B = 16, the wrapper and plain ``fit`` from the same weights for 3
#: steps; at one rank the wrapper's statistics are the rank's own rows
#: and its mean over the group a division by one, so the two run the same
#: arithmetic: each parameter leaf and res5_2_c_bn's running mean and
#: variance within 1e-5 of the leaf's largest value (the max-pool
#: backward's atomics may add in another order from run to run)
DP_AGREE_B, DP_AGREE_STEPS, DP_AGREE_TOL = 16, 3, 1e-5
#: inference: ParallelInference BATCHED over the trained ResNet-50 in f32
#: (TF32 off): 64 requests of one image from 8 threads, each result
#: against ``output`` on the 64 stacked images within the band of
#: tests/test_parallel.py:723 (rtol 1e-4, atol 1e-5)
INFER_REQUESTS, INFER_THREADS = 64, 8
INFER_RTOL, INFER_ATOL = 1e-4, 1e-5
INFER_PLAN = "serving:error=RuntimeError:nth=1:max=1"


def _resnet50(dtype="bfloat16"):
    from deeplearning4j_tpu_torch.zoo import ResNet50
    return ResNet50(num_classes=RESNET_CLASSES,
                    input_shape=(RESNET_HW, RESNET_HW, 3),
                    compute_dtype=dtype).init()


def _dp_resnet_profile(steps, card) -> None:
    """One step of each of ``steps`` ({name: step}) under
    ``torch.profiler``: device busy ms, kernel launches and the host ops
    the wrapper adds (c10d all-reduces, divisions, copies), beside a
    second step's wall from a synchronised card to a synchronised card;
    then the kernels whose summed time differs most between the two."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    kerns = {}
    for name, step in steps.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        busy, kerns[name] = _kernel_split(prof)
        ops = collections.Counter(e.key for e in prof.key_averages()
                                  for _ in range(e.count))
        wall = _wall_ms(step)
        host = {k: ops[k] for k in ("c10d::allreduce_", "aten::div",
                                    "aten::contiguous", "aten::copy_",
                                    "aten::clone", "cudaLaunchKernel")}
        log(f"dp_resnet: profiled {name} step device_busy_ms={busy:.3f} "
            f"wall_ms={wall:.3f} idle_share={1 - busy / wall:.3f} "
            f"kernels={sum(n for _, n in kerns[name].values())} host ops "
            f"{host} {card}")
    w, p = kerns["wrapper"], kerns["plain"]
    diff = sorted(((w.get(k, (0, 0))[0] - p.get(k, (0, 0))[0], k)
                   for k in set(w) | set(p)), reverse=True)[:6]
    for d, k in diff:
        log(f"  wrapper - plain {d:+9.3f} ms x{w.get(k, (0, 0))[1]}/"
            f"{p.get(k, (0, 0))[1]} {k[:90]}")


def phase_dp_resnet(state):
    """ResNet-50 (the resnet phase's net: 224², bf16 compute on f32
    masters, the zoo's Nesterovs) under ``ParallelWrapper(net,
    mesh=data_parallel_mesh())`` in SYNC at one rank, through ``fit`` on
    one synthetic ImageNet batch of 128 on the host (each step copies it
    to the card, on both sides): 2 warm steps, then 8 timed ones
    taken in turns with 8 steps of plain ``fit`` on a second net from the
    same seed (wrapper, plain, plain, wrapper, ...), each step timed from
    a synchronised card to a synchronised card; ms a step, images/s and
    each net's peak memory over what was allocated before it; the
    wrapper's overhead, and one profiled step of each. The launch
    counters, zeroed just before each of the wrapper's timed steps and
    read just after it, sum to 0 for every ported kernel (conv, batch
    norm and pooling go to cuDNN and PyTorch's ops). Every loss finite, the
    running statistics moved. The trained net stays for the inference
    phase."""
    import math
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.train.listeners import \
        CollectScoresListener
    card = state["card"]
    _free_card("dp_resnet", card)
    mesh = _dp_mesh(state)
    # one host batch, as a user's loader hands it to both: each step
    # copies it to the card
    xh, yh = _resnet_batch(0, RESNET_B, RESNET_HW)
    batch = [DataSet(xh, yh)]
    peaks = {}

    def build(name):
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        net = _resnet50()
        scores = CollectScoresListener()
        net.set_listeners(scores)
        if name == "wrapper":
            w = ParallelWrapper(net, mesh=mesh)
            step = lambda: w.fit(batch)
        else:
            step = lambda: net.fit(xh, yh)
        for _ in range(DP_RESNET_WARM):
            step()
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        return net, step, scores

    net, w_step, w_scores = build("wrapper")
    log(f"dp_resnet: ParallelWrapper mode=sync world={mesh.size('data')} "
        f"over {net.num_params()} params {card}")
    init_stats = tree.map_(torch.clone, net.state["res5_2_c_bn"])
    plain, p_step, _ = build("plain")
    times = {"wrapper": [], "plain": []}
    order = ["wrapper", "plain", "plain", "wrapper"] * (DP_RESNET_STEPS // 2)
    # the counters are zeroed just before each wrapper step and read just
    # after it: the sum covers the wrapper's timed steps alone
    launches = {e.key: 0 for e in kernel_registry.ported()}
    for name in order:
        if name == "wrapper":
            for e in kernel_registry.ported():
                e.reset()
            times[name].append(_wall_ms(w_step))
            for e in kernel_registry.ported():
                launches[e.key] += e.launches()
        else:
            times[name].append(_wall_ms(p_step))
    losses = [s for _, s in w_scores.scores]
    _dp_resnet_profile({"wrapper": w_step, "plain": p_step}, card)
    del plain, p_step
    moved = {k: (net.state["res5_2_c_bn"][k] - init_stats[k]).abs().max()
             .item() for k in ("mean", "var")}
    ms = {k: statistics.mean(v) for k, v in times.items()}
    for name in ("wrapper", "plain"):
        log(f"dp_resnet: {name} B={RESNET_B} {RESNET_HW}x{RESNET_HW} "
            f"steps={DP_RESNET_STEPS} mean_step_ms={ms[name]:.3f} "
            f"median_step_ms={statistics.median(times[name]):.3f} "
            f"images_per_s={RESNET_B / ms[name] * 1e3:.1f} "
            f"peak_gb={peaks[name]:.3f} {card}")
    log(f"dp_resnet: wrapper overhead {ms['wrapper'] - ms['plain']:.3f} ms "
        f"a step ({100 * (ms['wrapper'] / ms['plain'] - 1):.2f} %) in "
        f"turns; losses {' '.join(f'{l:.4f}' for l in losses)}; "
        f"res5_2_c_bn moved by max|d mean|={moved['mean']:.4e} max|d var|="
        f"{moved['var']:.4e} {card}")
    assert all(math.isfinite(l) for l in losses), losses
    assert len(losses) == DP_RESNET_WARM + DP_RESNET_STEPS
    assert moved["mean"] > 0 and moved["var"] > 0
    _check_step_launches("dp_resnet", DP_RESNET_STEPS, launches, card)
    state["dp_resnet_net"] = net


def phase_dp_resnet_agree(state):
    """ResNet-50 at 224² in f32 (TF32 off, cuDNN's deterministic
    algorithms), B = 16: ``DP_AGREE_STEPS`` steps of ``ParallelWrapper``
    SYNC at one rank against as many of plain ``fit`` on a second net
    from the same seed and batches. At one rank the two must agree: every
    parameter leaf and one batch norm's (res5_2_c_bn) running mean and
    variance within ``DP_AGREE_TOL`` of the leaf's largest value."""
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    card = state["card"]
    _free_card("dp_resnet_agree", card)
    mesh = _dp_mesh(state)
    det = torch.backends.cudnn.deterministic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        nets = [_resnet50(None) for _ in range(2)]
        w = ParallelWrapper(nets[0], mesh=mesh, prefetch_buffer=0)
        losses = {"wrapper": [], "plain": []}
        for i in range(DP_AGREE_STEPS):
            xh, yh = _resnet_batch(10 + i, DP_AGREE_B, RESNET_HW)
            w.fit([DataSet(xh, yh)])
            nets[1].fit(xh, yh)
            losses["wrapper"].append(nets[0].score())
            losses["plain"].append(nets[1].score())
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = det
    worst = {}
    for what in ("params", "state"):
        a, b = (getattr(n, what) for n in nets)
        if what == "state":
            a, b = a["res5_2_c_bn"], b["res5_2_c_bn"]
        errs = [(_rel_err(p, q), k) for (k, p), (_, q) in zip(
            _named(a), _named(b))]
        worst[what] = max(errs)
    same = all(torch.equal(p, q) for p, q in zip(
        tree.leaves(nets[0].params), tree.leaves(nets[1].params)))
    log(f"dp_resnet_agree: f32 B={DP_AGREE_B} {DP_AGREE_STEPS} steps, "
        f"ParallelWrapper SYNC at one rank vs plain fit: losses "
        f"{losses['wrapper']} vs {losses['plain']}; worst param leaf "
        f"{worst['params'][1]} {worst['params'][0]:.3e}, res5_2_c_bn "
        f"{worst['state'][1]} {worst['state'][0]:.3e} (max|d|/max|x|, "
        f"tol={DP_AGREE_TOL:.0e}); params equal to the bit: {same} {card}")
    assert worst["params"][0] <= DP_AGREE_TOL
    assert worst["state"][0] <= DP_AGREE_TOL


def phase_inference(state):
    """``ParallelInference`` BATCHED (``batch_limit`` 32, buckets up to
    32) serving the ResNet-50 that dp_resnet trained, in f32 (its
    ``compute_dtype`` cleared, TF32 off): 64 requests of one 224² image
    ([1, 224, 224, 3]) from 8 threads, 8 each; every result against
    ``net.output`` on the 64 stacked images within (INFER_RTOL,
    INFER_ATOL); p50/p99 request latency and images/s; the batches the
    worker formed (``dl4j_tpu_inference_batch_size``); the launch
    counters, zeroed just before the 64 requests and read just after
    them, read each ported kernel's registry count for ``inference`` (0
    for all: the forward runs cuDNN and PyTorch's ops). Then under
    ``INFER_PLAN`` a request fails fast with the injected error, the
    fault counter moves by one, and the same worker serves the next
    request, its result the direct output's row."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.obs import metrics
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.resilience import faults
    card = state["card"]
    net = state.pop("dp_resnet_net", None)
    assert net is not None, "inference serves the net dp_resnet trained"
    _free_card("inference", card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net.conf.compute_dtype = None
    xh, _ = _resnet_batch(3, INFER_REQUESTS, RESNET_HW)
    direct = net.output(xh)[0].cpu().numpy()
    hist = metrics.INFER_BATCH._children[()]
    n0, s0 = hist.count, hist.sum
    pi = ParallelInference(net, batch_limit=32)
    try:
        pi.output(xh[:1], timeout=120)              # first use, untimed
        n0, s0 = hist.count, hist.sum
        results, lat = [None] * INFER_REQUESTS, [None] * INFER_REQUESTS

        def client(t):
            for i in range(t, INFER_REQUESTS, INFER_THREADS):
                t0 = time.perf_counter()
                results[i] = pi.output(xh[i:i + 1], timeout=120)
                lat[i] = time.perf_counter() - t0

        for e in kernel_registry.ported():
            e.reset()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(INFER_THREADS) as ex:
            list(ex.map(client, range(INFER_THREADS)))
        wall = time.perf_counter() - t0
        launches = {e.key: e.launches() for e in kernel_registry.ported()}
        batches, examples = hist.count - n0, hist.sum - s0
        got = np.concatenate([r[0] for r in results])
        err = np.abs(got - direct).max()
        close = np.allclose(got, direct, rtol=INFER_RTOL, atol=INFER_ATOL)
        lat_ms = np.array(lat) * 1e3
        log(f"inference: ParallelInference batched, {INFER_REQUESTS} "
            f"requests of [1,{RESNET_HW},{RESNET_HW},3] f32 from "
            f"{INFER_THREADS} threads in {wall:.3f} s: images_per_s="
            f"{INFER_REQUESTS / wall:.1f} p50_ms="
            f"{np.percentile(lat_ms, 50):.3f} p99_ms="
            f"{np.percentile(lat_ms, 99):.3f}; {batches:g} batches of "
            f"{examples / max(batches, 1):.2f} images on average; max|d| "
            f"vs output on the stacked batch {err:.3e} (rtol="
            f"{INFER_RTOL:.0e}, atol={INFER_ATOL:.0e}): {close} {card}")
        assert close and examples == INFER_REQUESTS
        _check_step_launches("inference", INFER_REQUESTS, launches, card,
                             unit="requests")
        worker = pi._worker
        f0 = metrics.FAULTS_INJECTED.labels(site="serving").get()
        with faults.active(INFER_PLAN):
            t0 = time.perf_counter()
            try:
                pi.output(xh[:1], timeout=60)
            except RuntimeError as e:
                failed = (str(e), time.perf_counter() - t0)
            else:
                failed = None
        fired = metrics.FAULTS_INJECTED.labels(site="serving").get() - f0
        after = pi.output(xh[5:6], timeout=60)[0]
        ok_after = np.allclose(after, direct[5:6], rtol=INFER_RTOL,
                               atol=INFER_ATOL)
        alive = pi._worker is worker and worker.is_alive()
        log(f"inference: plan {INFER_PLAN}: the request failed with "
            f"{failed}, FAULTS_INJECTED{{site=serving}} +{fired:g}; then "
            f"the same worker ({alive}) served the next request, equal to "
            f"the direct output: {ok_after} {card}")
        assert failed is not None and "injected fault" in failed[0]
        assert failed[1] < 5.0 and fired == 1 and alive and ok_after
    finally:
        faults.reset()
        pi.shutdown()


# -- head dims between the kernels' own (ROADMAP C11) -------------------------
#: attn_dims: the head dims off K1's 16, 32, 64, 128 and 256 (zero-padded
#: to the next one inside the launch helpers) and 256 itself, the shape of
#: their kernel cases (GQA), and the timed shape (the train path's rows
#: and heads)
ATTN_DIMS = (2, 24, 48, 80, 96, 160, 256)
ATTN_B, ATTN_T, ATTN_H, ATTN_HKV = 2, 200, 4, 2
ATTN_TIMED_T = 2048
#: the reference's SelfAttentionLayer(n_out=4, n_heads=2): head dim 2,
#: one forward and backward on the card (K1, K3; f32, TF32 off) against
#: the port on the CPU (the einsum): max |d| over the largest value
#: within FLASH_TOL's f32 band (f32 sums in another order, __expf)
ATTN_LAYER_B, ATTN_LAYER_T = 4, 37


def phase_attn_dims(state):
    """K1, K3 and the K4/K5 pair at head dims ``ATTN_DIMS`` in bfloat16
    and float32, causal and key-masked, [2, 200, 4 heads on 2 kv heads],
    each against its plain version at the real dim (the bands of the
    kernels phase); K1 timed at [1, 2048, 6, D] bf16 causal beside SDPA
    at the real dim. Then ``SelfAttentionLayer(n_out=4, n_heads=2)`` (head
    dim 2) forward and backward on the card against the port on the CPU,
    between zeroed and read launch counters: K1 and K3 once each and no
    other kernel, so the einsum did not take it."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        SelfAttentionLayer
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.ops import kernel_registry
    card = state["card"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for d in ATTN_DIMS:
        for dname in ("bfloat16", "float32"):
            dt = getattr(torch, dname)
            for j, (causal, masked) in enumerate(((True, False),
                                                  (False, True))):
                for e in kernel_registry.ported():
                    e.reset()
                q, k, v, out, lse, do, mask = _flash_bwd_case(
                    dt, ATTN_B, ATTN_T, ATTN_H, ATTN_HKV, causal, masked,
                    700 + 10 * d + j, d=d)
                kw = dict(causal=causal, mask=mask)
                ref_out, ref_lse = ck.flash_attention_reference(
                    q, k, v, return_lse=True, **kw)
                fused = ck.flash_attention_bwd(q, k, v, out, lse, do, **kw)
                split = (ck.flash_attention_bwd_dq(q, k, v, out, lse, do,
                                                   **kw),
                         *ck.flash_attention_bwd_dkv(q, k, v, out, lse, do,
                                                     **kw))
                ref = ck.flash_attention_bwd_reference(q, k, v, out, lse,
                                                       do, **kw)
                torch.cuda.synchronize()
                case_launches = {e.key: e.launches()
                                 for e in kernel_registry.ported()}
                case_want = {e.key: 0 for e in kernel_registry.ported()}
                case_want.update(K1=1, K3=1, K4=1, K5=1)
                if case_launches != case_want:
                    raise AssertionError(
                        f"attn_dims D={d} {dname}: launches "
                        f"{case_launches}, expected {case_want}")
                o_err = (out.float() - ref_out.float()).abs().max().item()
                lse_err = (lse - ref_lse).abs().max().item()
                r3 = max(_rel_err(a, r) for a, r in zip(fused, ref))
                r45 = max(_rel_err(a, r) for a, r in zip(split, ref))
                finite = all(bool(torch.isfinite(x).all())
                             for x in (out, lse, *fused, *split))
                line = (f"attn_dims D={d} {dname} [{ATTN_B},{ATTN_T},"
                        f"{ATTN_H},{d}] Hkv={ATTN_HKV} causal={causal} "
                        f"mask={masked} (kernel dim {ck._kernel_dim(d)}): "
                        f"K1 out max_abs_err={o_err:.3e} tol="
                        f"{FLASH_TOL[dname]:.0e} lse {lse_err:.3e} tol="
                        f"{LSE_TOL:.0e}; K3 rel={r3:.3e} K4+K5 rel={r45:.3e}"
                        f" tol={K3_TOL[dname]:.0e} {card}")
                log(line)
                if not (o_err <= FLASH_TOL[dname] and lse_err <= LSE_TOL
                        and r3 <= K3_TOL[dname] and r45 <= K3_TOL[dname]
                        and finite):
                    raise AssertionError(f"a flash kernel disagrees with "
                                         f"its plain version: {line}")
        q, k, v, _ = _flash_case(torch.bfloat16, ATTN_TIMED_T, 6, 6, True,
                                 False, 900 + d)
        q, k, v = (x[..., :d].contiguous() for x in (q, k, v))
        t_k = device_ms(lambda: ck.flash_attention(q, k, v, causal=True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        t_l = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        flops = 4 * d * 6 * ATTN_TIMED_T * (ATTN_TIMED_T + 1) / 2
        b_ms, b_by = bound_ms(flops, 4 * q.numel() * q.element_size(),
                              PEAK_BF16_FLOPS)
        log(f"attn_dims K1 bfloat16 [1,{ATTN_TIMED_T},6,{d}] causal "
            f"(run at {ck._kernel_dim(d)}): kernel_ms={t_k:.4f} "
            f"sdpa_ms={t_l:.4f} kernel/sdpa={t_k / t_l:.2f} bound_ms="
            f"{b_ms:.5f}({b_by}) {_rate(flops, t_k, b_ms)} {card}")
    # the reference's layer at head dim 2, card against CPU
    layer = SelfAttentionLayer(n_out=4, n_heads=2)
    params, _, _ = layer.init(torch.Generator().manual_seed(0),
                              (ATTN_LAYER_T, 4))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((ATTN_LAYER_B, ATTN_LAYER_T, 4)).astype(
        np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    mask = (rng.random((ATTN_LAYER_B, ATTN_LAYER_T)) > 0.3).astype(
        np.float32)
    mask[:, 0] = 1

    def run(dev):
        p = {k_: t.to(dev).requires_grad_() for k_, t in params.items()}
        xt = torch.tensor(x, device=dev, requires_grad=True)
        y, _ = layer.apply(p, {}, xt, mask=torch.tensor(mask, device=dev))
        (y * torch.tensor(w, device=dev)).sum().backward()
        return [y.detach().cpu(), xt.grad.cpu(),
                *(p[k_].grad.cpu() for k_ in sorted(p))]

    for e in kernel_registry.ported():
        e.reset()
    card_out = run("cuda")
    torch.cuda.synchronize()
    launches = {e.key: e.launches() for e in kernel_registry.ported()}
    cpu_out = run("cpu")
    errs = [_rel_err(a, b) for a, b in zip(card_out, cpu_out)]
    log(f"attn_dims: SelfAttentionLayer(n_out=4, n_heads=2) (head dim 2) "
        f"B={ATTN_LAYER_B} T={ATTN_LAYER_T} key-masked, card vs CPU: max|d|"
        f"/max|x| of y, dx, {', '.join('d' + k_ for k_ in sorted(params))}"
        f" = {', '.join(f'{e:.3e}' for e in errs)} tol="
        f"{FLASH_TOL['float32']:.0e} {card}")
    want = {e.key: 0 for e in kernel_registry.ported()}
    want.update(K1=1, K3=1)
    log(f"attn_dims: the layer's launches {launches} (expected {want}) "
        f"{card}")
    assert max(errs) <= FLASH_TOL["float32"], errs
    assert launches == want, launches


# -- the char-RNN ------------------------------------------------------------
#: the BASELINE's config #3 (``tools/perf_dossier.py:379-410``): the
#: GravesLSTM char-RNN at its published widths, B = 64 sequences of 200
#: characters, truncated BPTT in segments of 50
CHARRNN = dict(vocab_size=77, hidden=512, layers=2, tbptt=50)
CHARRNN_B, CHARRNN_T = 64, 200
CHARRNN_WARM, CHARRNN_BATCHES = 2, 8
#: greedy characters generated one ``rnn_time_step`` at a time
CHARRNN_GEN = 200
#: the seeded Markov text: each character has this many successors,
#: equally likely, so that the loss has something to fall to
CHARRNN_SUCCESSORS = 4
#: charrnn_agree: one tBPTT batch card vs CPU (B, T; k = 50), its Sgd
#: rate, and the stored-state steps compared after it
CHARRNN_AGREE_B, CHARRNN_AGREE_T, CHARRNN_AGREE_LR = 4, 100, 0.1
CHARRNN_AGREE_STEPS = 16
#: the output probabilities of 16 stored-state steps, card vs CPU in
#: f32: f32 sums in another order through 2 × 512-wide cells a step
CHARRNN_STEP_TOL = 2e-3
#: the golden zip's forward (a 16-wide GravesLSTM over 20 steps) on the
#: card against the probabilities minted by the JAX package on a CPU:
#: f32 in another summation order, ~1e-7 a step
CHARRNN_GOLDEN_TOL = 1e-5


def _charrnn_text(seed: int, n: int, b: int, t: int, vocab: int):
    """``n`` batches of one-hot [b, t, vocab] characters and their
    next characters, from ``np.random.default_rng(seed)``: a Markov text
    in which each character has ``CHARRNN_SUCCESSORS`` successors, drawn
    alike. Returns ([(x, y)], the successor table)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, (vocab, CHARRNN_SUCCESSORS))
    ids = np.empty((n * b, t + 1), np.int64)
    ids[:, 0] = rng.integers(0, vocab, n * b)
    for j in range(1, t + 1):
        ids[:, j] = succ[ids[:, j - 1],
                         rng.integers(0, CHARRNN_SUCCESSORS, n * b)]
    eye = np.eye(vocab, dtype=np.float32)
    return ([(eye[ids[i * b:(i + 1) * b, :-1]],
              eye[ids[i * b:(i + 1) * b, 1:]]) for i in range(n)], succ)


def _is_gemm(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in ("gemm", "gemv", "xmma", "cutlass"))


def _greedy(net, first: int, n: int):
    """``n`` greedy characters from ``first``, one ``rnn_time_step`` a
    character, the next input built on the card (no read-back); returns
    the ids on the card."""
    import torch
    vocab = net.layers[-1].n_out
    net.rnn_clear_previous_state()
    cur = torch.nn.functional.one_hot(
        torch.tensor([first], device=net.device), vocab).float()
    out = []
    for _ in range(n):
        nxt = net.rnn_time_step(cur).argmax(-1)
        out.append(nxt)
        cur = torch.nn.functional.one_hot(nxt, vocab).float()
    return torch.cat(out)


def phase_charrnn(state):
    """The BASELINE's config #3 through the entry points a user calls:
    ``TextGenerationLSTM(**CHARRNN).init()`` → ``fit(x, y)`` (truncated
    BPTT, 4 segments a batch) → ``rnn_time_step`` generation. The
    batches lie on the card before the timing, so a batch's time is the
    four segments' updates. No ported kernel may launch."""
    import math
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    card = state["card"]
    _free_card("charrnn", card)
    v, b, t = CHARRNN["vocab_size"], CHARRNN_B, CHARRNN_T
    host, succ = _charrnn_text(0, CHARRNN_WARM + CHARRNN_BATCHES, b, t, v)
    batches = [(torch.as_tensor(x, device="cuda"),
                torch.as_tensor(y, device="cuda")) for x, y in host]
    net = TextGenerationLSTM(**CHARRNN).init()
    segments = -(-t // net.conf.tbptt_fwd_length)
    losses = []

    def fit(group):
        for x, y in group:
            net.fit(x, y)
            losses.append(net.score_)

    fit(batches[:CHARRNN_WARM])
    torch.cuda.reset_peak_memory_stats()
    for e in kernel_registry.ported():
        e.reset()
    wall = _wall_ms(lambda: fit(batches[CHARRNN_WARM:]))
    launches = {e.key: e.launches() for e in kernel_registry.ported()}
    state.setdefault("launches", {})["charrnn"] = launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_char = [l / net.conf.tbptt_fwd_length for l in losses]
    ms = wall / CHARRNN_BATCHES
    log(f"charrnn: {net.num_params()} params on {net.device}; losses "
        f"a character (last segment) "
        f"{' '.join(f'{l:.4f}' for l in per_char)} (ln {v} = "
        f"{math.log(v):.4f}, the text's entropy ln "
        f"{CHARRNN_SUCCESSORS} = {math.log(CHARRNN_SUCCESSORS):.4f}) "
        f"{card}")
    log(f"charrnn: B={b} T={t} k={net.conf.tbptt_fwd_length} "
        f"batches={CHARRNN_BATCHES} ms_per_batch={ms:.3f} "
        f"ms_per_segment={ms / segments:.3f} "
        f"chars_per_s={b * t / ms * 1e3:.1f} "
        f"max_memory_allocated_gb={peak:.3f}; dossier FLOPs a batch "
        f"{_charrnn_flops() / 1e12:.4f} TFLOP, bound at the f32 peak "
        f"{bound_ms(_charrnn_flops(), 0, PEAK_F32_FLOPS)[0]:.3f} ms {card}")
    assert all(math.isfinite(l) for l in losses), losses
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
    _check_step_launches("charrnn", CHARRNN_BATCHES, launches, card)
    x, y = batches[-1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        net.fit(x, y)
        torch.cuda.synchronize()
    busy, kern = _kernel_split(prof)
    one = statistics.median(_wall_ms(lambda: net.fit(x, y))
                            for _ in range(3))
    n_kern = sum(cnt for name, (_, cnt) in kern.items()
                 if not name.startswith(("Memcpy", "Memset")))
    gemm = sum(ms_ for name, (ms_, _) in kern.items() if _is_gemm(name))
    elem = sum(ms_ for name, (ms_, _) in kern.items()
               if not _is_gemm(name) and ("elementwise" in name
                                          or "reduce" in name.lower()))
    log(f"charrnn: profiled batch device_busy_ms={busy:.3f} wall_ms="
        f"{one:.3f} (median of 3 unprofiled) idle_share="
        f"{1 - busy / one:.3f} kernel_launches="
        f"{n_kern} ({n_kern / segments:.0f} a segment); GEMM {gemm:.3f} "
        f"ms ({_pct(gemm, busy):.1f}%), elementwise and reductions "
        f"{elem:.3f} ms ({_pct(elem, busy):.1f}%), rest "
        f"{busy - gemm - elem:.3f} ms {card}")
    for name, (ms_, cnt) in sorted(kern.items(), key=lambda kv: -kv[1][0]
                                   )[:8]:
        log(f"  {ms_:9.3f} ms {_pct(ms_, busy):5.1f}% x{cnt:<6d} "
            f"{name[:90]}")
    for e in kernel_registry.ported():
        e.reset()
    first = int(np.argmax(host[0][0][0, 0]))
    _greedy(net, first, 3)                          # warm
    box = {}
    gen_ms = _wall_ms(lambda: box.update(ids=_greedy(net, first,
                                                     CHARRNN_GEN)))
    again = _greedy(net, first, CHARRNN_GEN)
    assert all(e.launches() == 0 for e in kernel_registry.ported())
    chars = [first] + box["ids"].tolist()
    legal = np.mean([c in succ[p] for p, c in zip(chars, chars[1:])])
    log(f"charrnn: {CHARRNN_GEN} greedy characters through rnn_time_step "
        f"(B=1): ms_per_step={gen_ms / CHARRNN_GEN:.3f} chars_per_s="
        f"{CHARRNN_GEN / gen_ms * 1e3:.1f}; transitions the text allows "
        f"{legal:.3f}; first 24 ids {chars[:24]} {card}")
    assert torch.equal(box["ids"], again), "greedy generation not repeatable"
    assert all(0 <= c < v for c in chars)


def _charrnn_flops() -> float:
    """A batch's operations by ``tools/perf_dossier.py:406-408``: the
    2-layer 512-wide cell's GEMMs, forward and backward (3×)."""
    v, d = CHARRNN["vocab_size"], CHARRNN["hidden"]
    return (3 * 2 * (4 * (v * d + d * d) + 4 * 2 * d * d)
            * CHARRNN_T * CHARRNN_B)


def _charrnn_agree_tbptt(card) -> None:
    """One tBPTT batch of the char-RNN on the card and on the CPU from
    the same weights (the zoo's configuration, Sgd in place of Adam: run
    free, Adam steps a gradient element within f32 rounding of zero by
    about its rate either way, see ``_sweep_step``), then the stored-state
    steps."""
    import torch
    from deeplearning4j_tpu_torch.nn import updaters as upd
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    v = CHARRNN["vocab_size"]
    [(x, y)], _ = _charrnn_text(1, 1, CHARRNN_AGREE_B, CHARRNN_AGREE_T, v)
    nets = {}
    for dev in ("cuda", "cpu"):
        conf = TextGenerationLSTM(**CHARRNN).conf()
        conf.updater = upd.Sgd(learning_rate=CHARRNN_AGREE_LR)
        nets[dev] = MultiLayerNetwork(conf).init(input_shape=(None, v),
                                                 device=dev)
        nets[dev].fit(x, y)
    l_card, l_cpu = nets["cuda"].score_, nets["cpu"].score_
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst, key = _worst_param(nets["cuda"].params, nets["cpu"].params)
    outs = {}
    for dev, net in nets.items():
        net.rnn_clear_previous_state()
        outs[dev] = torch.stack([net.rnn_time_step(x[:, i]).cpu()
                                 for i in range(CHARRNN_AGREE_STEPS)])
    step_err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    log(f"charrnn_agree: one tBPTT batch B={CHARRNN_AGREE_B} "
        f"T={CHARRNN_AGREE_T} k={nets['cpu'].conf.tbptt_fwd_length} f32, "
        f"card vs CPU: last segment's loss {l_card:.6f} vs {l_cpu:.6f} "
        f"rel={loss_rel:.3e} tol={TRAIN_LOSS_RTOL:.0e}; worst parameter "
        f"{key} max|d|/max|p|={worst:.3e} tol={TRAIN_GRAD_TOL:.0e}; "
        f"{CHARRNN_AGREE_STEPS} rnn_time_step outputs max|d|={step_err:.3e}"
        f" tol={CHARRNN_STEP_TOL:.0e} {card}")
    assert loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_TOL
    assert step_err <= CHARRNN_STEP_TOL


def _charrnn_att_net(dev):
    """SelfAttentionLayer → LSTM → RecurrentAttentionLayer →
    LearnedSelfAttentionLayer → RnnOutputLayer, n_out 256 and 4 heads of
    64 each, on ``dev`` (f32). Each attention reads rows that differ: a
    self-attention at its initial weights averages its values near
    uniformly, so behind one the keys of the next attention would be
    alike, its softmax flat whatever the query, and its query and key
    gradients a cancellation residue (~1e-9 of the others, measured on
    the CPU against f64) that f32 rounding decides on either device; the
    LSTM's recurrence makes the rows differ again."""
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import kernel_registry
    t = kernel_registry.CHARRNN_ATT_T
    conf = (NeuralNetConfiguration.builder().seed(9).list()
            .layer(L.SelfAttentionLayer(n_out=256, n_heads=4))
            .layer(L.LSTM(n_out=256))
            .layer(L.RecurrentAttentionLayer(n_out=256, n_heads=4))
            .layer(L.LearnedSelfAttentionLayer(n_out=256, n_heads=4,
                                               n_queries=4))
            .layer(L.RnnOutputLayer(n_out=8, activation="softmax",
                                    loss="mcxent"))
            .set_input_type(InputType.recurrent(32, t)).build())
    return MultiLayerNetwork(conf).init(device=dev)


def phase_charrnn_agree(state):
    """The char-RNN and the reference's attention layers in f32, TF32
    off: the tBPTT batch and stored-state steps card vs CPU; the golden
    zip on the card; the attention net's step card vs CPU, its K1 and K3
    launches exact."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    card = state["card"]
    _free_card("charrnn_agree", card)
    with _tf32(False):
        _charrnn_agree_tbptt(card)
        base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "resources", "pretrained")
        golden = TextGenerationLSTM.init_pretrained(base_dir=base)
        io = np.load(os.path.join(base, "TextGenerationLSTM",
                                  "default_golden_io.npz"))
        err = float(np.abs(golden.output(io["x"]).cpu().numpy()
                           - io["y"]).max())
        log(f"charrnn_agree: golden TextGenerationLSTM zip restored on "
            f"{golden.device}: output {tuple(io['y'].shape)} against the "
            f"minting forward max|d|={err:.3e} tol={CHARRNN_GOLDEN_TOL:.0e}"
            f" {card}")
        assert golden.device.type == "cuda" and err <= CHARRNN_GOLDEN_TOL
        t = kernel_registry.CHARRNN_ATT_T
        rng = np.random.default_rng(4)
        x = rng.standard_normal((2, t, 32)).astype(np.float32)
        y = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (2, 4))]
        fm = (np.arange(t)[None, :] < np.array([[t], [t - 5]])).astype(
            np.float32)
        steps = {}
        for dev in ("cuda", "cpu"):
            net = _charrnn_att_net(dev)
            on = [torch.as_tensor(a, device=dev) for a in (x, y, fm)]
            for e in kernel_registry.ported():
                e.reset()
            loss, grads, _ = net._loss_and_grads(*on, None)
            if dev == "cuda":
                launches = {e.key: e.launches()
                            for e in kernel_registry.ported()}
            steps[dev] = (loss.item(), tree.map_(lambda g: g.cpu(), grads))
    (l_card, g_card), (l_cpu, g_cpu) = steps["cuda"], steps["cpu"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    worst, key = _worst_rel(g_card, g_cpu)
    log(f"charrnn_agree: attention net (T={t}, key mask) one f32 step, "
        f"card vs CPU: loss {l_card:.6f} vs {l_cpu:.6f} rel={loss_rel:.3e}"
        f" tol={TRAIN_LOSS_RTOL:.0e}; worst gradient {key} "
        f"max|d|/max|g|={worst:.3e} tol={TRAIN_GRAD_TOL:.0e} {card}")
    assert loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_TOL
    state.setdefault("launches", {})["charrnn_agree"] = launches
    _check_step_launches("charrnn_agree", 1, launches, card)


# -- the compile lifecycle: captured paths against eager ones (A12) ----------
#: capture: the serve burst (requests, new tokens; prompts of 1..28
#: tokens, inside the warmed buckets 16 and 32), the fine-tune steps, the
#: char-RNN batches, and the seed of the sampled burst; capture_agree: the
#: timing turns (each a burst, CAPTURE_TURN_STEPS fine-tune steps or one
#: char-RNN batch, captured then eager)
CAPTURE_REQS, CAPTURE_NEW, CAPTURE_PROMPT_MAX = 32, 64, 28
CAPTURE_FT_STEPS, CAPTURE_RNN_BATCHES = 10, 4
CAPTURE_SAMPLE_SEED = 11
CAPTURE_TURNS, CAPTURE_TURN_STEPS = 2, 5
#: capture: the temperatures of the admissions that must share each
#: prompt bucket's one prefill graph
CAPTURE_TEMPS = (0.35, 0.8, 1.0, 1.6)


def _capture_prompts(vocab: int):
    import numpy as np
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, int(t))
            for t in rng.integers(1, CAPTURE_PROMPT_MAX + 1, CAPTURE_REQS)]


def _serve_burst(gw, prompts):
    """One burst through ``gw`` (queued while the worker is parked):
    the tokens of every stream, the mean decode step and prefill ms
    (the scheduler's histograms), the steps and admissions."""
    import torch
    from deeplearning4j_tpu_torch.obs import metrics
    step0 = metrics.SERVING_STEP.snapshot()[""]
    pre0 = metrics.SERVING_PREFILL.snapshot()[""]
    gw.pause()
    streams = [gw.submit(p, max_new=CAPTURE_NEW) for p in prompts]
    gw.resume()
    outs = [st.result(timeout=600) for st in streams]
    torch.cuda.synchronize()
    assert all(st.error() is None for st in streams)
    step1 = metrics.SERVING_STEP.snapshot()[""]
    pre1 = metrics.SERVING_PREFILL.snapshot()[""]
    n_steps = step1["count"] - step0["count"]
    n_pre = pre1["count"] - pre0["count"]
    return {"tokens": [o[len(p):].tolist() for p, o in zip(prompts, outs)],
            "steps": n_steps, "admissions": n_pre,
            "step_ms": (step1["sum"] - step0["sum"]) / n_steps * 1e3,
            "prefill_ms": (pre1["sum"] - pre0["sum"]) / n_pre * 1e3}


def _launches():
    from deeplearning4j_tpu_torch.ops import kernel_registry
    return {e.key: e.launches() for e in kernel_registry.ported()}


def _reset_launches():
    from deeplearning4j_tpu_torch.ops import kernel_registry
    for e in kernel_registry.ported():
        e.reset()


def _capture_serve(state, eager: bool, sample: bool):
    """A serve-width gateway (phase serve's configuration, greedy or
    sampled from ``CAPTURE_SAMPLE_SEED``) warmed over the prompt lengths
    1..28, then one burst; eagerly under ``sentry.eager()``. Returns the
    gateway (kept for the timing turns) and the run's record."""
    import contextlib
    import torch
    from deeplearning4j_tpu_torch.perf import sentry
    from deeplearning4j_tpu_torch.serving.gateway import ServingGateway
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    model = CausalTransformerLM(compute_dtype="bfloat16", **SERVE)
    params = model.init_params(seed=0, device="cuda")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with sentry.eager() if eager else contextlib.nullcontext():
        gw = ServingGateway(model, params, max_slots=32, block=16,
                            max_context=2048, queue_limit=64,
                            default_max_new=CAPTURE_NEW, sample=sample,
                            seed=CAPTURE_SAMPLE_SEED)
        t0 = time.perf_counter()
        warm = gw.warmup(prompt_lens=range(1, CAPTURE_PROMPT_MAX + 1))
        warm_s = time.perf_counter() - t0
        traces = sentry.total_traces()
        _reset_launches()
        run = _serve_burst(gw, _capture_prompts(model.vocab_size))
        run["launches"] = _launches()
    run.update(warm=warm, warm_s=warm_s,
               traces_moved=sentry.total_traces() - traces,
               peak_gb=(torch.cuda.max_memory_allocated() - base) / 2 ** 30)
    return gw, run


def _capture_finetune(eager: bool):
    """BERT-base's classifier (phase finetune's, dropout 0.1) warmed at
    the fine-tune batch's shapes, then CAPTURE_FT_STEPS ``fit`` steps and
    one ``output``; eagerly under ``sentry.eager()``. Returns the net
    (kept for the timing turns) and the run's record."""
    import contextlib
    import torch
    from deeplearning4j_tpu_torch.perf import WarmupSpec, sentry
    from deeplearning4j_tpu_torch.zoo.bert import BertBase
    net = BertBase(seed=2, compute_dtype="bfloat16").init_classifier(
        2, BERT_T)
    tokens, segments, mask, labels = _finetune_batch(0, BERT_B, BERT_T)
    spec = WarmupSpec(features=[(BERT_B, BERT_T)] * 2,
                      labels=[(BERT_B, 2)], features_mask=(BERT_B, BERT_T),
                      dtype="int32", labels_dtype="float32")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with sentry.eager() if eager else contextlib.nullcontext():
        t0 = time.perf_counter()
        warm = net.warmup([spec])
        warm_s = time.perf_counter() - t0
        _reset_launches()
        losses = []
        for _ in range(CAPTURE_FT_STEPS):
            net.fit([tokens, segments], [labels], features_masks=[mask])
            losses.append(net.score_)
        launches = _launches()
        probs = net.output(tokens, segments)[0]
    params = {k: v.detach().float().cpu()
              for k, v in _flat_params(net.params).items()}
    return net, {
        "warm": warm, "warm_s": warm_s, "losses": losses,
        "launches": launches, "params": params,
        "probs": probs.float().cpu(),
        "peak_gb": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
        "fit": lambda: net.fit([tokens, segments], [labels],
                               features_masks=[mask])}


def _capture_charrnn(eager: bool):
    """The char-RNN of phase charrnn (tBPTT, 4 segments a batch) with
    its output warmed, then CAPTURE_RNN_BATCHES ``fit`` batches;
    eagerly under ``sentry.eager()``. Returns the net and the record."""
    import contextlib
    import torch
    from deeplearning4j_tpu_torch.perf import WarmupSpec, sentry
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    v, b, t = CHARRNN["vocab_size"], CHARRNN_B, CHARRNN_T
    host, _ = _charrnn_text(0, CAPTURE_RNN_BATCHES, b, t, v)
    batches = [(torch.as_tensor(x, device="cuda"),
                torch.as_tensor(y, device="cuda")) for x, y in host]
    net = TextGenerationLSTM(**CHARRNN).init()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with sentry.eager() if eager else contextlib.nullcontext():
        t0 = time.perf_counter()
        warm = net.warmup([WarmupSpec(features=(b, t, v), train=False)])
        warm_s = time.perf_counter() - t0
        _reset_launches()
        losses = []
        for x, y in batches:
            net.fit(x, y)
            losses.append(net.score_)
        launches = _launches()
    params = {k: v_.detach().cpu()
              for k, v_ in _flat_params(net.params).items()}
    x, y = batches[-1]
    return net, {
        "warm": warm, "warm_s": warm_s, "losses": losses,
        "launches": launches, "params": params,
        "peak_gb": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
        "fit": lambda: net.fit(x, y)}


def _check_temperatures(gw, card) -> None:
    """Admissions at each of CAPTURE_TEMPS, at prompt lengths 1..28 in
    turn, through a warmed gateway: no trace, and one prefill graph a
    bucket however many temperatures it served (the temperature is a
    0-d tensor on the device, not a key of the graph)."""
    import numpy as np
    from deeplearning4j_tpu_torch.perf import sentry
    sched = gw._sched
    traces = sentry.total_traces()
    rng = np.random.default_rng(6)
    n = 0
    for temp in CAPTURE_TEMPS:                 # one burst a temperature
        gw.pause()
        streams = [gw.submit(rng.integers(0, SERVE["vocab_size"], t0),
                             max_new=4, temperature=temp)
                   for t0 in range(1, CAPTURE_PROMPT_MAX + 1)]
        gw.resume()
        for st in streams:
            st.result(timeout=600)
            assert st.error() is None, st.error()
        n += len(streams)
    graphs = {tb: fn.graphs() for tb, fn in sorted(sched._admit_fns.items())}
    log(f"capture: {n} admissions at temperatures "
        f"{CAPTURE_TEMPS}: prefill graphs by bucket {graphs}, traces "
        f"moved {sentry.total_traces() - traces} {card}")
    assert sentry.total_traces() == traces
    assert all(g == 1 for g in graphs.values()), graphs


def _flat_params(params, prefix=""):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_flat_params(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _capture_times(card) -> None:
    """Every entry point's build (capture) time and traces, and the
    compile report."""
    from deeplearning4j_tpu_torch import perf
    rep = perf.compile_report()
    for name, st in sorted(rep["per_function"].items()):
        log(f"capture: entry {name} traces={st['traces']} "
            f"warmed={st['warmed']} compiles={st['compiles']} "
            f"aot_hits={st['aot_hits']} build_s={st['compile_time_s']:.3f} "
            f"{card}")
    log(f"capture: compile_report {json.dumps({k: v for k, v in rep.items() if k != 'per_function'})} {card}")


def phase_capture(state):
    """The compile lifecycle on the card (``perf/``): three paths at
    full width, each warmed and then run through the entry points a
    user calls, their programs replaying CUDA graphs. serve: the serve
    phase's gateway warmed over prompts of 1..28 tokens, one burst of
    CAPTURE_REQS such requests (greedy), then a sampled gateway's burst;
    no trace after the warmups, the decode step and the prefill served
    by warmed graphs (aot_hits > 0, compiles 0), the launches exactly
    K1 12 an admission and K2 25 an admission and a step. finetune:
    BERT-base's classifier (dropout 0.1) warmed at the batch's shapes,
    CAPTURE_FT_STEPS steps, the launches exactly the registry's, an
    ``output`` whose rows sum to 1. charrnn: CAPTURE_RNN_BATCHES tBPTT
    batches, no ported kernel, its tBPTT steps captured at their first
    calls. Each path's peak memory and build times; capture_agree holds
    them against the eager runs. Then admissions at CAPTURE_TEMPS through
    the sampled gateway: one prefill graph a bucket."""
    import math
    import torch
    from deeplearning4j_tpu_torch.perf import sentry
    card = state["card"]
    _free_card("capture", card)
    sentry.reset()
    cap = state["capture"] = {}
    for tag, sample in (("serve", False), ("serve_sampled", True)):
        gw, run = _capture_serve(state, eager=False, sample=sample)
        cap[tag] = (gw, run)
        st = sentry.stats()
        log(f"capture: {tag} warmup {run['warm']['buckets']} compiled="
            f"{run['warm']['compiled']} in {run['warm_s']:.2f}s; burst of "
            f"{CAPTURE_REQS}: admissions={run['admissions']} steps="
            f"{run['steps']} mean_step_ms={run['step_ms']:.3f} "
            f"mean_prefill_ms={run['prefill_ms']:.3f} traces after "
            f"warmup {run['traces_moved']} peak_gb={run['peak_gb']:.3f} "
            f"{card}")
        assert run["traces_moved"] == 0, run["traces_moved"]
        for name in ("serving.decode_step", "serving.prefill"):
            assert st[name]["aot_hits"] > 0 and st[name]["compiles"] == 0, \
                (name, st[name])
        want = {k: 0 for k in run["launches"]}
        want.update(K1=12 * run["admissions"],
                    K2=25 * (run["admissions"] + run["steps"]))
        log(f"capture: {tag} launches {run['launches']} expected {want} "
            f"{card}")
        assert run["launches"] == want, (run["launches"], want)
        assert gw._sched._step_fn.graphs() > 0
        if sample:
            _check_temperatures(gw, card)
    state.setdefault("launches", {}).setdefault(
        "serve", cap["serve"][1]["launches"])
    net, run = _capture_finetune(eager=False)
    cap["finetune"] = (net, run)
    log(f"capture: finetune warmup {run['warm']} in {run['warm_s']:.2f}s; "
        f"losses {' '.join(f'{l:.4f}' for l in run['losses'])} "
        f"peak_gb={run['peak_gb']:.3f} graphs train_step="
        f"{net._train_step_fn.graphs()} output={net._output_fn.graphs()} "
        f"{card}")
    assert all(math.isfinite(l) for l in run["losses"]), run["losses"]
    _check_step_launches("finetune", CAPTURE_FT_STEPS, run["launches"],
                         card)
    state["launches"].setdefault("finetune", run["launches"])
    _check_prob_rows("capture finetune", run["probs"].cuda(), (BERT_B, 2),
                     PROB_SUM_TOL["bfloat16"], card)
    assert net._train_step_fn.graphs() == 1
    net, run = _capture_charrnn(eager=False)
    cap["charrnn"] = (net, run)
    log(f"capture: charrnn losses "
        f"{' '.join(f'{l:.4f}' for l in run['losses'])} peak_gb="
        f"{run['peak_gb']:.3f} graphs tbptt_step="
        f"{net._tbptt_step_fn.graphs()} {card}")
    assert all(math.isfinite(l) for l in run["losses"]), run["losses"]
    _check_step_launches("charrnn", CAPTURE_RNN_BATCHES, run["launches"],
                         card)
    assert net._tbptt_step_fn.graphs() == 2
    _capture_times(card)


def _max_rel(a: dict, b: dict):
    """Over the leaves of two flat trees: whether every leaf is equal to
    the bit, and the largest |a - b| over the leaf's largest |b|."""
    import torch
    same = all(torch.equal(a[k], b[k]) for k in b)
    worst = max(((a[k].double() - b[k].double()).abs().max()
                 / b[k].double().abs().max().clamp_min(1e-30)).item()
                for k in b)
    return same, worst


def _capture_turns(label, captured, eager, card, unit="step"):
    """``captured()`` and ``eager()`` (each returning ms a ``unit``)
    taken in turns, CAPTURE_TURNS each; prints every reading and the
    medians."""
    from deeplearning4j_tpu_torch.perf import sentry
    got = {"captured": [], "eager": []}
    for _ in range(CAPTURE_TURNS):
        got["captured"].append(captured())
        with sentry.eager():
            got["eager"].append(eager())
    med = {k: statistics.median(v) for k, v in got.items()}
    log(f"capture_agree: {label} ms a {unit} in turns captured "
        f"{' '.join(f'{x:.3f}' for x in got['captured'])} eager "
        f"{' '.join(f'{x:.3f}' for x in got['eager'])}; medians "
        f"captured={med['captured']:.3f} eager={med['eager']:.3f} "
        f"eager/captured={med['eager'] / med['captured']:.3f} {card}")


def _capture_idle(label, captured, eager, card) -> None:
    """``captured()`` and then ``eager()`` (its programs under
    ``sentry.eager()``), each once unprofiled for its wall and once under
    ``torch.profiler`` for the device's busy time: the idle share of the
    replayed work beside the eager work's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.perf import sentry
    rows = []
    for tag, fn in (("captured", captured), ("eager", eager)):
        with (sentry.eager() if tag == "eager"
              else contextlib.nullcontext()):
            wall = _wall_ms(fn)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        busy, kern = _kernel_split(prof)
        rows.append(f"{tag} wall_ms={wall:.3f} device_busy_ms={busy:.3f} "
                    f"idle_share={1 - busy / wall:.3f} kernels="
                    f"{sum(n for _, n in kern.values())}")
    log(f"capture_agree: {label} profiled once each: {'; '.join(rows)} "
        f"{card}")


def phase_capture_agree(state):
    """The paths of phase capture run eagerly (``sentry.eager()``) from
    the same seeds: the greedy and the sampled bursts' tokens equal
    token for token, the fine-tune and char-RNN parameters after their
    steps equal to the bit (else the largest difference over the largest
    value is printed and must stay within ``CAPTURE_PARAM_TOL``), the
    ported kernels' launches equal; each path's peak memory. Then each
    path's step timed captured and eager in turns in this process, one
    of each profiled for the device's idle share (for serve, a whole
    burst), and the entry points' build times."""
    import torch
    card = state["card"]
    cap = state["capture"]
    for tag, sample in (("serve", False), ("serve_sampled", True)):
        gw_c, run_c = cap[tag]
        gw_e, run_e = _capture_serve(state, eager=True, sample=sample)
        same = run_c["tokens"] == run_e["tokens"]
        log(f"capture_agree: {tag} captured tokens == eager tokens: "
            f"{same}; launches captured {run_c['launches']} eager "
            f"{run_e['launches']}; peak_gb captured={run_c['peak_gb']:.3f}"
            f" eager={run_e['peak_gb']:.3f} {card}")
        assert same, [i for i, (a, b) in enumerate(
            zip(run_c["tokens"], run_e["tokens"])) if a != b]
        assert run_c["launches"] == run_e["launches"]
        if not sample:
            prompts = _capture_prompts(SERVE["vocab_size"])
            _capture_turns("serve decode step",
                   lambda: _serve_burst(gw_c, prompts)["step_ms"],
                   lambda: _serve_burst(gw_e, prompts)["step_ms"], card)
            _capture_idle(f"serve burst ({CAPTURE_REQS} requests of 1.."
                          f"{CAPTURE_PROMPT_MAX} tokens, {CAPTURE_NEW} new)",
                          lambda: _serve_burst(gw_c, prompts),
                          lambda: _serve_burst(gw_e, prompts), card)
        gw_e.shutdown(drain=False)
        gw_c.shutdown(drain=False)
    for tag, make in (("finetune", _capture_finetune),
                      ("charrnn", _capture_charrnn)):
        net_c, run_c = cap[tag]
        net_e, run_e = make(eager=True)
        same, worst = _max_rel(run_c["params"], run_e["params"])
        log(f"capture_agree: {tag} parameters after the captured steps "
            f"equal to the bit: {same}; max |d|/max|x| over the leaves "
            f"{worst:.3e}; losses captured "
            f"{' '.join(f'{l:.6f}' for l in run_c['losses'])} eager "
            f"{' '.join(f'{l:.6f}' for l in run_e['losses'])}; launches "
            f"captured {run_c['launches']} eager {run_e['launches']}; "
            f"peak_gb captured={run_c['peak_gb']:.3f} eager="
            f"{run_e['peak_gb']:.3f} {card}")
        assert same or worst <= CAPTURE_PARAM_TOL, worst
        assert run_c["launches"] == run_e["launches"]
        reps = CAPTURE_TURN_STEPS if tag == "finetune" else 1
        fit_c, fit_e = run_c["fit"], run_e["fit"]
        _capture_turns(f"{tag} {'step' if tag == 'finetune' else 'batch'}",
               lambda: _wall_ms(lambda: [fit_c() for _ in range(reps)])
               / reps,
               lambda: _wall_ms(lambda: [fit_e() for _ in range(reps)])
               / reps, card, unit="step" if tag == "finetune" else "batch")
        _capture_idle(f"{tag} {'step' if tag == 'finetune' else 'batch'}",
                      fit_c, fit_e, card)
        del net_c, net_e
    state.pop("capture")
    _capture_times(card)
    torch.cuda.synchronize()


#: capture_agree: the parameters of a captured path against the eager
#: path's from the same start, when they are not equal to the bit (a
#: library that picks another algorithm under capture): the largest
#: difference over the leaf's largest value
CAPTURE_PARAM_TOL = 1e-3


def phase_profile(state):
    """Device-time breakdown of the serving path — the prefill of the
    longest prompt (bucket 2048), then 8 decode steps with all 32 slots
    active — of one training step of the train phase's model and batch,
    of one fine-tune step of the finetune phase's model and batch, of
    one step of the longctx phase's model and batch, of one sp step (the
    same batch, the zigzag ring at one rank), of one dp_packed step (on
    the train net), of its packed exchange alone, of one zero step
    (the train model and batch under the sharded update: the flat copies
    and NCCL's reduce-scatter and all-gather beside the step's work) and
    of one dp_graph step (the fine-tune model and batch, unmasked, under
    the same wrapper), and of one pass of the eval phase: ``evaluate``
    over its 16 batches, and the bare ``output`` loop over them.
    Every wall time is taken before the first profiled window,
    and the decode window's once more after the last one: a host-bound
    step ran slower after the kernels phase, and this shows whether
    profiling alone does that."""
    import numpy as np
    from deeplearning4j_tpu_torch.serving.gateway import TokenStream
    from deeplearning4j_tpu_torch.serving.scheduler import DecodeScheduler
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    card = state["card"]
    model = CausalTransformerLM(compute_dtype="bfloat16", **SERVE)
    params = model.init_params(seed=0, device="cuda")
    sched = DecodeScheduler(model, params, max_slots=32, block=16,
                            max_context=2048)
    sched.warmup()
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 1501, size=32)
    prompts = [rng.integers(0, model.vocab_size, int(t)) for t in lens]
    stream = lambda i: TokenStream(prompts[i], 64, "profile", None, None,
                                   None)
    reqs = [stream(i) for i in range(len(prompts))]
    first, *rest = list(np.argsort(-lens))
    for i in rest:
        sched.admit(reqs[i])
    tmodel = CausalTransformerLM(compute_dtype="bfloat16", **TRAIN)
    net = tmodel.init(TRAIN_T)
    x, y = _train_batch(0, TRAIN_B, TRAIN_T, tmodel.vocab_size)
    for _ in range(2):
        net.fit(x, y)
    from deeplearning4j_tpu_torch.zoo.bert import BertBase
    bert = BertBase(seed=2, compute_dtype="bfloat16").init_classifier(
        2, BERT_T)
    tokens, segments, mask, labels = _finetune_batch(0, BERT_B, BERT_T)
    ft_step = lambda: bert.fit([tokens, segments], [labels],
                               features_masks=[mask, mask])
    for _ in range(2):
        ft_step()
    lmodel = CausalTransformerLM(compute_dtype="bfloat16", **LONGCTX)
    lnet = lmodel.init(LONGCTX_T)
    lx, ly = _train_batch(0, LONGCTX_B, LONGCTX_T, lmodel.vocab_size)
    long_step = lambda: lnet.fit(lx, ly)
    long_step()
    from deeplearning4j_tpu_torch.parallel import distributed_context
    snet = CausalTransformerLM(compute_dtype="bfloat16", **SP).init(
        LONGCTX_T)
    sp_ctx = distributed_context(_seq_mesh(state))

    def sp_step():
        with sp_ctx:
            snet.fit(lx, ly)
    sp_step()
    # the dp_packed step on the train net, and its exchange alone on one
    # step's gradients
    packed_step, parts = _packed_step(_dp_mesh(state), net, x, y)
    packed_step()
    g, acc_state, group, acc = parts()
    exchange = lambda: acc.exchange_packed(g, acc_state, group)
    exchange()
    # the zero step: the train model under the sharded update
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    zw = ParallelWrapper(tmodel.init(TRAIN_T), mesh=_dp_mesh(state),
                         sharded_update=True)
    zero_step = lambda: zw.fit([DataSet(x, y)])
    for _ in range(2):
        zero_step()
    # the dp_graph step: the fine-tune model and batch under the wrapper
    gw = ParallelWrapper(BertBase(seed=2, compute_dtype="bfloat16")
                         .init_classifier(2, BERT_T), mesh=_dp_mesh(state),
                         sharded_update=True)
    graph_step = lambda: gw.fit([([tokens, segments], [labels])])
    for _ in range(2):
        graph_step()
    # one pass of the eval phase, and its bare output loop
    ebatches = _eval_batches(0, EVAL_BATCHES, BERT_B)
    eval_pass = lambda: bert.evaluate(ebatches)
    out_pass = lambda: [bert.output(*b.features) for b in ebatches]
    eval_pass()
    out_pass()
    decode = lambda: [sched.step() for _ in range(8)]
    train_step = lambda: net.fit(x, y)
    walls = {"prefill": _wall_ms(lambda: sched.admit(reqs[first])),
             "decode": _wall_ms(decode), "train": _wall_ms(train_step),
             "finetune": _wall_ms(ft_step), "longctx": _wall_ms(long_step),
             "sp": _wall_ms(sp_step),
             "dp_packed": _wall_ms(packed_step),
             "exchange": _wall_ms(exchange), "zero": _wall_ms(zero_step),
             "dp_graph": _wall_ms(graph_step), "eval": _wall_ms(eval_pass),
             "output": _wall_ms(out_pass)}
    sched.evict(reqs[first])            # its slot and pages, once more
    _device_window(f"prefill t0={lens[first]} (bucket 2048)",
                   lambda: sched.admit(stream(first)), walls["prefill"],
                   card)
    _device_window("8 decode steps x 32 slots", decode, walls["decode"],
                   card)
    _device_window(f"train step B={TRAIN_B} T={TRAIN_T}", train_step,
                   walls["train"], card)
    _device_window(f"finetune step B={BERT_B} T={BERT_T}", ft_step,
                   walls["finetune"], card)
    _device_window(f"longctx step B={LONGCTX_B} T={LONGCTX_T}", long_step,
                   walls["longctx"], card)
    _device_window(f"sp step (zigzag ring, one rank) B={LONGCTX_B} "
                   f"T={LONGCTX_T}", sp_step, walls["sp"], card)
    _device_window(f"dp_packed step B={TRAIN_B} T={TRAIN_T}", packed_step,
                   walls["dp_packed"], card)
    _device_window("exchange_packed alone", exchange,
                   walls["exchange"], card, host_top=12)
    _device_window(f"zero step (sharded update, one rank) B={TRAIN_B} "
                   f"T={TRAIN_T}", zero_step, walls["zero"], card,
                   host_top=12)
    _device_window(f"dp_graph step (sharded update, one rank, unmasked) "
                   f"B={BERT_B} T={BERT_T}", graph_step, walls["dp_graph"],
                   card, host_top=12)
    _device_window(f"eval pass ({EVAL_BATCHES} batches B={BERT_B} "
                   f"T={BERT_T}, unmasked)", eval_pass, walls["eval"], card,
                   host_top=6)
    _device_window(f"output loop ({EVAL_BATCHES} batches B={BERT_B} "
                   f"T={BERT_T}, unmasked)", out_pass, walls["output"], card)
    log(f"profile: dp_packed exchange wall_ms={walls['exchange']:.3f} of a "
        f"{walls['dp_packed']:.3f} ms step "
        f"({100 * walls['exchange'] / walls['dp_packed']:.1f}%) {card}")
    log(f"profile: 8 decode steps x 32 slots wall_ms before any profiling"
        f"={walls['decode']:.3f}, after it={_wall_ms(decode):.3f} {card}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list from {PHASES + ('profile',)}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from a checkout of the repository "
              "(deeplearning4j_tpu_torch not found)", file=sys.stderr)
        return 2
    state = {}
    phase_device(state)
    _build_all()
    try:
        for name in phases:
            if name == "device":
                continue
            t0 = time.perf_counter()
            log(f"== phase {name}")
            try:
                globals()[f"phase_{name}"](state)
            except Exception as e:
                import traceback
                traceback.print_exc()
                print(f"chip_smoke: phase {name} FAILED: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
                return 1
            log(f"== phase {name} ok ({time.perf_counter() - t0:.1f}s)")
    finally:
        import torch.distributed as dist
        if dist.is_initialized():            # the dp phases' group
            dist.destroy_process_group()
    from deeplearning4j_tpu_torch.resilience import faults
    log(f"faults: site evaluations with no plan active over the run: "
        f"{faults.evaluations()} (expected 0; the plan phases reset the "
        f"count after their plans)")
    if faults.evaluations():
        return 1
    if "kernels" in phases and state.get("launches"):
        from deeplearning4j_tpu_torch.ops import kernel_registry
        rows = state["kernel_rows"]
        ran = state["launches"]              # path -> {key: launches}
        kernels = []
        for e in kernel_registry.ported():
            r = rows[e.key]
            by_path = {p: ran[p][e.key] for p in e.paths if p in ran}
            kernels.append({
                "name": e.name, "route": e.route, "source": e.source,
                "replaces": e.replaces,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": rows[f"{e.key}_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": state["kind"],
        "count": state["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
