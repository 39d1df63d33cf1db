#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py               # phases 1-20 (needs one card)
    python3 chip_smoke.py --phases train,train_agree,kernels
    python3 chip_smoke.py --phases finetune,finetune_agree,kernels
    python3 chip_smoke.py --phases longctx,longctx_agree,kernels
    python3 chip_smoke.py --phases dp,dp_packed,dp_agree,kernels
    python3 chip_smoke.py --phases sp,sp_agree,kernels
    python3 chip_smoke.py --phases zero,zero_agree,dp_graph,kernels
    python3 chip_smoke.py --phases eval,eval_agree,kernels
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
4. train — the same model built by ``CausalTransformerLM(...).init(1024)``
   (bfloat16 compute, the model's AdamW) trained by ``net.fit(x, y)`` on
   one fixed batch of 16 x 1024 random tokens: 2 warm steps, then 8
   timed steps; every loss finite and the last below the first, and each
   training kernel launched its expected number of times per step;
5. train_agree — the same model in float32 (TF32 off), one step at
   B = 2, T = 256: the card's loss and every gradient against the port
   on the CPU;
6. finetune — BERT-base at full width and depth (vocab 30522, hidden
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
7. finetune_agree — BERT-base in float32 with dropout 0 (a CUDA and a
   CPU ``torch.Generator`` draw different masks) and TF32 off, one step
   at B = 4, T = 128 with a key mask: the card's loss and every gradient
   against the port on the CPU;
8. longctx — the serve phase's LM at a 32 768-token context, built by
   ``CausalTransformerLM(..., max_len=32768).init(32768)`` (bfloat16
   compute, the model's AdamW) and trained by ``net.fit(x, y)`` on one
   fixed batch of 1 x 32 768 random tokens: 1 warm step, then 3 timed
   steps. Past 24 576 query rows the attention backward takes the split
   pair K4 (dq) + K5 (dk/dv) instead of the fused K3, by the JAX
   package's own test; every loss finite and the last below the first,
   each kernel launched exactly its registry count per step (K3 none);
9. longctx_agree — the same model in float32 (TF32 off), one step at
   B = 2, T = 256 with the fused backward's budget set to 0, so the
   card's backward runs K4 + K5: its loss and every gradient against
   the port on the CPU;
10. dp — ``initialize_distributed()`` (this process alone, a
   ``"cpu:gloo,cuda:nccl"`` group: NCCL for CUDA tensors, gloo for CPU
   ones), then the train phase's LM and batch through
   ``SharedTrainingMaster().make_wrapper(net, data_parallel_mesh())`` →
   ``ParallelWrapper.fit`` (ENCODED: threshold-encoded gradients, the
   decoded update summed over the group): 2 warm steps, then 8 timed;
   every loss finite and the last below the first, the train kernels'
   launches exactly, K10 and K11 none;
11. dp_packed — the same LM and batch in a step loop over the data group:
   ``loss_and_grads`` → ``EncodedGradientsAccumulator.exchange_packed``
   (K10 once a parameter leaf, the packed words all-gathered, K11 once a
   leaf and rank) → ``apply_updates``; 2 warm and 8 timed steps, the
   launches exactly (K10 = the net's parameter leaves, K11 = leaves ×
   ranks);
12. dp_agree — one f32 step (TF32 off) of ENCODED and of the packed
   exchange at B = 2, T = 256 from the same weights, card against CPU in
   the same group (the CPU tensors over gloo): the loss, the decoded
   updates (all but the codes flipped at |g| ≈ τ equal) and the
   residuals (where the codes agree, to 1e-3 of the leaf's largest
   gradient);
13. sp — ``initialize_distributed()`` (this process alone), then
   ``make_mesh({"seq": 1})`` and ``distributed_context``: the longctx
   phase's LM built with ``sequence_parallel="zigzag_ring"`` and trained
   by ``net.fit(x, y)`` on the same 1 x 32 768 batch, 1 warm and 3
   timed steps. Each layer's attention is the zigzag ring at one rank:
   four half-chunk block pairs of 16 384 rows a step through
   ``flash_block_fwd`` (K1) and ``flash_block_bwd`` (K3: the half's rows
   fit the fused budget), one pair wholly above the diagonal; every loss
   finite and the last below the first, each kernel launched exactly its
   registry count per step;
14. sp_agree — one f32 step (TF32 off) of the train phase's model at
   B = 2, T = 256 under the seq-1 context for each of ``ring``,
   ``zigzag_ring`` and ``ulysses``: the card's loss and every gradient
   against the same step without the context on the card, and against
   the same step under the context on the CPU;
15. zero — the train phase's LM and batch through ``ParallelWrapper(net,
   mesh=data_parallel_mesh(), sharded_update=True)`` on the one-rank
   group of the dp phases (the ZeRO sharded update: one reduce-scatter a
   flat gradient leaf, the update on the rank's slice against its 1/N
   optimizer state, one all-gather a leaf), then the same with
   ``gather_overlap=True``: each 2 warm and 8 timed steps, the step ms,
   tokens/s, peak GB and the ``OPT_STATE_BYTES`` reading, every loss
   finite and the last below the first, the train kernels' launches
   exactly;
16. zero_agree — the train model in float32 (TF32 off) at B = 2,
   T = 256: replicated SYNC, the sharded update and the overlap take two
   steps each from one gradient and must end bit for bit alike (params
   and the gathered optimizer state); then one sharded step through
   ``fit`` on the card against the CPU: the loss and the
   reduce-scattered gradient in train_agree's bands;
17. dp_graph — BERT-base's classifier (the finetune phase's model)
   through ``ParallelWrapper(graph, sharded_update=True)`` on the same
   group, the fine-tune batch as full-length rows (no masks, so K1 and
   K3 run unmasked): 2 warm and 8 timed steps, the loss falling, the
   launches exactly, then one ``output`` whose rows each sum to 1;
18. eval — the finetune phase's model (BERT-base, bfloat16 compute)
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
19. eval_agree — BERT-base in float32 (dropout 0, TF32 off), 2 batches
   of 16 x 128: the card's probabilities against the port on the CPU
   within ``AGREE_TOL``, any argmax that differs on a row whose top two
   lie within twice the observed error, and the seven classes fed the
   card's tensors equal to the bit to the same fed numpy arrays;
20. kernels — holds each ported kernel against its plain PyTorch version
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

Each main path (serve, train, finetune, longctx, dp, dp_packed, sp, zero,
dp_graph, eval) zeroes
the launch counters of the kernels just before it runs and reads them
just after; it fails if a kernel the registry lists for that path was
not launched, and on a stepped path (all but serve; eval counts its
batches) if any ported kernel was launched other than its registry
count per step (0 for a kernel the path does not list).

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

PHASES = ("device", "serve", "agree", "train", "train_agree", "finetune",
          "finetune_agree", "longctx", "longctx_agree", "dp", "dp_packed",
          "dp_agree", "sp", "sp_agree", "zero", "zero_agree", "dp_graph",
          "eval", "eval_agree", "kernels")

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


# -- the builds; phase 10, kernels -----------------------------------------
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


def _flash_case(dt, tb, h, h_kv, causal, masked, seed, unaligned=False):
    """q, k, v [1, tb, heads, 128] and a key mask (``masked``) on the
    card; ``unaligned``: each a view one element into a [.., 129] tensor,
    so that its base and strides are not whole 16-byte chunks and the
    tensor-core kernels fill their tiles by element copies."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    extra = 1 if unaligned else 0
    mk = lambda hh: torch.randn((1, tb, hh, 128 + extra), generator=g,
                                device="cuda").to(dt)[..., extra:]
    q, k, v = mk(h), mk(h_kv), mk(h_kv)
    mask = None
    if masked:
        mask = (torch.rand((1, tb), generator=g, device="cuda") > 0.3)
        mask[:, 0] = True
        mask = mask.float()
    return q, k, v, mask


def _flash_flops(tb, h, causal, mask):
    """Two products (q·k and p·v) of 2·D flops per live (query, key)
    pair and head — the pairs these inputs make live."""
    if causal:
        pairs = tb * (tb + 1) / 2
    else:
        pairs = tb * (tb if mask is None else float(mask.sum()))
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
    # (tb, h, h_kv, causal, masked, unaligned)
    cases = [(tb, 6, 6, True, False, False)
             for tb in (16, 200, 1024, 2048)]
    cases += [(200, 6, 2, True, False, False),
              (2048, 6, 2, True, False, False),
              (200, 6, 6, False, True, False),
              (1024, 6, 6, False, True, False),
              (333, 6, 3, True, False, True),
              (200, 6, 6, False, True, True)]
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for i, (tb, h, h_kv, causal, masked, unal) in enumerate(cases):
            q, k, v, mask = _flash_case(dt, tb, h, h_kv, causal, masked, i,
                                        unal)
            out = flash(q, k, v, causal=causal, mask=mask)
            ref = plain(q, k, v, causal=causal, mask=mask)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = err <= FLASH_TOL[dname] and torch.isfinite(out).all()
            line = (f"K1 flash {dname} Tb={tb} H={h} Hkv={h_kv} "
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
            flops = _flash_flops(tb, h, causal, mask)
            b_ms, b_by = bound_ms(
                flops, nbytes,
                PEAK_BF16_FLOPS if dname == "bfloat16" else PEAK_F32_FLOPS)
            line += (f" kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
                     f"sdpa_ms={t_l:.4f} kernel/sdpa={t_k / t_l:.2f} "
                     f"bound_ms={b_ms:.5f}({b_by}) "
                     f"{_rate(flops, t_k, b_ms)} {card}")
            if (dname, tb, h_kv, masked) == ("bfloat16", 2048, 6, False):
                rows["K1"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                  bound_ms=b_ms, bound_by=b_by)
            log(line)
            if not ok:
                raise AssertionError(f"K1 disagrees with its plain "
                                     f"version: {line}")
            rows.setdefault("K1_err", 0.0)
            rows["K1_err"] = max(rows["K1_err"], err)

    # K2 RMSNorm forward
    e = ents["K2"]
    rms, rms_plain = e.port_fn(), e.plain_fn()
    f = 768
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for n in (32, 2048, TRAIN_B * TRAIN_T):
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
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


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


# -- phases 4, 8 ------------------------------------------------------------
def _train_batch(seed: int, b: int, t: int, vocab: int):
    """Random tokens from ``np.random.default_rng(seed)``: inputs and
    their next-token labels, [b, t] int32 each."""
    import numpy as np
    toks = np.random.default_rng(seed).integers(0, vocab, (b, t + 1))
    return (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32))


def _fit_steps(state, path: str, model_kw, b: int, t: int, warm: int,
               steps: int, make_step=None):
    """The stepped LM path ``path``: ``CausalTransformerLM(**model_kw)``
    (bfloat16 compute) built by ``init(t)`` and trained on one fixed
    [b, t] batch, ``warm`` steps, then ``steps`` timed ones between
    zeroed and read launch counters. A step is ``net.fit(x, y)``, or the
    callable ``make_step(net, x, y)`` returns (it ends in a device sync
    and leaves the loss in ``net.score()``). Returns the net."""
    import math
    import torch
    from deeplearning4j_tpu_torch.ops import kernel_registry
    from deeplearning4j_tpu_torch.zoo.gpt import CausalTransformerLM
    card = state["card"]
    model = CausalTransformerLM(compute_dtype="bfloat16", **model_kw)
    t0 = time.perf_counter()
    net = model.init(t)
    x, y = _train_batch(0, b, t, model.vocab_size)
    log(f"{path}: init {net.num_params()} params "
        f"{time.perf_counter() - t0:.1f}s")
    step = (make_step(net, x, y) if make_step is not None
            else lambda: net.fit(x, y))
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
    state.setdefault("launches", {})[path] = launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{path}: losses {' '.join(f'{l:.4f}' for l in losses)} {card}")
    log(f"{path}: B={b} T={t} steps={steps} mean_step_ms="
        f"{wall / steps * 1e3:.3f} tokens_per_s={b * t / wall * steps:.1f}"
        f" max_memory_allocated_gb={peak_gb:.3f} {card}")
    assert all(math.isfinite(l) for l in losses), losses
    assert losses[-1] < losses[0], losses
    _check_step_launches(path, steps, launches, card)
    return net


def phase_train(state):
    _fit_steps(state, "train", TRAIN, TRAIN_B, TRAIN_T, warm=2, steps=8)


def phase_longctx(state):
    _fit_steps(state, "longctx", LONGCTX, LONGCTX_B, LONGCTX_T, warm=1,
               steps=3)


def _check_step_launches(path: str, steps: int, launches, card) -> None:
    """Every ported kernel was launched exactly its registry count per
    step on the stepped ``path`` over ``steps`` steps: 0 for a kernel
    the registry does not list for that path."""
    from deeplearning4j_tpu_torch.ops import kernel_registry
    per_step = {e.key: e.per_step.get(path, 0)
                for e in kernel_registry.ported()}
    log(f"{path}: launches over {steps} steps {launches} (per step "
        f"expected {per_step}) {card}")
    for key, n in per_step.items():
        want = steps * n
        assert launches[key] == want, \
            f"{key}: {launches[key]} launches in {steps} steps of " \
            f"{path}, expected {want}"


# -- phases 5, 9 ------------------------------------------------------------
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


# -- phases 10-12: data-parallel --------------------------------------------
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
            net.conf.updater, net._grad_norm, net.params, dec,
            net.opt_state)
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


# -- phases 15-17: the ZeRO sharded update, the graph under the wrapper ----
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
    assert gauge["layout=sharded"] == mine and devices == ["cpu"]


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
    fixed = ref._local_grads(ref.net.params, ref.net._as_input(x),
                             ref.net._as_input(y),
                             fold_in(ref.net.conf.seed, 0))
    nets = {}
    for name, kw in (("replicated", {}), ("sharded",
                                          {"sharded_update": True}),
                     ("overlap", {"sharded_update": True,
                                  "gather_overlap": True})):
        w = ParallelWrapper(model.init(256), mesh=mesh, **kw)
        w._local_grads = lambda p, xs, ys, rng, w=w: (
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
    _check_prob_rows("dp_graph", probs, PROB_SUM_TOL["bfloat16"], card)


# -- phases 6, 7 -----------------------------------------------------------
# -- phases 13-14: sequence-parallel ----------------------------------------
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
    _check_prob_rows("finetune", probs, PROB_SUM_TOL["bfloat16"], card)


def _check_prob_rows(phase, probs, tol, card) -> None:
    """The classifier's output on the card: finite [B, 2] probabilities
    whose rows each sum to 1 within ``tol``."""
    import torch
    row_err = (probs.sum(-1) - 1).abs().max().item()
    log(f"{phase}: output {tuple(probs.shape)} on {probs.device} "
        f"max|row sum - 1|={row_err:.2e} tol={tol:.1e} {card}")
    assert probs.ndim == 2 and probs.shape[1] == 2 and probs.is_cuda
    assert bool(torch.isfinite(probs).all()) and row_err <= tol


def phase_finetune_agree(state):
    import torch
    from deeplearning4j_tpu_torch import tree
    from deeplearning4j_tpu_torch.zoo.bert import BertBase
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = BertBase(seed=3, dropout=0.0)            # float32
    tokens, segments, mask, labels = _finetune_batch(1, 4, BERT_T)
    results = {}
    for dev in ("cuda", "cpu"):
        net = model.init_classifier(2, BERT_T, device=dev)
        loss, grads, _ = net._loss_and_grads(
            [tokens, segments], [labels], [mask, mask])
        results[dev] = (loss.item(), tree.map_(lambda g: g.cpu(), grads))
        if dev == "cuda":
            _check_prob_rows("finetune_agree", net.output(
                tokens, segments, features_masks=[mask, mask])[0],
                PROB_SUM_TOL["float32"], state["card"])
        del net, grads
    (l_card, g_card), (l_cpu, g_cpu) = results["cuda"], results["cpu"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    rels = tree.map_with_path(
        lambda path, a, b: (_rel_err(a, b), ".".join(path)), g_card, g_cpu)
    worst, worst_key = max(tree.leaves(rels))
    log(f"finetune_agree: f32 B=4 T={BERT_T} key-masked one step, card vs "
        f"CPU: loss {l_card:.6f} vs {l_cpu:.6f} rel={loss_rel:.3e} "
        f"tol={TRAIN_LOSS_RTOL:.0e}; worst gradient {worst_key} "
        f"max|d|/max|g|={worst:.3e} tol={TRAIN_GRAD_TOL:.0e} "
        f"{state['card']}")
    if not (loss_rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_TOL):
        raise AssertionError("card and CPU fine-tune step disagree")


# -- phases 18, 19: evaluation ---------------------------------------------
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
        log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}% x{count[key]:<5d} "
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
