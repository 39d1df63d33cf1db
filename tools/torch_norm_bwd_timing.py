#!/usr/bin/env python3
"""Time the port's norm backward kernels (K6 RMSNorm, K9 LayerNorm) on
one NVIDIA card, for the checkout this file sits in or another one.

    python3 tools/torch_norm_bwd_timing.py              # this checkout
    python3 tools/torch_norm_bwd_timing.py --tree DIR   # another tree

``DIR`` is the root of an unpacked checkout (for instance a parent commit
from ``git archive``), so that two versions can be timed on one card in
one process's turn each. For each kernel at its main path's shape (K6
[16384, 768] and [32768, 768], K9 [8192, 768]; bf16) it prints the
device time per call by CUDA-graph replay of 20 calls, and the host time
per call (CUDA events around 20 eager calls). Where the tree still has
the Triton pair of a row pass and a partials reduce (``_triton_kernels``
in ``ops/fused_norms.py`` with ``rms_bwd``, ``ln_bwd`` and
``bwd_reduce``), each of the two launches is also timed alone, which
splits the old kernel's time between its row pass and its reduce.
Where the tree has the CUDA kernel's two warp paths (``_TMA_ROWS_PER_WARP``
in ``ops/fused_norms.py``), each shape is also timed with the rows
forced onto the TMA ring and onto 16-byte register loads, in turns
(TMA, registers, registers, TMA). Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys


def device_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
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


def host_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Time per call of eager calls between CUDA events: the host's
    launch path where it is longer than the device's work."""
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


def _split(fn_mod, x, gamma, dy, ln: bool):
    """The old Triton pair's two launches, each timed alone: the row
    pass (dx and one f32 partial row per program) and the reduce of the
    partials."""
    import torch
    k = fn_mod._triton_kernels()
    rows, f = x.shape
    rows_per, n_prog = fn_mod._row_runs(k.triton, rows)
    ncol = 2 * f if ln else f
    part = torch.empty((n_prog, ncol), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((ncol,), dtype=gamma.dtype, device=x.device)
    dx = torch.empty_like(x)
    block = k.triton.next_power_of_2(f)
    body = k.ln_bwd if ln else k.rms_bwd
    row_pass = lambda: body[(n_prog,)](x, gamma, dy, dx, part, rows, f,
                                       rows_per, 1e-5 if ln else 1e-6,
                                       BLOCK=block,
                                       num_warps=fn_mod._warps(block))
    reduce = lambda: fn_mod._reduce_partials(k, part, out)
    return device_ms(row_pass), device_ms(reduce), n_prog


def _paths(fn_mod, call):
    """Device ms of ``call`` with the warp path forced to the TMA ring
    and to 16-byte register loads, in turns."""
    keep = fn_mod._TMA_ROWS_PER_WARP
    times = {"tma": [], "registers": []}
    try:
        for name in ("tma", "registers", "registers", "tma"):
            # 0: the ring from the first row; inf: never
            rows = 0 if name == "tma" else float("inf")
            fn_mod._TMA_ROWS_PER_WARP = {False: rows, True: rows}
            times[name].append(device_ms(call))
    finally:
        fn_mod._TMA_ROWS_PER_WARP = keep
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="root of the checkout to time")
    ap.add_argument("--label", default="", help="tag for the output lines")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_norm_bwd_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from deeplearning4j_tpu_torch.ops import fused_norms as fn_mod
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    card = f"[{smi.splitlines()[0] if smi else 'nvidia-smi: no output'}]"
    tag = f"{args.label} " if args.label else ""
    print(f"{tag}tree={os.path.abspath(args.tree)} module="
          f"{fn_mod.__file__} {card}", flush=True)
    has_pair = all(hasattr(fn_mod, a) for a in ("_triton_kernels",
                                               "_row_runs",
                                               "_reduce_partials"))
    for key, rows, ln in (("K6", 16384, False), ("K6", 32768, False),
                          ("K9", 8192, True)):
        g = torch.Generator(device="cuda").manual_seed(rows)
        x = torch.randn((rows, 768), generator=g,
                        device="cuda").to(torch.bfloat16)
        dy = torch.randn((rows, 768), generator=g,
                         device="cuda").to(torch.bfloat16)
        gamma = (1 + 0.1 * torch.randn((768,), generator=g,
                                       device="cuda")).to(torch.bfloat16)
        call = ((lambda: fn_mod.layer_norm_bwd(x, gamma, dy)) if ln
                else (lambda: fn_mod.rms_norm_bwd(x, gamma, dy)))
        line = (f"{tag}{key} bf16 [{rows}, 768]: kernel_ms="
                f"{device_ms(call):.4f} host_ms={host_ms(call):.4f}")
        if has_pair:
            t_rows, t_red, n_prog = _split(fn_mod, x, gamma, dy, ln)
            line += (f" row_pass_ms={t_rows:.4f} reduce_ms={t_red:.4f} "
                     f"programs={n_prog}")
        if hasattr(fn_mod, "_TMA_ROWS_PER_WARP"):
            for name, ts in _paths(fn_mod, call).items():
                line += f" {name}_ms={'/'.join(f'{t:.4f}' for t in ts)}"
        print(f"{line} {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
