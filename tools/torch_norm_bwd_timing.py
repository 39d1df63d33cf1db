#!/usr/bin/env python3
"""Time the port's norm backward kernels (K6 RMSNorm, K9 LayerNorm) on
one NVIDIA card, for the checkout this file sits in or another one.

    python3 tools/torch_norm_bwd_timing.py              # this checkout
    python3 tools/torch_norm_bwd_timing.py --tree DIR   # another tree

``DIR`` is the root of an unpacked checkout (for instance a parent commit
from ``git archive``), so that two versions can be timed on one card in
one process's turn each. For each kernel at its main path's shape (K6
[16384, 768] and [32768, 768], K9 [8192, 768]; bf16), and for K9 at
``chip_smoke.py``'s closest library bar, [1000, 200] in bf16 and f32, it
prints the device time per call by CUDA-graph replay of 20 calls, and
the host time per call (CUDA events around 20 eager calls). At [1000,
200] it also times the bar's yardstick as the kernels phase does: the
backward of autograd through ``F.layer_norm``, its forward's time taken
off, in ``TURNS`` alternating turns with the kernel, medians printed. Where the tree still has
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
import statistics
import subprocess
import sys

#: alternating (kernel, library) readings at the small-row bar's shape
TURNS = 7


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


def _against_library(call, x, gamma, dy) -> str:
    """The kernel and the library's LayerNorm backward (autograd through
    ``F.layer_norm``, less its forward), ``TURNS`` readings each in
    alternating turns (kernel, library, library, kernel, ...)."""
    import torch
    import torch.nn.functional as F
    f = x.shape[-1]
    xr, gr, br = (t.detach().clone().requires_grad_()
                  for t in (x, gamma, torch.zeros_like(gamma)))
    fwd = lambda: F.layer_norm(xr, (f,), gr, br, eps=1e-5)
    lib = lambda: (device_ms(lambda: torch.autograd.grad(
        fwd(), (xr, gr, br), dy)) - device_ms(fwd))
    ks, ls = [], []
    for i in range(TURNS):
        turn = ((lambda: device_ms(call), ks), (lib, ls))
        for fn, reads in (turn if i % 2 == 0 else turn[::-1]):
            reads.append(fn())
    k, v = statistics.median(ks), statistics.median(ls)
    return (f" turns: kernel_ms={k:.5f} ({min(ks):.5f}-{max(ks):.5f}) "
            f"library_ms={v:.5f} ({min(ls):.5f}-{max(ls):.5f}) "
            f"kernel/library={k / v:.3f}")


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
    for key, rows, f, dt, ln in (
            ("K6", 16384, 768, torch.bfloat16, False),
            ("K6", 32768, 768, torch.bfloat16, False),
            ("K9", 8192, 768, torch.bfloat16, True),
            ("K9", 1000, 200, torch.bfloat16, True),
            ("K9", 1000, 200, torch.float32, True)):
        g = torch.Generator(device="cuda").manual_seed(rows)
        x = torch.randn((rows, f), generator=g, device="cuda").to(dt)
        dy = torch.randn((rows, f), generator=g, device="cuda").to(dt)
        gamma = (1 + 0.1 * torch.randn((f,), generator=g,
                                       device="cuda")).to(dt)
        call = ((lambda: fn_mod.layer_norm_bwd(x, gamma, dy)) if ln
                else (lambda: fn_mod.rms_norm_bwd(x, gamma, dy)))
        dname = str(dt).replace("torch.", "").replace("bfloat16", "bf16")
        line = (f"{tag}{key} {dname} [{rows}, {f}]: kernel_ms="
                f"{device_ms(call):.4f} host_ms={host_ms(call):.4f}")
        if f != 768:
            line += _against_library(call, x, gamma, dy)
            print(f"{line} {card}", flush=True)
            continue
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
