#!/usr/bin/env python3
"""The spread of ``chip_smoke.py``'s K9 library bar on one NVIDIA card:
LayerNorm backward (K9) against the backward of autograd through
``F.layer_norm`` at [1000, 200] bf16, the bar's closest case.

    python3 tools/torch_norm_bwd_spread.py [--rounds N] [--pairs P]

Each round is a fresh process (a bar reading moves more between
processes than within one). It times kernel and library call as the
kernels phase does (``chip_smoke._check_norm_bwd_cases``: 20-call
CUDA-graph replays, the library's forward time taken off) in ``P``
alternating turns (kernel, library, library, kernel, ...), and prints
every reading and two ratios kernel/library: the mean of the first two
turns of each (the bar's reading before it took medians) and the median
of all ``P`` (``chip_smoke.NORM_BAR_PAIRS``). Last, the spread of each
ratio over the rounds. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
from chip_smoke import (NORM_BAR_PAIRS, _ln_inputs, _turns,  # noqa: E402
                        device_ms)

ROWS, FEATURES = 1000, 200


def one_round(pairs: int) -> None:
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops.fused_norms import layer_norm_bwd
    x, dy, gamma, beta = _ln_inputs(torch.bfloat16, ROWS, FEATURES)
    xr, gr, br = (t.detach().clone().requires_grad_()
                  for t in (x, gamma, beta))
    lib_fwd = lambda: F.layer_norm(xr, (FEATURES,), gr, br, eps=1e-5)
    kernel = lambda: device_ms(lambda: layer_norm_bwd(x, gamma, dy))
    library = lambda: (device_ms(lambda: torch.autograd.grad(
        lib_fwd(), (xr, gr, br), dy)) - device_ms(lib_fwd))
    ks, ls = _turns(kernel, library, pairs)
    print(f"kernel_ms={','.join(f'{k:.5f}' for k in ks)}")
    print(f"library_ms={','.join(f'{v:.5f}' for v in ls)}")
    two = (ks[0] + ks[1]) / (ls[0] + ls[1])
    med = statistics.median(ks) / statistics.median(ls)
    print(f"ratio_two_turns={two:.4f} ratio_median={med:.4f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--pairs", type=int, default=NORM_BAR_PAIRS)
    ap.add_argument("--one", action="store_true",
                    help="run one round in this process")
    args = ap.parse_args()
    if args.one:
        one_round(args.pairs)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"K9 layer_norm_bwd bf16 rows={ROWS} F={FEATURES} [{smi}]")
    two, med = [], []
    for r in range(args.rounds):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", "--pairs",
             str(args.pairs)], capture_output=True, text=True, check=True,
            timeout=600).stdout
        print(f"round {r}:\n{out.rstrip()}", flush=True)
        m = re.search(r"ratio_two_turns=([\d.]+) ratio_median=([\d.]+)",
                      out)
        two.append(float(m.group(1)))
        med.append(float(m.group(2)))
    print(f"two turns: kernel/library {min(two):.4f}-{max(two):.4f} over "
          f"{args.rounds} rounds; median of {args.pairs}: "
          f"{min(med):.4f}-{max(med):.4f} [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
