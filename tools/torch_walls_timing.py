#!/usr/bin/env python3
"""Time the port's host-bound walls, serving and the BERT fine-tune step,
of this checkout against another one on one NVIDIA card, in turns.

    python3 tools/torch_walls_timing.py --against DIR [--rounds N]

``DIR`` is the root of an unpacked checkout (for instance a parent commit
from ``git archive``). The tool runs ``python3 chip_smoke.py --phases
serve,finetune`` of each tree, one process each, in the order DIR, this
checkout, this checkout, DIR, ``N`` times over (default 2), and reads
from each run the serve phase's p50 TTFT, tokens/s and mean decode step
and the fine-tune phase's mean step. It prints every reading, then each
metric's median per tree and the change/parent ratio of the medians.
Each tree builds its kernels in its own checkout on its first run.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: metric -> (pattern in chip_smoke's output, True when higher is better)
METRICS = {
    "serve_p50_ttft_s": (r"serve: requests=.* p50_ttft_s=([0-9.]+)", False),
    "serve_tokens_per_s": (r"serve: requests=.* tokens_per_s=([0-9.]+)",
                           True),
    "serve_mean_step_ms": (r"serve: requests=.* mean_step_ms=([0-9.]+)",
                           False),
    "finetune_step_ms": (r"finetune: B=.* mean_step_ms=([0-9.]+)", False),
}


def run_tree(tree: str, timeout: int) -> dict:
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py", "--phases", "serve,finetune"],
        cwd=tree, capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"chip_smoke.py in {tree} exited "
                         f"{proc.returncode}")
    got = {}
    for name, (pattern, _) in METRICS.items():
        m = re.search(pattern, proc.stdout)
        if m is None:
            raise SystemExit(f"no {name} in the output of {tree}")
        got[name] = float(m.group(1))
    card = re.search(r"\[(NVIDIA[^\]]*)\]", proc.stdout)
    got["card"] = card.group(1) if card else "card not printed"
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--timeout", type=int, default=600,
                    help="seconds allowed for one chip_smoke.py run")
    args = ap.parse_args(argv)
    trees = {"parent": os.path.abspath(args.against), "change": HERE}
    readings = {"parent": [], "change": []}
    for r in range(args.rounds):
        for label in ("parent", "change", "change", "parent"):
            got = run_tree(trees[label], args.timeout)
            readings[label].append(got)
            print(f"round {r} {label}: "
                  + " ".join(f"{k}={got[k]}" for k in METRICS)
                  + f" [{got['card']}]", flush=True)
    for name, (_, higher) in METRICS.items():
        med = {k: statistics.median(g[name] for g in v)
               for k, v in readings.items()}
        ratio = med["change"] / med["parent"]
        print(f"{name}: median parent={med['parent']} change="
              f"{med['change']} change/parent={ratio:.4f} "
              f"({'higher' if higher else 'lower'} is better)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
