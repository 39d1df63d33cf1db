#!/usr/bin/env python3
"""Time the port's threshold decode (K11) on one NVIDIA card at every
gradient leaf shape of the data-parallel LM's packed step, for the
checkout this file sits in or another one.

    python3 tools/torch_codec_timing.py              # this checkout
    python3 tools/torch_codec_timing.py --tree DIR   # another tree
    python3 tools/torch_codec_timing.py --against DIR [--rounds N]

``DIR`` is the root of an unpacked checkout (for instance a parent commit
from ``git archive``). With ``--against DIR`` the tool runs itself in the
order DIR, this checkout, this checkout, DIR, ``N`` times over (one
process each), so that two versions are timed on one card in turns, and
prints every reading, each round's change/parent ratio and the ratio of
the sums. At each of the five leaf shapes of ``chip_smoke.DECODE_LEAVES``
it prints the device time per call by CUDA-graph replay of 100 calls
(the small leaves take ~2 µs), the host time per call (CUDA events
around 20 eager calls) and the write ceiling (``fill_(0.0)`` of an f32
buffer of the leaf's size, by CUDA-graph replay) and the exchange's work
on one leaf (``exchange_packed``: every rank's words decoded and summed,
then divided by the ranks) at 1 and at 4 ranks, by CUDA-graph replay.
Last, one step's sums: each shape's time times its leaves in the
step ([2048, 768] counted at [768, 2048]'s time). The timing helpers
and the leaf list are ``chip_smoke.py``'s. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# this checkout's helpers, imported before any other tree is on the path
sys.path.insert(0, HERE)
from chip_smoke import DECODE_LEAVES, device_ms, time_ms  # noqa: E402

#: ranks of the exchange timed at each leaf
RANKS = (1, 4)


def time_tree(tree: str, label: str) -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_codec_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(tree))
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    card = f"[{smi.splitlines()[0] if smi else 'nvidia-smi: no output'}]"
    tag = f"{label} " if label else ""
    print(f"{tag}tree={os.path.abspath(tree)} module={ck.__file__} {card}",
          flush=True)
    tau = torch.tensor(1e-3, device="cuda")
    step = {}
    for i, (shape, leaves) in enumerate(DECODE_LEAVES):
        n = 1
        for d in shape:
            n *= d
        g = torch.Generator(device="cuda").manual_seed(i)
        words = [torch.randint(-2 ** 31, 2 ** 31 - 1,
                               (ck.threshold_words(n),), generator=g,
                               device="cuda", dtype=torch.int32)
                 for _ in range(max(RANKS))]
        buf = torch.empty(n, dtype=torch.float32, device="cuda")

        def exchange(ranks):
            def run():
                s = ck.threshold_decode(words[0], tau, n, shape)
                for w in words[1:ranks]:
                    s += ck.threshold_decode(w, tau, n, shape)
                return s / ranks
            return run

        call = lambda: ck.threshold_decode(words[0], tau, n, shape)
        times = {"kernel": device_ms(call, iters=100)}
        line = (f"{tag}K11 {list(shape)} x{leaves}: kernel_ms="
                f"{times['kernel']:.6f} host_ms={time_ms(call):.4f} "
                f"write_ceiling_ms="
                f"{device_ms(lambda: buf.fill_(0.0), iters=100):.6f}")
        for r in RANKS:
            times[f"exchange{r}"] = device_ms(exchange(r), iters=100)
            line += f" exchange{r}_ms={times[f'exchange{r}']:.6f}"
        for name, t in times.items():
            step[name] = step.get(name, 0.0) + leaves * t
        print(f"{line} {card}", flush=True)
        del words, buf
    print(f"{tag}K11 one step, {sum(c for _, c in DECODE_LEAVES)} leaves: "
          + " ".join(f"{name}_ms={t:.6f}" for name, t in step.items())
          + f" {card}", flush=True)
    return 0


def against(parent: str, rounds: int) -> int:
    """Parent, this checkout, this checkout, parent, ``rounds`` times:
    one process each; then every tree's kernel readings a shape and a
    step, each round's change/parent ratio and that of the sums."""
    got = {}
    for r in range(rounds):
        for label, tree in (("parent", parent), ("change", HERE),
                            ("change", HERE), ("parent", parent)):
            res = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--tree", tree, "--label", label],
                                 capture_output=True, text=True)
            sys.stdout.write(res.stdout)
            sys.stderr.write(res.stderr[-4000:])
            if res.returncode:
                return res.returncode
            for m in re.finditer(r"^\w+ K11 (\[[\d, ]+\]|one step)\S* .*?"
                                 r"kernel_ms=([\d.]+)", res.stdout, re.M):
                got.setdefault((m.group(1), label), []).append(
                    (r, float(m.group(2))))
    for what in [str(list(s)) for s, _ in DECODE_LEAVES] + ["one step"]:
        p, c = (got[(what, k)] for k in ("parent", "change"))
        per_round = [sum(t for q, t in c if q == r)
                     / sum(t for q, t in p if q == r) for r in range(rounds)]
        print(f"K11 {what}: parent_ms={'/'.join(f'{t:.6f}' for _, t in p)} "
              f"change_ms={'/'.join(f'{t:.6f}' for _, t in c)} "
              f"change/parent by round="
              f"{'/'.join(f'{x:.3f}' for x in per_round)} change/parent="
              f"{sum(t for _, t in c) / sum(t for _, t in p):.3f}",
              flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=HERE,
                    help="root of the checkout to time")
    ap.add_argument("--label", default="", help="tag for the output lines")
    ap.add_argument("--against", metavar="DIR",
                    help="time DIR and this checkout in turns (P C C P)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="P C C P rounds with --against")
    args = ap.parse_args(argv)
    if args.against:
        return against(args.against, args.rounds)
    return time_tree(args.tree, args.label)


if __name__ == "__main__":
    sys.exit(main())
