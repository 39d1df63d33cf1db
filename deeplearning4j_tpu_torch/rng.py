"""Seed arithmetic and the generators of the port's random draws
(below ``nn`` and ``perf``: both use it, it uses neither).

A training forward hands each layer an integer seed (the counterpart of
a ``jax.random`` key): :func:`split_seed` and :func:`fold_in` derive new
seeds, and every draw (dropout, weight noise) takes its generator from
:func:`generator`, eagerly a new ``torch.Generator`` seeded with the
seed.

A seed may also be a :class:`SymbolicSeed`, whose value is known only
when the draw runs (a CUDA graph's replay draws anew each time): it
splits, folds and hands out its draw site's generator itself. The layers
see the same three functions either way.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class SymbolicSeed:
    """A seed whose value each run supplies: subclasses derive their
    splits and folds, and own the generator each draw site takes."""

    def split(self, n: int) -> Tuple["SymbolicSeed", ...]:
        raise NotImplementedError

    def fold(self, data: int) -> "SymbolicSeed":
        raise NotImplementedError

    def generator(self, device) -> torch.Generator:
        raise NotImplementedError


def split_seed(seed: int, n: int = 2) -> Tuple[int, ...]:
    """``n`` independent seeds derived from ``seed`` (a deterministic
    counterpart of ``jax.random.split``)."""
    if isinstance(seed, SymbolicSeed):
        return seed.split(n)
    state = np.random.SeedSequence(int(seed)).generate_state(n)
    return tuple(int(s) for s in state)


def fold_in(seed: int, data: int) -> int:
    """A seed derived from ``seed`` and ``data`` (the counterpart of
    ``jax.random.fold_in``)."""
    if isinstance(seed, SymbolicSeed):
        return seed.fold(data)
    return int(np.random.SeedSequence([int(seed), int(data)])
               .generate_state(1)[0])


def generator(device, seed) -> torch.Generator:
    """The generator a draw of ``seed`` takes on ``device``: a new
    ``torch.Generator`` seeded with it, or a symbolic seed's own."""
    if isinstance(seed, SymbolicSeed):
        return seed.generator(device)
    return torch.Generator(device=device).manual_seed(int(seed))
