"""Training listeners (port of ``deeplearning4j_tpu/train/listeners.py``)
— reference: ``org.deeplearning4j.optimize.api.TrainingListener`` and
its implementations (ScoreIterationListener, PerformanceListener,
CheckpointListener, EvaluativeListener, CollectScoresIterationListener).

The networks call ``iteration_done`` after each step's loss reached the
host (in a ``steps_per_loop`` region, once per step after the group's
one device-to-host copy) and ``on_epoch_start``/``on_epoch_end`` around
each epoch of an iterator's ``fit``. A listener reads the step's loss
from ``net.score_`` (:func:`_step_score`) and never scores the network
again. ``CheckpointListener(sharded=True)`` (the orbax path) comes with
ROADMAP A14.
"""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Optional

from deeplearning4j_tpu_torch.resilience.checkpoint import manifest_path
from deeplearning4j_tpu_torch.serialization import ModelSerializer

logger = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    def iteration_done(self, net, iteration: int, epoch: int):
        pass

    def on_epoch_start(self, net):
        pass

    def on_epoch_end(self, net):
        pass


def _step_score(net) -> float:
    """The fit loop's already-computed step loss (``net.score_``, a host
    float) — listeners never call ``net.score()`` per iteration: scoring
    a dataset would run an extra forward and a device sync just to log a
    number the step already produced."""
    return net.score_


class ScoreIterationListener(TrainingListener):
    """Logs score every N iterations (reference ScoreIterationListener)."""

    def __init__(self, print_iterations: int = 10):
        self.n = print_iterations

    def iteration_done(self, net, iteration, epoch):
        if iteration % self.n == 0:
            logger.info("Score at iteration %d is %s", iteration,
                        _step_score(net))


class PerformanceListener(TrainingListener):
    """Throughput/ETL timing (reference PerformanceListener)."""

    def __init__(self, frequency: int = 10, report=None,
                 iterator=None):
        """``iterator``: pass the AsyncDataSetIterator feeding fit() to
        include its cumulative ETL-wait in the report (the reference's
        ETL-time column)."""
        self.frequency = frequency
        self._last_time = None
        self._last_iter = None
        self._report = report or (lambda msg: logger.info("%s", msg))
        self._iterator = iterator
        self._last_etl = 0.0

    def iteration_done(self, net, iteration, epoch):
        now = time.perf_counter()
        if self._last_time is not None and \
                iteration % self.frequency == 0:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            if dt > 0 and iters > 0:
                msg = (f"iter {iteration}: {iters / dt:.1f} iter/sec, "
                       f"score {_step_score(net):.5f}")
                etl = getattr(self._iterator, "etl_wait_seconds", None)
                if etl is not None:
                    msg += (f", ETL wait "
                            f"{(etl - self._last_etl) * 1e3:.1f} ms")
                    self._last_etl = etl
                self._report(msg)
        if iteration % self.frequency == 0:
            self._last_time = now
            self._last_iter = iteration


class CheckpointListener(TrainingListener):
    """Periodic checkpoints with keep-last-K (reference
    CheckpointListener: every N iters/epochs, keepLast policies)."""

    def __init__(self, save_dir, save_every_n_iterations: Optional[int]
                 = None, save_every_n_epochs: Optional[int] = None,
                 keep_last: int = 3, sharded: bool = False):
        """Writes ``checkpoint_iter_<n>.zip`` or ``checkpoint_epoch_<n>.zip``
        with ``ModelSerializer`` and keeps the newest ``keep_last`` (by
        modification time), dropping each pruned file's manifest with
        it. ``sharded=True`` (the orbax ShardedCheckpointer) is refused:
        it comes with ROADMAP A14."""
        if sharded:
            raise NotImplementedError(
                "CheckpointListener(sharded=True): the orbax "
                "ShardedCheckpointer comes with ROADMAP A14")
        self.dir = Path(save_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.every_iter = save_every_n_iterations
        self.every_epoch = save_every_n_epochs
        self.keep_last = keep_last

    def _save(self, net, tag: str):
        path = self.dir / f"checkpoint_{tag}.zip"
        ModelSerializer.write_model(net, path)
        ckpts = sorted(self.dir.glob("checkpoint_*.zip"),
                       key=lambda p: p.stat().st_mtime)
        for old in ckpts[:-self.keep_last]:
            old.unlink()
            # drop the CRC manifest sidecar with its checkpoint
            manifest_path(old).unlink(missing_ok=True)

    def iteration_done(self, net, iteration, epoch):
        if self.every_iter and iteration % self.every_iter == 0:
            self._save(net, f"iter_{iteration}")

    def on_epoch_end(self, net):
        if self.every_epoch and (net.epoch + 1) % self.every_epoch == 0:
            self._save(net, f"epoch_{net.epoch}")

    def flush(self):
        """Nothing to wait for: the zip saves are synchronous."""


class EvaluativeListener(TrainingListener):
    """Periodic eval during training (reference EvaluativeListener)."""

    def __init__(self, iterator, frequency_iters: int = 0,
                 frequency_epochs: int = 1, callback=None):
        self.iterator = iterator
        self.frequency_iters = frequency_iters
        self.frequency_epochs = frequency_epochs
        self.callback = callback or (
            lambda e: logger.info("\n%s", e.stats()))
        self.last_evaluation = None

    def _eval(self, net):
        e = net.evaluate(self.iterator)
        self.last_evaluation = e
        self.callback(e)

    def iteration_done(self, net, iteration, epoch):
        if self.frequency_iters and iteration % self.frequency_iters == 0:
            self._eval(net)

    def on_epoch_end(self, net):
        if self.frequency_epochs and \
                (net.epoch + 1) % self.frequency_epochs == 0:
            self._eval(net)


class CollectScoresListener(TrainingListener):
    """Collects (iteration, score) pairs (reference
    CollectScoresIterationListener)."""

    def __init__(self):
        self.scores = []

    def iteration_done(self, net, iteration, epoch):
        self.scores.append((iteration, _step_score(net)))
