"""DataSet iterators (port of ``deeplearning4j_tpu/data/iterators.py``) —
reference: ``org.nd4j.linalg.dataset.api.iterator.DataSetIterator``,
``ListDataSetIterator`` and ``AsyncDataSetIterator``: batches of host
numpy arrays, each network moving a batch to its device when it takes
it.

Every batch an iterator of this package yields passes through
:meth:`DataSetIterator._apply_pp`: the ``iterator`` fault site fires
there (``resilience/faults.py``; with no plan active it costs one
branch), then the normaliser set by ``set_pre_processor`` transforms the
features. ``BucketedSequenceIterator`` pads variable-length sequence
batches to a few lengths. ``TfDataSetIterator`` (no TensorFlow on the
card's machine) is not ported.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Iterator, List

import numpy as np

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.resilience import faults


class DataSetIterator:
    """Base iterator; subclasses override ``__iter__`` and pass every
    batch through :meth:`_apply_pp`."""

    def __init__(self, batch_size: int = 32):
        self.batch_size = batch_size
        self.pre_processor = None  # normalizer hook (reference name)

    def reset(self):
        pass

    def set_pre_processor(self, p):
        self.pre_processor = p

    def _apply_pp(self, ds: DataSet) -> DataSet:
        # site: iterator next — every batch any subclass yields passes
        # through here (resilience/faults.py; off path is one branch)
        faults.inject("iterator")
        if self.pre_processor is not None:
            ds = self.pre_processor.transform_dataset(ds)
        return ds

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError


class ListDataSetIterator(DataSetIterator):
    """Iterates a list of batches, or one ``DataSet`` cut into
    ``batch_size`` rows, reshuffled each pass with seed ``seed + epoch``
    when ``shuffle`` is set (reference ListDataSetIterator)."""

    def __init__(self, data, batch_size: int = 32, shuffle: bool = False,
                 seed: int = 0):
        super().__init__(batch_size)
        self._data = data
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        if isinstance(self._data, DataSet):
            n = self._data.features.shape[0]
            return -(-n // self.batch_size)
        return len(self._data)

    def __iter__(self):
        data = self._data
        if isinstance(data, DataSet):
            if self.shuffle:
                data = data.shuffle(self.seed + self._epoch)
                self._epoch += 1
            for b in data.batch_by(self.batch_size):
                yield self._apply_pp(b)
        else:
            for b in data:
                yield self._apply_pp(b)


class _ClosableQueue:
    """A bounded FIFO between one producer and one consumer that either
    side can close: ``put`` returns False once closed (the consumer left
    early), ``get`` raises ``StopIteration`` once closed and drained."""

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._items: deque = deque()
        self._closed = False
        self._cv = threading.Condition()

    def put(self, item) -> bool:
        with self._cv:
            while len(self._items) >= self.capacity and not self._closed:
                self._cv.wait()
            if self._closed:
                return False
            self._items.append(item)
            self._cv.notify_all()
            return True

    def get(self):
        with self._cv:
            while not self._items and not self._closed:
                self._cv.wait()
            if not self._items:
                raise StopIteration
            item = self._items.popleft()
            self._cv.notify_all()
            return item

    def qsize(self) -> int:
        with self._cv:
            return len(self._items)

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch wrapper (reference
    AsyncDataSetIterator): a worker thread draws up to ``queue_size``
    batches of ``base`` ahead of the consumer, so the host's ETL
    overlaps the card's step. ``etl_wait_seconds`` accumulates the time
    the consumer blocked on the queue (the reference PerformanceListener's
    ETL-wait column; also ``dl4j_tpu_prefetch_wait_seconds_total``). An
    error of ``base`` reaches the consumer after the batches before it;
    a consumer that stops early closes the queue, and the worker ends."""

    def __init__(self, base, queue_size: int = 4):
        # base may be any iterable of DataSets; batch_size is None when
        # the base does not declare one
        super().__init__(getattr(base, "batch_size", None))
        self.base = base
        self.queue_size = queue_size
        #: cumulative seconds the consumer blocked waiting on ETL
        self.etl_wait_seconds = 0.0

    def __len__(self):
        return len(self.base)

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()

    def __iter__(self):
        q = _ClosableQueue(self.queue_size)
        err: List[BaseException] = []

        def worker():
            obs.trace.set_thread_name("etl-prefetch")
            try:
                for ds in self.base:
                    if not q.put(ds):      # consumer closed early
                        return
            except BaseException as e:     # propagate to the consumer
                err.append(e)
            finally:
                q.close()

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                t0 = obs.now()
                try:
                    item = q.get()
                except StopIteration:
                    break
                finally:
                    dt = obs.now() - t0
                    self.etl_wait_seconds += dt
                    obs.metrics.PREFETCH_WAIT.inc(dt)
                    obs.metrics.PREFETCH_DEPTH.set(q.qsize())
                    if obs.trace.enabled():
                        obs.trace.add_span("AsyncDataSetIterator/wait",
                                           t0, t0 + dt)
                yield item
        finally:
            q.close()                      # unblock the producer on break
            t.join()
        if err:
            raise err[0]


class IteratorDataSetIterator(DataSetIterator):
    """Wraps any Python iterable of ``(x, y)`` examples into ``DataSet``
    batches of ``batch_size`` (the last one shorter)."""

    def __init__(self, iterable, batch_size: int = 32):
        super().__init__(batch_size)
        self._iterable = iterable

    def __iter__(self):
        xs, ys = [], []
        for x, y in self._iterable:
            xs.append(x)
            ys.append(y)
            if len(xs) == self.batch_size:
                yield self._apply_pp(DataSet(np.stack(xs), np.stack(ys)))
                xs, ys = [], []
        if xs:
            yield self._apply_pp(DataSet(np.stack(xs), np.stack(ys)))


class BucketedSequenceIterator(DataSetIterator):
    """Pads each sequence batch's time axis up to the smallest bucket
    length that holds it (a batch past the largest bucket passes as it
    is), masks keeping the math exact: the padded steps are masked out
    of the features and of [B, T, C] labels, a batch without masks gets
    ones over its real steps, and per-sequence labels (and their mask)
    are left alone. The JAX package buckets to bound its recompiles; in
    the port it bounds the distinct shapes a run sees. The batches come
    from ``base``, which already passed each through its own fault site
    and normaliser."""

    def __init__(self, base, buckets=(32, 64, 128, 256)):
        super().__init__(getattr(base, "batch_size", None))
        self.base = base
        self.buckets = sorted(buckets)

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()

    def _bucket_for(self, t: int) -> int:
        return next((b for b in self.buckets if t <= b), t)

    def __iter__(self):
        for ds in self.base:
            t = ds.features.shape[1]
            pad = self._bucket_for(t) - t
            if not pad:
                yield ds
                continue

            def pad_time(a):
                width = [(0, 0)] * a.ndim
                width[1] = (0, pad)
                return np.pad(np.asarray(a), width)

            fm = ds.features_mask
            if fm is None:            # padding needs a mask to be exact
                fm = np.ones(ds.features.shape[:2], np.float32)
            seq_labels = ds.labels is not None and ds.labels.ndim >= 3
            lm = ds.labels_mask
            if lm is None and seq_labels:
                lm = np.ones(ds.labels.shape[:2], np.float32)
            yield DataSet(pad_time(ds.features),
                          pad_time(ds.labels) if seq_labels else ds.labels,
                          features_mask=pad_time(fm),
                          labels_mask=pad_time(lm) if seq_labels else lm)
