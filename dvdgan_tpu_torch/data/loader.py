"""Batching + background-prefetch loader — a copy of
`dvdgan_tpu/data/loader.py` (numpy only; same classes, same seeds, so the
same seed gives the same batches in the same order).

A thread-pool prefetcher: decode is numpy/PIL, and a bounded queue of ready
batches hides host latency behind device compute.

Yields (clip (B,T,H,W,C) float32, label (B,) int32) numpy batches; the
caller moves them to the device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, num_threads: int = 2,
                 rows: Optional[Tuple[int, int]] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        if prefetch < 1:
            # queue.Queue(maxsize=0) is UNBOUNDED — the worker would decode
            # the whole epoch ahead of the consumer (~100+ MB/batch at
            # 256px/48f). There is no "no prefetch": depth 1 is the floor.
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        self.prefetch = prefetch
        # rows: this process's [start, stop) slice of every GLOBAL batch
        # (multi-host input sharding, parallel.local_batch_rows). The
        # global shuffle/batch layout — a pure function of (seed, epoch) —
        # is identical on every host; each host decodes only its rows, so
        # pod-scale runs don't pay global-batch decode per host.
        if rows is not None:
            start, stop = rows
            if not (0 <= start < stop <= batch_size):
                raise ValueError(f"rows {rows} outside batch {batch_size}")
            if not drop_last:
                # a short final batch would slice to fewer (or zero) rows
                # on some hosts — desynced multi-host shapes at the next
                # collective. Refuse instead.
                raise ValueError("rows= (multi-host input sharding) "
                                 "requires drop_last=True")
        self.rows = rows
        self.num_threads = max(1, num_threads)
        # item decodes fan out over this pool (num_threads > 1); the decode
        # path (C++ clipops / PIL) releases the GIL, so threads give real
        # parallelism where it matters (256px/48f clip assembly)
        self._pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(self.num_threads)
            if self.num_threads > 1 else None)
        self._epoch_workers = 0

    def close(self) -> None:
        """Shut down the decode thread pool. A training loop keeps one Loader
        for the process lifetime so it never needs this; tools that sweep
        Loader configurations must call it
        or leak an idle pool per sweep point."""
        if self._epoch_workers:
            # closing under an active prefetch worker races its _pool use:
            # shutdown-then-None could raise 'cannot schedule new futures'
            # inside the worker or silently flip it to the serial branch
            # mid-epoch — refuse loudly instead
            raise RuntimeError(
                "Loader.close() called while an epoch()/forever() prefetch "
                "worker is active — exhaust or abandon the iterator first "
                "(its cleanup joins the worker)")
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
            self.num_threads = 1

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.ds)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        if self.drop_last:
            idx = idx[: (n // self.batch_size) * self.batch_size]
        return idx

    def _make_batch(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        if self.rows is not None:
            indices = indices[self.rows[0]:self.rows[1]]
        if self._pool is not None:
            items = list(self._pool.map(self.ds.__getitem__,
                                        (int(i) for i in indices)))
        else:
            items = [self.ds[int(i)] for i in indices]
        clips, labels = zip(*items)
        return np.stack(clips), np.asarray(labels, np.int32)

    def batches_per_epoch(self) -> int:
        n = len(self.ds)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch: int = 0, start_batch: int = 0
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One pass over the data with background prefetch; `start_batch`
        skips the first batches (within-epoch resume: the shuffle order is
        a pure function of (seed, epoch), so skipping replays exactly the
        stream an uninterrupted run would have produced)."""
        if hasattr(self.ds, "set_epoch"):
            self.ds.set_epoch(epoch)
        idx = self._epoch_indices(epoch)
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        batches = batches[start_batch:]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    q.put(self._make_batch(b))
            except BaseException as e:        # surface decode errors to the
                q.put(e)                      # consumer — a swallowed error
            finally:                          # would silently truncate the
                q.put(None)                   # epoch and desync resume

        th = threading.Thread(target=worker, daemon=True)
        self._epoch_workers += 1
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # a consumer abandoning the generator early leaves the worker
            # blocked in q.put on the full queue; drain until it exits so
            # the thread (and its in-flight decoded batches — hundreds of
            # MB at 256px/48f) don't leak for the process lifetime
            while th.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            th.join()
            self._epoch_workers -= 1

    def forever(self, start_epoch: int = 0, start_batch: int = 0
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Endless stream (the reference's `while True: next(loader)`);
        (start_epoch, start_batch) resumes mid-stream exactly."""
        if self.batches_per_epoch() == 0:
            # an empty epoch would spin forever (thread+queue per lap)
            # with next(data) never returning — fail loudly instead
            raise ValueError(
                f"dataset of {len(self.ds)} items yields zero batches at "
                f"batch_size={self.batch_size} (drop_last="
                f"{self.drop_last})")
        e = start_epoch
        while True:
            yield from self.epoch(e, start_batch)
            start_batch = 0
            e += 1
