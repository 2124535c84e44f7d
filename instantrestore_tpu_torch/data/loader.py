"""A prefetching data loader on host threads (counterpart of
``instantrestore_tpu/data/loader.py``): workers collate whole batches of
numpy items (the degradation chain is numpy, OpenCV and libjpeg work that
releases the GIL) and the loader yields them in order.

The order is the JAX package's: the indices are shuffled by
``np.random.default_rng(seed + epoch)`` and cut into batches, the last
partial one dropped with ``drop_last``; ``start_at`` sets the epoch and batch the next iteration
starts from. ``process_index`` /
``process_count`` give each process its contiguous slice of every global
batch (``batch_size`` stays the global size), for a multi-process run.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List

import numpy as np

from instantrestore_tpu_torch.data.datasets import collate


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        num_workers: int = 8,
        drop_last: bool = True,
        collate_fn: Callable = collate,
        prefetch: int = 4,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ):
        if process_count > 1:
            if batch_size % process_count:
                raise ValueError(f"global batch_size={batch_size} must divide evenly over "
                                 f"{process_count} processes")
            if not drop_last:
                raise ValueError("a multi-process loader needs drop_last=True (a partial final "
                                 "batch cannot split evenly across processes)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self._epoch = 0
        self._skip = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def start_at(self, epoch: int, batch: int = 0) -> None:
        """Make the next iteration epoch ``epoch`` (its shuffle), from its
        batch ``batch`` on: a resumed run's place in the data."""
        self._epoch, self._skip = epoch, batch

    def _batch_indices(self) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size].tolist()
                   for i in range(len(self))]
        if self.process_count > 1:
            per = self.batch_size // self.process_count
            lo = self.process_index * per
            batches = [b[lo:lo + per] for b in batches]
        return batches

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._batch_indices()[self._skip:]
        self._epoch += 1
        self._skip = 0
        work_q: "queue.Queue" = queue.Queue()
        results: Dict[int, Any] = {}
        ready_cv = threading.Condition(threading.Lock())
        stop = threading.Event()
        # at most the prefetch window plus one batch per worker in flight
        budget = threading.Semaphore(self.prefetch + self.num_workers)
        for bi, batch in enumerate(batches):
            work_q.put((bi, batch))

        def worker():
            while not stop.is_set():
                budget.acquire()
                try:
                    bi, batch_idx = work_q.get_nowait()
                except queue.Empty:
                    budget.release()
                    return
                try:
                    result = self.collate_fn([self.dataset[i] for i in batch_idx])
                except Exception as e:  # raised again in the consumer
                    result = e
                with ready_cv:
                    results[bi] = result
                    ready_cv.notify_all()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for next_bi in range(len(batches)):
                with ready_cv:
                    while next_bi not in results:
                        ready_cv.wait(timeout=1.0)
                    result = results.pop(next_bi)
                budget.release()
                if isinstance(result, Exception):
                    raise result
                yield result
        finally:
            stop.set()
