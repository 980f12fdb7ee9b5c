"""Asynchronous training-data loaders (a copy of s4g_tpu/runtime/loader.py:
the port reads no module of the JAX package): background threads prefetch
and collate scene pickles while the device runs the previous step.

Each yields device-ready batches: the dataset's numpy arrays as tensors in
the dtypes the model and the losses take (`train.dataset.
batch_to_tensors`), in pinned host memory where a GPU is present, so the
trainer's copy to the card does not block the host.

`AsyncSceneLoader` marks two spans (`utils.profiling`), each with the
loader's batch number as its call id: `loader.collate`, one batch drawn
from the dataset by the feeder thread, and `loader.wait`, the consumer's
wait for the next batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ..train.dataset import batch_to_tensors
from ..utils.profiling import span


def _device_ready(batch: dict) -> dict:
    return batch_to_tensors(batch, pin_memory=torch.cuda.is_available())


class AsyncSceneLoader:
    """Wraps a SceneGraspDataset(-like) iterable with prefetching workers."""

    def __init__(self, dataset, num_workers: int = 2, prefetch: int = 4):
        self.dataset = dataset
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        # Batches drawn from the dataset and handed out, over all passes.
        self._drawn = self._served = 0

    def __len__(self):
        return len(self.dataset)

    def __iter__(self) -> Iterator[dict]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        idx_q: "queue.Queue" = queue.Queue()
        stop = threading.Event()

        # one pass of batch "recipes": the dataset's own iterator already
        # shuffles, so workers pull pre-built batches from a feeder thread.
        def feeder():
            try:
                batches = iter(self.dataset)
                while True:
                    with span("loader.collate", call=self._drawn):
                        batch = next(batches, None)
                    if batch is None or stop.is_set():
                        break
                    self._drawn += 1
                    idx_q.put(batch)
            finally:
                for _ in range(self.num_workers):
                    idx_q.put(None)

        def worker():
            while not stop.is_set():
                item = idx_q.get()
                if item is None:
                    out_q.put(None)
                    return
                out_q.put(_device_ready(item))

        threads = [threading.Thread(target=feeder, daemon=True)]
        threads += [threading.Thread(target=worker, daemon=True)
                    for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        finished = 0
        try:
            while finished < self.num_workers:
                with span("loader.wait", call=self._served):
                    item = out_q.get()
                if item is None:
                    finished += 1
                    continue
                self._served += 1
                yield item
        finally:
            stop.set()
            # drain so threads unblock
            while not idx_q.empty():
                try:
                    idx_q.get_nowait()
                except queue.Empty:
                    break


class FileBackedSceneLoader:
    """Parallel file loading variant: workers each open and collate scene
    pickles (the expensive host work) concurrently."""

    def __init__(self, dataset, num_workers: int = 4, prefetch: int = 8):
        self.dataset = dataset
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self):
        return len(self.dataset)

    def __iter__(self) -> Iterator[dict]:
        files = list(self.dataset.files)
        order = self.dataset.rng.permutation(len(files))
        batch_size = self.dataset.batch_size
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        task_q: "queue.Queue" = queue.Queue()
        for pos, i in enumerate(order):
            task_q.put((pos, files[i]))
        for _ in range(self.num_workers):
            task_q.put(None)

        def worker():
            while True:
                task = task_q.get()
                if task is None:
                    out_q.put(None)
                    return
                pos, path = task
                sample = self.dataset._load_one(path)
                out_q.put((pos, sample))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        next_pos = 0
        finished = 0
        batch: list = []
        pending: dict = {}
        total = len(order)
        while next_pos < total and finished < self.num_workers + 1:
            item = out_q.get()
            if item is None:
                finished += 1
                continue
            pos, sample = item
            pending[pos] = sample
            while next_pos in pending:
                batch.append(pending.pop(next_pos))
                next_pos += 1
                if len(batch) == batch_size:
                    yield _device_ready({k: np.stack([s[k] for s in batch])
                                         for k in batch[0]})
                    batch = []
