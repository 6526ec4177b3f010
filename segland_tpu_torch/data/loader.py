"""Threaded prefetching batch loader (in place of torch DataLoader +
DistributedSampler, reference engine.py:77-118).  Own copy of
segland_tpu/data/loader.py.

With several processes, pass process_index/process_count and each process
loads its contiguous shard of the global batch (the DistributedSampler
equivalent).  ``drop_last`` matches the reference train loader, whose global
batch must divide by the process count.  Without it (eval) a process's share
is ceil(batch / count) rows, as the JAX mesh shards a batch padded to it, so
a short batch may leave a process a short share or none: it then skips that
batch.
"""

import queue
import random as _random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


def _collate(samples):
    """Stack a list of per-sample tuples into arrays; passthrough strings."""
    out = []
    for parts in zip(*samples):
        if isinstance(parts[0], np.ndarray):
            out.append(np.stack(parts, axis=0))
        else:
            out.append(list(parts))
    return tuple(out)


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        # intra-batch parallel decode (PIL/rasterio release the GIL);
        # replaces torch DataLoader workers (reference engine.py:81-96)
        self.num_workers = num_workers
        if drop_last and batch_size % process_count != 0:
            raise ValueError("global batch must divide process count")
        self.local_batch = -(-batch_size // process_count)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            _random.Random(self.seed + self.epoch).shuffle(idx)
        # per-process contiguous shard of each global batch
        n_batches = len(idx) // self.batch_size if self.drop_last else -(-len(idx) // self.batch_size)
        for b in range(n_batches):
            chunk = idx[b * self.batch_size : (b + 1) * self.batch_size]
            lo = self.process_index * self.local_batch
            share = chunk[lo : lo + self.local_batch]
            if share:
                yield share

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()

        pool = ThreadPoolExecutor(self.num_workers) if self.num_workers > 0 else None

        get_batch = getattr(self.dataset, "get_batch", None)

        def fetch(chunk):
            if get_batch is not None:
                batch = get_batch(chunk)  # native batched decode fast path
                if batch is not None:
                    return batch
            if pool is not None and len(chunk) > 1:
                return _collate(list(pool.map(self.dataset.__getitem__, chunk)))
            return _collate([self.dataset[i] for i in chunk])

        def worker():
            try:
                for chunk in self._indices():
                    q.put(fetch(chunk))
            finally:
                q.put(stop)
                if pool is not None:
                    pool.shutdown(wait=False)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
