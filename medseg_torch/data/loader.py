"""Batched data loader with threaded host prefetch (a copy of
``medseg/data/loader.py``).

MONAI/torch ``DataLoader(batch_size, shuffle, num_workers)`` as the reference
uses it, with its crop-list collation rule: a dataset item that is a list of
``num_samples`` crops is flattened into the batch, so ``batch_size=1`` with
4 crops gives a batch of 4, and the pretraining's ``batch_size=2`` with 2
crops gives 4 (``[vol1_crop1, vol1_crop2, vol2_crop1, vol2_crop2]``).

Worker threads (the decode and numpy resampling release the GIL), a bounded
prefetch queue so that preprocessing overlaps the device's work, an
epoch-seeded shuffle (``np.random.default_rng((seed, epoch))``, the JAX
package's order) and an optional ``device_put`` of each finished batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np


def collate(items: list) -> dict:
    """Flatten crop-lists and stack arrays; non-array metadata kept as lists."""
    flat: list[dict] = []
    for item in items:
        if isinstance(item, list):
            flat.extend(item)
        else:
            flat.append(item)
    if not flat:
        return {}
    batch: dict = {}
    for key in flat[0]:
        vals = [f[key] for f in flat if key in f]
        if len(vals) != len(flat):
            continue
        first = vals[0]
        if isinstance(first, np.ndarray) and all(
            isinstance(v, np.ndarray) and v.shape == first.shape for v in vals
        ):
            batch[key] = np.stack(vals)
        else:
            batch[key] = vals
    return batch


class DataLoader:
    """Iterate a dataset in shuffled batches with threaded prefetch."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        num_workers: int = 4,
        seed: int = 0,
        prefetch: int = 2,
        device_put: Callable | None = None,
        drop_last: bool = False,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.prefetch = max(prefetch, 1)
        self.device_put = device_put
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[dict]:
        indices = self._epoch_indices()
        self._epoch += 1
        n_batches = len(indices) // self.batch_size
        remainder = len(indices) % self.batch_size
        batches = [
            indices[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(n_batches)
        ]
        if remainder and not self.drop_last:
            batches.append(indices[-remainder:])

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    # keep `prefetch` batches in flight, in order
                    futures = []
                    for b in batches:
                        futures.append(pool.submit(self._make_batch, b))
                        while len(futures) > self.prefetch:
                            if stop.is_set():
                                return
                            out_q.put(("ok", futures.pop(0).result()))
                    for fut in futures:
                        if stop.is_set():
                            return
                        out_q.put(("ok", fut.result()))
                out_q.put(("done", None))
            except BaseException as e:  # surface worker errors to the consumer
                out_q.put(("err", e))

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                kind, payload = out_q.get()
                if kind == "done":
                    return
                if kind == "err":
                    raise payload
                yield payload
        finally:
            stop.set()

    def _make_batch(self, idx_batch: Sequence[int]) -> dict:
        items = [self.dataset[int(i)] for i in idx_batch]
        batch = collate(items)
        if self.device_put is not None:
            batch = self.device_put(batch)
        return batch
