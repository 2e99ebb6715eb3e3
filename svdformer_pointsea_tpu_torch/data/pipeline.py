"""Fixed-shape batches with threaded loading (semantics of
svdformer_pointsea_tpu/data/pipeline.py ``Batch`` / ``Loader``).

Every batch has exactly ``batch_size`` samples: the trailing remainder is
padded by repeating the batch's first samples, and ``Batch.valid`` counts the
real ones. All data randomness derives from (seed, epoch, index): the shuffle
order from (seed, epoch), each sample's transform draws from (seed, epoch,
index), so a run resumed at epoch k sees exactly the batches the straight run
saw, and the same files give the JAX package's arrays bit for bit.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np


class Batch:
    """Stacked f32 arrays (``data``), ids, and the number of valid rows."""

    __slots__ = ("taxonomy_ids", "model_ids", "data", "valid")

    def __init__(self, taxonomy_ids, model_ids, data, valid):
        self.taxonomy_ids = taxonomy_ids
        self.model_ids = model_ids
        self.data = data
        self.valid = valid


def _seeded(*key: int) -> np.random.RandomState:
    return np.random.RandomState(np.random.SeedSequence(list(key)).generate_state(1)[0])


_PREFETCH = 4  # batches queued ahead of the consumer


class Loader:
    """Batches of ``dataset`` (``dataset.__getitem__(index, rng)`` -> (taxonomy
    id, model id, dict of arrays)), loaded by ``num_workers`` threads and
    queued ahead of the consumer. Each ``__iter__`` is one epoch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self._epoch = 0  # bumped by each __iter__

    def set_epoch(self, epoch: int) -> None:
        """The (1-based) epoch of the next ``__iter__``; without it epochs
        count 1, 2, ... per iteration."""
        self._epoch = int(epoch) - 1

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _batches_indices(self, epoch: int) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            _seeded(self.seed, epoch).shuffle(order)
        return [order[i:i + self.batch_size] for i in range(0, n, self.batch_size)]

    def __iter__(self) -> Iterator[Batch]:
        self._epoch += 1
        epoch = self._epoch
        batches = self._batches_indices(epoch)
        q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH)
        sentinel = object()

        def fetch(i):
            return self.dataset.__getitem__(int(i), rng=_seeded(self.seed, epoch, int(i)))

        # Set when the consumer leaves early (a max_steps break): the producer
        # then stops instead of blocking on the full queue.
        abandoned = threading.Event()

        def put(item) -> bool:
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(max(1, self.num_workers)) as pool:
                    for chunk in batches:
                        if abandoned.is_set() or not put(self._collate(list(pool.map(fetch, chunk)))):
                            return
                put(sentinel)
            except BaseException as e:  # noqa: BLE001 - raised again on the consumer's side
                put(e)

        threading.Thread(target=produce, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            abandoned.set()

    def _collate(self, samples) -> Batch:
        valid = len(samples)
        while len(samples) < self.batch_size:  # pad by repeating
            samples.append(samples[len(samples) % valid])
        data: Dict[str, np.ndarray] = {
            k: np.stack([s[2][k] for s in samples]).astype(np.float32) for k in samples[0][2]}
        return Batch([s[0] for s in samples], [s[1] for s in samples], data, valid)
