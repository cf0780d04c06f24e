"""The mock dataset of the unconditional quickstart and a minimal batch
iterator (counterpart of ``MockImageDataset`` and the loader in
gigagan_tpu/data/datasets.py).  Images are float32 (h, w, c) numpy arrays
in [0, 1]; batches are stacked (b, h, w, c) arrays."""

from __future__ import annotations

import numpy as np


class DataLoader:
    """Batches of a map-style dataset: optional shuffle from a seeded
    numpy generator (a new permutation each pass), optional drop of the
    last partial batch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n, bs = len(self.dataset), self.batch_size
        return n // bs if self.drop_last else -(-n // bs)

    def __iter__(self):
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield np.stack([self.dataset[int(i)] for i in idx])


def cycle(dl):
    while True:
        yield from dl


class MockImageDataset:
    """Random images only, for the unconditional quickstart without data;
    the same pixels as the JAX package's for the same (seed, index)."""

    def __init__(self, image_size: int, length: int = int(1e5),
                 channels: int = 3, seed: int = 0):
        self.image_size = image_size
        self.channels = channels
        self.length = length
        self.seed = seed

    def get_dataloader(self, batch_size, **kwargs):
        kwargs.setdefault("shuffle", True)
        kwargs.setdefault("drop_last", True)
        return DataLoader(self, batch_size, **kwargs)

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index))
        return rng.random(
            (self.image_size, self.image_size, self.channels)
        ).astype(np.float32)
