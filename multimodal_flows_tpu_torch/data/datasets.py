"""Host-side datasets (port of `multimodal_flows_tpu/data/datasets.py:22-103`):
an in-memory coupling of numpy arrays, its random split, and the shuffled
batch stream.  Batches are slices of the arrays; the trainer moves them
to the device.  The shuffle draws from `SeedSequence([seed, epoch])`, the
JAX package's stream, so both packages cut the same batches."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

from multimodal_flows_tpu_torch.data.state import DataCoupling


@dataclass
class ArrayDataset:
    """A `DataCoupling` of numpy arrays (tensors given are converted)."""

    coupling: DataCoupling

    def __post_init__(self):
        self.coupling = self.coupling.map(np.asarray)

    def __len__(self) -> int:
        return len(self.coupling)

    def __getitem__(self, idx) -> DataCoupling:
        return self.coupling[idx]

    def split(self, train_frac: float, seed: int = 0) -> Tuple["ArrayDataset", "ArrayDataset"]:
        """Random (train, val) split: the first `train_frac` of a
        permutation drawn from `default_rng(seed)`."""
        perm = np.random.default_rng(seed).permutation(len(self))
        n_train = int(train_frac * len(self))
        return (ArrayDataset(self.coupling[perm[:n_train]]),
                ArrayDataset(self.coupling[perm[n_train:]]))


def shuffle_batches(dataset, batch_size: int, *, shuffle: bool = True, seed: int = 0,
                    epoch: int = 0, drop_last: bool = True,
                    pad_last: bool = False) -> Iterator:
    """Yield batches of `batch_size` rows; with `pad_last` the last partial
    batch is filled by repeating its rows, so every batch has one shape."""
    n = len(dataset)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(np.random.SeedSequence([seed, epoch])).shuffle(idx)
    num_full = n // batch_size
    for b in range(num_full):
        yield dataset[idx[b * batch_size:(b + 1) * batch_size]]
    rem = n - num_full * batch_size
    if rem and not drop_last:
        tail = idx[num_full * batch_size:]
        if pad_last:
            tail = np.tile(tail, math.ceil(batch_size / rem))[:batch_size]
        yield dataset[tail]


def num_batches(n: int, batch_size: int, drop_last: bool = True) -> int:
    return n // batch_size if drop_last else math.ceil(n / batch_size)


def make_train_val_loaders(coupling: DataCoupling, train_frac: float, seed: int = 0):
    """Split a coupling into (train_dataset, val_dataset)."""
    return ArrayDataset(coupling).split(train_frac, seed=seed)
