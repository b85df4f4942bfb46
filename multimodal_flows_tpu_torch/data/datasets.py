"""Host-side datasets (port of `multimodal_flows_tpu/data/datasets.py`):
an in-memory coupling of numpy arrays, its random split, the shuffled
batch stream, and the set <-> sequence helpers (`standardize`, `pt_order`,
and `jet_set_to_seq` / `seq_to_jet_set` for the autoregressive baseline).
Batches are slices of the arrays; the trainer moves them to the device.
The split and the shuffle draw from the JAX package's numpy streams
(`default_rng(seed)`, `SeedSequence([seed, epoch])`), so both packages cut
the same sets and batches.  The helpers take a `MultiModal` of numpy
arrays or tensors and return numpy fields."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal


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


# --------------------------------------------------------------------------
# set <-> sequence helpers
# --------------------------------------------------------------------------


def standardize(jets: MultiModal) -> Tuple[MultiModal, dict]:
    """Standardize the continuous features over every slot (pads
    included, as the reference does); returns (jets, {'mean', 'std'})."""
    x = np.asarray(jets.continuous, dtype=np.float64)
    flat = x.reshape(-1, x.shape[-1])
    mean = flat.mean(axis=0)
    std = flat.std(axis=0, ddof=1)
    out = ((x - mean) / std).astype(np.float32)
    return jets.replace(continuous=out), {"mean": mean.tolist(), "std": std.tolist()}


def jet_set_to_seq(part_set: MultiModal, vocab_size: int) -> MultiModal:
    """A particle set as a BOS/EOS/PAD token sequence (N, D + 2) for the
    autoregressive baseline: start_token = vocab_size + 1, end_token =
    vocab_size + 2, pad_token = vocab_size + 3; the mask marks the tokens
    up to and including EOS."""
    start_token = vocab_size + 1
    end_token = vocab_size + 2
    pad_token = vocab_size + 3

    if part_set.discrete is None:
        raise ValueError("particle set must have a 'discrete' field")

    seq = np.asarray(part_set.discrete)
    if seq.ndim == 3:
        seq = seq[..., 0]
    seq = seq.copy().astype(np.int64)  # (N, D)
    n = seq.shape[0]

    start = np.full((n, 1), start_token, dtype=np.int64)
    extra_pad = np.full((n, 1), pad_token, dtype=np.int64)
    seq[seq == 0] = pad_token
    seq = np.concatenate([start, seq, extra_pad], axis=1)

    idx_eos = (seq != pad_token).sum(axis=1)
    seq[np.arange(n), idx_eos] = end_token

    mask = (seq != pad_token).astype(np.int32)
    return part_set.replace(discrete=seq, mask=mask)


def seq_to_jet_set(seq: np.ndarray, vocab_size: int, max_num_particles: int) -> np.ndarray:
    """Strip the BOS/EOS/PAD tokens and re-pad to (N, D) flavor tokens."""
    start_token = vocab_size + 1
    seq = np.asarray(seq)
    seq = np.where(seq >= start_token, 0, seq)
    body = seq[:, 1:]  # drop BOS
    out = np.zeros((seq.shape[0], max_num_particles), dtype=np.int64)
    ncols = min(max_num_particles, body.shape[1])
    out[:, :ncols] = body[:, :ncols]
    return out


def pt_order(state: MultiModal, include_mask: bool = False) -> MultiModal:
    """Re-sort the particles of each jet by descending pt (feature 0)."""
    if not state.has_continuous:
        raise ValueError("state must have continuous features to sort by pt")
    x = np.asarray(state.continuous)
    order = np.argsort(-x[..., 0], axis=1, kind="stable")
    rows = np.arange(x.shape[0])[:, None]

    new_discrete, new_mask = state.discrete, state.mask
    if state.has_discrete:
        new_discrete = np.asarray(state.discrete)[rows, order]
    if include_mask and state.mask is not None:
        new_mask = np.asarray(state.mask)[rows, order]
    return state.replace(continuous=x[rows, order], discrete=new_discrete, mask=new_mask)
