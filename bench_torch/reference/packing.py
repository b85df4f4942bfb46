"""Where the program's packed layout puts each jet, and in which order its
batches come: copies of the port's layout rules, so that the reference can
find, for every jet, the noise and the times that the program drew for it.

These rules are part of what a seed means to the program: the same seed
puts the same jet in the same slot, and so gives it the same draws.  A
change to packing, to the batch sizes or to the order of the draws changes
the result of a seed, and needs a change here.

- `pack_jets`: best-fit-decreasing bin packing of multiplicities into rows
  (`data/packing.py:pack_jets`);
- `segment_slots`: each packed jet's slot within its row, ordered by offset
  (`data/packing.py:build_packed_rows`);
- `sampling_batches`: the row batches of `generate_packed`
  (`sampling/generator.py:_run_packed_rows`, `_snap_batch`,
  `_rebalanced_batch`, no mesh);
- `training_row_batch`: rows a step of packed training
  (`train/trainer.py:_pack_units`, no mesh);
- `epoch_perm`: the rows of each step of an epoch
  (`train/trainer.py:_epoch_perm`).
"""

from __future__ import annotations

import math

import numpy as np


def pack_jets(mult: np.ndarray, width: int):
    """(row_of, offset_of, n_rows); row -1 for jets wider than `width`."""
    mult = np.asarray(mult, np.int64)
    row_of = np.full(len(mult), -1, np.int64)
    offset_of = np.zeros(len(mult), np.int64)
    bins_by_cap = [[] for _ in range(width + 1)]
    fill = []
    for j in np.argsort(-mult, kind="stable"):
        m = int(mult[j])
        if m > width or m == 0:
            continue
        for c in range(m, width + 1):
            if bins_by_cap[c]:
                b = bins_by_cap[c].pop()
                break
        else:
            b, c = len(fill), width
            fill.append(0)
        row_of[j], offset_of[j] = b, fill[b]
        fill[b] += m
        bins_by_cap[c - m].append(b)
    return row_of, offset_of, len(fill)


def segment_slots(row_of: np.ndarray, offset_of: np.ndarray) -> np.ndarray:
    """Each packed jet's slot (0, 1, ...) in its row, by offset."""
    slot = np.full(len(row_of), -1, np.int64)
    packed = np.where(row_of >= 0)[0]
    order = packed[np.lexsort((offset_of[packed], row_of[packed]))]
    prev, s = -1, 0
    for j in order:
        s = s + 1 if row_of[j] == prev else 0
        prev = row_of[j]
        slot[j] = s
    return slot


def sampling_batches(n_rows: int, cap: int, gran: int = 8):
    """(rows a batch, batches) of `generate_packed`'s packed rows."""
    batch = cap
    if n_rows < batch:
        for b in (8, 16, 32):
            if n_rows <= b:
                snapped = b
                break
        else:
            snapped = ((n_rows + 63) // 64) * 64
        batch = min(-(-snapped // gran) * gran, batch)
    n_batches = (n_rows + batch - 1) // batch
    if n_batches > 1:
        per_batch = -(-n_rows // n_batches)
        balanced = -(-per_batch // gran) * gran
        saved = (batch - balanced) * n_batches
        if saved >= 32 and saved >= 0.05 * n_batches * batch:
            batch = balanced
    return batch, (n_rows + batch - 1) // batch


def training_row_batch(n_jets: int, n_rows: int, jets_per_step: int) -> int:
    jets_per_row = max(n_jets / max(n_rows, 1), 1.0)
    return min(max(int(round(jets_per_step / jets_per_row)), 1), jets_per_step)


def epoch_perm(n: int, batch: int, seed: int, epoch: int) -> np.ndarray:
    """(steps, batch) row indices of a shuffled epoch, the tail dropped."""
    idx = np.arange(n)
    np.random.default_rng(np.random.SeedSequence([seed, epoch])).shuffle(idx)
    steps = n // batch
    return idx[:steps * batch].reshape(steps, batch)


def padded_rows(n_rows: int, multiple: int) -> int:
    return math.ceil(n_rows / multiple) * multiple
