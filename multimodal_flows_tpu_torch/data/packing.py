"""Block-diagonal multi-jet packing: the host-side layout math
(port of `multimodal_flows_tpu/data/packing.py`).

Several low-multiplicity jets share one `width`-token attention row behind
a same-segment mask (`ops/attention.py` `segments`).  These functions are
numpy, as in the JAX package; they are copied rather than imported because
the JAX module imports flax.

- `pack_jets`         — best-fit-decreasing bin packing of multiplicities
- `build_packed_rows` — masks (R,W,1) + segment ids (R,W) for the layout
- `unpack_rows`       — scatter packed tokens back to the padded layout
- `pack_multimodal`   — scatter a padded dataset into packed rows, with the
                        per-(row, jet-slot) bookkeeping the per-jet
                        training loss needs (`PackedJets`)
- `pad_rows`, `singleton_rows`, `PackedDataset` — the packed training
                        units (rows padded to a batch multiple; jets wider
                        than a row as one-jet rows at their own width)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from multimodal_flows_tpu_torch.data.state import MultiModal


def pack_jets(mult: np.ndarray, width: int = 128):
    """Best-fit-decreasing bin packing of jet multiplicities into rows of
    `width` token slots.

    Returns (row_of (N,), offset_of (N,), n_rows): jet i occupies slots
    [offset_of[i], offset_of[i] + mult[i]) of row row_of[i].  Jets with
    mult > width (or mult 0) get row_of = -1; the caller routes them
    through an unpacked path.
    """
    mult = np.asarray(mult, np.int64)
    N = mult.shape[0]
    row_of = np.full(N, -1, np.int64)
    offset_of = np.zeros(N, np.int64)
    order = np.argsort(-mult, kind="stable")
    # bins indexed by remaining capacity: bins_by_cap[c] = [row ids]
    bins_by_cap = [[] for _ in range(width + 1)]
    fill = []  # current fill level per row
    for j in order:
        m = int(mult[j])
        if m > width or m == 0:
            continue
        for c in range(m, width + 1):
            if bins_by_cap[c]:
                b = bins_by_cap[c].pop()
                break
        else:
            b = len(fill)
            fill.append(0)
            c = width
        row_of[j] = b
        offset_of[j] = fill[b]
        fill[b] += m
        bins_by_cap[c - m].append(b)
    return row_of, offset_of, len(fill)


def build_packed_rows(pad_masks: np.ndarray, row_of, offset_of, n_rows: int,
                      width: int):
    """Masks (R, W, 1) and segment ids (R, W) for the packed layout.
    Pad slots carry segment -1."""
    mult = pad_masks[..., 0].sum(axis=1).astype(np.int64)
    packed = np.where(row_of >= 0)[0]
    seg = np.full((n_rows, width), -1, np.int32)
    # per-row segment counter: order jets by (row, offset)
    order = packed[np.lexsort((offset_of[packed], row_of[packed]))]
    prev_row = -1
    seg_id = 0
    for j in order:
        r, o, m = int(row_of[j]), int(offset_of[j]), int(mult[j])
        seg_id = seg_id + 1 if r == prev_row else 0
        prev_row = r
        seg[r, o:o + m] = seg_id
    mask = (seg >= 0).astype(np.int64)[..., None]
    return mask, seg


def unpack_rows(rows: MultiModal, pad_masks: np.ndarray, row_of, offset_of,
                width: int) -> MultiModal:
    """Scatter packed-row tokens (CPU tensors) back into the (N, D) padded
    layout; returns CPU tensors."""
    N, D = pad_masks.shape[0], pad_masks.shape[1]
    mult = pad_masks[..., 0].sum(axis=1).astype(np.int64)
    packed = np.where(row_of >= 0)[0]
    m = mult[packed]
    total = int(m.sum())
    jet_of_tok = np.repeat(np.arange(len(packed)), m)
    within = np.arange(total) - np.repeat(np.cumsum(m) - m, m)
    src = (row_of[packed] * width + offset_of[packed])[jet_of_tok] + within
    dst_row = packed[jet_of_tok]

    def scatter(flat_rows, fill_dtype):
        flat_rows = np.asarray(flat_rows)
        out = np.zeros((N, D) + flat_rows.shape[2:], fill_dtype)
        flat = flat_rows.reshape(-1, *flat_rows.shape[2:])
        out[dst_row, within] = flat[src]
        return torch.from_numpy(out)

    x = None if rows.continuous is None else scatter(rows.continuous, np.float32)
    k = None if rows.discrete is None else scatter(rows.discrete, np.int32)
    return MultiModal(continuous=x, discrete=k,
                      mask=torch.from_numpy(pad_masks.astype(np.int32)))


_PACKED_FIELDS = ("continuous", "discrete", "mask", "segments", "jet_valid")


@dataclasses.dataclass
class PackedJets:
    """Jets sharing `W`-token rows, as numpy arrays on the host or tensors
    on a device: continuous (R, W, Fc) fp32 | None, discrete (R, W, 1)
    int32 | None, mask (R, W, 1) int32, segments (R, W) int32 (pads -1,
    jets 0..J-1 within their row), jet_valid (R, J) int32 (1 where a jet
    occupies slot j).  J is the most jets a row holds in the dataset."""

    continuous: Optional[np.ndarray] = None
    discrete: Optional[np.ndarray] = None
    mask: Optional[np.ndarray] = None
    segments: Optional[np.ndarray] = None
    jet_valid: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.mask.shape[0]

    @property
    def width(self) -> int:
        return self.mask.shape[1]

    @property
    def num_jets(self) -> int:
        return int(self.jet_valid.sum())

    def map(self, fn: Callable) -> "PackedJets":
        return PackedJets(**{f: None if getattr(self, f) is None else fn(getattr(self, f))
                             for f in _PACKED_FIELDS})

    def __getitem__(self, idx) -> "PackedJets":
        return self.map(lambda a: a[idx])

    def to(self, device) -> "PackedJets":
        """Tensors on `device` (numpy fields are converted)."""
        return self.map(lambda a: torch.as_tensor(a, device=device))


def first_n_filled(pad_masks: np.ndarray) -> bool:
    """Whether every (N, D, 1) pad mask has its real particles before its
    pads: what truncating a row to its multiplicity, and packing, need."""
    D = pad_masks.shape[1]
    mult = pad_masks[..., 0].sum(axis=1)
    return bool((pad_masks[..., 0].cumsum(axis=1) ==
                 np.minimum(np.arange(1, D + 1)[None, :], mult[:, None])).all())


def pack_multimodal(jets: MultiModal, width: int = 128
                    ) -> Tuple[Optional[PackedJets], np.ndarray]:
    """Pack a padded dataset into `width`-token rows.

    Returns (packed, leftover_idx): `packed` covers every jet whose
    multiplicity fits `width` (None when none does); `leftover_idx`
    indexes the jets wider than `width`, which train as one-jet rows at
    their own width (`singleton_rows`).  The masks must be first-n filled
    (real particles before pads); otherwise this raises ValueError."""
    pad_masks = np.asarray(jets.mask)
    mult = pad_masks[..., 0].sum(axis=1).astype(np.int64)
    if not first_n_filled(pad_masks):
        raise ValueError("pack_multimodal requires first-n-filled masks")

    row_of, offset_of, n_rows = pack_jets(mult, width)
    leftover = np.where((row_of < 0) & (mult > 0))[0]
    if n_rows == 0:
        return None, leftover

    row_mask, seg = build_packed_rows(pad_masks, row_of, offset_of, n_rows, width)

    packed_j = np.where(row_of >= 0)[0]
    m = mult[packed_j]
    jet_of_tok = np.repeat(np.arange(len(packed_j)), m)
    within = np.arange(int(m.sum())) - np.repeat(np.cumsum(m) - m, m)
    dst_row = row_of[packed_j][jet_of_tok]
    dst_col = offset_of[packed_j][jet_of_tok] + within
    src_row = packed_j[jet_of_tok]

    def scatter(field, dtype):
        if field is None:
            return None
        src = np.asarray(field)
        out = np.zeros((n_rows, width) + src.shape[2:], dtype)
        out[dst_row, dst_col] = src[src_row, within]
        return out

    jets_per_row = np.zeros(n_rows, np.int64)
    np.add.at(jets_per_row, row_of[packed_j], 1)
    J = int(jets_per_row.max())
    jet_valid = (np.arange(J)[None, :] < jets_per_row[:, None]).astype(np.int32)
    packed = PackedJets(continuous=scatter(jets.continuous, np.float32),
                        discrete=scatter(jets.discrete, np.int32),
                        mask=row_mask.astype(np.int32), segments=seg.astype(np.int32),
                        jet_valid=jet_valid)
    return packed, leftover


@dataclasses.dataclass
class PackedDataset:
    """Packed rows with the `ArrayDataset` protocol (`len`, indexing, a
    `.coupling`), so the trainer's epoch machinery runs on it unchanged."""

    coupling: PackedJets

    def __len__(self) -> int:
        return len(self.coupling)

    def __getitem__(self, idx) -> PackedJets:
        return self.coupling[idx]


def pad_rows(packed: PackedJets, multiple: int) -> PackedJets:
    """Pad the row count up to a multiple of `multiple` with empty rows
    (mask 0, segments -1, jet_valid 0): every batch has one shape and no
    row is dropped.  Empty rows add nothing to any loss."""
    pad = (-len(packed)) % multiple
    if pad == 0:
        return packed

    def padz(a, fill=0):
        a = np.asarray(a)
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0)

    return PackedJets(
        continuous=None if packed.continuous is None else padz(packed.continuous),
        discrete=None if packed.discrete is None else padz(packed.discrete),
        mask=padz(packed.mask), segments=padz(packed.segments, fill=-1),
        jet_valid=padz(packed.jet_valid))


def singleton_rows(jets: MultiModal) -> PackedJets:
    """Padded jets as one-jet rows (J = 1) at their own width: the packed
    loss path for jets too wide to pack."""
    mask = np.asarray(jets.mask).astype(np.int32)
    seg = np.where(mask[..., 0] > 0, 0, -1).astype(np.int32)
    x = None if jets.continuous is None else np.asarray(jets.continuous, np.float32)
    k = None if jets.discrete is None else np.asarray(jets.discrete).astype(np.int32)
    return PackedJets(continuous=x, discrete=k, mask=mask, segments=seg,
                      jet_valid=np.ones((mask.shape[0], 1), np.int32))
