"""Block-diagonal multi-jet packing: the host-side layout math
(port of `multimodal_flows_tpu/data/packing.py:37-125`).

Several low-multiplicity jets share one `width`-token attention row behind
a same-segment mask (`ops/attention.py` `segments`).  These functions are
numpy, as in the JAX package; they are copied rather than imported because
the JAX module imports flax.

- `pack_jets`         — best-fit-decreasing bin packing of multiplicities
- `build_packed_rows` — masks (R,W,1) + segment ids (R,W) for the layout
- `unpack_rows`       — scatter packed tokens back to the padded layout
"""

from __future__ import annotations

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
