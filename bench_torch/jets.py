"""The one generator of every traffic mix's jets, from a seed.

AOJ-like jets as the AOJ reader hands them to the program: first-n-filled
pad masks, pT-ordered particles, pt = 1 + Exp(20) GeV, eta_rel and phi_rel
~ N(0, 0.15), flavor tokens uniform in 1..8, the kinematics standardized
over every slot (pads included, as the reader does) and zeroed on pads.
Multiplicities are Poisson(mean) clipped to [lo, hi].  The arrays are made
on the host in bulk with numpy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


#: the call index of a driver's warm-up call, apart from the window's calls
WARM = 1 << 40


def _entropy(parts):
    return [int(p) % (1 << 64) for p in parts]


def rng(*parts: int) -> np.random.Generator:
    """A numpy generator of the seed parts (any integers)."""
    return np.random.default_rng(np.random.SeedSequence(_entropy(parts)))


def sub_seed(*parts: int) -> int:
    """A 63-bit seed (torch generators, the program's seeds) of the parts."""
    state = np.random.SeedSequence(_entropy(parts)).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def multiplicities(r: np.random.Generator, n: int, spec: Dict) -> np.ndarray:
    return np.clip(r.poisson(spec["mean"], size=n), spec["min"], spec["max"]).astype(np.int64)


def pad_masks(mult: np.ndarray, width: int) -> np.ndarray:
    """(N, width, 1) int64, real particles first."""
    return (np.arange(width)[None, :] < mult[:, None]).astype(np.int64)[..., None]


def physical_jets(r: np.random.Generator, mult: np.ndarray, width: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(continuous (N, D, 3) fp32 standardized, tokens (N, D, 1) int32,
    mask (N, D, 1) int64)."""
    mask = pad_masks(mult, width)
    n = len(mult)
    pt = -np.sort(-(1.0 + r.exponential(20.0, size=(n, width))) * mask[..., 0], axis=1)
    x = np.stack([pt, r.normal(0, 0.15, size=(n, width)), r.normal(0, 0.15, size=(n, width))],
                 -1) * mask
    flat = x.reshape(-1, 3)
    x = (x - flat.mean(axis=0)) / flat.std(axis=0, ddof=1) * mask
    k = r.integers(1, 9, size=(n, width, 1)) * mask
    return x.astype(np.float32), k.astype(np.int32), mask
