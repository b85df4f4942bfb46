"""Particle-cloud and jet-level physics observables (PyTorch port's copy of
`multimodal_flows_tpu/utils/jet_features.py`), host-side numpy:
`ParticleClouds` (derived per-particle views, flavor selections, charges),
`JetFeatures` (jet 4-momentum, mass, jet charge, and the substructure
observables tau1/2/3, tau21, tau32, c1, d2, d0 from the native jetkit
library or its numpy version, `utils/jet_substructure.py`),
`EnergyCorrelationFunctions` and `JetChargeDipole` (flavor-masked
correlators).  All take a `MultiModal` of tensors (on any device) or of
numpy arrays, and never touch the device path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.utils import jet_substructure as jk
from multimodal_flows_tpu_torch.utils.metrics import wasserstein1d

FLAVOR_SELECTIONS = {
    "Photon": lambda d: d == 1,
    "NeutralHadron": lambda d: d == 2,
    "NegativeHadron": lambda d: d == 3,
    "PositiveHadron": lambda d: d == 4,
    "Electron": lambda d: d == 5,
    "Positron": lambda d: d == 6,
    "Muon": lambda d: d == 7,
    "AntiMuon": lambda d: d == 8,
    "Hadron": lambda d: (d >= 2) & (d <= 4),
    "Lepton": lambda d: d > 4,
    "Neutral": lambda d: d <= 2,
    "Charged": lambda d: d > 2,
    "Negative": lambda d: (d == 3) | (d == 5) | (d == 7),
    "Positive": lambda d: (d == 4) | (d == 6) | (d == 8),
}


def astype_numpy(data: MultiModal) -> MultiModal:
    """The fields as numpy arrays on the host."""
    return data.map(lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                    else np.asarray(a))


class ParticleClouds:
    """Derived particle-level views of a MultiModal cloud."""

    def __init__(self, data: MultiModal):
        self.data = astype_numpy(data)
        d = self.data
        self.continuous = d.continuous
        self.discrete = None if d.discrete is None else (
            d.discrete[..., 0] if d.discrete.ndim == 3 else d.discrete)
        self.mask = d.mask
        self.mask_bool = d.mask[..., 0] > 0
        self.multiplicity = self.mask_bool.sum(axis=1)

        if self.has_continuous:
            self.pt = self.continuous[..., 0]
            self.eta_rel = self.continuous[..., 1]
            self.phi_rel = self.continuous[..., 2]
            self.px = self.pt * np.cos(self.phi_rel)
            self.py = self.pt * np.sin(self.phi_rel)
            self.pz = self.pt * np.sinh(self.eta_rel)
            self.E = self.pt * np.cosh(self.eta_rel)

        if self.has_discrete:
            for name, sel in FLAVOR_SELECTIONS.items():
                self._flavored_kinematics(name, sel(self.discrete))
            self.charge = np.zeros(self.mask_bool.shape, dtype=np.float32)
            self.charge[self.isPositive] = 1.0
            self.charge[self.isNegative] = -1.0

    def _flavored_kinematics(self, name: str, selection: np.ndarray) -> None:
        is_sel = selection & self.mask_bool
        setattr(self, f"is{name}", is_sel)
        setattr(self, f"num_{name}", is_sel.sum(axis=1))
        if self.has_continuous:
            setattr(self, f"pt_{name}", self.pt[is_sel])
            setattr(self, f"eta_{name}", self.eta_rel[is_sel])
            setattr(self, f"phi_{name}", self.phi_rel[is_sel])

    @property
    def has_continuous(self) -> bool:
        return self.continuous is not None

    @property
    def has_discrete(self) -> bool:
        return self.discrete is not None

    def __len__(self) -> int:
        return self.mask.shape[0]


class JetFeatures:
    """Jet-level observables: 4-momentum, pt, mass, eta, phi, the jet
    charge, and with `compute_substructure` tau1/2/3, tau21, tau32, c1, d2
    and d0 of the jets with >= 3 particles (`substructure_mask` marks
    them; the others are dropped from the substructure arrays)."""

    def __init__(self, data: MultiModal, R: float = 0.8, beta: float = 1.0,
                 compute_substructure: bool = True):
        self.constituents = ParticleClouds(data)
        c = self.constituents
        self.numParticles = c.mask_bool.sum(axis=1)

        if c.has_continuous:
            self.px = c.px.sum(axis=-1)
            self.py = c.py.sum(axis=-1)
            self.pz = c.pz.sum(axis=-1)
            self.E = c.E.sum(axis=-1)
            self.pt = np.sqrt(self.px**2 + self.py**2)
            with np.errstate(invalid="ignore", divide="ignore"):
                self.m = np.sqrt(np.clip(self.E**2 - self.pt**2 - self.pz**2, 0, None))
                self.eta = 0.5 * np.log((self.pt + self.pz) / (self.pt - self.pz))
            self.phi = np.arctan2(self.py, self.px)
            if compute_substructure:
                self._substructure(R=R, beta=beta)

        if c.has_discrete:
            self.charge = self._jet_charge(kappa=0.0)
        if c.has_continuous and c.has_discrete:
            self.jet_charge = self._jet_charge(kappa=1.0)

    def _substructure(self, R: float, beta: float) -> None:
        c = self.constituents
        sub = jk.substructure(c.pt, c.eta_rel, c.phi_rel, R=R, beta=beta)
        keep = self.numParticles >= 3
        for key, vals in sub.items():
            setattr(self, key, vals[keep])
        self.substructure_mask = keep

    def _jet_charge(self, kappa: float) -> np.ndarray:
        """Q_kappa = sum_i Q_i (pT_i / pT_jet)^kappa."""
        c = self.constituents
        if kappa > 0:
            return (c.charge * c.pt**kappa).sum(axis=1) / self.pt**kappa
        return c.charge.sum(axis=1)

    def flavor_counts(self, vocab_size: int = 9) -> np.ndarray:
        """(B, vocab+1) per-jet token counts."""
        c = self.constituents
        counts = np.zeros((len(c), vocab_size + 1), dtype=np.int64)
        for tok in range(vocab_size + 1):
            counts[:, tok] = ((c.discrete == tok) & c.mask_bool).sum(axis=1)
        return counts

    def Wassertein1D(self, feature: str, reference: "JetFeatures") -> float:
        """W1 between this sample and a reference for any scalar feature
        (the reference implementation's spelling, kept)."""
        x = np.asarray(getattr(self, feature), np.float64)
        y = np.asarray(getattr(reference, feature), np.float64)
        x = x[np.isfinite(x)]
        y = y[np.isfinite(y)]
        return wasserstein1d(x, y)

    wasserstein1d = Wassertein1D


# flavor key -> token selection, on the canonical token map 1 = photon ..
# 8 = antimuon
ECF_FLAVOR_GROUPS = {
    "photon": lambda d: d == 1,
    "h0": lambda d: d == 2,
    "h-": lambda d: d == 3,
    "h+": lambda d: d == 4,
    "e-": lambda d: d == 5,
    "e+": lambda d: d == 6,
    "mu-": lambda d: d == 7,
    "mu+": lambda d: d == 8,
    "hadron": lambda d: (d >= 2) & (d <= 4),
    "lepton": lambda d: d > 4,
    "negative": lambda d: (d == 3) | (d == 5) | (d == 7),
    "positive": lambda d: (d == 4) | (d == 6) | (d == 8),
    "charged": lambda d: d > 2,
    "neutral": lambda d: (d == 1) | (d == 2),
    "h+/-": lambda d: (d == 3) | (d == 4),
    "e+/-": lambda d: (d == 5) | (d == 6),
    "mu+/-": lambda d: (d == 7) | (d == 8),
}


class EnergyCorrelationFunctions:
    """Flavor-masked auto / cross 2-point energy correlators of the jets
    with >= 3 particles (jetkit's `ecf2`)."""

    def __init__(self, data: MultiModal):
        self.data = astype_numpy(data)
        disc = self.data.discrete
        self.discrete = disc[..., 0] if disc.ndim == 3 else disc
        self.mask_bool = self.data.mask[..., 0] > 0
        self.mask_3_parts = self.mask_bool.sum(axis=1) >= 3

    def _flavor_kin(self, key: str):
        sel = ECF_FLAVOR_GROUPS[key](self.discrete) & self.mask_bool
        x = self.data.continuous
        pt = np.where(sel, x[..., 0], 0.0)
        return pt, x[..., 1], x[..., 2]

    def compute_ecf(self, flavor_i: str, flavor_j: Optional[str] = None,
                    beta: float = 1.0):
        pt1, eta1, phi1 = self._flavor_kin(flavor_i)
        if flavor_j is None:
            ecf, pt2 = jk.ecf2(pt1, eta1, phi1, beta=beta)
        else:
            ptb, etab, phib = self._flavor_kin(flavor_j)
            ecf, pt2 = jk.ecf2(pt1, eta1, phi1, ptb, etab, phib, beta=beta)
        return ecf[self.mask_3_parts], pt2[self.mask_3_parts]


class JetChargeDipole:
    """pT-weighted jet charge Q_kappa and electric dipole d2 of the jets
    with >= 2 particles (jetkit's `charge_dipole`)."""

    def __init__(self, data: JetFeatures):
        c = data.constituents
        self.pt, self.eta, self.phi = c.pt, c.eta_rel, c.phi_rel
        self.charge = c.charge
        self.mask_2_parts = c.mask_bool.sum(axis=1) >= 2

    def charge_and_dipole(self, kappa: float = 1.0, beta: float = 1.0):
        q0, qk, d2 = jk.charge_dipole(self.pt, self.eta, self.phi, self.charge,
                                      kappa=kappa, beta=beta)
        keep = self.mask_2_parts
        return q0[keep], qk[keep], d2[keep]
