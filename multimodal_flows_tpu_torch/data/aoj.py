"""AspenOpenJets (AOJ) dataset pipeline (PyTorch port's copy of
`multimodal_flows_tpu/data/aoj.py`; host-side numpy, no device code).

Reads AOJ `.h5` files (the `PFCands` dataset of CMS PF candidates), filters
bad PIDs, pT-sorts, computes relative kinematic coordinates, maps the 8 PDG
ids to tokens 1..8, and emits static-shape padded clouds plus the dataset
metadata (mean / std / min / max, counts).  `AspenOpenJets.__call__`
returns a `MultiModal` of **numpy arrays** (continuous float32, discrete
int32, mask int64), which is what `ArrayDataset` holds; `.to(device)`
makes tensors of them.  Every random draw comes from a numpy seed, so both
packages give equal arrays.  `h5py` is imported where a file is read.

PFCands feature layout (AOJ convention): columns 0..3 = px, py, pz, E;
4..7 = d0, d0Err, dz, dzErr; column -2 = PDG id.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.utils.logger import SimpleLogger as log

# PDG id -> flavor token
PID_TO_TOKEN = {
    22: 1,     # photon
    130: 2,    # neutral hadron
    -211: 3,   # negative hadron
    211: 4,    # positive hadron
    -11: 5,    # electron
    11: 6,     # positron
    -13: 7,    # muon
    13: 8,     # antimuon
}

AOJ_URL = "https://www.fdr.uni-hamburg.de/record/16505/files"


class AspenOpenJets:
    """Data constructor for the AOJ dataset: `AspenOpenJets(dir, files)(...)`
    returns (jets, metadata), the jets as numpy arrays."""

    def __init__(self, data_dir: str, data_files: Union[str, Sequence[str], None] = None,
                 url: str = AOJ_URL):
        self.data_dir = data_dir
        self.data_files = [data_files] if isinstance(data_files, str) else list(data_files or [])
        self.url = url

    def __call__(
        self,
        num_jets: Optional[int] = None,
        max_num_particles: int = 150,
        download: bool = False,
        transform: Optional[str] = None,
        features: Dict = None,
        pt_order: bool = True,
        padding: str = "zeros",
        seed: int = 0,
    ) -> Tuple[MultiModal, Dict]:
        features = features or {"continuous": ["pt", "eta_rel", "phi_rel"], "discrete": "tokens"}
        features = {k: (list(v) if isinstance(v, (list, tuple)) else v) for k, v in features.items()}
        self.pt_order = pt_order
        self.padding = padding
        self._rng = np.random.default_rng(seed)

        if features.get("discrete") == "onehot":
            cont = features.get("continuous") or []
            features["continuous"] = cont + ["onehot"]

        cont_list, disc_list, mask_list = [], [], []
        jet_count = 0
        for datafile in self.data_files:
            path = os.path.join(self.data_dir, datafile)
            if download and not os.path.exists(path):
                self._download_file(path)
            if not os.path.isfile(path):
                raise FileNotFoundError(f"file {datafile} not found in {self.data_dir}")

            feats, mask = self._read_aoj_file(path, num_jets)

            if features.get("continuous"):
                cont_list.append(
                    np.concatenate([feats[x] for x in features["continuous"]], axis=-1))
            if features.get("discrete") == "tokens":
                disc_list.append(feats["tokens"])
            mask_list.append(mask)

            if num_jets:
                jet_count += len(mask_list[-1])
                if jet_count >= num_jets:
                    break

        continuous = (np.concatenate(cont_list, axis=0)[:num_jets, :max_num_particles, :]
                      if cont_list else None)
        discrete = (np.concatenate(disc_list, axis=0)[:num_jets, :max_num_particles, :]
                    if disc_list else None)
        mask = np.concatenate(mask_list, axis=0)[:num_jets, :max_num_particles, :]

        continuous, discrete, mask, metadata = self._preprocess(
            continuous, discrete, mask, transform)

        # numpy-side apply_mask
        if continuous is not None:
            continuous = (continuous * mask).astype(np.float32)
        if discrete is not None:
            discrete = (discrete * mask).astype(np.int32)
        return MultiModal(continuous=continuous, discrete=discrete, mask=mask), metadata

    # ------------------------------------------------------------ file I/O

    def _read_aoj_file(self, filepath: str, num_jets: Optional[int] = None):
        """Read + featurize one AOJ .h5 file."""
        import h5py

        try:
            with h5py.File(filepath, "r") as f:
                pf = f["PFCands"][:num_jets] if num_jets else f["PFCands"][:]
        except (OSError, KeyError) as e:
            raise ValueError(f"error reading file {filepath}: {e}")

        # float32 end to end: the PFCands payload (px, py, pz, E <= ~1 TeV,
        # PDG ids <= 211) is exactly representable, the statistics
        # accumulate in float64 (extract_metadata), and the featurization
        # moves half the memory of a float64 copy
        pf = np.asarray(pf, dtype=np.float32)
        feats, mask, pf_sorted = self._compute_continuous_coordinates(pf)
        # tokens from the SAME filtered + sorted candidates as the
        # kinematics, so an unsorted file keeps them aligned
        tokens = map_pid_to_tokens(pf_sorted[:, :, -2])[:, :, None]
        feats["tokens"] = tokens.astype(np.int64)
        onehot = np.eye(9, dtype=np.float32)[tokens[..., 0]][..., 1:]  # drop pad col (vocab=8)
        feats["onehot"] = onehot
        for k in feats:
            if k != "tokens":
                feats[k] = np.asarray(feats[k], dtype=np.float32)
        return feats, mask[:, :, None].astype(np.int64)

    def _download_file(self, target_file: str) -> None:
        """Fetch an AOJ file over HTTP; raises a clear error when the host
        cannot be reached."""
        import urllib.request

        filename = os.path.basename(target_file)
        full_url = f"{self.url}/{filename}"
        log.warn(f"file {filename} not found locally; downloading from {full_url}")
        try:
            urllib.request.urlretrieve(full_url, target_file)
            log.info(f"downloaded {target_file}")
        except Exception as e:
            raise RuntimeError(
                f"failed to download {full_url} (offline environment?): {e}") from e

    # ------------------------------------------------------- featurization

    def _compute_continuous_coordinates(self, pf: np.ndarray):
        """px, py, pz, E -> (pt, eta, phi, eta_rel, phi_rel, impact
        parameters), vectorized; returns (features, mask, sorted PFCands)."""
        pf = filter_particles(pf)
        pf = pt_sort(pf)

        px, py, pz, e = pf[:, :, 0], pf[:, :, 1], pf[:, :, 2], pf[:, :, 3]
        pt = np.sqrt(px**2 + py**2)
        with np.errstate(divide="ignore", invalid="ignore"):
            eta = np.arcsinh(np.divide(pz, pt, out=np.zeros_like(pz), where=pt != 0))
        phi = np.arctan2(py, px)

        jet = pf[:, :, :4].sum(axis=1)
        jet_eta = np.arcsinh(jet[:, 2] / np.sqrt(jet[:, 0] ** 2 + jet[:, 1] ** 2))
        jet_phi = np.arctan2(jet[:, 1], jet[:, 0])

        eta_rel = eta - jet_eta[:, None]
        phi_rel = wrap_phi(phi - jet_phi[:, None])

        mask = e > 0

        if self.padding == "ghosts":
            # fill pad slots with soft random "ghost" particles
            real = pt > 0
            pt_min = pt[real].min()
            eta_lo, eta_hi = eta_rel[real].min(), eta_rel[real].max()
            phi_lo, phi_hi = phi_rel[real].min(), phi_rel[real].max()
            pt = np.where(mask, pt, self._rng.uniform(0, pt_min, size=mask.shape))
            eta_rel = np.where(mask, eta_rel, self._rng.uniform(eta_lo, eta_hi, size=mask.shape))
            phi_rel = np.where(mask, phi_rel, self._rng.uniform(phi_lo, phi_hi, size=mask.shape))
            mask = pt > 0

        m = mask
        feats = {
            "px": (px * m)[:, :, None], "py": (py * m)[:, :, None],
            "pz": (pz * m)[:, :, None], "e": (e * m)[:, :, None],
            "pt": (pt * m)[:, :, None], "eta": (eta * m)[:, :, None],
            "phi": (phi * m)[:, :, None],
            "eta_rel": (eta_rel * m)[:, :, None], "phi_rel": (phi_rel * m)[:, :, None],
            "d0": (pf[:, :, 4] * m)[:, :, None], "d0Err": (pf[:, :, 5] * m)[:, :, None],
            "dz": (pf[:, :, 6] * m)[:, :, None], "dzErr": (pf[:, :, 7] * m)[:, :, None],
        }
        return feats, mask, pf

    # --------------------------------------------------------- preprocess

    def _preprocess(self, continuous, discrete, mask, transform):
        metadata = extract_metadata(continuous, mask)

        if continuous is not None:
            if transform == "standardize":
                mean = np.asarray(metadata["mean"], np.float32)
                std = np.asarray(metadata["std"], np.float32)
                continuous = (continuous - mean) / std
            elif transform == "normalize":
                lo = np.asarray(metadata["min"], np.float32)
                hi = np.asarray(metadata["max"], np.float32)
                continuous = (continuous - lo) / (hi - lo)
            elif transform == "log_pt":
                continuous = continuous.copy()
                continuous[:, :, 0] = np.log(continuous[:, :, 0] + 1e-6)
                metadata = extract_metadata(continuous, mask)
                mean = np.asarray(metadata["mean"], np.float32)
                std = np.asarray(metadata["std"], np.float32)
                continuous = (continuous - mean) / std

        if not self.pt_order:
            # shuffle particle slots within jets (one shared permutation)
            idx = self._rng.permutation(mask.shape[1])
            if continuous is not None:
                continuous = continuous[:, idx, :]
            if discrete is not None:
                discrete = discrete[:, idx, :]
            mask = mask[:, idx, :]

        return continuous, discrete, mask, metadata

    def load_metadata(self, path: str) -> Dict:
        with open(os.path.join(path, "metadata.json")) as f:
            return json.load(f)


# --------------------------------------------------------------------------
# pure helpers
# --------------------------------------------------------------------------


def wrap_phi(dphi: np.ndarray) -> np.ndarray:
    """Wrap an angle difference into (-pi, pi]."""
    return (dphi + np.pi) % (2 * np.pi) - np.pi


def filter_particles(pf: np.ndarray) -> np.ndarray:
    """Zero out candidates with |pid| < 11 (bad PF ids)."""
    bad = np.abs(pf[:, :, -2]) < 11
    out = pf.copy()
    out[bad] = 0.0
    return out


def pt_sort(pf: np.ndarray) -> np.ndarray:
    """Sort particles in each jet by descending pT (stable)."""
    pt = np.sqrt(pf[:, :, 0] ** 2 + pf[:, :, 1] ** 2)
    order = np.argsort(-pt, axis=1, kind="stable")
    return np.take_along_axis(pf, order[:, :, None], axis=1)


def map_pid_to_tokens(pid: np.ndarray) -> np.ndarray:
    """PDG ids -> tokens 1..8, unknown -> 0."""
    pid = pid.astype(np.int64)
    out = np.zeros_like(pid)
    for p, tok in PID_TO_TOKEN.items():
        out[pid == p] = tok
    return out


def extract_metadata(continuous: Optional[np.ndarray], mask: np.ndarray) -> Dict:
    """Dataset statistics over real particles, as plain Python numbers and
    lists (they go into `config.yaml`)."""
    mask_bool = mask[..., 0] > 0
    nums = mask.sum(axis=(1, 2))
    metadata = {
        "num_jets_sample": int(mask.shape[0]),
        "num_particles_sample": int(nums.sum()),
        "max_num_particles_per_jet": int(mask.shape[1]),
    }
    if continuous is not None:
        x = continuous[mask_bool]
        # float64 accumulators over float32 arrays: exact enough statistics
        # without a float64 copy of the whole dataset
        mean = x.mean(0, dtype=np.float64)
        std = x.std(0, ddof=1, dtype=np.float64)
        metadata["mean"] = mean.tolist()
        metadata["std"] = std.tolist()
        metadata["min"] = x.min(0).tolist()
        metadata["max"] = x.max(0).tolist()
        with np.errstate(divide="ignore"):
            logpt = np.log(x[:, 0])
        metadata["log_pt_mean"] = [float(logpt.mean(dtype=np.float64))] + mean[1:].tolist()
        metadata["log_pt_std"] = [float(logpt.std(ddof=1, dtype=np.float64))] + std[1:].tolist()
    return metadata


def multiplicity_histogram(mask: np.ndarray, max_num_particles: int) -> np.ndarray:
    """Normalized multiplicity histogram over bins 0..max."""
    nums = mask[..., 0].sum(axis=1).astype(np.int64)
    hist, _ = np.histogram(nums, bins=np.arange(0, max_num_particles + 2), density=True)
    return hist


def sample_from_empirical_masks(pad_masks: np.ndarray, num_jets: int,
                                max_num_particles: int = 150,
                                randomize_masks: bool = False,
                                seed: int = 0) -> np.ndarray:
    """Generation-time pad masks (N, D, 1) int64, first-n filled, drawn
    from the test set's multiplicity histogram with `default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    probs = multiplicity_histogram(np.asarray(pad_masks), max_num_particles)
    probs = probs / probs.sum()
    multiplicity = rng.choice(len(probs), size=num_jets, p=probs)
    mask = (np.arange(max_num_particles)[None, :] < multiplicity[:, None]).astype(np.int64)
    if randomize_masks:
        mask = rng.permuted(mask, axis=1)
    return mask[:, :, None]
