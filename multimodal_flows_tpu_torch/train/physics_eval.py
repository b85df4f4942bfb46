"""In-training physics eval (PyTorch port of
`multimodal_flows_tpu/train/physics_eval.py`): sample a few thousand jets
and score W1 against the validation set, feeding the `best_physics`
checkpoint slot.

The validation loss is a per-step denoising objective and ranks sample
quality badly; sample quality depends on the whole integrated trajectory.
So every `physics_eval_every_n_epochs` the trainer generates
`physics_eval_num_jets` jets at a low step count with the current (EMA)
weights, computes W1 on jet pT, jet mass and token multiplicity, and
checkpoints by the combined score in the `best_physics` slot beside
val_loss / _mse / _ce.  Generation runs on the system's device; the
observables and W1 are host-side numpy.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.utils.jet_features import JetFeatures, astype_numpy
from multimodal_flows_tpu_torch.utils.metrics import wasserstein1d


def _destandardized(jets: MultiModal, metadata: Optional[Dict]) -> MultiModal:
    if jets.continuous is None or not metadata:
        return jets
    mean = np.asarray(metadata["mean"], np.float32)
    std = np.asarray(metadata["std"], np.float32)
    x = (np.asarray(jets.continuous) * std + mean) * np.asarray(jets.mask)
    return jets.replace(continuous=x.astype(np.float32))


def reference_observables(ref_jets: MultiModal, metadata: Optional[Dict],
                          num_jets: int) -> Dict[str, np.ndarray]:
    """Host-side observables of the (standardized) reference jets; computed
    once per fit and cached by the trainer.  Returns {name: (N,) values}."""
    ref = _destandardized(astype_numpy(ref_jets[:num_jets]), metadata)
    obs: Dict[str, np.ndarray] = {}
    if ref.continuous is not None:
        f = JetFeatures(ref, compute_substructure=False)
        obs["pt"] = np.asarray(f.pt, np.float64)
        obs["mass"] = np.asarray(f.m, np.float64)
    if ref.discrete is not None:
        toks = np.asarray(ref.discrete)[..., 0]
        obs["mult"] = (toks > 0).sum(axis=1).astype(np.float64)
    return obs


def physics_metrics(system, module, ref_obs: Dict[str, np.ndarray], masks: np.ndarray, *,
                    num_timesteps: int, metadata: Optional[Dict], batch_size: int,
                    seed: int, pack_width: int = 128) -> Dict[str, float]:
    """Generate one jet per row of `masks` with the weights of `module`
    (the system's own, or e.g. its EMA copy; None for the system's) and
    score W1 per observable against `ref_obs` (from
    `reference_observables`).

    Returns {"val_w1_pt": ..., "val_w1_mass": ..., "val_w1_mult": ...,
    "val_w1_physics": combined}: the combined score is the mean of the
    per-observable W1s, each divided by the reference's std, so GeV-scale
    pT and O(10) multiplicities weigh equally in the ranking."""
    from multimodal_flows_tpu_torch.sampling.generator import generate_packed

    own = system.module
    system.module = own if module is None else module
    try:
        res = generate_packed(system, masks, num_timesteps=num_timesteps,
                              pack_width=pack_width, batch_size=batch_size, seed=seed,
                              metadata=metadata)
    finally:
        system.module = own
    sample = astype_numpy(res.sample)

    gen: Dict[str, np.ndarray] = {}
    if sample.continuous is not None and ("pt" in ref_obs or "mass" in ref_obs):
        f = JetFeatures(sample, compute_substructure=False)
        gen["pt"] = np.asarray(f.pt, np.float64)
        gen["mass"] = np.asarray(f.m, np.float64)
    if sample.discrete is not None and "mult" in ref_obs:
        gen["mult"] = (sample.discrete[..., 0] > 0).sum(axis=1).astype(np.float64)

    out: Dict[str, float] = {}
    normed = []
    for name, ref_vals in ref_obs.items():
        if name not in gen:
            continue
        w1 = wasserstein1d(gen[name], ref_vals)
        out[f"val_w1_{name}"] = float(w1)
        normed.append(w1 / (float(ref_vals.std()) or 1.0))
    if normed:
        out["val_w1_physics"] = float(np.mean(normed))
    return out
