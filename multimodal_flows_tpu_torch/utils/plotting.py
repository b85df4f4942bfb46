"""Plotting suite: closure plots of generated against reference jets
(PyTorch port's copy of `multimodal_flows_tpu/utils/plotting.py`).

Plain matplotlib: hist + ratio panels, flavor-multiplicity grids, particle
and jet kinematics + substructure grids, per-flavor kinematics, charge
observables, and the toy 2D trajectory plots of the tutorial.  Everything
takes numpy arrays or a `MultiModal` (of numpy arrays or tensors) on the
host and returns the figure, saving it to `path` when given.  matplotlib is
imported, with the `Agg` backend, inside the functions that draw: a machine
without it can still import this module.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.utils.jet_features import astype_numpy
from multimodal_flows_tpu_torch.utils.metrics import flavor_multiplicities


def pyplot():
    """matplotlib.pyplot on the `Agg` (file-only) backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


GEN_COLOR = "crimson"
REF_COLOR = "k"


def _finite(x):
    x = np.asarray(x, dtype=np.float64).ravel()
    return x[np.isfinite(x)]


def plot_hist_and_ratio(ax_main, ax_ratio, gen, ref, bins=50, range_=None,
                        log_scale=False, xlabel=None, density=True):
    """Overlaid histograms + gen/ref ratio panel."""
    gen, ref = _finite(gen), _finite(ref)
    if range_ is None and len(ref):
        lo, hi = np.quantile(ref, [0.001, 0.999])
        pad = 0.05 * (hi - lo + 1e-9)
        range_ = (lo - pad, hi + pad)

    h_ref, edges = np.histogram(ref, bins=bins, range=range_, density=density)
    h_gen, _ = np.histogram(gen, bins=edges, density=density)
    centers = 0.5 * (edges[1:] + edges[:-1])

    ax_main.step(edges, np.append(h_ref, h_ref[-1]), where="post",
                 color=REF_COLOR, lw=1.0, label="AOJ")
    ax_main.step(edges, np.append(h_gen, h_gen[-1]), where="post",
                 color=GEN_COLOR, lw=1.2, label="generated")
    ax_main.set_xlim(edges[0], edges[-1])
    if log_scale:
        ax_main.set_yscale("log")
    ax_main.legend(fontsize=7, frameon=False)
    ax_main.tick_params(labelsize=7, labelbottom=False)

    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(h_ref > 0, h_gen / h_ref, np.nan)
    ax_ratio.axhline(1.0, color="gray", lw=0.5)
    ax_ratio.plot(centers, ratio, color=GEN_COLOR, lw=0.8)
    ax_ratio.set_ylim(0.5, 1.5)
    ax_ratio.set_xlim(edges[0], edges[-1])
    if xlabel:
        ax_ratio.set_xlabel(xlabel, fontsize=8)
    ax_ratio.tick_params(labelsize=6)


def _grid_with_ratios(n_rows, n_cols, figsize):
    """Figure with (hist, ratio) stacked axis pairs in a grid."""
    fig = pyplot().figure(figsize=figsize)
    outer = fig.add_gridspec(n_rows, n_cols, hspace=0.35, wspace=0.3)
    pairs = []
    for r in range(n_rows):
        for c in range(n_cols):
            inner = outer[r, c].subgridspec(2, 1, height_ratios=[3, 1], hspace=0.06)
            pairs.append((fig.add_subplot(inner[0]), fig.add_subplot(inner[1])))
    return fig, pairs


def plot_flavor_feats(sample: MultiModal, test: MultiModal, path: Optional[str] = None):
    """4x4 grid of flavor-multiplicity observables."""
    feats_gen = flavor_multiplicities(sample)
    feats_ref = flavor_multiplicities(test)
    fig, pairs = _grid_with_ratios(4, 4, (14, 12))
    for (ax_m, ax_r), key in zip(pairs, feats_gen):
        g, r = feats_gen[key], feats_ref[key]
        lo = int(min(g.min(), r.min()))
        hi = int(max(g.max(), r.max())) + 1
        bins = np.arange(lo, hi + 1) - 0.5
        plot_hist_and_ratio(ax_m, ax_r, g, r, bins=bins, range_=(bins[0], bins[-1]),
                            xlabel=key, log_scale=True)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_kin_feats(gen_feats, ref_feats, path: Optional[str] = None):
    """3x4 grid: particle-level pT/eta_rel/phi_rel/N, jet pT/eta/phi/m,
    substructure c1/d2/tau21/tau32."""
    g, r = gen_feats.constituents, ref_feats.constituents
    panels = [
        (g.pt[g.mask_bool], r.pt[r.mask_bool], r"particle $p_T$", True),
        (g.eta_rel[g.mask_bool], r.eta_rel[r.mask_bool], r"particle $\eta^{rel}$", True),
        (g.phi_rel[g.mask_bool], r.phi_rel[r.mask_bool], r"particle $\phi^{rel}$", True),
        (g.multiplicity, r.multiplicity, r"$N$ particles", False),
        (gen_feats.pt, ref_feats.pt, r"jet $p_T$", False),
        (gen_feats.eta, ref_feats.eta, r"jet $\eta$", False),
        (gen_feats.phi, ref_feats.phi, r"jet $\phi$", False),
        (gen_feats.m, ref_feats.m, r"jet mass", False),
    ]
    for attr, label in [("c1", r"$C_1$"), ("d2", r"$D_2$"),
                        ("tau21", r"$\tau_{21}$"), ("tau32", r"$\tau_{32}$")]:
        if hasattr(gen_feats, attr) and hasattr(ref_feats, attr):
            panels.append((getattr(gen_feats, attr), getattr(ref_feats, attr), label, False))

    fig, pairs = _grid_with_ratios(3, 4, (14, 10))
    for (ax_m, ax_r), (gv, rv, label, logs) in zip(pairs, panels):
        plot_hist_and_ratio(ax_m, ax_r, gv, rv, xlabel=label, log_scale=logs)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_jet_features(gen_feats, ref_feats, path: Optional[str] = None):
    """2x4 jet-level panel."""
    panels = [
        (gen_feats.pt, ref_feats.pt, r"jet $p_T$"),
        (gen_feats.m, ref_feats.m, r"jet mass"),
        (gen_feats.eta, ref_feats.eta, r"jet $\eta$"),
        (gen_feats.phi, ref_feats.phi, r"jet $\phi$"),
    ]
    for attr, label in [("tau21", r"$\tau_{21}$"), ("tau32", r"$\tau_{32}$"),
                        ("c1", r"$C_1$"), ("d2", r"$D_2$")]:
        if hasattr(gen_feats, attr):
            panels.append((getattr(gen_feats, attr), getattr(ref_feats, attr), label))
    fig, pairs = _grid_with_ratios(2, 4, (14, 7))
    for (ax_m, ax_r), (gv, rv, label) in zip(pairs, panels):
        plot_hist_and_ratio(ax_m, ax_r, gv, rv, xlabel=label)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def flavor_kinematics(gen_feats, ref_feats, path: Optional[str] = None):
    """8x3 per-flavor (pt, eta, phi) grid."""
    flavors = ["Photon", "NeutralHadron", "NegativeHadron", "PositiveHadron",
               "Electron", "Positron", "Muon", "AntiMuon"]
    g, r = gen_feats.constituents, ref_feats.constituents
    fig, pairs = _grid_with_ratios(8, 3, (12, 26))
    i = 0
    for flavor in flavors:
        for obs, label in [("pt", r"$p_T$"), ("eta", r"$\eta^{rel}$"), ("phi", r"$\phi^{rel}$")]:
            ax_m, ax_r = pairs[i]
            i += 1
            gv = getattr(g, f"{obs}_{flavor}")
            rv = getattr(r, f"{obs}_{flavor}")
            if len(_finite(rv)) < 2:
                ax_m.set_axis_off(); ax_r.set_axis_off()
                continue
            plot_hist_and_ratio(ax_m, ax_r, gv, rv, xlabel=f"{flavor} {label}",
                                log_scale=(obs == "pt"))
    if path:
        fig.savefig(path, dpi=100, bbox_inches="tight")
    return fig


def plot_charge_features(gen_dip, ref_dip, path: Optional[str] = None,
                         kappa: float = 1.0, beta: float = 1.0):
    """Q0 / Q_kappa / dipole-d2 panels.
    Takes two `JetChargeDipole`s."""
    g0, gk, gd = gen_dip.charge_and_dipole(kappa=kappa, beta=beta)
    r0, rk, rd = ref_dip.charge_and_dipole(kappa=kappa, beta=beta)
    fig, pairs = _grid_with_ratios(1, 3, (12, 4))
    for (ax_m, ax_r), (gv, rv, label) in zip(
            pairs, [(g0, r0, r"$Q_0$"), (gk, rk, rf"$Q_{{\kappa={kappa}}}$"),
                    (gd, rd, r"dipole $d_2$")]):
        plot_hist_and_ratio(ax_m, ax_r, gv, rv, xlabel=label)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_trajectories(trajectory: MultiModal, num_points: int = 500,
                      path: Optional[str] = None, timesteps_to_mark: Sequence[float] = ()):
    """Toy 2D trajectory plot: paths colored by final label.  `trajectory`
    is the stacked (T, N, 1, 2) output of
    `simulate(..., return_trajectory=True)`."""
    trajectory = astype_numpy(trajectory)
    x = trajectory.continuous[:, :num_points, 0, :]   # (T, N, 2)
    labels = trajectory.discrete[-1, :num_points, 0, 0]

    fig, ax = pyplot().subplots(figsize=(6, 6))
    ax.plot(x[:, :, 0], x[:, :, 1], color="gray", lw=0.2, alpha=0.3)
    sc = ax.scatter(x[-1, :, 0], x[-1, :, 1], c=labels, s=6, cmap="tab10", zorder=3)
    ax.scatter(x[0, :, 0], x[0, :, 1], c="lightgray", s=4, zorder=2)
    # intermediate-time snapshots (fractions in [0, 1] of the trajectory)
    T = x.shape[0]
    for frac in timesteps_to_mark:
        ti = min(int(round(float(frac) * (T - 1))), T - 1)
        ax.scatter(x[ti, :, 0], x[ti, :, 1], c="darkgray", s=4, alpha=0.6,
                   zorder=2)
    ax.set_xticks([]); ax.set_yticks([]); ax.axis("equal")
    fig.colorbar(sc, ax=ax, shrink=0.7)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig


def plot_trajectory_panels(trajectory: MultiModal, num_points: int = 500,
                           times: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                           path: Optional[str] = None):
    """The tutorial's figure (`notebooks/trajectories.png`): one panel
    per snapshot time, points colored by their label AT that time over the
    gray path bundle."""
    trajectory = astype_numpy(trajectory)
    x = trajectory.continuous[:, :num_points, 0, :]   # (T, N, 2)
    k = trajectory.discrete[:, :num_points, 0, 0]     # (T, N)
    T = x.shape[0]
    fig, axes = pyplot().subplots(1, len(times), figsize=(2.6 * len(times), 2.8))
    for ax, frac in zip(np.atleast_1d(axes), times):
        ti = min(int(round(float(frac) * (T - 1))), T - 1)
        ax.plot(x[:, :, 0], x[:, :, 1], color="gray", lw=0.15, alpha=0.25)
        ax.scatter(x[ti, :, 0], x[ti, :, 1], c=k[ti], s=3, cmap="tab10",
                   vmin=0, vmax=9, zorder=3)
        ax.text(0.03, 0.95, f"t={frac:.1f}", transform=ax.transAxes, va="top")
        ax.set_xticks([]); ax.set_yticks([]); ax.axis("equal")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
    return fig
