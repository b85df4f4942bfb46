"""Toy 2D multimodal datasets for the tutorial workload (PyTorch port's
copy of `multimodal_flows_tpu/data/toy.py`): colored 8-Gaussians and
colored two-moons in pure numpy from a seed, so both packages give equal
arrays; each has `.continuous (N, 2)` points and `.discrete (N, 1)` labels.
`as_clouds()` reshapes them into single-particle clouds (N, 1, F), a
`MultiModal` of numpy arrays, so the particle-cloud machinery (masks,
bridges, solvers) runs unchanged on the toy problem.
"""

from __future__ import annotations

import math

import numpy as np

from multimodal_flows_tpu_torch.data.state import MultiModal


class NGaussians:
    """N colored Gaussians on a circle, labels 1..N."""

    def __init__(self, dim=2, num_gaussians=8, num_points_per_gaussian=1000,
                 std_dev=0.1, scale=5, seed=0):
        self.dim = dim
        self.num_gaussians = num_gaussians
        self.N = num_gaussians * num_points_per_gaussian
        rng = np.random.default_rng(seed)

        positions, labels = [], []
        angle_step = 2 * np.pi / num_gaussians
        # covariance sqrt(std_dev) * I, as the tutorial notebook has it
        chol = math.sqrt(std_dev) ** 0.5
        for i in range(num_gaussians):
            angle = i * angle_step
            center = np.array([np.cos(angle), np.sin(angle)]) * scale
            pts = rng.normal(size=(num_points_per_gaussian, dim)) * chol + center
            positions.append(pts)
            labels += [i % num_gaussians] * num_points_per_gaussian

        positions = np.concatenate(positions, axis=0).astype(np.float32)
        labels = np.asarray(labels, dtype=np.int64)
        idx = rng.permutation(self.N)
        self.continuous = positions[idx]
        self.discrete = (labels[idx] + 1)[:, None]  # labels 1..N_gauss

    def __len__(self):
        return self.N

    def as_clouds(self) -> MultiModal:
        return _as_clouds(self.continuous, self.discrete)


class TwoMoons:
    """Colored two-moons, labels 1 and 2."""

    def __init__(self, dim=2, num_points_per_moon=1000, std_dev=0.2, seed=0):
        self.dim = dim
        self.N = 2 * num_points_per_moon
        rng = np.random.default_rng(seed)

        theta = rng.uniform(0, np.pi, size=num_points_per_moon)
        upper = np.stack([np.cos(theta), np.sin(theta)], axis=1)
        lower = np.stack([1 - np.cos(theta), -np.sin(theta) + 0.5], axis=1)
        pts = np.concatenate([upper, lower], axis=0)
        pts += rng.normal(size=pts.shape) * std_dev
        labels = np.concatenate([np.zeros(num_points_per_moon, np.int64),
                                 np.ones(num_points_per_moon, np.int64)])

        idx = rng.permutation(self.N)
        self.continuous = (pts[idx] * 3 - 1).astype(np.float32)
        self.discrete = (labels[idx] + 1)[:, None]  # labels 1, 2

    def __len__(self):
        return self.N

    def as_clouds(self) -> MultiModal:
        return _as_clouds(self.continuous, self.discrete)


def _as_clouds(continuous: np.ndarray, discrete: np.ndarray) -> MultiModal:
    """(N, F) points + (N, 1) labels -> (N, 1, F)/(N, 1, 1) particle clouds."""
    n = continuous.shape[0]
    return MultiModal(
        continuous=continuous[:, None, :].astype(np.float32),
        discrete=discrete[:, :, None].astype(np.int32),
        mask=np.ones((n, 1, 1), dtype=np.int32),
    )
