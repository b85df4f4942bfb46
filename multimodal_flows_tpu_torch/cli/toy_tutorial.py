"""Tutorial: colored 8-Gaussians -> 2-moons multimodal flow.

    python -m multimodal_flows_tpu_torch.cli.toy_tutorial [--epochs 20] [--out toy_out]

The twin of `examples/toy_tutorial.py`: train a small MLP multimodal flow
(CFM for the positions, a telegraph bridge for the color label) on the toy
coupling, whose sources are explicit (the 8 Gaussians, not noise), then
sample full trajectories with the hybrid tau-leaping solver, plot the
paths, and report the label frequencies and the per-axis W1 of the
generated points against a fresh two-moons sample.  `--device` (default
`cuda`) as in the other entry points.

`run` is the compute half (train, sample, closure numbers; no matplotlib);
`main` adds the plots.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.datasets import ArrayDataset
from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal
from multimodal_flows_tpu_torch.data.toy import NGaussians, TwoMoons
from multimodal_flows_tpu_torch.train.systems import MMF
from multimodal_flows_tpu_torch.train.trainer import Trainer
from multimodal_flows_tpu_torch.utils.logger import SimpleLogger as log
from multimodal_flows_tpu_torch.utils.metrics import wasserstein1d


def toy_config(epochs: int = 20, out: str = "toy_out") -> Config:
    """The tutorial notebook's recipe: 3 x 128 MLP, lr 1e-3, sigma 0.1,
    beta 0.25, batch 256, the sum of the two losses."""
    return Config(
        model="ToyMLP", vocab_size=9, dim_continuous=2, max_num_particles=1,
        n_embd=128, n_inner=128, n_layer=3, batch_size=256,
        max_epochs=epochs, lr=1e-3, lr_final=1e-5,
        multitask_loss="sum", beta=0.25, sigma=0.1,
        dir=out, project="toy", seed=0,
    )


def toy_coupling(num_points: int) -> DataCoupling:
    """8 colored Gaussians (labels 1..8) -> colored two moons (labels 1,
    2); vocabulary 9 covers both plus the pad token."""
    src = NGaussians(num_points_per_gaussian=num_points // 8, num_gaussians=8, seed=0)
    tgt = TwoMoons(num_points_per_moon=num_points // 2, seed=1)
    return DataCoupling(source=src.as_clouds(), target=tgt.as_clouds())


def generation_source(cfg: Config, n: int, device) -> MultiModal:
    """`n` fresh 8-Gaussians draws at t = time_eps: the model was trained
    on such sources, not on standard-normal noise."""
    gen_src = NGaussians(num_points_per_gaussian=n // 8, num_gaussians=8, seed=7).as_clouds()
    return MultiModal(time=torch.full((n,), cfg.time_eps),
                      continuous=torch.from_numpy(gen_src.continuous),
                      discrete=torch.from_numpy(gen_src.discrete),
                      mask=torch.ones((n, 1, 1), dtype=torch.int32)).to(device)


def closure(final: MultiModal, vocab_size: int, n: int) -> Dict:
    """Label frequencies of the generated points, and their per-axis W1
    against a fresh two-moons sample (scale about 3; < 0.3 looks closed)."""
    labels = final.discrete.cpu().numpy()[:, 0, 0]
    truth = TwoMoons(num_points_per_moon=n // 2, seed=9)
    gen_xy = final.continuous.cpu().numpy()[:, 0, :]
    return {"label_freq": np.bincount(labels, minlength=vocab_size) / n,
            "w1_x": wasserstein1d(gen_xy[:, 0], truth.continuous[:, 0]),
            "w1_y": wasserstein1d(gen_xy[:, 1], truth.continuous[:, 1]),
            "generated": gen_xy, "labels": labels, "truth": truth}


def run(cfg: Config, num_points: int = 80_000, num_timesteps: int = 200, device="cuda",
        num_generated: int = 2000) -> Dict:
    """The compute half: train the toy MMF on `device`, sample
    `num_generated` trajectories of `num_timesteps` steps from generator
    seed 42, and score the closure.  Returns the system, the train state,
    the final state, the trajectory and the closure numbers."""
    cfg.mint_experiment_id()
    train_ds, val_ds = ArrayDataset(toy_coupling(num_points)).split(0.9, seed=0)
    system = MMF(cfg, device=device, generator=torch.Generator().manual_seed(cfg.seed))
    state = Trainer(system, cfg).fit(train_ds, val_ds)

    final, trajectory = system.simulate(
        generation_source(cfg, num_generated, system.device), num_timesteps,
        generator=torch.Generator(device=system.device).manual_seed(42),
        return_trajectory=True)
    out = closure(final, cfg.vocab_size, num_generated)
    log.info(f"final label frequencies: {np.round(out['label_freq'], 3)} "
             f"(target: ~0.5 each on labels 1 and 2, ~0 elsewhere)")
    log.info(f"W1(generated, truth): x={out['w1_x']:.3f} y={out['w1_y']:.3f} "
             f"(truth scale ~3; <0.3 is visually closed)")
    return dict(out, system=system, state=state, final=final, trajectory=trajectory)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--num_points", type=int, default=80_000)
    p.add_argument("--num_timesteps", type=int, default=200)
    p.add_argument("--out", type=str, default="toy_out")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run; without CUDA the default raises, "
                        "`cpu` runs on the CPU")
    args = p.parse_args(argv)

    cfg = toy_config(args.epochs, args.out)
    out = run(cfg, args.num_points, args.num_timesteps, args.device)

    from multimodal_flows_tpu_torch.utils.plotting import (
        pyplot,
        plot_trajectories,
        plot_trajectory_panels,
    )

    out_png = os.path.join(cfg.experiment_dir, "trajectories.png")
    plot_trajectories(out["trajectory"], num_points=600, path=out_png)
    plot_trajectory_panels(out["trajectory"], num_points=600,
                           path=out_png.replace(".png", "_panels.png"))
    log.info(f"saved trajectory plots -> {out_png} (+_panels)")

    # generated against a fresh truth sample, side by side
    truth = out["truth"]
    fig, axes = pyplot().subplots(1, 2, figsize=(8, 4))
    axes[0].scatter(out["generated"][:, 0], out["generated"][:, 1], c=out["labels"], s=4,
                    cmap="tab10", vmin=0, vmax=9)
    axes[0].set_title("generated (t=1)")
    axes[1].scatter(truth.continuous[:, 0], truth.continuous[:, 1],
                    c=truth.discrete[:, 0], s=4, cmap="tab10", vmin=0, vmax=9)
    axes[1].set_title("target law")
    for ax in axes:
        ax.set_xticks([])
        ax.set_yticks([])
        ax.axis("equal")
    cmp_png = os.path.join(cfg.experiment_dir, "closure.png")
    fig.savefig(cmp_png, dpi=120, bbox_inches="tight")
    log.info(f"saved closure comparison -> {cmp_png}")


if __name__ == "__main__":
    main()
