"""Generation: batched sampling on the system's device (PyTorch port of
`multimodal_flows_tpu/sampling/generator.py`).

`generate_packed` is the serving entry point, for any of the three
systems (MMF, CFM, MJB): jets of multiplicity up to `pack_width` share
packed rows behind a block-diagonal segment mask; wider jets go through
`generate_bucketed` at their bucket width, and an encoder with learned
positions goes bucketed throughout.  On CUDA the attention of a packed
row is K1 (segments) or, with a pairwise bias, K2 (bias + segments); a
bucketed batch takes K1's key-mask form or K2's pair-mask bias.  Batches
run one after another in eager PyTorch; the JAX package's
`max_dispatch_steps` chunking, a workaround for its remote-TPU transport,
has no counterpart here.  Destandardization with the dataset metadata and
final pad masking happen on the host, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.packing import (
    build_packed_rows,
    first_n_filled,
    pack_jets,
    unpack_rows,
)
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.utils.logger import SimpleLogger as log

Tensor = torch.Tensor


@dataclasses.dataclass
class GenerationResult:
    sample: MultiModal           # destandardized, masked, CPU tensors
    jets_per_sec: float
    wall_time_s: float
    num_timesteps: int
    temperature: float
    tag: str = ""


def make_noise_source(generator: torch.Generator, pad_mask: Tensor,
                      config: Config) -> MultiModal:
    """Noise source: continuous ~ N(0,1)*mask, tokens ~ U{1..V-1}*mask,
    t0 = time_eps; drawn on the device of `pad_mask` (B, D, 1)."""
    B, D = pad_mask.shape[0], pad_mask.shape[1]
    device = pad_mask.device
    mask = pad_mask.to(torch.int32)
    x = torch.randn((B, D, config.dim_continuous), generator=generator,
                    dtype=torch.float32, device=device) * mask
    k = torch.randint(1, config.vocab_size, (B, D, 1), generator=generator,
                      dtype=torch.int32, device=device) * mask
    t0 = torch.full((B,), config.time_eps, dtype=torch.float32, device=device)
    return MultiModal(time=t0, continuous=x, discrete=k, mask=mask)


#: encoders that take packed multi-jet rows (segment ids): the
#: transformers through the block-diagonal segment mask of their attention,
#: EPiC through its per-segment pooling
_PACKABLE_MODELS = ("ParticleFormer", "FusedParticleFormer", "KinFormer",
                    "FlavorFormer", "EPiC")


def _snap_batch(n: int) -> int:
    """Smallest batch on the {8, 16, 32, then multiples of 64} ladder that
    fits n rows."""
    for b in (8, 16, 32):
        if n <= b:
            return b
    return ((n + 63) // 64) * 64


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finalize(sample: MultiModal, metadata: Optional[Dict]) -> MultiModal:
    """Host-side finalize: destandardize with the metadata, zero the pads."""
    m = sample.mask.cpu().to(torch.int32)
    x = sample.continuous.cpu().to(torch.float32)
    if metadata:
        x = (x * torch.tensor(metadata["std"], dtype=torch.float32)
             + torch.tensor(metadata["mean"], dtype=torch.float32))
    return MultiModal(continuous=x * m,
                      discrete=(sample.discrete.cpu() * m).to(torch.int32), mask=m)


def generate(system, pad_masks: np.ndarray, *, num_timesteps: int,
             temperature: float = 1.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, use_final_max_rates: bool = False,
             batch_size: int = 256, seed: int = 0,
             metadata: Optional[Dict] = None) -> GenerationResult:
    """Generate one jet per pad-mask row (N, D, 1), in batches of
    `batch_size`; the tail batch is padded and trimmed after."""
    cfg = system.config
    device = system.device
    num_jets = pad_masks.shape[0]
    kw = dict(num_timesteps=num_timesteps, temperature=temperature, top_k=top_k,
              top_p=top_p, use_final_max_rates=use_final_max_rates,
              batch_size=batch_size, metadata=metadata)

    # a tail that would waste >= 64 padded rows runs as its own smaller
    # batch, snapped to the {8, 16, 32, 64k} ladder
    rem = num_jets % batch_size
    if 0 < rem and num_jets > rem and batch_size - _snap_batch(rem) >= 64:
        head = generate(system, pad_masks[:num_jets - rem], seed=seed, **kw)
        tail = generate(system, pad_masks[num_jets - rem:], seed=seed + 104729, **kw)
        wall = head.wall_time_s + tail.wall_time_s
        return GenerationResult(sample=MultiModal.concat([head.sample, tail.sample]),
                                jets_per_sec=num_jets / wall, wall_time_s=wall,
                                num_timesteps=num_timesteps, temperature=temperature)
    if num_jets < batch_size:
        batch_size = min(_snap_batch(num_jets), batch_size)

    n_batches = (num_jets + batch_size - 1) // batch_size
    total = n_batches * batch_size
    masks = pad_masks
    if total > num_jets:  # pad the tail to the batch shape
        masks = np.concatenate([masks, np.repeat(masks[-1:], total - num_jets, axis=0)])

    t_start = time.perf_counter()
    masks_dev = torch.as_tensor(masks, dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    finals = []
    for i in range(n_batches):
        src = make_noise_source(gen, masks_dev[i * batch_size:(i + 1) * batch_size], cfg)
        finals.append(system.simulate(src, num_timesteps, temperature=temperature,
                                      top_k=top_k, top_p=top_p,
                                      use_final_max_rates=use_final_max_rates,
                                      generator=gen))
    _synchronize(device)
    wall = time.perf_counter() - t_start

    sample = MultiModal.concat(finals)[:num_jets]
    return GenerationResult(sample=_finalize(sample, metadata),
                            jets_per_sec=num_jets / wall, wall_time_s=wall,
                            num_timesteps=num_timesteps, temperature=temperature)


def generate_bucketed(system, pad_masks: np.ndarray, *, num_timesteps: int,
                      bucket_widths=(32, 40, 48, 56, 64, 128), **kw) -> GenerationResult:
    """Multiplicity-bucketed generation: jets are grouped by multiplicity
    into widths, each bucket runs `generate` at its own width, and the
    outputs are re-padded and put back in the original order.  Needs
    first-n-filled masks; otherwise every jet runs at the full width."""
    cfg = system.config
    if cfg.use_pos_emb or not first_n_filled(pad_masks):
        return generate(system, pad_masks, num_timesteps=num_timesteps, **kw)
    D = pad_masks.shape[1]
    mult = pad_masks[..., 0].sum(axis=1)
    widths = sorted(w for w in bucket_widths if w < D) + [D]
    num_jets = pad_masks.shape[0]
    order, pieces = [], []
    t0 = time.perf_counter()
    lo = 0
    for w in widths:
        sel = np.where((mult <= w) & (mult > lo))[0] if w != widths[0] else np.where(mult <= w)[0]
        lo = w
        if len(sel) == 0:
            continue
        s = generate(system, pad_masks[sel, :w], num_timesteps=num_timesteps, **kw).sample
        if w < D:  # re-pad to the global width
            s = s.map(lambda a: F.pad(a, (0, 0, 0, D - w)))
        order.append(sel)
        pieces.append(s)
    wall = time.perf_counter() - t0

    inv = torch.from_numpy(np.argsort(np.concatenate(order)))
    return GenerationResult(sample=MultiModal.concat(pieces)[inv],
                            jets_per_sec=num_jets / wall, wall_time_s=wall,
                            num_timesteps=num_timesteps,
                            temperature=kw.get("temperature", 1.0))


def generate_packed(system, pad_masks: np.ndarray, *, num_timesteps: int,
                    pack_width: int = 128, temperature: float = 1.0,
                    top_k: Optional[int] = None, top_p: Optional[float] = None,
                    use_final_max_rates: bool = False, batch_size: int = 256,
                    seed: int = 0, metadata: Optional[Dict] = None) -> GenerationResult:
    """Generation with multi-jet packing: several jets share one
    `pack_width`-token row behind a block-diagonal segment mask.

    Exactly the per-jet model: attention is restricted to same-segment
    pairs, all dense and solver work is per token, and on the sampling
    grid every jet shares the same t.  Jets wider than `pack_width` go
    through the bucketed path, and so does every jet of an encoder that
    cannot be packed (learned positions)."""
    cfg = system.config
    num_jets, D = pad_masks.shape[0], pad_masks.shape[1]
    kw = dict(num_timesteps=num_timesteps, temperature=temperature, top_k=top_k,
              top_p=top_p, use_final_max_rates=use_final_max_rates)
    if (cfg.model not in _PACKABLE_MODELS or cfg.use_pos_emb
            or not first_n_filled(pad_masks)):
        return generate_bucketed(system, pad_masks, batch_size=batch_size, seed=seed,
                                 metadata=metadata, **kw)

    t_start = time.perf_counter()
    mult = pad_masks[..., 0].sum(axis=1)
    row_of, offset_of, n_rows = pack_jets(mult, pack_width)

    if n_rows > 0:
        row_mask, row_seg = build_packed_rows(pad_masks, row_of, offset_of, n_rows,
                                              pack_width)
        # packed rows run at most 128 to a batch (the JAX package's
        # operating point); `batch_size` still governs the bucketed tail
        rows = _run_packed_rows(system, row_mask, row_seg, batch_size=min(batch_size, 128),
                                seed=seed, num_segments=int(row_seg.max()) + 1, **kw)
        sample = unpack_rows(rows, pad_masks, row_of, offset_of, pack_width)
    else:
        sample = MultiModal(
            continuous=torch.zeros((num_jets, D, cfg.dim_continuous), dtype=torch.float32),
            discrete=torch.zeros((num_jets, D, 1), dtype=torch.int32),
            mask=torch.from_numpy(pad_masks.astype(np.int32)))

    # jets wider than a row: bucketed path, written over their slots
    left = np.where(row_of < 0)[0]
    if len(left):
        res = generate_bucketed(system, pad_masks[left], batch_size=batch_size,
                                seed=seed + 15485863, metadata=None, **kw)
        idx = torch.from_numpy(left)
        sample.continuous[idx] = res.sample.continuous
        sample.discrete[idx] = res.sample.discrete

    wall = time.perf_counter() - t_start
    return GenerationResult(sample=_finalize(sample, metadata),
                            jets_per_sec=num_jets / wall, wall_time_s=wall,
                            num_timesteps=num_timesteps, temperature=temperature)


def _rebalanced_batch(n_rows: int, batch_size: int, gran: int = 8) -> int:
    """Shrink the batch so the same number of batches covers `n_rows`
    nearly evenly (e.g. 674 rows: 3 x 232 instead of 3 x 256).  Only when
    it removes >= 32 pad rows and >= 5% of the padded total."""
    n_batches = (n_rows + batch_size - 1) // batch_size
    if n_batches <= 1:
        return batch_size
    balanced = -(-n_rows // n_batches)          # ceil: rows per batch
    balanced = -(-balanced // gran) * gran      # ceil to granularity
    saved = (batch_size - balanced) * n_batches
    if saved >= 32 and saved >= 0.05 * n_batches * batch_size:
        return balanced
    return batch_size


def _run_packed_rows(system, row_masks: np.ndarray, row_segs: np.ndarray, *,
                     num_timesteps: int, temperature: float, top_k, top_p,
                     use_final_max_rates: bool, batch_size: int,
                     seed: int, num_segments: Optional[int] = None) -> MultiModal:
    """Sample packed rows (R, W): noise per row on the device, the segment
    ids fixed through each trajectory; `num_segments` (the most jets a row
    holds) sizes EPiC's per-jet global stream.  Returns the rows on the
    CPU."""
    cfg = system.config
    device = system.device
    n_rows, W = row_masks.shape[0], row_masks.shape[1]
    if n_rows < batch_size:
        batch_size = min(_snap_batch(n_rows), batch_size)
    batch_size = _rebalanced_batch(n_rows, batch_size)
    n_batches = (n_rows + batch_size - 1) // batch_size
    total = n_batches * batch_size
    if total > n_rows:  # pad with empty rows (mask 0, segment -1)
        row_masks = np.concatenate(
            [row_masks, np.zeros((total - n_rows,) + row_masks.shape[1:], row_masks.dtype)])
        row_segs = np.concatenate(
            [row_segs, np.full((total - n_rows, W), -1, row_segs.dtype)])

    masks_dev = torch.as_tensor(row_masks, dtype=torch.int32, device=device)
    segs_dev = torch.as_tensor(row_segs, dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    finals = []
    for i in range(n_batches):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        src = make_noise_source(gen, masks_dev[sl], cfg)
        finals.append(system.simulate(src, num_timesteps, temperature=temperature,
                                      top_k=top_k, top_p=top_p,
                                      use_final_max_rates=use_final_max_rates,
                                      segments=segs_dev[sl], num_segments=num_segments,
                                      generator=gen))
    return MultiModal.concat(finals)[:n_rows].to("cpu")


def save_generation(result: GenerationResult, config: Config, res_dir: str) -> str:
    """Write generated_sample.h5 + configs.yaml into the results dir."""
    import yaml

    os.makedirs(res_dir, exist_ok=True)
    out_path = os.path.join(res_dir, "generated_sample.h5")
    result.sample.save_to(out_path)
    with open(os.path.join(res_dir, "configs.yaml"), "w") as f:
        yaml.safe_dump(config.to_dict(), f, sort_keys=False)
    return out_path


def run_generation_sweep(system, test_masks: np.ndarray, config: Config, *,
                         temperatures: List[float], timestep_grid: List[int],
                         num_files: int = 1, save: bool = True) -> List[GenerationResult]:
    """The generation sweep: num_files x temperatures x timestep_grid runs of
    `generate_packed` on `test_masks`, file i seeded `config.seed + i`,
    each result tagged `{_tags}{_i}_steps_{steps}_temp_{temp}`.  With
    `save` and an experiment id each run is written to
    `<experiment_dir>/generation_results{tag}` (that needs h5py and yaml;
    `save=False` does not)."""
    results = []
    tags = config.tags or ""
    if isinstance(tags, (list, tuple)):
        tags = "_".join(str(t) for t in tags)
    if tags:
        tags = f"_{tags}"
    for i in range(num_files):
        for temp in temperatures:
            for steps in timestep_grid:
                suffix = f"_{i}" if i > 0 else ""
                tag = f"{tags}{suffix}_steps_{steps}_temp_{temp}"
                res = generate_packed(
                    system, test_masks, num_timesteps=steps, temperature=temp,
                    top_k=config.top_k, top_p=config.top_p,
                    use_final_max_rates=config.use_final_max_rates,
                    batch_size=config.batch_size, seed=config.seed + i,
                    metadata=config.metadata)
                res.tag = tag
                log.info(f"generated {len(res.sample)} jets @steps={steps} T={temp}: "
                         f"{res.jets_per_sec:.1f} jets/s")
                if save and config.experiment_id:
                    save_generation(res, config, os.path.join(config.experiment_dir,
                                                               f"generation_results{tag}"))
                results.append(res)
    return results
