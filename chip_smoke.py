"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Setup: refuses to run without CUDA; turns TF32 off; prints the card's
   name and power limit.
2. Builds the two kernels from the checkout's sources, one nvcc each, both
   at once: K1 (`multimodal_flows_tpu_torch/csrc/btc_attention.cu`) and K2
   (`csrc/set_attention.cu`), both around the shared core
   `csrc/set_attention_core.cuh`; prints each build's time, the compiler's
   register / shared-memory report and the tensor-core instructions
   `cuobjdump -sass` finds in each kernel symbol: every fp32 form (3xTF32)
   and every bf16 form must show HGMMA (`wgmma`) and no HMMA (`mma.sync`).
3. Holds each kernel against its plain PyTorch version on the card, fp32,
   on the shapes the sampler and the trainer give it and on the edges of
   the kernels' tiling (head sizes not a multiple of 8, T not a multiple of
   16, one jet filling a row, rows of 3-particle jets, scattered segment
   ids, head-major Tq != Tk with an odd Dh), and compares the autograd
   gradients (K1's also at the packed training batch, K2's with the bias's
   gradient).
   The Lund pair MLP kernel (`csrc/lund_pair_mlp.cu`, `lund_pair_mlp_phase`):
   its build and HGMMA, each case of LUND_CASES against the plain version
   and symmetric in (i, j), its launch counter, KinFormer's bias on it, its
   refusal of widths and head counts it does not take, its
   Function's gradient, and its time beside the plain version's and its
   bound (no library call computes it).
   ParT (`part_phase`): K2's bias + segments form at head size 16
   (B=128, T=128, H=8, C=128) against the plain version and timed beside
   it; CFM + ParticleTransformer through `generate_packed` (K2 bias +
   segments and bias, no K1, one `part.pair_embed` span and one K2 launch
   a block a forward); the pair embedding's share of a forward.  Its K2
   launches, error and time go into K2's entry of the kernels line.
4. Times each kernel, its plain version and one PyTorch call of the same
   function (`scaled_dot_product_attention` with the equivalent float
   mask) at the packed-row shapes, C=128 and C=256, and K1 in its key-mask
   form on wide jets (device time by CUDA events with the stream held
   while the host enqueues, median of alternating runs after warm-up);
   works out each kernel's bound (bytes at 3.35 TB/s or same-jet FLOPs at
   the 3xTF32 rate, whichever is larger).
5. Drives the serving paths through `generate_packed`, each with the
   launch counters set to 0 just before it and read just after:
   - the flagship MMF at full width on 512 jets of AOJ-like multiplicity
     plus 4 jets wider than a packed row: K1 in its segment and key-mask
     forms, K2 never;
   - the co-occurrence MMF (the flagship plus `use_coocurrence`), the same
     jets: K2 in its bias + segments form (packed rows) and its bias form
     (the bucketed wide jets), K1 never;
   - MJB + FlavorFormer (pairwise, learned positions: bucketed) and
     CFM + KinFormer (Lund bias: packed rows) at the CLI's widths, with
     lambda_u set nonzero, fewer jets and steps: K2 ran; the KinFormer run
     traced, each of its forwards ran the Lund pair MLP kernel, none the
     plain version.
   Each path's output must be well formed; both MMF samplers must agree
   with the CPU sampler (plain attention) for 8 steps on shared uniforms.
6. Training, on 2048 synthetic jets of that multiplicity plus 8 of
   135-150, split 90/10:
   - the flagship's packed training loss and every parameter gradient on
     the card against the CPU on one packed batch with shared bridge
     states, then one optimizer update from the same gradients on both;
   - 30 steps on one fixed batch with fixed draws: the loss falls;
   - the train step as one CUDA graph (`train_graph_check`), for the
     flagship MMF on packed rows and for GPT: 6 steps captured and
     replayed against the same 6 steps run eagerly from one state and one
     seed (losses, weights, Adam's moments, EMA within 1e-6), one capture
     and 5 replays, the replays under the sync-debug mode "error"; a
     bucketed fit captures once a width; a checkpoint taken after replayed
     steps resumes to the run it came from;
   - the main path: `Trainer.fit` of the flagship, packed rows of 128,
     256 jets a step, EMA, 2 epochs, counts set to 0 just before and read
     just after: K1 in its segment form (the wide jets as one-jet rows at
     width 150), K2 never; the logged losses finite, `last` and `best`
     written, `last` reloaded into a fresh system gives the logged
     validation loss;
   - the step's wall time, jets/s, peak memory, its device time split
     into forward, backward and optimizer, and the share of K1's forward
     and of its backward (the recompute through the plain version);
   - 5 steps of the co-occurrence MMF: K2 in its bias + segments form
     (its backward gives the bias's gradient), K1 never.
7. The rest of the model / solver matrix, each at the full width of its
   model, counts set to 0 before each phase and read after:
   - MMF + FusedParticleFormer: `generate_packed` on the flagship's jets
     (K1 five launches a forward, segment form on packed rows, key-mask
     form on the wide jets, the exact counts asserted), the sampler
     against the CPU on shared noise, 5 steps on a fixed packed batch (the
     loss falls, K1 5 launches a forward), and the step's time;
   - `Trainer.fit` of the flagship, 2 epochs, with the physics eval every
     epoch: `val_w1_pt/mass/mult/physics` logged and finite,
     `best_physics.pt` written, both evals on one generation seed;
   - flagship steps with `dropout=0.1`: in train mode K1 and K2 launch
     nothing and the plain-attention counter reads 16 a forward, in eval
     mode K1 runs again and the loss is deterministic; the step's time,
     and the plain attention with dropout against K1 at the step's shapes;
   - one bucketed epoch of the flagship: K1's key-mask form at every
     bucket width;
   - CFM + EPiC: `generate_packed`, packed rows against one jet a row on
     shared noise, the card against the CPU, steps on a fixed packed
     batch, the step's time; K1 and K2 never run;
   - every new solver mode on the card against the CPU for 4 steps on
     shared noise: hybrid `euler` with `class_freqs`, `top_k=3` +
     `top_p=0.9`, a sigmoid thermostat, `euler_maruyama`,
     `tauleap-bernouilli`, `euler`, `jump_or_stay`.
8. The entry points, each phase failing the run when it fails:
   - the compute halves of `cli.train_mmf` and `cli.sample_mmf` at the
     flagship's full width on in-memory synthetic jets (the machine has no
     h5py or yaml): two packed epochs, then `load_for_inference`, the
     empirical masks, `run_generation_sweep` over two sweep points and the
     W1 metrics; K1 must have moved by 16 a forward in both halves, K2 not
     at all, and `tb/events.out.tfevents.*` must exist and decode to the
     logged records;
   - `cli.toy_tutorial`'s compute at the tutorial's widths and points,
     epochs cut (10 of 20): W1(x), W1(y) and the label frequencies, the
     train step's wall time and launches, and the card's 200-step
     trajectory against the CPU's on shared uniforms (no kernel: the toy
     has no attention);
   - jet substructure (host code) once on the sampled jets, with the
     native library if the host compiler builds it, else the numpy version.
9. The GPT baseline at the training CLI's defaults with `--system GPT`
   (n_embd 256, 5 layers, 4 heads, sequences of 152, batch 256):
   - K2 at its GPT shapes against the plain version (held in 3): the full
     forward's causal form (the causal term in the kernel, the key
     tiles past each warp's rows skipped) with the q/k/v gradients and at
     the edges of its tiling (T 1, 17, 63, 64, 65, 152, 256; head sizes 64
     and 9; a key mask), with its largest difference from the bias form
     (1, 1, 152, 152) printed; the bias form itself with gradients; the
     decode's key-mask form (one query against 152 cached keys) at
     positions 0, 75 and 151; the causal form, the bias form, the library
     call with `is_causal` and the plain version timed in turns as in 4,
     the decode with the float key mask;
   - the KV-cached decode against the full forward at every position, and
     the card against the CPU on shared weights (logits, loss, greedy and
     Gumbel-injected generation);
   - `cli.train_mmf.train` with `--system GPT`, 2 epochs: K2's causal form
     exactly 5 launches a forward, K1 and every other form 0, `last`
     reloads to the logged val loss; 30 steps on a fixed batch (the loss
     falls) and the step's time (`utils/profiling.py`);
   - `cli.sample_mmf.sample_gpt` on that checkpoint, 512 jets at batch 256:
     K2's key-mask form exactly 5 x 151 launches a batch, BOS first, PAD
     after EOS; jets/s, and the decode step under the profiler.
10. The meshes (`mesh_phase`, right after the kernels' timings):
   - K1 at the per-rank shapes of tensor_parallel=2, H=2 at C=64 and
     C=128 (B=128, T=128), in its segment and key-mask forms, and K2 with a
     (B, 2, T, T) bias + segments, against the plain version with
     gradients, then timed as in 4;
   - NCCL at world size 1 on cuda:0: the flagship's packed step plain,
     data parallel and FSDP2 on one batch (84 rows) with the same draws:
     loss, every gradient and the weights after the update equal, K1 16
     launches a forward in each; each layout's step timed (wall, device
     time, launches, NCCL kernel time, peak memory); an FSDP `fit` whose
     `last` reloads into a plain one-device system to the logged val_loss;
   - the captured step on a data mesh (`mesh_graph_check`): a NCCL group
     of one rank, whose step still all-reduces its gradients (between its
     two graphs), 6 steps captured and replayed against the same 6 steps
     run eagerly on the mesh, as `train_graph_check` holds them;
   - two processes sharing the card over gloo (CUDA tensors): a data
     parallel and a tensor_parallel=2 step equal to the plain step (K1 at
     H=2, 16 a forward), and 128 jets sampled over the data mesh at 8
     steps equal to one process's on one seed.  A collective gloo refuses
     fails the run with its name.
11. The bf16 compute path (compute_dtype="bfloat16"; `check_bf16_kernels`
   and `time_bf16_kernels` right after 3 and 4, `bf16_phase` after 5):
   - the bf16 forms of K1 (segments, key mask) and K2 (bias + segments,
     bias, key mask + bias, key mask; an fp32 and a bf16 bias; head-major
     Tq != Tk, odd head size) against their bf16 plain versions (atol
     1e-2, rtol 1e-2), with gradients, and at the edges of the TMA / wgmma
     core (T 256 at head size 128, Tk off its 64-key tiles, a
     (B, 1, T, T) bias, a bias whose rows miss TMA's 16-byte rule); each
     case prints its host plan (q/k/v by TMA or staged, the bias by TMA or
     per fragment, the shared memory) and every path must have run; both
     timed at the packed-row shapes beside the bf16 plain version,
     scaled_dot_product_attention in bf16 and the bound at 2 bytes an
     element and the dense bf16 rate;
   - the flagship MMF in bf16 at full width: `generate_packed` on the jets
     and noise of 5 (the bf16 K1 in both forms, no fp32 kernel), the
     samples' W1 in pT, eta, phi and multiplicity against the fp32 samples,
     the bf16 sampler against the port's bf16 CPU sampler on shared noise;
     5 steps on a fixed packed batch (the loss falls, the bf16 K1 16
     launches a forward) and the step timed as in 6; the packed loss's
     bf16 drift from fp32 on shared states;
   - the co-occurrence MMF in bf16: `generate_packed` and 5 training steps
     (the bf16 K2, bias + segments and bias).
12. Prints one JSON line of the kernels, the card line, and the contract
   line {"ok": true, "device": {...}} last.  Any failure exits non-zero.

Against earlier versions of this script the two MMF sampling paths run 50
steps instead of 100 and the flagship's `Trainer.fit` 2 epochs instead of
3, to make room for the phases of 7.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import glob
import json
import os
import shutil
import struct
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from bench_torch.drivers.common import moved_rows
from multimodal_flows_tpu_torch.cli import sample_mmf, toy_tutorial, train_mmf
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.aoj import extract_metadata
from multimodal_flows_tpu_torch.data.datasets import ArrayDataset
from multimodal_flows_tpu_torch.data.packing import build_packed_rows, pack_jets
from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal
from multimodal_flows_tpu_torch.dynamics.bridges import RandomTelegraphBridge
from multimodal_flows_tpu_torch.dynamics.solvers import REFERENCE_CLASS_FREQS
from multimodal_flows_tpu_torch.dynamics.thermostats import SigmoidThermostat
from multimodal_flows_tpu_torch.models import particle_transformers
from multimodal_flows_tpu_torch.models.blocks import pair_mask_bias
from multimodal_flows_tpu_torch.ops import attention
from multimodal_flows_tpu_torch.ops import btc_attention as k1
from multimodal_flows_tpu_torch.ops import cuda_build
from multimodal_flows_tpu_torch.ops import lund_pair_mlp as lpm
from multimodal_flows_tpu_torch.ops import set_attention as k2
from multimodal_flows_tpu_torch.ops.attention import attention_btc_reference, attention_reference
from multimodal_flows_tpu_torch.parallel import tensor_parallel as tpar
from multimodal_flows_tpu_torch.parallel.mesh import data_rows
from multimodal_flows_tpu_torch.sampling.generator import generate_packed
from multimodal_flows_tpu_torch.train import physics_eval
from multimodal_flows_tpu_torch.train.systems import build_system
from multimodal_flows_tpu_torch.train.trainer import Trainer
from multimodal_flows_tpu_torch.utils import jet_substructure, profiling
from multimodal_flows_tpu_torch.utils.jet_features import JetFeatures
from multimodal_flows_tpu_torch.utils.logger import _masked_crc
from multimodal_flows_tpu_torch.utils.profiling import median_device_ms

# fp32 on both sides, TF32 off; the kernels sum over <= 256 keys in
# another order than the plain version's matmuls
ATOL, RTOL = 2e-5, 1e-5
# the gradients go through the same plain backward on both sides; their
# upstream gradient 2*out differs by the forward's rounding
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-4

FLAGSHIP = dict(model="ParticleFormer", n_embd=256, n_inner=512, n_layer=5, n_layer_fused=6,
                n_head=4, vocab_size=9, dim_continuous=3, max_num_particles=150,
                batch_size=128, multitask_loss="time-weighted")
COOCC = dict(FLAGSHIP, use_coocurrence=True)
# the training CLI's default widths (scripts/train_mmf.py:57-66), pair_chunk 16
CLI = dict(n_embd=256, n_inner=512, n_layer=5, n_head=4, vocab_size=9, dim_continuous=3,
           max_num_particles=150, pair_chunk=16)
FLAVOR = dict(CLI, model="FlavorFormer", use_pairwise=True, use_pos_emb=True)
KIN = dict(CLI, model="KinFormer", use_pairwise=True)
LAMBDA_U = 0.5
# training: the flagship on packed rows of 128, 256 jets a step (the
# training CLI's default, scripts/train_mmf.py:41), EMA, lr 5e-4, clip 1.0
TRAIN = dict(FLAGSHIP, batch_size=256, packed_training=True, pack_width=128,
             use_ema_weights=True, lr=5e-4, gradient_clip_val=1.0, max_epochs=2)
TRAIN_COOCC = dict(TRAIN, use_coocurrence=True)
# the rest of the matrix: FusedParticleFormer and EPiC at the CLI's widths
# (n_embd_glob 16 is the CLI default), the flagship with dropout, with the
# physics eval (the validation set's ~200 jets at 50 steps) and bucketed
FUSED = dict(CLI, model="FusedParticleFormer", batch_size=128, multitask_loss="time-weighted")
TRAIN_FUSED = dict(TRAIN, model="FusedParticleFormer")
EPIC = dict(model="EPiC", n_embd=256, n_embd_glob=16, n_layer=5, vocab_size=9, dim_continuous=3,
            max_num_particles=150, batch_size=128)
TRAIN_EPIC = dict(EPIC, batch_size=256, packed_training=True, pack_width=128,
                  use_ema_weights=True, lr=5e-4, gradient_clip_val=1.0)
TRAIN_DROPOUT = dict(TRAIN, dropout=0.1)
TRAIN_PHYSICS = dict(TRAIN, physics_eval_every_n_epochs=1,
                     physics_eval_num_jets=300, physics_eval_num_timesteps=50)
TRAIN_BUCKETED = dict(FLAGSHIP, batch_size=64, bucketed_training=True, bucket_widths=[48, 64, 128],
                      use_ema_weights=True, lr=5e-4, gradient_clip_val=1.0, max_epochs=1)
SAMPLING_STEPS = 50
# the entry points: the training CLI's defaults at the flagship's width
# (packed rows of 128, 256 jets a step, train_frac 0.8), 2 epochs on 1,024
# jets + 4 wide ones; then 512 jets at two sweep points
CLI_TRAIN = dict(TRAIN, max_epochs=2, train_frac=0.8, tags=["system:MMF"])
CLI_SWEEP_STEPS, CLI_SAMPLED_JETS = [20, 50], 512
# the toy tutorial at its own widths and points, epochs cut from 20
TOY_POINTS, TOY_EPOCHS, TOY_STEPS = 80_000, 10, 200
# card vs CPU on one training batch: fp32 on both sides, TF32 off; the sums
# run in another order and the card's per-jet sums (index_add_) use
# atomics, whose order changes from run to run
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3
# one Adam update from the same gradients on both sides
UPDATE_ATOL = 1e-5
# the packed training batch at the flagship: about 256 jets in rows of 128
TRAIN_K1_GRAD_SHAPE = (85, 128, 256, 4)
# a bucketed training batch at the narrowest bucket: 64 jets of width 48
BUCKET_K1_GRAD_SHAPE = (64, 48, 256, 4)

# (B, T, C, H), form: the flagship packed rows (half- and full-width
# blocks), wide jets at T=150, the parity-test shapes, the kernel's limits;
# then the edges of the tiling: head size 9 (not a multiple of 8), T=33
# with segments, one jet filling each row (no key tile skipped), rows of
# 3-particle jets (most tiles skipped), scattered ids in {-1, 0, 1, 2};
# then the bucketed training batches: 64 jets under a key mask at the
# bucket widths 48 (less than one 64-query block), 64 and 128, both stream
# widths (the widest bucket, 150, is the wide-jet shape above)
SEGMENT_FORMS = ("segments", "one_jet", "jets_of_3", "scattered")
K1_CASES = [
    ((128, 128, 128, 4), "segments"),
    ((128, 128, 256, 4), "segments"),
    ((16, 150, 128, 4), "key_mask"),
    ((16, 150, 256, 4), "key_mask"),
    ((12, 10, 32, 4), "key_mask"),
    ((8, 12, 32, 4), "segments"),
    ((16, 150, 128, 4), "none"),
    ((4, 256, 512, 4), "segments"),
    ((16, 128, 36, 4), "segments"),
    ((16, 150, 36, 4), "key_mask"),
    ((8, 33, 128, 4), "segments"),
    ((16, 128, 256, 4), "one_jet"),
    ((16, 128, 256, 4), "jets_of_3"),
    ((16, 128, 128, 4), "scattered"),
    ((4, 256, 256, 4), "scattered"),
    ((64, 48, 128, 4), "key_mask"),
    ((64, 48, 256, 4), "key_mask"),
    ((64, 64, 128, 4), "key_mask"),
    ((64, 64, 256, 4), "key_mask"),
    ((64, 128, 128, 4), "key_mask"),
    ((64, 128, 256, 4), "key_mask"),
]
# token-major (B, T, C, H) and form: the co-occurrence packed rows, the
# bucketed wide jets (pair mask + bias), the pair mask alone (a broadcast
# bias), the kernel's limits, then the tiling's edges as for K1; then
# CrossAttention's head-major shapes (B, H, Tq, Tk, Dh), and odd Dh with
# Tq != Tk both ways
K2_BTC_CASES = [
    ((128, 128, 128, 4), "bias_segments"),
    ((128, 128, 256, 4), "bias_segments"),
    ((16, 150, 256, 4), "pair_mask_bias"),
    ((16, 150, 128, 4), "pair_mask"),
    ((4, 256, 512, 4), "bias_segments"),
    ((16, 128, 36, 4), "bias_segments"),
    ((8, 33, 128, 4), "bias_segments"),
    ((16, 128, 256, 4), "bias_one_jet"),
    ((16, 128, 256, 4), "bias_jets_of_3"),
    ((16, 128, 128, 4), "bias_scattered"),
]
K2_HEAD_MAJOR_CASES = [((16, 4, 150, 64, 64), True), ((16, 4, 150, 64, 64), False),
                       ((16, 4, 150, 64, 33), True), ((8, 3, 20, 150, 9), False)]
TIMED = [(128, 128, 128, 4), (128, 128, 256, 4)]
# K1 in its key-mask form on the wide-jet batch: no key tile is skipped
TIMED_WIDE = (8, 150, 256, 4)
# the GPT baseline at the training CLI's defaults with `--system GPT`
# (scripts/train_mmf.py: n_embd 256, n_inner 512, 5 layers, 4 heads, batch
# 256; Config: gelu_new, dropouts 0): max_seq_length = max_num_particles =
# 150, so sequences of 152 and 13 logits.  2 epochs (cut from 1,500) on
# 1,024 + 4 wide synthetic jets, 30 steps on a fixed batch, then 512 jets
# sampled at batch 256.  K2 carries its attention: the full forward's
# causal bias form at GPT_SHAPE, the decode's key-mask form (one query
# against the 152 cached keys) at three positions.
GPT_ARGV = ["--system", "GPT", "--max_epochs", "2"]
GPT_JETS, GPT_SAMPLED_JETS, GPT_VS_CPU_ROWS = 1024, 512, 32
GPT_SHAPE = (256, 152, 256, 4)
GPT_DECODE_POS = (0, 75, 151)
# K2's causal form (B, T, C, H), with or without a key mask of trailing
# pads (every query keeps key 0): GPT's shape, then the edges of its
# 64-key tiles and 64-row blocks at head size 64 and 9
K2_CAUSAL_CASES = [(GPT_SHAPE, False), (GPT_SHAPE, True), ((8, 1, 256, 4), False),
                   ((8, 17, 256, 4), True), ((8, 63, 256, 4), False), ((8, 64, 256, 4), True),
                   ((8, 65, 256, 4), False), ((4, 256, 256, 4), True), ((8, 17, 36, 4), False),
                   ((8, 65, 36, 4), True), ((8, 152, 36, 4), False)]
# the decode against the teacher-forced forward, as tests/test_gpt.py holds
# JAX; the card against the CPU on shared weights (fp32, TF32 off, sums in
# another order); the tokens drawn from equal noise may part where two
# logits tie within the rounding
GPT_DECODE_ATOL, GPT_LOGITS_ATOL, GPT_LOSS_RTOL, GPT_TOKENS_EQUAL = 2e-4, 1e-4, 1e-5, 0.99


def _multiplicities(rng: np.random.Generator, n: int, hi: int) -> np.ndarray:
    """AOJ-like multiplicities: Poisson(40) clipped to [3, hi]."""
    return np.clip(rng.poisson(40, size=n), 3, hi)


def _packed_segments(B: int, T: int, rng: np.random.Generator) -> np.ndarray:
    """Segment ids of B packed rows of width T (pads -1)."""
    if T == 12:  # jets of 5 and 4, then 3 pads, as in tests/test_ops.py
        seg = np.full((B, T), -1, np.int32)
        seg[:, :5], seg[:, 5:9] = 0, 1
        return seg
    mult = _multiplicities(rng, 4 * B * T // 40, T)
    row_of, offset_of, n_rows = pack_jets(mult, T)
    pad = (np.arange(T)[None, :] < mult[:, None]).astype(np.int64)[..., None]
    _, seg = build_packed_rows(pad, row_of, offset_of, n_rows, T)
    if n_rows < B:
        raise ValueError(f"{n_rows} packed rows, {B} wanted")
    return seg[:B]


def _segments(pattern: str, B: int, T: int, rng: np.random.Generator) -> np.ndarray:
    """(B, T) segment ids of one of SEGMENT_FORMS (pads -1)."""
    if pattern == "segments":
        return _packed_segments(B, T, rng)
    if pattern == "one_jet":
        return np.zeros((B, T), np.int32)
    if pattern == "jets_of_3":
        pos = np.arange(T)
        return np.tile(np.where(pos < T - T % 3, pos // 3, -1), (B, 1)).astype(np.int32)
    return rng.integers(-1, 3, size=(B, T)).astype(np.int32)  # scattered


def _case_inputs(shape, form, dev, seed=0):
    """q, k, v (B, T, C), key mask, segments, bias and the query rows
    compared of one kernel case: the real ones, or all of them for
    scattered ids, where a pad query's own key is a pad too."""
    B, T, C, H = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, T, C), generator=gen, device=dev) for _ in range(3))
    rng = np.random.default_rng(seed)
    km = seg = bias = None
    real = torch.ones((B, T), dtype=torch.bool, device=dev)
    pattern = form.removeprefix("bias_")
    if pattern in SEGMENT_FORMS:
        seg = torch.from_numpy(_segments(pattern, B, T, rng)).to(dev)
        if pattern != "scattered":
            real = seg >= 0
    elif form in ("key_mask", "pair_mask", "pair_mask_bias"):
        mult = torch.from_numpy(rng.integers(2, T + 1, size=B)).to(dev)
        real = torch.arange(T, device=dev)[None, :] < mult[:, None]
        if form == "key_mask":
            km = torch.where(real, 0.0, -1e9).to(torch.float32)
        else:
            bias = pair_mask_bias(real[..., None].to(torch.int32))
    if form.startswith("bias_") or form == "pair_mask_bias":
        pairwise = torch.randn((B, H, T, T), generator=gen, device=dev)
        bias = pairwise if bias is None else bias + pairwise
    return q, k, v, km, seg, bias, real


def _held(name, out, ref, real, atol=ATOL, rtol=RTOL) -> float:
    """max abs error over the real query rows (in fp32); raises past the
    tolerance or when the output's dtype is not the plain version's."""
    torch.cuda.synchronize()
    if out.dtype != ref.dtype:
        raise AssertionError(f"{name}: output {out.dtype}, plain version {ref.dtype}")
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (out - ref).abs()[real]
    bad = err > atol + rtol * ref.abs()[real]
    max_err = float(err.max())
    print(f"{name}: max_abs_err {max_err:.3e} (atol {atol}, rtol {rtol}, "
          f"{int(real.sum())} real rows)")
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} values out of tolerance")
    return max_err


def _grads_held(name, fns, leaves, upstream=None, atol=GRAD_ATOL, rtol=GRAD_RTOL):
    """Compare the autograd gradients of fns[0] (a kernel) and fns[1] (its
    plain version) of sum(out**2), or of sum(out * upstream) when given,
    with respect to `leaves`."""
    grads = []
    for fn in fns:
        ls = [t.clone().requires_grad_(True) for t in leaves]
        out = fn(*ls)
        (out ** 2 if upstream is None else out.float() * upstream).sum().backward()
        grads.append([t.grad for t in ls])
    for i, (a, b) in enumerate(zip(*grads)):
        err = float((a.float() - b.float()).abs().max())
        print(f"{name} grad of input {i} {tuple(a.shape)} {a.dtype} vs plain: max_abs_err "
              f"{err:.3e}")
        if (a.shape != b.shape or a.dtype != b.dtype
                or not torch.allclose(a.float(), b.float(), atol=atol, rtol=rtol)):
            raise AssertionError(f"{name} gradient {i} out of tolerance")


def check_k1(dev) -> float:
    worst = 0.0
    for shape, form in K1_CASES:
        q, k, v, km, seg, _, real = _case_inputs(shape, form, dev)
        H = shape[3]
        out = k1.btc_attention(q, k, v, H, km, seg)
        ref = attention_btc_reference(q, k, v, H, km, seg)
        worst = max(worst, _held(f"K1 vs plain {shape} {form}", out, ref, real))
    q, k, v, km, _, _, _ = _case_inputs((16, 150, 128, 4), "key_mask", dev, seed=1)
    _grads_held("K1", [lambda a, b, c: k1.btc_attention(a, b, c, 4, km, None),
                       lambda a, b, c: attention_btc_reference(a, b, c, 4, km, None)],
                [q, k, v])
    q, k, v, _, seg, _, _ = _case_inputs(TRAIN_K1_GRAD_SHAPE, "segments", dev, seed=4)
    _grads_held(f"K1 at the training batch {TRAIN_K1_GRAD_SHAPE} segments",
                [lambda a, b, c: k1.btc_attention(a, b, c, 4, None, seg),
                 lambda a, b, c: attention_btc_reference(a, b, c, 4, None, seg)], [q, k, v])
    q, k, v, km2, _, _, _ = _case_inputs(BUCKET_K1_GRAD_SHAPE, "key_mask", dev, seed=5)
    _grads_held(f"K1 at a bucketed batch {BUCKET_K1_GRAD_SHAPE} key_mask",
                [lambda a, b, c: k1.btc_attention(a, b, c, 4, km2, None),
                 lambda a, b, c: attention_btc_reference(a, b, c, 4, km2, None)], [q, k, v])
    return worst


def _head_major_inputs(shape, masked, dev, seed=2):
    """CrossAttention's shapes: q (B, H, Tq, Dh), k/v (B, H, Tk, Dh), with
    or without a key mask and a (B, 1, Tq, Tk) bias."""
    B, H, Tq, Tk, Dh = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, Tq, Dh), generator=gen, device=dev)
    k, v = (torch.randn((B, H, Tk, Dh), generator=gen, device=dev) for _ in range(2))
    if not masked:
        return q, k, v, None, None
    rng = np.random.default_rng(seed)
    mult = torch.from_numpy(rng.integers(2, Tk + 1, size=B)).to(dev)
    km = torch.where(torch.arange(Tk, device=dev)[None, :] < mult[:, None], 0.0, -1e9)
    bias = torch.randn((B, 1, Tq, Tk), generator=gen, device=dev)
    return q, k, v, km.to(torch.float32), bias


def check_k2(dev) -> float:
    worst = 0.0
    for shape, form in K2_BTC_CASES:
        q, k, v, km, seg, bias, real = _case_inputs(shape, form, dev)
        H = shape[3]
        out = k2.set_attention_btc(q, k, v, H, km, bias, seg)
        ref = attention_btc_reference(q, k, v, H, km, seg, bias)
        worst = max(worst, _held(f"K2 vs plain {shape} {form} bias {tuple(bias.shape)}",
                                 out, ref, real))
    for shape, masked in K2_HEAD_MAJOR_CASES:
        q, k, v, km, bias = _head_major_inputs(shape, masked, dev)
        out = k2.set_attention(q, k, v, km, bias)
        ref = attention_reference(q, k, v, km, bias)
        real = torch.ones(out.shape[:3], dtype=torch.bool, device=dev)
        form = "key_mask + (B,1,Tq,Tk) bias" if masked else "no mask, no bias"
        worst = max(worst, _held(f"K2 vs plain head-major {shape} {form}", out, ref, real))
    q, k, v, km, bias = _head_major_inputs(K2_HEAD_MAJOR_CASES[0][0], True, dev, seed=3)
    _grads_held("K2", [lambda a, b, c, d: k2.set_attention(a, b, c, km, d),
                       lambda a, b, c, d: attention_reference(a, b, c, km, d)],
                [q, k, v, bias])
    return worst


# published H100 SXM rates: HBM 3.35 TB/s; dense TF32 tensor cores 495
# TFLOP/s, and the kernels' 3xTF32 spends three TF32 products on each fp32
# product
HBM_BYTES_PER_S = 3.35e12
KERNEL_FLOP_PER_S = 495e12 / 3
# dense bf16 tensor cores: one pass per product in the bf16 kernels
BF16_FLOP_PER_S = 989e12


def _roofline(nbytes: int, flops: int, flop_per_s: float = KERNEL_FLOP_PER_S):
    """(ms, what bounds it): `nbytes` at the HBM rate against `flops` at
    `flop_per_s` (the 3xTF32 rate unless given), whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _bound(q: torch.Tensor, real_pairs: int, extra_bytes: int):
    """(ms, what bounds it): the least time for the kernel's work on these
    inputs: q, k, v read and the output written once (at q's element size)
    plus `extra_bytes` (segments or key mask, the bias of the pairs used) at
    the HBM rate, against QK^T and PV over the (query, key) pairs that this
    data needs (real tokens of one jet) at the kernel's tensor-core rate
    (3xTF32 for fp32, bf16 dense for bf16), whichever is longer."""
    rate = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else KERNEL_FLOP_PER_S
    return _roofline(4 * q.numel() * q.element_size() + extra_bytes,
                     4 * q.shape[-1] * real_pairs, rate)


def _library_call(q, k, v, H, ref, real, name, atol=1e-4, **sdpa_kw):
    """One PyTorch call of the same function: scaled_dot_product_attention
    over head-major views of q (B, Tq, C) and k/v (B, Tk, C) with the
    equivalent additive float mask (`attn_mask`, made beforehand, in q's
    dtype for bf16) or `is_causal`; checked against the plain version once
    (within `atol`: 1e-4 in fp32, a bf16 ulp or two in bf16)."""
    B, T, C = q.shape

    def heads(t):
        return t.view(B, t.shape[1], H, C // H).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)

    def call():
        return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, **sdpa_kw)

    out = call().transpose(1, 2).reshape(B, T, C)
    err = float((out.float() - ref.float()).abs()[real].max())
    print(f"{name}: scaled_dot_product_attention vs plain max_abs_err {err:.3e} (atol {atol})")
    if err > atol:
        raise AssertionError(f"{name}: the library call does not compute the kernel's function")
    return call


def _print_time(name, shape, form, t):
    print(f"{name} time {shape} {form}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
          f"scaled_dot_product_attention {t['library_ms']:.4f} ms, kernel / plain "
          f"{t['ms'] / t['plain_ms']:.3f} (median of 40, CUDA events, device time); bound "
          f"{t['bound_ms']:.4f} ms by {t['bound_by']}, kernel / bound "
          f"{t['ms'] / t['bound_ms']:.2f}")


def _fp32_plan(q, k, v, H=None) -> dict:
    """The fp32 core's host plan of a call (`ops/set_attention.py:fp32_plan`)
    on token-major q/k/v with H heads, or head-major ones (H None)."""
    return dataclasses.asdict(k2.fp32_plan(*(t if H is None else k2._heads(t, H)
                                             for t in (q, k, v))))


def _time_packed(shape, dev):
    """{"K1": times, "K2": times} at packed rows of `shape`: K1 in its
    segment form, K2 in its bias + segments form, each with its plain
    version, the library call and its bound."""
    q, k, v, _, seg, bias, real = _case_inputs(shape, "bias_segments", dev)
    B, T, C, H = shape
    same = seg[:, None, :, None] == seg[:, None, None, :]
    # (query, key) pairs of one jet: the only ones the function reads a
    # bias entry for and computes a product of
    pairs = int((same[:, 0] & real[:, :, None]).sum())
    cross = torch.where(same, 0.0, -1e9)
    forms = {
        "K1": ("segments", lambda: k1.btc_attention(q, k, v, H, None, seg),
               lambda: attention_btc_reference(q, k, v, H, None, seg),
               cross, 4 * seg.numel()),
        "K2": (f"bias {tuple(bias.shape)} + segments",
               lambda: k2.set_attention_btc(q, k, v, H, None, bias, seg),
               lambda: attention_btc_reference(q, k, v, H, None, seg, bias),
               (bias + cross).contiguous(), 4 * (seg.numel() + H * pairs)),
    }
    result = {}
    for name, (form, kernel, plain, mask, extra) in forms.items():
        library = _library_call(q, k, v, H, plain(), real, f"{name} {shape}", attn_mask=mask)
        ms, plain_ms, library_ms = median_device_ms([kernel, plain, library])
        bound_ms, bound_by = _bound(q, pairs, extra)
        t = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                 bound_by=bound_by, plan=_fp32_plan(q, k, v, H))
        _print_time(name, shape, form, t)
        result[name] = t
    return result


def _time_key_mask(shape, dev):
    """K1 in its key-mask form at `shape` (no key tile skipped), with its
    plain version, the library call and its bound."""
    q, k, v, km, _, _, real = _case_inputs(shape, "key_mask", dev)
    H = shape[3]
    plain = lambda: attention_btc_reference(q, k, v, H, km)  # noqa: E731
    library = _library_call(q, k, v, H, plain(), real, f"K1 {shape} key_mask",
                            attn_mask=km[:, None, None, :])
    ms, plain_ms, library_ms = median_device_ms(
        [lambda: k1.btc_attention(q, k, v, H, km, None), plain, library])
    n_real = real.sum(dim=1)
    bound_ms, bound_by = _bound(q, int((n_real * n_real).sum()), 4 * km.numel())
    t = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
             bound_by=bound_by, plan=_fp32_plan(q, k, v, H))
    _print_time("K1", shape, "key_mask", t)
    return t


def time_kernels(dev):
    """{(kernel, shape): times} at the packed-row shapes: K1 in its segment
    form, K2 in its bias + segments form; then K1 in its key-mask form on
    the wide-jet batch.  Each with its plain version, the library call and
    its bound."""
    result = {}
    with torch.no_grad():
        for shape in TIMED:
            for name, t in _time_packed(shape, dev).items():
                result[name, shape] = t
        result["K1", TIMED_WIDE] = _time_key_mask(TIMED_WIDE, dev)
    return result


def _gpt_forward_inputs(dev, seed=5):
    B, T, C, _ = GPT_SHAPE
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, T, C), generator=gen, device=dev) for _ in range(3))
    return q, k, v, attention.causal_bias(T, dev)


def _gpt_decode_inputs(pos, dev, seed=6):
    """One decode call: q (B, 1, C) against (B, 152, C) caches, the key
    mask 0 on the cached positions <= pos and -1e9 after."""
    B, T, C, _ = GPT_SHAPE
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, 1, C), generator=gen, device=dev)
    k, v = (torch.randn((B, T, C), generator=gen, device=dev) for _ in range(2))
    km = torch.where(torch.arange(T, device=dev) <= pos, 0.0, -1e9).expand(B, T).contiguous()
    return q, k, v, km


def check_k2_gpt(dev) -> float:
    """K2 at the GPT baseline's two shapes against its plain version: the
    full forward's causal bias (broadcast by zero strides), with the q/k/v
    gradients, and the decode's key-mask form at three positions."""
    B, T, C, H = GPT_SHAPE
    q, k, v, bias = _gpt_forward_inputs(dev)
    real = torch.ones((B, T), dtype=torch.bool, device=dev)
    worst = _held(f"K2 vs plain GPT forward {GPT_SHAPE} causal bias (1,1,T,T)",
                  k2.set_attention_btc(q, k, v, H, None, bias),
                  attention_btc_reference(q, k, v, H, None, None, bias), real)
    _grads_held(f"K2 at the GPT forward {GPT_SHAPE} causal bias",
                [lambda a, b, c: k2.set_attention_btc(a, b, c, H, None, bias),
                 lambda a, b, c: attention_btc_reference(a, b, c, H, None, None, bias)],
                [q, k, v])
    for pos in GPT_DECODE_POS:
        q1, kc, vc, km = _gpt_decode_inputs(pos, dev)
        worst = max(worst, _held(f"K2 vs plain GPT decode ({B}, 1 of {T}, {C}, {H}) key_mask "
                                 f"pos {pos}", k2.set_attention_btc(q1, kc, vc, H, km),
                                 attention_btc_reference(q1, kc, vc, H, km), real[:, :1]))
    return worst


def check_k2_causal(dev) -> float:
    """K2's causal form against the plain version with the causal
    bias, at GPT's shape with the q/k/v gradients and at the edges of its
    tiling (K2_CAUSAL_CASES); at GPT's shape also the largest difference
    from K2's bias form on the same inputs (the same scores, so 0 or a few
    ulp where the compiler contracts otherwise)."""
    worst = 0.0
    for shape, masked in K2_CAUSAL_CASES:
        B, T, C, H = shape
        q, k, v, km, _, _, real = _case_inputs(shape, "key_mask" if masked else "none", dev,
                                               seed=T)
        bias = attention.causal_bias(T, dev)
        name = f"K2 causal vs plain {shape} {'key_mask' if masked else 'no mask'}"
        out = k2.set_attention_btc(q, k, v, H, km, causal=True)
        worst = max(worst, _held(name, out, attention_btc_reference(q, k, v, H, km, None, bias),
                                 real))
        if shape == GPT_SHAPE and not masked:
            diff = float((out - k2.set_attention_btc(q, k, v, H, None, bias)).abs().max())
            print(f"K2 causal vs K2 bias form {shape}: max_abs_diff {diff:.3e}")
            _grads_held(f"K2 causal at the GPT forward {shape}",
                        [lambda a, b, c: k2.set_attention_btc(a, b, c, H, causal=True),
                         lambda a, b, c: attention_btc_reference(a, b, c, H, None, None, bias)],
                        [q, k, v])
    return worst


def time_gpt_attention(dev):
    """{"full_causal", "full", "decode", "decode_pos75"}: K2 (its causal
    form and its bias form for the full forward), its plain version and
    scaled_dot_product_attention (is_causal for the full forward, the float
    key mask for a decode call) at the GPT shapes, with their bounds: the
    full forward's q, k, v and out (and the bias form's bias) once against
    the causal pairs' FLOPs; a decode call's q, out, key mask and the cache
    rows <= pos (the keys this data needs) against their FLOPs."""
    B, T, C, H = GPT_SHAPE
    result = {}
    with torch.no_grad():
        q, k, v, bias = _gpt_forward_inputs(dev)
        real = torch.ones((B, T), dtype=torch.bool, device=dev)
        plain = lambda: attention_btc_reference(q, k, v, H, None, None, bias)  # noqa: E731
        library = _library_call(q, k, v, H, plain(), real, "K2 GPT forward", is_causal=True)
        causal_ms, ms, plain_ms, library_ms = median_device_ms(
            [lambda: k2.set_attention_btc(q, k, v, H, causal=True),
             lambda: k2.set_attention_btc(q, k, v, H, None, bias), plain, library])
        flops = 4 * C * B * T * (T + 1) // 2
        for key, form, t, nbytes in (
                ("full_causal", "GPT forward, causal form", causal_ms, 4 * 4 * q.numel()),
                ("full", "GPT forward, causal bias", ms, 4 * (4 * q.numel() + bias.numel()))):
            bound_ms, bound_by = _roofline(nbytes, flops)
            result[key] = dict(ms=t, plain_ms=plain_ms, library_ms=library_ms,
                               bound_ms=bound_ms, bound_by=bound_by, plan=_fp32_plan(q, k, v, H))
            _print_time("K2", GPT_SHAPE, form, result[key])
        for pos, key in ((T - 1, "decode"), (75, "decode_pos75")):
            q1, kc, vc, km = _gpt_decode_inputs(pos, dev)
            plain = lambda: attention_btc_reference(q1, kc, vc, H, km)  # noqa: E731
            library = _library_call(q1, kc, vc, H, plain(), real[:, :1], f"K2 GPT decode {pos}",
                                    attn_mask=km[:, None, None, :])
            ms, plain_ms, library_ms = median_device_ms(
                [lambda: k2.set_attention_btc(q1, kc, vc, H, km), plain, library])
            keys = B * (pos + 1)
            bound_ms, bound_by = _roofline(4 * (2 * q1.numel() + km.numel() + 2 * keys * C),
                                           4 * C * keys)
            result[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               plan=_fp32_plan(q1, kc, vc, H))
            _print_time("K2", (B, 1, T, C, H), f"GPT decode, key_mask pos {pos}", result[key])
    return result


# ------------------------------------------------------- Lund pair MLP

#: (B, D, C, H, U) of the Lund pair MLP's checks: the Lund cell's packed
#: batches (128 and 80 rows of 128, U of packed jets), the bucketed width
#: 150, small D and the other head counts the kernel takes (U random, so
#: the two orientations differ)
LUND_CASES = [(128, 128, 256, 4, "jets"), (80, 128, 256, 4, "jets"),
              (8, 150, 256, 4, "random"), (3, 5, 256, 4, "random"), (2, 9, 256, 3, "random"),
              (4, 33, 256, 2, "random"), (4, 17, 256, 1, "random")]
#: the kernel's 3xTF32 C x C product and its own sums against the plain
#: version's fp32 GEMMs: about 1e-6 on a bias of order one
LUND_ATOL, LUND_RTOL = 2e-5, 1e-5
#: the Lund cell's destandardisation (bench_torch/configs/cfm-kinformer-lund.json)
LUND_METADATA = {"mean": [21.016593877194147, 9.910235204337828e-05, 1.9272257871336627e-05],
                 "std": [20.03396353429283, 0.14994647759321778, 0.15003588849793748]}
LUND_CHUNK = 16
#: the timed shapes: the Lund cell's batch of packed rows, then wide jets
LUND_TIMED = [(128, 128, 256, 4, "jets"), (8, 150, 256, 4, "jets")]


def _lund_mlp(C, H, dev, seed=0, biases=True) -> lpm.PairMLP:
    """Pair-MLP weights (leaves that take gradients) scaled as the
    benchmark draws them: matrices N(0, 1/fan_in), biases N(0, 0.1^2),
    LayerNorm scales 1 + N(0, 0.1^2); eps 1e-6, as KinFormer's."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, scale, shift=0.0):
        return nn.Parameter(torch.randn(shape, generator=gen, device=dev) * scale + shift)

    fc_w, fc_b = draw((C, 2), 2 ** -0.5), draw((C,), 0.1)
    ln_w, ln_b = draw((C,), 0.1, 1.0), draw((C,), 0.1)
    proj_w = draw((C, C), C ** -0.5)
    proj_b = draw((C,), 0.1) if biases else None
    out_w = draw((H, C), C ** -0.5)
    out_b = draw((H,), 0.1) if biases else None
    return lpm.PairMLP(fc_w, fc_b, ln_w, ln_b, proj_w, proj_b, out_w, out_b,
                       nn.Parameter(torch.tensor(LAMBDA_U, device=dev)), 1e-6)


def _lund_U(B, D, kind, dev, seed=0):
    """U (B, D, D, 2): the Lund observables of packed rows of standardized
    noise kinematics (the sampler's start), or standard normal."""
    if kind == "random":
        return torch.randn((B, D, D, 2), generator=torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    seg = torch.from_numpy(_packed_segments(B, D, np.random.default_rng(seed))).to(dev)
    mask = (seg >= 0).to(torch.int32)[..., None]
    x = torch.randn((B, D, 3), generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev) * mask
    state = MultiModal(continuous=x, mask=mask)
    return particle_transformers.lund_observables(state, LUND_METADATA["mean"],
                                                  LUND_METADATA["std"])


def _lund_grads(fn, U, mlp, upstream) -> list:
    """The gradients of sum(fn(U, mlp) * upstream) for U and each parameter
    of the pair MLP (None where it has none)."""
    u = U.detach().clone().requires_grad_(True)
    params = [t for t in mlp.tensors() if t is not None]
    for t in params:
        t.grad = None
    (fn(u, mlp) * upstream).sum().backward()
    return [u.grad] + [t.grad.clone() for t in params]


def _lund_bound(B, D, C, H):
    """(ms, what bounds it): U read and the bias written once at the HBM
    rate against the pair MLP's FLOPs of every slot pair (stage 1 once,
    C x C, C x H: bench_torch/reference/kinformer.py:pair_flops) at the
    3xTF32 rate."""
    pairs = B * D * D
    return _roofline(4 * pairs * (2 + H), pairs * 2 * (2 * C + C * C + C * H))


def time_lund_pair_mlp(dev) -> dict:
    """{"BxD": times} at LUND_TIMED: the kernel beside the plain version
    (chunks of LUND_CHUNK rows, as the Lund cell runs it) and its bound."""
    times = {}
    with torch.no_grad():
        for B, D, C, H, kind in LUND_TIMED:
            U = _lund_U(B, D, kind, dev, seed=4)
            w = _lund_mlp(C, H, dev, seed=4)
            ms, plain_ms = median_device_ms(
                [lambda: lpm.lund_pair_mlp_kernel(U, w),
                 lambda: lpm.lund_pair_mlp_reference(U, w, LUND_CHUNK)], n=20)
            bound_ms, bound_by = _lund_bound(B, D, C, H)
            t = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            print(f"Lund pair MLP time B={B} D={D} C={C} H={H}: kernel {ms:.4f} ms, "
                  f"plain (chunks of {LUND_CHUNK}) {plain_ms:.4f} ms, "
                  f"kernel / plain {ms / plain_ms:.3f} (median of 20, CUDA events, device "
                  f"time); bound {bound_ms:.4f} ms by {bound_by}, kernel / bound "
                  f"{ms / bound_ms:.2f}")
            times[f"{B}x{D}"] = t
    return times


def lund_pair_mlp_phase(dev) -> dict:
    """The fused Lund pair MLP (`ops/lund_pair_mlp.py`): build (time, the
    compiler's report, HGMMA and no HMMA), every case of LUND_CASES against
    the plain version (with and without the two biases) and symmetric in
    (i, j), the launch counter against the forwards, KinFormer's
    `_lund_bias` on the kernel route, the refusal of widths and head counts
    the kernel does not take, the Function's gradient against the plain
    path's, and the kernel's time beside the plain version's (chunks
    of 16 rows, as the Lund cell) and the bound."""
    t0 = time.perf_counter()
    lpm.build()
    build_s = time.perf_counter() - t0
    so = lpm._LIB.path()
    print(f"Lund pair MLP build: {build_s:.2f} s ({so.name})")
    log = so.with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())
    counts = _tensor_core_counts(so)
    print(f"Lund pair MLP tensor cores: {counts}")
    kernels = {sym: c for sym, c in counts.items() if "lund_pair_mlp_kernel" in sym}
    if not kernels or any(c["HMMA"] or not c["HGMMA"] for c in kernels.values()):
        raise AssertionError(f"the Lund pair MLP does not run on wgmma alone: {counts}")

    err, sym_err = 0.0, 0.0
    with torch.no_grad():
        for case in LUND_CASES:
            B, D, C, H, kind = case
            U = _lund_U(B, D, kind, dev)
            for biases in (True, False):
                w = _lund_mlp(C, H, dev, biases=biases)
                ref = lpm.lund_pair_mlp_reference(U, w, LUND_CHUNK)
                out = lpm.lund_pair_mlp_kernel(U, w)
                name = f"Lund pair MLP {case} biases={biases}"
                err = max(err, _held(name, out, ref, torch.ones_like(out, dtype=torch.bool),
                                     LUND_ATOL, LUND_RTOL))
                gap = float((out - out.transpose(-1, -2)).abs().max())
                print(f"{name}: symmetric in (i, j) to {gap:.3e}"
                      f"{' (to the bit)' if gap == 0 else ''}")
                if gap > LUND_ATOL:
                    raise AssertionError(f"{name}: not symmetric ({gap:.3e})")
                sym_err = max(sym_err, gap)

        # the launch counter against the forwards, through the dispatch
        U = _lund_U(16, 128, "jets", dev, seed=1)
        w = _lund_mlp(256, 4, dev, seed=1)
        before = _group(profiling.peek_counters(), "lund_mlp")
        for _ in range(5):
            lpm.lund_pair_mlp(U, w, LUND_CHUNK)
        routes = {k: n - before[k] for k, n in _group(profiling.peek_counters(),
                                                      "lund_mlp").items()}
        print(f"Lund pair MLP: 5 forwards, routes {routes}")
        if routes != {"kernel": 5, "plain": 0}:
            raise AssertionError(f"Lund pair MLP: 5 forwards took the routes {routes}")

        # KinFormer's bias on the kernel route, against the plain version
        system = _system("CFM", dict(KIN, metadata=LUND_METADATA), dev)
        seg = torch.from_numpy(_packed_segments(32, 128, np.random.default_rng(2))).to(dev)
        mask = (seg >= 0).to(torch.int32)[..., None]
        x = torch.randn((32, 128, 3), device=dev) * mask
        state = MultiModal(continuous=x, mask=mask)
        m = system.module
        before = profiling.peek_counters()["lund_mlp.kernel"]
        got = m._lund_bias(state)
        if profiling.peek_counters()["lund_mlp.kernel"] - before != 1:
            raise AssertionError("KinFormer's Lund bias did not take the kernel")
        U = particle_transformers.lund_observables(state, LUND_METADATA["mean"],
                                                   LUND_METADATA["std"])
        fc, ln, proj, out = m.wue_fc, m.wue_ln, m.wue_proj_fc, m.wue_proj_out
        w = lpm.PairMLP(fc.weight, fc.bias, ln.weight, ln.bias, proj.weight, proj.bias,
                        out.weight, out.bias, m.lambda_u, ln.eps)
        err = max(err, _held("KinFormer._lund_bias (kernel) vs plain", got,
                             lpm.lund_pair_mlp_reference(U, w, LUND_CHUNK),
                             torch.ones_like(got, dtype=torch.bool), LUND_ATOL, LUND_RTOL))
        del system

        # widths and head counts the kernel does not take raise, on the card too
        for C, H in ((128, 4), (256, 8)):
            try:
                lpm.lund_pair_mlp(_lund_U(2, 9, "random", dev), _lund_mlp(C, H, dev))
            except ValueError as e:
                print(f"Lund pair MLP C={C} H={H}: refused ({e})")
            else:
                raise AssertionError(f"the Lund pair MLP took C={C} H={H}")

    # the Function's gradient: its backward recomputes through the plain version
    U = _lund_U(4, 40, "random", dev, seed=3)
    w = _lund_mlp(256, 4, dev, seed=3)
    upstream = torch.randn((4, 4, 40, 40), device=dev)
    got = _lund_grads(lambda u, m: lpm.lund_pair_mlp(u, m, LUND_CHUNK), U, w, upstream)
    want = _lund_grads(lambda u, m: lpm.lund_pair_mlp_reference(u, m, LUND_CHUNK), U, w,
                       upstream)
    for i, (a, b) in enumerate(zip(got, want)):
        gap = float((a - b).abs().max())
        print(f"Lund pair MLP grad of input {i} {tuple(a.shape)} vs plain: max_abs_err {gap:.3e}")
        if not torch.allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL):
            raise AssertionError(f"Lund pair MLP gradient {i} out of tolerance")

    times = time_lund_pair_mlp(dev)
    first = times["{}x{}".format(*LUND_TIMED[0])]
    if first["ms"] > first["plain_ms"] / 4:
        raise AssertionError("the Lund pair MLP kernel takes more than a quarter of the plain "
                             f"version's time at {LUND_TIMED[0]}")
    return {"max_abs_err": err, "max_sym_gap": sym_err, "build_s": build_s, "times": times}


# ------------------------------------------------------------- ParT (CFM)

#: CFM over the Particle Transformer at the published widths of
#: `bench_torch/configs/cfm-part.json` (8 heads of 16, 8 blocks), on the
#: Lund configuration's metadata
PART = dict(model="ParticleTransformer", n_embd=128, n_inner=512, n_layer=8, n_head=8,
            vocab_size=9, dim_continuous=3, max_num_particles=150, qk_layernorm=False,
            metadata=LUND_METADATA)
#: K2's bias + segments form at ParT's packed rows: B=128 rows of T=128,
#: C=128 over H=8 heads of 16 (the head size's 32 bucket, half padding)
PART_K2_SHAPE = (128, 128, 128, 8)


def part_phase(dev) -> dict:
    """K2's bias + segments form at ParT's head size 16 against the plain
    attention (and timed beside it), then CFM + ParT through
    `generate_packed`: K2 bias + segments on the packed rows, its bias form
    on the jets wider than a row, no K1, one `part.pair_embed` span and one
    K2 launch a block a forward."""
    q, k, v, km, seg, bias, real = _case_inputs(PART_K2_SHAPE, "bias_segments", dev)
    H = PART_K2_SHAPE[3]
    err = _held(f"K2 vs plain {PART_K2_SHAPE} bias_segments (head size 16)",
                k2.set_attention_btc(q, k, v, H, km, bias, seg),
                attention_btc_reference(q, k, v, H, km, seg, bias), real)
    times = _time_packed(PART_K2_SHAPE, dev)["K2"]

    system = _system("CFM", PART, dev)
    mult = _jets(np.random.default_rng(9), 128, 2)
    launches, _ = drive("CFM + ParticleTransformer", system, mult, 10,
                        lambda l1, l2: ("did not run K2 as bias + segments and as bias"
                                        if not (l2["bias_segments"] and l2["bias"])
                                        else "launched K1" if _total(l1) else ""))
    profiling.take_counters()
    profiling.take_spans()
    profiling.record_spans(True)
    try:
        generate_packed(system, _pad_masks(mult[:-2], PART["max_num_particles"]),
                        num_timesteps=3, pack_width=128, batch_size=128, seed=1)
    finally:
        profiling.record_spans(False)
    spans = profiling.take_spans()
    c = profiling.take_counters()
    steps = sum(s.name == "solver.step" for s in spans)
    pair = sum(s.name == "part.pair_embed" for s in spans)
    k2_launches = _total(_group(c, "k2"))
    print(f"CFM + ParticleTransformer: {steps} solver steps, {pair} pair embeddings, "
          f"part.forwards {c['part.forwards']}, K2 launches {k2_launches}")
    if (not steps or not (pair == steps == c["part.forwards"])
            or k2_launches != PART["n_layer"] * steps):
        raise AssertionError("CFM + ParticleTransformer: a forward without its pair embedding "
                             "or without a K2 launch a block")
    # the pair embedding's share of a forward's device time, on one batch
    # of 128 packed rows of the drive's jets
    rows = _pad_masks(_multiplicities(np.random.default_rng(10), 420, 128), 128)
    row_of, offset_of, n_rows = pack_jets(rows[..., 0].sum(axis=1), 128)
    row_mask, row_seg = build_packed_rows(rows, row_of, offset_of, n_rows, 128)
    B = min(n_rows, 128)
    mask = torch.as_tensor(row_mask[:B], dtype=torch.int32, device=dev)
    state = MultiModal(time=torch.full((B,), 0.5, device=dev), mask=mask,
                       continuous=torch.randn((B, 128, 3), device=dev) * mask)
    seg = torch.as_tensor(row_seg[:B], device=dev)
    with torch.no_grad():
        forward_ms, pair_ms = median_device_ms([lambda: system.module(state, seg),
                                                lambda: system.module._pair_bias(state)])
    print(f"CFM + ParticleTransformer forward on {B} rows of 128: {forward_ms:.3f} ms, its pair "
          f"embedding {pair_ms:.3f} ms ({100 * pair_ms / forward_ms:.1f}%)")
    return {"max_abs_err": err, "k2_time": times, "launches": launches["K2"],
            "forward_ms": forward_ms, "pair_embed_ms": pair_ms}


def _pad_masks(mult, D):
    return (np.arange(D)[None, :] < np.asarray(mult)[:, None]).astype(np.int64)[..., None]


def _jets(rng, n, n_wide, D=150):
    """n AOJ-like jets plus n_wide jets of 135-150, wider than a packed row."""
    return np.concatenate([_multiplicities(rng, n, D), rng.integers(135, D + 1, size=n_wide)])


#: the groups of `_counts()` by their counters' prefix
COUNT_GROUPS = {"K1": "k1", "K2": "k2", "K1_bf16": "k1_bf16", "K2_bf16": "k2_bf16",
                "plain_dropout": "attn.plain_dropout"}


def _group(counters, prefix) -> dict:
    """The counters `prefix.<name>` of `counters` (`profiling.peek_counters()`
    or `take_counters()`) as {name: count}."""
    return {k[len(prefix) + 1:]: n for k, n in counters.items() if k.startswith(prefix + ".")}


def _counts():
    """The launch counts of both kernels by form, fp32 (K1, K2) and bf16
    (K1_bf16, K2_bf16), and the attention calls that took the plain version
    for dropout (`profiling.peek_counters()`)."""
    counters = profiling.peek_counters()
    return {group: _group(counters, prefix) for group, prefix in COUNT_GROUPS.items()}


def _total(counts) -> int:
    return sum(counts.values())


def _only(form, n) -> dict:
    """K2's counts when only `form` launched, n times."""
    return {f: n if f == form else 0 for f in _group(profiling.peek_counters(), "k2")}


def drive(name, system, mult, steps, expect, counters=("K1", "K2"), lund=False):
    """One serving path: counts set to 0, `generate_packed`, counts read.
    `expect(k1_launches, k2_launches)` (the `counters` of the system's
    dtype) returns what is wrong, or ''.  With `lund` (a KinFormer with its
    Lund bias) the run is traced, and every KinFormer forward of it
    (`lund.forwards`) must have run the pair MLP kernel (`lund_mlp.kernel`),
    none the plain version."""
    cfg = system.config
    pad_masks = _pad_masks(mult, cfg.max_num_particles)
    kw = dict(pack_width=128, batch_size=128, seed=0)
    generate_packed(system, pad_masks[-40:], num_timesteps=2, **kw)  # warm-up

    profiling.take_counters()
    profiling.record_spans(lund)
    try:
        res = generate_packed(system, pad_masks, num_timesteps=steps, **kw)
    finally:
        profiling.record_spans(False)
    launches = _counts()
    print(f"{name}: launches {launches}")
    wrong = expect(launches[counters[0]], launches[counters[1]])
    if wrong:
        raise AssertionError(f"{name}: {wrong}")
    if lund:
        profiling.take_spans()
        c = profiling.take_counters()
        forwards = c["lund.forwards"]
        routes = {"kernel": c["lund_mlp.kernel"], "plain": c["lund_mlp.plain"]}
        print(f"{name}: {forwards} KinFormer forwards, pair MLP routes {routes}")
        if not forwards or routes != {"kernel": forwards, "plain": 0}:
            raise AssertionError(f"{name}: {forwards} forwards, pair MLP routes {routes}")

    s = res.sample
    N, D = pad_masks.shape[:2]
    if s.continuous.shape != (N, D, cfg.dim_continuous) or s.discrete.shape != (N, D, 1):
        raise AssertionError(f"{name}: bad output shapes {s.continuous.shape} "
                             f"{s.discrete.shape}")
    pad = s.mask[..., 0] == 0
    checks = {
        "finite": bool(torch.isfinite(s.continuous).all()),
        "tokens in [0, V)": bool(((s.discrete >= 0) & (s.discrete < cfg.vocab_size)).all()),
        "pads zero": bool((s.continuous[pad] == 0).all() and (s.discrete[pad] == 0).all()),
        "mask kept": bool((s.mask.numpy() == pad_masks).all()),
    }
    print(f"{name}: checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"{name}: output failed {checks}")
    print(f"{name}: {N} jets ({int((mult > 128).sum())} wider than a row), {steps} steps, "
          f"wall {res.wall_time_s:.3f} s, {res.jets_per_sec:.2f} jets/s")
    return launches, res


def sampler_vs_cpu(name, system, cfg_kw, dev, steps=8, rows=8, atol=1e-4, tokens_equal=0.99,
                   width=128, packed=True):
    """The MMF sampler on the card and on the CPU (plain attention), same
    weights, source, segments and uniforms (continuous within `atol`, at
    least `tokens_equal` of the real sites' tokens equal), on packed rows
    of `width` or (`packed` False) on padded jets of up to `width`, one of
    them at the full width; returns the continuous error and the tokens'
    share."""
    cfg = system.config
    cpu_system = build_system(Config(**cfg_kw), system.name, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    if packed:
        mult = _multiplicities(rng, 4 * rows * width // 128, min(width, cfg.max_num_particles))
        row_of, offset_of, n_rows = pack_jets(mult, width)
        mask, seg = build_packed_rows(_pad_masks(mult, int(mult.max())), row_of, offset_of,
                                      n_rows, width)
        mask, seg = mask[:rows].astype(np.int32), seg[:rows]
        real = seg >= 0
    else:
        mult = np.concatenate([[width], rng.integers(width // 2, width + 1, size=rows - 1)])
        mask, seg = _pad_masks(mult, width).astype(np.int32), None
        real = mask[..., 0] > 0
    x0 = (rng.normal(size=(rows, width, 3)) * mask).astype(np.float32)
    k0 = (rng.integers(1, 9, size=(rows, width, 1)) * mask).astype(np.int32)
    us = rng.uniform(size=(steps, rows, width)).astype(np.float32)
    outs = []
    for sys_, d in ((system, dev), (cpu_system, torch.device("cpu"))):
        src = MultiModal(time=torch.full((rows,), cfg.time_eps), continuous=torch.from_numpy(x0),
                         discrete=torch.from_numpy(k0), mask=torch.from_numpy(mask)).to(d)
        segments = None if seg is None else torch.from_numpy(seg).to(d)
        outs.append(sys_.simulate(src, steps, segments=segments,
                                  uniforms=torch.from_numpy(us).to(d)).to("cpu"))
    real = torch.from_numpy(real)
    err = float((outs[0].continuous - outs[1].continuous).abs()[real].max())
    same = float((outs[0].discrete[..., 0] == outs[1].discrete[..., 0])[real].float().mean())
    layout = f"packed rows of {width}" if packed else f"padded jets of up to {width}"
    print(f"{name} sampler card vs CPU, {steps} steps x {rows} {layout}: continuous "
          f"max_abs_err {err:.3e} (atol {atol}), tokens equal on {same:.4f} of real sites "
          f"(>= {tokens_equal})")
    if err > atol or same < tokens_equal:
        raise AssertionError(f"{name}: the sampler on the card disagrees with the CPU sampler")
    return err, same


def _split_dataset(rng, mult, D=150):
    """(train, val) datasets, 90/10, of jets of the multiplicities `mult`:
    normal kinematics and tokens 1..8."""
    mask = _pad_masks(mult, D).astype(np.int32)
    x = (rng.normal(size=(len(mult), D, 3)) * mask).astype(np.float32)
    k = (rng.integers(1, 9, size=(len(mult), D, 1)) * mask).astype(np.int32)
    ds = ArrayDataset(DataCoupling(source=MultiModal(mask=mask),
                                   target=MultiModal(continuous=x, discrete=k, mask=mask)))
    return ds.split(0.9, seed=0)


def _train_data(rng, n=2048, n_wide=8, D=150):
    """n jets of AOJ-like multiplicity plus n_wide of 135-150."""
    return _split_dataset(rng, _jets(rng, n, n_wide, D), D)


def _first_batch(trainer, train_ds):
    """The first row batch of the packed unit (host arrays)."""
    return trainer._pack_units(train_ds)[0].coupling[np.arange(trainer._packed_row_bs)]


def _bridge_states(batch, time_eps, seed=3):
    """Per-jet times, the bridge state (host arrays of `MultiModal` fields)
    and the drift target of a packed batch, drawn from `seed`: what two
    sides share when their losses are compared."""
    rng = np.random.default_rng(seed)
    m = batch.mask
    t_jets = rng.uniform(time_eps, 1.0, batch.jet_valid.shape).astype(np.float32)
    states = dict(time=np.take_along_axis(t_jets, np.clip(batch.segments, 0, None), axis=1),
                  continuous=(rng.normal(size=m.shape[:2] + (3,)) * m).astype(np.float32),
                  discrete=(rng.integers(1, 9, size=m.shape) * m).astype(np.int32), mask=m)
    drift = (rng.normal(size=m.shape[:2] + (3,)) * m).astype(np.float32)
    return t_jets, states, drift


def train_card_vs_cpu(dev, train_ds, cfg_kw=TRAIN):
    """The flagship's packed training loss and every parameter gradient on
    the card and on the CPU (plain attention), same weights, one packed
    batch, shared bridge states; then one optimizer update (clip, Adam,
    EMA) from the card's gradients on both."""
    cfg = Config(**cfg_kw)
    sides = {side: (d, build_system(cfg, "MMF", device=d,
                                    generator=torch.Generator().manual_seed(0)))
             for side, d in (("card", dev), ("cpu", torch.device("cpu")))}
    batch = _first_batch(Trainer(sides["card"][1], cfg), train_ds)
    t_jets, states, drift = _bridge_states(batch, cfg.time_eps)
    loss, grads, launches = {}, {}, {}
    for side, (d, system) in sides.items():
        b = batch.to(d)
        state = MultiModal(**{f: torch.from_numpy(a) for f, a in states.items()}).to(d)
        profiling.take_counters()
        out = system.module.packed_training_loss(state, torch.from_numpy(drift).to(d),
                                                 b.discrete, torch.from_numpy(t_jets).to(d),
                                                 b.segments, b.jet_valid)
        out[0].backward()
        loss[side] = out[0].item()
        launches[side] = _counts()
        grads[side] = {n: p.grad.cpu() for n, p in system.module.named_parameters()}
        print(f"training loss on the {side}: {loss[side]:.7f} ({len(b)} rows x {b.width}, "
              f"{b.num_jets} jets; K1 launches {_total(launches[side]['K1'])})")
    rel = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
    worst = max(float(((grads["card"][n] - g).abs() / (TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL
                                                        * g.abs())).max())
                for n, g in grads["cpu"].items())
    print(f"training card vs CPU: loss rel err {rel:.3e} (<= {TRAIN_LOSS_RTOL}); "
          f"{len(grads['cpu'])} gradients, worst |diff| / (atol {TRAIN_GRAD_ATOL} + rtol "
          f"{TRAIN_GRAD_RTOL} |g|) = {worst:.3f} (<= 1)")
    if rel > TRAIN_LOSS_RTOL or worst > 1.0:
        raise AssertionError("the training loss or its gradients on the card disagree with "
                             "the CPU")

    after = {}
    for side, (d, system) in sides.items():
        trainer = Trainer(system, cfg)
        state = trainer.init_state(10)
        for n, p in system.module.named_parameters():
            p.grad = grads["card"][n].to(d)
        trainer._update(state)
        after[side] = [t.detach().cpu() for t in (*system.module.parameters(),
                                                  *state.ema.parameters())]
    err = max(float((a - b).abs().max()) for a, b in zip(after["card"], after["cpu"]))
    print(f"one update (clip, Adam, EMA) from the same gradients, card vs CPU: max_abs_err "
          f"{err:.3e} (atol {UPDATE_ATOL})")
    if err > UPDATE_ATOL:
        raise AssertionError("the optimizer update on the card disagrees with the CPU")
    return launches["card"]


def fit_fixed_batch(dev, train_ds, steps=30, name="flagship", kind="MMF", cfg_kw=TRAIN):
    """`steps` train steps on one packed batch with the same draws (the
    generator reseeded) every step: the loss must fall below where it
    started (the mean of the last steps against the first loss, so that a
    jump after the first update cannot pass for learning).  Returns the
    trainer, its state and the launch counts of the steps."""
    cfg = Config(**cfg_kw)
    system = build_system(cfg, kind, device=dev, generator=torch.Generator().manual_seed(1))
    trainer = Trainer(system, cfg)
    state = trainer.init_state(steps)
    batch = _first_batch(trainer, train_ds).to(dev)
    gen = torch.Generator(device=dev)
    system.module.train()
    losses = []
    profiling.take_counters()
    for _ in range(steps):
        gen.manual_seed(0)
        losses.append(trainer._train_step(state, batch, gen)["loss"])
    losses = torch.stack(losses).cpu().numpy()
    launches = _counts()
    system.module.eval()
    k = min(5, steps // 2)
    if steps <= 20:
        print(f"{name}, fixed batch: losses {np.round(losses, 5).tolist()}")
    print(f"{name}, fixed batch, {steps} steps: loss {losses[0]:.5f} -> {losses[-1]:.5f} "
          f"(last {k} mean {losses[-k:].mean():.5f}, highest {losses.max():.5f}); "
          f"launches {launches}")
    if not (np.isfinite(losses).all() and losses[-k:].mean() < losses[0]):
        raise AssertionError(f"{name}: the loss on a fixed batch did not fall")
    return trainer, state, launches


def train_flagship(dev, train_ds, val_ds, out_dir):
    """The training main path: `Trainer.fit` of the flagship, the launch
    counters set to 0 just before and read just after."""
    cfg = Config(**TRAIN, dir=out_dir, experiment_id="flagship")
    system = build_system(cfg, "MMF", device=dev, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(system, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiling.take_counters()
    t0 = time.perf_counter()
    state = trainer.fit(train_ds, val_ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"flagship training: launches {launches}")
    if not launches["K1"]["segments"] or sum(launches["K2"].values()):
        raise AssertionError("flagship training: K1 did not run in its segment form, or K2 ran")

    exp = os.path.join(out_dir, cfg.project, "flagship")
    records = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    losses = [r[k] for r in records for k in r if "loss" in k]
    slots = set(os.listdir(os.path.join(exp, "checkpoints")))
    fresh = build_system(cfg, "MMF", device=dev)
    fresh.module.load_state_dict(trainer.load_for_inference("last"))
    reloaded = trainer.evaluate(val_ds, fresh.module, epoch=cfg.max_epochs - 1)["val_loss"]
    logged = records[-1]["val_loss"]
    checks = {
        f"{len(records)} epochs logged": len(records) == cfg.max_epochs,
        "every logged loss finite": bool(np.isfinite(losses).all()),
        "last and best written": {"last.pt", "best.pt"} <= slots,
        "last reloaded gives the logged val_loss (rel 1e-5)":
            abs(reloaded - logged) <= 1e-5 * abs(logged),
    }
    for r in records:
        print(f"  epoch {r['epoch']:.0f}: train_loss {r['train_loss']:.5f} val_loss "
              f"{r['val_loss']:.5f} lr {r['lr']:.3e} ({r['epoch_time_s']:.2f} s)")
    print(f"flagship training: {state.step} steps in {wall:.2f} s ({cfg.max_epochs} epochs, "
          f"validation and checkpoints included); val_loss logged {logged:.7f}, reloaded "
          f"{reloaded:.7f}; peak max_memory_allocated {peak / 2**20:.1f} MiB; checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"flagship training failed {checks}")
    return launches, trainer, state, peak


def _share(part: float, whole: float) -> float:
    return part / whole if whole else float("nan")


def time_training(dev, trainer, state, train_ds, n=20, n_prof=5, label="flagship",
                  kernel="K1", backward_node="BtcAttentionBackward"):
    """Wall time of a train step (ending in a synchronize) and jets/s; then
    `torch.profiler` over `n_prof` steps (`utils/profiling.py`): the
    kernels' device time split into forward (launched inside the loss),
    optimizer (inside the update) and backward (the rest: the autograd
    engine launches it from its own thread), the device's busy share of the
    wall, the kernels that take the most time, and the attention kernel's
    forward and its backward nodes (`backward_node`, the recompute through
    the plain version).  A step launches more kernels than the stream's
    queue holds, so holding the stream while the host enqueues (as
    `median_device_ms` does) cannot time it.  Packed training times its
    packed rows (a row holds several jets), other training its batches of
    `batch_size` jets."""
    cfg = trainer.config
    if cfg.packed_training:
        unit, rows, width = trainer._pack_units(train_ds)[0], trainer._packed_row_bs, cfg.pack_width
    else:
        unit, rows = train_ds, cfg.batch_size
        width = unit.coupling.target.discrete.shape[1]
    idx = trainer._epoch_perm(len(unit), rows, shuffle=True, seed=1, epoch=0)
    batches = list(trainer._batches(trainer._resident(unit), idx))
    jets = ([int(unit.coupling.jet_valid[i].sum()) for i in idx] if cfg.packed_training
            else [rows] * len(idx))
    gen = torch.Generator(device=dev).manual_seed(2)
    state.module.train()
    for b in batches[:3]:  # warm-up
        trainer._train_step(state, b, gen)
    torch.cuda.synchronize()
    walls, step_jets = [], []
    for i in range(n):
        j = i % len(batches)
        t0 = time.perf_counter()
        trainer._train_step(state, batches[j], gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        step_jets.append(jets[j])
    wall_ms = float(np.median(walls)) * 1e3
    jets_per_s = sum(step_jets) / sum(walls)

    prof = profiling.profile_steps(
        lambda i: trainer._train_step(state, batches[i % len(batches)], gen), n_prof)
    state.module.eval()
    split, total_ms, launches = prof.phases, prof.device_ms, prof.launches
    print(f"train step ({label}, {rows} rows x {width}, ~{np.mean(jets):.1f} jets): median wall "
          f"{wall_ms:.3f} ms over {n} steps (each synchronized), {jets_per_s:.1f} trained "
          f"jets/s")
    print(f"train step kernel time (torch.profiler, {n_prof} steps): forward "
          f"{split['forward']:.3f} ms, backward {split['backward']:.3f} ms, optimizer "
          f"{split['optimizer']:.3f} ms, total {total_ms:.3f} ms; device busy share "
          f"{_share(total_ms, wall_ms):.3f} of the unprofiled wall ({_share(total_ms, prof.wall_ms):.3f} of "
          f"the profiled wall, {prof.wall_ms:.3f} ms a step); {launches:.0f} cudaLaunchKernel "
          f"a step"
          + ("" if total_ms else " (the profiler shows no device time)"))
    for name, ms, count in prof.kernels[:15]:
        print(f"  {ms:8.3f} ms/step {_share(ms, total_ms):6.3f}  {count:6.1f}/step  {name[:100]}")
    # in the profiled steps: the attention kernel's own time, and the device
    # time of the autograd nodes of its backward
    attn_fwd_ms = prof.kernel_ms("attention_kernel")
    n_nodes, attn_bwd_ms = prof.nodes(backward_node)
    print(f"attention in the profiled steps: {kernel} kernels {attn_fwd_ms:.3f} ms a step "
          f"({_share(attn_fwd_ms, split['forward']):.3f} of the forward); {n_nodes:.0f} "
          f"backward nodes a step, {attn_bwd_ms:.3f} ms ({_share(attn_bwd_ms, split['backward']):.3f} "
          f"of the backward)")
    return dict(config=label, wall_ms=wall_ms, jets_per_s=jets_per_s, device_ms=total_ms,
                busy_share=_share(total_ms, wall_ms), launches_per_step=launches, **split,
                attention_forward_ms=attn_fwd_ms, attention_backward_ms=attn_bwd_ms,
                collective_ms=prof.kernel_ms("nccl"), memcpy_ms=prof.kernel_ms("Memcpy"),
                memcpy_per_step=sum(c for name, _, c in prof.kernels if "Memcpy" in name))


#: graph against eager steps: the worst leaf's gap, against the larger of its
#: norm and the median leaf's (`_leaf_gap`); the eager route itself moves
#: from run to run (the per-jet sums' atomics, the last bits of a backward),
#: and under Adam the rows that move by round-off alone (a key's bias
#: under softmax) move as far as lr: the weights are compared on the rows
#: that the gradient moves (`bench_torch.drivers.common.moved_rows` of
#: Adam's first moment), as the benchmark's `change_leaf_gap` is
GRAPH_STEPS, GRAPH_RTOL = 6, 1e-6


def _leaf_gap(a: dict, b: dict, rows: Optional[dict] = None) -> float:
    """max over the leaves n of ||a_n - b_n|| / max(||b_n||, the median
    leaf's ||b||), each leaf cut to its `rows[n]` where given."""
    if rows is not None:
        a = {n: a[n][r] for n, r in rows.items()}
        b = {n: b[n][r] for n, r in rows.items()}
    norms = {n: float(t.double().norm()) for n, t in b.items()}
    med = float(np.median(list(norms.values())))
    return max(float((a[n].double() - t.double()).norm()) / max(v, med, 1e-30)
               for (n, t), v in zip(b.items(), norms.values()))


def _state_leaves(state) -> dict:
    """Host copies of a train state's weights, Adam's moments and EMA
    weights: {kind: {name: tensor}}."""
    opt = state.optimizer
    named = list(state.module.named_parameters())
    out = {"weights": {n: p.detach().cpu() for n, p in named},
           "exp_avg": {n: opt.state[p]["exp_avg"].cpu() for n, p in named},
           "exp_avg_sq": {n: opt.state[p]["exp_avg_sq"].cpu() for n, p in named}}
    if state.ema is not None:
        out["ema"] = {n: p.detach().cpu() for n, p in state.ema.named_parameters()}
    return out


def _state_gaps(a: dict, b: dict) -> dict:
    """`_leaf_gap` of each kind of `_state_leaves`: the weights and the EMA
    weights on the rows that `b`'s first moment moves."""
    rows = moved_rows(b["exp_avg"])
    return {kind: _leaf_gap(a[kind], b[kind], rows if kind in ("weights", "ema") else None)
            for kind in b}


def _graph_counters() -> dict:
    return _group(profiling.peek_counters(), "train_graph")


def _graph_vs_eager(name, dev, kind, cfg, batches) -> dict:
    """`len(batches)` steps from one state and one seed through
    `Trainer._train_step` (the graph: the first step eager, the second
    captured, the rest replayed under the sync-debug mode "error") and
    through `_eager_step`: their losses, weights, Adam's moments and EMA
    weights, the graph counters and the kernels' launches."""
    sides = {}
    for route in ("graph", "eager"):
        system = build_system(cfg, kind, device=dev, generator=torch.Generator().manual_seed(0))
        trainer = Trainer(system, cfg)
        meshed = trainer.mesh is not None
        state = trainer.init_state(len(batches))
        gen = torch.Generator(device=dev).manual_seed(0)
        system.module.train()
        torch.cuda.synchronize()
        profiling.take_counters()
        losses = []
        for i, b in enumerate(batches):
            if route == "eager":
                losses.append(trainer._eager_step(state, b, gen)["loss"])
                continue
            torch.cuda.set_sync_debug_mode("error" if i >= 2 else "default")
            try:
                losses.append(trainer._train_step(state, b, gen)["loss"])
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        sides[route] = dict(losses=torch.stack(losses).cpu(), leaves=_state_leaves(state),
                            counters=_graph_counters(), keys=len(state.graphs),
                            launches=_counts(), meshed=meshed)
        system.module.eval()
        del trainer, state, system
    g, e = sides["graph"], sides["eager"]
    loss_gap = float(((g["losses"] - e["losses"]).abs() / e["losses"].abs()).max())
    gaps = _state_gaps(g["leaves"], e["leaves"])
    n = len(batches)
    if n != GRAPH_STEPS:
        raise AssertionError(f"{name}: {n} batches, not {GRAPH_STEPS}")
    want = {"captures": 1, "replays": n - 1, "eager_steps": 1}
    print(f"{name}, {n} steps captured and replayed against eager: losses "
          f"{np.round(g['losses'].numpy(), 6).tolist()}, worst loss rel gap {loss_gap:.3e}; "
          f"leaf gaps {({k: f'{v:.3e}' for k, v in gaps.items()})} (<= {GRAPH_RTOL}); "
          f"counters {g['counters']}; launches equal {g['launches'] == e['launches']}")
    if not (loss_gap <= GRAPH_RTOL and max(gaps.values()) <= GRAPH_RTOL
            and g["counters"] == want and g["keys"] == 1 and g["launches"] == e["launches"]):
        raise AssertionError(f"{name}: the graph's steps differ from the eager steps, or it did "
                             f"not capture once and replay {n - 1} times ({want})")
    return dict(loss_rel_gap=loss_gap, leaf_gaps=gaps, counters=g["counters"],
                meshed=g["meshed"] and e["meshed"])


def _graph_batches(dev, train_ds) -> list:
    """GRAPH_STEPS packed batches of the flagship's training, on the card,
    no two successive ones with the same segment ids."""
    cfg = Config(**TRAIN)
    trainer = Trainer(build_system(cfg, "MMF", device=dev), cfg, mesh=None)
    unit = trainer._pack_units(train_ds)[0]
    idx = trainer._epoch_perm(len(unit), trainer._packed_row_bs, shuffle=True, seed=0,
                              epoch=0)[:GRAPH_STEPS]
    batches = list(trainer._batches(trainer._resident(unit), idx))
    if any(torch.equal(a.segments, b.segments) for a, b in zip(batches, batches[1:])):
        raise AssertionError("train graph check: two successive batches share segment ids")
    return batches


def mesh_graph_check(dev, train_ds) -> dict:
    """The captured step on a data mesh: a NCCL group of one rank on the
    card, whose data mesh still all-reduces the gradients every step
    (`Trainer._average_gradients`), so each replay makes it between the
    step's two graphs.
    The flagship MMF's graph against its eager steps (`_graph_vs_eager`:
    one capture, a replay every later step, no eager step past the first),
    both on the mesh."""
    torch.distributed.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                                         rank=0, world_size=1, device_id=dev)
    try:
        out = _graph_vs_eager("flagship MMF, data mesh of one NCCL rank", dev, "MMF",
                              Config(**TRAIN), _graph_batches(dev, train_ds))
    finally:
        torch.distributed.destroy_process_group()
    if not out["meshed"]:
        raise AssertionError("mesh graph check: the trainers did not take the data mesh")
    return out


def train_graph_check(dev, train_ds, val_ds, out_dir) -> dict:
    """The train step as one CUDA graph (`Trainer._graph_step`).  The
    flagship MMF on GRAPH_STEPS packed batches of different rows (so
    different segment ids under one graph) and GPT on as many batches of
    sequences: graph against eager (`_graph_vs_eager`).  A bucketed fit
    of 2 epochs: one key and one capture a width, every other step a
    replay.  A 2-epoch fit against the same fit resumed from its epoch-1
    checkpoint (saved after replayed steps): the same weights, moments
    and EMA."""
    out = {"mmf": _graph_vs_eager("flagship MMF", dev, "MMF", Config(**TRAIN),
                                  _graph_batches(dev, train_ds))}

    gpt_cfg, _ = train_mmf.experiment_configs(GPT_ARGV + ["--dir", out_dir])
    rng = np.random.default_rng(17)
    x, tok, mask = _physical_jets(rng, _jets(rng, 2 * GPT_JETS, 4))
    gpt_ds, _ = train_mmf.split_jets(MultiModal(continuous=x, discrete=tok, mask=mask),
                                     gpt_cfg, "GPT")
    trainer = Trainer(build_system(gpt_cfg, "GPT", device=dev), gpt_cfg)
    idx = trainer._epoch_perm(len(gpt_ds), gpt_cfg.batch_size, shuffle=True, seed=0,
                              epoch=0)[:GRAPH_STEPS]
    batches = list(trainer._batches(trainer._resident(gpt_ds), idx))
    del trainer
    out["gpt"] = _graph_vs_eager("GPT", dev, "GPT", gpt_cfg, batches)

    # a bucketed fit: a graph a width
    cfg = Config(**dict(TRAIN_BUCKETED, max_epochs=2), dir=out_dir,
                 experiment_id="graph_buckets")
    b_train, b_val = _bucket_data(np.random.default_rng(6))
    trainer = Trainer(build_system(cfg, "MMF", device=dev,
                                   generator=torch.Generator().manual_seed(0)), cfg)
    widths = [w for w, _, _ in trainer._bucketize(b_train, min_size=cfg.batch_size)]
    profiling.take_counters()
    state = trainer.fit(b_train, b_val)
    counters = _graph_counters()
    keyed = sorted({name: shape for name, shape, _ in key[3]}[".target.mask"][1]
                   for key in state.graphs)
    print(f"bucketed fit, 2 epochs, {state.step} steps: graph keys at widths {keyed} (bucket "
          f"widths {widths}); counters {counters}")
    if not (keyed == sorted(widths) and counters["captures"] == len(widths)
            and counters["eager_steps"] == len(widths)
            and counters["replays"] == state.step - len(widths)):
        raise AssertionError("bucketed fit: not one graph and one capture a width")
    out["bucketed"] = dict(widths=keyed, steps=state.step, counters=counters)
    del trainer, state

    # resumed from the checkpoint of epoch 1 against the uninterrupted fit
    states = []
    for exp, ckpt in (("graph_full", None),
                      ("graph_resumed", os.path.join(out_dir, cfg.project, "graph_full",
                                                     "checkpoints", "best-ep1.pt"))):
        cfg = Config(**TRAIN, dir=out_dir, experiment_id=exp, ckpt_path=ckpt)
        system = build_system(cfg, "MMF", device=dev, generator=torch.Generator().manual_seed(0))
        profiling.take_counters()
        state = Trainer(system, cfg).fit(train_ds, val_ds)
        states.append((state.step, _state_leaves(state), _graph_counters()))
        del system, state
    (full_steps, full, full_counters), (resumed_steps, resumed, resumed_counters) = states
    gaps = _state_gaps(resumed, full)
    print(f"resumed from the epoch-1 checkpoint: {resumed_steps} steps against {full_steps} "
          f"(counters {resumed_counters} against {full_counters}); leaf gaps "
          f"{({k: f'{v:.3e}' for k, v in gaps.items()})} (<= {GRAPH_RTOL})")
    if not (resumed_steps == full_steps and max(gaps.values()) <= GRAPH_RTOL
            and full_counters["replays"] and resumed_counters["captures"] == 1):
        raise AssertionError("a fit resumed from a checkpoint taken after replayed steps does "
                             "not equal the run it was taken from")
    out["resume_leaf_gaps"] = gaps
    return out


def train_coocc(dev, train_ds, steps=5, cfg_kw=TRAIN_COOCC, k2_counter="K2"):
    """5 train steps of the co-occurrence MMF: K2 in its bias + segments
    form, forward and (through the plain version) backward with the bias's
    gradient; K1 never.  `k2_counter` names K2's counter of the config's
    dtype ("K2_bf16" for a bf16 config); no other counter may move."""
    cfg = Config(**cfg_kw)
    system = build_system(cfg, "MMF", device=dev, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(system, cfg)
    state = trainer.init_state(steps)
    unit = trainer._pack_units(train_ds)[0]
    idx = trainer._epoch_perm(len(unit), trainer._packed_row_bs, shuffle=True, seed=0,
                              epoch=0)[:steps]
    gen = torch.Generator(device=dev).manual_seed(0)
    system.module.train()
    profiling.take_counters()
    metrics = [trainer._train_step(state, b, gen)
               for b in trainer._batches(trainer._resident(unit), idx)]
    torch.cuda.synchronize()
    launches = _counts()
    losses = torch.stack([m["loss"] for m in metrics]).cpu().numpy()
    wue = system.module.encoder.coocc.wue.weight
    print(f"co-occurrence training ({cfg.compute_dtype}), {steps} steps: losses "
          f"{np.round(losses, 5).tolist()}; launches {launches}")
    others = sum(_total(c) for name, c in launches.items()
                 if name not in (k2_counter, "plain_dropout"))
    if not (len(losses) == steps and np.isfinite(losses).all()
            and launches[k2_counter]["bias_segments"] and not others):
        raise AssertionError("co-occurrence training: a loss is not finite, K2 did not run "
                             "as bias + segments, or K1 ran")
    if wue.grad is None or not torch.isfinite(wue.grad).all() or not wue.grad.abs().sum():
        raise AssertionError("co-occurrence training: no gradient reached the bias table")
    return launches


def drive_fused(dev, mult, steps):
    """`generate_packed` of MMF + FusedParticleFormer: 5 blocks, so K1 runs
    5 times a forward, in its segment form on each batch of packed rows and
    in its key-mask form on the one bucketed batch of wide jets."""
    system = _system("MMF", FUSED, dev)
    n_layer = system.config.n_layer
    row_of, _, n_rows = pack_jets(mult, 128)
    want = {"segments": n_layer * steps * -(-n_rows // 128),        # batches of <= 128 rows
            "key_mask": n_layer * steps * (1 if (row_of < 0).any() else 0), "none": 0}
    launches, _ = drive(
        "FusedParticleFormer MMF", system, mult, steps,
        lambda l1, l2: (f"K1 launches {l1}, expected {want}" if l1 != want
                        else "launched K2" if _total(l2) else ""))
    sampler_vs_cpu("FusedParticleFormer MMF", system, FUSED, dev)
    return launches


def train_physics_eval(dev, train_ds, val_ds, out_dir):
    """`Trainer.fit` of the flagship with the physics eval after every
    epoch: the W1 scores logged and finite, `best_physics.pt` written,
    every eval on the same generation seed.  The trainer swallows a failed
    eval; the checks here fail the run instead."""
    cfg = Config(**TRAIN_PHYSICS, dir=out_dir, experiment_id="physics")
    system = build_system(cfg, "MMF", device=dev, generator=torch.Generator().manual_seed(0))
    evals = []
    real = physics_eval.physics_metrics

    def recorded(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        evals.append((kw["seed"], time.perf_counter() - t0))
        return out

    physics_eval.physics_metrics = recorded
    try:
        profiling.take_counters()
        Trainer(system, cfg).fit(train_ds, val_ds)
        launches = _counts()
    finally:
        physics_eval.physics_metrics = real
    exp = os.path.join(out_dir, cfg.project, "physics")
    records = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    names = ("val_w1_pt", "val_w1_mass", "val_w1_mult", "val_w1_physics")
    checks = {
        "an eval every epoch": len(evals) == cfg.max_epochs == len(records),
        "one generation seed": len({seed for seed, _ in evals}) == 1,
        "val_w1_* logged and finite": all(np.isfinite(r.get(n, np.nan)) for r in records
                                          for n in names),
        "best_physics written": os.path.exists(os.path.join(exp, "checkpoints",
                                                            "best_physics.pt")),
        "K1 ran (packed rows), K2 never": bool(launches["K1"]["segments"]
                                               and not _total(launches["K2"])),
    }
    for r in records:
        print(f"  epoch {r['epoch']:.0f}: val_loss {r['val_loss']:.5f} "
              + " ".join(f"{n} {r.get(n, float('nan')):.4f}" for n in names))
    n_jets = min(cfg.physics_eval_num_jets, len(val_ds))
    seconds = [t for _, t in evals]
    print(f"physics eval in Trainer.fit: {len(evals)} evals of {n_jets} jets at "
          f"{cfg.physics_eval_num_timesteps} steps, {np.round(seconds, 3).tolist()} s each, "
          f"seeds {[seed for seed, _ in evals]}; launches {launches}; checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"physics eval failed {checks}")
    return launches, dict(jets=n_jets, steps=cfg.physics_eval_num_timesteps, seconds=seconds)


def train_dropout(dev, train_ds, steps=3):
    """Flagship steps with dropout 0.1.  In train mode every attention call
    takes the plain version (16 a forward) and neither kernel is launched;
    in eval mode the same module launches K1 again and its loss does not
    depend on the dropout draws."""
    cfg = Config(**TRAIN_DROPOUT)
    system = build_system(cfg, "MMF", device=dev, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(system, cfg)
    state = trainer.init_state(steps)
    unit = trainer._pack_units(train_ds)[0]
    idx = trainer._epoch_perm(len(unit), trainer._packed_row_bs, shuffle=True, seed=0,
                              epoch=0)[:steps]
    batches = list(trainer._batches(trainer._resident(unit), idx))
    gen = torch.Generator(device=dev).manual_seed(0)
    system.module.train()
    profiling.take_counters()
    losses = torch.stack([trainer._train_step(state, b, gen)["loss"] for b in batches])
    torch.cuda.synchronize()
    train_counts = _counts()
    system.module.eval()
    profiling.take_counters()
    with torch.no_grad():
        held = [system.loss_fn(batches[0], gen.manual_seed(3), train=False)[0].item()
                for _ in range(2)]
    eval_counts = _counts()
    losses = losses.cpu().numpy()
    steps = len(batches)
    print(f"dropout 0.1, {steps} train steps: losses {np.round(losses, 5).tolist()}; launches "
          f"{train_counts}; eval mode, 2 forwards: losses {held}; launches {eval_counts}")
    blocks = 2 * cfg.n_layer + cfg.n_layer_fused
    if not (np.isfinite(losses).all() and not _total(train_counts["K1"])
            and not _total(train_counts["K2"])
            and train_counts["plain_dropout"]["token_major"] == blocks * steps):
        raise AssertionError("dropout training: a loss is not finite, a kernel ran, or the "
                             f"plain attention did not run {blocks} times a forward")
    if not (held[0] == held[1] and eval_counts["K1"]["segments"] == 2 * blocks
            and not _total(eval_counts["plain_dropout"])):
        raise AssertionError("dropout model in eval mode: the loss moved with the dropout "
                             "draws, K1 did not run, or the plain dropout path ran")
    return trainer, state, train_counts


def time_dropout_attention(dev, rows=84, rate=0.1):
    """Device time of one attention call of a dropout train step's forward
    at the step's shapes: the plain version with dropout, the plain
    version without, and K1 (which a dropout-free step runs)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    with torch.no_grad():
        for C in (128, 256):
            q, k, v, _, seg, _, _ = _case_inputs((rows, 128, C, 4), "segments", dev)
            times = median_device_ms([
                lambda: attention_btc_reference(q, k, v, 4, None, seg, None, rate, gen),
                lambda: attention_btc_reference(q, k, v, 4, None, seg),
                lambda: k1.btc_attention(q, k, v, 4, None, seg)], n=20)
            out[C] = dict(zip(("plain_dropout_ms", "plain_ms", "k1_ms"), times))
            print(f"attention of a dropout step, ({rows}, 128, {C}, 4) segments: plain with "
                  f"dropout {times[0]:.4f} ms, plain {times[1]:.4f} ms, K1 {times[2]:.4f} ms "
                  f"(median of 20, CUDA events, device time)")
    forward = {name: 10 * out[128][name] + 6 * out[256][name] for name in out[128]}
    print(f"attention of a flagship forward (10 calls at C=128, 6 at C=256): "
          + ", ".join(f"{name} {ms:.3f}" for name, ms in forward.items()))
    return forward


def _bucket_data(rng, D=150):
    """(train, val) with jets for every bucket width: 1,024 of AOJ-like
    multiplicity, 160 of 65-128 and 112 of 129-150."""
    return _split_dataset(rng, np.concatenate([
        _multiplicities(rng, 1024, D), rng.integers(65, 129, size=160),
        rng.integers(129, D + 1, size=112)]), D)


def train_bucketed(dev, out_dir):
    """One bucketed epoch of the flagship: a unit a bucket, each at its own
    width, so K1 runs in its key-mask form at every width.  The widths K1
    is launched at are read from the wrapper's calls."""
    cfg = Config(**TRAIN_BUCKETED, dir=out_dir, experiment_id="bucketed")
    train_ds, val_ds = _bucket_data(np.random.default_rng(6))
    system = build_system(cfg, "MMF", device=dev, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(system, cfg)
    buckets = [(w, len(b)) for w, b, _ in trainer._bucketize(train_ds, min_size=cfg.batch_size)]
    widths = set()
    launch = k1.btc_attention

    def spied(q, *args, **kw):
        widths.add(int(q.shape[1]))
        return launch(q, *args, **kw)

    k1.btc_attention = spied
    try:
        profiling.take_counters()
        state = trainer.fit(train_ds, val_ds)
        torch.cuda.synchronize()
        launches = _counts()
    finally:
        k1.btc_attention = launch
    exp = os.path.join(out_dir, cfg.project, "bucketed")
    record = json.loads(open(os.path.join(exp, "metrics.jsonl")).readline())
    print(f"bucketed training: buckets (width, jets) {buckets}, {state.step} steps; K1 ran at "
          f"widths {sorted(widths)}; train_loss {record['train_loss']:.5f} val_loss "
          f"{record['val_loss']:.5f}; launches {launches}")
    want = {w for w, _ in buckets}
    if not (want == {48, 64, 128, 150} == widths and launches["K1"]["key_mask"]
            and launches["K1"]["key_mask"] == _total(launches["K1"])
            and not _total(launches["K2"])
            and np.isfinite([record["train_loss"], record["val_loss"]]).all()):
        raise AssertionError("bucketed training: not all four widths trained, K1 did not run "
                             "in its key-mask form at each, or a loss is not finite")
    return launches


def _packed_case(rng, n_jets, W=128):
    """`n_jets` jets packed into rows of W with per-jet noise, as packed
    rows and as one jet a row: (mult, row_of, offset_of, rows, jets), each
    of the last two a dict of numpy arrays (continuous, discrete, mask;
    rows with segments)."""
    mult = _multiplicities(rng, n_jets, W)
    row_of, offset_of, n_rows = pack_jets(mult, W)
    pad = _pad_masks(mult, W).astype(np.int32)
    row_mask, seg = build_packed_rows(pad, row_of, offset_of, n_rows, W)
    x = (rng.normal(size=(n_jets, W, 3)) * pad).astype(np.float32)
    k = (rng.integers(1, 9, size=(n_jets, W, 1)) * pad).astype(np.int32)
    rx, rk = np.zeros((n_rows, W, 3), np.float32), np.zeros((n_rows, W, 1), np.int32)
    for j, m in enumerate(mult):
        r, o = row_of[j], offset_of[j]
        rx[r, o:o + m], rk[r, o:o + m] = x[j, :m], k[j, :m]
    rows = dict(continuous=rx, discrete=rk, mask=row_mask.astype(np.int32), segments=seg)
    return mult, row_of, offset_of, rows, dict(continuous=x, discrete=k, mask=pad)


def _source(arrays, time_eps, d):
    n = len(arrays["mask"])
    return MultiModal(time=torch.full((n,), time_eps),
                      **{f: torch.from_numpy(arrays[f])
                         for f in ("continuous", "discrete", "mask")}).to(d)


def epic_checks(dev, system, steps=10):
    """CFM + EPiC on shared noise: packed rows (per-jet pooling through the
    segment ids) against one jet a row (per-row pooling) on the card, per
    jet; then the packed rows on the card against the CPU."""
    cfg = system.config
    mult, row_of, offset_of, rows, jets = _packed_case(np.random.default_rng(7), 48)
    seg = torch.from_numpy(rows["segments"])
    J = int(rows["segments"].max()) + 1
    packed = system.simulate(_source(rows, cfg.time_eps, dev), steps, segments=seg.to(dev),
                             num_segments=J).continuous.cpu()
    alone = system.simulate(_source(jets, cfg.time_eps, dev), steps).continuous.cpu()
    err = max(float((packed[row_of[j], offset_of[j]:offset_of[j] + m] - alone[j, :m]).abs().max())
              for j, m in enumerate(mult))
    cpu_system = build_system(Config(**EPIC), "CFM", device="cpu",
                              generator=torch.Generator().manual_seed(0))
    on_cpu = cpu_system.simulate(_source(rows, cfg.time_eps, "cpu"), steps, segments=seg,
                                 num_segments=J).continuous
    real = seg >= 0
    cpu_err = float((packed - on_cpu).abs()[real].max())
    print(f"CFM + EPiC, {steps} steps, {len(mult)} jets in {len(seg)} packed rows (up to {J} a "
          f"row): packed vs one jet a row max_abs_err {err:.3e} (atol 1e-4); card vs CPU "
          f"max_abs_err {cpu_err:.3e} (atol 1e-4)")
    if not (err <= 1e-4 and cpu_err <= 1e-4 and torch.isfinite(packed[real]).all()):
        raise AssertionError("CFM + EPiC: packed rows disagree with one jet a row, or the card "
                             "with the CPU")


# the new solver modes: (name, system, config, simulate arguments, the
# noise argument's name, the trailing dims of one step's noise after
# (rows, 128), whether a sigmoid thermostat replaces the constant one)
PAIRWISE_FLAVOR = dict(CLI, model="FlavorFormer", use_pairwise=True)
MODES = [
    ("hybrid euler + class_freqs", "MMF",
     dict(FLAGSHIP, hybrid_solver="euler", class_freqs=list(REFERENCE_CLASS_FREQS)),
     dict(temperature=0.9), "uniforms", (), False),
    ("hybrid tauleap, top_k=3 top_p=0.9", "MMF", FLAGSHIP, dict(top_k=3, top_p=0.9),
     "uniforms", (), False),
    ("hybrid tauleap, sigmoid thermostat", "MMF", FLAGSHIP, {}, "uniforms", (), True),
    ("CFM euler_maruyama", "CFM", dict(CLI, model="KinFormer"), dict(method="euler_maruyama"),
     "normals", (3,), False),
    ("MJB tauleap-bernouilli", "MJB",
     dict(PAIRWISE_FLAVOR, markov_jump_solver="tauleap-bernouilli"), {}, "uniforms", (9,), False),
    ("MJB euler", "MJB", dict(PAIRWISE_FLAVOR, markov_jump_solver="euler"), {}, "uniforms", (),
     False),
    ("MJB jump_or_stay", "MJB", dict(PAIRWISE_FLAVOR, markov_jump_solver="jump_or_stay"), {},
     "uniforms", (2,), False),
]


# a step's jump probabilities min(rates * dt, 1), card vs CPU.  Every
# method draws from them; the rates themselves grow without bound as
# t -> 1 (w_t / (1 - w_t) cancels in fp32 there) and have no tolerance
JUMP_PROB_ATOL = 1e-4


def _record_rates(system, into):
    """Have the system's token bridge append every step's rates (on the
    host) to `into`."""
    bridge = system.bridge_discrete
    rate = bridge.rate

    def recorded(t, k, probs):
        out = rate(t, k, probs)
        into.append(out.cpu())
        return out

    bridge.rate = recorded


def modes_vs_cpu(dev, steps=8, n_jets=256):
    """Each new solver mode for `steps` steps on a packed batch of `n_jets`
    jets (the smoke's 84-88 rows of 128), on the card (the kernels) and on
    the CPU (plain attention), from the same weights, source and injected
    noise: the final state, and for the modes with tokens the jump
    probabilities of every step.  The first step's come from identical
    inputs and must agree at every real site (on 0.999 of them under
    top-k / top-p, which drop a class whose probability lies within
    rounding of the threshold on one side only); a later step's may
    differ in the jets where a token fell on the other side of a
    threshold."""
    _, _, _, packed, _ = _packed_case(np.random.default_rng(8), n_jets)
    rows = len(packed["mask"])
    seg = torch.from_numpy(packed["segments"])
    real = seg >= 0
    rng = np.random.default_rng(9)
    for name, kind, cfg_kw, sim_kw, noise_name, tail, sigmoid in MODES:
        shape = (steps, rows, 128) + tail
        noise = (rng.normal(size=shape) if noise_name == "normals"
                 else rng.uniform(size=shape)).astype(np.float32)
        outs, rates = [], []
        profiling.take_counters()
        for d in (dev, torch.device("cpu")):
            system = _system(kind, cfg_kw, d)
            if sigmoid:
                cfg = system.config
                system.bridge_discrete = RandomTelegraphBridge(
                    cfg.beta, cfg.vocab_size, SigmoidThermostat(cfg.beta, cfg.vocab_size))
            rates.append([])
            if hasattr(system, "bridge_discrete"):
                _record_rates(system, rates[-1])
            outs.append(system.simulate(
                _source(packed, system.config.time_eps, d), steps, segments=seg.to(d),
                **{noise_name: torch.from_numpy(noise).to(d)}, **sim_kw).to("cpu"))
        launches = _counts()
        err = float((outs[0].continuous - outs[1].continuous).abs()[real].max())
        same = float((outs[0].discrete == outs[1].discrete)[real].float().mean())
        first = 0.999 if sim_kw.get("top_k") or sim_kw.get("top_p") else 1.0
        dt = (1.0 - 2.0 * Config(**cfg_kw).time_eps) / (steps - 1)
        held = [float((((a * dt).clamp(max=1.0) - (b * dt).clamp(max=1.0)).abs()
                       <= JUMP_PROB_ATOL).all(dim=-1)[real].float().mean())
                for a, b in zip(*rates)]
        print(f"{name}: card vs CPU, {steps} steps x {rows} packed rows ({int(real.sum())} real "
              f"sites): continuous max_abs_err {err:.3e} (atol 1e-4), tokens equal on "
              f"{same:.4f} of real sites (>= 0.99); "
              + (f"jump probabilities within atol {JUMP_PROB_ATOL} on "
                 f"{[round(h, 4) for h in held]} of real sites by step (the first >= {first}, the "
                 f"others >= 0.99); " if held else "")
              + f"launches K1 {_total(launches['K1'])} K2 {_total(launches['K2'])}")
        if err > 1e-4 or same < 0.99 or not (_total(launches["K1"]) + _total(launches["K2"])):
            raise AssertionError(f"{name}: the card disagrees with the CPU, or no kernel ran")
        if kind != "CFM" and not (len(held) == steps == len(rates[1]) and held[0] >= first
                                  and min(held) >= 0.99):
            raise AssertionError(f"{name}: the jump probabilities on the card disagree with "
                                 "the CPU's")


def _physical_jets(rng, mult, D=150):
    """AOJ-like jets in physical units, pT-ordered, as the AOJ reader gives
    them: pt = 1 + Exp(20) GeV, eta_rel and phi_rel ~ N(0, 0.15), tokens
    1..8; (continuous, discrete, mask) with an int64 mask."""
    mask = _pad_masks(mult, D)
    n = len(mult)
    pt = -np.sort(-(1.0 + rng.exponential(20.0, size=(n, D))) * mask[..., 0], axis=1)
    x = np.stack([pt, rng.normal(0, 0.15, size=(n, D)), rng.normal(0, 0.15, size=(n, D))], -1)
    k = rng.integers(1, 9, size=(n, D, 1))
    return (x * mask).astype(np.float32), (k * mask).astype(np.int32), mask


def _read_events(path):
    """[(step, {tag: value})] of a TensorBoard event file: the TFRecord
    framing with both masked CRC-32Cs of every record checked, then the
    Event protos' step (field 2) and scalar Summary values (field 5: tag 1,
    simple_value 2) decoded.  The first record (the file version) is
    skipped."""
    def varint(buf, i):
        shift = val = 0
        while True:
            b = buf[i]
            i += 1
            val |= (b & 0x7F) << shift
            if not b & 0x80:
                return val, i
            shift += 7

    def fields(buf):
        i = 0
        while i < len(buf):
            key, i = varint(buf, i)
            wire = key & 7
            if wire == 0:
                val, i = varint(buf, i)
            elif wire in (1, 5):
                size = 8 if wire == 1 else 4
                val, i = buf[i:i + size], i + size
            elif wire == 2:
                size, i = varint(buf, i)
                val, i = buf[i:i + size], i + size
            else:
                raise AssertionError(f"{path}: unexpected wire type {wire}")
            yield key >> 3, val

    records = []
    with open(path, "rb") as f:
        while header := f.read(8):
            (length,) = struct.unpack("<Q", header)
            crcs = [struct.unpack("<I", f.read(4))[0]]
            data = f.read(length)
            crcs.append(struct.unpack("<I", f.read(4))[0])
            if crcs != [_masked_crc(header), _masked_crc(data)]:
                raise AssertionError(f"{path}: a record's CRC does not match")
            records.append(data)
    events = []
    for data in records[1:]:
        step, scalars = None, {}
        for field, val in fields(data):
            if field == 2:
                step = val
            elif field == 5:
                for _, value in fields(val):
                    parts = dict(fields(value))
                    scalars[parts[1].decode()] = struct.unpack("<f", parts[2])[0]
        events.append((step, scalars))
    return events


class _Forwards:
    """Counts the forwards of every module of class `cls` while it is
    active (`count` after the block), through the counter registry
    (`smoke.forwards`, declared at the first block: the port's tests import
    this script and hold the port's own counters), so that a captured
    train step's forwards count at each of its replays."""

    def __init__(self, cls=particle_transformers.ParticleFormer):
        self.cls = cls

    def __enter__(self):
        profiling.declare("smoke", "forwards")
        self._start = profiling.peek_counters()["smoke.forwards"]
        self._forward = forward = self.cls.forward

        def counted(module, *args, **kw):
            profiling.count("smoke.forwards")
            return forward(module, *args, **kw)

        self.cls.forward = counted
        return self

    def __exit__(self, *exc):
        self.cls.forward = self._forward
        self.count = profiling.peek_counters()["smoke.forwards"] - self._start


def cli_entry_points(dev, out_dir):
    """The compute halves of the training and the sampling entry point at
    the flagship's full width, on in-memory synthetic jets: train two
    packed epochs, then sample from the checkpoint it left.  Returns the
    launch counts of both halves, the phase's numbers and the last sweep
    point's sample (physical units)."""
    blocks = 2 * CLI_TRAIN["n_layer"] + CLI_TRAIN["n_layer_fused"]      # 16 attention calls
    rng = np.random.default_rng(11)
    x, k, mask = _physical_jets(rng, _jets(rng, 1024, 4))
    metadata = extract_metadata(x, mask)
    mean, std = (np.asarray(metadata[m], np.float32) for m in ("mean", "std"))
    jets = MultiModal(continuous=((x - mean) / std * mask).astype(np.float32), discrete=k,
                      mask=mask)
    cfg = Config(**CLI_TRAIN, dir=out_dir, metadata=metadata)
    cfg.mint_experiment_id()
    train_ds, val_ds = train_mmf.split_jets(jets, cfg)

    t0 = time.perf_counter()
    profiling.take_counters()
    with _Forwards() as forwards:
        _, state = train_mmf.train(cfg, "MMF", train_ds, val_ds, device=dev)
        torch.cuda.synchronize()
    train_launches, train_forwards = _counts(), forwards.count
    train_s = time.perf_counter() - t0

    exp = cfg.experiment_dir
    records = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    event_files = glob.glob(os.path.join(exp, "tb", "events.out.tfevents.*"))
    events = _read_events(event_files[0]) if len(event_files) == 1 else []
    checks = {
        f"{cfg.max_epochs} epochs logged, losses finite": len(records) == cfg.max_epochs and all(
            np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in records),
        "last and best written": {"last.pt", "best.pt"} <= set(
            os.listdir(os.path.join(exp, "checkpoints"))),
        "metrics.csv written": os.path.getsize(os.path.join(exp, "metrics.csv")) > 0,
        "one tb event file, an event an epoch at the logged steps":
            [step for step, _ in events] == [r["step"] for r in records],
        "tb val_loss is the logged one (fp32)": bool(events) and all(
            abs(sc["val_loss"] - r["val_loss"]) <= 1e-6 * abs(r["val_loss"])
            for (_, sc), r in zip(events, records)),
        f"K1 {blocks} launches a forward, segment form on packed rows":
            _total(train_launches["K1"]) == blocks * train_forwards
            and train_launches["K1"]["segments"] > 0,
        "K2 never": not _total(train_launches["K2"]),
    }
    print(f"entry point cli.train_mmf.train: {state.step} steps, {train_forwards} encoder "
          f"forwards (train + validation) in {train_s:.2f} s; launches {train_launches}; tb "
          f"events {[(step, round(sc['val_loss'], 5)) for step, sc in events]}; checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"training entry point failed {checks}")

    # the sampling entry point's overrides, then its compute half; the test
    # jets are a fresh draw of the same law in physical units
    cfg.num_jets, cfg.temperature, cfg.num_timesteps = CLI_SAMPLED_JETS, [1.0], CLI_SWEEP_STEPS
    tx, tk, tmask = _physical_jets(rng, _jets(rng, 1024, 32))
    test = MultiModal(continuous=tx, discrete=tk, mask=tmask)
    t0 = time.perf_counter()
    profiling.take_counters()
    with _Forwards() as forwards:
        results = sample_mmf.sample(cfg, "MMF", tmask, dev, checkpoint="best",
                                    temperatures=cfg.temperature,
                                    timestep_grid=cfg.num_timesteps, save=False)
    sample_launches, sample_forwards = _counts(), forwards.count
    sample_s = time.perf_counter() - t0
    points = [sample_mmf.point_metrics(r.sample, test, cfg, {
        "jets_per_sec": r.jets_per_sec, "num_timesteps": r.num_timesteps,
        "temperature": r.temperature}, tag=r.tag) for r in results]
    N, D = CLI_SAMPLED_JETS, cfg.max_num_particles
    checks = {
        "two sweep points, tagged": [r.tag for r in results] == [
            f"_system:MMF_steps_{steps}_temp_1.0" for steps in CLI_SWEEP_STEPS],
        "shapes": all(r.sample.continuous.shape == (N, D, 3)
                      and r.sample.discrete.shape == (N, D, 1) for r in results),
        "finite, tokens in [0, V), pads zero": all(
            bool(torch.isfinite(r.sample.continuous).all()
                 and ((r.sample.discrete >= 0) & (r.sample.discrete < cfg.vocab_size)).all()
                 and (r.sample.continuous[r.sample.mask[..., 0] == 0] == 0).all())
            for r in results),
        "physical units (destandardized pt)": all(
            float(r.sample.continuous[..., 0].abs().max()) > 3.0 for r in results),
        "W1 metrics finite": all(
            np.isfinite(list(p["w1_flavor"].values()) + list(p["w1_kinematics"].values())).all()
            for p in points),
        f"K1 {blocks} launches a forward, both forms":
            _total(sample_launches["K1"]) == blocks * sample_forwards
            and sample_launches["K1"]["segments"] > 0 and sample_launches["K1"]["key_mask"] > 0,
        "K2 never": not _total(sample_launches["K2"]),
    }
    for p in points:
        print(f"  steps {p['num_timesteps']}: {p['jets_per_sec']:.1f} jets/s, W1 multiplicity "
              f"{p['w1_flavor']['multiplicity']:.3f}, W1 kinematics "
              f"{ {n: round(v, 4) for n, v in p['w1_kinematics'].items()} }")
    print(f"entry point cli.sample_mmf.sample: {N} jets x steps {CLI_SWEEP_STEPS}, "
          f"{sample_forwards} encoder forwards in {sample_s:.2f} s; launches {sample_launches}; "
          f"checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"sampling entry point failed {checks}")
    numbers = dict(train_s=train_s, train_steps=state.step, train_forwards=train_forwards,
                   sample_s=sample_s, sample_forwards=sample_forwards,
                   jets_per_s=[p["jets_per_sec"] for p in points])
    return train_launches, sample_launches, numbers, results[-1].sample


def toy_phase(dev, out_dir):
    """`cli.toy_tutorial.run` on the card at the tutorial's widths: the
    closure numbers; the train step's wall time and launches; then the
    trained model's 200-step trajectory on the card against the CPU's, from
    one source and one set of uniforms."""
    from torch.profiler import ProfilerActivity, profile

    cfg = toy_tutorial.toy_config(TOY_EPOCHS, out_dir)
    t0 = time.perf_counter()
    profiling.take_counters()
    out = toy_tutorial.run(cfg, num_points=TOY_POINTS, num_timesteps=TOY_STEPS, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _counts()
    freq = out["label_freq"]
    print(f"toy tutorial on the card: {TOY_POINTS} points, {TOY_EPOCHS} epochs "
          f"({out['state'].step} steps), {TOY_STEPS}-step trajectories of 2000 points in "
          f"{run_s:.2f} s: W1(x) {out['w1_x']:.4f}, W1(y) {out['w1_y']:.4f} (< 0.3), label "
          f"frequencies {np.round(freq, 3).tolist()}")
    traj = out["trajectory"]
    if not (out["w1_x"] < 0.3 and out["w1_y"] < 0.3 and freq[1] + freq[2] > 0.8
            and traj.continuous.shape == (TOY_STEPS, 2000, 1, 2)
            and traj.time.shape == (TOY_STEPS, 2000) and torch.isfinite(traj.continuous).all()):
        raise AssertionError("toy tutorial: the flow did not close, or the trajectory is "
                             "malformed")
    if _total(launches["K1"]) + _total(launches["K2"]):
        raise AssertionError("toy tutorial launched an attention kernel")

    # the train step: wall (each step synchronized) and launches
    system = out["system"]
    trainer = Trainer(system, cfg)
    state = trainer.init_state(100)
    coupling = toy_tutorial.toy_coupling(cfg.batch_size * 8)
    batches = [coupling[np.arange(i * cfg.batch_size, (i + 1) * cfg.batch_size)].to(dev)
               for i in range(8)]
    gen = torch.Generator(device=dev).manual_seed(0)
    system.module.train()
    weights = {n: p.detach().clone() for n, p in system.module.named_parameters()}
    for b in batches[:3]:
        trainer._train_step(state, b, gen)
    torch.cuda.synchronize()
    walls = []
    for i in range(40):
        t0 = time.perf_counter()
        trainer._train_step(state, batches[i % 8], gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(5):
            trainer._train_step(state, batches[i], gen)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    step_launches = sum(e.count for e in averages if e.key == "cudaLaunchKernel") / 5
    annotations = {e.key for e in averages if e.device_type.name == "CPU"}
    device_ms = sum(e.self_device_time_total for e in averages
                    if e.device_type.name == "CUDA" and e.key not in annotations) / 5 / 1e3
    with torch.no_grad():  # the timing steps trained on: put the run's weights back
        for n, p in system.module.named_parameters():
            p.copy_(weights[n])
    system.module.eval()
    step_ms = float(np.median(walls)) * 1e3
    print(f"toy train step (batch {cfg.batch_size}): median wall {step_ms:.3f} ms over 40 "
          f"synchronized steps, device {device_ms:.3f} ms and {step_launches:.0f} "
          f"cudaLaunchKernel a step (torch.profiler, 5 steps)")

    # card vs CPU: the same trained weights, source and uniforms
    n = 512
    cpu = build_system(cfg, "MMF", device="cpu")
    cpu.module.load_state_dict({k: v.cpu() for k, v in system.module.state_dict().items()})
    us = torch.from_numpy(np.random.default_rng(12).uniform(size=(TOY_STEPS, n, 1))
                          .astype(np.float32))
    trajs = []
    for sys_, d in ((system, dev), (cpu, "cpu")):
        src = toy_tutorial.generation_source(cfg, n, d)
        trajs.append(sys_.simulate(src, TOY_STEPS, uniforms=us.to(d),
                                   return_trajectory=True)[1].to("cpu"))
    same = trajs[0].discrete == trajs[1].discrete
    agree = same.all(dim=0)[:, 0, 0]      # points whose labels agree along the whole path
    err = float((trajs[0].continuous - trajs[1].continuous)[:, agree].abs().max())
    time_err = float((trajs[0].time - trajs[1].time).abs().max())
    print(f"toy trajectory card vs CPU, {TOY_STEPS} steps x {n} points, every entry: tokens "
          f"equal on {float(same.float().mean()):.4f} of sites (>= 0.99), {int(agree.sum())} "
          f"points agree along the whole path (>= 0.99 of {n}); their positions max_abs_err "
          f"{err:.3e} (atol 1e-4); times max_abs_err {time_err:.1e}")
    if not (float(same.float().mean()) >= 0.99 and float(agree.float().mean()) >= 0.99
            and err <= 1e-4 and time_err <= 1e-6):
        raise AssertionError("toy trajectory: the card disagrees with the CPU")
    return dict(run_s=run_s, steps=out["state"].step, w1_x=out["w1_x"], w1_y=out["w1_y"],
                label_freq=np.round(freq, 4).tolist(), step_wall_ms=step_ms,
                step_device_ms=device_ms, step_launches=step_launches)


def substructure_phase(sample: MultiModal):
    """Jet substructure of the sampled jets, once: host code, with the
    native library when the host compiler builds it, else the numpy version
    (on a few small jets: its loops are cubic in the multiplicity)."""
    lib = jet_substructure.load_library()
    version = "native library" if lib is not None else "numpy version"
    mult = sample.mask[..., 0].sum(dim=1)
    small = torch.nonzero((mult >= 3) & (mult <= 24))[:4, 0]
    chosen = sample if lib is not None else sample[small]
    t0 = time.perf_counter()
    feats = JetFeatures(chosen, compute_substructure=True)
    seconds = time.perf_counter() - t0
    names = ("tau1", "tau2", "tau3", "tau21", "tau32", "c1", "d2")
    finite = {n: float(np.isfinite(getattr(feats, n)).mean()) for n in names}
    print(f"substructure ({version}): {int(feats.substructure_mask.sum())} of {len(chosen)} "
          f"sampled jets with >= 3 particles in {seconds:.3f} s; median tau21 "
          f"{np.nanmedian(feats.tau21):.4f}, tau32 {np.nanmedian(feats.tau32):.4f}, c1 "
          f"{np.nanmedian(feats.c1):.4f}; finite share {finite}")
    ok = (feats.substructure_mask.sum() > 0 and min(finite[n] for n in names[:3]) == 1.0
          and (feats.tau1 >= 0).all() and np.nanmax(feats.tau21) <= 1.0 + 1e-5)
    if lib is not None and len(small):
        # the library against the numpy version on a few small jets
        c = JetFeatures(sample[small], compute_substructure=False).constituents
        a = jet_substructure.substructure(c.pt, c.eta_rel, c.phi_rel)
        b = jet_substructure.substructure(c.pt, c.eta_rel, c.phi_rel, force_numpy=True)
        err = max(float(np.nanmax(np.abs(a[n] - b[n]) / (1e-5 + 1e-4 * np.abs(b[n]))))
                  for n in a)
        print(f"substructure library vs numpy on {len(small)} small jets: worst |diff| / "
              f"(atol 1e-5 + rtol 1e-4 |ref|) = {err:.3f} (<= 1)")
        ok = ok and err <= 1.0
    if not ok:
        raise AssertionError("substructure of the sampled jets is malformed")
    return version


def _gpt_card_vs_cpu(dev, system, cpu, ids):
    """`FlavorSeqGPT` on the card against the CPU on shared weights: the
    full forward's logits and the loss on `ids`; greedy generation and
    generation from one set of Gumbel noise, tokens equal."""
    batch = DataCoupling(target=MultiModal(discrete=ids))
    with torch.no_grad():
        logits = [s.module(ids.to(s.device)).cpu() for s in (system, cpu)]
        losses = [s.loss_fn(batch.to(s.device), train=False)[0].item() for s in (system, cpu)]
    B, T, V = logits[0].shape
    u = np.random.default_rng(19).uniform(size=(T - 1, B, V)).astype(np.float32)
    gumbel = torch.from_numpy(-np.log(-np.log(np.maximum(u, np.finfo(np.float32).tiny))))
    same = {}
    for name, kw in (("greedy", dict(top_k=1)), ("Gumbel noise", dict(gumbel=gumbel))):
        seqs = [s.generate(B, **kw).cpu() for s in (system, cpu)]
        same[name] = float((seqs[0] == seqs[1]).float().mean())
    err = float((logits[0] - logits[1]).abs().max())
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    print(f"GPT card vs CPU, {B} sequences of {T}: logits max_abs_err {err:.3e} (atol "
          f"{GPT_LOGITS_ATOL}), loss {losses[0]:.7f} vs {losses[1]:.7f} rel {rel:.3e} (<= "
          f"{GPT_LOSS_RTOL}); generated tokens equal {same} (>= {GPT_TOKENS_EQUAL})")
    if err > GPT_LOGITS_ATOL or rel > GPT_LOSS_RTOL or min(same.values()) < GPT_TOKENS_EQUAL:
        raise AssertionError("GPT: the card disagrees with the CPU")
    return dict(logits_max_abs_err=err, loss_rel_err=rel, tokens_equal=same)


def decode_graph_check(system, batch_size: int, calls: int = 3) -> dict:
    """`GPT.generate` with its decode step captured as one CUDA graph against
    the same steps run eagerly (the graph path switched off), `calls` calls
    of `batch_size` from seeds 0, 1, ...: identical tokens call by call; K2's
    key-mask form counted n_layer x (seq_len - 1) a call on both paths (a
    replay adds the captured step's launches); one capture over the calls.
    Prints each call's wall, synchronised, graph beside eager (the graph's
    first call captures)."""
    from unittest import mock

    from multimodal_flows_tpu_torch.train import gpt as gpt_train

    steps = system.module.seq_len - 1
    n_layer = system.config.n_layer

    def run():
        out = []
        for seed in range(calls):
            gen = torch.Generator(device=system.device).manual_seed(seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens = system.generate(batch_size, gen, temperature=1.0, top_k=None)
            torch.cuda.synchronize()
            out.append((tokens.cpu(), time.perf_counter() - t0))
        return out, profiling.take_counters()

    profiling.take_counters()
    graph, graph_counts = run()
    with mock.patch.object(gpt_train, "_graphable", return_value=False):
        eager, eager_counts = run()
    n = calls * steps
    equal = [torch.equal(a, b) for (a, _), (b, _) in zip(graph, eager)]
    checks = {
        "graph and eager tokens identical, every call": all(equal),
        f"K2 key-mask {n_layer} x {steps} a call through the replays":
            _group(graph_counts, "k2") == _only("key_mask", n_layer * n),
        f"K2 key-mask {n_layer} x {steps} a call eagerly":
            _group(eager_counts, "k2") == _only("key_mask", n_layer * n),
        f"one capture over {calls} calls, {n - 1} replays after one eager step":
            (graph_counts["gpt_decode.captures"], graph_counts["gpt_decode.graph_steps"],
             graph_counts["gpt_decode.eager_steps"]) == (1, n - 1, 1),
        f"eagerly: {n} eager steps, no replay, no capture":
            (eager_counts["gpt_decode.captures"], eager_counts["gpt_decode.graph_steps"],
             eager_counts["gpt_decode.eager_steps"]) == (0, 0, n),
    }
    walls = {"graph_s": [round(w, 4) for _, w in graph], "eager_s": [round(w, 4) for _, w in eager]}
    print(f"GPT decode as one CUDA graph vs eager, batch {batch_size}, {calls} calls of {steps} "
          f"steps: wall a call graph {walls['graph_s']} s, eager {walls['eager_s']} s; tokens "
          f"equal by call {equal}; checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"GPT decode graph failed {checks}")
    return walls


def gpt_phase(dev, out_dir):
    """The GPT baseline at the training CLI's defaults with `--system GPT`:
    the decode against the full forward on the card, the card against the
    CPU, the training entry point's compute half (K2's causal form exactly 5
    launches a forward, nothing else), 30 steps on a fixed batch, the step's
    time, then the sampling entry point's GPT compute half on the
    checkpoint (K2's key-mask form exactly 5 x 151 launches a batch), the
    decode step captured as a CUDA graph against its eager run
    (`decode_graph_check`) and the decode step's time.  Returns the launch
    counts of both halves and the phase's numbers."""
    from multimodal_flows_tpu_torch.models.gpt import FlavorSeqGPT
    from multimodal_flows_tpu_torch.train.gpt import GPT

    cfg, _ = train_mmf.experiment_configs(GPT_ARGV + ["--dir", out_dir])
    cfg.mint_experiment_id()
    rng = np.random.default_rng(17)
    x, tok, mask = _physical_jets(rng, _jets(rng, GPT_JETS, 4))
    train_ds, val_ds = train_mmf.split_jets(MultiModal(continuous=x, discrete=tok, mask=mask),
                                            cfg, "GPT")
    trainer = train_mmf.build_trainer(cfg, "GPT", dev)
    system, n_layer = trainer.system, cfg.n_layer
    T = system.module.seq_len
    ids = torch.from_numpy(train_ds.coupling.target.discrete[:cfg.batch_size]).to(dev)
    numbers = {"shape": f"{cfg.batch_size} sequences of {T}, {cfg.n_layer} layers, C "
                        f"{cfg.n_embd}, {cfg.n_head} heads, {system.module.full_vocab} logits"}

    # the KV-cached decode against the teacher-forced forward, every position
    with torch.no_grad():
        full = system.module(ids)
        caches = system.module.init_cache(len(ids))
        steps = []
        for t in range(T):
            logits, caches = system.module.decode(ids[:, t], t, caches)
            steps.append(logits)
        err = float((torch.stack(steps, 1) - full).abs().max())
    print(f"GPT decode vs the full forward on the card, {len(ids)} x {T} positions: max_abs_err "
          f"{err:.3e} (atol {GPT_DECODE_ATOL})")
    if err > GPT_DECODE_ATOL:
        raise AssertionError("GPT: the KV-cached decode disagrees with the full forward")
    numbers["decode_vs_full_max_abs_err"] = err
    cpu = build_system(cfg, "GPT", device="cpu", generator=torch.Generator().manual_seed(0))
    cpu.module.load_state_dict({k: v.cpu() for k, v in system.module.state_dict().items()})
    numbers["card_vs_cpu"] = _gpt_card_vs_cpu(dev, system, cpu, ids[:GPT_VS_CPU_ROWS].cpu())
    del trainer, system, cpu, full, caches, steps

    # the training entry point's compute half: the main path
    t0 = time.perf_counter()
    profiling.take_counters()
    with _Forwards(FlavorSeqGPT) as forwards:
        trainer, state = train_mmf.train(cfg, "GPT", train_ds, val_ds, device=dev)
        torch.cuda.synchronize()
    train_launches, train_forwards = _counts(), forwards.count
    train_s = time.perf_counter() - t0
    exp = cfg.experiment_dir
    records = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    fresh = build_system(cfg, "GPT", device=dev)
    fresh.module.load_state_dict(trainer.load_for_inference("last"))
    reloaded = trainer.evaluate(val_ds, fresh.module, epoch=cfg.max_epochs - 1)["val_loss"]
    del fresh
    checks = {
        f"{cfg.max_epochs} epochs logged, losses finite": len(records) == cfg.max_epochs and all(
            np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in records),
        "last reloaded gives the logged val_loss (rel 1e-5)":
            abs(reloaded - records[-1]["val_loss"]) <= 1e-5 * abs(records[-1]["val_loss"]),
        f"K2 causal form {n_layer} launches a forward, every other form 0":
            train_forwards > 0
            and train_launches["K2"] == _only("causal", n_layer * train_forwards),
        "K1 never, no plain dropout call": not _total(train_launches["K1"])
            and not _total(train_launches["plain_dropout"]),
    }
    for r in records:
        print(f"  epoch {r['epoch']:.0f}: train_loss {r['train_loss']:.5f} val_loss "
              f"{r['val_loss']:.5f} ({r['epoch_time_s']:.2f} s)")
    print(f"GPT entry point cli.train_mmf.train: {state.step} steps, {train_forwards} forwards "
          f"(train + validation) in {train_s:.2f} s; launches {train_launches}; val_loss logged "
          f"{records[-1]['val_loss']:.7f}, reloaded {reloaded:.7f}; checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"GPT training entry point failed {checks}")
    numbers.update(train_s=train_s, train_steps=state.step, train_forwards=train_forwards,
                   val_loss=records[-1]["val_loss"])

    # 30 steps on one fixed batch: the loss falls
    system = trainer.system
    fixed = Trainer(system, cfg)
    fixed_state = fixed.init_state(30)
    batch = train_ds[np.arange(cfg.batch_size)].to(dev)
    gen = torch.Generator(device=dev)
    system.module.train()
    profiling.take_counters()
    losses = []
    for _ in range(30):
        gen.manual_seed(0)
        losses.append(fixed._train_step(fixed_state, batch, gen)["loss"])
    losses = torch.stack(losses).cpu().numpy()
    fixed_launches = _counts()
    system.module.eval()
    print(f"GPT, fixed batch, 30 steps: loss {losses[0]:.5f} -> {losses[-1]:.5f} (last 5 mean "
          f"{losses[-5:].mean():.5f}); launches {fixed_launches}")
    if not (np.isfinite(losses).all() and losses[-5:].mean() < losses[0]
            and fixed_launches["K2"] == _only("causal", 30 * n_layer)
            and not _total(fixed_launches["K1"])):
        raise AssertionError("GPT: the loss on a fixed batch did not fall, or K2 did not run "
                             "5 times a step")
    numbers["step"] = time_training(dev, fixed, fixed_state, train_ds, n=10, n_prof=3,
                                    label="GPT", kernel="K2",
                                    backward_node="SetAttentionBackward")
    del trainer, state, fixed, fixed_state

    # the sampling entry point's GPT compute half on the checkpoint
    cfg.num_jets = GPT_SAMPLED_JETS
    batches = -(-cfg.num_jets // cfg.batch_size)
    generated = []
    real_generate = GPT.generate

    def recorded(self, batch_size, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_generate(self, batch_size, *args, **kw)
        torch.cuda.synchronize()
        generated.append((out.cpu().numpy(), time.perf_counter() - t0))
        return out

    GPT.generate = recorded
    try:
        t0 = time.perf_counter()
        profiling.take_counters()
        sample = sample_mmf.sample_gpt(cfg, dev, checkpoint="last", temperature=1.0)
        sample_launches = _counts()
        sample_s = time.perf_counter() - t0
    finally:
        GPT.generate = real_generate
    seqs = np.concatenate([g for g, _ in generated])
    V = cfg.vocab_size
    after_eos = [row[np.argmax(row == V + 2) + 1:] for row in seqs if (row == V + 2).any()]
    decode_steps = T - 1
    checks = {
        "shape": sample.shape == (cfg.num_jets, cfg.max_num_particles),
        f"{batches} batches of {cfg.batch_size}": len(generated) == batches,
        "BOS first": bool((seqs[:, 0] == V + 1).all()),
        "PAD after the first EOS": all((rest == V + 3).all() for rest in after_eos),
        "stripped tokens in [0, V]": bool(sample.min() >= 0 and sample.max() <= V),
        f"K2 key-mask form {n_layer} x {decode_steps} launches a batch, every other form 0":
            sample_launches["K2"] == _only("key_mask", n_layer * decode_steps * batches),
        "K1 never": not _total(sample_launches["K1"]),
    }
    gen_s = sum(s for _, s in generated)
    sampled_jets_per_s = len(seqs) / gen_s
    ended = float(np.mean([(row == V + 2).any() for row in seqs]))
    print(f"GPT entry point cli.sample_mmf.sample_gpt: {cfg.num_jets} jets in {batches} batches, "
          f"{sample_s:.2f} s with the checkpoint's load, generation {gen_s:.3f} s = "
          f"{sampled_jets_per_s:.1f} jets/s ({[round(s, 3) for _, s in generated]} s a batch); "
          f"{ended:.3f} of the sequences ended with EOS, multiplicity mean "
          f"{(sample > 0).sum(1).mean():.1f}, token V {int((sample == V).sum())} times; "
          f"launches {sample_launches}; checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"GPT sampling entry point failed {checks}")
    numbers.update(sample_s=sample_s, generate_s=gen_s, sampled_jets_per_s=sampled_jets_per_s)

    numbers["decode_graph"] = decode_graph_check(
        build_system(cfg, "GPT", device=dev, generator=torch.Generator().manual_seed(0)),
        cfg.batch_size)

    # the decode step: one batch's generation under the profiler
    system = build_system(cfg, "GPT", device=dev, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    system.generate(cfg.batch_size, gen)  # warm-up
    prof = profiling.profile_steps(lambda i: system.generate(cfg.batch_size, gen), 1)
    # the device time from the kernels themselves: a graph's kernels hang
    # under no host op, so `prof.device_ms` (the host ops' totals) misses them
    step = dict(wall_ms=prof.wall_ms / decode_steps,
                device_ms=sum(ms for _, ms, _ in prof.kernels) / decode_steps,
                launches=prof.launches / decode_steps,
                attention_ms=prof.kernel_ms("attention_kernel") / decode_steps)
    step["busy_share"] = _share(step["device_ms"], step["wall_ms"])
    print(f"GPT decode step (batch {cfg.batch_size}, torch.profiler over one batch's "
          f"{decode_steps} steps): wall {step['wall_ms']:.3f} ms, device {step['device_ms']:.3f} "
          f"ms (busy share {step['busy_share']:.3f}), {step['launches']:.1f} cudaLaunchKernel "
          f"(a graph replay launches none), "
          f"K2 {step['attention_ms']:.4f} ms a step")
    for name, ms, count in prof.kernels[:10]:
        ms /= decode_steps
        print(f"  {ms:8.4f} ms/step {_share(ms, step['device_ms']):6.3f}  "
              f"{count / decode_steps:6.1f}/step  {name[:100]}")
    numbers["decode_step"] = step
    return train_launches, sample_launches, numbers


# --------------------------------------------------------------- meshes
#
# mesh_phase: the port's meshes on the card.  Tensor parallelism at
# tensor_parallel=2 gives each rank H=2 of the flagship's 4 heads: K1 and K2
# then run at C=64 (head size 32, the half-width streams) and C=128 (head
# size 64, the fused blocks), the co-occurrence bias at (B, 2, T, T).

TP_SHAPES = [(128, 128, 64, 2), (128, 128, 128, 2)]
MESH_TIMEOUT_S = 300
# sampling over two ranks: 128 jets of AOJ-like multiplicity, 8 steps
MESH_SAMPLE_JETS, MESH_SAMPLE_STEPS = 128, 8
# every flagship forward: 5 + 5 half-width blocks and 6 fused blocks
K1_PER_FORWARD = 16


def check_tp_shapes(dev):
    """K1 (segments and key mask) and K2 (bias (B, 2, T, T) + segments) at
    the per-rank shapes of tensor_parallel=2, against the plain version with
    their gradients (K2's with the bias's); then each timed as
    `time_kernels` times them.  Returns (worst errors, times)."""
    worst, times = {"K1": 0.0, "K2": 0.0}, {}
    for shape in TP_SHAPES:
        H = shape[3]
        for form in ("segments", "key_mask"):
            q, k, v, km, seg, _, real = _case_inputs(shape, form, dev, seed=11)
            worst["K1"] = max(worst["K1"], _held(
                f"K1 (TP shard) vs plain {shape} {form}", k1.btc_attention(q, k, v, H, km, seg),
                attention_btc_reference(q, k, v, H, km, seg), real))
            _grads_held(f"K1 (TP shard) {shape} {form}",
                        [lambda a, b, c: k1.btc_attention(a, b, c, H, km, seg),
                         lambda a, b, c: attention_btc_reference(a, b, c, H, km, seg)],
                        [q, k, v])
        q, k, v, _, seg, bias, real = _case_inputs(shape, "bias_segments", dev, seed=12)
        worst["K2"] = max(worst["K2"], _held(
            f"K2 (TP shard) vs plain {shape} bias {tuple(bias.shape)} + segments",
            k2.set_attention_btc(q, k, v, H, None, bias, seg),
            attention_btc_reference(q, k, v, H, None, seg, bias), real))
        _grads_held(f"K2 (TP shard) {shape} bias + segments",
                    [lambda a, b, c, d: k2.set_attention_btc(a, b, c, H, None, d, seg),
                     lambda a, b, c, d: attention_btc_reference(a, b, c, H, None, seg, d)],
                    [q, k, v, bias])
    with torch.no_grad():
        for shape in TP_SHAPES:
            for name, t in _time_packed(shape, dev).items():
                times[name, shape, "segments"] = t
            times["K1", shape, "key_mask"] = _time_key_mask(shape, dev)
    return worst, times


def _mesh_batch(train_ds):
    """The flagship's first packed row batch, cut to an even number of rows
    (84) so that two data ranks take equal shares; host arrays."""
    trainer = Trainer(_system("MMF", TRAIN, torch.device("cpu")), Config(**TRAIN), mesh=None)
    batch = _first_batch(trainer, train_ds)
    return batch[np.arange(len(batch) - len(batch) % 2)]


def _layout_step(dev, cfg_kw, mesh, batch):
    """One flagship train step in the layout of `cfg_kw` over `mesh` ("auto"
    or None), on `batch` (global rows; each rank runs its share) with fixed
    draws: the loss, every full gradient, the full weights after the update,
    the forward's launches, and the trainer and its state."""
    cfg = Config(**cfg_kw)
    system = build_system(cfg, "MMF", device=dev, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(system, cfg, mesh=mesh)
    state = trainer.init_state(10)
    state.module.train()
    batch = batch.to(dev)
    profiling.take_counters()
    loss, _ = system.loss_fn(batch, torch.Generator(device=dev).manual_seed(3), train=True,
                             module=state.module, rows=data_rows(len(batch), trainer.mesh))
    launches = _counts()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    # before the update: a data-parallel rank's own gradients (its share);
    # FSDP's are reduced in the backward, TP's gathered here.  Host copies:
    # an unsharded module's gradients are clipped in place and its state
    # dict aliases the parameters, and the card's memory stays the layout's
    grads = {n: tpar._full(p.grad, p).to("cpu", copy=True)
             for n, p in state.module.named_parameters()}
    trainer._update(state)
    after = {n: w.to("cpu", copy=True) for n, w in tpar.full_state_dict(state.module).items()}
    state.module.eval()
    return loss.item(), grads, after, launches, trainer, state


def _same_step(name, ref, got, loss_rtol=TRAIN_LOSS_RTOL):
    """A layout's step against the plain step: loss, gradients, weights."""
    (loss_a, grads_a, after_a), (loss_b, grads_b, after_b) = ref, got
    rel = abs(loss_b - loss_a) / abs(loss_a)
    worst, worst_name = max((float(((grads_b[n].cpu() - g.cpu()).abs()
                                    / (TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * g.cpu().abs())).max()),
                             n) for n, g in grads_a.items())
    err = max(float((after_b[n].cpu() - w.cpu()).abs().max()) for n, w in after_a.items())
    print(f"{name} vs the plain step: loss {loss_b:.7f} vs {loss_a:.7f} (rel {rel:.3e} <= "
          f"{loss_rtol}); {len(grads_a)} gradients, worst |diff| / (atol {TRAIN_GRAD_ATOL} + "
          f"rtol {TRAIN_GRAD_RTOL} |g|) = {worst:.3f} (<= 1, {worst_name}); weights after the "
          f"update max_abs_err {err:.3e} (atol {UPDATE_ATOL})")
    if rel > loss_rtol or worst > 1.0 or err > UPDATE_ATOL:
        raise AssertionError(f"{name}: the step disagrees with the plain step")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def nccl_world_one(dev, train_ds, val_ds, out_dir, batch):
    """NCCL at world size 1 on the card, through the real wrappers: the
    flagship's step plain, data parallel (one NCCL all-reduce of the
    gradients a step) and FSDP2, on one batch with the same draws: equal
    losses, gradients and weights, K1 16 launches a forward in each; each
    layout's step timed (`time_training`: wall, device time, launches, the
    NCCL kernels' time) with its peak memory.  Then an FSDP `fit`, whose
    `last` reloads into a plain one-device system and gives the logged
    val_loss.  Returns ({layout: numbers}, the fit's val losses, the plain
    step)."""
    torch.distributed.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                                         rank=0, world_size=1, device_id=dev)
    numbers, steps, live = {}, {}, {}
    try:
        for layout, cfg_kw, mesh in (("plain", TRAIN, None), ("data parallel", TRAIN, "auto"),
                                     ("FSDP2", dict(TRAIN, fsdp=True), "auto")):
            # the layout's own peak: above what the earlier layouts hold
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss, grads, after, launches, trainer, state = _layout_step(dev, cfg_kw, mesh, batch)
            print(f"mesh, NCCL world size 1, {layout}: mesh {trainer.mesh}; forward launches "
                  f"{launches}")
            if launches["K1"]["segments"] != K1_PER_FORWARD or _total(launches["K2"]):
                raise AssertionError(f"{layout}: K1 did not run {K1_PER_FORWARD} times a "
                                     "forward in its segment form, or K2 ran")
            steps[layout] = (loss, grads, after)
            if layout != "plain":
                _same_step(f"NCCL world size 1, {layout}", steps["plain"], steps[layout])
            t = time_training(dev, trainer, state, train_ds, n=10, n_prof=3,
                              label=f"flagship, {layout}, NCCL world size 1")
            t["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
            t["forward_k1_launches"] = launches["K1"]["segments"]
            t["walls_ms"] = [t["wall_ms"]]
            print(f"{layout}: peak max_memory_allocated {t['peak_mib']:.1f} MiB above the "
                  f"{base / 2**20:.1f} MiB held before; NCCL kernels {t['collective_ms']:.4f} ms, "
                  f"memcpy {t['memcpy_ms']:.4f} ms ({t['memcpy_per_step']:.0f}) a step")
            numbers[layout], live[layout] = t, (trainer, state)
        # the walls again in reverse order (turns plain, DP, FSDP, FSDP, DP,
        # plain): the host's speed drifts within a call
        for layout in reversed(list(live)):
            again = time_training(dev, *live[layout], train_ds, n=10, n_prof=3,
                                  label=f"flagship, {layout}, NCCL world size 1, second turn")
            numbers[layout]["walls_ms"].append(again["wall_ms"])
        live.clear()

        # an FSDP fit: its checkpoint holds full tensors and loads into one device
        cfg = Config(**dict(TRAIN, fsdp=True, max_epochs=1, dir=out_dir, experiment_id="fsdp"))
        trainer = Trainer(_system("MMF", dict(TRAIN, fsdp=True), dev), cfg)
        trainer.fit(train_ds, val_ds)
        logged = [json.loads(line) for line in open(
            os.path.join(cfg.experiment_dir, "metrics.jsonl"))][-1]["val_loss"]
        fresh = build_system(cfg, "MMF", device=dev)
        plain = Trainer(fresh, Config(**TRAIN), mesh=None)
        fresh.module.load_state_dict(trainer.load_for_inference("last"))
        reloaded = plain.evaluate(val_ds, fresh.module, epoch=0)["val_loss"]
        print(f"FSDP fit: val_loss logged {logged:.7f}, `last` reloaded into a plain system "
              f"{reloaded:.7f} (rel 1e-5)")
        if abs(reloaded - logged) > 1e-5 * abs(logged):
            raise AssertionError("the FSDP checkpoint does not reload to the logged val_loss")
    finally:
        torch.distributed.destroy_process_group()
    return numbers, dict(val_loss_logged=logged, val_loss_reloaded=reloaded), steps["plain"]


def _two_rank_worker(rank, port, out_dir, device, train_kw, flagship_kw):
    """One of two ranks sharing `device` (cuda:0) over gloo with its
    tensors: a data parallel step and a tensor_parallel=2 step of
    `train_kw` on the parent's batch (`batch.pt`), and `generate_packed` of
    `flagship_kw` over the data mesh on the parent's masks (`masks.npy`)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         rank=rank, world_size=2)
    try:
        batch = torch.load(os.path.join(out_dir, "batch.pt"), weights_only=False)
        res = {}
        for layout, cfg_kw in (("dp", train_kw), ("tp", dict(train_kw, tensor_parallel=2))):
            loss, grads, after, launches, trainer, state = _layout_step(dev, cfg_kw, "auto",
                                                                        batch)
            heads = state.module.encoder.block_fuse_0.attn.n_head
            res[layout] = dict(loss=loss, after={n: w.cpu() for n, w in after.items()},
                               grads={n: g.cpu() for n, g in grads.items()},
                               launches=launches, heads=heads, mesh=str(trainer.mesh))
            del trainer, state
        system = _system("MMF", flagship_kw, dev)
        mesh = Trainer(system, Config(**flagship_kw)).mesh
        res["sample"] = generate_packed(system, np.load(os.path.join(out_dir, "masks.npy")),
                                        num_timesteps=MESH_SAMPLE_STEPS,
                                        pack_width=train_kw["pack_width"], batch_size=128,
                                        seed=0, mesh=mesh).sample
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def two_ranks_one_card(dev, plain_step, batch, out_dir):
    """Two processes sharing the card over gloo (CUDA tensors): their data
    parallel and tensor-parallel steps against the plain step on the same
    global batch and draws (K1 at H=2 in the TP step), and 128 jets sampled
    over the data mesh at 8 steps against one process on one seed.  A
    collective that gloo refuses fails the phase with its name (the
    worker's traceback)."""
    import torch.multiprocessing as mp

    torch.save(batch, os.path.join(out_dir, "batch.pt"))
    width = TRAIN["pack_width"]
    mult = _multiplicities(np.random.default_rng(8), MESH_SAMPLE_JETS, width)
    masks = _pad_masks(mult, FLAGSHIP["max_num_particles"])
    np.save(os.path.join(out_dir, "masks.npy"), masks)
    t0 = time.perf_counter()
    ctx = mp.spawn(_two_rank_worker, args=(_free_port(), out_dir, str(dev), TRAIN, FLAGSHIP),
                   nprocs=2, join=False)
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the two ranks did not finish in {MESH_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]

    # data parallel: each rank's loss and gradients are its share, scaled so
    # that their mean over the ranks is the global batch's
    dp_loss = float(np.mean([r["dp"]["loss"] for r in ranks]))
    dp_grads = {n: (ranks[0]["dp"]["grads"][n] + ranks[1]["dp"]["grads"][n]) / 2
                for n in ranks[0]["dp"]["grads"]}
    for r, res in enumerate(ranks):
        print(f"two ranks on one card, rank {r}: dp mesh {res['dp']['mesh']}, forward launches "
              f"{res['dp']['launches']}; tp mesh {res['tp']['mesh']}, {res['tp']['heads']} heads "
              f"a rank, forward launches {res['tp']['launches']}")
        if res["tp"]["heads"] != 2 or res["tp"]["launches"]["K1"]["segments"] != K1_PER_FORWARD:
            raise AssertionError("the TP step did not run K1 at H=2, 16 times a forward")
        _same_step(f"gloo rank {r}, data parallel (the ranks' mean loss and gradients)",
                   plain_step, (dp_loss, dp_grads, res["dp"]["after"]))
        _same_step(f"gloo rank {r}, tensor_parallel=2", plain_step,
                   (res["tp"]["loss"], res["tp"]["grads"], res["tp"]["after"]))

    single = generate_packed(_system("MMF", FLAGSHIP, dev), masks,
                             num_timesteps=MESH_SAMPLE_STEPS, pack_width=width, batch_size=128,
                             seed=0).sample
    real = single.mask[..., 0] > 0
    for r, res in enumerate(ranks):
        s = res["sample"]
        err = float((s.continuous - single.continuous).abs().max())
        same = float((s.discrete[..., 0] == single.discrete[..., 0])[real].float().mean())
        print(f"sampling over 2 ranks (rank {r}): {len(s)} jets, continuous max_abs_err "
              f"{err:.3e} (atol 1e-4), tokens equal on {same:.4f} of real sites (>= 0.999)")
        if len(s) != len(single) or err > 1e-4 or same < 0.999:
            raise AssertionError("sampling over two ranks disagrees with one process")
    return dict(wall_s=wall, dp_loss=dp_loss, tp_loss=ranks[0]["tp"]["loss"],
                plain_loss=plain_step[0])


def mesh_phase(dev, train_ds, val_ds, out_dir):
    """The meshes: K1 / K2 at the TP shard shapes (held, timed), NCCL at
    world size 1 (plain, data parallel, FSDP2; the data mesh's captured
    step against its eager steps), then two ranks on the one card over gloo
    (data parallel, tensor parallel, sharded sampling)."""
    t0 = time.perf_counter()
    worst, tp_times = check_tp_shapes(dev)
    batch = _mesh_batch(train_ds)
    layouts, fsdp_fit, plain_step = nccl_world_one(dev, train_ds, val_ds, out_dir, batch)
    graph = mesh_graph_check(dev, train_ds)
    two = two_ranks_one_card(dev, plain_step, batch, out_dir)
    wall = time.perf_counter() - t0
    print(f"mesh phase: {wall:.1f} s")
    return worst, tp_times, dict(layouts=layouts, fsdp_fit=fsdp_fit, graph=graph,
                                 two_ranks=two, wall_s=wall)


# ------------------------------------------------------------------ bf16
#
# The bf16 compute path (compute_dtype="bfloat16"): the bf16 forms of K1
# and K2 against their bf16 plain versions, their times, and the flagship
# and co-occurrence MMF sampled and trained in bf16 at full width.

BF16 = torch.bfloat16
# a bf16 kernel against its bf16 plain version: both compute fp32 scores
# from the same bf16 inputs; the kernel rounds the unnormalised
# probabilities to bf16 where the plain version rounds the normalised ones,
# and both round the output: outputs of order 1 one or two bf16 ulp (2^-8
# relative) apart
BF16_ATOL, BF16_RTOL = 1e-2, 1e-2
# gradients: both sides recompute through the same bf16 plain version from
# the same inputs and a fixed upstream gradient (equal bit for bit on the
# card; the tolerance allows the backward's own atomics)
BF16_GRAD_ATOL, BF16_GRAD_RTOL = 1e-2, 1e-2
# the library call in bf16 against the bf16 plain version: a few ulp
BF16_LIBRARY_ATOL = 3e-2
# the bf16 sampler on the card against the port's bf16 sampler on the CPU,
# 8 steps on shared noise: cuBLAS and the CPU round the same bf16 products
# summed in another order, and K1 rounds its probabilities before the
# division: an activation may land one bf16 ulp apart and move the drift
# by that (3.7e-4 measured on an NVIDIA H100, PERF.md); a token may flip
# where a uniform falls in that rounding
BF16_SAMPLER_ATOL, BF16_TOKENS_EQUAL = 5e-3, 0.99
FLAGSHIP_BF16 = dict(FLAGSHIP, compute_dtype="bfloat16")
COOCC_BF16 = dict(COOCC, compute_dtype="bfloat16")
TRAIN_BF16 = dict(TRAIN, compute_dtype="bfloat16")
TRAIN_COOCC_BF16 = dict(TRAIN_COOCC, compute_dtype="bfloat16")
# the flagship's shapes (packed rows, the wide jets' key mask, the bucketed
# training batch), the tiling's edges (head size 9 and 36, T=33, scattered
# ids); K2 with an fp32 and a bf16 bias.  Then the edges of the TMA /
# wgmma core: T = 256 at head size 128, Tk not a multiple of its
# 64-key tiles (100, 150), an odd head size at T = 100, a (B, 1, T, T)
# pair bias that TMA reads (T = 128) and one it cannot (T = 150, rows of
# 600 bytes); a bias whose row stride misses TMA's 16-byte rule is
# BF16_STRIDED_BIAS
K1_BF16_CASES = [((128, 128, 128, 4), "segments"), ((128, 128, 256, 4), "segments"),
                 ((16, 150, 256, 4), "key_mask"), ((64, 48, 128, 4), "key_mask"),
                 ((8, 33, 128, 4), "segments"), ((16, 150, 36, 4), "key_mask"),
                 ((16, 128, 128, 4), "scattered"),
                 ((4, 256, 512, 4), "segments"), ((8, 100, 36, 4), "key_mask"),
                 ((4, 256, 512, 4), "key_mask")]
K2_BF16_CASES = [((128, 128, 128, 4), "bias_segments"), ((128, 128, 256, 4), "bias_segments"),
                 ((16, 150, 256, 4), "pair_mask_bias"), ((16, 128, 36, 4), "bias_segments"),
                 ((16, 128, 128, 4), "bias_scattered"),
                 ((4, 256, 512, 4), "bias_segments"), ((8, 100, 36, 4), "bias_scattered"),
                 ((16, 128, 256, 4), "pair_mask"), ((16, 150, 128, 4), "pair_mask")]
# head-major (B, H, Tq, Tk, Dh) with a (B, 1, Tq, Tk) bias: the CrossAttention
# shape, an odd head size with Tq != Tk both ways, head size 128 with Tk
# off the tiles, and a bias TMA reads (Tk = 128)
K2_BF16_HEAD_MAJOR = [(16, 4, 150, 64, 64), (8, 3, 20, 150, 9), (4, 2, 70, 130, 128),
                      (8, 4, 64, 128, 64)]
# the packed rows with a bias whose rows are 129 values apart (a view of a
# wider tensor): the kernel reads it per fragment from global memory
BF16_STRIDED_BIAS = (32, 128, 256, 4)


def _plan_of(q, k, v, H=None, bias=None) -> str:
    """The bf16 core's host plan of a call, for the record: which operands
    go by TMA, the shared memory, the ring's stages of the key tiles and
    the slices of the head."""
    views = [t if H is None else k2._heads(t, H) for t in (q, k, v)]
    bias4 = None
    if bias is not None:
        B, Hh, Tq, _ = views[0].shape
        bias4 = bias.expand(B, Hh, Tq, views[1].shape[2])
    plan = k2.bf16_plan(*views, bias4)
    return (f"[q/k/v {'TMA' if plan.qkv_tma else 'staged'}, bias "
            f"{'none' if bias is None else 'TMA' if plan.bias_tma else 'per fragment'}, "
            f"{plan.smem_bytes} B shared, {plan.stages} of {plan.key_tiles} key tiles, "
            f"{plan.slices} slice(s)]")


def check_bf16_kernels(dev) -> dict:
    """The bf16 forms of K1 (segments, key mask) and K2 (bias + segments,
    bias, key mask + bias, key mask; head-major with Tq != Tk and an odd
    head size) against their bf16 plain versions, and their gradients; each
    case prints the host plan it ran under, and both bias paths and both
    q/k/v paths must have run."""
    worst = {"K1": 0.0, "K2": 0.0}
    tol = dict(atol=BF16_ATOL, rtol=BF16_RTOL)
    plans = set()
    for shape, form in K1_BF16_CASES:
        q, k, v, km, seg, _, real = _case_inputs(shape, form, dev)
        q, k, v, H = q.to(BF16), k.to(BF16), v.to(BF16), shape[3]
        plan = _plan_of(q, k, v, H)
        worst["K1"] = max(worst["K1"], _held(
            f"K1 bf16 vs plain {shape} {form} {plan}", k1.btc_attention(q, k, v, H, km, seg),
            attention_btc_reference(q, k, v, H, km, seg), real, **tol))
    for shape, form in K2_BF16_CASES:
        q, k, v, km, seg, bias, real = _case_inputs(shape, form, dev)
        q, k, v, H = q.to(BF16), k.to(BF16), v.to(BF16), shape[3]
        for b in (bias, bias.to(BF16)):
            plan = _plan_of(q, k, v, H, b)
            plans.add(plan.split(", ")[1])
            worst["K2"] = max(worst["K2"], _held(
                f"K2 bf16 vs plain {shape} {form} bias {tuple(b.shape)} {b.dtype} {plan}",
                k2.set_attention_btc(q, k, v, H, km, b, seg),
                attention_btc_reference(q, k, v, H, km, seg, b), real, **tol))
    for shape in K2_BF16_HEAD_MAJOR:
        q, k, v, km, bias = _head_major_inputs(shape, True, dev)
        q, k, v = q.to(BF16), k.to(BF16), v.to(BF16)
        real = torch.ones(q.shape[:3], dtype=torch.bool, device=dev)
        for name, b in (("key_mask + (B,1,Tq,Tk) bias", bias), ("key_mask", None)):
            plan = _plan_of(q, k, v, None, b)
            plans.add(plan.split(", ")[0])
            worst["K2"] = max(worst["K2"], _held(
                f"K2 bf16 vs plain head-major {shape} {name} {plan}",
                k2.set_attention(q, k, v, km, b), attention_reference(q, k, v, km, b),
                real, **tol))
    q, k, v, _, seg, _, real = _case_inputs(BF16_STRIDED_BIAS, "bias_segments", dev)
    B, T, C, H = BF16_STRIDED_BIAS
    wide = torch.randn((B, H, T, T + 1), device=dev)
    q, k, v, b = q.to(BF16), k.to(BF16), v.to(BF16), wide[..., :T]
    plan = _plan_of(q, k, v, H, b)
    plans.add(plan.split(", ")[1])
    worst["K2"] = max(worst["K2"], _held(
        f"K2 bf16 vs plain {BF16_STRIDED_BIAS} bias rows {T + 1} apart + segments {plan}",
        k2.set_attention_btc(q, k, v, H, None, b, seg),
        attention_btc_reference(q, k, v, H, None, seg, b), real, **tol))
    paths = {"[q/k/v TMA", "[q/k/v staged", "bias TMA", "bias per fragment"}
    if not paths <= plans:
        raise AssertionError(f"the bf16 checks ran the paths {sorted(plans)}, not all of "
                             f"{sorted(paths)}")
    grad_tol = dict(atol=BF16_GRAD_ATOL, rtol=BF16_GRAD_RTOL)
    q, k, v, _, seg, _, _ = _case_inputs(TRAIN_K1_GRAD_SHAPE, "segments", dev, seed=4)
    up = torch.randn(q.shape, device=dev)
    _grads_held(f"K1 bf16 at the training batch {TRAIN_K1_GRAD_SHAPE} segments",
                [lambda a, b, c: k1.btc_attention(a, b, c, 4, None, seg),
                 lambda a, b, c: attention_btc_reference(a, b, c, 4, None, seg)],
                [t.to(BF16) for t in (q, k, v)], upstream=up, **grad_tol)
    q, k, v, _, seg, bias, _ = _case_inputs((85, 128, 128, 4), "bias_segments", dev, seed=6)
    up = torch.randn(q.shape, device=dev)
    _grads_held("K2 bf16 at the co-occurrence training batch (85, 128, 128, 4) bias + segments",
                [lambda a, b, c, d: k2.set_attention_btc(a, b, c, 4, None, d, seg),
                 lambda a, b, c, d: attention_btc_reference(a, b, c, 4, None, seg, d)],
                [q.to(BF16), k.to(BF16), v.to(BF16), bias], upstream=up, **grad_tol)
    return worst


def time_bf16_kernels(dev) -> dict:
    """{(kernel, shape): times} of the bf16 forms at the packed-row shapes:
    K1 in its segment form, K2 with a bf16 (B, H, T, T) bias + segments,
    each beside its bf16 plain version, scaled_dot_product_attention in
    bf16 with the same float mask (in bf16) and its bound: the bytes at 2
    an element (q, k, v, out and the bias of same-jet pairs) against the
    same-jet FLOPs at the dense bf16 rate."""
    result = {}
    with torch.no_grad():
        for shape in TIMED:
            q, k, v, _, seg, bias, real = _case_inputs(shape, "bias_segments", dev)
            q, k, v, bias, H = q.to(BF16), k.to(BF16), v.to(BF16), bias.to(BF16), shape[3]
            same = seg[:, None, :, None] == seg[:, None, None, :]
            pairs = int((same[:, 0] & real[:, :, None]).sum())
            cross = torch.where(same, 0.0, -1e9)
            forms = {
                "K1": ("segments, bf16", lambda: k1.btc_attention(q, k, v, H, None, seg),
                       lambda: attention_btc_reference(q, k, v, H, None, seg),
                       cross.to(BF16), 4 * seg.numel()),
                "K2": (f"bf16 bias {tuple(bias.shape)} + segments, bf16",
                       lambda: k2.set_attention_btc(q, k, v, H, None, bias, seg),
                       lambda: attention_btc_reference(q, k, v, H, None, seg, bias),
                       (bias.float() + cross).to(BF16), 4 * seg.numel() + 2 * H * pairs),
            }
            for name, (form, kernel, plain, mask, extra) in forms.items():
                library = _library_call(q, k, v, H, plain(), real, f"{name} bf16 {shape}",
                                        atol=BF16_LIBRARY_ATOL, attn_mask=mask)
                ms, plain_ms, library_ms = median_device_ms([kernel, plain, library])
                bound_ms, bound_by = _bound(q, pairs, extra)
                t = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
                _print_time(name, shape, form, t)
                result[name, shape] = t
    return result


def _jet_w1(a: MultiModal, b: MultiModal) -> dict:
    """W1 between two samples of the same jets: pT, eta and phi over the real
    particles, and the per-jet flavor multiplicity (tokens > 0)."""
    from multimodal_flows_tpu_torch.utils.metrics import flavor_multiplicities, wasserstein1d

    real = a.mask[..., 0].cpu().numpy() > 0
    xa, xb = a.continuous.cpu().numpy()[real], b.continuous.cpu().numpy()[real]
    w1 = {name: wasserstein1d(xa[:, i], xb[:, i]) for i, name in enumerate(("pt", "eta", "phi"))}
    w1["multiplicity"] = wasserstein1d(flavor_multiplicities(a)["multiplicity"],
                                       flavor_multiplicities(b)["multiplicity"])
    return w1


def bf16_loss_drift(dev, train_ds) -> dict:
    """The flagship's packed training loss in bf16 and in fp32 on the card,
    the same weights, batch and bridge states: the relative drift."""
    losses = {}
    for name, cfg_kw in (("fp32", TRAIN), ("bf16", TRAIN_BF16)):
        cfg = Config(**cfg_kw)
        system = build_system(cfg, "MMF", device=dev, generator=torch.Generator().manual_seed(0))
        batch = _first_batch(Trainer(system, cfg), train_ds)
        t_jets, states, drift = _bridge_states(batch, cfg.time_eps)
        b = batch.to(dev)
        state = MultiModal(**{f: torch.from_numpy(a) for f, a in states.items()}).to(dev)
        with torch.no_grad():
            out = system.module.packed_training_loss(
                state, torch.from_numpy(drift).to(dev), b.discrete,
                torch.from_numpy(t_jets).to(dev), b.segments, b.jet_valid)
        losses[name] = float(out[0])
    rel = abs(losses["bf16"] - losses["fp32"]) / abs(losses["fp32"])
    print(f"flagship packed training loss, bf16 {losses['bf16']:.7f} vs fp32 "
          f"{losses['fp32']:.7f}: relative drift {rel:.3e}")
    if not np.isfinite(losses["bf16"]):
        raise AssertionError("the bf16 training loss is not finite")
    return dict(losses, relative_drift=rel)


def bf16_phase(dev, mult, fp32_sample, train_ds):
    """The bf16 compute path at the flagship's width, each path driven with
    the counts set to 0 just before it and read just after: `generate_packed`
    of the flagship MMF (the bf16 K1, both forms) on the jets and noise of
    the fp32 run, its samples' W1 against the fp32 samples; the bf16
    sampler against the port's bf16 CPU sampler; the packed train step on a
    fixed batch (the loss falls, the bf16 K1 16 launches a forward) and its
    time; the loss's bf16 drift; the co-occurrence MMF sampled and trained 5
    steps (the bf16 K2).  No fp32 kernel may launch."""
    t0 = time.perf_counter()
    res = {}
    only_bf16 = lambda l: _total(l["K1"]) + _total(l["K2"]) == 0  # noqa: E731

    flagship = _system("MMF", FLAGSHIP_BF16, dev)
    launches, gen = drive(
        "flagship MMF bf16", flagship, mult, SAMPLING_STEPS,
        lambda l1, l2: ("did not run both bf16 K1 forms" if not (l1["segments"] and l1["key_mask"])
                        else "launched the bf16 K2" if _total(l2) else ""),
        counters=("K1_bf16", "K2_bf16"))
    if not only_bf16(launches):
        raise AssertionError("flagship MMF bf16: an fp32 kernel ran")
    res["sampling"] = dict(launches_k1=_total(launches["K1_bf16"]), wall_s=gen.wall_time_s,
                           jets_per_s=gen.jets_per_sec,
                           w1_vs_fp32=_jet_w1(gen.sample, fp32_sample))
    print(f"flagship MMF bf16 samples vs fp32 on the same noise: W1 {res['sampling']['w1_vs_fp32']}")
    res["sampler_vs_cpu"] = sampler_vs_cpu("flagship MMF bf16", flagship, FLAGSHIP_BF16, dev,
                                           atol=BF16_SAMPLER_ATOL, tokens_equal=BF16_TOKENS_EQUAL)
    del flagship

    trainer, state, train_launches = fit_fixed_batch(dev, train_ds, steps=5,
                                                     name="flagship MMF bf16", cfg_kw=TRAIN_BF16)
    blocks = 2 * FLAGSHIP["n_layer"] + FLAGSHIP["n_layer_fused"]
    if train_launches["K1_bf16"] != {"segments": 5 * blocks, "key_mask": 0, "none": 0} \
            or not only_bf16(train_launches):
        raise AssertionError(f"flagship bf16 training: the bf16 K1 did not run {blocks} times "
                             f"a forward in its segment form, or an fp32 kernel ran")
    res["train_step"] = time_training(dev, trainer, state, train_ds, label="flagship MMF, bf16")
    res["launches_training"] = _total(train_launches["K1_bf16"])
    del trainer, state
    res["loss_drift"] = bf16_loss_drift(dev, train_ds)

    coocc = _system("MMF", COOCC_BF16, dev)
    coocc_launches, _ = drive(
        "co-occurrence MMF bf16", coocc, mult, SAMPLING_STEPS,
        lambda l1, l2: ("did not run the bf16 K2 as bias + segments and as bias"
                        if not (l2["bias_segments"] and l2["bias"])
                        else "launched the bf16 K1" if _total(l1) else ""),
        counters=("K1_bf16", "K2_bf16"))
    if not only_bf16(coocc_launches):
        raise AssertionError("co-occurrence MMF bf16: an fp32 kernel ran")
    del coocc
    coocc_train = train_coocc(dev, train_ds, cfg_kw=TRAIN_COOCC_BF16, k2_counter="K2_bf16")
    res["coocc_launches"] = _total(coocc_launches["K2_bf16"])
    res["coocc_launches_training"] = _total(coocc_train["K2_bf16"])
    res["wall_s"] = time.perf_counter() - t0
    print(f"bf16 phase: {res['wall_s']:.1f} s")
    return res


# ------------------------------------------------------------------ wide
#
# The kernels past 256 keys and past a head size of 128 (`wide_phase`):
# the fp32 core's key tiles under per-window need masks and its sliced form
# (a block a slice of 128 output columns), the bf16 core's ring of stages
# and its sliced form, each form against its plain version on the card;
# then the slice at those shapes at the flagship's width: bucketed
# sampling at D = 300, packed rows of 512 (sampling and a train step), the
# co-occurrence MMF at D = 300, GPT at max_num_particles 300 (sequences of
# 302), the flagship at one head (head sizes 128 and 256), the bf16 forms,
# and both entry points at `--max_num_particles 300 --pack_width 512`.

WIDE_D, WIDE_PACK = 300, 512
# (B, Tq, Tk, C, H, form): K1 in its key-mask and segment forms, K2 with a
# bias (+ segments or key mask), causal (+ key mask), the decode's key-mask
# form at Tq = 1, and head-major (CrossAttention, a (B, 1, Tq, Tk) bias)
WIDE_CASES = (
    [(8, T, T, 256, 4, f) for T in (257, 300) for f in ("key_mask", "segments")]
    + [(8, 302, 302, 256, 4, "key_mask"), (4, 512, 512, 256, 4, "segments"),
       (4, 512, 512, 256, 4, "key_mask"), (2, 1024, 1024, 256, 4, "segments"),
       (2, 1024, 1024, 256, 4, "key_mask"), (1, 2048, 2048, 256, 4, "segments"),
       (1, 2048, 2048, 256, 4, "key_mask"), (1, 2048, 2048, 64, 1, "segments"),
       (8, 300, 300, 272, 2, "key_mask"), (8, 300, 300, 272, 2, "segments"),
       (8, 300, 300, 320, 2, "segments"), (8, 300, 300, 256, 1, "key_mask"),
       (8, 300, 300, 256, 1, "segments"), (4, 300, 300, 512, 1, "key_mask"),
       (4, 257, 257, 512, 1, "segments")]
    + [(8, T, T, 256, 4, f) for T in (300, 302) for f in ("bias_segments", "bias", "bias_key_mask")]
    + [(4, 512, 512, 256, 4, "bias_segments"), (8, 300, 300, 320, 2, "bias_segments"),
       (4, 300, 300, 512, 1, "bias"), (8, 300, 300, 272, 2, "bias_key_mask"),
       (8, 257, 257, 256, 4, "causal"), (8, 302, 302, 256, 4, "causal_key_mask"),
       (2, 1024, 1024, 256, 4, "causal"), (4, 302, 302, 256, 1, "causal"),
       (64, 1, 257, 256, 4, "decode"), (64, 1, 302, 256, 4, "decode"),
       (16, 1, 302, 512, 2, "decode"), (4, 20, 300, 256, 4, "head_major"),
       (2, 20, 512, 320, 2, "head_major")])
# the bf16 forms: the bias fp32 where its rows meet TMA's rule (T % 4 ==
# 0), bf16 otherwise; head sizes 36 and 140 stage q/k/v in the kernel (in
# the ring and in slices)
WIDE_BF16_CASES = [
    (8, 300, 300, 256, 4, "key_mask"), (8, 300, 300, 256, 4, "segments"),
    (4, 512, 512, 256, 4, "segments"), (1, 2048, 2048, 256, 4, "segments"),
    (2, 1024, 1024, 144, 4, "key_mask"), (8, 300, 300, 256, 1, "key_mask"),
    (8, 300, 300, 280, 2, "segments"), (4, 300, 300, 512, 1, "segments"),
    (8, 300, 300, 256, 4, "bias_segments"), (8, 302, 302, 256, 4, "bias_segments"),
    (8, 300, 300, 256, 4, "bias_key_mask"), (2, 1024, 1024, 256, 4, "bias"),
    (8, 300, 300, 320, 2, "bias_segments"), (64, 1, 302, 256, 4, "decode"),
    (4, 20, 300, 256, 4, "head_major")]
# fp32 gradients (q, k, v and a bias's) through each wide form's backward
WIDE_GRAD_CASES = [(4, 512, 512, 256, 4, "segments"), (4, 300, 300, 256, 1, "key_mask"),
                   (4, 300, 300, 256, 4, "bias"), (4, 302, 302, 256, 4, "causal"),
                   (4, 300, 300, 320, 2, "bias_segments")]
WIDE_BF16_GRAD_CASE = (4, 512, 512, 256, 4, "segments")
WIDE_FLAGSHIP = dict(FLAGSHIP, max_num_particles=WIDE_D)
WIDE_COOCC = dict(WIDE_FLAGSHIP, use_coocurrence=True)
WIDE_TRAIN = dict(TRAIN, max_num_particles=WIDE_D, pack_width=WIDE_PACK)
WIDE_ONE_HEAD = dict(FLAGSHIP, n_head=1)  # head sizes 128 (half-width blocks) and 256
WIDE_CLI_ARGV = ["--packed_training", "--pack_width", str(WIDE_PACK), "--max_num_particles",
                 str(WIDE_D), "--max_epochs", "2", "--train_frac", "0.8"]
WIDE_GPT_ARGV = ["--system", "GPT", "--max_num_particles", str(WIDE_D)]
WIDE_GPT_ROWS = 4


def _wide_case(case, dev, dtype=torch.float32, seed=0):
    """One wide case: (kernel, plain, sdpa kwargs, token-major plain output,
    rows compared, q, k, v, bias or None, the bound's pairs and extra
    bytes).  The key mask leaves 2..Tk keys a row (the decode: keys <= a
    position), the segments are packed jets of Poisson(40) multiplicity."""
    B, Tq, Tk, C, H, form = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    q = torch.randn((B, Tq, C), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((B, Tk, C), generator=gen, device=dev).to(dtype) for _ in range(2))
    km = seg = bias = pbias = None
    rows = torch.ones((B, Tq), dtype=torch.bool, device=dev)
    keys = torch.ones((B, Tk), dtype=torch.bool, device=dev)
    if "key_mask" in form or form in ("decode", "head_major"):
        n = torch.from_numpy(rng.integers(2, Tk + 1, size=B)).to(dev)
        keys = torch.arange(Tk, device=dev)[None, :] < n[:, None]
        km = torch.where(keys, 0.0, -1e9).to(torch.float32)
    if "segments" in form:
        seg = torch.from_numpy(_packed_segments(B, Tq, rng)).to(dev)
        rows = seg >= 0
    if form.startswith("bias") or form == "head_major":
        bias_dtype = BF16 if dtype == BF16 and Tk % 4 else torch.float32
        heads = 1 if form == "head_major" else H
        bias = pbias = torch.randn((B, heads, Tq, Tk), generator=gen, device=dev).to(bias_dtype)
    causal = form.startswith("causal")
    if causal:
        pbias = attention.causal_bias(Tq, dev)
    same = torch.ones((B, Tq, Tk), dtype=torch.bool, device=dev)
    if seg is not None:
        same = seg[:, :, None] == seg[:, None, :]
    pair = same & keys[:, None, :] & rows[:, :, None]
    if causal:
        pair &= torch.ones((Tq, Tk), dtype=torch.bool, device=dev).tril()[None]
    mask = torch.zeros((B, 1, Tq, Tk), device=dev)
    if km is not None:
        mask = mask + km[:, None, None, :]
    if pbias is not None:
        mask = mask + pbias.float()
    if seg is not None:
        mask = torch.where(same[:, None], mask, -1e9)
    sdpa = dict(is_causal=True) if form == "causal" else dict(attn_mask=mask.to(dtype))
    ref_btc = attention_btc_reference(q, k, v, H, km, seg, pbias)
    if form in ("key_mask", "segments"):
        kernel = lambda: k1.btc_attention(q, k, v, H, km, seg)  # noqa: E731
        plain = lambda: attention_btc_reference(q, k, v, H, km, seg)  # noqa: E731
    elif form == "head_major":
        qh, kh, vh = (t.view(B, t.shape[1], H, C // H).transpose(1, 2) for t in (q, k, v))
        kernel = lambda: k2.set_attention(qh, kh, vh, km, bias)  # noqa: E731
        plain = lambda: attention_reference(qh, kh, vh, km, bias)  # noqa: E731
    elif causal:
        kernel = lambda: k2.set_attention_btc(q, k, v, H, km, causal=True)  # noqa: E731
        plain = lambda: attention_btc_reference(q, k, v, H, km, None, pbias)  # noqa: E731
    else:
        kernel = lambda: k2.set_attention_btc(q, k, v, H, km, bias, seg)  # noqa: E731
        plain = lambda: attention_btc_reference(q, k, v, H, km, seg, bias)  # noqa: E731
    pairs = int(pair.sum())
    es = q.element_size()
    extra = 4 * B * Tk * (km is not None) + 4 * B * Tq * (seg is not None)
    if bias is not None:
        extra += bias.element_size() * (H if bias.shape[1] == H else 1) * pairs
    needed_keys = int(keys.sum()) if form == "decode" else B * Tk
    nbytes = es * (2 * q.numel() + 2 * needed_keys * C) + extra
    return dict(kernel=kernel, plain=plain, sdpa=sdpa, ref_btc=ref_btc, rows=rows, q=q, k=k, v=v,
                bias=bias, km=km, seg=seg, pairs=pairs, nbytes=nbytes, flops=4 * C * pairs)


def _wide_name(case, dtype=torch.float32):
    B, Tq, Tk, C, H, form = case
    tag = "K1" if form in ("key_mask", "segments") else "K2"
    return (f"{tag}{' bf16' if dtype == BF16 else ''} {form} B={B} Tq={Tq} Tk={Tk} C={C} H={H} "
            f"(head size {C // H})")


def check_wide_kernels(dev) -> dict:
    """Every wide case against its plain version (fp32 within ATOL / RTOL,
    bf16 within BF16_ATOL / BF16_RTOL), the gradients of the fp32 forms
    within GRAD_ATOL and of one bf16 form; each case prints its plan: the
    bf16 ring that wraps, the slices and the staged q/k/v in both, and the
    fp32 forms with and without key splits, in slices and whole, must have
    run.  Returns the worst errors by kernel and dtype."""
    worst = {"K1": 0.0, "K2": 0.0, "K1_bf16": 0.0, "K2_bf16": 0.0}
    seen = set()
    for dtype, cases, tol in ((torch.float32, WIDE_CASES, dict(atol=ATOL, rtol=RTOL)),
                              (BF16, WIDE_BF16_CASES, dict(atol=BF16_ATOL, rtol=BF16_RTOL))):
        for case in cases:
            c = _wide_case(case, dev, dtype)
            name = _wide_name(case, dtype)
            if dtype == BF16:
                plan = _plan_of(c["q"], c["k"], c["v"], case[4], c["bias"])
                name += f" {plan}"
                stages, tiles = (int(x) for x in plan.split(" key tiles")[0].split(", ")[-1]
                                 .split(" of "))
                slices = int(plan.split(" slice")[0].split(", ")[-1])
                staged = "staged" in plan
                seen |= {("ring" if stages < tiles else "resident", staged),
                         ("slices" if slices > 1 else "whole head", staged)}
            else:
                plan = k2.fp32_plan(*(k2._heads(t, case[4]) for t in (c["q"], c["k"], c["v"])))
                name += (f" [{plan.splits} key split(s), {plan.slices} slice(s), "
                         f"{plan.stages} stages]")
                seen |= {"split" if plan.splits > 1 else "unsplit",
                         "slices" if plan.slices > 1 else "whole head"}
            out, ref = c["kernel"](), c["plain"]()
            rows = c["rows"] if case[-1] != "head_major" else torch.ones(
                out.shape[:3], dtype=torch.bool, device=dev)
            key = ("K1" if case[-1] in ("key_mask", "segments") else "K2") + (
                "_bf16" if dtype == BF16 else "")
            worst[key] = max(worst[key], _held(f"{name} vs plain", out, ref, rows, **tol))
    need = {("ring", False), ("ring", True), ("slices", False), ("slices", True), "split",
            "unsplit", "slices", "whole head"}
    if not need <= seen:
        raise AssertionError(f"the wide checks ran {sorted(seen, key=str)}, not all of "
                             f"{sorted(need, key=str)}")
    for case in WIDE_GRAD_CASES:
        c = _wide_case(case, dev, seed=1)
        B, Tq, Tk, C, H, form = case
        km, seg = c["km"], c["seg"]
        if form in ("key_mask", "segments"):
            fns = [lambda a, b_, d: k1.btc_attention(a, b_, d, H, km, seg),
                   lambda a, b_, d: attention_btc_reference(a, b_, d, H, km, seg)]
            leaves = [c["q"], c["k"], c["v"]]
        elif form == "causal":
            cb = attention.causal_bias(Tq, dev)
            fns = [lambda a, b_, d: k2.set_attention_btc(a, b_, d, H, km, causal=True),
                   lambda a, b_, d: attention_btc_reference(a, b_, d, H, km, None, cb)]
            leaves = [c["q"], c["k"], c["v"]]
        else:
            fns = [lambda a, b_, d, e: k2.set_attention_btc(a, b_, d, H, km, e, seg),
                   lambda a, b_, d, e: attention_btc_reference(a, b_, d, H, km, seg, e)]
            leaves = [c["q"], c["k"], c["v"], c["bias"]]
        _grads_held(_wide_name(case), fns, leaves)
    c = _wide_case(WIDE_BF16_GRAD_CASE, dev, BF16, seed=2)
    H, seg = WIDE_BF16_GRAD_CASE[4], c["seg"]
    up = torch.randn(c["q"].shape, device=dev)
    _grads_held(_wide_name(WIDE_BF16_GRAD_CASE, BF16),
                [lambda a, b_, d: k1.btc_attention(a, b_, d, H, None, seg),
                 lambda a, b_, d: attention_btc_reference(a, b_, d, H, None, seg)],
                [c["q"], c["k"], c["v"]], upstream=up, atol=BF16_GRAD_ATOL, rtol=BF16_GRAD_RTOL)
    return worst


def time_wide_kernels(dev) -> dict:
    """{name: times} of every wide case: the kernel, its plain version and
    scaled_dot_product_attention (the equivalent float mask, `is_causal`
    for the causal form without a key mask) as device time, median of 40 in
    turns, and the bound: q and the output, the keys this data needs (every
    key; the decode's up to its position) of k and v, the key mask, the ids
    and the bias of the needed pairs at the HBM rate, against QK^T and PV
    over the needed pairs at the kernel's tensor-core rate."""
    result = {}
    with torch.no_grad():
        for dtype, cases in ((torch.float32, WIDE_CASES), (BF16, WIDE_BF16_CASES)):
            for case in cases:
                c = _wide_case(case, dev, dtype, seed=3)
                name = _wide_name(case, dtype)
                B, Tq, Tk, C, H, form = case
                library = _library_call(c["q"], c["k"], c["v"], H, c["ref_btc"], c["rows"], name,
                                        atol=BF16_LIBRARY_ATOL if dtype == BF16 else 1e-4,
                                        **c["sdpa"])
                ms, plain_ms, library_ms = median_device_ms([c["kernel"], c["plain"], library])
                rate = BF16_FLOP_PER_S if dtype == BF16 else KERNEL_FLOP_PER_S
                bound_ms, bound_by = _roofline(c["nbytes"], c["flops"], rate)
                t = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
                if dtype == torch.float32:
                    t["plan"] = _fp32_plan(c["q"], c["k"], c["v"], H)
                _print_time(name.split(" ")[0], case[:5], " ".join(name.split(" ")[1:]), t)
                result[name] = t
    return result


def _counted(fn, model_cls=particle_transformers.ParticleFormer):
    """(fn's result, the launch counts, the forwards of `model_cls`) with
    the counts set to 0 just before fn and read just after."""
    profiling.take_counters()
    with _Forwards(model_cls) as forwards:
        out = fn()
        torch.cuda.synchronize()
    return out, _counts(), forwards.count


def _expect(name, launches, want, k1_per_forward=0, forwards=0):
    """`want`: {counter: {form: n}} that must equal the counts (the other
    counters 0, no plain dropout call); `k1_per_forward` K1 launches (of the
    run's dtype) a forward of the encoder, where given."""
    zero = {c: {f: 0 for f in launches[c]} for c in launches}
    expected = {c: dict(zero[c], **want.get(c, {})) for c in launches}
    for c, forms in want.items():
        for f, n in forms.items():
            if n is None:  # some, not counted here
                expected[c][f] = launches[c][f] if launches[c][f] > 0 else 1
    print(f"{name}: launches {launches}")
    if launches != expected:
        raise AssertionError(f"{name}: launches {launches}, expected {expected}")
    if k1_per_forward:
        total = _total(launches["K1"]) + _total(launches["K1_bf16"])
        if total != k1_per_forward * forwards:
            raise AssertionError(f"{name}: {total} K1 launches for {forwards} forwards, not "
                                 f"{k1_per_forward} a forward")


def _wide_gpt(dev, out_dir) -> dict:
    """GPT at max_num_particles 300 (sequences of 302) at the CLI's widths:
    the full forward's logits, the loss and every parameter gradient on
    the card against the CPU, the KV-cached decode against the full forward
    and greedy / Gumbel generation against the CPU; K2's causal form
    n_layer launches a forward, its key-mask form n_layer a decode step."""
    from multimodal_flows_tpu_torch.models.gpt import FlavorSeqGPT

    cfg, _ = train_mmf.experiment_configs(WIDE_GPT_ARGV + ["--dir", out_dir])
    rng = np.random.default_rng(23)
    mult = np.concatenate([[WIDE_D], rng.integers(150, WIDE_D + 1, size=3 * WIDE_GPT_ROWS)])
    x, tok, mask = _physical_jets(rng, mult, WIDE_D)
    train_ds, _ = train_mmf.split_jets(MultiModal(continuous=x, discrete=tok, mask=mask), cfg,
                                       "GPT")
    system = train_mmf.build_trainer(cfg, "GPT", dev).system
    cpu = build_system(cfg, "GPT", device="cpu", generator=torch.Generator().manual_seed(0))
    cpu.module.load_state_dict({k: v.cpu() for k, v in system.module.state_dict().items()})
    T, n_layer = system.module.seq_len, cfg.n_layer
    ids = torch.from_numpy(train_ds.coupling.target.discrete[:WIDE_GPT_ROWS]).to(dev)
    batch = DataCoupling(target=MultiModal(discrete=ids.cpu()))
    res = {"shape": f"{len(ids)} sequences of {T}"}
    grads, losses = {}, {}
    for side, s in (("card", system), ("cpu", cpu)):
        s.module.zero_grad()
        (loss, _), launches, forwards = _counted(
            lambda: s.loss_fn(batch.to(s.device), train=False), FlavorSeqGPT)
        loss.backward()
        losses[side] = loss.item()
        grads[side] = {n: p.grad.cpu() for n, p in s.module.named_parameters()}
        if side == "card":
            _expect(f"GPT at {T} tokens, the loss's forward", launches,
                    {"K2": {"causal": n_layer * forwards}})
            res["launches_loss"] = launches["K2"]
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    worst = max(float(((grads["card"][n] - g).abs() / (TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL
                                                        * g.abs())).max())
                for n, g in grads["cpu"].items())
    print(f"GPT at {T} tokens card vs CPU: loss rel err {rel:.3e} (<= {GPT_LOSS_RTOL}); "
          f"gradients worst |diff| / (atol {TRAIN_GRAD_ATOL} + rtol {TRAIN_GRAD_RTOL} |g|) = "
          f"{worst:.3f} (<= 1)")
    if rel > GPT_LOSS_RTOL or worst > 1.0:
        raise AssertionError("GPT at 302 tokens: the loss or its gradients disagree with the CPU")
    with torch.no_grad():
        full = system.module(ids)

        def decode():
            caches, out = system.module.init_cache(len(ids)), []
            for t in range(T):
                logits, caches = system.module.decode(ids[:, t], t, caches)
                out.append(logits)
            return torch.stack(out, 1)

        steps, launches, _ = _counted(decode)
    _expect(f"GPT decode over {T} positions", launches, {"K2": {"key_mask": n_layer * T}})
    err = float((steps - full).abs().max())
    print(f"GPT decode vs the full forward at {T} positions: max_abs_err {err:.3e} (atol "
          f"{GPT_DECODE_ATOL})")
    if err > GPT_DECODE_ATOL:
        raise AssertionError("GPT at 302 tokens: the decode disagrees with the full forward")
    res.update(loss_rel_err=rel, grad_worst=worst, decode_vs_full=err,
               card_vs_cpu=_gpt_card_vs_cpu(dev, system, cpu, ids.cpu()),
               launches_decode=launches["K2"])
    return res


def _wide_models(dev) -> dict:
    """The slice at the wide shapes, the flagship's width, each path held
    against the CPU and its launch counts read: K1 or K2 serve every
    forward attention, no plain forward runs on the card."""
    blocks = 2 * FLAGSHIP["n_layer"] + FLAGSHIP["n_layer_fused"]
    res = {}
    runs = [
        ("bucketed sampling at D = 300", "MMF", WIDE_FLAGSHIP,
         dict(width=WIDE_D, packed=False), {"K1": {"key_mask": None}}, blocks),
        ("packed sampling on rows of 512", "MMF", WIDE_FLAGSHIP,
         dict(width=WIDE_PACK, packed=True, rows=4), {"K1": {"segments": None}}, blocks),
        ("co-occurrence MMF at D = 300", "MMF", WIDE_COOCC,
         dict(width=WIDE_D, packed=False), {"K2": {"bias": None}}, 0),
        ("co-occurrence MMF on rows of 512", "MMF", WIDE_COOCC,
         dict(width=WIDE_PACK, packed=True, rows=4), {"K2": {"bias_segments": None}}, 0),
        ("flagship at one head (head sizes 128 and 256)", "MMF", WIDE_ONE_HEAD,
         dict(width=128, packed=True), {"K1": {"segments": None}}, blocks),
        ("bf16 bucketed sampling at D = 300", "MMF", dict(WIDE_FLAGSHIP, compute_dtype="bfloat16"),
         dict(width=WIDE_D, packed=False, atol=BF16_SAMPLER_ATOL, tokens_equal=BF16_TOKENS_EQUAL),
         {"K1_bf16": {"key_mask": None}}, blocks),
        ("bf16 packed sampling on rows of 512", "MMF",
         dict(WIDE_FLAGSHIP, compute_dtype="bfloat16"),
         dict(width=WIDE_PACK, packed=True, rows=4, atol=BF16_SAMPLER_ATOL,
              tokens_equal=BF16_TOKENS_EQUAL), {"K1_bf16": {"segments": None}}, blocks),
    ]
    for name, kind, cfg_kw, kw, want, per_forward in runs:
        system = _system(kind, cfg_kw, dev)
        err, launches, forwards = _counted(
            lambda: sampler_vs_cpu(f"wide: {name}", system, cfg_kw, dev, steps=4, **kw))
        # the CPU side's forwards are counted too, and launch nothing
        _expect(f"wide: {name}", launches, want, per_forward, forwards // 2)
        res[name] = dict(err=err, launches=launches)
        del system
    rng = np.random.default_rng(29)
    launches = train_card_vs_cpu(dev, _split_dataset(rng, _wide_mult(rng, 512), WIDE_D)[0],
                                 WIDE_TRAIN)
    k1_card = launches["K1"]["segments"]
    print(f"wide: a packed train step on rows of 512: launches {launches}")
    if not k1_card or _total(launches["K2"]) or _total(launches["plain_dropout"]) or \
            k1_card != _total(launches["K1"]):
        raise AssertionError("wide: the packed train step on rows of 512 did not run K1's "
                             "segment form alone")
    res["packed train step on rows of 512"] = dict(launches=launches)
    return res


def _wide_mult(rng, n):
    """n multiplicities of AOJ-like jets, a quarter of them wide (150-300)."""
    return np.concatenate([_multiplicities(rng, n - n // 4, WIDE_D),
                           rng.integers(150, WIDE_D + 1, size=n // 4)])


def _wide_entry_points(dev, out_dir) -> dict:
    """`cli.train_mmf` at `--max_num_particles 300 --pack_width 512` (2 packed
    epochs on synthetic jets) and `cli.sample_mmf` on its checkpoint: their
    compute halves, K1 16 launches a forward in both (segments on rows of
    512 in training; segments on rows of 128 and the key-mask form at the
    full width of 300 in sampling, as the sampling entry point packs), K2
    and plain dropout calls 0."""
    blocks = 2 * FLAGSHIP["n_layer"] + FLAGSHIP["n_layer_fused"]
    rng = np.random.default_rng(31)
    x, k, mask = _physical_jets(rng, _wide_mult(rng, 384), WIDE_D)
    metadata = extract_metadata(x, mask)
    mean, std = (np.asarray(metadata[m], np.float32) for m in ("mean", "std"))
    jets = MultiModal(continuous=((x - mean) / std * mask).astype(np.float32), discrete=k,
                      mask=mask)
    cfg, _ = train_mmf.experiment_configs(WIDE_CLI_ARGV + ["--dir", out_dir])
    cfg.metadata = metadata
    cfg.mint_experiment_id()
    train_ds, val_ds = train_mmf.split_jets(jets, cfg)
    (_, state), launches, forwards = _counted(
        lambda: train_mmf.train(cfg, "MMF", train_ds, val_ds, device=dev))
    _expect("wide: cli.train_mmf.train at D = 300, rows of 512", launches,
            {"K1": {"segments": None}}, blocks, forwards)
    records = [json.loads(line) for line in open(os.path.join(cfg.experiment_dir,
                                                              "metrics.jsonl"))]
    if len(records) != cfg.max_epochs or not all(np.isfinite(r["val_loss"]) for r in records):
        raise AssertionError("wide: the training entry point did not log finite epochs")
    cfg.num_jets = 96
    tx, tk, tmask = _physical_jets(rng, _wide_mult(rng, 256), WIDE_D)
    results, s_launches, s_forwards = _counted(lambda: sample_mmf.sample(
        cfg, "MMF", tmask, dev, checkpoint="best", temperatures=[1.0], timestep_grid=[4],
        save=False))
    _expect("wide: cli.sample_mmf.sample at D = 300", s_launches,
            {"K1": {"segments": None, "key_mask": None}}, blocks, s_forwards)
    s = results[-1].sample
    if s.continuous.shape != (cfg.num_jets, WIDE_D, 3) or not torch.isfinite(
            s.continuous).all() or not ((s.discrete >= 0) & (s.discrete < cfg.vocab_size)).all():
        raise AssertionError("wide: the sampling entry point's jets are malformed")
    point = sample_mmf.point_metrics(s, MultiModal(continuous=tx, discrete=tk, mask=tmask), cfg,
                                     {"num_timesteps": 4, "temperature": 1.0})
    print(f"wide: entry points at D = 300, rows of 512: {state.step} steps, {forwards} forwards "
          f"in training, {s_forwards} in sampling; W1 multiplicity "
          f"{point['w1_flavor']['multiplicity']:.3f}")
    return dict(train_launches=launches, sample_launches=s_launches, train_steps=state.step)


def wide_phase(dev, out_dir) -> dict:
    """The kernels at every wide shape against their plain versions, their
    times, the slice at the wide shapes and both entry points; every
    failure fails the run."""
    t0 = time.perf_counter()
    res = {"max_abs_err": check_wide_kernels(dev), "times": time_wide_kernels(dev)}
    res["models"] = _wide_models(dev)
    res["gpt"] = _wide_gpt(dev, out_dir)
    res["entry_points"] = _wide_entry_points(dev, out_dir)
    res["wall_s"] = time.perf_counter() - t0
    print(f"wide phase: {res['wall_s']:.1f} s")
    return res


def _system(kind, cfg_kw, dev):
    system = build_system(Config(**cfg_kw), kind, device=dev,
                          generator=torch.Generator().manual_seed(0))
    if hasattr(system.module, "lambda_u"):  # initialised to 0, which turns the bias off
        with torch.no_grad():
            system.module.lambda_u.fill_(LAMBDA_U)
    return system


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    return found or str(Path(cuda_build._nvcc()).with_name("cuobjdump"))


def _tensor_core_counts(so: Path) -> dict:
    """{kernel symbol: {"HMMA": n, "HGMMA": n}}: the tensor-core
    instructions of each function in a library's device code, HMMA
    (`mma.sync`) and HGMMA (`wgmma`)."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout.splitlines()
    counts, symbol = {}, None
    for line in sass:
        if "Function : " in line:
            symbol = line.split("Function : ")[1].strip()
            counts[symbol] = {"HMMA": 0, "HGMMA": 0}
        elif symbol is not None:
            for op in ("HMMA", "HGMMA"):
                counts[symbol][op] += f" {op}." in line
    return counts


def _check_tensor_cores(name: str, counts: dict) -> None:
    """Every attention kernel of a library runs its products on `wgmma`:
    each fp32 form (`attention_kernel_tf32`, 3xTF32) and each bf16 form
    (`attention_kernel_bf16*`) shows HGMMA and no HMMA, both kinds are
    there, and no function of the library has an HMMA."""
    kinds = {"fp32": "attention_kernel_tf32", "bf16": "attention_kernel_bf16"}
    for kind, stem in kinds.items():
        forms = {sym: c for sym, c in counts.items() if stem in sym}
        print(f"{name} {kind}: {len(forms)} kernels, HGMMA "
              f"{sorted(c['HGMMA'] for c in forms.values())}, HMMA "
              f"{sum(c['HMMA'] for c in forms.values())}")
        if not forms or any(c["HMMA"] or not c["HGMMA"] for c in forms.values()):
            raise AssertionError(f"{name}: the {kind} forms do not all run on wgmma alone: {forms}")
    stray = {sym: c for sym, c in counts.items() if c["HMMA"]}
    if stray:
        raise AssertionError(f"{name}: mma.sync (HMMA) in {sorted(stray)}")


def _build_all() -> dict:
    """Build both kernels at once, one nvcc each; print the reports and
    each library's tensor-core instructions by kernel symbol, and fail
    unless every fp32 and bf16 form shows HGMMA and none HMMA.  Returns the
    build seconds by kernel."""
    def timed(mod):
        t0 = time.perf_counter()
        mod.build()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        seconds = list(pool.map(timed, (k1, k2)))
    for name, mod, s in (("K1", k1, seconds[0]), ("K2", k2, seconds[1])):
        print(f"{name} build: {s:.2f} s ({mod.library_path().name})")
        log = mod.library_path().with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())
        _check_tensor_cores(name, _tensor_core_counts(mod.library_path()))
    return {"K1": seconds[0], "K2": seconds[1]}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    build_s = _build_all()
    err = {"K1": check_k1(dev),
           "K2": max(check_k2(dev), check_k2_gpt(dev), check_k2_causal(dev))}
    bf16_err = check_bf16_kernels(dev)
    times = time_kernels(dev)
    bf16_times = time_bf16_kernels(dev)
    gpt_times = time_gpt_attention(dev)
    lund = lund_pair_mlp_phase(dev)
    part = part_phase(dev)
    print(json.dumps({"part": {k: part[k] for k in ("forward_ms", "pair_embed_ms")}}))

    train_ds, val_ds = _train_data(np.random.default_rng(5))
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as out_dir:
        mesh_err, tp_times, mesh = mesh_phase(dev, train_ds, val_ds, out_dir)
    err = {k: max(v, mesh_err[k]) for k, v in err.items()}

    rng = np.random.default_rng(0)
    mult = _jets(rng, 512, 4)

    flagship = _system("MMF", FLAGSHIP, dev)
    main_launches, flagship_gen = drive(
        "flagship MMF", flagship, mult, SAMPLING_STEPS,
        lambda l1, l2: ("did not run both K1 forms" if not (l1["segments"] and l1["key_mask"])
                        else "launched K2" if sum(l2.values()) else ""))
    sampler_vs_cpu("flagship MMF", flagship, FLAGSHIP, dev)
    del flagship

    coocc = _system("MMF", COOCC, dev)
    coocc_launches, _ = drive(
        "co-occurrence MMF", coocc, mult, SAMPLING_STEPS,
        lambda l1, l2: ("did not run K2 as bias + segments and as bias"
                        if not (l2["bias_segments"] and l2["bias"])
                        else "launched K1" if sum(l1.values()) else ""))
    sampler_vs_cpu("co-occurrence MMF", coocc, COOCC, dev)
    del coocc

    for name, kind, cfg_kw, n, steps in (
            ("MJB + FlavorFormer (pairwise, pos-emb)", "MJB", FLAVOR, 256, 20),
            ("CFM + KinFormer (Lund)", "CFM", KIN, 128, 10)):
        system = _system(kind, cfg_kw, dev)
        drive(name, system, _jets(rng, n, 2), steps,
              lambda l1, l2: "did not run K2" if not sum(l2.values()) else "",
              lund=cfg_kw is KIN)
        del system

    bf16 = bf16_phase(dev, mult, flagship_gen.sample, train_ds)
    print(json.dumps({"bf16": {"card": card, **bf16}}))

    train_card_vs_cpu(dev, train_ds)
    fit_fixed_batch(dev, train_ds)
    steps_timed = []
    with tempfile.TemporaryDirectory(dir=build_dir) as out_dir:
        train_graph = train_graph_check(dev, train_ds, val_ds, out_dir)
        train_launches, trainer, state, peak = train_flagship(dev, train_ds, val_ds, out_dir)
        steps_timed.append(dict(time_training(dev, trainer, state, train_ds),
                                peak_mib=peak / 2**20))
        del trainer, state
        coocc_train_launches = train_coocc(dev, train_ds)

        # the rest of the model / solver matrix
        fused_launches = drive_fused(dev, mult, SAMPLING_STEPS)
        trainer, state, fused_train_launches = fit_fixed_batch(
            dev, train_ds, steps=5, name="FusedParticleFormer MMF", cfg_kw=TRAIN_FUSED)
        if fused_train_launches["K1"] != {"segments": 5 * 5, "key_mask": 0, "none": 0}:
            raise AssertionError("FusedParticleFormer training: K1 did not run 5 times a forward "
                                 "in its segment form")
        steps_timed.append(time_training(dev, trainer, state, train_ds, n=10,
                                         label="FusedParticleFormer MMF"))
        del trainer, state

        physics_launches, physics = train_physics_eval(dev, train_ds, val_ds, out_dir)

        trainer, state, dropout_launches = train_dropout(dev, train_ds)
        steps_timed.append(time_training(dev, trainer, state, train_ds, n=10,
                                         label="flagship MMF, dropout 0.1"))
        del trainer, state
        dropout_attention = time_dropout_attention(dev)

        bucketed_launches = train_bucketed(dev, out_dir)

    epic = _system("CFM", EPIC, dev)
    epic_launches, _ = drive(
        "CFM + EPiC", epic, _jets(rng, 256, 2), 20,
        lambda l1, l2: "launched a kernel (EPiC has no attention)"
        if _total(l1) + _total(l2) else "")
    epic_checks(dev, epic)
    del epic
    trainer, state, epic_train_launches = fit_fixed_batch(
        dev, train_ds, steps=20, name="CFM + EPiC", kind="CFM", cfg_kw=TRAIN_EPIC)
    if _total(epic_train_launches["K1"]) + _total(epic_train_launches["K2"]):
        raise AssertionError("CFM + EPiC training launched a kernel")
    steps_timed.append(time_training(dev, trainer, state, train_ds, n=10, label="CFM + EPiC"))
    del trainer, state

    modes_vs_cpu(dev)

    with tempfile.TemporaryDirectory(dir=build_dir) as out_dir:
        cli_train_launches, cli_sample_launches, cli_numbers, cli_sample = cli_entry_points(
            dev, out_dir)
        toy = toy_phase(dev, out_dir)
        gpt_train_launches, gpt_sample_launches, gpt = gpt_phase(dev, out_dir)
        wide = wide_phase(dev, out_dir)
    substructure = substructure_phase(cli_sample)
    print(json.dumps({"entry_points": {"card": card, "cli": cli_numbers, "toy": toy,
                                       "substructure": substructure}}))
    print(json.dumps({"gpt": {"card": card, **gpt}}))
    print(json.dumps({"wide": {"card": card, "models": wide["models"], "gpt": wide["gpt"],
                               "entry_points": wide["entry_points"], "wall_s": wide["wall_s"]}}))
    print(json.dumps({"mesh": {"card": card, **mesh, "tp_shapes": {
        f"{name} {shape} {form}": t for (name, shape, form), t in tp_times.items()}}}))

    print(json.dumps({"training": {"card": card, "shape": "packed rows of 128, 256 jets/step",
                                   "steps": steps_timed,
                                   "dropout_forward_attention_ms": dropout_attention,
                                   "physics_eval": physics, "graph": train_graph}}))

    def timed(name, times=times, tag=""):
        out = {}
        for shape, suffix in ((TIMED[0], ""), (TIMED[1], "_c256")):
            out.update({k + tag + suffix: v for k, v in times[name, shape].items()})
        return out

    def wide_launches(name):
        """The wide phase's launches of one kernel (both dtypes) by run."""
        runs = {n: r["launches"] for n, r in wide["models"].items()}
        runs["GPT loss forward"] = {"K2": wide["gpt"]["launches_loss"]}
        runs["GPT decode"] = {"K2": wide["gpt"]["launches_decode"]}
        runs.update({f"entry point {k}": v for k, v in wide["entry_points"].items()
                     if k.endswith("launches")})
        return {n: _total(c.get(name, {})) + _total(c.get(f"{name}_bf16", {}))
                for n, c in runs.items()}

    print(json.dumps({"kernels": [
        {"name": "btc_attention (K1, timed at B=128 T=128 H=4 segments, C=128 and C=256)",
         "route": "cuda",
         "source": "multimodal_flows_tpu_torch/csrc/btc_attention.cu",
         "replaces": "multimodal_flows_tpu/ops/pallas_attention.py:201",
         "launches": _total(main_launches["K1"]),
         "launches_training": _total(train_launches["K1"]),
         "launches_fused_sampling": _total(fused_launches["K1"]),
         "launches_fused_training": _total(fused_train_launches["K1"]),
         "launches_physics_eval_fit": _total(physics_launches["K1"]),
         "launches_dropout_training": _total(dropout_launches["K1"]),
         "plain_calls_dropout_training": _total(dropout_launches["plain_dropout"]),
         "launches_bucketed_training": _total(bucketed_launches["K1"]),
         "launches_epic": _total(epic_launches["K1"]) + _total(epic_train_launches["K1"]),
         "launches_cli_training": _total(cli_train_launches["K1"]),
         "launches_cli_sampling": _total(cli_sample_launches["K1"]),
         "launches_mesh_forward": {k: v["forward_k1_launches"]
                                   for k, v in mesh["layouts"].items()},
         "max_abs_err": err["K1"], "build_s": build_s["K1"], **timed("K1"),
         "launches_bf16_sampling": bf16["sampling"]["launches_k1"],
         "launches_bf16_training": bf16["launches_training"],
         "max_abs_err_bf16": bf16_err["K1"], **timed("K1", bf16_times, "_bf16"),
         **{f"tp_c{shape[2]}_{form}": tp_times["K1", shape, form]
            for shape in TP_SHAPES for form in ("segments", "key_mask")},
         "max_abs_err_wide": wide["max_abs_err"]["K1"],
         "max_abs_err_wide_bf16": wide["max_abs_err"]["K1_bf16"],
         "launches_wide": wide_launches("K1"),
         "wide": {n: t for n, t in wide["times"].items() if n.startswith("K1")}},
        {"name": "set_attention (K2, timed at B=128 T=128 H=4 bias + segments, "
                 "C=128 and C=256)",
         "route": "cuda",
         "source": "multimodal_flows_tpu_torch/csrc/set_attention.cu",
         "replaces": "multimodal_flows_tpu/ops/pallas_attention.py:48",
         "launches": _total(coocc_launches["K2"]),
         "launches_training": _total(coocc_train_launches["K2"]),
         "launches_dropout_training": _total(dropout_launches["K2"]),
         "launches_epic": _total(epic_launches["K2"]) + _total(epic_train_launches["K2"]),
         "launches_cli": _total(cli_train_launches["K2"]) + _total(cli_sample_launches["K2"]),
         "launches_gpt_training": _total(gpt_train_launches["K2"]),
         "launches_gpt_training_by_form": gpt_train_launches["K2"],
         "launches_gpt_sampling": _total(gpt_sample_launches["K2"]),
         "max_abs_err": err["K2"], "build_s": build_s["K2"], **timed("K2"),
         "launches_bf16_sampling": bf16["coocc_launches"],
         "launches_bf16_training": bf16["coocc_launches_training"],
         "max_abs_err_bf16": bf16_err["K2"], **timed("K2", bf16_times, "_bf16"),
         **{f"gpt_{shape}": t for shape, t in gpt_times.items()},
         **{f"tp_c{shape[2]}_bias_segments": tp_times["K2", shape, "segments"]
            for shape in TP_SHAPES},
         "max_abs_err_wide": wide["max_abs_err"]["K2"],
         "max_abs_err_wide_bf16": wide["max_abs_err"]["K2_bf16"],
         "launches_wide": wide_launches("K2"),
         "wide": {n: t for n, t in wide["times"].items() if n.startswith("K2")},
         "launches_part": _total(part["launches"]), "launches_part_by_form": part["launches"],
         "max_abs_err_part_h16": part["max_abs_err"], "part_h16": part["k2_time"]},
        {"name": "lund_pair_mlp (KinFormer's Lund pair MLP, timed at B=128 D=128 C=256 H=4 and "
                 "B=8 D=150)",
         "route": "cuda",
         "source": "multimodal_flows_tpu_torch/csrc/lund_pair_mlp.cu",
         "replaces": "none: the JAX package runs the pair MLP in XLA",
         "max_abs_err": lund["max_abs_err"], "max_sym_gap": lund["max_sym_gap"],
         "build_s": lund["build_s"], "times": lund["times"]},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
