"""The GPT baseline's training and generation system (PyTorch port of
`multimodal_flows_tpu/train/gpt.py`).

Next-token cross-entropy with PAD targets ignored, and autoregressive
sampling with temperature and top-k through the KV-cached decode: one
token a step for `seq_len - 1` steps, K2 carrying the attention on CUDA,
where the whole step is captured once as a CUDA graph and replayed (the
position a device scalar, so a replay needs nothing from the host).
The draw at each step is argmax(logits + Gumbel noise), which is what
`jax.random.categorical` computes; the noise comes from an explicit
`torch.Generator`, or is injected (`gumbel=`) so that a test can share it
with the JAX package.  The system has the trainer's interface of the flow
systems (`loss_fn(batch, generator, train, module, rows)`, split into
`loss_draws` and `loss_from_draws`; `dropout_rate`, `.module`, `.device`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.state import DataCoupling
from multimodal_flows_tpu_torch.models.gpt import FlavorSeqGPT
from multimodal_flows_tpu_torch.train.systems import _device, _dropout_mode, _placed, _rank_total
from multimodal_flows_tpu_torch.utils.profiling import (
    add_counts, captured_counts, count, declare, span, spanned,
)

Tensor = torch.Tensor

declare("gpt_decode", "graph_steps", "eager_steps", "captures")


def gumbel_noise(generator: Optional[torch.Generator], shape, device) -> Tensor:
    """Standard Gumbel noise -log(-log(U)), U uniform on [tiny, 1) as
    `jax.random.gumbel` draws it, from `generator` on `device`."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


class GPT:
    """Autoregressive flavor-sequence baseline.  The weights are drawn from
    `generator` (a CPU generator, so a seed gives the same weights on every
    device) and the module is moved to `device` in eval mode."""

    name = "GPT"

    def __init__(self, config: Config, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.config = config
        self.device = _device(device)
        self.module = _placed(FlavorSeqGPT(config), self.device, generator)
        self.start_token = config.vocab_size + 1
        self.end_token = config.vocab_size + 2
        self.pad_token = config.vocab_size + 3
        # generation's static buffers and CUDA graphs, by `decode_graph_key`
        self._decode_loops: Dict[tuple, "_DecodeLoop"] = {}

    # ----------------------------------------------------------------- loss

    @property
    def dropout_rate(self) -> float:
        """The largest dropout rate of a train-mode forward."""
        cfg = self.config
        return max(cfg.dropout_att, cfg.dropout_emb, cfg.dropout_res)

    def loss_draws(self, batch: DataCoupling,
                   generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """The loss's draws outside the forward: none (the dropout masks are
        drawn inside it)."""
        return {}

    def loss_fn(self, batch: DataCoupling, generator: Optional[torch.Generator] = None,
                train: bool = True, module: Optional[nn.Module] = None,
                rows: Optional[slice] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
        return self.loss_from_draws(batch, self.loss_draws(batch, generator), train, module,
                                    rows, generator)

    def loss_from_draws(self, batch: DataCoupling, draws: Dict[str, Tensor],
                        train: bool = True, module: Optional[nn.Module] = None,
                        rows: Optional[slice] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Next-token CE over the token sequences `batch.target.discrete`
        (B, T) or (B, T, 1); positions whose target is PAD are ignored.
        With `train` and a dropout rate > 0 the forward runs in train mode,
        every mask from `generator`.  With `rows` (data parallelism), the
        forward runs on those rows and the sum divides by their share of
        the batch's target count."""
        module = module or self.module
        tokens = batch.target.discrete
        if tokens.ndim == 3:
            tokens = tokens[..., 0]
        tokens = tokens.long()
        n = len(tokens)
        total = _rank_total((tokens[:, 1:] != self.pad_token).sum(), rows, n)
        if rows is not None:
            tokens = tokens[rows]
        with _dropout_mode(module, self.dropout_rate, train, generator, rows, n):
            logits = module(tokens)
        # predict token t+1 from the prefix <= t
        logp = F.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
        targets = tokens[:, 1:]
        nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
        w = (targets != self.pad_token).to(torch.float32)
        loss = (nll * w).sum() / (w.sum().clamp_min(1.0) if total is None else total)
        return loss, {"loss": loss, "loss_ce": loss}

    # ------------------------------------------------------------- sampling

    @torch.no_grad()
    @spanned("gpt.generate")
    def generate(self, batch_size: int, generator: Optional[torch.Generator] = None,
                 temperature=None, top_k: Optional[int] = None,
                 gumbel: Optional[Tensor] = None,
                 module: Optional[nn.Module] = None) -> Tensor:
        """Token sequences (B, seq_len) int32 from BOS, special tokens
        included.  Each step decodes one token against the KV caches,
        scales by the temperature (the first entry of a list), keeps the
        `top_k` largest logits and draws argmax(logits + Gumbel).  The noise
        (seq_len - 1, B, V + 4) is `gumbel` when given, else drawn from
        `generator` on the system's device.  Sequences that have emitted
        EOS emit PAD.

        The steps run on static buffers with the position a device scalar
        (`_DecodeLoop`).  On CUDA, in eval mode, without tensor parallelism
        and outside another capture, the first call for a key
        (`decode_graph_key`) runs its first step eagerly on a side stream,
        captures the second as a CUDA graph and replays it for the rest;
        later calls replay it at every step.  Elsewhere every step runs
        eagerly, the same code."""
        cfg = self.config
        module = module or self.module
        T, V = module.seq_len, module.full_vocab
        temperature = cfg.temperature if temperature is None else temperature
        if isinstance(temperature, (list, tuple)):
            temperature = temperature[0]
        top_k = cfg.top_k if top_k is None else top_k
        if gumbel is None:
            gumbel = gumbel_noise(generator, (T - 1, batch_size, V), self.device)
        elif gumbel.shape != (T - 1, batch_size, V):
            raise ValueError(f"gumbel must be {(T - 1, batch_size, V)}, got {tuple(gumbel.shape)}")

        if _graphable(module, self.device):
            key = decode_graph_key(module, batch_size, temperature, top_k, self.device)
            loop = self._decode_loops.get(key)
            if loop is None:
                loop = self._decode_loops[key] = _DecodeLoop(self, module, batch_size,
                                                             temperature, top_k, capture=True)
        else:
            loop = _DecodeLoop(self, module, batch_size, temperature, top_k, capture=False)
        loop.reset(gumbel)
        for _ in range(T - 1):
            with span("gpt.decode_step"):
                loop.run_step()
        return loop.tokens.clone()

    def sample_jets(self, batch_size: int, generator: Optional[torch.Generator] = None,
                    temperature=None, top_k: Optional[int] = None) -> np.ndarray:
        """Generate and strip the special tokens back to (B,
        max_seq_length) flavor sets (numpy)."""
        from multimodal_flows_tpu_torch.data.datasets import seq_to_jet_set

        seq = self.generate(batch_size, generator, temperature, top_k).cpu().numpy()
        return seq_to_jet_set(seq, self.config.vocab_size, self.config.max_seq_length)

    # ------------------------------------------------- trainer compatibility

    def example_state(self, batch_size: int = 2) -> Tensor:
        return torch.zeros((batch_size, self.module.seq_len), dtype=torch.int32,
                           device=self.device)


def decode_graph_key(module: nn.Module, batch_size: int, temperature: float,
                     top_k: Optional[int], device: torch.device) -> tuple:
    """What a captured decode step bakes in: the batch size, the
    temperature, `top_k`, the module (by identity and by where its
    parameters live; their values are read at each replay) and the device."""
    return (batch_size, float(temperature), top_k, id(module),
            tuple(p.data_ptr() for p in module.parameters()), device)


def _graphable(module: nn.Module, device: torch.device) -> bool:
    """A decode step captures on CUDA, in eval mode (no dropout draws), with
    no collective inside it (no tensor-parallel group) and outside any
    capture already running."""
    return (device.type == "cuda" and not module.training
            and all(block.attn.tp_group is None for block in module.blocks)
            and not torch.cuda.is_current_stream_capturing())


class _DecodeLoop:
    """One key's generation: static buffers (the KV caches, the noise, the
    tokens, the previous token, the done flags and the position, a 0-d
    int64 tensor) that `step` reads and advances in place, and with
    `capture` the step captured as a CUDA graph on its first call."""

    def __init__(self, system: GPT, module: nn.Module, batch_size: int, temperature: float,
                 top_k: Optional[int], capture: bool):
        dev = system.device
        T, V = module.seq_len, module.full_vocab
        self.module, self.temperature, self.top_k = module, float(temperature), top_k
        self.start, self.end, self.pad = system.start_token, system.end_token, system.pad_token
        self.caches = module.init_cache(batch_size)
        self.noise = torch.empty((T - 1, batch_size, V), device=dev)
        self.tokens = torch.empty((batch_size, T), dtype=torch.int32, device=dev)
        self.prev = torch.empty(batch_size, dtype=torch.int32, device=dev)
        self.done = torch.empty(batch_size, dtype=torch.bool, device=dev)
        self.pos = torch.zeros((), dtype=torch.long, device=dev)
        self.capture = capture
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.counts: Dict[str, int] = {}   # what a replay adds to the counters

    def reset(self, gumbel: Tensor) -> None:
        """A call's start: its noise, empty caches, BOS, position 0."""
        self.noise.copy_(gumbel)
        for k, v in self.caches:
            k.zero_()
            v.zero_()
        self.tokens[:, 0] = self.start
        self.prev.fill_(self.start)
        self.done.zero_()
        self.pos.zero_()

    def step(self) -> None:
        """Decode at the position, draw, write the token after it and
        advance; the host reads nothing."""
        logits, _ = self.module.decode(self.prev, self.pos, self.caches)
        logits = logits.to(torch.float32) / self.temperature
        if self.top_k is not None:
            thresh = torch.topk(logits, self.top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits >= thresh, logits, -1e9)
        gumbel = self.noise.index_select(0, self.pos.reshape(1))[0]
        nxt = torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
        nxt = torch.where(self.done, self.pad, nxt)
        self.done |= nxt == self.end
        self.pos += 1
        self.tokens.index_copy_(1, self.pos.reshape(1), nxt[:, None])
        self.prev.copy_(nxt)

    def run_step(self) -> None:
        """One step: a replay of the graph, or the step run eagerly (on a
        side stream followed by the capture, the first time a graph is due)."""
        if self.graph is not None:
            self.graph.replay()
            add_counts(self.counts)
            count("gpt_decode.graph_steps")
            return
        count("gpt_decode.eager_steps")
        if not self.capture:
            self.step()
            return
        # warm up on the stream the capture uses (the kernels' attributes,
        # cuBLAS's workspace), then capture
        side = torch.cuda.Stream(self.pos.device)
        side.wait_stream(torch.cuda.current_stream(self.pos.device))
        with torch.cuda.stream(side):
            self.step()
        graph = torch.cuda.CUDAGraph()
        with captured_counts() as self.counts, torch.cuda.graph(graph, stream=side):
            self.step()
        torch.cuda.current_stream(self.pos.device).wait_stream(side)
        self.graph = graph
        count("gpt_decode.captures")
