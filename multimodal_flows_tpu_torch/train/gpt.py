"""The GPT baseline's training and generation system (PyTorch port of
`multimodal_flows_tpu/train/gpt.py`).

Next-token cross-entropy with PAD targets ignored, and autoregressive
sampling with temperature and top-k through the KV-cached decode: one
token a step for `seq_len - 1` steps, K2 carrying the attention on CUDA.
The draw at each step is argmax(logits + Gumbel noise), which is what
`jax.random.categorical` computes; the noise comes from an explicit
`torch.Generator`, or is injected (`gumbel=`) so that a test can share it
with the JAX package.  The system has the trainer's interface of the flow
systems (`loss_fn(batch, generator, train, module)`, `.module`, `.device`).
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
from multimodal_flows_tpu_torch.utils.profiling import span, spanned

Tensor = torch.Tensor


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

    # ----------------------------------------------------------------- loss

    def loss_fn(self, batch: DataCoupling, generator: Optional[torch.Generator] = None,
                train: bool = True, module: Optional[nn.Module] = None,
                rows: Optional[slice] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Next-token CE over the token sequences `batch.target.discrete`
        (B, T) or (B, T, 1); positions whose target is PAD are ignored.
        With `train` and a dropout rate > 0 the forward runs in train mode,
        every mask from `generator`.  With `rows` (data parallelism), the
        forward runs on those rows and the sum divides by their share of
        the batch's target count."""
        module = module or self.module
        cfg = self.config
        tokens = batch.target.discrete
        if tokens.ndim == 3:
            tokens = tokens[..., 0]
        tokens = tokens.long()
        n = len(tokens)
        total = _rank_total((tokens[:, 1:] != self.pad_token).sum(), rows, n)
        if rows is not None:
            tokens = tokens[rows]
        rate = max(cfg.dropout_att, cfg.dropout_emb, cfg.dropout_res)
        with _dropout_mode(module, rate, train, generator, rows, n):
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
        EOS emit PAD."""
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
        gumbel = gumbel.to(self.device, torch.float32)

        caches = module.init_cache(batch_size)
        tokens = torch.empty((batch_size, T), dtype=torch.int32, device=self.device)
        tokens[:, 0] = self.start_token
        prev = tokens[:, 0]
        done = torch.zeros(batch_size, dtype=torch.bool, device=self.device)
        for t in range(T - 1):
            with span("gpt.decode_step"):
                logits, caches = module.decode(prev, t, caches)
                logits = logits.to(torch.float32) / float(temperature)
                if top_k is not None:
                    thresh = torch.topk(logits, top_k, dim=-1).values[:, -1:]
                    logits = torch.where(logits >= thresh, logits, -1e9)
                nxt = torch.argmax(logits + gumbel[t], dim=-1).to(torch.int32)
                nxt = torch.where(done, self.pad_token, nxt)
                done = done | (nxt == self.end_token)
                tokens[:, t + 1] = nxt
                prev = nxt
        return tokens

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
