"""Plain reference of the Particle Transformer (ParT) as the encoder of the
CFM system: fp32 `torch`, one jet a row, no packing, no chunks, no cache.

The model of Qu, Li and Qian, "Particle Transformer for Jet Tagging"
(arXiv:2202.03772), as weaver-core's `nn/model/ParticleTransformer.py`
writes it (`Embed`, `PairEmbed`, `Block`, `pairwise_lv_fts`), at its
published widths: embed_dims (128, 512, 128), pair_embed_dims
(64, 64, 64) then one output a head, 8 heads of 16, 8 blocks, FFN ratio 4,
4 pair inputs, every NormFormer scale on.  With E = `n_embd`, H = `n_head`,
F = `n_inner`, on standardized kinematics s (N, D, 3), the mask m and the
time t of each jet:

A.1 embedding: h = BN_in(s); three times h = GELU(Linear(LN(h))), widths
    3 -> E -> F -> E, each LN over its layer's input; h = h m (pads zero);
    x = h + tau(t), tau the sinusoidal time embedding of width E;
A.2 pair observables, eps = 1e-8, from the kinematics destandardized with
    the configuration's `metadata`, pads zeroed: d_eta = eta_i - eta_j,
    d_phi = ((phi_i - phi_j + pi) mod 2 pi) - pi, delta = sqrt(d_eta^2 +
    d_phi^2), ptmin = min(pt_i, pt_j);
    lnkt = log max(ptmin delta, eps)  (delta, not delta^2: upstream's kT);
    lnz = log max(ptmin / max(pt_i + pt_j, eps), eps);
    lndelta = log max(delta, eps);
    lnm2 = log max(2 pt_i pt_j (cosh d_eta - cos d_phi), eps);
    self-pairs kept; every pair computed (upstream computes the lower
    triangle and mirrors it: every observable is symmetric in (i, j));
A.3 pair embedding (`PairEmbed`, mode sum, `use_pre_activation_pair`):
    u = BN_p(obs); three times u = GELU(BN_k(Linear_k(u))), 4 -> 64 -> 64
    -> 64; U = BN_4(Linear_4(u)), 64 -> H, the last layer's GELU dropped
    (the pre-activation quirk); U[..., h] added unscaled to head h's scores;
A.4 for each of the L blocks: a = MHA(LN_pre_attn(x)) with fused qkv and
    an output projection, both with biases, scores q_h k_h^T / sqrt(hs) +
    U_h over the real keys of the jet; head h of a scaled by c_attn[h] and
    its channels re-laid as (hs, H): channel d H + h of a2 is
    a[h hs + d] c_attn[h] (upstream's `einsum('tbhd,h->tbdh')`);
    x = LN_post_attn(a2) + x; f = Linear_2(LN_post_fc(GELU(Linear_1(
    LN_pre_fc(x))))), LN_post_fc over F; x = f + w_resid x; x = x + tau(t);
A.5 v = Linear(GELU(Linear(LN_final(x)))), widths E -> F -> 3.

Departures from the published model (also the program's): (1) the two
class-attention blocks and the classifier are left out, since a CFM drift
is per particle and those blocks pool a jet into one token; LN_final (ParT's
`norm`) on every particle and the drift head take their place; (2) the time
enters as the repo's CFM encoders take it, tau(t) after the embedding and
after every block (ParT has no time input); (3) the particle features are
the flow state's 3 standardized kinematics, not JetClass's 17, and the pair
observables come from them destandardized as massless four-vectors;
(4) m^2 of a pair is the massless closed form above, equal to upstream's
E^2 - |p|^2 in exact arithmetic, without that form's fp32 cancellation;
(5) every BatchNorm is in its inference form, fixed running statistics and
one affine a channel, in training too; (6) no dropout (the published 0.1
acts in training only).

Weights from the seed (`draw_weights`): `weights.draw` (matrices
N(0, 1/fan_in), biases N(0, 0.1^2), LayerNorm and BatchNorm scales
1 + N(0, 0.1^2), the inner BatchNorms' running means N(0, 0.1^2) and
running variances 1 + N(0, 0.1^2)); `c_attn` and `w_resid` 1 + 0.25 z (not
the published ones, so that a misplaced scale shows); BN_in's and BN_p's
running statistics the configuration's `input_stats` / `pair_stats`
(`norm_statistics`).  The pair embedding runs in blocks of jets of at most
`PAIR_BUDGET` pairs.  Parameter names are the program's state-dict names,
the BatchNorm buffers included.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench_torch import jets, weights
from bench_torch.counts import block_flops
from bench_torch.reference.common import Ops, Spec, gelu_exact, layer_norm, linear_spec, \
    ln_spec, sinusoidal

Tensor = torch.Tensor
#: pairs of one block of the pair embedding (a (pairs, 64) fp32 hidden
#: tensor is 512 MiB)
PAIR_BUDGET = 1 << 21
EPS = 1e-8
NORM_EPS = 1e-5
#: the rule of `c_attn` and `w_resid`: 1 + SCALE_SPREAD z
SCALE_SPREAD = 0.25


def _bn_spec(name: str, n: int) -> Spec:
    return [(f"{name}.weight", (n,), "ln_weight"), (f"{name}.bias", (n,), "bias"),
            (f"{name}.running_mean", (n,), "bias"), (f"{name}.running_var", (n,), "ln_weight")]


def _widths(cfg: Dict) -> Tuple[int, int, List[int]]:
    E = cfg["n_embd"]
    return E, cfg["n_inner"], list(cfg["pair_embed_dims"]) + [cfg["n_head"]]


def param_spec(cfg: Dict) -> Spec:
    E, F, pair = _widths(cfg)
    H, dc = cfg["n_head"], cfg["dim_continuous"]
    spec = _bn_spec("embed.input_bn", dc)
    n_in = dc
    for i, w in enumerate((E, F, E)):
        spec += ln_spec(f"embed.ln_{i}", n_in) + linear_spec(f"embed.fc_{i}", n_in, w)
        n_in = w
    spec += _bn_spec("pair_embed.input_bn", 4)
    n_in = 4
    for k, w in enumerate(pair):
        spec += linear_spec(f"pair_embed.fc_{k}", n_in, w) + _bn_spec(f"pair_embed.bn_{k}", w)
        n_in = w
    for i in range(cfg["n_layer"]):
        b = f"block_{i}"
        spec += (ln_spec(f"{b}.pre_attn_norm", E) + linear_spec(f"{b}.attn.c_attn", E, 3 * E)
                 + linear_spec(f"{b}.attn.c_proj", E, E) + ln_spec(f"{b}.post_attn_norm", E)
                 + ln_spec(f"{b}.pre_fc_norm", E) + linear_spec(f"{b}.fc1", E, F)
                 + ln_spec(f"{b}.post_fc_norm", F) + linear_spec(f"{b}.fc2", F, E)
                 + [(f"{b}.c_attn", (H,), "embedding"), (f"{b}.w_resid", (E,), "embedding")])
    spec += ln_spec("norm", E)
    return spec + linear_spec("head.fc", E, F) + linear_spec("head.proj", F, dc)


def draw_weights(cfg: Dict, seed: int, device: torch.device) -> Dict[str, Tensor]:
    """`weights.draw`; `c_attn` and `w_resid` 1 + SCALE_SPREAD z; BN_in's
    and BN_p's running statistics from the configuration."""
    p = weights.draw(param_spec(cfg), seed, device)
    for name in p:
        if name.endswith((".c_attn", ".w_resid")):
            p[name] = 1.0 + SCALE_SPREAD * p[name]
    for bn, key in (("embed.input_bn", "input_stats"), ("pair_embed.input_bn", "pair_stats")):
        stats = cfg[key]
        p[f"{bn}.running_mean"] = torch.tensor(stats["mean"], dtype=torch.float32, device=device)
        p[f"{bn}.running_var"] = torch.tensor(stats["var"], dtype=torch.float32, device=device)
    return p


def dense_flops(cfg: Dict) -> int:
    """Dense FLOPs of one real particle (`bench_torch/counts.py`): the
    embedding, the blocks and the head; the pair embedding is counted a
    pair (`pair_flops`)."""
    E, F, _ = _widths(cfg)
    dc = cfg["dim_continuous"]
    embed = 2 * (dc * E + E * F + F * E)
    head = 2 * (E * F + F * dc)
    return embed + cfg["n_layer"] * block_flops(E, F) + head


def attention_layers(cfg: Dict) -> List[Tuple[int, int]]:
    """[(width, layers)] of the self-attention calls of one forward."""
    return [(cfg["n_embd"], cfg["n_layer"])]


def pair_flops(cfg: Dict) -> int:
    """FLOPs of the pair embedding's dense layers for one real pair."""
    n_in, total = 4, 0
    for w in _widths(cfg)[2]:
        total += n_in * w
        n_in = w
    return 2 * total


# ------------------------------------------------------------------ the pairs

def observables(cfg: Dict, cont: Tensor, mask: Tensor) -> Tensor:
    """(N, D, D, 4) [lnkt, lnz, lndelta, lnm2] of every pair of the
    destandardized kinematics, pads zeroed (A.2)."""
    meta = cfg.get("metadata") or {}
    dim = cont.shape[-1]
    mu = torch.tensor(meta.get("mean", [0.0] * dim), dtype=torch.float32, device=cont.device)
    sig = torch.tensor(meta.get("std", [1.0] * dim), dtype=torch.float32, device=cont.device)
    kin = (cont.float() * sig + mu) * mask[..., None]
    pt, eta, phi = kin[..., 0], kin[..., 1], kin[..., 2]
    pt_i, pt_j = pt[:, :, None], pt[:, None, :]
    d_eta = eta[:, :, None] - eta[:, None, :]
    d_phi = torch.remainder(phi[:, :, None] - phi[:, None, :] + math.pi, 2 * math.pi) - math.pi
    delta = torch.sqrt(d_eta ** 2 + d_phi ** 2)
    ptmin = torch.minimum(pt_i, pt_j)
    lnkt = torch.log(torch.clamp(ptmin * delta, min=EPS))
    lnz = torch.log(torch.clamp(ptmin / torch.clamp(pt_i + pt_j, min=EPS), min=EPS))
    lndelta = torch.log(torch.clamp(delta, min=EPS))
    lnm2 = torch.log(torch.clamp(2.0 * pt_i * pt_j * (torch.cosh(d_eta) - torch.cos(d_phi)),
                                 min=EPS))
    return torch.stack([lnkt, lnz, lndelta, lnm2], dim=-1)


def batch_norm(p: Dict[str, Tensor], name: str, x: Tensor) -> Tensor:
    """BatchNorm over the last axis in its inference form."""
    return ((x - p[f"{name}.running_mean"]) / torch.sqrt(p[f"{name}.running_var"] + NORM_EPS)
            * p[f"{name}.weight"] + p[f"{name}.bias"])


def pair_embedding(ops: Ops, p: Dict[str, Tensor], cfg: Dict, obs: Tensor) -> Tensor:
    """(N, D, D, H) of the observables (A.3)."""
    u = batch_norm(p, "pair_embed.input_bn", obs)
    n = len(_widths(cfg)[2])
    for k in range(n):
        u = batch_norm(p, f"pair_embed.bn_{k}",
                       ops.linear(u, p[f"pair_embed.fc_{k}.weight"], p[f"pair_embed.fc_{k}.bias"]))
        if k < n - 1:
            u = gelu_exact(u)
    return u


def pair_bias(ops: Ops, p: Dict[str, Tensor], cfg: Dict, cont: Tensor, mask: Tensor) -> Tensor:
    """U (N, H, D, D), in blocks of jets of at most PAIR_BUDGET pairs."""
    N, D = cont.shape[0], cont.shape[1]
    per = max(1, PAIR_BUDGET // (D * D))
    out = [pair_embedding(ops, p, cfg, observables(cfg, cont[a:a + per], mask[a:a + per]))
           for a in range(0, N, per)]
    return torch.cat(out).permute(0, 3, 1, 2)


# ----------------------------------------------------------------- the model

def attention(ops: Ops, q: Tensor, k: Tensor, v: Tensor, n_head: int, bias: Tensor,
              allowed: Tensor) -> Tensor:
    """softmax(q k^T / sqrt(hs) + bias) v over `n_head` heads, token-major
    q/k/v (N, T, C), bias (N, H, T, T), `allowed` (N, T, T) the keys a
    query sees."""
    N, T, C = q.shape
    hs = C // n_head

    def heads(t):
        return t.reshape(N, T, n_head, hs).transpose(1, 2)

    s = ops.matmul(heads(q), heads(k).transpose(-1, -2)) / math.sqrt(hs) + bias
    s = s.masked_fill(~allowed[:, None], float("-inf"))
    return ops.matmul(torch.softmax(s, dim=-1), heads(v)).transpose(1, 2).reshape(N, T, C)


def block(ops: Ops, p: Dict[str, Tensor], name: str, x: Tensor, cfg: Dict, bias: Tensor,
          allowed: Tensor) -> Tensor:
    """One NormFormer particle-attention block (A.4, without the time)."""
    H = cfg["n_head"]
    N, T, E = x.shape
    h = layer_norm(x, p[f"{name}.pre_attn_norm.weight"], p[f"{name}.pre_attn_norm.bias"])
    q, k, v = ops.linear(h, p[f"{name}.attn.c_attn.weight"],
                         p[f"{name}.attn.c_attn.bias"]).chunk(3, dim=-1)
    a = ops.linear(attention(ops, q, k, v, H, bias, allowed), p[f"{name}.attn.c_proj.weight"],
                   p[f"{name}.attn.c_proj.bias"])
    a2 = torch.einsum("nthd,h->ntdh", a.reshape(N, T, H, E // H), p[f"{name}.c_attn"])
    x = layer_norm(a2.reshape(N, T, E), p[f"{name}.post_attn_norm.weight"],
                   p[f"{name}.post_attn_norm.bias"]) + x
    f = layer_norm(x, p[f"{name}.pre_fc_norm.weight"], p[f"{name}.pre_fc_norm.bias"])
    f = gelu_exact(ops.linear(f, p[f"{name}.fc1.weight"], p[f"{name}.fc1.bias"]))
    f = layer_norm(f, p[f"{name}.post_fc_norm.weight"], p[f"{name}.post_fc_norm.bias"])
    f = ops.linear(f, p[f"{name}.fc2.weight"], p[f"{name}.fc2.bias"])
    return f + p[f"{name}.w_resid"] * x


def forward(ops: Ops, p: Dict[str, Tensor], cfg: Dict, cont: Tensor, mask: Tensor,
            time: Tensor) -> Tensor:
    """Drift (N, D, Fc) of N jets, one a row: `cont` (N, D, Fc)
    standardized kinematics, `mask` (N, D) bool (real particles), `time`
    (N,) per jet."""
    allowed = mask[:, None, :] & torch.ones_like(mask)[:, :, None]     # keys: real particles
    bias = pair_bias(ops, p, cfg, cont, mask)
    temb = sinusoidal(time, cfg["n_embd"])[:, None, :]
    h = batch_norm(p, "embed.input_bn", cont.float())
    for i in range(3):
        h = layer_norm(h, p[f"embed.ln_{i}.weight"], p[f"embed.ln_{i}.bias"])
        h = gelu_exact(ops.linear(h, p[f"embed.fc_{i}.weight"], p[f"embed.fc_{i}.bias"]))
    x = h * mask[..., None] + temb
    for i in range(cfg["n_layer"]):
        x = block(ops, p, f"block_{i}", x, cfg, bias, allowed) + temb
    h = layer_norm(x, p["norm.weight"], p["norm.bias"])
    h = gelu_exact(ops.linear(h, p["head.fc.weight"], p["head.fc.bias"]))
    return ops.linear(h, p["head.proj.weight"], p["head.proj.bias"])


def euler(ops: Ops, p: Dict[str, Tensor], cfg: Dict, x: Tensor, mask: Tensor,
          steps: int) -> Tensor:
    """The CFM system's Euler sampler from the source `x`: times
    linspace(eps, 1 - eps, steps) in fp32, dt = (t_last - t_first) /
    (steps - 1), x <- x + v dt."""
    eps = cfg["time_eps"]
    ts = torch.linspace(eps, 1.0 - eps, steps, dtype=torch.float32, device=x.device)
    dt = (ts[-1] - ts[0]) / (steps - 1)
    with torch.no_grad():
        for i in range(steps):
            x = x + forward(ops, p, cfg, x, mask, ts[i].expand(len(x))) * dt
    return x


# --------------------------------------------------------- the input statistics

def norm_statistics(cfg: Dict, n_jets: int = 1 << 16, block_jets: int = 512) -> Dict:
    """The running statistics of BN_in and BN_p: the mean and (population)
    variance of the standardized kinematics over the real particles, and of
    the four observables (destandardized with the configuration's
    `metadata`) over the real same-jet pairs, self-pairs included, of the
    `n_jets` jets that the metadata came from (`jets.physical_jets` of
    Poisson(40) multiplicities in [3, 150], `jets.rng(0)`)."""
    D = cfg["max_num_particles"]
    r = jets.rng(0)
    mult = jets.multiplicities(r, n_jets, {"mean": 40, "min": 3, "max": 150})
    x, _, m = jets.physical_jets(r, mult, D)
    real = m[..., 0] > 0
    kin = x[real].astype(np.float64)
    s1, s2, n = np.zeros(4), np.zeros(4), 0
    for a in range(0, n_jets, block_jets):
        Dm = int(mult[a:a + block_jets].max())
        cont = torch.as_tensor(x[a:a + block_jets, :Dm])
        mask = torch.as_tensor(real[a:a + block_jets, :Dm])
        pairs = mask[:, :, None] & mask[:, None, :]
        obs = observables(cfg, cont, mask)[pairs].double()
        s1 += obs.sum(dim=0).numpy()
        s2 += (obs ** 2).sum(dim=0).numpy()
        n += len(obs)
    mean = s1 / n
    return {"input_stats": {"mean": kin.mean(axis=0).tolist(), "var": kin.var(axis=0).tolist()},
            "pair_stats": {"mean": mean.tolist(), "var": (s2 / n - mean ** 2).tolist()}}
