"""Shared layers: norms, MLPs, embeddings, RoPE, init helpers.

Counterpart of `repro/models/layers.py`. The reference's parameter dicts are
`nn.Module`s here, with the dicts' keys as attribute names, so a parameter's
name in `state_dict()` is its path in the reference's tree (`embed.table`,
`layers.0.mlp.wi`, ...). Each parameter carries its init rule (`Params`),
which `init_params` draws from one `torch.Generator` in the module's
parameter order: the same distributions as the reference's `ninit`, other
bits (`repro_torch.convert.lm_params` carries the reference's bits over).

Serving holds weight matrices in the config's compute dtype, with no
gradient; norm scales stay float32, as every use reads them in float32.
Training holds float32 masters, as the reference does (`LM(...,
param_dtype=torch.float32)`), and every use casts a matrix to the compute
dtype (the dtype of the activations it meets, as the reference's); on
serving's weights that cast is a no-op, so serving's bits do not change.

The embedding lookup's backward (`_EmbedLookup`) sums each vocabulary row's
contributions in token order, in float32, with no atomics: the gradient
does not depend on the device's scheduling.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Params(nn.Module):
    """A module of named parameters, each with its init rule.

    Rules: ("normal", scale) draws N(0, 1) * scale in float32, then casts to
    the parameter's dtype; ("uniform",) draws U[0, 1) likewise; ("ones",)
    fills ones and ("fill", value) fills `value`.
    """

    def __init__(self):
        super().__init__()
        self.inits: dict[str, tuple] = {}

    def param(self, name: str, shape, dtype, device, rule) -> None:
        t = torch.empty(tuple(shape), dtype=dtype, device=device)
        self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.inits[name] = rule

    def weight(self, name: str, shape, cfg, device, fan_in=None) -> None:
        """A matrix in the compute dtype, drawn as the reference's `ninit`:
        N(0, 1) * (1 / max(fan_in, 1)) ** 0.5, fan_in defaulting to shape[0]."""
        fan_in = fan_in if fan_in is not None else shape[0]
        self.param(name, shape, compute_dtype(cfg), device,
                   ("normal", (1.0 / max(fan_in, 1)) ** 0.5))


def init_module(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of `module` from `generator`, in parameter order.

    The generator must live on the parameters' device."""
    with torch.no_grad():
        for mod in module.modules():
            if not isinstance(mod, Params):
                continue
            for name, rule in mod.inits.items():
                p = getattr(mod, name)
                if rule[0] == "ones":
                    p.fill_(1.0)
                elif rule[0] == "fill":
                    p.fill_(rule[1])
                elif rule[0] == "uniform":
                    p.copy_(torch.rand(p.shape, generator=generator, dtype=torch.float32,
                                       device=p.device))
                else:
                    draw = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                                       device=p.device)
                    p.copy_(draw * rule[1])
    return module


# --- norms --------------------------------------------------------------------


class Norm(Params):
    def __init__(self, d: int, device):
        super().__init__()
        self.param("scale", (d,), torch.float32, device, ("ones",))


def rmsnorm(params, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * params.scale).to(dt)


def layernorm(params, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * params.scale).to(dt)


def apply_norm(cfg, params, x):
    return rmsnorm(params, x, cfg.norm_eps) if cfg.norm == "rmsnorm" else layernorm(params, x)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def act_fn(cfg):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[cfg.act]


# --- gated MLP (SwiGLU family) --------------------------------------------------


class MLP(Params):
    def __init__(self, cfg, d_model: int, d_ff: int, device):
        super().__init__()
        self.weight("wi", (d_model, d_ff), cfg, device)
        self.weight("wg", (d_model, d_ff), cfg, device)
        self.weight("wo", (d_ff, d_model), cfg, device)


def mlp_apply(cfg, params, x):
    dt = x.dtype
    h = x @ params.wi.to(dt)
    g = x @ params.wg.to(dt)
    return (act_fn(cfg)(g) * h) @ params.wo.to(dt)


# --- embeddings -----------------------------------------------------------------


class Embed(Params):
    def __init__(self, cfg, vocab: int, d_model: int, device):
        super().__init__()
        self.param("table", (vocab, d_model), compute_dtype(cfg), device, ("normal", 0.02))


class _EmbedLookup(torch.autograd.Function):
    """table.to(dtype)[tokens], whose backward adds each row's cotangents in
    token order (a stable sort, then a sequential segment sum) in float32.
    The default backward (`index_put_` with accumulate) adds them with float
    atomics on the card, in no fixed order."""

    @staticmethod
    def forward(ctx, table, tokens, dtype):
        ctx.save_for_backward(tokens)
        ctx.vocab, ctx.table_dtype = table.shape[0], table.dtype
        return table.to(dtype)[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        flat = tokens.reshape(-1)
        order = torch.argsort(flat, stable=True)
        rows = torch.arange(ctx.vocab + 1, dtype=flat.dtype, device=flat.device)
        bounds = torch.searchsorted(flat[order], rows)
        grad = torch.segment_reduce(g.reshape(flat.shape[0], -1)[order].float(), "sum",
                                    lengths=bounds[1:] - bounds[:-1], axis=0, unsafe=True)
        return grad.to(ctx.table_dtype), None, None


class Head(Params):
    """An output head of its own (`cfg.separate_head`), laid out as the
    embedding table: (padded vocab, d_model), a matrix of fan-in d_model."""

    def __init__(self, cfg, vocab: int, d_model: int, device):
        super().__init__()
        self.weight("table", (vocab, d_model), cfg, device, fan_in=d_model)


def embed_apply(cfg, params, tokens):
    return _EmbedLookup.apply(params.table, tokens, compute_dtype(cfg))


def unembed_apply(cfg, params, x):
    """Logits over the padded vocabulary; `params` the embedding (tied) or
    the `Head`."""
    logits = x @ params.table.to(x.dtype).t()
    if params.table.shape[0] > cfg.vocab_size:
        # mask padding rows (never predicted, zero softmax mass)
        logits[..., cfg.vocab_size:] = -1e30
    return logits


# --- RoPE ------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: (B, T, H, Dh); positions: (B, T) integer. Computed in float32."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (B, T, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
