"""Block composition per architecture family (pre-norm residual blocks).

Counterpart of `repro/models/blocks.py`: the kinds `attn` (the dense and vlm
families, hybrid's shared block), `enc` (audio's encoder), `moe`, `mamba`
(hybrid), `rwkv` (ssm) and `dec_cross` (audio's decoder), with the
reference's parameter names, and the remat policy (`remat_wrap`). A block's
self-attention is latent attention where `cfg.attention == "mla"`
(`attention.attention_params`); a moe model's first `cfg.first_dense_layers`
layers are `attn` blocks of `d_ff` (`lm.layer_kind`).
"""

from __future__ import annotations

from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import MLP, Norm, apply_norm, mlp_apply

KINDS = ("attn", "enc", "moe", "mamba", "rwkv", "dec_cross")


class Block(nn.Module):
    def __init__(self, cfg, kind: str, device, n_model: int = 1):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}; the kinds are {KINDS}")
        d = cfg.d_model
        self.ln1 = Norm(d, device)
        if kind == "mamba":
            self.ssm = ssm_mod.SSM(cfg, device)
            return
        if kind == "rwkv":  # `tmix` holds both time-mix and channel-mix (cm_*)
            self.tmix = rwkv_mod.RWKV(cfg, device)
            self.ln2 = Norm(d, device)
            return
        self.attn = attn.attention_params(cfg, device)
        if kind == "dec_cross":
            self.lnx = Norm(d, device)
            self.xattn = attn.Attention(cfg, device)
        self.ln2 = Norm(d, device)
        if kind == "moe":
            self.moe = moe_mod.MoE(cfg, device, n_model)
        else:
            self.mlp = MLP(cfg, d, cfg.d_ff, device)


def block_init(cfg, kind: str, n_model: int = 1, device=None) -> Block:
    """An uninitialised block (`layers.init_module` draws its parameters)."""
    return Block(cfg, kind, device, n_model)


# the matrix products `dots_with_no_batch_dims_saveable` keeps: products with
# no batch dimension (the batched expert products are bmm)
DOT_OPS = (torch.ops.aten.mm.default,)


def checkpointed(fn, save_ops=()):
    """`fn` under `torch.utils.checkpoint` (non-reentrant): the backward
    recomputes its activations, but for the outputs of the operators in
    `save_ops`, which a selective-checkpoint policy keeps (their recompute
    returns the kept tensors without running the operator)."""
    if not save_ops:
        return partial(checkpoint, fn, use_reentrant=False)
    context_fn = partial(create_selective_checkpoint_contexts, list(save_ops))
    return partial(checkpoint, fn, use_reentrant=False, context_fn=context_fn)


def remat_wrap(cfg, fn, save_ops=()):
    """The remat policy, as the reference's. `save_ops` stands for the
    reference's checkpoint names: operators whose outputs the backward keeps
    (the MoE's expert exchange, `moe.EXCHANGE_OPS`), so it does not replay
    the exchange or its ChaCha launches."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        return checkpointed(fn, DOT_OPS)
    return checkpointed(fn, save_ops)


def apply_attn_block(cfg, p, x, positions, causal=None):
    h = attn.self_attention(cfg, p.attn, apply_norm(cfg, p.ln1, x), positions, causal=causal)
    x = x + h
    return x + mlp_apply(cfg, p.mlp, apply_norm(cfg, p.ln2, x))


def apply_moe_block(cfg, p, x, positions, mesh=None, secure=None):
    h = attn.self_attention(cfg, p.attn, apply_norm(cfg, p.ln1, x), positions)
    x = x + h
    y, aux, dropped = moe_mod.moe_apply(cfg, p.moe, apply_norm(cfg, p.ln2, x), mesh=mesh,
                                        secure=secure)
    return x + y, aux, dropped


def apply_mamba_block(cfg, p, x, h0=None, conv0=None):
    y, (h_end, conv_end) = ssm_mod.ssm_apply(cfg, p.ssm, apply_norm(cfg, p.ln1, x), h0, conv0)
    return x + y, h_end, conv_end


def apply_rwkv_block(cfg, p, x, states=None):
    """states: (tmix shift, wkv, cmix shift) or None. Returns (x, states):
    the shifts are the NORMALISED inputs' last tokens."""
    s = states or (None, None, None)
    y, (tshift, wkv) = rwkv_mod.rwkv_time_mix(cfg, p.tmix, apply_norm(cfg, p.ln1, x), s[0], s[1])
    x = x + y
    y, cshift = rwkv_mod.rwkv_channel_mix(cfg, p.tmix, apply_norm(cfg, p.ln2, x), s[2])
    return x + y, (tshift, wkv, cshift)


def apply_dec_cross_block(cfg, p, x, positions, enc_kv, enc_valid=None):
    h = attn.self_attention(cfg, p.attn, apply_norm(cfg, p.ln1, x), positions)
    x = x + h
    h = attn.cross_attention(cfg, p.xattn, apply_norm(cfg, p.lnx, x), enc_kv, positions,
                             enc_valid)
    x = x + h
    return x + mlp_apply(cfg, p.mlp, apply_norm(cfg, p.ln2, x))
