"""Block composition per architecture family (pre-norm residual blocks).

Counterpart of `repro/models/blocks.py` for the kinds the port serves:
`attn` (the dense and vlm families) and `moe`. The `mamba`, `rwkv`, `enc`
and `dec_cross` kinds and `remat_wrap` (training) are ROADMAP item 10.
"""

from __future__ import annotations

from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import MLP, Norm, apply_norm, mlp_apply

KINDS = ("attn", "moe")


class Block(nn.Module):
    def __init__(self, cfg, kind: str, device, n_model: int = 1):
        super().__init__()
        if kind not in KINDS:
            raise NotImplementedError(
                f"block kind {kind!r} is not ported yet (ROADMAP item 10); the port "
                f"has {KINDS}")
        d = cfg.d_model
        self.ln1 = Norm(d, device)
        self.attn = attn.Attention(cfg, device)
        self.ln2 = Norm(d, device)
        if kind == "attn":
            self.mlp = MLP(cfg, d, cfg.d_ff, device)
        else:
            self.moe = moe_mod.MoE(cfg, device, n_model)


def block_init(cfg, kind: str, n_model: int = 1, device=None) -> Block:
    """An uninitialised block (`layers.init_module` draws its parameters)."""
    return Block(cfg, kind, device, n_model)


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
