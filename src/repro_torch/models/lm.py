"""LM assembly: init and forward for the dense, vlm and moe families.

Counterpart of `repro/models/lm.py`. The reference scans stacked per-layer
parameters; the port holds one `Block` per layer (`layers.<i>`) and walks
them in a Python loop. The moe family runs the secure-shuffle expert
dispatch inside each block. Training's remat and `loss_fn`, and the ssm,
hybrid and audio families, are ROADMAP item 10: `init_params` raises
NotImplementedError for those families.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.layers import (
    Embed,
    Norm,
    apply_norm,
    embed_apply,
    init_module,
    unembed_apply,
)

PORTED_FAMILIES = ("dense", "vlm", "moe")


def main_kind(cfg) -> str:
    return {
        "dense": "attn",
        "vlm": "attn",
        "moe": "moe",
        "ssm": "rwkv",
        "hybrid": "mamba",
        "audio": "dec_cross",
    }[cfg.family]


def check_family(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (ROADMAP item 10); "
            f"the port serves {PORTED_FAMILIES}")


class LM(nn.Module):
    """The model's parameters, named as the reference's tree: `embed.table`,
    `layers.<i>.{ln1,attn,ln2,mlp|moe}.*`, `final_norm.scale`. Built
    uninitialised; `init_params` draws it, `load_state_dict` of
    `repro_torch.convert.lm_params` loads the reference's. `n_model` pads the
    experts to a multiple of the mesh's shards, as the reference's."""

    def __init__(self, cfg, n_model: int = 1, device=None):
        super().__init__()
        check_family(cfg)
        device = resolve_device(device)
        self.embed = Embed(cfg, cfg.padded_vocab, cfg.d_model, device)
        self.layers = nn.ModuleList(B.block_init(cfg, main_kind(cfg), n_model, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg.d_model, device)


def init_params(cfg, generator: torch.Generator, n_model: int = 1, device=None) -> LM:
    """A model with every parameter drawn from `generator` (on `device`)."""
    return init_module(LM(cfg, n_model, device), generator)


@torch.no_grad()
def forward(cfg, model, batch, mesh=None, secure_moe=None):
    """batch: {"tokens": (B, T) int}. Returns (logits (B, T, V_pad), aux dict)."""
    check_family(cfg)
    tokens = batch["tokens"]
    b, t = tokens.shape
    x = embed_apply(cfg, model.embed, tokens)
    positions = torch.arange(t, device=tokens.device)[None].expand(b, t)
    aux = {"moe_aux": torch.zeros((), device=tokens.device),
           "moe_dropped": torch.zeros((), dtype=torch.int32, device=tokens.device)}
    if cfg.family == "moe":
        moe_aux, dropped = aux["moe_aux"], aux["moe_dropped"]
        for p in model.layers:
            x, a, d = B.apply_moe_block(cfg, p, x, positions, mesh=mesh, secure=secure_moe)
            moe_aux, dropped = moe_aux + a, dropped + d
        aux = {"moe_aux": moe_aux / cfg.n_layers, "moe_dropped": dropped}
    else:
        for p in model.layers:
            x = B.apply_attn_block(cfg, p, x, positions)
    x = apply_norm(cfg, model.final_norm, x)
    return unembed_apply(cfg, model.embed, x), aux
