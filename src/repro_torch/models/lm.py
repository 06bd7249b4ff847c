"""LM assembly: init, forward and loss for every architecture family.

Counterpart of `repro/models/lm.py`. The reference scans stacked per-layer
parameters; the port holds one `Block` per layer (`layers.<i>`, and for
audio `encoder.<i>` and `decoder.<i>`) and walks them in a Python loop,
under the config's remat policy (`_walk_layers`: `remat_wrap` per layer,
and for `remat="sqrt"` the reference's second level of G groups).
Families:
  dense | vlm       attn blocks
  moe               attn+MoE blocks (secure-shuffle expert dispatch inside;
                    with `moe_remat="save_shuffle"` the backward keeps both
                    legs' outputs at both levels and replays no exchange),
                    after `first_dense_layers` attn blocks (`layer_kind`)
  ssm (rwkv6)       rwkv blocks
  hybrid (zamba2)   mamba blocks in groups of `attn_every`, each group
                    followed by ONE weight-shared attention+MLP block
                    (`shared_attn`), then the remainder without attention
  audio (whisper)   encoder walk (non-causal) + decoder walk with
                    cross-attention; the conv/mel frontend is a stub: the
                    inputs are frame embeddings (`batch["frames"]`)
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import blocks as B
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    Embed,
    Head,
    Norm,
    apply_norm,
    compute_dtype,
    embed_apply,
    init_module,
    unembed_apply,
)

PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def main_kind(cfg) -> str:
    return {
        "dense": "attn",
        "vlm": "attn",
        "moe": "moe",
        "ssm": "rwkv",
        "hybrid": "mamba",
        "audio": "dec_cross",
    }[cfg.family]


def layer_kind(cfg, i: int) -> str:
    """The block kind of layer i of `layers`: `main_kind`, but "attn" for a
    moe model's first `cfg.first_dense_layers` layers."""
    kind = main_kind(cfg)
    return "attn" if kind == "moe" and i < cfg.first_dense_layers else kind


def output_head(cfg, model):
    """The parameters the logits are read from: the embedding (tied) or,
    with `cfg.separate_head`, the head of its own (`head.table`)."""
    return model.head if cfg.separate_head else model.embed


def check_family(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the port has "
                         f"{PORTED_FAMILIES}")


class LM(nn.Module):
    """The model's parameters, named as the reference's tree: `embed.table`,
    `layers.<i>.*` (audio: `encoder.<i>.*`, `enc_norm.scale`,
    `decoder.<i>.*`; hybrid adds `shared_attn.*`), `final_norm.scale`, and
    `head.table` where `cfg.separate_head` (the port's own). Built
    uninitialised; `init_params` draws it, `load_state_dict` of
    `repro_torch.convert.lm_params` loads the reference's. `n_model` pads the
    experts to a multiple of the mesh's shards, as the reference's.

    `param_dtype` None holds the matrices in the compute dtype with no
    gradient (serving); a dtype (float32 for training, the reference's
    masters) holds every floating parameter in it, requiring grad."""

    def __init__(self, cfg, n_model: int = 1, device=None, param_dtype=None):
        super().__init__()
        check_family(cfg)
        device = resolve_device(device)
        self.embed = Embed(cfg, cfg.padded_vocab, cfg.d_model, device)

        def stack(kind, n):
            return nn.ModuleList(B.block_init(cfg, kind, n_model, device) for _ in range(n))

        if cfg.family == "audio":
            self.encoder = stack("enc", cfg.n_encoder_layers)
            self.enc_norm = Norm(cfg.d_model, device)
            self.decoder = stack("dec_cross", cfg.n_layers)
        else:
            self.layers = nn.ModuleList(B.block_init(cfg, layer_kind(cfg, i), n_model, device)
                                        for i in range(cfg.n_layers))
        if cfg.family == "hybrid":
            self.shared_attn = B.block_init(cfg, "attn", n_model, device)
        self.final_norm = Norm(cfg.d_model, device)
        if cfg.separate_head:
            self.head = Head(cfg, cfg.padded_vocab, cfg.d_model, device)
        if param_dtype is not None:
            self.to(param_dtype).requires_grad_(True)


def init_params(cfg, generator: torch.Generator, n_model: int = 1, device=None,
                param_dtype=None) -> LM:
    """A model with every parameter drawn from `generator` (on `device`)."""
    return init_module(LM(cfg, n_model, device, param_dtype), generator)


def _remat_groups(cfg, n_layers: int) -> int:
    """Outer group count for two-level (sqrt-L) remat, as the reference's:
    the walk keeps only G ≈ sqrt(L) group-boundary activations and each
    group recomputes its layers in the backward; 1 (per-layer remat alone)
    when not worthwhile."""
    if cfg.remat != "sqrt" or n_layers < 12:
        return 1
    best, best_cost = 1, float("inf")
    for g in range(2, n_layers + 1):
        if n_layers % g:
            continue
        cost = g + n_layers // g  # boundaries + recompute span
        if cost < best_cost:
            best, best_cost = g, cost
    return best


def _walk_layers(cfg, layers, carry, layer_step, save_ops=()):
    """carry = layer_step(carry, layer) over the layers in order, under the
    remat policy (the reference's `_scan_grouped`). `save_ops` are kept at
    BOTH levels: their outputs (the expert exchange's) are never replayed."""
    body = B.remat_wrap(cfg, layer_step, save_ops)
    groups = _remat_groups(cfg, len(layers))
    if groups == 1:
        for p in layers:
            carry = body(carry, p)
        return carry
    per = len(layers) // groups

    def group_step(carry, g):
        for p in layers[g * per:(g + 1) * per]:
            carry = body(carry, p)
        return carry

    group = B.checkpointed(group_step, save_ops)
    for g in range(groups):
        carry = group(carry, g)
    return carry


def _walk_hybrid(cfg, model, x, positions):
    """Mamba layers in groups of `attn_every`, the weight-SHARED attention
    block after each group, then the remainder layers without attention
    (the reference's `_scan_hybrid`): each mamba layer and the shared block
    under `remat_wrap`, and each whole group checkpointed, whatever the
    policy."""
    every = cfg.attn_every or (cfg.n_layers + 1)
    n_groups = cfg.n_layers // every
    mamba_body = B.remat_wrap(cfg, lambda p, h: B.apply_mamba_block(cfg, p, h)[0])
    attn_body = B.remat_wrap(cfg, lambda h: B.apply_attn_block(cfg, model.shared_attn, h,
                                                               positions))

    def walk(h, lo, hi):
        for p in model.layers[lo:hi]:
            h = mamba_body(p, h)
        return h

    group = B.checkpointed(lambda h, g: attn_body(walk(h, g * every, (g + 1) * every)))
    for g in range(n_groups):
        x = group(x, g)
    return walk(x, n_groups * every, cfg.n_layers)


def encode_audio(cfg, model, frames):
    """frames: (B, S_enc, d_model) frontend embeddings (the stub). Returns the
    cross-attention (k, v) of every decoder layer, stacked: (L, B, S_enc,
    Hkv, Dh) each."""
    b, s, _ = frames.shape
    pos = torch.arange(s, device=frames.device)[None].expand(b, s)
    h = _walk_layers(cfg, model.encoder, frames.to(compute_dtype(cfg)),
                     lambda hh, p: B.apply_attn_block(cfg, p, hh, pos, causal=False))
    h = apply_norm(cfg, model.enc_norm, h)
    kv = [attn.project_kv(cfg, p.xattn, h, pos, apply_rope=False) for p in model.decoder]
    return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])


def forward(cfg, model, batch, mesh=None, secure_moe=None):
    """batch: {"tokens": (B, T) int[, "frames": (B, S_enc, d) for audio]}.
    Returns (logits (B, T, V_pad), aux dict).

    Records a graph for the backward when grad is enabled and the model's
    parameters require it (a training model, `param_dtype`)."""
    check_family(cfg)
    tokens = batch["tokens"]
    b, t = tokens.shape
    x = embed_apply(cfg, model.embed, tokens)
    positions = torch.arange(t, device=tokens.device)[None].expand(b, t)
    aux = {"moe_aux": torch.zeros((), device=tokens.device),
           "moe_dropped": torch.zeros((), dtype=torch.int32, device=tokens.device)}
    if cfg.family == "moe":
        def step(carry, layer):
            (h, moe_aux, dropped), (i, p) = carry, layer
            if layer_kind(cfg, i) != "moe":
                return B.apply_attn_block(cfg, p, h, positions), moe_aux, dropped
            h, a, d = B.apply_moe_block(cfg, p, h, positions, mesh=mesh, secure=secure_moe)
            return h, moe_aux + a, dropped + d

        save = moe_mod.EXCHANGE_OPS if cfg.moe_remat == "save_shuffle" else ()
        x, moe_aux, dropped = _walk_layers(cfg, list(enumerate(model.layers)),
                                           (x, aux["moe_aux"], aux["moe_dropped"]), step,
                                           save)
        aux = {"moe_aux": moe_aux / cfg.n_moe_layers, "moe_dropped": dropped}
    elif cfg.family == "ssm":
        x = _walk_layers(cfg, model.layers, x, lambda h, p: B.apply_rwkv_block(cfg, p, h)[0])
    elif cfg.family == "hybrid":
        x = _walk_hybrid(cfg, model, x, positions)
    elif cfg.family == "audio":
        enc_k, enc_v = encode_audio(cfg, model, batch["frames"])
        body = B.remat_wrap(cfg, lambda p, k, v, h: B.apply_dec_cross_block(cfg, p, h,
                                                                            positions, (k, v)))
        for i, p in enumerate(model.decoder):
            x = body(p, enc_k[i], enc_v[i], x)
    else:
        x = _walk_layers(cfg, model.layers, x,
                         lambda h, p: B.apply_attn_block(cfg, p, h, positions))
    x = apply_norm(cfg, model.final_norm, x)
    return unembed_apply(cfg, output_head(cfg, model), x), aux


def loss_fn(cfg, model, batch, mesh=None, secure_moe=None, aux_coef: float = 0.01):
    """Next-token cross entropy in float32 (+ aux_coef · the MoE load-balance
    aux), over `batch["loss_mask"]` when given (of width T or T - 1).
    Returns (loss, {"nll", "moe_aux", "moe_dropped"})."""
    logits, aux = forward(cfg, model, batch, mesh, secure_moe)
    tokens = batch["tokens"]
    targets = tokens[:, 1:].long()
    lg = logits[:, :-1].float()
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, targets[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=tokens.device)
    elif mask.shape[1] == tokens.shape[1]:
        mask = mask[:, 1:]
    nll = torch.sum((lse - picked) * mask) / torch.clamp(torch.sum(mask), min=1.0)
    loss = nll + aux_coef * aux["moe_aux"]
    return loss, {"nll": nll, **aux}
