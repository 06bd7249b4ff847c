"""Carry the JAX side's numpy material over to the port.

What crosses over is session key material, data and LM weights. These
helpers turn numpy values (as the JAX package holds or returns them) into
the port's objects on a given device, so both packages compute on identical
inputs. `lm_params` turns the reference's `init_params` tree into the port
model's `state_dict`, `adamw_state` the reference's AdamW state into the
port's optimizer state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.shuffle import SecureShuffleConfig
from repro_torch.device import resolve_device
from repro_torch.models.lm import check_family
from repro_torch.models.moe import padded_experts
from repro_torch.tree import tree_map


def secure_config(key_words, nonce_words, counter0: int = 0, coalesce="auto",
                  impl: str = "auto") -> SecureShuffleConfig:
    """A port `SecureShuffleConfig` from numpy key/nonce words and counter0."""
    kw = np.asarray(key_words, dtype=np.uint32).reshape(8)
    nw = np.asarray(nonce_words, dtype=np.uint32).reshape(3)
    return SecureShuffleConfig(key_words=kw, nonce_words=nw, counter0=int(counter0),
                               impl=impl, coalesce=coalesce)


def to_tensor(x, device=None) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a tensor on `device`."""
    device = resolve_device(device)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def to_tensors(tree, device=None):
    """A numpy pytree (points, weights, initial centres, ...) as tensors."""
    device = resolve_device(device)
    return tree_map(lambda x: to_tensor(x, device), tree)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 comes back as its uint16 bit patterns."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _named_leaves(tree, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _named_leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


# the reference's stacked trees (L, ...) and the config field giving each depth
STACKS = {"layers": "n_layers", "decoder": "n_layers", "encoder": "n_encoder_layers"}


def lm_params(cfg, np_params, n_model: int = 1) -> dict:
    """The port model's `state_dict` (CPU tensors, the reference's dtypes)
    from the reference's `init_params(cfg, key, n_model)` tree with numpy
    leaves: the stacked `layers`, `encoder` and `decoder` leaves (L, ...)
    are sliced into `<stack>.<i>.*`, each stack's depth checked against
    its config field; everything else (`shared_attn`, `enc_norm`, ...)
    keeps its path. Load it with `LM(cfg, n_model, device).load_state_dict(...)`,
    which casts each matrix into the model's compute dtype."""
    check_family(cfg)
    out = {}
    for name, leaf in _named_leaves(np_params):
        a = np.asarray(leaf)
        stack, _, rest = name.partition(".")
        if stack in STACKS:
            depth = getattr(cfg, STACKS[stack])
            if a.shape[0] != depth:
                raise ValueError(f"{name}: {a.shape[0]} stacked layers, config has {depth} "
                                 f"({STACKS[stack]})")
            for i in range(depth):
                out[f"{stack}.{i}.{rest}"] = to_tensor(np.array(a[i]), "cpu")
        else:
            out[name] = to_tensor(np.array(a), "cpu")
    if cfg.family == "moe":
        e = out["layers.0.moe.wi"].shape[0]
        if e != padded_experts(cfg, n_model):
            raise ValueError(f"{e} experts in the tree, {padded_experts(cfg, n_model)} "
                             f"for n_model={n_model}")
    return out


def adamw_state(cfg, np_opt_state, n_model: int = 1, device=None) -> dict:
    """The port's AdamW state (`repro_torch.optim.adamw_init`'s form) from the
    reference's `{"mu", "nu", "count"}` with numpy leaves: the moments
    sliced per layer as `lm_params` slices the parameters, on `device`."""
    device = resolve_device(device)
    out = {k: {name: t.to(device) for name, t in lm_params(cfg, np_opt_state[k],
                                                            n_model).items()}
           for k in ("mu", "nu")}
    out["count"] = torch.tensor(int(np.asarray(np_opt_state["count"])), dtype=torch.int32,
                                device=device)
    return out
