"""Carry the JAX side's numpy material over to the port.

The port has no weights; what crosses over is session key material and
data. These helpers turn numpy values (as the JAX package holds or returns
them) into the port's objects on a given device, so both packages compute
on identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.shuffle import SecureShuffleConfig
from repro_torch.device import resolve_device
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
