"""Device selection (the card by default, the CPU only when asked for), and
the device constants that a captured CUDA graph reads."""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

_pins = threading.local()


def resolve_device(device=None) -> torch.device:
    """Return the device an entry point runs on.

    None means the CUDA card. Without a card that raises instead of running
    on the CPU; the CPU path (plain PyTorch versions of every kernel) is
    taken only when the caller names it, e.g. `device="cpu"`.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@contextmanager
def pinned_constants(store: dict):
    """Inside, `device_constant` looks its values up in `store` first and
    adds what it builds there.

    A CUDA graph captured inside keeps the addresses of the device constants
    it read (block tables, exchange ids); the owner of `store` keeps those
    tensors alive for as long as it replays the graph, whatever the LRU
    caches behind them evict meanwhile, and a later capture into the same
    store copies nothing from the host. Nests per thread; the innermost wins.
    """
    stack = _pins.__dict__.setdefault("stack", [])
    stack.append(store)
    try:
        yield store
    finally:
        stack.pop()


def device_constant(cached_fn, *args):
    """`cached_fn(*args)`, a device tensor (or a tuple of them) from an LRU
    cache, taken through the innermost `pinned_constants` store if any."""
    stack = getattr(_pins, "stack", None)
    if not stack:
        return cached_fn(*args)
    store = stack[-1]
    key = (cached_fn, args)
    if key not in store:
        store[key] = cached_fn(*args)
    return store[key]
