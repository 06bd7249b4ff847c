"""Device selection: the card by default, the CPU only when asked for."""

from __future__ import annotations

import torch


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
