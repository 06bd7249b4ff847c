"""Hand-written Hopper kernels, each beside its plain PyTorch version.

`impl` selectors keep the JAX package's argument names for parity. Their
values are 'auto' (the tensor's device decides: the kernel for a CUDA
tensor, the plain version for a CPU tensor) and 'torch' (the plain version,
refused for a CUDA tensor, where the kernel is the only route).

`kernel_calls` counts calls of the kernels' dispatch points, kernel or plain
version alike (`repro_torch.tools.opcount`).
"""

from __future__ import annotations

import torch

from repro_torch.tools.opcount import CallCounter

IMPLS = ("auto", "torch")
kernel_calls = CallCounter()


def uses_kernel(impl: str, t: torch.Tensor) -> bool:
    """True when `t` goes through the Hopper kernel, False for the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if t.is_cuda:
        if impl == "torch":
            raise ValueError("impl='torch' is the plain CPU version; a CUDA "
                             "tensor runs the hand-written kernel (impl='auto')")
        return True
    return False
