"""PyTorch/CUDA port of the secure MapReduce framework in `repro`.

The port mirrors `repro`'s subpackages (`crypto/`, `kernels/chacha20/`,
`kernels/kmeans/`, `core/`) so the counterpart of each module is found
under the same name. It imports `torch` and numpy only. Entry points run
on the CUDA card unless the caller passes `device="cpu"`; on the CPU every
hand-written kernel is replaced by its plain PyTorch version (`ref.py`).

Words of a ChaCha20 wire are 32-bit patterns held in `torch.int32` tensors:
torch's `uint32` has no addition or shifts on the CPU, while `int32` carries
the same bits and supports every operation the port needs on both devices.
"""

from repro_torch.device import resolve_device
from repro_torch.mesh import VirtualMesh

__all__ = ["VirtualMesh", "resolve_device"]
