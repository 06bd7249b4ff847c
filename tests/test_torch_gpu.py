"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `gpu` and skips without a CUDA card: the kernels
have no CPU mode. This file imports no JAX, so it also runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: ChaCha20 output exact; k-means assignments equal to the plain
version's except at near-ties (at most 1 in 1,000 points here), sums within
rtol/atol 1e-5 and counts within rtol 1e-6 of the plain accumulate fed the
kernel's own assignments, and two runs identical bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.chacha20 import ops as tops
from repro_torch.kernels.chacha20.ref import chacha20_xor_rows_ref
from repro_torch.kernels.kmeans.ops import kmeans_assign
from repro_torch.kernels.kmeans.ref import kmeans_accumulate_ref, kmeans_assign_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def w(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,blocks", [(1, 1), (64, 132), (5, 1000)])
def test_chacha20_kernel_matches_plain(cuda, rows, blocks):
    from repro_torch.kernels.chacha20 import kernel

    rng = np.random.default_rng(rows + blocks)
    args = [w(rng.integers(0, 2**32, s, dtype=np.uint32)).to(cuda)
            for s in [(rows, blocks, 16), 16, rows, rows, blocks, blocks]]
    before = kernel.launches
    got = kernel.chacha20_xor_rows_cuda(*args)
    assert kernel.launches == before + 1
    assert torch.equal(got.cpu(), chacha20_xor_rows_ref(*[a.cpu() for a in args]))
    with pytest.raises(ValueError, match="impl='torch'"):
        tops.chacha20_xor_words(args[0].reshape(-1), args[1], impl="torch")


@pytest.mark.gpu
@pytest.mark.parametrize("s,n,d,k", [(1, 77, 3, 7), (8, 1000, 4, 8), (2, 5000, 64, 256)])
def test_kmeans_kernel_matches_plain(cuda, s, n, d, k):
    from repro_torch.kernels.kmeans import kernel

    rng = np.random.default_rng(n)
    pts = torch.as_tensor(rng.random((s, n, d)).astype(np.float32), device=cuda)
    ctr = torch.as_tensor(rng.random((k, d)).astype(np.float32), device=cuda)
    wt = torch.as_tensor((rng.random((s, n)) > 0.2).astype(np.float32), device=cuda)
    before = kernel.launches
    a, sums, counts = kmeans_assign(pts, ctr, wt)
    a2, sums2, counts2 = kmeans_assign(pts, ctr, wt)
    assert kernel.launches == before + 2
    assert torch.equal(a, a2) and torch.equal(sums, sums2) and torch.equal(counts, counts2)
    ra, _, _ = kmeans_assign_ref(pts, ctr, wt)
    assert float((ra != a).float().mean()) <= 1e-3
    ps, pc = kmeans_accumulate_ref(pts, a, wt, k)
    torch.testing.assert_close(sums, ps, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(counts, pc, rtol=1e-6, atol=0.0)
    with pytest.raises(ValueError, match="impl='torch'"):
        kmeans_assign(pts, ctr, wt, impl="torch")
