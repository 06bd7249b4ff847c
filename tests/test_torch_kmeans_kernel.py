"""Port k-means kernel API (repro_torch.kernels.kmeans) against the JAX kernel.

On the CPU `kmeans_assign` runs the plain version; it is held to
`repro.kernels.kmeans.ops.kmeans_assign(impl="pallas", interpret=True)` over
the shapes of tests/test_kernel_kmeans.py with its tolerances: assign exact,
sums rtol/atol 1e-5, counts rtol 1e-6 (float sums are taken in another
order). The CUDA kernel is held to the plain version by
tests/test_torch_gpu.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.kmeans.ops import kmeans_assign as jax_kmeans_assign
from repro_torch.kernels.kmeans.ops import kmeans_assign


def _check(got, want):
    a, s, c = got
    np.testing.assert_array_equal(a.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(s.numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(want[2]), rtol=1e-6)


@pytest.mark.parametrize(
    "n,d,k,tile",
    [(64, 2, 4, 16), (128, 8, 10, 32), (500, 2, 10, 128), (1024, 16, 50, 256), (77, 3, 7, 512)],
)
def test_matches_jax_kernel(n, d, k, tile):
    rng = np.random.default_rng(n + d + k)
    pts = rng.normal(size=(n, d)).astype(np.float32)
    ctr = rng.normal(size=(k, d)).astype(np.float32)
    want = jax_kmeans_assign(jnp.asarray(pts), jnp.asarray(ctr), impl="pallas", tile_n=tile,
                             interpret=True)
    _check(kmeans_assign(torch.from_numpy(pts), torch.from_numpy(ctr)), want)


def test_weights_match_jax_kernel():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(96, 4)).astype(np.float32)
    ctr = rng.normal(size=(5, 4)).astype(np.float32)
    w = (rng.random(96) > 0.3).astype(np.float32)
    want = jax_kmeans_assign(jnp.asarray(pts), jnp.asarray(ctr), jnp.asarray(w),
                             impl="pallas", tile_n=32, interpret=True)
    _check(kmeans_assign(torch.from_numpy(pts), torch.from_numpy(ctr), torch.from_numpy(w)), want)


@pytest.mark.parametrize("s,n,d,k", [(1, 64, 2, 4), (4, 100, 3, 7), (8, 96, 4, 8)])
def test_shard_batched_form_matches_jax_per_shard(s, n, d, k):
    """(S, n, D) points give per-shard sums (S, K, D) and counts (S, K)."""
    rng = np.random.default_rng(s * n)
    pts = rng.normal(size=(s, n, d)).astype(np.float32)
    ctr = rng.normal(size=(k, d)).astype(np.float32)
    w = (rng.random((s, n)) > 0.2).astype(np.float32)
    a, sums, counts = kmeans_assign(torch.from_numpy(pts), torch.from_numpy(ctr),
                                    torch.from_numpy(w))
    assert a.shape == (s, n) and sums.shape == (s, k, d) and counts.shape == (s, k)
    for i in range(s):
        want = jax_kmeans_assign(jnp.asarray(pts[i]), jnp.asarray(ctr), jnp.asarray(w[i]),
                                 impl="pallas", tile_n=32, interpret=True)
        _check((a[i], sums[i], counts[i]), want)


def test_impl_selector():
    pts = torch.zeros((4, 2))
    ctr = torch.ones((2, 2))
    kmeans_assign(pts, ctr, impl="torch")
    with pytest.raises(ValueError, match="impl must be one of"):
        kmeans_assign(pts, ctr, impl="jnp")

