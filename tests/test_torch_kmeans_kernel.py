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



# --- the card kernel's arithmetic and launch geometry, checked on the CPU ---


def _tf32_rna(a):
    """f32 -> f32 rounded to TF32's 10 mantissa bits, ties away from zero
    (`cvt.rna.tf32.f32`), on the bit pattern."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _dot_3xtf32(x, c):
    """x.c as the card's assign kernel forms it: x_lo.c_hi + x_hi.c_lo +
    x_hi.c_hi, each product of TF32 operands, accumulated in f32."""
    x_hi = _tf32_rna(x)
    x_lo = _tf32_rna(x - x_hi)
    c_hi = _tf32_rna(c)
    c_lo = _tf32_rna(c - c_hi)
    return (x_lo @ c_hi.T + x_hi @ c_lo.T) + x_hi @ c_hi.T


def test_3xtf32_split_is_fp32_grade_at_the_main_path_scale():
    """The precision argument of csrc/kmeans.cu at 65,536 x 64, K=256.

    An emulation of the 3xTF32 split (here only; the package does not use
    it) keeps every dot product within 1e-5 x (|x|^2 + |c|^2) of the exact
    one, and its assignments equal the f32 plain version's outside
    near-ties (the two smallest plain d2 within 1e-5 x (|x|^2 + |c|^2), the
    rule of chip_smoke.py). One TF32 product alone misses by far more.
    """
    from repro_torch.core.kmeans import generate_points
    from repro_torch.kernels.kmeans.ref import kmeans_assign_ref

    pts, _ = generate_points(65_536, 256, d=64, seed=0)
    ctr = pts[:256].copy()  # init="first", as the main path starts
    c2 = np.sum(ctr * ctr, axis=1, dtype=np.float32)
    plain, _, _ = kmeans_assign_ref(torch.from_numpy(pts), torch.from_numpy(ctr))
    plain = plain.numpy()
    worst_3x = worst_1x = 0.0
    outside_ties = 0
    for i in range(0, len(pts), 16_384):
        x = pts[i:i + 16_384]
        x2 = np.sum(x * x, axis=1, dtype=np.float32)
        scale = x2[:, None].astype(np.float64) + c2[None, :]
        exact = x.astype(np.float64) @ ctr.astype(np.float64).T
        dot = _dot_3xtf32(x, ctr)
        worst_3x = max(worst_3x, float(np.max(np.abs(dot - exact) / scale)))
        one = _tf32_rna(x) @ _tf32_rna(ctr).T
        worst_1x = max(worst_1x, float(np.max(np.abs(one - exact) / scale)))

        d2 = (x2[:, None] + c2[None, :]) - np.float32(2.0) * dot
        got = np.argmin(d2, axis=1)
        d2_plain = (x2[:, None] + c2[None, :]) - np.float32(2.0) * (x @ ctr.T)
        best = plain[i:i + 16_384]
        top2 = np.sort(d2_plain, axis=1)[:, :2]
        tie = (top2[:, 1] - top2[:, 0]) <= 1e-5 * (x2 + c2[best])
        outside_ties += int(np.sum((got != best) & ~tie))
    assert worst_3x < 1e-5
    assert outside_ties == 0
    assert worst_1x > 100 * worst_3x


def test_tf32_rounding_emulation():
    """Round to nearest on the 13 dropped bits, ties away from zero; the
    residual of the split is exact in f32 and fits in TF32 up to 2 bits."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's spacing at 1.0
    vals = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20,
                     -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12], np.float32)
    want = np.array([one, one + ulp, one + ulp, -(one + ulp), one], np.float32)
    np.testing.assert_array_equal(_tf32_rna(vals), want)
    rng = np.random.default_rng(0)
    x = rng.normal(size=4096).astype(np.float32)
    hi = _tf32_rna(x)
    lo = _tf32_rna(x - hi)
    assert not np.any(hi.view(np.uint32) & 0x1FFF) and not np.any(lo.view(np.uint32) & 0x1FFF)
    assert np.max(np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)) < 2.0 ** -21


@pytest.mark.parametrize("k,d,ok", [(435, 64, True), (436, 64, True), (256, 64, True),
                                    (8082, 1, True), (8083, 1, True), (7, 3, True),
                                    (4, 65, True), (1024, 128, True), (4096, 256, True),
                                    (0, 4, False), (4, 0, False)])
def test_kernel_admits_its_contracted_shapes(k, d, ok):
    """Every K >= 1 and D >= 1: the kernel takes every shape the reference takes."""
    from repro_torch.kernels.kmeans.kernel import admits

    assert admits(k, d) is ok


@pytest.mark.parametrize("s,n", [(8, 524_288), (1, 77), (3, 1001), (8, 1000), (2, 2999),
                                 (1, 4000), (200, 300)])
def test_kernel_grid_covers_every_tile_once(s, n):
    from repro_torch.kernels.kmeans.kernel import ACC_TILE, ASSIGN_TILE, grid_for

    n_sms = 132
    assign_ctas, acc_ctas, per_cta = grid_for(s, n, n_sms)
    assert 1 <= assign_ctas <= min(n_sms, -(-s * n // ASSIGN_TILE))
    # every accumulate tile of a shard belongs to exactly one CTA, none idle
    tiles = -(-n // ACC_TILE)
    assert acc_ctas * per_cta >= tiles > (acc_ctas - 1) * per_cta
    assert acc_ctas * s <= max(n_sms, s)
