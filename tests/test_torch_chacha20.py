"""Port ChaCha20 kernel API (repro_torch.kernels.chacha20) against the JAX ops.

On the CPU the port's wrappers run the kernel's plain version; it must equal
`repro.kernels.chacha20.ops` bit for bit, both with the Pallas kernel in
interpret mode and with the jnp oracle. The CUDA kernel itself is held to
the plain version by tests/test_torch_gpu.py and by `chip_smoke.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.chacha20 import ops as jops
from repro_torch.kernels.chacha20 import ops as tops

JAX_IMPLS = [("pallas", True), ("jnp", True)]


def u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def w(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32))


def _state(rng):
    kw = rng.integers(0, 2**32, 8, dtype=np.uint32)
    nw = rng.integers(0, 2**32, 3, dtype=np.uint32)
    return kw, nw


def test_make_state0_matches_jax():
    kw, nw = _state(np.random.default_rng(0))
    np.testing.assert_array_equal(u32(tops.make_state0(kw, nw, 2**32 - 1, device="cpu")),
                                  np.asarray(jops.make_state0(kw, nw, 2**32 - 1)))


@pytest.mark.parametrize("impl,interpret", JAX_IMPLS)
@pytest.mark.parametrize("n,counter0", [(1, 0), (45, 2**32 - 2), (16, 2**32 - 1),
                                        (300, 7)])
def test_xor_words_matches_jax(impl, interpret, n, counter0):
    rng = np.random.default_rng(n)
    kw, nw = _state(rng)
    words = rng.integers(0, 2**32, n, dtype=np.uint32)
    want = jops.chacha20_xor_words(jnp.asarray(words), jops.make_state0(kw, nw, counter0),
                                   impl=impl, interpret=interpret)
    got = tops.chacha20_xor_words(w(words), tops.make_state0(kw, nw, counter0, device="cpu"))
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("impl,interpret", JAX_IMPLS)
@pytest.mark.parametrize("r,n", [(1, 5), (4, 37), (8, 130), (3, 32), (2, 1)])
def test_xor_rows_matches_jax(impl, interpret, r, n):
    rng = np.random.default_rng(r * 100 + n)
    kw, nw = _state(rng)
    words = rng.integers(0, 2**32, (r, n), dtype=np.uint32)
    nid = rng.integers(0, 2**32, r, dtype=np.uint32)
    starts = rng.integers(0, 2**32, r, dtype=np.uint32)
    starts[0] = 2**32 - 1  # the row's counters wrap
    want = jops.chacha20_xor_rows(jnp.asarray(words), jops.make_state0(kw, nw, 0),
                                  jnp.asarray(nid), jnp.asarray(starts),
                                  impl=impl, interpret=interpret)
    got = tops.chacha20_xor_rows(w(words), tops.make_state0(kw, nw, 0, device="cpu"), nid, starts)
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("impl,interpret", JAX_IMPLS)
@pytest.mark.parametrize("r,blocks", [(1, 1), (4, 3), (8, 9)])
def test_xor_rows_coalesced_matches_jax(impl, interpret, r, blocks):
    rng = np.random.default_rng(r * 10 + blocks)
    kw, nw = _state(rng)
    words = rng.integers(0, 2**32, (r, 16 * blocks), dtype=np.uint32)
    nid = rng.integers(0, 2**32, r, dtype=np.uint32)
    rows = rng.integers(0, 2**32, r, dtype=np.uint32)
    base = rng.integers(0, 2**32, blocks, dtype=np.uint32)
    mul = rng.integers(0, 2**32, blocks, dtype=np.uint32)
    base[0], mul[0] = 2**32 - 1, 1  # wraps for every row but row counter 0
    want = jops.chacha20_xor_rows_coalesced(
        jnp.asarray(words), jops.make_state0(kw, nw, 0), jnp.asarray(nid), jnp.asarray(rows),
        jnp.asarray(base), jnp.asarray(mul), impl=impl, interpret=interpret)
    got = tops.chacha20_xor_rows_coalesced(w(words), tops.make_state0(kw, nw, 0, device="cpu"),
                                           nid, rows, base, mul)
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("impl,interpret", JAX_IMPLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_ctr_crypt_array_matches_jax(impl, interpret, dtype):
    rng = np.random.default_rng(3)
    kw, nw = _state(rng)
    a = rng.normal(size=(5, 7)).astype(np.float32)
    if dtype == "uint8":
        a = rng.integers(0, 256, (5, 7)).astype(np.uint8)
        jx, tx = jnp.asarray(a), torch.from_numpy(a.copy())
    elif dtype == "bfloat16":
        jx = jnp.asarray(a).astype(jnp.bfloat16)
        tx = torch.from_numpy(np.asarray(jx).view(np.uint16).view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        a = (a * 50).astype(dtype)
        jx, tx = jnp.asarray(a), torch.from_numpy(a.copy())
    want = jops.ctr_crypt_array(jx, kw, nw, 9, impl=impl, interpret=interpret)
    got = tops.ctr_crypt_array(tx, kw, nw, 9)
    assert bytes(got.contiguous().view(torch.uint8).numpy()) == np.asarray(want).tobytes()


@pytest.mark.parametrize("n", [1, 16, 17, 40])
def test_row_table_is_row_aligned(n):
    """The row-aligned entry points' table: block j = words 16j.., counter j,
    the last block cut to the row."""
    from repro_torch.kernels.chacha20.table import row_table

    table = row_table(n, torch.device("cpu"))
    tab = table.words.numpy()
    blocks = -(-n // 16)
    np.testing.assert_array_equal(tab[:, 0], np.arange(blocks))
    np.testing.assert_array_equal(tab[:, 1], np.ones(blocks))
    np.testing.assert_array_equal(tab[:, 2], 16 * np.arange(blocks))
    np.testing.assert_array_equal(tab[:, 3], [min(16, n - 16 * j) for j in range(blocks)])
    assert table.aligned == (n % 16 == 0)
    assert row_table(n, torch.device("cpu")) is table


def test_impl_selector():
    s0 = tops.make_state0(np.zeros(8, np.uint32), np.zeros(3, np.uint32), 0, device="cpu")
    x = torch.zeros(16, dtype=torch.int32)
    a = tops.chacha20_xor_words(x, s0, impl="torch")
    np.testing.assert_array_equal(u32(a), u32(tops.chacha20_xor_words(x, s0)))
    with pytest.raises(ValueError, match="impl must be one of"):
        tops.chacha20_xor_words(x, s0, impl="pallas")

