"""Port crypto (repro_torch.crypto) against repro.crypto, plus the port's rules.

All inputs come from numpy seeds. Every comparison here is exact: keystream
words, packed wire words and ciphertext bytes must be equal bit for bit.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.crypto import chacha as jch
from repro.crypto import ctr as jctr
from repro_torch.crypto import chacha as tch
from repro_torch.crypto import ctr as tctr
from repro_torch.kernels.chacha20 import ops as tops
from rfc_vectors import (
    RFC_BLOCK_232,
    RFC_CIPHERTEXT,
    RFC_KEY,
    RFC_NONCE_232,
    RFC_NONCE_242,
    RFC_PLAINTEXT,
)

ROOT = Path(__file__).resolve().parents[1]


def u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


# --- RFC 8439 ---------------------------------------------------------------------


def test_rfc8439_block_tensor_path():
    kw, nw = tch.key_to_words(RFC_KEY), tch.nonce_to_words(RFC_NONCE_232)
    out = tch.chacha20_block_words(kw, np.array([1], np.uint32), nw, device="cpu")
    np.testing.assert_array_equal(u32(out)[0], RFC_BLOCK_232)


def test_rfc8439_encrypt_bytes_host_path():
    assert tch.chacha20_encrypt_bytes(RFC_KEY, RFC_NONCE_242, 1, RFC_PLAINTEXT) == RFC_CIPHERTEXT


def test_rfc8439_through_kernel_api():
    """The RFC vectors through the kernel wrapper (plain version on the CPU)."""
    kw = tch.key_to_words(RFC_KEY)
    s0 = tops.make_state0(kw, tch.nonce_to_words(RFC_NONCE_232), 1, device="cpu")
    blk = tops.chacha20_xor_words(torch.zeros(16, dtype=torch.int32), s0)
    np.testing.assert_array_equal(u32(blk), RFC_BLOCK_232)
    pt = torch.frombuffer(bytearray(RFC_PLAINTEXT), dtype=torch.uint8)
    ct = tops.ctr_crypt_array(pt, kw, tch.nonce_to_words(RFC_NONCE_242), 1)
    assert bytes(ct.numpy()) == RFC_CIPHERTEXT


# --- block words and keystreams == repro.crypto.chacha ----------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_words_match_jax(seed):
    """Random keys/nonces and counters, including the 2**32 wrap."""
    rng = np.random.default_rng(seed)
    kw = rng.integers(0, 2**32, 8, dtype=np.uint32)
    nw = rng.integers(0, 2**32, 3, dtype=np.uint32)
    ctrs = np.concatenate([rng.integers(0, 2**32, 13, dtype=np.uint32),
                           np.array([0, 2**32 - 1, 2**31], np.uint32)])
    want = np.asarray(jch.chacha20_block_words(kw, ctrs, nw))
    got = u32(tch.chacha20_block_words(kw, ctrs, nw, device="cpu"))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("counter0,n_words", [(0, 1), (7, 33), (2**32 - 2, 70)])
def test_keystream_words_match_jax(counter0, n_words):
    rng = np.random.default_rng(n_words)
    kw = rng.integers(0, 2**32, 8, dtype=np.uint32)
    nw = rng.integers(0, 2**32, 3, dtype=np.uint32)
    want = np.asarray(jch.chacha20_keystream_words(kw, nw, counter0, n_words))
    got = u32(tch.chacha20_keystream_words(kw, nw, counter0, n_words, device="cpu"))
    np.testing.assert_array_equal(got, want)


# --- word packing == repro.crypto.ctr ---------------------------------------------


def _sample(rng, dtype: str, n: int) -> np.ndarray:
    if dtype == "uint32":
        return rng.integers(0, 2**32, n, dtype=np.uint32)
    if dtype == "int32":
        return rng.integers(-2**31, 2**31, n, dtype=np.int32)
    if dtype == "uint8":
        return rng.integers(0, 256, n, dtype=np.uint8)
    bits = rng.integers(0, 2**32, n, dtype=np.uint32)
    bits[::3] = 0x7FC00000 | (bits[::3] & 0x3FFFFF)  # NaNs with payloads
    return bits.view(np.float32)


def _bf16_pair(rng, n):
    """The same bf16 values as a JAX array and a torch tensor (NaN payloads kept)."""
    bits = rng.integers(0, 2**16, n, dtype=np.uint16)
    bits[::4] = 0x7FC1 | (bits[::4] & 0x3E)
    jx = jnp.asarray(bits).view(jnp.bfloat16)
    tx = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    return jx, tx


@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32", "uint8", "bfloat16"])
@pytest.mark.parametrize("n", [1, 3, 7, 33])
def test_to_words_from_words_match_jax(dtype, n):
    rng = np.random.default_rng(n)
    if dtype == "bfloat16":
        jx, tx = _bf16_pair(rng, n)
    else:
        a = _sample(rng, dtype, n)
        jx, tx = jnp.asarray(a), torch.from_numpy(a.copy())
    jw, jpad = jctr._to_words(jx)
    tw, tpad = tctr._to_words(tx)
    assert tpad == jpad == jctr.pad_for(jx.shape, jx.dtype) == tctr.pad_for(tx.shape, tx.dtype)
    assert tctr.words_for(tx.shape, tx.dtype) == jctr.words_for(jx.shape, jx.dtype)
    np.testing.assert_array_equal(u32(tw), np.asarray(jw))
    back = tctr._from_words(tw, tx.shape, tx.dtype, tpad)
    assert back.dtype == tx.dtype
    assert bytes(back.contiguous().view(torch.uint8).numpy()) == bytes(
        tx.contiguous().view(torch.uint8).numpy())


def test_bf16_words_are_jax_words():
    """bf16 [1.0, 2.0] packs to the word 0x40003F80, as in JAX."""
    w, pad = tctr._to_words(torch.tensor([1.0, 2.0], dtype=torch.bfloat16))
    assert pad == 0 and u32(w).tolist() == [0x40003F80]
    jw, _ = jctr._to_words(jnp.asarray([1.0, 2.0], jnp.bfloat16))
    assert np.asarray(jw).tolist() == [0x40003F80]


def test_encrypt_array_and_tree_match_jax():
    rng = np.random.default_rng(5)
    kw = rng.integers(0, 2**32, 8, dtype=np.uint32)
    nw = rng.integers(0, 2**32, 3, dtype=np.uint32)
    a = rng.normal(size=(5, 7)).astype(np.float32)
    b = rng.integers(-9, 9, (3,), dtype=np.int32)
    want = np.asarray(jctr.encrypt_array(jnp.asarray(a), kw, nw, 11))
    got = tctr.encrypt_array(torch.from_numpy(a), kw, nw, 11)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    jt, jnext = jctr.encrypt_tree({"b": jnp.asarray(b), "a": jnp.asarray(a)}, kw, nw, 3)
    tt, tnext = tctr.encrypt_tree({"b": torch.from_numpy(b), "a": torch.from_numpy(a)}, kw, nw, 3)
    assert int(jnext) == tnext
    for key in ("a", "b"):
        np.testing.assert_array_equal(tt[key].numpy().view(np.uint32),
                                      np.asarray(jt[key]).view(np.uint32))
    back, _ = tctr.decrypt_tree(tt, kw, nw, 3)
    np.testing.assert_array_equal(back["a"].numpy(), a)


# --- the port's rules -------------------------------------------------------------


def test_port_imports_no_jax_and_no_repro():
    """Every repro_torch module and chip_smoke.py import with `jax` and
    `repro` blocked from import."""
    code = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT / "src")!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location("chip_smoke", {str(ROOT / "chip_smoke.py")!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
        print(len(names))
    """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert int(p.stdout.strip()) >= 15


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    """With no CUDA card, an entry point given no device raises instead of
    running on the CPU."""
    from repro_torch import VirtualMesh
    from repro_torch.core.kmeans import kmeans_fit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VirtualMesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tch.chacha20_keystream_words(np.zeros(8, np.uint32), np.zeros(3, np.uint32), 0, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.make_state0(np.zeros(8, np.uint32), np.zeros(3, np.uint32), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kmeans_fit(np.zeros((8, 2), np.float32), 2, VirtualMesh(1))
    # the CPU is taken when it is named
    assert VirtualMesh(4, "cpu").device.type == "cpu"
