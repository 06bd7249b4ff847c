"""The port's MAC, key hierarchy and counter-mode leftovers against the JAX package.

Counterparts of `tests/test_crypto.py:123-192` (the MAC and keys) and of its
`tree_counter_blocks` check, each holding the port to `repro.crypto` on the
same seeded inputs: MAC tags, derived keys, nonces and ciphertexts equal bit
for bit; `_mulmod31` exact against Python ints.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.crypto import chacha as jch
from repro.crypto import ctr as jctr
from repro.crypto import keys as jkeys
from repro.crypto import mac as jmac
from repro_torch.crypto import chacha as tch
from repro_torch.crypto import ctr as tctr
from repro_torch.crypto import keys as tkeys
from repro_torch.crypto import mac as tmac

KW = tch.key_to_words(bytes(range(32)))
NW = tch.nonce_to_words(b"\x01" * 12)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.int32).view(np.uint32)


def test_mac_keys_from_keystream_match_jax():
    for ctr in (0, 3, 7, 2**32 - 1):
        for a, b in zip(tmac.mac_keys_from_keystream(KW, NW, ctr),
                        jmac.mac_keys_from_keystream(KW, NW, ctr)):
            np.testing.assert_array_equal(a, b)


def test_mac_device_matches_host():
    rs, ss = tmac.mac_keys_from_keystream(KW, NW, 7)
    msg = np.arange(100, dtype=np.uint32) * np.uint32(2654435761)
    t_host = tmac.mac_tag_host(msg, rs, ss)
    t_dev = _u32(tmac.mac_tag_words(torch.from_numpy(msg.view(np.int32)), rs, ss))
    np.testing.assert_array_equal(t_host, t_dev)
    np.testing.assert_array_equal(t_host, jmac.mac_tag_host(msg, rs, ss))


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 4096])
def test_mac_tag_words_equals_jax_bit_for_bit(n):
    """The blocked int64 Horner on the tensor's device gives the reference's
    word-at-a-time `lax.scan` tag exactly, at lengths around its blocks."""
    rng = np.random.default_rng(n)
    msg = rng.integers(0, 2**32, n, dtype=np.uint32)
    rs, ss = tmac.mac_keys_from_keystream(KW, NW, n + 1)
    want = np.asarray(jmac.mac_tag_words(jnp.asarray(msg), jnp.asarray(rs), jnp.asarray(ss)))
    got = tmac.mac_tag_words(torch.from_numpy(msg.view(np.int32)), rs, ss)
    assert got.dtype == torch.int32 and got.shape == (4,)
    np.testing.assert_array_equal(_u32(got), want)
    # tensors for the keys, and a u32 view of the words, give the same tag
    again = tmac.mac_tag_words(torch.from_numpy(msg.view(np.int32)).view(torch.uint32),
                               torch.from_numpy(rs.view(np.int32)),
                               torch.from_numpy(ss.view(np.int32)))
    assert torch.equal(again, got)


def test_mac_detects_tamper():
    rs, ss = tmac.mac_keys_from_keystream(KW, NW, 3)
    msg = np.arange(64, dtype=np.uint32)
    tag = tmac.mac_tag_host(msg, rs, ss)
    bad = msg.copy()
    bad[10] ^= 1
    assert not tmac.mac_verify_host(bad, rs, ss, tag)
    assert tmac.mac_verify_host(msg, rs, ss, tag)
    dev = tmac.mac_tag_words(torch.from_numpy(bad.view(np.int32)), rs, ss)
    assert not np.array_equal(_u32(dev), tag)


def test_mac_length_extension_guard():
    rs, ss = tmac.mac_keys_from_keystream(KW, NW, 3)
    a, b = np.zeros(4, np.uint32), np.zeros(5, np.uint32)
    assert not np.array_equal(tmac.mac_tag_host(a, rs, ss), tmac.mac_tag_host(b, rs, ss))
    ta = tmac.mac_tag_words(torch.from_numpy(a.view(np.int32)), rs, ss)
    tb = tmac.mac_tag_words(torch.from_numpy(b.view(np.int32)), rs, ss)
    assert not torch.equal(ta, tb)


def test_mac_tamper_seeded_sweep():
    """The reference's hypothesis tamper property on 50 seeded cases."""
    rs, ss = tmac.mac_keys_from_keystream(KW, NW, 11)
    rng = np.random.default_rng(11)
    for _ in range(50):
        msg = rng.integers(0, 2**32, int(rng.integers(1, 65)), dtype=np.uint32)
        tag = tmac.mac_tag_host(msg, rs, ss)
        bad = msg.copy()
        i = int(rng.integers(0, len(bad)))
        bad[i] = np.uint32((int(bad[i]) + int(rng.integers(1, 2**31))) % 2**32)
        if np.array_equal(bad % np.uint64(tmac.P31), msg % np.uint64(tmac.P31)):
            continue  # same residues -> same tag by design (31-bit field)
        assert not np.array_equal(tmac.mac_tag_host(bad, rs, ss), tag)
        dev = tmac.mac_tag_words(torch.from_numpy(bad.view(np.int32)), rs, ss)
        np.testing.assert_array_equal(_u32(dev), tmac.mac_tag_host(bad, rs, ss))


def test_mulmod31_and_mod31_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(0, tmac.P31, size=200, dtype=np.int64)
    b = rng.integers(0, tmac.P31, size=200, dtype=np.int64)
    got = tmac._mulmod31(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = [(int(x) * int(y)) % tmac.P31 for x, y in zip(a, b)]
    np.testing.assert_array_equal(got, np.array(want, np.int64))
    ref = np.asarray(jmac._mulmod31(jnp.asarray(a.astype(np.uint32)),
                                    jnp.asarray(b.astype(np.uint32))))
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    x = rng.integers(0, 2**32, size=200, dtype=np.int64)
    np.testing.assert_array_equal(
        tmac._mod31(torch.from_numpy(x)).numpy(),
        np.asarray(jmac._mod31(jnp.asarray(x.astype(np.uint32)))).astype(np.int64))


def test_key_hierarchy_and_attestation():
    kh = tkeys.KeyHierarchy(master=b"\x42" * 32)
    m = kh.attestation.enroll(b"worker-code-v1")
    sk = kh.release_keys(m)
    assert sk.data != sk.code and len(sk.data) == 32
    with pytest.raises(PermissionError):
        kh.release_keys(tkeys.Attestation.measure(b"evil-code"))
    kek = b"\x99" * 32
    wrapped = kh.wrap_key("data", kek)
    assert wrapped != sk.data
    assert tkeys.KeyHierarchy.unwrap_key("data", kek, wrapped) == sk.data
    # the same master derives the reference's session keys and wrapped forms
    jkh = jkeys.KeyHierarchy(master=b"\x42" * 32)
    assert m == jkh.attestation.enroll(b"worker-code-v1")
    for label in tkeys.LABELS:
        assert getattr(sk, label) == getattr(jkh.session, label)
        np.testing.assert_array_equal(sk.words(label), jkh.session.words(label))
        assert kh.wrap_key(label, kek) == jkh.wrap_key(label, kek)
    with pytest.raises(ValueError):
        tkeys.KeyHierarchy(master=b"short")


def test_derive_key_deterministic_and_distinct():
    m = b"\x01" * 32
    assert tkeys.derive_key(m, "data") == tkeys.derive_key(m, "data")
    assert tkeys.derive_key(m, "data") != tkeys.derive_key(m, "code")
    for label in tkeys.LABELS:
        assert tkeys.derive_key(m, label) == jkeys.derive_key(m, label)
    for label, stream in (("sub", 1), ("hdr", 77), ("page:p3", 0)):
        assert tkeys.SessionKeys.nonce(label, stream) == jkeys.SessionKeys.nonce(label, stream)
        np.testing.assert_array_equal(tkeys.SessionKeys.nonce_words(label, stream),
                                      jkeys.SessionKeys.nonce_words(label, stream))
    with pytest.raises(ValueError):
        tkeys.derive_key(b"short", "data")


def _tree():
    rng = np.random.default_rng(3)
    return {"a": rng.random(17).astype(np.float32),
            "b": (np.arange(5, dtype=np.int32), rng.integers(0, 255, (2, 9)).astype(np.uint8))}


def test_tree_counter_blocks_matches_jax():
    tree = _tree()
    assert tctr.tree_counter_blocks(tree) == jctr.tree_counter_blocks(tree)
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": tuple(torch.from_numpy(x) for x in tree["b"])}
    assert tctr.tree_counter_blocks(ttree) == jctr.tree_counter_blocks(tree)


@pytest.mark.parametrize("counter0", [0, 5, 2**32 - 2])
def test_encrypt_tree_takes_a_device_counter(counter0):
    """`counter0` as a 0-d tensor: the same ciphertext as a host int and as
    the reference's, and the next counter back as a tensor, never read."""
    tree = _tree()
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": tuple(torch.from_numpy(x) for x in tree["b"])}
    jenc, jnext = jctr.encrypt_tree({"a": jnp.asarray(tree["a"]),
                                     "b": tuple(jnp.asarray(x) for x in tree["b"])},
                                    KW, NW, jnp.uint32(counter0))
    by_int, next_int = tctr.encrypt_tree(ttree, KW, NW, counter0)
    c0 = torch.tensor(counter0, dtype=torch.int64)
    by_tensor, next_tensor = tctr.encrypt_tree(ttree, KW, NW, c0)
    assert isinstance(next_tensor, torch.Tensor) and next_tensor.dim() == 0
    assert int(next_tensor) == next_int == counter0 + tctr.tree_counter_blocks(tree)
    for t_leaf, i_leaf, j_leaf in zip(tctr.tree_flatten(by_tensor)[0],
                                      tctr.tree_flatten(by_int)[0],
                                      tctr.tree_flatten(jenc)[0]):
        assert torch.equal(t_leaf, i_leaf)
        np.testing.assert_array_equal(t_leaf.numpy(), np.asarray(j_leaf))
    back, _ = tctr.decrypt_tree(by_tensor, KW, NW, c0)
    np.testing.assert_array_equal(back["a"].numpy(), tree["a"])
    np.testing.assert_array_equal(back["b"][1].numpy(), tree["b"][1])


@pytest.mark.parametrize("counter0", [0, 5, 2**32 - 2])
def test_kernel_wrapper_takes_a_device_counter(counter0):
    """The ChaCha20 kernel's array wrapper (what `encrypt_array` calls on a
    CUDA tensor) takes the counter as a 0-d tensor, which enters the kernel
    as the row's counter start: the same bits as a host counter and as the
    PyTorch ARX, across the 2**32 wrap. Here it runs the kernel's plain
    version; tests/test_torch_gpu.py holds the kernel on the card."""
    from repro_torch.kernels.chacha20 import ops as tops

    x = torch.from_numpy(np.random.default_rng(4).integers(0, 255, 301).astype(np.uint8))
    want = tctr.encrypt_array(x, KW, NW, counter0)
    for c0 in (counter0, torch.tensor(counter0, dtype=torch.int64),
               torch.tensor(counter0, dtype=torch.int64).to(torch.uint32).view(torch.int32)):
        assert torch.equal(tops.ctr_crypt_array(x, KW, NW, c0), want)
