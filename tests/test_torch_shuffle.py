"""Port shuffle (repro_torch.core.shuffle) against repro.core.shuffle.

Exact comparisons throughout: bucket_pack's integers and packed values, the
packed wire and its layout, and the coalesced ciphertext must equal the
reference's bit for bit; received trees must be identical. Inputs come from
numpy seeds. Meshes of R > 1 devices run the JAX side in a subprocess with
forced host devices (tests/conftest.py::run_in_subprocess).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import run_in_subprocess
from repro.core import shuffle as jsh
from repro.crypto import chacha as jch
from repro_torch import VirtualMesh
from repro_torch.convert import secure_config, to_numpy
from repro_torch.core import shuffle as tsh
from repro_torch.tree import tree_flatten

KW = jch.key_to_words(bytes(range(32)))
NW = jch.nonce_to_words(b"\x07" * 12)


def _jcfg(coalesce=True, counter0=100):
    return jsh.SecureShuffleConfig(key_words=KW, nonce_words=NW, counter0=counter0,
                                   impl="pallas-interpret", coalesce=coalesce)


def _tcfg(coalesce=True, counter0=100):
    return secure_config(KW, NW, counter0, coalesce=coalesce)


def bits(x) -> np.ndarray:
    """Raw bytes of a JAX array or torch tensor, for bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        return np.frombuffer(to_numpy(x).tobytes(), np.uint8)
    return np.frombuffer(np.asarray(x).tobytes(), np.uint8)


def _np_tree(rng, lead: tuple, c: int):
    """u32/i32/f32/bf16 leaves; odd `c` gives odd word counts (bf16 half words)."""
    return {"f": rng.normal(size=lead + (c, 3)).astype(np.float32),
            "h": rng.integers(0, 2**16, lead + (c,), dtype=np.uint16),  # bf16 bits
            "k": rng.integers(-5, 100, lead + (c,)).astype(np.int32),
            "u": rng.integers(0, 2**32, lead + (c,), dtype=np.uint32)}


def _jax_tree(t):
    return {"f": jnp.asarray(t["f"]), "h": jnp.asarray(t["h"]).view(jnp.bfloat16),
            "k": jnp.asarray(t["k"]), "u": jnp.asarray(t["u"])}


def _torch_tree(t, device="cpu"):
    return {"f": torch.as_tensor(t["f"], device=device),
            "h": torch.as_tensor(t["h"].view(np.int16), device=device).view(torch.bfloat16),
            "k": torch.as_tensor(t["k"], device=device),
            "u": torch.as_tensor(t["u"], device=device)}


# --- bucket_pack ---------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "overflow", "all_invalid", "empty_leaf"])
def test_bucket_pack_matches_jax(case):
    rng = np.random.default_rng(hash(case) % 2**32)
    n, r, cap = 40, 4, 6
    keys = rng.integers(-3, 50, n).astype(np.int32)
    bucket = rng.integers(0, r, n).astype(np.int32)
    if case == "overflow":
        bucket[:] = rng.integers(0, 2, n)  # two hot buckets of capacity 6
    if case == "all_invalid":
        keys[:] = -1
    vals = {"v": rng.normal(size=(n, 3)).astype(np.float32),
            "w": rng.integers(0, 9, n).astype(np.int32)}
    if case == "empty_leaf":
        vals["e"] = np.zeros((n, 0), np.float32)
    jo = jsh.bucket_pack(jnp.asarray(keys), jnp.asarray(bucket),
                         jax.tree.map(jnp.asarray, vals), r, cap, return_positions=True)
    to = tsh.bucket_pack(torch.from_numpy(keys), torch.from_numpy(bucket),
                         {k: torch.from_numpy(v) for k, v in vals.items()}, r, cap,
                         return_positions=True)
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo[0]))
    for name in vals:
        assert tuple(to[1][name].shape) == np.asarray(jo[1][name]).shape
        np.testing.assert_array_equal(to[1][name].numpy(), np.asarray(jo[1][name]))
    assert int(to[2]) == int(jo[2])
    np.testing.assert_array_equal(to[3].numpy(), np.asarray(jo[3]))
    if case == "overflow":
        assert int(to[2]) > 0
    if case == "all_invalid":
        assert (to[0].numpy() == -1).all() and int(to[2]) == 0


def test_bucket_pack_shard_batched_equals_per_shard():
    rng = np.random.default_rng(1)
    keys = rng.integers(-1, 20, (3, 16)).astype(np.int32)
    bucket = rng.integers(0, 3, (3, 16)).astype(np.int32)
    vals = rng.normal(size=(3, 16, 2)).astype(np.float32)
    ok, ov, od = tsh.bucket_pack(torch.from_numpy(keys), torch.from_numpy(bucket),
                                 torch.from_numpy(vals), 3, 4)
    for s in range(3):
        k1, v1, d1 = tsh.bucket_pack(torch.from_numpy(keys[s]), torch.from_numpy(bucket[s]),
                                     torch.from_numpy(vals[s]), 3, 4)
        assert torch.equal(ok[s], k1) and torch.equal(ov[s], v1) and int(od[s]) == int(d1)


# --- the coalesced wire -----------------------------------------------------------------


@pytest.mark.parametrize("seed,round_id", [(0, None), (1, 0), (2, 7), (3, 2**32 - 1)])
@pytest.mark.parametrize("c", [5, 1])
def test_coalesced_ciphertext_matches_jax(seed, round_id, c):
    rng = np.random.default_rng(seed)
    r = 3
    t = _np_tree(rng, (r,), c)
    nonce_ids = rng.integers(0, 2**32, r, dtype=np.uint32)
    ctr_rows = rng.integers(0, 2**16, r, dtype=np.uint32)
    jwire, jlay, _ = jsh._pack_wire_coalesced(_jax_tree(t))
    twire, tlay, _ = tsh._pack_wire_coalesced(_torch_tree(t))
    np.testing.assert_array_equal(twire.numpy().view(np.uint32), np.asarray(jwire))
    np.testing.assert_array_equal(tlay.ctr_base, jlay.ctr_base)
    np.testing.assert_array_equal(tlay.ctr_rowmul, jlay.ctr_rowmul)
    assert tlay.total_blocks == jlay.total_blocks
    assert tlay.payload_words == jlay.payload_words
    rid = None if round_id is None else jnp.uint32(round_id)
    want = jsh._crypt_wire_coalesced(jwire, jlay, _jcfg(), jnp.asarray(nonce_ids),
                                     jnp.asarray(ctr_rows), rid)
    got = tsh._crypt_wire_coalesced(twire, tlay, _tcfg(), torch.from_numpy(
        nonce_ids.view(np.int32)), torch.from_numpy(ctr_rows.view(np.int32)), round_id)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_coalesced_equals_per_leaf_per_region():
    rng = np.random.default_rng(9)
    r = 4
    tree = _torch_tree(_np_tree(rng, (r,), 7))
    nonce_ids = torch.from_numpy(rng.integers(0, 2**31, r).astype(np.int32))
    ctr_rows = torch.arange(r)
    wires, meta, _ = tsh._pack_wire(tree)
    wire, layout, _ = tsh._pack_wire_coalesced(tree)
    per_leaf = tsh._crypt_wires(wires, meta, _tcfg(False), nonce_ids, ctr_rows, 5)
    co = tsh._crypt_wire_coalesced(wire, layout, _tcfg(), nonce_ids, ctr_rows, 5)
    for leaf_ct, m in zip(per_leaf, layout.leaves):
        assert torch.equal(leaf_ct, co[:, m[3]:m[3] + m[4]])


@pytest.mark.parametrize("r", [1, 4])
def test_mesh_sender_wire_matches_jax_per_shard(r):
    """For each source shard, the port's one-launch sender wire over all S·R
    rows equals the reference's per-shard encrypted wire."""
    rng = np.random.default_rng(r)
    t = _np_tree(rng, (r, r), 3)
    twire, tlay, _ = tsh._pack_wire_coalesced(_torch_tree(t), lead=2)
    shard = torch.arange(r).repeat_interleave(r)
    dest = torch.arange(r).repeat(r)
    got = tsh._crypt_wire_coalesced(twire.reshape(r * r, -1), tlay, _tcfg(), shard, dest, 3)
    got = got.reshape(r, r, -1).numpy().view(np.uint32)
    for s in range(r):
        jt = _jax_tree({k: v[s] for k, v in t.items()})
        jwire, jlay, _ = jsh._pack_wire_coalesced(jt)
        want = jsh._crypt_wire_coalesced(jwire, jlay, _jcfg(), jnp.full((r,), s, jnp.uint32),
                                         jnp.arange(r, dtype=jnp.uint32), jnp.uint32(3))
        np.testing.assert_array_equal(got[s], np.asarray(want))


# --- keyed_all_to_all on meshes of R shards ------------------------------------------------

_EXCHANGE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core import shuffle as jsh
from repro.crypto import chacha as jch
R = {r}
mesh = compat.make_mesh((R,), ("data",), devices=jax.devices()[:R])
rng = np.random.default_rng(R)
t = {{"f": rng.normal(size=(R * R, 3, 3)).astype(np.float32),
      "h": rng.integers(0, 2**16, (R * R, 3), dtype=np.uint16),
      "k": rng.integers(-5, 100, (R * R, 3)).astype(np.int32),
      "u": rng.integers(0, 2**32, (R * R, 3), dtype=np.uint32)}}
tree = {{"f": jnp.asarray(t["f"]), "h": jnp.asarray(t["h"]).view(jnp.bfloat16),
         "k": jnp.asarray(t["k"]), "u": jnp.asarray(t["u"])}}
specs = jax.tree.map(lambda _: P("data"), tree)
cfg = jsh.SecureShuffleConfig(key_words=jch.key_to_words(bytes(range(32))),
                              nonce_words=jch.nonce_to_words(b"\\x07" * 12), counter0=100,
                              impl="pallas-interpret", coalesce={coalesce})
out = {{}}
for name, sec in (("plain", None), ("secure", cfg)):
    body = lambda x, sec=sec: jsh.keyed_all_to_all(x, "data", sec, round_index=jnp.uint32(7))
    fn = compat.shard_map(body, mesh=mesh, in_specs=(specs,), out_specs=specs, check_vma=False)
    res = jax.jit(fn)(tree)
    for k, v in res.items():
        out[name + "_" + k] = np.frombuffer(np.asarray(v).tobytes(), np.uint8)
np.savez({path!r}, **out)
print("OK")
"""


def _run_jax_exchange(r: int, coalesce: bool, path: str) -> dict:
    if r == 1:
        run = {}
        exec(_EXCHANGE.format(r=r, coalesce=coalesce, path=path), run)
    else:
        run_in_subprocess(_EXCHANGE.format(r=r, coalesce=coalesce, path=path), devices=r)
    return dict(np.load(path))


@pytest.mark.parametrize("r,coalesce", [(1, True), (1, False), (4, True), (8, True)])
def test_keyed_all_to_all_matches_jax(tmp_path, r, coalesce):
    want = _run_jax_exchange(r, coalesce, str(tmp_path / "ref.npz"))
    rng = np.random.default_rng(r)
    t = {"f": rng.normal(size=(r * r, 3, 3)).astype(np.float32),
         "h": rng.integers(0, 2**16, (r * r, 3), dtype=np.uint16),
         "k": rng.integers(-5, 100, (r * r, 3)).astype(np.int32),
         "u": rng.integers(0, 2**32, (r * r, 3), dtype=np.uint32)}
    tree = {k: v.reshape((r, r) + v.shape[1:]) for k, v in _torch_tree(t).items()}
    mesh = VirtualMesh(r, "cpu")
    with tsh.record_wire_bytes() as recs:
        outs = {"plain": tsh.keyed_all_to_all(tree, mesh, None, round_index=7),
                "secure": tsh.keyed_all_to_all(tree, mesh, _tcfg(coalesce), round_index=7)}
    for name, res in outs.items():
        for k, v in res.items():
            np.testing.assert_array_equal(bits(v), want[f"{name}_{k}"])
    plain, sec = recs
    n_leaves = len(tree_flatten(tree)[0])
    assert plain["collectives"] == 1 and plain["keystream_launches"] == 0
    assert sec["keystream_launches"] == (2 if coalesce else 2 * n_leaves)
    assert sec["coalesced"] is coalesce and sec["pad_bytes"] == 0
    assert sec["bytes"] == sum(sec["per_leaf"])


def test_resolve_coalesce_and_config_copies():
    assert tsh.resolve_coalesce("auto") is True and tsh.resolve_coalesce(None) is True
    assert tsh.resolve_coalesce(False) is False
    with pytest.raises(ValueError):
        tsh.resolve_coalesce("sideways")
    cfg = _tcfg()
    assert cfg.with_coalesce(None) is cfg and cfg.with_impl(None) is cfg
    assert cfg.with_coalesce(False).coalesce is False and cfg.coalesce is True
