"""Port shuffle (repro_torch.core.shuffle) against repro.core.shuffle.

Exact comparisons throughout: bucket_pack's integers and packed values, the
packed wire and its layout, and the coalesced ciphertext must equal the
reference's bit for bit; received trees must be identical. Inputs come from
numpy seeds. Meshes of R > 1 devices run the JAX side in a subprocess with
forced host devices (tests/conftest.py::run_in_subprocess).
"""

import threading

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
from repro_torch.kernels.chacha20.ref import chacha20_xor_packed_ref
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
    tab = tsh._layout_table(tlay, twire.device).words.numpy().view(np.uint32)
    np.testing.assert_array_equal(tab[:, 0], jlay.ctr_base)
    np.testing.assert_array_equal(tab[:, 1], jlay.ctr_rowmul)
    assert tlay.total_blocks == jlay.total_blocks
    assert tlay.payload_words == jlay.payload_words
    rid = None if round_id is None else jnp.uint32(round_id)
    want = jsh._crypt_wire_coalesced(jwire, jlay, _jcfg(), jnp.asarray(nonce_ids),
                                     jnp.asarray(ctr_rows), rid)
    got = tsh._crypt_wire_coalesced(twire, tlay, _tcfg(), torch.from_numpy(
        nonce_ids.view(np.int32)), torch.from_numpy(ctr_rows.view(np.int32)), round_id)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


# --- the fused crypt: block table and plain version ----------------------------------


def _layout_tree(kind: str, rng, r: int):
    """numpy trees whose packed leaves break the 16-word grid: odd word
    counts, a leaf with no words, bf16 half words and uint8 quarter words."""
    t = {"f": rng.normal(size=(r, 5, 3)).astype(np.float32),
         "k": rng.integers(-5, 100, (r, 7)).astype(np.int32)}
    if kind in ("empty", "all"):
        t["e"] = np.zeros((r, 5, 0), np.float32)
    if kind in ("bf16", "all"):
        t["h"] = rng.integers(0, 2**16, (r, 9), dtype=np.uint16)  # bf16 bits
    if kind in ("uint8", "all"):
        t["u8"] = rng.integers(0, 256, (r, 11), dtype=np.uint8)
    return t


def _layout_pair(t):
    jt = {k: (jnp.asarray(v).view(jnp.bfloat16) if k == "h" else jnp.asarray(v))
          for k, v in t.items()}
    tt = {k: (torch.as_tensor(v.view(np.int16)).view(torch.bfloat16) if k == "h"
              else torch.as_tensor(v)) for k, v in t.items()}
    return jsh._pack_wire_coalesced(jt), tsh._pack_wire_coalesced(tt)


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("kind", ["odd", "empty", "bf16", "uint8", "all"])
def test_layout_table_matches_jax_layout(kind, r):
    """The cached block table holds the reference layout's counters and its
    packed offsets, and its blocks cover every packed word exactly once."""
    tree = _layout_tree(kind, np.random.default_rng(r), r)
    (jwire, jlay, _), (twire, tlay, _) = _layout_pair(tree)
    np.testing.assert_array_equal(twire.numpy().view(np.uint32), np.asarray(jwire))
    table = tsh._layout_table(tlay, twire.device)
    assert table is tsh._layout_table(tlay, twire.device)  # cached
    tab = table.words.numpy().view(np.uint32)
    assert tab.shape == (jlay.total_blocks, 4)
    np.testing.assert_array_equal(tab[:, 0], jlay.ctr_base)
    np.testing.assert_array_equal(tab[:, 1], jlay.ctr_rowmul)
    start, valid = [], []
    for _shape, _dtype, _pad, word_start, n_words, blocks, _ks in jlay.leaves:
        for b in range(blocks):
            start.append(word_start + 16 * b)
            valid.append(min(16, n_words - 16 * b))
    np.testing.assert_array_equal(tab[:, 2], start)
    np.testing.assert_array_equal(tab[:, 3], valid)
    covered = np.zeros(jlay.payload_words, np.int64)
    for s0, nv in zip(tab[:, 2], tab[:, 3]):
        covered[s0:s0 + nv] += 1
    assert (covered == 1).all()
    assert table.aligned == bool((tab[:, 3] == 16).all() and (tab[:, 2] % 4 == 0).all())


@pytest.mark.parametrize("counter0", [100, 2**32 - 3])
@pytest.mark.parametrize("kind", ["odd", "all"])
def test_fused_plain_matches_jax_crypt(kind, counter0):
    """The fused plain version (the CPU route of `_crypt_wire_coalesced`)
    equals the reference's aligned-keystream-and-slice crypt bit for bit, with
    counters wrapping at 2**32 and round ids None, 0 and 2**32 - 1."""
    r = 3
    rng = np.random.default_rng(counter0 % 97)
    (jwire, jlay, _), (twire, tlay, _) = _layout_pair(_layout_tree(kind, rng, r))
    nonce_ids = rng.integers(0, 2**32, r, dtype=np.uint32)
    ctr_rows = rng.integers(0, 2**16, r, dtype=np.uint32)
    tid, trows = (torch.from_numpy(a.view(np.int32)) for a in (nonce_ids, ctr_rows))
    table = tsh._layout_table(tlay, twire.device)
    for round_id in (None, 0, 2**32 - 1):
        rid = None if round_id is None else jnp.uint32(round_id)
        want = np.asarray(jsh._crypt_wire_coalesced(
            jwire, jlay, _jcfg(counter0=counter0), jnp.asarray(nonce_ids),
            jnp.asarray(ctr_rows), rid))
        got = tsh._crypt_wire_coalesced(twire, tlay, _tcfg(counter0=counter0), tid, trows,
                                        round_id)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        direct = chacha20_xor_packed_ref(twire, table, KW, tsh._round_nonce(_tcfg(), round_id),
                                         counter0, tid, trows)
        assert torch.equal(direct, got)


def test_exchange_ids_are_cached_int32():
    ids = tsh._exchange_ids(3, 3, torch.device("cpu"))
    assert ids is tsh._exchange_ids(3, 3, torch.device("cpu"))
    assert all(t.dtype == torch.int32 for t in ids)
    send_ids, send_rows, recv_ids, recv_rows = (t.tolist() for t in ids)
    assert send_ids == recv_rows == [0, 0, 0, 1, 1, 1, 2, 2, 2]
    assert send_rows == recv_ids == [0, 1, 2] * 3


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
    assert cfg.with_coalesce(None) is cfg
    assert cfg.with_coalesce(False).coalesce is False and cfg.coalesce is True


# --- the round index on the device ---------------------------------------------------


@pytest.mark.parametrize("round_id", [0, 1, 7, 2**31, 2**32 - 1, 2**32 + 5])
def test_chacha_plain_round_dev_equals_round_xored_into_the_nonce(round_id):
    """The plain version's `round_dev` (int32 bits or an int64 value) keys the
    same keystream as the round XORed into nonce word 1 on the host."""
    rng = np.random.default_rng(round_id % 97)
    t = {k: v[None] for k, v in _torch_tree(_np_tree(rng, (4,), 5)).items()}
    wire, layout, _ = tsh._pack_wire_coalesced(t, lead=2)
    flat = wire.reshape(4, -1)
    table = tsh._layout_table(layout, flat.device)
    ids = torch.arange(4, dtype=torch.int32)
    want = chacha20_xor_packed_ref(flat, table, KW, tsh._round_nonce(_tcfg(), round_id), 9,
                                   ids, ids)
    for rd in (torch.tensor([round_id & 0xFFFFFFFF], dtype=torch.int64),
               torch.tensor(round_id & 0xFFFFFFFF, dtype=torch.int64).to(torch.int32)):
        got = chacha20_xor_packed_ref(flat, table, KW, NW, 9, ids, ids, round_dev=rd.reshape(1))
        assert torch.equal(got, want)


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("round_id", [3, 2**31, 2**32 - 1])
def test_keyed_all_to_all_device_round_equals_host_round(coalesce, round_id):
    """A round index given as a device tensor (int64 value, or int32 u32 bits)
    gives the host int's ciphertext and received tree, on both wires."""
    rng = np.random.default_rng(11)
    r = 4
    tree = {k: torch.as_tensor(v.reshape((r, r) + v.shape[1:]))
            for k, v in {"f": rng.normal(size=(r * r, 3, 2)).astype(np.float32),
                         "k": rng.integers(-5, 100, (r * r, 3)).astype(np.int32)}.items()}
    mesh = VirtualMesh(r, "cpu")
    cfg = _tcfg(coalesce)
    want = tsh.keyed_all_to_all(tree, mesh, cfg, round_index=round_id)
    wire, layout, _ = tsh._pack_wire_coalesced(tree, lead=2)
    flat = wire.reshape(r * r, -1)
    ids = tsh._exchange_ids(r, r, flat.device)
    ct = tsh._crypt_wire_coalesced(flat, layout, cfg, ids[0], ids[1], round_id)
    bits32 = torch.tensor(round_id).to(torch.int32).reshape(1)  # two's complement wrap
    for rd in (torch.tensor(round_id), bits32):
        got = tsh.keyed_all_to_all(tree, mesh, cfg, round_index=rd)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert torch.equal(tsh._crypt_wire_coalesced(flat, layout, cfg, ids[0], ids[1], rd), ct)


# --- wire accounting -----------------------------------------------------------------


def test_wire_accounting_sinks_are_removed_by_identity():
    """Contexts may exit out of stack order; each sink keeps what was recorded
    while it was open."""
    acc = tsh.wire_accounting
    tree = {"k": torch.zeros((2, 2, 3), dtype=torch.int32)}
    mesh = VirtualMesh(2, "cpu")
    a, b = tsh.record_wire_bytes(), tsh.record_wire_bytes()
    ra = a.__enter__()
    tsh.keyed_all_to_all(tree, mesh)
    rb = b.__enter__()
    tsh.keyed_all_to_all(tree, mesh)
    a.__exit__(None, None, None)
    tsh.keyed_all_to_all(tree, mesh)
    b.__exit__(None, None, None)
    assert (len(ra), len(rb)) == (2, 2)
    assert not acc.enabled


def test_wire_accounting_suppressed_tagged_isolated_and_emit():
    acc = tsh.wire_accounting
    tree = {"k": torch.zeros((2, 2, 3), dtype=torch.int32)}
    mesh = VirtualMesh(2, "cpu")
    with tsh.record_wire_bytes() as outer:
        assert outer == [] and acc.enabled
        with acc.tagged("j1"), acc.tagged(None):
            tsh.keyed_all_to_all(tree, mesh)
            with acc.isolated() as kept:  # the open sink and the tag are set aside
                tsh.keyed_all_to_all(tree, mesh, _tcfg(), round_index=2)
            assert len(outer) == 1 and len(kept) == 1 and kept[0]["job"] is None
            acc.emit(kept * 3)  # replayed rounds re-emit the captured record
        with acc.tagged("j2"):
            acc.emit(kept)
    assert [r["job"] for r in outer] == ["j1"] * 4 + ["j2"]
    assert [r["secure"] for r in outer] == [False] + [True] * 4
    with tsh.record_wire_bytes() as fresh:  # the tags are gone with their blocks
        tsh.keyed_all_to_all(tree, mesh)
    assert outer[1] is not kept[0] and [r["job"] for r in fresh] == [None]


def test_wire_accounting_sink_outlives_another_threads_isolation():
    """A `record_wire_bytes()` opened on one thread while another thread
    holds `wire_accounting.isolated()` (a graph runner capturing a round)
    takes that thread's records only, and keeps recording after the
    isolation ends; the isolated sink takes its own thread's record alone."""
    acc = tsh.wire_accounting
    tree = {"k": torch.zeros((2, 2, 3), dtype=torch.int32)}
    mesh = VirtualMesh(2, "cpu")
    isolating, opened = threading.Event(), threading.Event()
    kept = []

    def capture():
        with acc.isolated() as mine:
            isolating.set()
            if opened.wait(timeout=30):
                tsh.keyed_all_to_all(tree, mesh, _tcfg(), round_index=1)
        kept.extend(mine)

    t = threading.Thread(target=capture)
    t.start()
    assert isolating.wait(timeout=30)
    with tsh.record_wire_bytes() as recs:
        tsh.keyed_all_to_all(tree, mesh)  # while the other thread is isolated
        opened.set()
        t.join(timeout=30)
        assert not t.is_alive()
        tsh.keyed_all_to_all(tree, mesh)  # after its isolation ended
    assert [r["secure"] for r in recs] == [False, False]
    assert [r["secure"] for r in kept] == [True]


def test_wire_accounting_job_tag_is_the_tagging_threads_own():
    """A shuffle on one thread is not labelled with the job that another
    thread tagged (`run_until_chunks` tags each chunk of a job)."""
    acc = tsh.wire_accounting
    tree = {"k": torch.zeros((2, 2, 3), dtype=torch.int32)}
    mesh = VirtualMesh(2, "cpu")
    tagged, untagged_done = threading.Event(), threading.Event()

    def job():
        with acc.tagged("job-A"):
            tagged.set()
            if untagged_done.wait(timeout=30):
                tsh.keyed_all_to_all(tree, mesh)

    with tsh.record_wire_bytes() as recs:
        t = threading.Thread(target=job)
        t.start()
        assert tagged.wait(timeout=30)
        tsh.keyed_all_to_all(tree, mesh)  # this thread tagged nothing
        untagged_done.set()
        t.join(timeout=30)
        assert not t.is_alive()
    assert [r["job"] for r in recs] == [None, "job-A"]


# --- device constants pinned for captured rounds --------------------------------------


def test_pinned_constants_keep_what_a_round_read_after_the_caches_evict():
    """A round run inside `pinned_constants(store)` takes its block table and
    exchange ids through the store, which keeps them: after the LRU caches
    are cleared the store still hands back the same tensors (a captured
    graph keeps their addresses), outside it the caches build new ones, and
    the innermost store wins."""
    from repro_torch.device import device_constant, pinned_constants

    mesh = VirtualMesh(2, "cpu")
    tree = {"k": torch.arange(2 * 2 * 5, dtype=torch.int32).reshape(2, 2, 5)}
    store = {}
    with pinned_constants(store):
        ct = tsh.keyed_all_to_all(tree, mesh, _tcfg(), round_index=3)
    assert {k[0] for k in store} == {tsh._layout_table, tsh._exchange_ids}
    held = dict(store)
    tsh._layout_table.cache_clear()
    tsh._exchange_ids.cache_clear()
    with pinned_constants(store):
        again = tsh.keyed_all_to_all(tree, mesh, _tcfg(), round_index=3)
        assert device_constant(tsh._exchange_ids, 2, 2, torch.device("cpu")) is \
            held[(tsh._exchange_ids, (2, 2, torch.device("cpu")))]
        with pinned_constants({}) as inner:
            fresh = device_constant(tsh._exchange_ids, 2, 2, torch.device("cpu"))
        assert fresh is not held[(tsh._exchange_ids, (2, 2, torch.device("cpu")))]
        assert list(inner.values()) == [fresh]
    assert store == held and all(store[k] is held[k] for k in held)
    assert device_constant(tsh._exchange_ids, 2, 2, torch.device("cpu")) is fresh  # the cache
    assert torch.equal(again["k"], ct["k"]) and torch.equal(ct["k"], tree["k"].transpose(0, 1))
