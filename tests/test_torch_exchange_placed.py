"""The secure coalesced exchange's placed send side (repro_torch.core.shuffle).

The send-side crypt stores each ciphertext row where its receiver reads it,
so the exchange's transpose moves nothing, and a one-leaf tree is packed as
a view of the leaf. Held bit for bit to the per-leaf oracle
(`coalesce=False`) and to the composition it replaces (pack, crypt,
all_to_all, crypt), with the ciphertext seen on a tapped mesh's all_to_all.
All on the CPU (the kernel's plain version); the card's kernel is held to the
same contract in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from repro_torch import VirtualMesh
from repro_torch.convert import secure_config
from repro_torch.core import shuffle as tsh
from repro_torch.kernels.chacha20 import ops as tops
from repro_torch.kernels.chacha20.ref import place_rows_ref
from repro_torch.kernels.chacha20.table import block_table, row_table
from repro_torch.tree import tree_flatten, tree_unflatten

KW = np.arange(0x01020304, 0x01020304 + 8, dtype=np.uint32)
NW = np.array([7, 0xFFFFFFF0, 3], np.uint32)


def _cfg(coalesce=True, counter0=2**32 - 50):
    return secure_config(KW, NW, counter0, coalesce=coalesce)


def _tapped(s, seen):
    """A VirtualMesh whose all_to_all hands each int32 wire it returns to
    `seen` (the way the benchmark taps the exchange's ciphertext)."""

    class Tapped(VirtualMesh):
        def all_to_all(self, x):
            out = super().all_to_all(x)
            if out.dtype == torch.int32:
                seen.append(out)
            return out

    return Tapped(s, "cpu")


def _tree(s, dtype, several, seed=0):
    """(S, S, C, d) value leaves of `dtype` (an odd bf16 width needs a pad word),
    with an int32 key leaf and a second value leaf when `several`."""
    g = torch.Generator().manual_seed(seed * 100 + s)
    x = torch.randn((s, s, 6, 5), generator=g).to(dtype)
    if not several:
        return {"x": x}
    return {"k": torch.randint(-1, 50, (s, s, 6), dtype=torch.int32, generator=g),
            "v": {"x": x, "y": torch.randn((s, s, 6, 3), generator=g).to(dtype)}}


def _bits(t):
    return t.contiguous().view(torch.uint8) if t.dtype.itemsize == 1 else \
        t.contiguous().view({2: torch.int16, 4: torch.int32}[t.dtype.itemsize])


def _assert_trees_identical(a, b):
    la, ta = tree_flatten(a)
    lb, tb = tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


def _round(kind):
    return 9 if kind == "host" else torch.tensor(9, dtype=torch.int32)


@pytest.mark.parametrize("round_kind", ["host", "device"])
@pytest.mark.parametrize("s", [2, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("several", [False, True])
def test_placed_exchange_equals_the_per_leaf_oracle(several, dtype, s, round_kind):
    """The received tree and the ciphertext that crosses equal the per-leaf
    wire's bit for bit: the coalesced wire is the per-leaf wires' words
    side by side, under the same counters."""
    tree = _tree(s, dtype, several)
    got_ct, want_ct = [], []
    got = tsh.keyed_all_to_all(tree, _tapped(s, got_ct), _cfg(), round_index=_round(round_kind))
    want = tsh.keyed_all_to_all(tree, _tapped(s, want_ct), _cfg(coalesce=False),
                                round_index=_round(round_kind))
    _assert_trees_identical(got, want)
    leaves, treedef = tree_flatten(tree)
    _assert_trees_identical(got, tree_unflatten(treedef, [l.transpose(0, 1) for l in leaves]))
    assert len(got_ct) == 1 and len(want_ct) == len(leaves)
    assert torch.equal(got_ct[0], torch.cat(want_ct, dim=-1))


@pytest.mark.parametrize("round_kind", ["host", "device"])
@pytest.mark.parametrize("several", [False, True])
def test_tapped_mesh_sees_the_ciphertext_of_pack_crypt_all_to_all(several, round_kind):
    """What crosses the tapped all_to_all is what the composition before the
    placed store sent: pack, crypt in sender order, all_to_all."""
    s = 4
    tree = _tree(s, torch.bfloat16, several, seed=3)
    rnd = _round(round_kind)
    seen = []
    got = tsh.keyed_all_to_all(tree, _tapped(s, seen), _cfg(), round_index=rnd)
    wire, layout, treedef = tsh._pack_wire_coalesced(tree, lead=2)
    w = wire.shape[-1]
    ids = tsh._exchange_ids(s, s, torch.device("cpu"))
    ct = tsh._crypt_wire_coalesced(wire.reshape(s * s, w), layout, _cfg(), ids[0], ids[1], rnd)
    moved = VirtualMesh(s, "cpu").all_to_all(ct.reshape(s, s, w))
    assert len(seen) == 1 and torch.equal(seen[0], moved)
    back = tsh._crypt_wire_coalesced(moved.reshape(s * s, w), layout, _cfg(), ids[2], ids[3],
                                     rnd)
    _assert_trees_identical(got, tsh._unpack_wire_coalesced(back.reshape(s, s, w), layout,
                                                            treedef, lead=2))


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("several,secure,coalesce,want", [
    (False, True, True, 0),    # the MoE's leg: a view packed, a placed store
    (True, True, True, 1),     # k-means's keys and values: the concatenation
    (False, True, False, 1),   # the per-leaf oracle keeps its transpose
    (True, True, False, 3),    # one transpose a leaf
    (False, False, True, 1),   # the plaintext wire keeps its transpose
    (True, False, True, 2),    # and its concatenation
    (True, False, False, 3),
])
def test_copies_counts_the_passes_besides_the_crypts(several, secure, coalesce, want, device):
    """A record's `copies`: the pack's concatenation plus each exchange that
    returned new storage; an abstract run on `meta` counts as a real one."""
    tree = {k: v.to(device) if isinstance(v, torch.Tensor) else
            {kk: vv.to(device) for kk, vv in v.items()}
            for k, v in _tree(4, torch.bfloat16, several).items()}
    cfg = _cfg(coalesce=coalesce) if secure else None
    with tsh.record_wire_bytes() as recs:
        tsh.keyed_all_to_all(tree, VirtualMesh(4, device), cfg, round_index=2,
                             coalesce=coalesce)
    assert [r["copies"] for r in recs] == [want]
    assert recs[0]["collectives"] == (1 if coalesce else len(tree_flatten(tree)[0]))
    if secure and coalesce:
        assert recs[0]["keystream_launches"] == 2


def test_one_shard_exchange_copies_nothing():
    """At S = 1 the all_to_all is the identity: no pass, secure or plain."""
    tree = _tree(1, torch.bfloat16, False)
    with tsh.record_wire_bytes() as recs:
        tsh.keyed_all_to_all(tree, VirtualMesh(1, "cpu"), _cfg())
        tsh.keyed_all_to_all(tree, VirtualMesh(1, "cpu"), None)
    assert [r["copies"] for r in recs] == [0, 0]


@pytest.mark.parametrize("s", [2, 8])
def test_all_to_all_of_a_placed_buffer_returns_its_storage(s, monkeypatch):
    """The mesh's all_to_all of the placed buffer's transposed view is the
    buffer itself, in the exchange as on its own: a copy that came back in
    `VirtualMesh.all_to_all` would fail here."""
    w = 5
    placed = torch.arange(s * s * w, dtype=torch.int32).reshape(s * s, w)
    moved = VirtualMesh(s, "cpu").all_to_all(placed.reshape(s, s, w).transpose(0, 1))
    assert moved.data_ptr() == placed.data_ptr() and moved.is_contiguous()
    assert torch.equal(moved.reshape(s * s, w), placed)

    crypts, seen = [], []
    real = tsh._crypt_wire_coalesced

    def spy(*a, **kw):
        crypts.append(real(*a, **kw))
        return crypts[-1]

    monkeypatch.setattr(tsh, "_crypt_wire_coalesced", spy)
    tsh.keyed_all_to_all(_tree(s, torch.bfloat16, False), _tapped(s, seen), _cfg(),
                         round_index=1)
    assert len(crypts) == 2 and len(seen) == 1
    assert seen[0].data_ptr() == crypts[0].data_ptr()
    assert seen[0].untyped_storage().data_ptr() == crypts[0].untyped_storage().data_ptr()


def _same_storage(a, b):
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def test_one_leaf_wire_is_a_view_of_the_leaf():
    """A contiguous leaf with no pad word packs as its own words; a padded
    leaf and several leaves are copied."""
    x = torch.randn(2, 2, 3, 4)
    wire, layout, _ = tsh._pack_wire_coalesced({"x": x}, lead=2)
    assert wire.data_ptr() == x.data_ptr() and _same_storage(wire, x)
    odd = torch.randn(2, 2, 3).to(torch.bfloat16)  # 3 halves: a pad word
    wire, _, _ = tsh._pack_wire_coalesced({"x": odd}, lead=2)
    assert not _same_storage(wire, odd)
    wire, _, _ = tsh._pack_wire_coalesced({"x": x, "y": x}, lead=2)
    assert not _same_storage(wire, x)


def test_closed_wire_accounting_counts_no_copies():
    """With no sink open, `copies` is not computed: the storages are not
    even looked at (a closed instrument costs one truth test)."""

    class Untouchable:
        def untyped_storage(self):
            raise AssertionError("a storage was read with no sink open")

    assert not tsh.wire_accounting.enabled
    assert tsh._passes([(Untouchable(), Untouchable())]) == 0
    with tsh.record_wire_bytes():
        with pytest.raises(AssertionError, match="no sink open"):
            tsh._passes([(Untouchable(), Untouchable())])


def test_exchange_places_are_the_receivers_rows():
    """`place_rows` R puts sender row (shard, dest) = shard·R + dest at row
    dest·S + shard, the row its receiver reads after the exchange."""
    s = 3
    rows = torch.arange(s * s, dtype=torch.int32)[:, None]
    placed = place_rows_ref(rows, s)[:, 0]
    shard, dest = (i.to(torch.int64) for i in tsh._exchange_ids(s, s, torch.device("cpu"))[:2])
    assert torch.equal(placed[dest * s + shard], rows[:, 0])
    assert place_rows_ref(rows, 0) is rows
    assert torch.equal(place_rows_ref(rows, 1), rows) and torch.equal(place_rows_ref(rows, 9), rows)
    for bad in (-1, 2, 10):
        with pytest.raises(ValueError, match="place_rows"):
            place_rows_ref(rows, bad)


@pytest.mark.parametrize("round_dev", [None, 2**31 + 5])
@pytest.mark.parametrize("packed,place", [(False, 3), (True, 4), (True, 6)])
def test_op_with_place_rows_is_the_unplaced_result_transposed(packed, place, round_dev):
    """The operator's CPU implementation with `place_rows` R stores row s·R +
    r of the unplaced result at row r·(n_rows/R) + s, row-aligned and packed
    tables alike; the fake gives the shape and refuses what the kernel
    refuses."""
    rng = np.random.default_rng(7 + packed + place)
    n_rows, row_words = 12, 37
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (n_rows, row_words), dtype=np.int64)
                         .astype(np.int32))
    if packed:  # two leaves of 20 and 17 words, each block-aligned in counters
        table = block_table([0, 1, 24, 25], [2, 2, 2, 2], [0, 16, 20, 36], [16, 4, 16, 1],
                            "cpu")
    else:
        table = row_table(row_words, torch.device("cpu"))
    nid = torch.from_numpy(rng.integers(0, 2**31, n_rows).astype(np.int32))
    crow = torch.arange(n_rows, dtype=torch.int32)
    rd = None if round_dev is None else torch.tensor([round_dev - 2**32], dtype=torch.int32)
    args = (x, table, KW, NW, 2**32 - 3, nid, crow)
    plain = tops.chacha20_xor_packed(*args, round_dev=rd)
    placed = tops.chacha20_xor_packed(*args, round_dev=rd, place_rows=place)
    s = n_rows // place
    assert torch.equal(placed.reshape(place, s, row_words),
                       plain.reshape(s, place, row_words).transpose(0, 1))
    assert not torch.equal(placed, plain)
    meta = (x.to("meta"), row_table(row_words, torch.device("meta")), KW, NW, 0,
            nid.to("meta"), crow.to("meta"))
    fake = tops.chacha20_xor_packed(*meta, place_rows=place)
    assert fake.shape == x.shape and fake.device.type == "meta"
    for bad in (5, -2):
        with pytest.raises(ValueError, match="place_rows"):
            tops.chacha20_xor_packed(*args, place_rows=bad)
        with pytest.raises(ValueError, match="place_rows"):
            tops.chacha20_xor_packed(*meta, place_rows=bad)


def test_moe_prefill_legs_copy_nothing_besides_the_crypts():
    """Both encrypted legs of a MoE layer with no gradient (a prefill's) read
    `copies` 0: the send buffers are contiguous one-leaf trees."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as tmoe

    cfg = get_config("granite-moe-3b-a800m").reduced()
    r = 2
    torch.manual_seed(0)
    model = tmoe.moe_init(cfg, r, "cpu")
    x = torch.randn(2, 8, cfg.d_model).to(model.wi.dtype)
    with torch.no_grad(), tsh.record_wire_bytes() as recs:
        tmoe.moe_apply(cfg, model, x, mesh=VirtualMesh(r, "cpu"), secure=_cfg())
    assert [(rec["secure"], rec["keystream_launches"], rec["copies"]) for rec in recs] == \
        [(True, 2, 0)] * 2
