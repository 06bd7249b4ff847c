"""Keyed shuffle on the virtual mesh: fixed-shape bucketing + encrypted all_to_all.

Counterpart of `repro/core/shuffle.py`. Each mapper packs its pairs into an
(R, C, ...) send buffer (R = reducers, C = per-destination capacity); on
the virtual mesh every shard's buffer sits in one (S, R, C, ...) tensor and
the exchange is a transpose of the first two dims (`VirtualMesh.all_to_all`).

Secure mode encrypts the send buffer before the exchange and decrypts after
it, even though the exchange here is a local transpose: ciphertext is what
would cross the chip boundary. The counter-space layout is the reference's,
bit for bit:
  nonce word 0 = base_nonce[0] XOR source shard
  nonce word 1 = base_nonce[1] XOR round index
  ctr          = counter0 + leaf_offset + dest_row * blocks_per_row(leaf) + b

Coalesced wire (default): the whole pytree travels as ONE packed
(R, payload_words) word wire per shard, with leaves concatenated at static
word offsets and zero pad words. The counter space is the block-aligned
per-leaf one; a per-block table {ctr_base, ctr_rowmul, packed_start,
n_valid}, built once per layout and kept on the device (`_layout_table`),
tells the kernel where each block's keystream lands on the packed wire, so
the keystream is XORed straight onto the packed words and each leaf region
keeps the per-leaf (key, nonce, counter) assignment. On the virtual mesh one
keystream launch covers all S·R wire rows of a side: sender rows use nonce
id = the shard and counter row = the destination; receiver rows use nonce id
= the source and counter row = the shard (`_exchange_ids`, built once per
(S, R, device)). The send side is one pass: a one-leaf tree's wire is the
leaf's own words (a view, no concatenation), and the encrypt stores sender
row (shard, dest) at row dest·S + shard of its output (the kernel's
`place_rows`, R), where the receiver reads it, so the exchange's transpose
finds its buffer already in order and moves nothing. A secure round is
therefore 2 ChaCha launches and no copy between them, and a crypt on the
card is one allocation and one launch: no host-to-device copy and no
synchronisation. The per-leaf wire is kept as the oracle
(`SecureShuffleConfig.coalesce=False`); it and the plaintext wire keep the
exchange's transpose. The placed store is the one-card `VirtualMesh`'s
layout, whose `all_to_all` is that transpose: a mesh over a real link would
send from sender order, and there the placed buffer would cost a copy back.

The round index is a host int, XORed into nonce word 1 on the host and
passed to the kernel by value, or a device tensor, which the kernel reads
from device memory (`round_dev`): a round captured in a CUDA graph then keys
every replay's keystream from the round id the replay is given.

Every shuffle call notes its wire to `wire_accounting`, which
`repro_torch.tools.opcount` keeps with the port's other instruments
(`record_wire_bytes` opens a sink of its records). A record's `copies`
counts the full passes over the wire besides the crypts: a pack that made
new storage (a concatenation), and each exchange that did.

The wire is 32-bit words held as int32 (u32 bit patterns): ciphertext never
travels as floats, which could quiet NaN payloads.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from repro_torch.crypto import ctr as _ctr
from repro_torch.crypto.chacha import CONSTANT_WORDS, MASK32, as_u32, u32_mul
from repro_torch.crypto.ctr import WORD, words_for
from repro_torch.device import device_constant
from repro_torch.kernels.chacha20.ops import chacha20_xor_packed, chacha20_xor_rows
from repro_torch.kernels.chacha20.table import BlockTable, block_table
from repro_torch.mesh import VirtualMesh
from repro_torch.perf.model import recommendation
from repro_torch.tools.opcount import record_wire_bytes, spans, wire_accounting  # noqa: F401
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


COALESCE_ENV = "REPRO_SHUFFLE_COALESCE"
_COALESCE_TRUE = ("1", "true", "yes", "on")
_COALESCE_FALSE = ("0", "false", "no", "off")


def resolve_coalesce(coalesce="auto") -> bool:
    """Resolve a coalesce selector to a concrete bool.

    An explicit bool always wins; 'auto'/None defers to
    $REPRO_SHUFFLE_COALESCE, then to the calibrated cost model when one is
    active (`repro_torch.perf.model`), then to the default True (the packed
    wire). An unparseable environment value raises, naming the variable.
    The driver resolves it once per runner, never per round.
    """
    if isinstance(coalesce, (bool, np.bool_)):
        return bool(coalesce)
    if coalesce in (None, "auto"):
        env_val = os.environ.get(COALESCE_ENV)
        if env_val is None:
            rec = recommendation("coalesce")
            return True if rec is None else bool(rec)
        val = env_val.strip().lower()
        if val in _COALESCE_TRUE:
            return True
        if val in _COALESCE_FALSE:
            return False
        raise ValueError(
            f"invalid ${COALESCE_ENV}={env_val!r} in the environment: "
            f"must be one of {_COALESCE_TRUE + _COALESCE_FALSE} "
            f"(unset ${COALESCE_ENV} to use the default coalesced wire)")
    raise ValueError(f"coalesce must be a bool or 'auto', got {coalesce!r}")


@dataclass(frozen=True)
class SecureShuffleConfig:
    """Session material for encrypting shuffle traffic (paper: k_shuffle).

    `impl` is the keystream selector of `repro_torch.kernels` ('auto' |
    'torch'); `coalesce` picks the wire layout (True | False | 'auto').
    """

    key_words: Any  # (8,) u32
    nonce_words: Any  # (3,) u32 base nonce; word 0 is XORed with the source shard
    counter0: int = 0
    impl: str = "auto"
    coalesce: Any = "auto"

    def with_coalesce(self, coalesce) -> "SecureShuffleConfig":
        """Copy with a different wire layout (None keeps the current one)."""
        if coalesce is None or coalesce == self.coalesce:
            return self
        return replace(self, coalesce=coalesce)


def bucket_pack(keys, bucket, values, n_buckets: int, capacity: int,
                return_positions: bool = False):
    """Pack (key, value) pairs into a fixed (R, C, ...) per-destination buffer.

    Args:
      keys:     (n,) or (S, n) int32; entries with key < 0 are padding.
      bucket:   like keys: destination bucket in [0, n_buckets) per item.
      values:   pytree of tensors with leading dims like keys.
      capacity: per-bucket slot count C.
      return_positions: also return each item's flat slot in [0, R*C), or
        R*C when it was dropped or invalid.

    Returns out_keys (…, R, C) int32 (-1 where empty), out_values with
    leading dims (…, R, C), n_dropped (…) int32 [, positions (…, n) int32].
    Items keep their input order within a bucket (stable sort).
    """
    batched = keys.dim() == 2
    if not batched:
        keys, bucket = keys[None], bucket[None]
        values = tree_map(lambda v: v[None], values)
    s, n = keys.shape
    dev = keys.device
    slots = n_buckets * capacity
    valid = keys >= 0
    b = torch.where(valid, bucket.to(torch.int64), n_buckets)  # invalid items sort last
    order = torch.argsort(b, dim=1, stable=True)
    b_sorted = torch.gather(b, 1, order)
    first = torch.searchsorted(b_sorted, b_sorted, side="left")
    pos = torch.arange(n, device=dev) - first
    in_range = (b_sorted < n_buckets) & (pos < capacity)
    dest = torch.where(in_range, b_sorted * capacity + pos, slots)
    n_dropped = ((b_sorted < n_buckets) & (pos >= capacity)).sum(dim=1).to(torch.int32)
    srow = torch.arange(s, device=dev)[:, None].expand(s, n)

    def scatter(x, fill):
        tail = tuple(x.shape[2:])
        if any(d == 0 for d in tail):
            # zero-size trailing dims: no elements to place, only the shape
            return torch.zeros((s, n_buckets, capacity) + tail, dtype=x.dtype, device=dev)
        out = torch.full((s, slots + 1) + tail, fill, dtype=x.dtype, device=dev)
        out[srow, dest] = x[srow, order]  # dropped items all land in the spare slot
        return out[:, :-1].reshape((s, n_buckets, capacity) + tail)

    out_keys = scatter(keys, -1)
    out_values = tree_map(lambda v: scatter(v, 0), values)
    result = [out_keys, out_values, n_dropped]
    if return_positions:
        positions = torch.full((s, n), slots, dtype=torch.int32, device=dev)
        positions[srow, order] = dest.to(torch.int32)
        result.append(positions)
    if not batched:
        result = [result[0][0], tree_map(lambda v: v[0], result[1]), result[2][0]] + [
            r[0] for r in result[3:]]
    return tuple(result)


def _row_blocks(leaf_row_shape, dtype) -> int:
    """ChaCha blocks consumed by one (C, ...) row of an (R, C, ...) leaf."""
    return -(-words_for(leaf_row_shape, dtype) // 16)


def _round_nonce(cfg: SecureShuffleConfig, round_id) -> np.ndarray:
    """Base nonce for this round: word 1 ^= round index (None = round 0)."""
    base = np.asarray(cfg.nonce_words, dtype=np.uint32).copy()
    if round_id is not None:
        base[1] ^= np.uint32(int(round_id) & MASK32)
    return base


def _round_key(cfg: SecureShuffleConfig, round_id):
    """(host nonce, device round id) of a round: a host int (or None) is
    XORed into the nonce here; a device tensor goes to the kernel, which XORs
    it into nonce word 1 itself."""
    if isinstance(round_id, torch.Tensor):
        return _round_nonce(cfg, None), round_id
    return _round_nonce(cfg, round_id), None


# --- per-leaf wire (the oracle) ------------------------------------------------


def _crypt_rows(cfg: SecureShuffleConfig, words, nonce_ids, ctr_starts, round_id):
    """XOR an (n_rows, n_words) wire with per-row keystreams (one launch)."""
    nonce, round_dev = _round_key(cfg, round_id)
    state0 = np.concatenate([CONSTANT_WORDS, np.asarray(cfg.key_words, np.uint32), [0],
                             nonce]).astype(np.uint32)
    return chacha20_xor_rows(words, state0, nonce_ids, ctr_starts, impl=cfg.impl,
                             round_dev=round_dev)


def _pack_wire(tree, lead: int = 1):
    """Bitcast every (…, R, C, ...) leaf into a (…, R, n_words) word wire.

    `lead` counts the row dims in front of C: 1 for one shard's (R, C, ...)
    leaves, 2 for the mesh's (S, R, C, ...).
    """
    leaves, treedef = tree_flatten(tree)
    wires, meta = [], []
    for leaf in leaves:
        row_shape = tuple(leaf.shape[lead:])
        wires.append(_ctr._to_words(leaf, lead)[0])
        meta.append((row_shape, leaf.dtype, _ctr.pad_for(row_shape, leaf.dtype)))
    return wires, meta, treedef


def _unpack_wire(wires, meta, treedef, lead: int = 1):
    leaves = [_ctr._from_words(w, shape, dtype, pad, lead)
              for w, (shape, dtype, pad) in zip(wires, meta)]
    return tree_unflatten(treedef, leaves)


def _crypt_wires(wires, meta, cfg, nonce_ids, ctr_rows, round_id=None, r=None):
    """Per-leaf crypt of 2-D (n_rows, n_words) wires; `r` rows per shard
    (default n_rows) sets each leaf's counter range of blocks * r."""
    out = []
    offset = int(cfg.counter0)
    for words, (shape, dtype, _pad) in zip(wires, meta):
        rows = words.shape[0] if r is None else r
        blocks = _row_blocks(shape, dtype)
        ctr = as_u32(ctr_rows, words.device).reshape(-1)
        ctr_starts = (offset + u32_mul(ctr, blocks)) & MASK32
        out.append(_crypt_rows(cfg, words, nonce_ids, ctr_starts, round_id))
        offset = (offset + blocks * rows) & MASK32
    return out


# --- coalesced wire ------------------------------------------------------------


@dataclass(frozen=True)
class _WireLayout:
    """Static unpack/counter metadata for a coalesced (R, payload_words) wire.

    leaves:  per-leaf (row shape, dtype, narrow-pad, word_start, n_words,
             blocks): word_start on the PACKED wire, blocks = the leaf's
             keystream blocks per row.
    rows:    R, the wire rows of one shard (the counter stride of a leaf).

    The counters and the keystream's place on the wire follow from these
    alone (`_layout_table`).
    """

    leaves: tuple
    rows: int

    @property
    def total_blocks(self) -> int:
        """Keystream blocks per wire row (Σ leaf blocks)."""
        return sum(m[5] for m in self.leaves)

    @property
    def payload_words(self) -> int:
        """Words of the packed wire -- exactly what crosses the link."""
        return sum(m[4] for m in self.leaves)


def _pack_wire_coalesced(tree, lead: int = 1):
    """Bitcast + concatenate the whole pytree into ONE packed word wire.

    Returns (wire (…, R, payload_words) int32, layout, treedef); R, the rows
    of one shard, is the dim just before C. A one-leaf tree's wire is the
    leaf's word view where the leaf is contiguous and needs no pad word.
    """
    leaves, treedef = tree_flatten(tree)
    lead_shape = tuple(leaves[0].shape[:lead])
    segs, meta = [], []
    word_off = 0
    for leaf in leaves:
        row_shape = tuple(leaf.shape[lead:])
        words = _ctr._to_words(leaf, lead)[0]
        n_words = words.shape[-1]
        segs.append(words)
        meta.append((row_shape, leaf.dtype, _ctr.pad_for(row_shape, leaf.dtype),
                     word_off, n_words, -(-n_words // 16)))
        word_off += n_words
    if len(segs) == 1:
        wire = segs[0]
    else:
        wire = torch.cat(segs, dim=-1) if segs else torch.zeros(
            lead_shape + (0,), dtype=WORD, device=leaves[0].device)
    return wire, _WireLayout(leaves=tuple(meta), rows=lead_shape[-1]), treedef


def _unpack_wire_coalesced(wire, layout: _WireLayout, treedef, lead: int = 1):
    leaves = [_ctr._from_words(wire[..., start:start + n_words], shape, dtype, pad, lead)
              for shape, dtype, pad, start, n_words, _b in layout.leaves]
    return tree_unflatten(treedef, leaves)


@functools.lru_cache(maxsize=64)
def _layout_table(layout: _WireLayout, device) -> BlockTable:
    """The coalesced wire's (total_blocks, 4) block table on `device`.

    Block b of a leaf of n_words words per row, after leaves holding
    `blocks_before` blocks: ctr_base = R·blocks_before + b (counter0 is
    added at crypt time), ctr_rowmul = the leaf's blocks per row,
    packed_start = the leaf's word_start + 16·b, n_valid = min(16, n_words -
    16·b): the per-leaf counter space, block-aligned per leaf, placed on the
    packed words. It depends only on the leaves' row shapes and dtypes and on
    R, so it is built once per (layout, device) and kept on the device; a
    captured round takes it through `device_constant`, which pins it.
    """
    base, mul, start, valid = [], [], [], []
    ctr_off = 0
    for _shape, _dtype, _pad, word_start, n_words, blocks in layout.leaves:
        b = np.arange(blocks, dtype=np.int64)
        base.append(ctr_off + b)
        mul.append(np.full(blocks, blocks, np.int64))
        start.append(word_start + 16 * b)
        valid.append(np.minimum(16, n_words - 16 * b))
        ctr_off += blocks * layout.rows
    return block_table(*(np.concatenate(c) for c in (base, mul, start, valid)), device)


def _crypt_wire_coalesced(wire, layout: _WireLayout, cfg, nonce_ids, ctr_rows,
                          round_id=None, *, place_rows: int = 0):
    """XOR an (n_rows, payload_words) packed wire with its keystream -- ONE launch.

    Block j of row i uses counter counter0 + ctr_base[j] + ctr_rowmul[j] ·
    ctr_rows[i] and nonce word 0 XOR nonce_ids[i]; the kernel XORs each
    block's words straight onto the packed wire (`_layout_table` places
    them). With a warm layout and int32 ids already on the card (as
    `keyed_all_to_all` passes them) the call is one allocation and one
    launch. `round_id` is a host int or a device tensor (`_round_key`).
    `place_rows` R > 0 stores row s·R + r's ciphertext at row r·(n_rows/R)
    + s; its keystream stays row s·R + r's.
    """
    if layout.total_blocks == 0:
        return wire
    table = device_constant(_layout_table, layout, wire.device)
    nonce, round_dev = _round_key(cfg, round_id)
    return chacha20_xor_packed(wire, table, cfg.key_words, nonce, cfg.counter0, nonce_ids,
                               ctr_rows, impl=cfg.impl, round_dev=round_dev,
                               place_rows=place_rows)


# --- the exchange ------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _exchange_ids(s: int, r: int, device):
    """(send_ids, send_rows, recv_ids, recv_rows): (S·R,) int32 on `device`.

    Sender row (shard, dest): nonce id = shard, counter row = dest; receiver
    row (shard, src): nonce id = src, counter row = shard.
    """
    shard = torch.arange(s, dtype=torch.int32, device=device).repeat_interleave(r)
    row = torch.arange(r, dtype=torch.int32, device=device).repeat(s)
    return shard, row, row, shard


def _passes(pairs) -> int:
    """Full passes over the wire among (out, src) pairs: each `out` with
    storage of its own, which a pass over the bytes made. Counted only while
    the wire accounting records; compared on the host, so nothing syncs.
    Storages are told apart by their handles: every storage on `meta` has
    address 0."""
    if not wire_accounting.enabled:
        return 0
    return sum(o.untyped_storage()._cdata != src.untyped_storage()._cdata for o, src in pairs)


def keyed_all_to_all(tree, mesh, secure: SecureShuffleConfig | None = None,
                     round_index=None, coalesce=None):
    """all_to_all every (S, R, C, ...) leaf: row i of shard j came from shard i.

    In secure mode leaves are packed to word wires, encrypted, exchanged,
    decrypted and unpacked. With the coalesced layout the whole pytree is one
    wire and a round costs 2 keystream launches (one per side, each over all
    S·R rows) and one exchange. `round_index` selects a disjoint keystream
    per round: a host int, or a device tensor that the kernel reads (an int32
    tensor is taken as u32 bits, another integer masked to 32 bits); None is
    round 0. In plaintext mode `coalesce` picks the wire (default packed); in
    secure mode the config's own `coalesce` governs.

    When grad is enabled and a leaf requires it, the exchange runs as the op
    `torch.ops.repro_torch.keyed_exchange` (same bits), whose backward is the
    same exchange of the cotangents (`_exchange_backward`). The forward call
    is the span `shuffle.exchange` (`repro_torch.tools.opcount.spans`).
    """
    with spans.span("shuffle.exchange"):
        leaves, treedef = tree_flatten(tree)
        if torch.is_grad_enabled() and any(leaf.requires_grad for leaf in leaves):
            if isinstance(round_index, torch.Tensor):
                raise ValueError("a differentiable exchange takes a host round index")
            args = _exchange_args(mesh, secure, round_index, coalesce)
            return tree_unflatten(treedef, keyed_exchange(leaves, *args))
        return _exchange(tree, mesh, secure, round_index, coalesce)


# --- the differentiable exchange ----------------------------------------------------

BACKWARD_ROUND_BIT = 1 << 31  # XORed into a leg's round index for its cotangents' leg


def _exchange_args(mesh, secure, round_index, coalesce) -> tuple:
    """The op's arguments after `leaves`: the wire resolved to a bool, the
    session material as host ints (zeros for plaintext), None as round 0."""
    if secure is None:
        return (mesh.n_shards, False, [0] * 8, [0] * 3, 0, 0, "auto",
                resolve_coalesce(coalesce))
    return (mesh.n_shards, True,
            [int(w) for w in np.asarray(secure.key_words, np.uint32).reshape(-1)],
            [int(w) for w in np.asarray(secure.nonce_words, np.uint32).reshape(-1)],
            int(secure.counter0), int(round_index or 0) & MASK32, secure.impl,
            resolve_coalesce(secure.coalesce))


@torch.library.custom_op("repro_torch::keyed_exchange", mutates_args=())
def keyed_exchange(leaves: list[torch.Tensor], n_shards: int, secure: bool,
                   key_words: list[int], nonce_words: list[int], counter0: int,
                   round_index: int, impl: str, coalesce: bool) -> list[torch.Tensor]:
    """`keyed_all_to_all` of a list of (S, R, C, ...) leaves as one operator:
    a selective-checkpoint policy can save its outputs by name, and its
    backward is `_exchange_backward`."""
    return _exchange_op_body(leaves, n_shards, secure, key_words, nonce_words, counter0,
                             round_index, impl, coalesce)


@keyed_exchange.register_fake
def _(leaves, n_shards, secure, key_words, nonce_words, counter0, round_index, impl,
      coalesce):
    # the same exchange on the abstract (meta) tensors: shape-only packing,
    # the crypt operator's fake and a transpose, so an abstract run
    # (`repro_torch.launch.dryrun`) records the wire, its collectives and its
    # kernel calls as a real run does
    return _exchange_op_body(leaves, n_shards, secure, key_words, nonce_words, counter0,
                             round_index, impl, coalesce)


def _exchange_op_body(leaves, n_shards, secure, key_words, nonce_words, counter0,
                      round_index, impl, coalesce) -> list:
    mesh = VirtualMesh(n_shards, leaves[0].device)
    cfg = None
    if secure:
        cfg = SecureShuffleConfig(key_words=np.asarray(key_words, np.uint32),
                                  nonce_words=np.asarray(nonce_words, np.uint32),
                                  counter0=counter0, impl=impl, coalesce=coalesce)
    out = _exchange(list(leaves), mesh, cfg, round_index, coalesce)
    if leaves[0].device.type == "meta":
        return [o.clone() for o in out]
    # an operator's outputs own their storage: a leaf the exchange left in
    # place (one shard), or two leaves unpacked from one wire, are copied
    seen = {leaf.untyped_storage().data_ptr() for leaf in leaves}
    owned = []
    for o in out:
        if o.numel() and o.untyped_storage().data_ptr() in seen:
            o = o.clone()
        seen.add(o.untyped_storage().data_ptr())
        owned.append(o)
    return owned


def _exchange_setup(ctx, inputs, output):
    leaves, *args = inputs
    ctx.args = args
    ctx.leaves = [(leaf.shape, leaf.dtype, leaf.device, leaf.is_floating_point())
                  for leaf in leaves]


def _exchange_backward(ctx, grads):
    """The exchange is a transpose of the shard axes, its own inverse, so the
    cotangents cross back by the same exchange. In secure mode they travel
    encrypted, under round index ^ 2**31 (nonce word 1): a pad no forward
    leg draws whatever the wire's size, and the same at every replay. The
    wire accounting records this leg as a leg of its own."""
    n_shards, secure, key_words, nonce_words, counter0, round_index, impl, coalesce = ctx.args
    idx = [i for i, like in enumerate(ctx.leaves) if like[3]]
    cts = [grads[i] if grads[i] is not None
           else torch.zeros(ctx.leaves[i][0], dtype=ctx.leaves[i][1], device=ctx.leaves[i][2])
           for i in idx]
    back = keyed_exchange(cts, n_shards, secure, key_words, nonce_words, counter0,
                          round_index ^ BACKWARD_ROUND_BIT, impl, coalesce)
    out = [None] * len(ctx.leaves)
    for i, g in zip(idx, back):
        out[i] = g
    return (out,) + (None,) * 8


keyed_exchange.register_autograd(_exchange_backward, setup_context=_exchange_setup)


def _exchange(tree, mesh, secure, round_index, coalesce):
    """The exchange itself: `keyed_all_to_all`'s contract."""
    leaves = tree_flatten(tree)[0]
    s = mesh.n_shards
    r = leaves[0].shape[1]
    if secure is None:
        if resolve_coalesce(coalesce):
            wire, layout, treedef = _pack_wire_coalesced(tree, lead=2)
            moved = mesh.all_to_all(wire)
            wire_accounting.note(secure=False, nbytes=layout.payload_words * r * 4,
                      n_leaves=len(layout.leaves), coalesced=True,
                      per_leaf=[m[4] * r * 4 for m in layout.leaves], collectives=1,
                      copies=_passes([(wire, leaves[0]), (moved, wire)]))
            return _unpack_wire_coalesced(moved, layout, treedef, lead=2)
        raw = [l.numel() // s * l.dtype.itemsize for l in leaves]
        moved = tree_map(mesh.all_to_all, tree)
        wire_accounting.note(secure=False, nbytes=sum(raw), n_leaves=len(leaves), per_leaf=raw,
                  collectives=len(leaves),
                  copies=_passes(zip(tree_flatten(moved)[0], leaves)))
        return moved

    send_ids, send_rows, recv_ids, recv_rows = device_constant(_exchange_ids, s, r,
                                                               leaves[0].device)

    if resolve_coalesce(secure.coalesce):
        wire, layout, treedef = _pack_wire_coalesced(tree, lead=2)
        w = wire.shape[-1]
        # the encrypt stores each row where its receiver reads it: the exchange's
        # transpose of this view is the buffer itself
        placed = _crypt_wire_coalesced(wire.reshape(s * r, w), layout, secure, send_ids,
                                       send_rows, round_index, place_rows=r)
        moved = mesh.all_to_all(placed.reshape(r, s, w).transpose(0, 1))
        per_leaf = [m[4] * r * 4 for m in layout.leaves]
        wire_accounting.note(secure=True, nbytes=sum(per_leaf), n_leaves=len(layout.leaves),
                  coalesced=True, pad_bytes=w * r * 4 - sum(per_leaf),
                  per_leaf=per_leaf, collectives=1, keystream_launches=2,
                  keystream_blocks=2 * r * layout.total_blocks,
                  copies=_passes([(wire, leaves[0]), (moved, placed)]))
        flat = _crypt_wire_coalesced(moved.reshape(s * r, w), layout, secure, recv_ids,
                                     recv_rows, round_index)
        return _unpack_wire_coalesced(flat.reshape(s, r, w), layout, treedef, lead=2)

    wires, meta, treedef = _pack_wire(tree, lead=2)
    flat = [wi.reshape(s * r, -1) for wi in wires]
    flat = _crypt_wires(flat, meta, secure, send_ids, send_rows, round_index, r=r)
    moved = [mesh.all_to_all(f.reshape(s, r, -1)) for f in flat]
    wire_accounting.note(secure=True, nbytes=sum(wi.numel() // s * 4 for wi in wires),
              n_leaves=len(wires), per_leaf=[wi.numel() // s * 4 for wi in wires],
              collectives=len(wires), keystream_launches=2 * len(wires),
              keystream_blocks=2 * sum(r * -(-wi.shape[-1] // 16) for wi in wires),
              copies=_passes([*zip(wires, leaves), *zip(moved, flat)]))
    flat = [m.reshape(s * r, -1) for m in moved]
    flat = _crypt_wires(flat, meta, secure, recv_ids, recv_rows, round_index, r=r)
    return _unpack_wire([f.reshape(s, r, -1) for f in flat], meta, treedef, lead=2)
