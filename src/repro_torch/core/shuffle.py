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
word offsets and zero pad words. The keystream is derived in the
block-aligned virtual layout by XOR with zeros and sliced onto the packed
wire (`_packed_keystream`), so each leaf region keeps the per-leaf
(key, nonce, counter) assignment. On the virtual mesh one keystream launch
covers all S·R wire rows of a side: sender rows use nonce id = the shard and
counter row = the destination; receiver rows use nonce id = the source and
counter row = the shard. A secure round is therefore 2 ChaCha launches with
the transpose between them. The per-leaf wire is kept as the oracle
(`SecureShuffleConfig.coalesce=False`).

The wire is 32-bit words held as int32 (u32 bit patterns): ciphertext never
travels as floats, which could quiet NaN payloads.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from repro_torch.crypto import ctr as _ctr
from repro_torch.crypto.chacha import MASK32, as_u32, u32_mul
from repro_torch.crypto.ctr import WORD, words_for
from repro_torch.kernels.chacha20.ops import (
    chacha20_xor_rows,
    chacha20_xor_rows_coalesced,
    make_state0,
)
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def resolve_coalesce(coalesce="auto") -> bool:
    """Resolve a coalesce selector: a bool wins; 'auto'/None is the packed wire."""
    if isinstance(coalesce, (bool, np.bool_)):
        return bool(coalesce)
    if coalesce in (None, "auto"):
        return True
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

    def with_impl(self, impl: str | None) -> "SecureShuffleConfig":
        """Copy with a different keystream impl (None keeps the current one)."""
        if impl is None or impl == self.impl:
            return self
        return replace(self, impl=impl)

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


# --- per-leaf wire (the oracle) ------------------------------------------------


def _crypt_rows(cfg: SecureShuffleConfig, words, nonce_ids, ctr_starts, round_id):
    """XOR an (n_rows, n_words) wire with per-row keystreams (one launch)."""
    state0 = make_state0(cfg.key_words, _round_nonce(cfg, round_id), 0, device=words.device)
    return chacha20_xor_rows(words, state0, nonce_ids, ctr_starts, impl=cfg.impl)


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

    leaves:      per-leaf (row shape, dtype, narrow-pad, word_start, n_words,
                 blocks, ks_start): word_start on the PACKED wire, ks_start =
                 16·Σ preceding blocks in the block-aligned keystream layout.
    ctr_base:    (total_blocks,) u32 -- leaf counter offset (Σ preceding
                 blocks·R) + intra-leaf block index; counter0 is added at
                 crypt time.
    ctr_rowmul:  (total_blocks,) u32 -- the owning leaf's blocks per row.
    """

    leaves: tuple
    ctr_base: Any
    ctr_rowmul: Any
    total_blocks: int

    @property
    def total_words(self) -> int:
        """Words of the block-aligned KEYSTREAM layout (>= payload_words)."""
        return self.total_blocks * 16

    @property
    def payload_words(self) -> int:
        """Words of the packed wire -- exactly what crosses the link."""
        return sum(m[4] for m in self.leaves)


def _pack_wire_coalesced(tree, lead: int = 1):
    """Bitcast + concatenate the whole pytree into ONE packed word wire.

    Returns (wire (…, R, payload_words) int32, layout, treedef); R, the rows
    of one shard, is the dim just before C.
    """
    leaves, treedef = tree_flatten(tree)
    lead_shape = tuple(leaves[0].shape[:lead])
    r = lead_shape[-1]
    segs, meta, base_parts, mul_parts = [], [], [], []
    word_off = ctr_off = ks_off = 0
    for leaf in leaves:
        row_shape = tuple(leaf.shape[lead:])
        words = _ctr._to_words(leaf, lead)[0]
        n_words = words.shape[-1]
        blocks = -(-n_words // 16)
        segs.append(words)
        meta.append((row_shape, leaf.dtype, _ctr.pad_for(row_shape, leaf.dtype),
                     word_off, n_words, blocks, ks_off))
        base_parts.append((ctr_off + np.arange(blocks, dtype=np.uint64)) & MASK32)
        mul_parts.append(np.full((blocks,), blocks, np.uint64))
        word_off += n_words
        ctr_off += blocks * r
        ks_off += blocks * 16
    wire = torch.cat(segs, dim=-1) if segs else torch.zeros(
        lead_shape + (0,), dtype=WORD, device=leaves[0].device)
    layout = _WireLayout(
        leaves=tuple(meta),
        ctr_base=np.concatenate(base_parts).astype(np.uint32) if base_parts
        else np.zeros((0,), np.uint32),
        ctr_rowmul=np.concatenate(mul_parts).astype(np.uint32) if mul_parts
        else np.zeros((0,), np.uint32),
        total_blocks=ks_off // 16,
    )
    return wire, layout, treedef


def _unpack_wire_coalesced(wire, layout: _WireLayout, treedef, lead: int = 1):
    leaves = [_ctr._from_words(wire[..., start:start + n_words], shape, dtype, pad, lead)
              for shape, dtype, pad, start, n_words, _b, _ks in layout.leaves]
    return tree_unflatten(treedef, leaves)


def _packed_keystream(ks_aligned, layout: _WireLayout):
    """Slice the packed wire's keystream out of the block-aligned keystream:
    each leaf's first n_words at its aligned ks_start, concatenated."""
    segs = [ks_aligned[..., m[6]:m[6] + m[4]] for m in layout.leaves]
    return torch.cat(segs, dim=-1) if segs else ks_aligned[..., :0]


def _crypt_wire_coalesced(wire, layout: _WireLayout, cfg, nonce_ids, ctr_rows,
                          round_id=None):
    """XOR an (n_rows, payload_words) packed wire with its keystream -- ONE launch.

    Block j of row i uses counter counter0 + ctr_base[j] + ctr_rowmul[j] ·
    ctr_rows[i] and nonce word 0 XOR nonce_ids[i]; the keystream is derived
    block-aligned (XOR with zeros) and sliced onto the packed wire.
    """
    if layout.total_blocks == 0:
        return wire
    dev = wire.device
    state0 = make_state0(cfg.key_words, _round_nonce(cfg, round_id), 0, device=dev)
    ctr_base = (layout.ctr_base.astype(np.uint64) + int(cfg.counter0)) & MASK32
    zeros = torch.zeros((wire.shape[0], layout.total_words), dtype=WORD, device=dev)
    ks = chacha20_xor_rows_coalesced(zeros, state0, nonce_ids, ctr_rows, ctr_base,
                                     layout.ctr_rowmul, impl=cfg.impl)
    return wire ^ _packed_keystream(ks, layout)


# --- wire accounting -------------------------------------------------------------

_sinks: list[list] = []


def note_wire(*, secure: bool, nbytes: int, n_leaves: int, halted: bool = False,
              coalesced: bool = False, pad_bytes: int = 0, per_leaf=None,
              collectives: int = 0, keystream_launches: int = 0,
              keystream_blocks: int = 0) -> None:
    """Append one record per shuffle call to every open `record_wire_bytes`.

    Fields are those of `repro.core.shuffle._WireAccounting.note`, per shard:
    bytes (payload), wire_bytes (= bytes + pad_bytes), per_leaf payload
    bytes, collectives (all_to_all exchanges), keystream_launches and
    keystream_blocks (encrypt + decrypt); job is always None in this port.
    """
    if not _sinks:
        return
    rec = {"secure": secure, "bytes": nbytes, "leaves": n_leaves,
           "halted": halted, "coalesced": coalesced,
           "wire_bytes": nbytes + pad_bytes, "pad_bytes": pad_bytes,
           "per_leaf": list(per_leaf or []), "collectives": collectives,
           "keystream_launches": keystream_launches,
           "keystream_blocks": keystream_blocks, "job": None}
    for sink in _sinks:
        sink.append(dict(rec))


class record_wire_bytes:
    """Context manager: one record per `keyed_all_to_all` call inside the block.

    The port runs eagerly, so every executed round's shuffle appends its own
    record (the JAX package records once per traced program).
    """

    def __init__(self):
        self.records: list[dict] = []

    def __enter__(self):
        self.records = []
        _sinks.append(self.records)
        return self.records

    def __exit__(self, *exc):
        for i, sink in enumerate(_sinks):
            if sink is self.records:
                del _sinks[i]
                break
        return False


# --- the exchange ------------------------------------------------------------------


def keyed_all_to_all(tree, mesh, secure: SecureShuffleConfig | None = None,
                     round_index=None, coalesce=None):
    """all_to_all every (S, R, C, ...) leaf: row i of shard j came from shard i.

    In secure mode leaves are packed to word wires, encrypted, exchanged,
    decrypted and unpacked. With the coalesced layout the whole pytree is one
    wire and a round costs 2 keystream launches (one per side, each over all
    S·R rows) and one exchange. `round_index` (a host int) selects a
    disjoint keystream per round; None is round 0. In plaintext mode
    `coalesce` picks the wire (default packed); in secure mode the config's
    own `coalesce` governs.
    """
    leaves = tree_flatten(tree)[0]
    s = mesh.n_shards
    r = leaves[0].shape[1]
    if secure is None:
        if resolve_coalesce(coalesce):
            wire, layout, treedef = _pack_wire_coalesced(tree, lead=2)
            note_wire(secure=False, nbytes=layout.payload_words * r * 4,
                      n_leaves=len(layout.leaves), coalesced=True,
                      per_leaf=[m[4] * r * 4 for m in layout.leaves], collectives=1)
            return _unpack_wire_coalesced(mesh.all_to_all(wire), layout, treedef, lead=2)
        raw = [l.numel() // s * l.dtype.itemsize for l in leaves]
        note_wire(secure=False, nbytes=sum(raw), n_leaves=len(leaves), per_leaf=raw,
                  collectives=len(leaves))
        return tree_map(mesh.all_to_all, tree)

    dev = leaves[0].device
    shard = torch.arange(s, device=dev)[:, None].expand(s, r).reshape(-1)
    row = torch.arange(r, device=dev)[None, :].expand(s, r).reshape(-1)
    # sender (shard, row=dest): nonce id = shard, counter row = dest;
    # receiver (shard, row=src): nonce id = src, counter row = shard
    send_ids, send_rows, recv_ids, recv_rows = shard, row, row, shard

    if resolve_coalesce(secure.coalesce):
        wire, layout, treedef = _pack_wire_coalesced(tree, lead=2)
        per_leaf = [m[4] * r * 4 for m in layout.leaves]
        note_wire(secure=True, nbytes=sum(per_leaf), n_leaves=len(layout.leaves),
                  coalesced=True, pad_bytes=wire.shape[-1] * r * 4 - sum(per_leaf),
                  per_leaf=per_leaf, collectives=1, keystream_launches=2,
                  keystream_blocks=2 * r * layout.total_blocks)
        w = wire.shape[-1]
        flat = _crypt_wire_coalesced(wire.reshape(s * r, w), layout, secure,
                                     send_ids, send_rows, round_index)
        flat = mesh.all_to_all(flat.reshape(s, r, w)).reshape(s * r, w)
        flat = _crypt_wire_coalesced(flat, layout, secure, recv_ids, recv_rows, round_index)
        return _unpack_wire_coalesced(flat.reshape(s, r, w), layout, treedef, lead=2)

    wires, meta, treedef = _pack_wire(tree, lead=2)
    note_wire(secure=True, nbytes=sum(wi.numel() // s * 4 for wi in wires),
              n_leaves=len(wires), per_leaf=[wi.numel() // s * 4 for wi in wires],
              collectives=len(wires), keystream_launches=2 * len(wires),
              keystream_blocks=2 * sum(r * -(-wi.shape[-1] // 16) for wi in wires))
    flat = [wi.reshape(s * r, -1) for wi in wires]
    flat = _crypt_wires(flat, meta, secure, send_ids, send_rows, round_index, r=r)
    flat = [mesh.all_to_all(f.reshape(s, r, -1)).reshape(s * r, -1) for f in flat]
    flat = _crypt_wires(flat, meta, secure, recv_ids, recv_rows, round_index, r=r)
    return _unpack_wire([f.reshape(s, r, -1) for f in flat], meta, treedef, lead=2)
