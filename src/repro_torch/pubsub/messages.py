"""Wire format: encrypted headers/subscriptions + separately-keyed payloads.

Counterpart of `repro/pubsub/messages.py`, over the port's host ChaCha20:
the same sealed bytes for the same sequence numbers.

Paper §III: "All subscriptions and publication messages are encrypted using a
symmetric cypher while outside the SGX enclaves. The subscriptions and
publication headers are decrypted inside the enclave, where subscriptions are
stored. Then, the service routes the publication payloads (encrypted with a
different key) to matching subscribers."

Headers are flat string->(str|int) dicts serialized as JSON; subscriptions
are conjunctions of (field, op, value) constraints, op in {==, !=, <, <=, >,
>=, exists}. Every wire blob carries a 4-byte counter prefix used as the CTR
nonce stream id, so no two messages reuse a keystream.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from typing import Any

from repro_torch.crypto.chacha import chacha20_encrypt_bytes
from repro_torch.crypto.keys import SessionKeys

_WIRE_SEQ = itertools.count(1)

OPS = {"==", "!=", "<", "<=", ">", ">=", "exists"}


def _seal(key: bytes, label: str, obj_bytes: bytes) -> bytes:
    seq = next(_WIRE_SEQ)
    nonce = SessionKeys.nonce(label, seq)
    ct = chacha20_encrypt_bytes(key, nonce, 0, obj_bytes)
    return seq.to_bytes(8, "little") + ct


def _open(key: bytes, label: str, blob: bytes) -> bytes:
    seq = int.from_bytes(blob[:8], "little")
    nonce = SessionKeys.nonce(label, seq)
    return chacha20_encrypt_bytes(key, nonce, 0, blob[8:])


@dataclass(frozen=True)
class Subscription:
    """Conjunction of constraints over header fields."""

    constraints: tuple  # ((field, op, value), ...)
    subscriber: str
    sub_id: int = 0

    def matches(self, header: dict) -> bool:
        for f, op, v in self.constraints:
            if op == "exists":
                if f not in header:
                    return False
                continue
            if f not in header:
                return False
            h = header[f]
            try:
                ok = {
                    "==": h == v,
                    "!=": h != v,
                    "<": h < v,
                    "<=": h <= v,
                    ">": h > v,
                    ">=": h >= v,
                }[op]
            except TypeError:
                return False
            if not ok:
                return False
        return True

    def seal(self, header_key: bytes) -> bytes:
        obj = {"c": list(self.constraints), "s": self.subscriber, "i": self.sub_id}
        return _seal(header_key, "sub", json.dumps(obj).encode())

    @staticmethod
    def unseal(header_key: bytes, blob: bytes) -> "Subscription":
        obj = json.loads(_open(header_key, "sub", blob))
        return Subscription(
            constraints=tuple(tuple(c) for c in obj["c"]),
            subscriber=obj["s"],
            sub_id=obj["i"],
        )


@dataclass
class Message:
    """A publication: encrypted header + separately-encrypted payload."""

    header_ct: bytes
    payload_ct: bytes
    sender: str = ""

    @staticmethod
    def seal(header: dict, payload: bytes, header_key: bytes, payload_key: bytes,
             sender: str = "") -> "Message":
        hct = _seal(header_key, "hdr", json.dumps(header).encode())
        pct = _seal(payload_key, "pay", payload)
        return Message(header_ct=hct, payload_ct=pct, sender=sender)

    def open_header(self, header_key: bytes) -> dict:
        return json.loads(_open(header_key, "hdr", self.header_ct))

    def open_payload(self, payload_key: bytes) -> bytes:
        return _open(payload_key, "pay", self.payload_ct)

    @property
    def wire_bytes(self) -> int:
        return len(self.header_ct) + len(self.payload_ct)
