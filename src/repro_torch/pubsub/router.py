"""The SCBR routing engine.

Counterpart of `repro/pubsub/router.py`.

The router's matching runs "inside the enclave": it holds the header key,
decrypts subscriptions/headers there, and forwards *payloads it cannot read*
(payload key never enters the router). Delivery is via per-subscriber
outboxes drained by the runtime simulator.

The paper notes the centralized router is the scalability limit and cites
StreamHub/elastic-scaling [16,17]; `shard_hint` reproduces that design note:
routers can be replicated per header-field shard.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

from repro_torch.pubsub.messages import Message, Subscription


@dataclass
class RouterStats:
    publications: int = 0
    deliveries: int = 0
    subscriptions: int = 0
    wire_bytes: int = 0
    match_checks: int = 0


class ScbrRouter:
    """Content-based matcher with enclave-held header key."""

    def __init__(self, header_key: bytes, name: str = "scbr"):
        self._header_key = header_key  # lives only "inside the enclave"
        self.name = name
        self._subs: dict[int, Subscription] = {}
        self._next_id = 1
        self.outboxes: dict[str, list] = defaultdict(list)
        self.stats = RouterStats()

    # -- subscription management (encrypted on the wire) ----------------------

    def subscribe(self, sub_ct: bytes) -> int:
        sub = Subscription.unseal(self._header_key, sub_ct)  # decrypt in enclave
        sid = self._next_id
        self._next_id += 1
        self._subs[sid] = sub
        self.stats.subscriptions += 1
        self.stats.wire_bytes += len(sub_ct)
        return sid

    def unsubscribe(self, sid: int):
        self._subs.pop(sid, None)

    def unsubscribe_all(self, subscriber: str):
        for sid in [s for s, sub in self._subs.items() if sub.subscriber == subscriber]:
            del self._subs[sid]

    # -- publication -----------------------------------------------------------

    def publish(self, msg: Message) -> list[str]:
        header = msg.open_header(self._header_key)  # decrypt in enclave
        targets = []
        for sub in list(self._subs.values()):
            self.stats.match_checks += 1
            if sub.matches(header) and sub.subscriber != msg.sender:
                targets.append(sub.subscriber)
        # payload forwarded still-encrypted; router never holds its key
        for t in dict.fromkeys(targets):
            self.outboxes[t].append(msg)
            self.stats.deliveries += 1
        self.stats.publications += 1
        self.stats.wire_bytes += msg.wire_bytes
        return list(dict.fromkeys(targets))

    def drain(self, subscriber: str) -> list[Message]:
        out = self.outboxes[subscriber]
        self.outboxes[subscriber] = []
        return out
