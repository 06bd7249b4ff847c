"""The port's SCBR pub/sub layer against the JAX package's.

`repro_torch.pubsub` (sealed `Message` and `Subscription`, `ScbrRouter`, the
session protocol's subscriptions) holds the same contract as
`repro.pubsub`: for the same wire sequence numbers both seal to identical
bytes, each opens the other's blobs, and the two routers deliver the same
publications to the same subscribers with the same counts.
"""

import itertools

import pytest

from repro.pubsub import messages as jmsg
from repro.pubsub import protocol as jpr
from repro.pubsub import router as jrouter
from repro_torch.crypto.keys import make_session_keys
from repro_torch.pubsub import Message, ScbrRouter, Subscription
from repro_torch.pubsub import messages as tmsg
from repro_torch.pubsub import protocol as tpr

KEYS = make_session_keys(b"\x42" * 32)
HEADERS = [
    {"type": "MAP_DATATYPE", "job": "j1", "dest": "w0", "split": 3},
    {"type": "MAP_DATATYPE", "job": "j1", "dest": "w1", "split": 4},
    {"type": "MAP_EOS", "job": "j1", "slot": 0},
    {"type": "RESULT", "job": "j2"},
    {"type": "HEARTBEAT", "from": "w2", "t": 7},
]
SUBS = [
    (("type", "==", "MAP_DATATYPE"), ("job", "==", "j1"), ("dest", "==", "w0")),
    (("type", "==", "MAP_EOS"), ("job", "==", "j1")),
    (("split", ">=", 4),),
    (("t", "<", 10), ("from", "!=", "w9")),
    (("slot", "exists", None),),
    (("split", "<=", "x"),),  # a type mismatch never matches
]


@pytest.fixture
def same_sequence(monkeypatch):
    """Both packages' wire counters restart at 1."""
    monkeypatch.setattr(tmsg, "_WIRE_SEQ", itertools.count(1))
    monkeypatch.setattr(jmsg, "_WIRE_SEQ", itertools.count(1))


def test_sealed_messages_equal_the_reference_bit_for_bit(same_sequence):
    for i, header in enumerate(HEADERS):
        payload = bytes(range(i * 7 % 256)) * 3
        t = Message.seal(header, payload, KEYS.header, KEYS.data, sender="c")
        j = jmsg.Message.seal(header, payload, KEYS.header, KEYS.data, sender="c")
        assert (t.header_ct, t.payload_ct, t.wire_bytes) == (j.header_ct, j.payload_ct,
                                                             j.wire_bytes)
        assert t.open_header(KEYS.header) == header == j.open_header(KEYS.header)
        assert t.open_payload(KEYS.data) == payload
        # each package opens the other's blobs
        assert jmsg.Message(t.header_ct, t.payload_ct).open_payload(KEYS.data) == payload
        assert Message(j.header_ct, j.payload_ct).open_header(KEYS.header) == header
    for n, c in enumerate(SUBS):
        t = Subscription(constraints=c, subscriber=f"s{n}", sub_id=n).seal(KEYS.header)
        j = jmsg.Subscription(constraints=c, subscriber=f"s{n}", sub_id=n).seal(KEYS.header)
        assert t == j
        back = Subscription.unseal(KEYS.header, j)
        assert back == Subscription(constraints=tuple(tuple(x) for x in c),
                                    subscriber=f"s{n}", sub_id=n)


def test_subscription_matching_equals_the_reference():
    for c in SUBS:
        ts, js = Subscription(c, "s"), jmsg.Subscription(c, "s")
        for h in HEADERS + [{}, {"split": "4"}]:
            assert ts.matches(h) == js.matches(h), (c, h)


def test_router_delivers_as_the_reference_router():
    """One scenario through both routers: the same targets per publication,
    the same outboxes and the same stats; payloads stay sealed."""
    routers = {"port": ScbrRouter(KEYS.header), "ref": jrouter.ScbrRouter(KEYS.header)}
    sub_cls = {"port": Subscription, "ref": jmsg.Subscription}
    msg_cls = {"port": Message, "ref": jmsg.Message}
    got = {}
    for side, router in routers.items():
        sids = [router.subscribe(sub_cls[side](c, f"s{n % 3}").seal(KEYS.header))
                for n, c in enumerate(SUBS)]
        router.unsubscribe(sids[1])
        targets = [router.publish(msg_cls[side].seal(h, b"secret", KEYS.header, KEYS.data,
                                                     sender="s2"))
                   for h in HEADERS]
        router.unsubscribe_all("s0")
        targets.append(router.publish(msg_cls[side].seal(HEADERS[0], b"x", KEYS.header,
                                                         KEYS.data)))
        drained = {s: [m.open_payload(KEYS.data) for m in router.drain(s)]
                   for s in ("s0", "s1", "s2")}
        st = router.stats
        got[side] = (targets, drained, st.publications, st.deliveries, st.subscriptions,
                     st.match_checks)
    assert got["port"][0] == got["ref"][0] and got["port"][1] == got["ref"][1]
    assert got["port"][2:] == got["ref"][2:]
    assert any(got["port"][0]) and b"secret" in got["port"][1]["s1"]


def test_protocol_subscriptions_equal_the_reference():
    names = ["JOB_OPENING", "JOB_DETAILS", "MAP_CODETYPE", "REDUCE_CODETYPE", "MAP_DATATYPE",
             "REDUCE_DATATYPE", "MAP_EOS", "RESULT", "HEARTBEAT"]
    assert [getattr(tpr, n) for n in names] == [getattr(jpr, n) for n in names]
    for fn, args in (("sub_job_openings", ("w0",)), ("sub_job_details", ("c", "j")),
                     ("sub_code", ("w1", "j", "mapper")), ("sub_code", ("w1", "j", "reducer")),
                     ("sub_data", ("w2", "j", "mapper")), ("sub_data", ("w2", "j", "reducer")),
                     ("sub_eos", ("w3", "j")), ("sub_results", ("c", "j")),
                     ("sub_heartbeats", ("c",))):
        t, j = getattr(tpr, fn)(*args), getattr(jpr, fn)(*args)
        assert (t.constraints, t.subscriber, t.sub_id) == (j.constraints, j.subscriber, j.sub_id)
