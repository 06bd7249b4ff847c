"""Client and worker nodes (the paper's Fig. 2 entities), with fault tolerance.

Counterpart of `repro/runtime/node.py`: pure Python over the port's keys,
pub/sub messages, SecurePager and simulator.

User code ships exactly like the paper's Lua scripts: a *source string*
defining `map(key, value)` / optional `combine(key, values)` / `hash(key,
rcount)` for mappers and `reduce(key, values)` for reducers, executed in a
restricted namespace where the framework injects `push(key, value)`. The
source travels ChaCha20-encrypted (k_code) and is only exec'd inside the
worker ("enclave"); the SCBR router never holds the payload keys.

Security policy toggles reproduce the paper's 4-combo evaluation:
  encryption — payload cipher on the wire (headers always sealed: SCBR needs
               them in its own enclave);
  enclave    — per-message enclave-transition cost + SecurePager working-set
               costs (EPC paging analogue).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.crypto.keys import Attestation, KeyHierarchy, SessionKeys
from repro_torch.core.paging import SecurePager
from repro_torch.pubsub import protocol as pr
from repro_torch.pubsub.messages import Message, Subscription
from repro_torch.runtime.sim import Cluster, Entity

MAP_ACK = "MAP_ACK"
RESHUFFLE = "RESHUFFLE"

_SAFE_BUILTINS = {
    "abs": abs, "min": min, "max": max, "sum": sum, "len": len, "range": range,
    "enumerate": enumerate, "zip": zip, "float": float, "int": int, "str": str,
    "sorted": sorted, "round": round, "list": list, "dict": dict, "tuple": tuple,
    "ord": ord, "chr": chr, "set": set, "map": map, "filter": filter, "bool": bool,
}


def load_script(source: str, consts: dict) -> dict:
    """exec the shipped script in a restricted namespace (the "Lua VM")."""
    ns: dict[str, Any] = {"__builtins__": dict(_SAFE_BUILTINS), "math": math, "consts": consts}
    exec(source, ns)  # runs only inside the worker "enclave"
    return ns


def default_hash(key, rcount: int) -> int:
    """Paper Listing 1: `string.byte(key, 1) % rcount`."""
    return ord(str(key)[0]) % rcount


@dataclass
class SecurityPolicy:
    encryption: bool = True
    enclave: bool = True


@dataclass
class MapReduceJob:
    job_id: str
    map_source: str          # defines map(key,value) [+ combine, hash]
    reduce_source: str       # defines reduce(key, values)
    data: list               # rows; split "line by line" round-robin
    n_mappers: int
    n_reducers: int
    consts: dict = field(default_factory=dict)


class _Script:
    """Instantiated user code with the framework's push() collector."""

    def __init__(self, source: str, consts: dict):
        self.ns = load_script(source, consts)

    def _call(self, name: str, *args):
        pairs: list = []
        self.ns["push"] = lambda k, v: pairs.append((k, v))
        self.ns[name](*args)
        return pairs

    def map(self, key, value):
        return self._call("map", key, value)

    def combine(self, key, values):
        if "combine" not in self.ns:
            return [(key, v) for v in values]
        return self._call("combine", key, values)

    def reduce(self, key, values):
        return self._call("reduce", key, values)

    def hash(self, key, rcount: int) -> int:
        if "hash" in self.ns:
            return int(self.ns["hash"](key, rcount)) % rcount
        return default_hash(key, rcount)


class _SecureEndpoint(Entity):
    """Shared seal/open helpers with timing charges."""

    session: SessionKeys
    policy: SecurityPolicy

    def _seal(self, header: dict, payload_obj, key_label: str) -> Message:
        raw = json.dumps(payload_obj).encode()
        key = getattr(self.session, key_label)
        if self.policy.encryption:
            msg = Message.seal(header, raw, self.session.header, key, sender=self.name)
        else:
            msg = Message.seal(header, b"", self.session.header, key, sender=self.name)
            msg.payload_ct = raw  # plaintext on the wire
        return msg

    def _open(self, msg: Message, key_label: str):
        if self.policy.encryption:
            raw = msg.open_payload(getattr(self.session, key_label))
        else:
            raw = msg.payload_ct
        return json.loads(raw) if raw else None

    def _crypto_cost(self, nbytes: int) -> float:
        return self.cluster.timing.crypto_delay(nbytes) if self.policy.encryption else 0.0

    def _enclave_cost(self) -> float:
        return self.cluster.timing.enclave_call_s if self.policy.enclave else 0.0


class Worker(_SecureEndpoint):
    """A node that can assume the mapper or reducer role (paper §IV)."""

    def __init__(self, name: str, session: SessionKeys, *, speed: float = 1.0,
                 code_identity: bytes = b"worker-code-v1", role_pref: str = "any",
                 policy: SecurityPolicy | None = None):
        self.name = name
        self.session = session
        self.speed = speed
        self.code_identity = code_identity
        self.role_pref = role_pref
        self.policy = policy or SecurityPolicy()
        self.alive = True
        self.busy_until = 0.0
        self._jobs: dict[str, dict] = {}
        self.pager: SecurePager | None = None

    # -- lifecycle ---------------------------------------------------------------

    def start(self, hb_interval: float = 0.05):
        self.hb_interval = hb_interval
        self.cluster.router.subscribe(
            pr.sub_job_openings(self.name).seal(self.session.header)
        )
        self.cluster.schedule(0.0, self._heartbeat)

    def _heartbeat(self):
        if not self.alive:
            return
        self.cluster.publish(
            self._seal({"type": pr.HEARTBEAT, "worker": self.name}, None, "header"),
            stream="ctl",  # dedicated connection: never blocked behind data
        )
        self.cluster.schedule(self.hb_interval, self._heartbeat)

    # -- message handling ----------------------------------------------------------

    def on_message(self, msg: Message):
        header = msg.open_header(self.session.header)
        t = header["type"]
        if t == pr.JOB_OPENING:
            self._apply(header)
        elif t in (pr.MAP_CODETYPE, pr.REDUCE_CODETYPE):
            self._receive_code(header, msg)
        elif t == pr.MAP_DATATYPE:
            self._map_split(header, msg)
        elif t == pr.REDUCE_DATATYPE:
            self._receive_pairs(header, msg)
        elif t == pr.MAP_EOS:
            self._receive_eos(header)
        elif t == RESHUFFLE:
            self._reshuffle(header)

    def _apply(self, header: dict):
        """Paper Fig. 3: JOB_DETAILS with our code/data subscriptions."""
        job_id = header["job"]
        subs = {}
        for role in ("mapper", "reducer"):
            subs[role] = [
                pr.sub_code(self.name, job_id, role).seal(self.session.header).hex(),
                pr.sub_data(self.name, job_id, role).seal(self.session.header).hex(),
            ]
        subs["common"] = [
            pr.sub_eos(self.name, job_id).seal(self.session.header).hex(),
            Subscription(
                constraints=(("type", "==", RESHUFFLE), ("job", "==", job_id)),
                subscriber=self.name,
            ).seal(self.session.header).hex(),
        ]
        payload = {
            "worker": self.name,
            "role_pref": self.role_pref,
            "measurement": Attestation.measure(self.code_identity),
            "subs": subs,
        }
        self.cluster.publish(
            self._seal({"type": pr.JOB_DETAILS, "job": job_id}, payload, "header")
        )

    def _receive_code(self, header: dict, msg: Message):
        code = self._open(msg, "code")
        role = "mapper" if header["type"] == pr.MAP_CODETYPE else "reducer"
        if self.policy.enclave and self.pager is None:
            self.pager = SecurePager(self.cluster.timing.epc_budget_bytes, self.session.page)
        self._jobs[header["job"]] = {
            "role": role,
            "slot": code["slot"],
            "script": _Script(code["source"], code.get("consts", {})),
            "mappers": code.get("mappers", []),
            "reducers": code.get("reducers", []),
            "n_mappers": code.get("n_mappers", 0),
            "n_reducers": code.get("n_reducers", 0),
            "seen_splits": set(),
            "eos_slots": set(),
            "groups": {},        # reducer: key -> [values]
            "stored": [],        # reducer: pager page ids
            "out_buffers": {},   # mapper: reducer slot -> [(split_id, pairs)]
            "done_splits": set(),
            "sent_eos": False,
        }

    # -- mapper ------------------------------------------------------------------

    def _charge(self, seconds: float) -> float:
        """Occupy this worker; returns delay until completion (from now)."""
        start = max(self.cluster.now, self.busy_until)
        self.busy_until = start + seconds
        return self.busy_until - self.cluster.now

    def _pager_charge(self, fn) -> float:
        if not (self.policy.enclave and self.pager):
            fn()
            return 0.0
        before = self.pager.stats.modeled_seconds
        fn()
        return self.pager.stats.modeled_seconds - before

    def _map_split(self, header: dict, msg: Message):
        st = self._jobs.get(header["job"])
        if st is None or st["role"] != "mapper":
            return
        if header.get("eos"):
            delay = self._charge(self._enclave_cost())
            st["sent_eos"] = True
            self.cluster.publish(
                self._seal(
                    {"type": pr.MAP_EOS, "job": header["job"], "slot": st["slot"]},
                    None, "header",
                ),
                extra_delay=delay,
            )
            return
        split_id = header["split"]
        if split_id in st["done_splits"]:
            return  # duplicate split (client retry) — idempotent
        rows = self._open(msg, "data")
        tm = self.cluster.timing

        work = 0.0
        work += self._enclave_cost() + self._crypto_cost(msg.wire_bytes)
        # working set through the pager (EPC model)
        page_cost = self._pager_charge(
            lambda: self.pager.store(f"{header['job']}/split/{split_id}", msg.payload_ct)
            if self.pager
            else None
        )
        work += page_cost

        script = st["script"]
        pairs: list = []
        for i, row in enumerate(rows):
            pairs.extend(script.map(f"{split_id}:{i}", row))
        # local combine (paper's optional combiner)
        grouped: dict = {}
        for k, v in pairs:
            grouped.setdefault(k, []).append(v)
        combined: list = []
        for k, vs in grouped.items():
            combined.extend(script.combine(k, vs))
        work += tm.item_cost_s * (len(rows) + len(pairs) + len(combined)) / self.speed

        r = st["n_reducers"]
        by_slot: dict[int, list] = {}
        for k, v in combined:
            by_slot.setdefault(script.hash(k, r), []).append((k, v))

        delay = self._charge(work)
        for slot, kvs in by_slot.items():
            st["out_buffers"].setdefault(slot, []).append((split_id, kvs))
            dest = st["reducers"][slot]
            out = self._seal(
                {
                    "type": pr.REDUCE_DATATYPE,
                    "job": header["job"],
                    "dest": dest,
                    "split": split_id,
                    "mslot": st["slot"],
                },
                kvs,
                "shuffle",
            )
            self.cluster.publish(out, extra_delay=delay + self._crypto_cost(out.wire_bytes))
        st["done_splits"].add(split_id)
        self.cluster.publish(
            self._seal(
                {"type": MAP_ACK, "job": header["job"], "split": split_id, "worker": self.name},
                None, "header",
            ),
            extra_delay=delay,
        )

    def _reshuffle(self, header: dict):
        """A reducer slot moved: re-send buffered outputs + EOS for that slot."""
        st = self._jobs.get(header["job"])
        if st is None or st["role"] != "mapper":
            return
        slot = header["slot"]
        st["reducers"][slot] = header["new_worker"]
        delay = self._charge(self._enclave_cost())
        for split_id, kvs in st["out_buffers"].get(slot, []):
            out = self._seal(
                {
                    "type": pr.REDUCE_DATATYPE,
                    "job": header["job"],
                    "dest": header["new_worker"],
                    "split": split_id,
                    "mslot": st["slot"],
                },
                kvs,
                "shuffle",
            )
            self.cluster.publish(out, extra_delay=delay + self._crypto_cost(out.wire_bytes))
        if st["sent_eos"]:
            # FIFO on the mapper->new-reducer channel keeps this EOS behind
            # the re-sent data above.
            self.cluster.publish(
                self._seal(
                    {"type": pr.MAP_EOS, "job": header["job"], "slot": st["slot"]},
                    None, "header",
                ),
                extra_delay=delay,
            )

    # -- reducer -------------------------------------------------------------------

    def _receive_pairs(self, header: dict, msg: Message):
        st = self._jobs.get(header["job"])
        if st is None or st["role"] != "reducer":
            return
        # dedupe by split alone: a backup/replacement mapper produces the
        # identical output for the same split under a different slot.
        if header["split"] in st["seen_splits"]:
            return
        st["seen_splits"].add(header["split"])
        work = self._enclave_cost() + self._crypto_cost(msg.wire_bytes)
        pid = f"{header['job']}/rd/{header['split']}/{header['mslot']}"
        work += self._pager_charge(
            lambda: self.pager.store(pid, msg.payload_ct) if self.pager else None
        )
        st["stored"].append(pid)
        kvs = self._open(msg, "shuffle")
        for k, v in kvs:
            st["groups"].setdefault(json.dumps(k), []).append(v)
        work += self.cluster.timing.item_cost_s * len(kvs) / self.speed
        self._charge(work)

    def _receive_eos(self, header: dict):
        st = self._jobs.get(header["job"])
        if st is None or st["role"] != "reducer":
            return
        st["eos_slots"].add(header["slot"])
        if len(st["eos_slots"]) < st["n_mappers"]:
            return
        # all mappers done -> run reduce (paper: "more memory intensive")
        work = self._enclave_cost()
        if self.pager:
            for pid in st["stored"]:
                work += self._pager_charge(lambda p=pid: self.pager.load(p))
        script = st["script"]
        out_pairs = []
        n_vals = 0
        for k_json, vs in sorted(st["groups"].items()):
            out_pairs.extend(script.reduce(json.loads(k_json), vs))
            n_vals += len(vs)
        work += self.cluster.timing.item_cost_s * n_vals / self.speed
        delay = self._charge(work)
        out = self._seal(
            {"type": pr.RESULT, "job": header["job"], "slot": st["slot"]},
            out_pairs,
            "data",
        )
        self.cluster.publish(out, extra_delay=delay + self._crypto_cost(out.wire_bytes))


class Client(_SecureEndpoint):
    """Data owner: hires via pub/sub, provisions code+data, tracks completion.

    Fault tolerance (beyond the paper, which defers it): heartbeat failure
    detection; mapper replacement re-runs unacked splits through the normal
    hiring flow; reducer replacement triggers RESHUFFLE of buffered mapper
    outputs; stragglers get speculative backup splits; reducers dedupe by
    (split, mapper-slot).
    """

    def __init__(self, name: str, keys: KeyHierarchy, *, policy: SecurityPolicy | None = None,
                 hb_interval: float = 0.05, straggler_factor: float = 6.0):
        self.name = name
        self.keys = keys
        self.session = keys.session
        self.policy = policy or SecurityPolicy()
        self.alive = True
        self.hb_interval = hb_interval
        self.straggler_factor = straggler_factor
        self._jobs: dict[str, dict] = {}
        self._last_hb: dict[str, float] = {}
        self.completed: dict[str, dict] = {}

    # -- submission ------------------------------------------------------------

    def submit(self, job: MapReduceJob):
        jid = job.job_id
        hdr = self.session.header
        for sub in (
            pr.sub_job_details(self.name, jid),
            pr.sub_results(self.name, jid),
            pr.sub_heartbeats(self.name),
            Subscription(constraints=(("type", "==", MAP_ACK), ("job", "==", jid)),
                         subscriber=self.name),
        ):
            self.cluster.router.subscribe(sub.seal(hdr))
        self._jobs[jid] = {
            "job": job,
            "mappers": [None] * job.n_mappers,
            "reducers": [None] * job.n_reducers,
            "standby": [],
            "hired": set(),
            "splits": {},           # split_id -> {"rows", "mapper_slot", "acked", "sent_at"}
            "provisioned": False,
            "results": {},
            "t_submit": self.cluster.now,
            "ack_times": [],
        }
        self.cluster.publish(
            self._seal({"type": pr.JOB_OPENING, "job": jid}, {"job": jid}, "header")
        )
        self.cluster.schedule(self.hb_interval * 3, self._liveness_check, jid)

    # -- message handling ----------------------------------------------------------

    def on_message(self, msg: Message):
        header = msg.open_header(self.session.header)
        t = header["type"]
        if t == pr.JOB_DETAILS:
            self._consider_hire(header, msg)
        elif t == MAP_ACK:
            self._on_ack(header)
        elif t == pr.RESULT:
            self._on_result(header, msg)
        elif t == pr.HEARTBEAT:
            self._last_hb[header["worker"]] = self.cluster.now

    def _consider_hire(self, header: dict, msg: Message):
        st = self._jobs.get(header["job"])
        if st is None:
            return
        d = self._open(msg, "header")
        w = d["worker"]
        if w in st["hired"]:
            return
        # simulated SGX attestation gate (paper's key-provisioning step)
        if not self.keys.attestation.verify(d["measurement"]):
            return
        slot_kind = None
        if not st["provisioned"]:
            if None in st["mappers"] and d["role_pref"] in ("any", "mapper"):
                slot_kind = "mapper"
            elif None in st["reducers"] and d["role_pref"] in ("any", "reducer"):
                slot_kind = "reducer"
        if slot_kind is None:
            if all(s["worker"] != w for s in st["standby"]):
                st["standby"].append(d)
            return
        self._hire(header["job"], d, slot_kind)
        if None not in st["mappers"] and None not in st["reducers"] and not st["provisioned"]:
            self._provision(header["job"])

    def _hire(self, jid: str, details: dict, role: str, slot: int | None = None):
        st = self._jobs[jid]
        w = details["worker"]
        roster = st["mappers"] if role == "mapper" else st["reducers"]
        if slot is None:
            slot = roster.index(None)
        roster[slot] = w
        st["hired"].add(w)
        # register the worker's subscriptions on its behalf (paper Fig. 3)
        for blob_hex in details["subs"][role] + details["subs"]["common"]:
            self.cluster.router.subscribe(bytes.fromhex(blob_hex))
        self._last_hb[w] = self.cluster.now
        return slot

    def _provision(self, jid: str):
        st = self._jobs[jid]
        job: MapReduceJob = st["job"]
        st["provisioned"] = True
        for slot, w in enumerate(st["mappers"]):
            self._send_code(jid, w, "mapper", slot)
        for slot, w in enumerate(st["reducers"]):
            self._send_code(jid, w, "reducer", slot)
        # paper: "data is split by the client among the mappers, line by line"
        st["slot_unacked"] = {s: 0 for s in range(job.n_mappers)}
        for i, row in enumerate(job.data):
            slot = i % job.n_mappers
            st["splits"][i] = {"rows": [row], "mapper_slot": slot, "acked": False,
                               "sent_at": self.cluster.now, "backup": False}
            st["slot_unacked"][slot] += 1
            self._send_split(jid, i)
        for slot, w in enumerate(st["mappers"]):
            self.cluster.publish(
                self._seal({"type": pr.MAP_DATATYPE, "job": jid, "dest": w, "eos": 1},
                           None, "data")
            )

    def _send_code(self, jid: str, worker: str, role: str, slot: int):
        st = self._jobs[jid]
        job: MapReduceJob = st["job"]
        code = {
            "slot": slot,
            "source": job.map_source if role == "mapper" else job.reduce_source,
            "consts": job.consts,
            "n_mappers": job.n_mappers,
            "n_reducers": job.n_reducers,
            "mappers": list(st["mappers"]),
            "reducers": list(st["reducers"]),
        }
        t = pr.MAP_CODETYPE if role == "mapper" else pr.REDUCE_CODETYPE
        self.cluster.publish(self._seal({"type": t, "job": jid, "dest": worker}, code, "code"))

    def _send_split(self, jid: str, split_id: int, to_slot: int | None = None):
        st = self._jobs[jid]
        sp = st["splits"][split_id]
        slot = to_slot if to_slot is not None else sp["mapper_slot"]
        dest = st["mappers"][slot]
        sp["sent_at"] = self.cluster.now
        self.cluster.publish(
            self._seal(
                {"type": pr.MAP_DATATYPE, "job": jid, "dest": dest, "split": split_id},
                sp["rows"],
                "data",
            )
        )

    def _on_ack(self, header: dict):
        jid = header["job"]
        st = self._jobs.get(jid)
        if st is None:
            return
        sp = st["splits"].get(header["split"])
        if sp and not sp["acked"]:
            sp["acked"] = True
            st["ack_times"].append(self.cluster.now - sp["sent_at"])
            # slot-coverage EOS: once every split of a mapper slot is acked
            # (possibly by backups), the client itself certifies end-of-stream
            # for that slot so reducers don't wait out a straggler.
            # (O(1) per-slot counter — a full scan here is O(splits^2))
            slot = sp["mapper_slot"]
            st["slot_unacked"][slot] -= 1
            if st["slot_unacked"][slot] == 0:
                self.cluster.publish(
                    self._seal({"type": pr.MAP_EOS, "job": jid, "slot": slot},
                               None, "header")
                )

    def _on_result(self, header: dict, msg: Message):
        st = self._jobs.get(header["job"])
        if st is None:
            return
        st["results"][header["slot"]] = self._open(msg, "data")
        if len(st["results"]) == st["job"].n_reducers:
            pairs = []
            for slot in sorted(st["results"]):
                pairs.extend([tuple(p) for p in st["results"][slot]])
            self.completed[header["job"]] = {
                "pairs": pairs,
                "t_complete": self.cluster.now,
                "elapsed": self.cluster.now - st["t_submit"],
            }

    # -- fault tolerance ------------------------------------------------------------

    def _liveness_check(self, jid: str):
        st = self._jobs.get(jid)
        if st is None or jid in self.completed:
            return
        timeout = 3 * self.hb_interval
        for role, roster in (("mapper", st["mappers"]), ("reducer", st["reducers"])):
            for slot, w in enumerate(roster):
                if w is None:
                    continue
                if self.cluster.now - self._last_hb.get(w, 0.0) > timeout:
                    self._replace(jid, role, slot, w)
        self._check_stragglers(jid)
        self.cluster.schedule(self.hb_interval * 2, self._liveness_check, jid)

    def _replace(self, jid: str, role: str, slot: int, dead: str):
        st = self._jobs[jid]
        roster = st["mappers"] if role == "mapper" else st["reducers"]
        roster[slot] = None
        st["hired"].discard(dead)
        if st["standby"]:
            details = st["standby"].pop(0)
            self._hire(jid, details, role, slot)
            self._recover(jid, role, slot)
        else:
            # no standby: re-open hiring (paper's Fig. 3 flow, again)
            st.setdefault("pending_recovery", []).append((role, slot))
            self.cluster.publish(
                self._seal({"type": pr.JOB_OPENING, "job": jid}, {"job": jid}, "header")
            )
            self.cluster.schedule(self.hb_interval, self._try_pending, jid)

    def _try_pending(self, jid: str):
        st = self._jobs.get(jid)
        if st is None or not st.get("pending_recovery"):
            return
        while st["pending_recovery"] and st["standby"]:
            role, slot = st["pending_recovery"].pop(0)
            details = st["standby"].pop(0)
            self._hire(jid, details, role, slot)
            self._recover(jid, role, slot)
        if st["pending_recovery"]:
            self.cluster.schedule(self.hb_interval, self._try_pending, jid)

    def _recover(self, jid: str, role: str, slot: int):
        st = self._jobs[jid]
        w = (st["mappers"] if role == "mapper" else st["reducers"])[slot]
        self._send_code(jid, w, role, slot)
        if role == "mapper":
            for sid, sp in st["splits"].items():
                if sp["mapper_slot"] == slot and not sp["acked"]:
                    self._send_split(jid, sid)
            self.cluster.publish(
                self._seal({"type": pr.MAP_DATATYPE, "job": jid, "dest": w, "eos": 1},
                           None, "data")
            )
        else:
            # tell mappers to re-route buffered output for this reducer slot
            self.cluster.publish(
                self._seal({"type": RESHUFFLE, "job": jid, "slot": slot, "new_worker": w},
                           None, "header")
            )

    def _check_stragglers(self, jid: str):
        st = self._jobs[jid]
        if not st["provisioned"] or not st["ack_times"]:
            return
        acks = sorted(st["ack_times"])
        median = acks[len(acks) // 2]
        limit = max(self.straggler_factor * median, 4 * self.hb_interval)
        live_slots = [s for s, w in enumerate(st["mappers"]) if w is not None]
        for sid, sp in st["splits"].items():
            if sp["acked"] or sp["backup"]:
                continue
            if self.cluster.now - sp["sent_at"] > limit:
                # speculative backup task on another live mapper
                others = [s for s in live_slots if s != sp["mapper_slot"]]
                if others:
                    sp["backup"] = True
                    self._send_split(jid, sid, to_slot=others[sid % len(others)])
