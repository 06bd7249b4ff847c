"""The paper's MapReduce session protocol over SCBR (Figs. 3-4).

Counterpart of `repro/pubsub/protocol.py`.

Session establishment:
  1. worker  --SUB(JOB_OPENING)-------------------> router
  2. client  --SUB(JOB_DETAILS)-------------------> router
  3. client  --PUB JOB_OPENING {job}--------------> available workers
  4. worker  --PUB JOB_DETAILS {role, subs for code+data}--> client
  5. client hires: registers the worker's code/data subscriptions on its
     behalf, fixing the mapper/reducer roster.

Provisioning:
  6. client  --PUB MAP_CODETYPE {n_reducers} + Lua/SecVM/callable code-->
     mappers;    REDUCE_CODETYPE {n_mappers} --> reducers
  7. client  --PUB MAP_DATATYPE {dest, split_id} + rows--> mapper `dest`
  8. mappers --PUB REDUCE_DATATYPE {dest=hash(k)%R, split_id}--> reducers
  9. mappers --PUB MAP_EOS {slot}--> all reducers (count to n_mappers)
 10. reducers --PUB RESULT--> client
"""

from __future__ import annotations

from repro_torch.pubsub.messages import Message, Subscription

JOB_OPENING = "JOB_OPENING"
JOB_DETAILS = "JOB_DETAILS"
MAP_CODETYPE = "MAP_CODETYPE"
REDUCE_CODETYPE = "REDUCE_CODETYPE"
MAP_DATATYPE = "MAP_DATATYPE"
REDUCE_DATATYPE = "REDUCE_DATATYPE"
MAP_EOS = "MAP_EOS"
RESULT = "RESULT"
HEARTBEAT = "HEARTBEAT"


def sub_job_openings(worker: str) -> Subscription:
    return Subscription(constraints=(("type", "==", JOB_OPENING),), subscriber=worker)


def sub_job_details(client: str, job_id: str) -> Subscription:
    return Subscription(
        constraints=(("type", "==", JOB_DETAILS), ("job", "==", job_id)), subscriber=client
    )


def sub_code(worker: str, job_id: str, role: str) -> Subscription:
    code_type = MAP_CODETYPE if role == "mapper" else REDUCE_CODETYPE
    return Subscription(
        constraints=(("type", "==", code_type), ("job", "==", job_id), ("dest", "==", worker)),
        subscriber=worker,
    )


def sub_data(worker: str, job_id: str, role: str) -> Subscription:
    data_type = MAP_DATATYPE if role == "mapper" else REDUCE_DATATYPE
    return Subscription(
        constraints=(("type", "==", data_type), ("job", "==", job_id), ("dest", "==", worker)),
        subscriber=worker,
    )


def sub_eos(worker: str, job_id: str) -> Subscription:
    return Subscription(
        constraints=(("type", "==", MAP_EOS), ("job", "==", job_id)), subscriber=worker
    )


def sub_results(client: str, job_id: str) -> Subscription:
    return Subscription(
        constraints=(("type", "==", RESULT), ("job", "==", job_id)), subscriber=client
    )


def sub_heartbeats(client: str) -> Subscription:
    return Subscription(constraints=(("type", "==", HEARTBEAT),), subscriber=client)
