"""Simulated multi-node cluster runtime for the paper's protocol.

Counterpart of `repro/runtime`.

Deterministic virtual-time event simulation of: client (data owner), SCBR
router, worker nodes (mapper/reducer roles). Implements the session
establishment + provisioning protocol (paper Figs. 3-4), the paper's
line-by-line split distribution, mapper-side shuffle, EOS counting — plus the
fault-tolerance features a production deployment needs (the paper defers
these to future work): heartbeat failure detection, re-hiring through the
same JOB_OPENING flow, split re-execution, reducer reshuffle, speculative
backup tasks for stragglers, and result deduplication by split id.
"""

from repro_torch.runtime.node import Client, MapReduceJob, Worker
from repro_torch.runtime.sim import Cluster, TimingModel

__all__ = ["Client", "Worker", "MapReduceJob", "Cluster", "TimingModel"]
