"""Secure MapReduce on the virtual mesh: shuffle, engine (`run_mapreduce`,
`run_mapreduce_until`), iterative driver with replicated and sharded carried
state, and the workloads: k-means, sampling sort, streaming grep, word count.

Plus the two SGX-specific mechanisms, adapted: `secvm.py` (user logic as
encrypted bytecode run by a generic interpreter on the card) and
`paging.py` (`SecurePager`, the EPC paging analogue). The cluster level is
`repro_torch.runtime`.

Exports what `repro.core` exports, but for `DEFAULT_HALT_LOOP` and
`HALT_LOOP_IMPLS`: the port's chunk is one host loop, with no loop shape to
choose.
"""

from repro_torch.core.driver import (
    IterativeSpec,
    RunUntilResult,
    make_iterative_runner,
    run_iterative_mapreduce,
    run_until,
)
from repro_torch.core.engine import MapReduceSpec, run_mapreduce, run_mapreduce_until
from repro_torch.core.shuffle import SecureShuffleConfig

__all__ = [
    "IterativeSpec",
    "MapReduceSpec",
    "RunUntilResult",
    "SecureShuffleConfig",
    "make_iterative_runner",
    "run_iterative_mapreduce",
    "run_mapreduce",
    "run_mapreduce_until",
    "run_until",
]
