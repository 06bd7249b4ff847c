"""Count what one run of a function does: device operations, collectives and
kernel calls.

Counterpart of `repro/tools/jaxprs.py`. The JAX package proves structural
claims about a round (one `all_to_all` and two keystream launches per
coalesced secure round; one `all_gather` fewer in the sharded layout) by
walking the traced jaxpr. The port has no jaxpr: it runs the function once
and counts what it did.

  * Device operations: a `TorchDispatchMode` counts every ATen operation
    dispatched inside, by its overload name (`aten.add.Tensor`), on
    whatever device the tensors live. `torch.profiler` is not used for any
    count here: on the card it has been seen to lose records.
  * Collectives: `repro_torch.mesh.collective_calls`, which
    `VirtualMesh.all_to_all`, `psum` and `all_gather` report to, counted
    over the reference's `COLLECTIVE_PRIMITIVES` names (the ones the
    virtual mesh has no counterpart of count 0).
  * Kernel calls: `repro_torch.kernels.kernel_calls`, which the two kernels'
    dispatch points report to (`kernels/chacha20/ops.py::chacha20_xor_packed`
    and `kernels/kmeans/ops.py::kmeans_assign`), whether the call goes to
    the CUDA kernel or to the plain version, so the counts hold on the CPU.

Every count is per run: a function that loops counts each iteration, where
a jaxpr counts a scan body once.
"""

from __future__ import annotations

import threading
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field

from torch.utils._python_dispatch import TorchDispatchMode

# Cross-shard communication primitives, by the reference's jaxpr names
# (`repro/tools/jaxprs.py::COLLECTIVE_PRIMITIVES`).
COLLECTIVE_PRIMITIVES = (
    "all_to_all", "all_gather", "psum", "all_reduce", "reduce_scatter",
    "ppermute", "pbroadcast",
)


class CallCounter:
    """Re-entrant counts of named calls, in the style of the shuffle's
    `wire_accounting`: open `recording()` contexts form a list of independent
    sinks, each removed by identity when its context exits, so contexts may
    nest or exit out of order. `note(name)` adds one to every open sink; with
    none open it costs a truth test."""

    def __init__(self):
        self._sinks: list[Counter] = []
        self._lock = threading.Lock()

    def note(self, name: str) -> None:
        if self._sinks:
            with self._lock:
                for sink in self._sinks:
                    sink[name] += 1

    @contextmanager
    def recording(self):
        """Yield a `Counter` of the calls noted inside."""
        sink: Counter = Counter()
        with self._lock:
            self._sinks.append(sink)
        try:
            yield sink
        finally:
            with self._lock:
                self._sinks = [s for s in self._sinks if s is not sink]


class _CountOps(TorchDispatchMode):
    def __init__(self, sink: Counter):
        super().__init__()
        self.sink = sink

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.sink[str(func)] += 1
        return func(*args, **(kwargs or {}))


@dataclass
class Counts:
    """What ran inside one `counting()` block."""

    ops: Counter = field(default_factory=Counter)  # ATen overload name -> calls
    collectives: Counter = field(default_factory=Counter)  # mesh collective -> calls
    kernels: Counter = field(default_factory=Counter)  # kernel dispatch point -> calls


@contextmanager
def counting():
    """Count the device operations (this thread's), collectives and kernel
    calls (every thread's) made inside."""
    from repro_torch.kernels import kernel_calls
    from repro_torch.mesh import collective_calls

    with collective_calls.recording() as coll, kernel_calls.recording() as kern:
        out = Counts(collectives=coll, kernels=kern)
        with _CountOps(out.ops):
            yield out


def count_ops(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` once; {ATen overload name: calls}."""
    with counting() as c:
        fn(*args, **kwargs)
    return dict(c.ops)


def count_primitives(counts: dict, name: str) -> int:
    """Calls of `name` in a `count_ops` dict: an overload (`aten.add.Tensor`)
    or every overload of an operator (`aten.add`; `aten.add_` is another)."""
    return sum(n for op, n in counts.items() if op == name or op.startswith(name + "."))


def total_ops(counts: dict) -> int:
    """All device operations of a `count_ops` dict: the port's counterpart of
    `total_eqns`, the size the cost model scales capture time by."""
    return sum(counts.values())


def collective_counts(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` once; {collective: calls} over every name of
    `COLLECTIVE_PRIMITIVES` (0 for a name the virtual mesh has no form of)."""
    with counting() as c:
        fn(*args, **kwargs)
    return {name: c.collectives.get(name, 0) for name in COLLECTIVE_PRIMITIVES}


def kernel_call_counts(fn, *args, **kwargs) -> dict:
    """Run `fn(*args, **kwargs)` once; {kernel dispatch point: calls}."""
    with counting() as c:
        fn(*args, **kwargs)
    return dict(c.kernels)
