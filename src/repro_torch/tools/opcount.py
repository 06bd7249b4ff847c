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
    A round replayed from a CUDA graph adds the calls its capture made once
    for each executed round; the capture itself counts none.

Every count is per run: a function that loops counts each iteration, where
a jaxpr counts a scan body once.

The program's own instruments live here too, on the same pattern (sinks
opened by `recording()`, removed by identity, guarded by a lock; with no
sink open a call costs a truth test and touches no tensor):

  * `spans`: host-clock spans of the program's layers (`SpanRecorder`),
    named `<layer>.<step>` (`service.chunk`, `driver.replay`,
    `engine.attention`, `moe.route`, `shuffle.exchange`, ...).
  * `counters`: named quantities the program computes anyway, such as the
    MoE's dropped expert entries (`moe.dropped_entries`), added with
    `CallCounter.add`, device tensors summed on their device.

Tracing is on exactly while a sink is open: there is no other switch.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import torch
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
    nest or exit out of order. `note(name)` adds one to every open sink and
    `add(name, value)` adds `value`: a number, or a tensor, which stays on
    its device (one addition there a sink) and is read once, when the sink's
    context exits. With no sink open either costs a truth test.

    `isolated()` gives the calling thread a sink of its own that takes
    every count the thread makes inside it, the open sinks none: a round
    captured into a CUDA graph keeps its kernel calls this way, to add them
    again at each replay (`core/driver.py::_GraphRunner`)."""

    def __init__(self):
        self._sinks: list[tuple] = []  # (owner thread's ident, or None for every thread; sink)
        self._lock = threading.Lock()

    def note(self, name: str) -> None:
        if self._sinks:
            self._add(name, 1)

    def add(self, name: str, value) -> None:
        if self._sinks:
            self._add(name, value)

    def _add(self, name: str, value) -> None:
        me = threading.get_ident()
        with self._lock:
            own = [sink for owner, sink in self._sinks if owner == me]
            for sink in own[-1:] or [sink for owner, sink in self._sinks if owner is None]:
                sink[name] = sink[name] + value

    @contextmanager
    def _open(self, owner):
        sink: Counter = Counter()
        entry = (owner, sink)
        with self._lock:
            self._sinks.append(entry)
        try:
            yield sink
        finally:
            with self._lock:
                self._sinks = [e for e in self._sinks if e is not entry]
            for name, value in sink.items():
                if isinstance(value, torch.Tensor):
                    sink[name] = value.item()

    def recording(self):
        """Yield a `Counter` of the calls noted inside (tensor values become
        numbers when the context exits)."""
        return self._open(None)

    def isolated(self):
        """Yield a `Counter` of this thread's calls inside, which the open
        sinks do not see."""
        return self._open(threading.get_ident())


class SpanRecorder:
    """Host-clock spans of the program's layers, kept by open `recording()`
    sinks (lists, independent, removed by identity, as `CallCounter`'s).

    `span(name, **attrs)` is a context manager; while a sink is open it
    appends `(name, t0, t1, attrs)` to every open sink when it exits, `t0`
    and `t1` from `time.perf_counter()` (the shape of the benchmark's
    `bench/common.Recorder.spans`). `attrs` holds the span's own attributes,
    those it inherits from the spans and tags open around it on its thread
    (the innermost wins), and always `parent` (the name of the innermost
    span open around it on its thread, or None), `thread` (the thread's
    name) and `job` (None unless set: the service sets its `job_id`, so
    every span of one job shares it). `tagged(**attrs)` records nothing:
    the spans opened inside inherit its attributes (the engine tags each
    layer with `layer`). With no sink open both return one shared no-op
    context: a truth test; no record is built, no clock read and no tensor
    touched."""

    def __init__(self):
        self._sinks: list[list] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def span(self, name: str, **attrs):
        if not self._sinks:
            return _NO_SPAN
        return _OpenSpan(self, name, attrs)

    def tagged(self, **attrs):
        if not self._sinks:
            return _NO_SPAN
        return _OpenSpan(self, None, attrs)

    @contextmanager
    def recording(self):
        """Yield the list of spans that end inside."""
        sink: list = []
        with self._lock:
            self._sinks.append(sink)
        try:
            yield sink
        finally:
            with self._lock:
                self._sinks = [s for s in self._sinks if s is not sink]

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _emit(self, record: tuple) -> None:
        with self._lock:
            for sink in self._sinks:
                sink.append(record)


_NO_SPAN = nullcontext()
_NO_ATTRS = {"job": None}


class _OpenSpan:
    """One span (or, with no name, a tag) open on its thread's stack."""

    __slots__ = ("rec", "name", "attrs", "parent", "t0")

    def __init__(self, rec: SpanRecorder, name, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        stack = self.rec._stack()
        outer = stack[-1] if stack else None
        if outer is None:
            self.parent, inherited = None, _NO_ATTRS
        else:
            self.parent = outer.name if outer.name is not None else outer.parent
            inherited = outer.attrs
        self.attrs = {**inherited, **self.attrs}
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        stack = self.rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # left out of order (a generator's span): remove by identity
            stack.remove(self)
        if self.name is not None:
            self.rec._emit((self.name, self.t0, t1,
                            {**self.attrs, "parent": self.parent,
                             "thread": threading.current_thread().name}))
        return False


spans = SpanRecorder()
counters = CallCounter()


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
