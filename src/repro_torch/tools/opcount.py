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

The program's own instruments live here too. Every instrument, these
counters included, keeps its sinks in one `_Sinks` (opened by `recording()`
for every thread or `isolated()` for the calling thread, removed by
identity, guarded by a lock; with no sink open a call costs a truth test
and touches no tensor):

  * `spans`: host-clock spans of the program's layers (`SpanRecorder`),
    named `<layer>.<step>` (`service.chunk`, `driver.replay`,
    `engine.attention`, `moe.route`, `shuffle.exchange`, ...).
  * `counters`: named quantities the program computes anyway, such as the
    MoE's dropped expert entries (`moe.dropped_entries`), added with
    `CallCounter.add`, device tensors summed on their device.
  * `wire_accounting`: one record per executed shuffle call
    (`record_wire_bytes`), re-exported by `repro_torch.core.shuffle`.

`replayable()` keeps what a captured round reports, to report it again at
each replay. Tracing is on exactly while a sink is open: there is no other
switch.
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


class _Sinks(list):
    """The open sinks of one instrument, and each thread's stack of tags.

    `recording(sink)` opens a sink that every thread writes to;
    `isolated(sink)` one that only the calling thread writes to, which the
    other sinks do not see, and sets the thread's tags aside while it is
    open. Either is removed by identity, so contexts may nest or exit in any
    order. `write(fn, ...)` calls `fn(sink, ...)` under the lock on the
    calling thread's innermost isolated sink if it has one, else on every
    shared sink. `tagged(tag)` pushes onto the thread's `stack()`. The
    object is the list of open (owner thread's ident, or None for every
    thread; sink) entries, changed only under the lock: with none open, an
    instrument's call costs a list's truth test."""

    __slots__ = ("_lock", "_local")

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._local = threading.local()

    @contextmanager
    def _open(self, owner, sink):
        entry = (owner, sink)
        with self._lock:
            self.append(entry)
        try:
            yield sink
        finally:
            with self._lock:
                self[:] = [e for e in self if e is not entry]

    def recording(self, sink):
        return self._open(None, sink)

    @contextmanager
    def isolated(self, sink):
        saved = self.stack()
        self._local.stack = []
        try:
            with self._open(threading.get_ident(), sink):
                yield sink
        finally:
            self._local.stack = saved

    def write(self, fn, *args) -> None:
        me = threading.get_ident()
        with self._lock:
            own = [sink for owner, sink in self if owner == me]
            for sink in own[-1:] or [sink for owner, sink in self if owner is None]:
                fn(sink, *args)

    def stack(self) -> list:
        """The calling thread's stack of tags (a span recorder's open spans)."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextmanager
    def tagged(self, tag):
        stack = self.stack()
        stack.append(tag)
        try:
            yield
        finally:
            _remove(stack, tag)


def _remove(stack: list, item) -> None:
    """Take the innermost `item` off `stack`: by identity, so a context left
    out of order (a generator's) takes its own entry."""
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] is item:
            del stack[i]
            return


def _bump(sink: Counter, name: str, value) -> None:
    sink[name] = sink[name] + value


class CallCounter:
    """Re-entrant counts of named calls. `note(name)` adds one to the sinks
    open to the calling thread and `add(name, value)` adds `value`: a number,
    or a tensor, which stays on its device (one addition there a sink) and
    is read once, when the sink's context exits. With no sink open either
    costs a truth test.

    `recording()` opens a sink every thread counts into; `isolated()` gives
    the calling thread a sink of its own that takes every count the thread
    makes inside it, the open sinks none (`_Sinks`)."""

    def __init__(self):
        self._sinks = _Sinks()

    def note(self, name: str) -> None:
        if self._sinks:
            self._sinks.write(_bump, name, 1)

    def add(self, name: str, value) -> None:
        if self._sinks:
            self._sinks.write(_bump, name, value)

    @contextmanager
    def _open(self, opener):
        sink: Counter = Counter()
        try:
            with opener(sink):
                yield sink
        finally:
            for name, value in sink.items():
                if isinstance(value, torch.Tensor):
                    sink[name] = value.item()

    def recording(self):
        """Yield a `Counter` of the calls noted inside (tensor values become
        numbers when the context exits)."""
        return self._open(self._sinks.recording)

    def isolated(self):
        """Yield a `Counter` of this thread's calls inside, which the open
        sinks do not see."""
        return self._open(self._sinks.isolated)


class SpanRecorder:
    """Host-clock spans of the program's layers, kept by open `recording()`
    sinks (lists); the open spans and tags are each thread's `_Sinks.stack()`.

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
        self._sinks = _Sinks()

    def span(self, name: str, **attrs):
        if not self._sinks:
            return _NO_SPAN
        return _OpenSpan(self, name, attrs)

    def tagged(self, **attrs):
        if not self._sinks:
            return _NO_SPAN
        return _OpenSpan(self, None, attrs)

    def recording(self):
        """Yield the list of spans that end inside."""
        return self._sinks.recording([])


_NO_SPAN = nullcontext()
_NO_ATTRS = {"job": None}


class _OpenSpan:
    """One span (or, with no name, a tag) open on its thread's stack."""

    __slots__ = ("rec", "name", "attrs", "parent", "t0", "stack")

    def __init__(self, rec: SpanRecorder, name, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        stack = self.stack = self.rec._sinks.stack()
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
        _remove(self.stack, self)
        if self.name is not None:
            self.rec._sinks.write(list.append, (self.name, self.t0, t1,
                                                {**self.attrs, "parent": self.parent,
                                                 "thread": threading.current_thread().name}))
        return False


def _extend(sink: list, records, job) -> None:
    sink.extend(dict(rec, per_leaf=list(rec["per_leaf"]), job=job) for rec in records)


class _WireAccounting:
    """The shuffle's byte counter behind `record_wire_bytes`: one record per
    executed shuffle call, to the sinks open to the calling thread (`_Sinks`).

    `tagged(job_id)` gives each record the calling thread's innermost job
    id, so a sink shared by interleaved jobs splits by job. `isolated()`
    yields a sink of the calling thread's records alone, which the open
    sinks do not see. A round replayed from a CUDA graph re-emits the record
    its capture made (`emit`, through `replayable`).
    """

    def __init__(self):
        self._sinks = _Sinks()

    @property
    def enabled(self) -> bool:
        return bool(self._sinks)

    def note(self, *, secure: bool, nbytes: int, n_leaves: int, halted: bool = False,
             coalesced: bool = False, pad_bytes: int = 0, per_leaf=None,
             collectives: int = 0, keystream_launches: int = 0,
             keystream_blocks: int = 0, copies: int = 0) -> None:
        """Append one record per shuffle call to the open sinks.

        Fields are those of `repro.core.shuffle._WireAccounting.note`, per
        shard: bytes (payload), wire_bytes (= bytes + pad_bytes), per_leaf
        payload bytes, collectives (all_to_all exchanges), keystream_launches
        and keystream_blocks (encrypt + decrypt), job (the innermost
        `tagged` id, or None); and the port's own copies: the full passes
        over the wire besides the crypts (the pack's concatenation, and each
        exchange that returned new storage).
        """
        if not self._sinks:
            return
        self.emit([{"secure": secure, "bytes": nbytes, "leaves": n_leaves,
                    "halted": halted, "coalesced": coalesced,
                    "wire_bytes": nbytes + pad_bytes, "pad_bytes": pad_bytes,
                    "per_leaf": list(per_leaf or []), "collectives": collectives,
                    "keystream_launches": keystream_launches,
                    "keystream_blocks": keystream_blocks, "copies": copies}])

    def emit(self, records) -> None:
        """Append copies of `records` to the open sinks, under the current tag."""
        if self._sinks:
            tags = self._sinks.stack()
            self._sinks.write(_extend, records, tags[-1] if tags else None)

    def tagged(self, job_id):
        """Attribute records made inside, on this thread, to `job_id`; None
        changes nothing."""
        return _NO_SPAN if job_id is None else self._sinks.tagged(job_id)

    def isolated(self):
        """Record only this thread's records inside, into a fresh sink it
        yields; the open sinks and this thread's tags are set aside until it
        exits."""
        return self._sinks.isolated([])


wire_accounting = _WireAccounting()


def record_wire_bytes():
    """Context manager yielding the list of records, one per executed shuffle
    call inside the block.

    The port runs rounds eagerly or replays them from a CUDA graph, and
    either way every executed round's shuffle appends its own record (the
    JAX package records once per traced program).
    """
    return wire_accounting._sinks.recording([])


@dataclass
class RoundReport:
    """What one round reported on its thread (`replayable`): its wire records
    and kernel calls."""

    records: list = field(default_factory=list)
    kernels: Counter = field(default_factory=Counter)

    def emit(self, n: int) -> None:
        """Report them again as `n` replays of the round."""
        from repro_torch.kernels import kernel_calls

        wire_accounting.emit(self.records * n)
        for name, calls in self.kernels.items():
            kernel_calls.add(name, calls * n)


@contextmanager
def replayable():
    """Yield a `RoundReport` of what the calling thread reports inside, which
    the open sinks do not see: a round captured into a CUDA graph keeps it
    this way, to `emit` at each replay (`core/driver.py::_GraphRunner`).
    Collectives and spans are not kept."""
    from repro_torch.kernels import kernel_calls

    with wire_accounting.isolated() as records, kernel_calls.isolated() as kernels:
        yield RoundReport(records, kernels)


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
