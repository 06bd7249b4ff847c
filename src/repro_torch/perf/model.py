"""Calibrated cost model: predict round time, capture time and wire bytes,
and answer the `auto` resolvers' knob questions.

Counterpart of `repro/perf/model.py`. A round's facts come from ONE run of
it: `trace_workload` runs one eager round of a runner's spec on its mesh
inside `record_wire_bytes()` and `tools/opcount.counting()`, so the wire
bytes, exchanges, keystream launches and ChaCha blocks are the round's own
records, and the device operations its own count (the reference reads them
off a jaxpr without running).
Predictions multiply those counts by the constants of a `Calibration`:

    round_us   = launches·launch_us + eff_blocks·us_per_block      (crypto)
               + collectives·a2a.base_us + wire_bytes·a2a.us_per_byte
               + round.base_us + n_local·item_us                   (compute)
    compile_s  = device ops scaled by the probe round most like this one
                 (the chacha probe's capture for a secure round, the round
                 probe's for a plaintext one), floored by the capture line
    wire_bytes = straight off the round's record (exact)

`item_us` is the trace's own per-workload slope when it carries one
(`RoundTrace.item_us`, from `calibrate.probe_workload_items`), else the
round probe's generic `round.us_per_item`, which makes the model the
reference's bit for bit.

Knob recommendations (`recommendation(knob)`) are what the `auto` resolvers
of `core/shuffle.py`, `core/driver.py` and `serve/service.py` consult; the
ACTIVE model comes from `$REPRO_CALIBRATION` (a JSON written by
`perf/calibrate.py`) or an explicit `set_active_model`. No active model:
every recommendation is None and the resolvers keep their historical
defaults bit for bit.

Not ported: `recommend_halt_loop` and `timing_model`'s `loop_impl` (the port
has one loop shape; it has no `masked_scan`), and `$REPRO_CHACHA_IMPL` (on
the card the kernel is the only route). `recommend_chacha_impl` answers a
selector of `repro_torch.kernels.IMPLS` that the calibrated device accepts.

A trace without its own item term prices workload map/reduce math with one
generic slope (the round probe's), so a map_fn doing heavy per-item math
(k-means' distances) is under-predicted: give such a workload its probe.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import ClassVar

from repro_torch.perf.calibrate import (
    CALIBRATION_ENV,
    Calibration,
    effective_blocks,
    load_calibration,
)

_UNSET = object()


@dataclass(frozen=True)
class RoundTrace:
    """Per-round facts read off ONE run of a runner's round."""

    n_eqns: int  # device operations of the round
    wire_bytes: int
    collectives: int
    keystream_launches: int
    keystream_blocks: int  # unpadded, summed over launches
    n_shards: int
    n_local_items: int
    secure: bool
    coalesced: bool
    # The workload's own us per mapped item (`calibrate.probe_workload_items`),
    # or None for the calibration's generic slope. Not a dataclass field: a
    # trace's fields stay the reference's, one for one; `with_item_us` sets it.
    item_us: ClassVar[float | None] = None

    def with_item_us(self, item_us: float | None) -> "RoundTrace":
        """This trace priced with its own item term (None: the generic one)."""
        out = replace(self)
        object.__setattr__(out, "item_us", None if item_us is None else float(item_us))
        return out

    @property
    def blocks_per_launch_row(self) -> int:
        """Unpadded ChaCha blocks per wire row of one launch."""
        if not self.keystream_launches:
            return 0
        return max(1, self.keystream_blocks
                   // (self.keystream_launches * self.n_shards))


def trace_workload(runner, inputs, state, *, n_shards: int,
                   n_local_items: int, round_offset=0, items: dict | None = None) -> RoundTrace:
    """Run one eager round of `runner`'s job and distill it into a `RoundTrace`.

    `runner` is what `make_iterative_runner` built (its spec, mesh, secure
    config and wire layout are used; its captures and static buffers are
    not touched). The round runs at `round_offset` on `inputs` and `state`,
    which it does not change, and its result is dropped; `halted` records
    are dropped too. `items`, the workload's `probe_workload_items` result,
    gives the trace its own item term; without it the trace has none.
    """
    from repro_torch.core.driver import _EagerRunner
    from repro_torch.core.shuffle import record_wire_bytes
    from repro_torch.tools.opcount import counting, total_ops

    one = _EagerRunner(runner.spec, runner.mesh, runner.secure, 1, runner.coalesce)
    with record_wire_bytes() as recs, counting() as c:
        one(inputs, state, int(round_offset))
    live = [r for r in recs if not r["halted"]]
    if not live:
        raise ValueError("the round ran no shuffle: nothing to model")
    rec = live[0]
    return RoundTrace(
        n_eqns=total_ops(c.ops),
        wire_bytes=int(rec["wire_bytes"]),
        collectives=int(rec["collectives"]),
        keystream_launches=int(rec["keystream_launches"]),
        keystream_blocks=int(rec["keystream_blocks"]),
        n_shards=max(1, int(n_shards)),
        n_local_items=int(n_local_items),
        secure=bool(rec["secure"]),
        coalesced=bool(rec["coalesced"]),
    ).with_item_us(None if items is None else items["us_per_item"])


def _port_impls(backend: str) -> tuple:
    """The keystream selectors the calibrated device accepts."""
    from repro_torch.kernels import IMPLS

    return ("auto",) if backend == "torch-cuda" else IMPLS


class CostModel:
    """Predictions + knob recommendations over one `Calibration`."""

    def __init__(self, cal: Calibration):
        self.cal = cal
        self._memo: dict = {}

    # -- predictions -------------------------------------------------------

    def _chacha(self, impl: str | None) -> tuple[str, dict]:
        chacha = self.cal.chacha
        if impl is None or impl == "auto":
            impl = self.recommend_chacha_impl()
        entry = chacha.get(impl)
        if entry is None:
            entry = next(iter(chacha.values()))
        return impl, entry

    def predict_round_us(self, trace: RoundTrace, impl: str | None = None) -> float:
        """Steady-state microseconds for ONE executed round."""
        cal = self.cal
        item_us = cal.round["us_per_item"] if trace.item_us is None else trace.item_us
        us = (cal.round["base_us"]
              + trace.n_local_items * item_us
              + trace.collectives * cal.all_to_all["base_us"]
              + trace.wire_bytes * cal.all_to_all["us_per_byte"])
        if trace.keystream_launches:
            _, entry = self._chacha(impl)
            eff = trace.keystream_launches * effective_blocks(
                trace.n_shards, trace.blocks_per_launch_row)
            us += (trace.keystream_launches * entry["launch_us"]
                   + eff * entry["us_per_block"])
        return us

    def predict_compile_s(self, trace: RoundTrace, impl: str | None = None) -> float:
        """Seconds a cold runner of the traced round pays before its first
        replay (warm-up round and capture).

        Device-operation scaling anchored on the probe round nearest in
        kind: keystream-bearing rounds scale off the chacha probe, plain
        ones off the round probe. The capture line is the floor.
        """
        cal = self.cal
        floor = cal.compile["base_s"] + trace.n_eqns * cal.compile["s_per_eqn"]
        if trace.keystream_launches:
            _, entry = self._chacha(impl)
            anchor_s, anchor_eqns = entry["compile_s"], entry["compile_eqns"]
        else:
            anchor_s, anchor_eqns = cal.round["compile_s"], cal.round["compile_eqns"]
        return max(floor, anchor_s * trace.n_eqns / max(1, anchor_eqns))

    def predict_wire_bytes(self, trace: RoundTrace) -> int:
        """Wire bytes per round, per shard: exact, straight off the round."""
        return trace.wire_bytes

    def timing_model(self, *, impl: str | None = None, coalesce: bool = True):
        """A `runtime/sim.py::TimingModel` with calibrated constants.

        AdmissionSim's virtual time and the model's predictions read the
        same probes. Crypto bandwidth comes from the chosen impl's us/block
        (64 bytes each); the cold cost (`xla_compile_s`, the port's capture)
        is the secure probe's plus the round machinery's. `coalesce=False`
        pays one exchange latency per state leaf instead of one in total
        (the nominal tree width `recommend_coalesce` prices); this is how
        `launch/hillclimb.py` cell K prices a whole knob vector.
        """
        from repro_torch.runtime.sim import TimingModel

        cal = self.cal
        _, entry = self._chacha(impl)
        us_blk = max(entry["us_per_block"], 1e-9)
        nominal_leaves = 1 if coalesce else 2
        return TimingModel(
            net_latency_s=cal.all_to_all["base_us"] * 1e-6 * nominal_leaves,
            net_bw_bytes_s=1.0 / max(cal.all_to_all["us_per_byte"] * 1e-6, 1e-15),
            enclave_call_s=cal.round["base_us"] * 1e-6,
            crypto_bw_bytes_s=64.0 / (us_blk * 1e-6),
            item_cost_s=cal.round["us_per_item"] * 1e-6,
            xla_compile_s=entry["compile_s"] + cal.round["compile_s"],
            dispatch_s=cal.dispatch["base_us"] * 1e-6,
        )

    # -- knob recommendations ---------------------------------------------

    def recommend(self, knob: str, **ctx):
        key = (knob, tuple(sorted(ctx.items())))
        if key not in self._memo:
            self._memo[key] = getattr(self, f"recommend_{knob}")(**ctx)
        return self._memo[key]

    def recommend_chacha_impl(self) -> str:
        """The probed selector with the cheapest nominal launch (256 blocks),
        among those the calibrated device accepts; 'auto' when none was
        probed."""
        ok = [i for i in self.cal.chacha if i in _port_impls(self.cal.backend)]
        if not ok:
            return "auto"

        def score(entry):
            return entry["launch_us"] + 256 * entry["us_per_block"]

        return min(ok, key=lambda i: score(self.cal.chacha[i]))

    def recommend_coalesce(self) -> bool:
        """Coalesced iff ONE exchange + 2 launches beats per-leaf's L + 2L at
        a nominal tree width: with non-negative probed costs always True;
        the comparison stays, priced."""
        _, entry = self._chacha(None)
        nominal_leaves = 2
        coalesced = self.cal.all_to_all["base_us"] + 2 * entry["launch_us"]
        per_leaf = nominal_leaves * (self.cal.all_to_all["base_us"]
                                     + 2 * entry["launch_us"])
        return coalesced <= per_leaf

    def recommend_chunk_growth(self, min_chunk: int = 1, max_rounds: int = 64,
                               max_chunk: int | None = None) -> int:
        """Geometric chunk-ladder growth minimizing capture + dispatch cost.

        Each DISTINCT chunk size on the ladder captures one runner (the
        serving `RunnerCache` regime); each dispatch pays the probed host
        round trip.
        """
        max_chunk = max_rounds if max_chunk is None else max_chunk
        _, entry = self._chacha(None)
        compile_s = entry["compile_s"] + self.cal.round["compile_s"]
        dispatch_s = self.cal.dispatch["base_us"] * 1e-6

        def cost(growth: int) -> float:
            sizes, dispatches, done = set(), 0, 0
            chunk = max(1, min_chunk)
            while done < max_rounds:
                n = min(chunk, max_rounds - done)
                sizes.add(n)
                dispatches += 1
                done += n
                chunk = min(chunk * growth, max_chunk)
            return len(sizes) * compile_s + dispatches * dispatch_s

        return min((2, 3, 4), key=cost)

    def recommend_bucket_growth(self) -> float:
        """Bucket-ladder growth minimizing AdmissionSim makespan under the
        calibrated TimingModel, summed over the burst + straggler traces."""
        from repro_torch.runtime.sim import AdmissionSim, burst_trace, straggler_trace

        timing = self.timing_model()
        traces = [burst_trace(), straggler_trace()]

        def makespan(growth: float) -> float:
            sim = AdmissionSim(timing, bucket_growth=growth)
            return sum(sim.run(t, "bucketed")["makespan_s"] for t in traces)

        return min((1.5, 2.0, 4.0), key=makespan)

    def recommend_max_resident(self):
        """Runner-cache residency cap: evicting a live runner only adds
        captures (the sim charges nothing for residency), so 'unbounded',
        a string that tells "model says no cap" from "no model"."""
        return "unbounded"

    def recommend_capacity_factor(self) -> float:
        """Auto-capacity headroom factor (ceil(n/R) * factor): non-default
        only from a deployment-measured `extra["capacity_factor"]`, since an
        undershot capacity silently drops records and no probe can bound
        another workload's key skew."""
        return float(self.cal.extra.get("capacity_factor", 2.0))

    def recommend_sort_capacity(self, bucket: int, n_shards: int) -> int:
        """Per-(source, destination) sort capacity: the smallest LOSSLESS
        wire, bucket // n_shards (one splitter range may own a source's
        whole slice)."""
        return max(1, bucket // max(1, n_shards))


# -- active-model plumbing ---------------------------------------------------

_active: object = _UNSET  # explicit override: a CostModel, or None = forced off
_env_cache: tuple | None = None  # (path, mtime, CostModel | None)


def set_active_model(model: CostModel | None) -> None:
    """Explicitly set (or with None, force OFF) the active model; wins over
    $REPRO_CALIBRATION until `clear_active_model`."""
    global _active
    _active = model


def clear_active_model() -> None:
    """Drop any explicit override AND the env-file cache."""
    global _active, _env_cache
    _active = _UNSET
    _env_cache = None


def active_model() -> CostModel | None:
    """The model the `auto` resolvers consult, or None (= use defaults).

    Resolution order: the explicit `set_active_model` value, else the
    calibration JSON named by $REPRO_CALIBRATION (the entry of this
    process's key, `calibrate.load_calibration`; cached by file mtime), else
    None. An unreadable file or a missing entry gives None, never an error.
    """
    global _env_cache
    if _active is not _UNSET:
        return _active  # type: ignore[return-value]
    path = os.environ.get(CALIBRATION_ENV)
    if not path:
        return None
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError:
        return None
    if _env_cache and _env_cache[0] == path and _env_cache[1] == mtime:
        return _env_cache[2]
    try:
        cal = load_calibration(path)
        model = None if cal is None else CostModel(cal)
    except Exception:  # a bad calibration costs performance, never a crash
        model = None
    _env_cache = (path, mtime, model)
    return model


def recommendation(knob: str, **ctx):
    """`active_model().recommend(knob, **ctx)`, or None with no active model."""
    model = active_model()
    if model is None:
        return None
    return model.recommend(knob, **ctx)
