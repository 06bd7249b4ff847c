"""Micro-probe calibration of the port: the constants the cost model multiplies.

Counterpart of `repro/perf/calibrate.py`, with its schema and field names.
One calibration is a handful of fitted (slope, intercept) lines, probed once
per (backend, device count) and kept in JSON:

  chacha[impl]   us per ChaCha20 block + us per launch, fitted over wire
                 widths as the secure-minus-plaintext time of a REAL driver
                 round (the runner a `RunnerCache` holds), plus the secure
                 runner's capture seconds and the device operations of one of
                 its rounds (the capture-time predictor's scaling anchor);
  all_to_all     us per wire byte + us per exchange: `VirtualMesh.all_to_all`,
                 which on one card is a transpose;
  dispatch       us per host-to-device round trip (one small operation and a
                 synchronise);
  round          us per mapped item + us of fixed per-round machinery, fitted
                 over per-shard input sizes through a minimal PLAINTEXT
                 driver round (map, bucket_pack, exchange, reduce), plus its
                 runner's capture seconds and device operations;
  compile        seconds per device operation + base, from the capture of two
                 CUDA graphs of different lengths (the floor for rounds with
                 no keystream in them);
  items[kind]    optional, per workload: us per mapped item + us per round of
                 the workload's OWN plaintext round, fitted over small
                 per-shard sizes (`probe_workload_items`); the cost model
                 prices that workload's items with it in place of `round`'s
                 generic slope, which cannot price k-means' distances, sort's
                 reducer sorts or grep's pattern match.

What differs from the reference, and why:

  * Keys. An entry is keyed "torch-cuda/<cards>" or "torch-cpu/1" (the
    reference's "cpu/1" on the same machine would otherwise collide), so
    neither package ever reads the other's entry from a shared file.
    `n_shards` records the virtual mesh the probes ran on.
  * "Compile" is capture. The port compiles nothing: what a cold runner pays
    before its first replay is its eager warm-up round and the capture of its
    CUDA graph (`core/driver.py::_GraphRunner`). `compile_s` of the chacha and
    round probes is a cold first call of the probe's runner less a warm one;
    `compile_eqns` counts the device operations of one round
    (`repro_torch.tools.opcount`); `compile` is fitted over the capture
    seconds of graphs of 16 and 160 operations. On a CPU mesh every capture
    figure is 0: its runner is the eager chunk, which captures nothing.
  * Probe sizes. On the card a ChaCha launch at the reference's sizes takes a
    few microseconds, while host times spread by milliseconds between runs.
    So each timed call is a chunk of many rounds (32, or 64 without `quick`)
    with no synchronise inside, trials of all sizes are interleaved, and the
    least of the repeats is kept; and the anchors span the k-means wire (132
    blocks a row) to a 64 MiB wire (256 MiB without `quick`), the exchange
    4 MiB to 256 MiB, the round per-shard slices of 4,096 to 524,288 items.
    A CPU mesh probes at the reference's small sizes.
  * Kernel padding. The port's kernel pads nothing per row: `effective_blocks`
    is rows x blocks per row on both of its cores (see there).

Activation is EXPLICIT: `$REPRO_CALIBRATION=<path>` (or
`repro_torch.perf.model.set_active_model`). With it unset every `auto`
resolver keeps its historical default bit for bit.

CLI:  PYTHONPATH=src python -m repro_torch.perf.calibrate --out calibration.json
(on the card; it raises without one).
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import asdict, dataclass, field

import numpy as np
import torch

from repro_torch.mesh import VirtualMesh

CALIBRATION_ENV = "REPRO_CALIBRATION"
SCHEMA = 1
DEFAULT_SHARDS = 8  # the virtual mesh the card is probed on (chip_smoke's)


@dataclass(frozen=True)
class _Sizes:
    """Probe sizes for one device type; each pair is (full, quick)."""

    chacha: tuple  # anchors: ((per-shard items, f32 words per item), ...)
    a2a_bytes: tuple  # bytes of the whole exchanged buffer
    round_items: tuple  # per-shard mapped items
    rounds: tuple  # rounds per timed chunk
    reps: tuple  # interleaved repeats


# At 8 shards the capacity is 2 x items / 8 per destination, so the chacha
# anchors' wires are 64 rows of 132 blocks (the k-means wire), 2,048 blocks
# (8 MiB), 16,384 blocks (64 MiB) and 65,536 blocks (256 MiB).
_SIZES = {
    "cuda": _Sizes(chacha=(((256, 32), (8192, 15), (65536, 15), (65536, 63)),
                           ((256, 32), (8192, 15), (65536, 15))),
                   a2a_bytes=((4 << 20, 32 << 20, 256 << 20), (4 << 20, 256 << 20)),
                   round_items=((4096, 65536, 524288),) * 2, rounds=(64, 32), reps=(9, 5)),
    "cpu": _Sizes(chacha=(((2, 1), (32, 1), (32, 8), (32, 32)), ((2, 1), (32, 1), (32, 16))),
                  a2a_bytes=((4 << 10, 64 << 10),) * 2, round_items=((32, 128, 512),) * 2,
                  rounds=(4, 4), reps=(7, 3)),
}


@dataclass(frozen=True)
class Calibration:
    """Fitted probe constants for one (backend, device count) pair.

    All times are microseconds unless the field name says seconds. `extra`
    carries optional deployment-measured overrides the model consults but
    never probes itself (e.g. "capacity_factor" for a measured key skew).
    `n_shards` is the virtual mesh the probes ran on.
    """

    backend: str
    n_devices: int
    chacha: dict  # impl -> {us_per_block, launch_us, compile_s, compile_eqns, resolved}
    all_to_all: dict  # {us_per_byte, base_us}
    dispatch: dict  # {base_us}
    round: dict  # {us_per_item, base_us, compile_s, compile_eqns}
    compile: dict  # {s_per_eqn, base_s}
    schema: int = SCHEMA
    extra: dict = field(default_factory=dict)
    n_shards: int = 1
    items: dict = field(default_factory=dict)  # kind -> `probe_workload_items` result

    @property
    def key(self) -> str:
        return f"{self.backend}/{self.n_devices}"

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Calibration":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


def backend_of(device) -> str:
    """The calibration backend of a device: 'torch-cuda' or 'torch-cpu'."""
    return "torch-cuda" if torch.device(device).type == "cuda" else "torch-cpu"


def _default_key() -> tuple[str, int]:
    """(backend, device count) of this process: the card's when there is one."""
    if torch.cuda.is_available():
        return "torch-cuda", torch.cuda.device_count()
    return "torch-cpu", 1


# -- probe plumbing ----------------------------------------------------------


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _time_us(fn, *args, reps: int = 7, inner: int = 1) -> float:
    """Least steady-state wall time of `fn(*args)` in us (after a warm-up)."""
    return _interleaved_best_us([(fn, args)], reps=reps, inner=inner)[0]


def _interleaved_best_us(entries, reps: int = 7, inner: int = 1) -> list:
    """Least wall time (us) per (fn, args) entry, trials INTERLEAVED.

    Every entry is warmed first, then trials go round-robin across them, so
    the sizes of one fit are timed under the same conditions; every source
    of jitter only adds time, so the least of the repeats is kept. A trial
    makes `inner` calls and one synchronise (host clock to
    `torch.cuda.synchronize()`), and counts per call.
    """
    for fn, args in entries:
        fn(*args)
    _sync()
    best = [float("inf")] * len(entries)
    for _ in range(max(1, reps)):
        for i, (fn, args) in enumerate(entries):
            _sync()
            t0 = time.perf_counter()
            for _ in range(inner):
                fn(*args)
            _sync()
            best[i] = min(best[i], (time.perf_counter() - t0) * 1e6 / inner)
    return best


def _capture_s(runner, args, mesh) -> float:
    """Seconds a cold runner pays before its first replay: its first call
    (warm-up round, capture, the chunk) less a warm call. 0 on a CPU mesh,
    whose eager runner captures nothing."""
    if mesh.device.type != "cuda":
        return 0.0
    _sync()
    t0 = time.perf_counter()
    runner(*args)
    _sync()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    runner(*args)
    _sync()
    return max(0.0, cold - (time.perf_counter() - t0))


def _fit_line(xs, ys) -> tuple[float, float]:
    """Least-squares y = slope*x + intercept, both clamped >= 0."""
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    if len(xs) < 2 or np.ptp(xs) == 0:
        return 0.0, float(ys.mean())
    slope, intercept = np.polyfit(xs, ys, 1)
    return max(float(slope), 0.0), max(float(intercept), 0.0)


def effective_blocks(rows: int, blocks_per_row: int, impl: str = "auto",
                     interpret: bool = False) -> int:
    """ChaCha block-equivalents a launch pays for: rows x blocks_per_row.

    Counterpart of the reference's padding model, where compiled Pallas pads
    each row to 128-lane multiples and interpret mode grows as rows^2. The
    port's kernel (`csrc/chacha20.cu`) runs one item per (row, block) of the
    launch's table, `n_rows x n_blocks` items, on both cores; a leaf's partial
    last block is cut by its `n_valid` in the kernel, not padded, and costs a
    whole keystream block like any other (`table.py`). The four-lane core
    (`kernel.lanes_for`: up to 512 items per SM) rounds its grid up to 64
    items, whose idle groups still run the rounds: at most 63 block
    computations per launch, a constant per launch that the fit's intercept
    absorbs. `impl` and `interpret` are kept for the reference's signature
    and change nothing.
    """
    if blocks_per_row == 0 or rows == 0:
        return 0
    return rows * blocks_per_row


def _probe_spec(mesh, with_width: bool, n_rounds: int):
    """The minimal driver round of the probes: keys arange % 8, the payload
    as the value, a sum reduced over the shards."""
    from repro_torch.core.driver import IterativeSpec

    def map_fn(state, inputs, r):
        x = inputs["x"]
        keys = (torch.arange(x.shape[1], dtype=torch.int32, device=x.device) % 8).expand(
            x.shape[0], x.shape[1])
        return keys, {"x": x}

    def reduce_fn(state, keys, values, valid, r):
        mask = valid[..., None] if with_width else valid
        local = torch.where(mask, values["x"], 0.0).reshape(valid.shape[0], -1).sum(dim=1)
        total = mesh.psum(local)
        return {"s": state["s"] + total}, {"s": total}

    return IterativeSpec(map_fn=map_fn, reduce_fn=reduce_fn, n_rounds=n_rounds)


def _probe_runner(mesh, with_width: bool, n_rounds: int, secure=None):
    """(runner, spec) of the probe round on `mesh`, as a runner cache builds it."""
    from repro_torch.core.driver import make_iterative_runner

    spec = _probe_spec(mesh, with_width, n_rounds)
    return make_iterative_runner(spec, mesh, secure), spec


def _one_round(spec, mesh, secure, inputs, state):
    """Device operations and the live wire record of one warm eager round
    (the first builds the kernels and the device tables, uncounted)."""
    from repro_torch.core.driver import _EagerRunner
    from repro_torch.core.shuffle import record_wire_bytes
    from repro_torch.tools.opcount import counting, total_ops

    one = _EagerRunner(spec, mesh, secure, 1)
    one(inputs, state, 0)
    with record_wire_bytes() as recs, counting() as c:
        one(inputs, state, 0)
    (rec,) = [r for r in recs if not r["halted"]]
    return total_ops(c.ops), rec


# -- probes ------------------------------------------------------------------


def _probe_chacha(impl: str, mesh, anchors, n_rounds: int, reps: int) -> dict:
    """Crypto cost measured through the REAL secure driver round.

    Times the probe's runner secure and PLAINTEXT at each anchor, trials
    interleaved; the difference per round is what the keystream path adds
    to one round (two launches, one per side of the exchange, each over
    every shard's rows). Fitted against launches x effective blocks per
    shard; the intercept is split per launch.
    """
    from repro_torch.core.shuffle import SecureShuffleConfig
    from repro_torch.crypto import chacha as chacha_mod

    sec = SecureShuffleConfig(key_words=chacha_mod.key_to_words(bytes(range(32))),
                              nonce_words=chacha_mod.nonce_to_words(b"\x07" * 12), impl=impl)
    s = mesh.n_shards
    xs, entries = [], []
    compile_s = compile_eqns = None
    for n_local, d in anchors:
        inputs = {"x": torch.ones((s * n_local, d), dtype=torch.float32, device=mesh.device)}
        state = {"s": torch.zeros((), dtype=torch.float32, device=mesh.device)}
        secure_runner, spec = _probe_runner(mesh, True, n_rounds, sec)
        plain_runner, _ = _probe_runner(mesh, True, n_rounds)
        n_ops, rec = _one_round(spec, mesh, secure_runner.secure, inputs, state)
        launches = max(1, rec["keystream_launches"])
        bpr = max(1, rec["keystream_blocks"] // (launches * s))
        xs.append(launches * effective_blocks(s, bpr, impl))
        if compile_s is None:
            compile_s = _capture_s(secure_runner, (inputs, state, 0), mesh)
            compile_eqns = n_ops
        entries.append((secure_runner, (inputs, state, 0)))
        entries.append((plain_runner, (inputs, state, 0)))
    timed = _interleaved_best_us(entries, reps=reps)
    ys = [max(0.0, (timed[2 * i] - timed[2 * i + 1]) / n_rounds) for i in range(len(anchors))]
    slope, intercept = _fit_line(xs, ys)
    route = "cuda" if mesh.device.type == "cuda" else "torch"
    return {"us_per_block": slope, "launch_us": intercept / 2.0,
            "compile_s": float(compile_s), "compile_eqns": int(compile_eqns),
            "resolved": [route, False]}


def _probe_all_to_all(mesh, sizes, reps: int) -> dict:
    """The exchange on the virtual mesh (a transpose on one device), ten
    calls a trial; bytes per shard, as the wire records count them."""
    s = mesh.n_shards
    xs, entries = [], []
    for nbytes in sizes:
        x = torch.zeros((s, s, max(1, nbytes // (4 * s * s))), dtype=torch.int32,
                        device=mesh.device)
        xs.append(x.numel() // s * 4)
        entries.append((mesh.all_to_all, (x,)))
    slope, intercept = _fit_line(xs, _interleaved_best_us(entries, reps=reps, inner=10))
    return {"us_per_byte": slope, "base_us": intercept}


def _probe_dispatch(mesh, reps: int) -> dict:
    x = torch.zeros((8,), dtype=torch.float32, device=mesh.device)
    return {"base_us": _time_us(lambda: x + 1, reps=reps)}


def _probe_round(mesh, sizes, n_rounds: int, reps: int) -> dict:
    """A minimal PLAINTEXT driver round: the real round machinery.

    The intercept prices what a round pays whatever its payload (the
    runner's call, bucket_pack's bookkeeping, the exchange's base cost); the
    slope prices per-mapped-item work. A workload whose map/reduce math
    this slope cannot price gets its own (`probe_workload_items`).
    """
    s = mesh.n_shards
    xs, entries = [], []
    compile_s = compile_eqns = None
    for n_local in sizes:
        runner, spec = _probe_runner(mesh, False, n_rounds)
        inputs = {"x": torch.ones((s * n_local,), dtype=torch.float32, device=mesh.device)}
        state = {"s": torch.zeros((), dtype=torch.float32, device=mesh.device)}
        xs.append(n_local)
        if compile_s is None:
            compile_eqns = _one_round(spec, mesh, None, inputs, state)[0]
            compile_s = _capture_s(runner, (inputs, state, 0), mesh)
        entries.append((runner, (inputs, state, 0)))
    ys = [us / n_rounds for us in _interleaved_best_us(entries, reps=reps)]
    slope, intercept = _fit_line(xs, ys)
    return {"us_per_item": slope, "base_us": intercept,
            "compile_s": float(compile_s), "compile_eqns": int(compile_eqns)}


def _probe_compile(mesh, reps: int) -> dict:
    """Capture seconds of CUDA graphs over chains of 16 and 160 operations,
    against the chains' device operations; 0 on a CPU mesh. A throwaway
    capture goes first (a process's first capture of a shape sets up what
    later ones reuse), and the least of `reps` captures is kept per chain."""
    from repro_torch.tools.opcount import count_ops, total_ops

    if mesh.device.type != "cuda":
        return {"s_per_eqn": 0.0, "base_s": 0.0}

    def chain(n):
        def f(x):
            for i in range(n):
                x = torch.sin(x) + float(i)
            return x
        return f

    def capture_s(f, x) -> float:
        graph = torch.cuda.CUDAGraph()
        _sync()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            f(x)
        _sync()
        return time.perf_counter() - t0

    x = torch.ones((128,), dtype=torch.float32, device=mesh.device)
    fns = [chain(n) for n in (16, 160)]
    xs = []
    for f in fns:
        f(x)  # the kernels load outside the capture
        xs.append(total_ops(count_ops(f, x)))
    capture_s(fns[0], x)
    ys = [float("inf")] * len(fns)
    for _ in range(max(1, reps)):
        for i, f in enumerate(fns):
            ys[i] = min(ys[i], capture_s(f, x))
    slope, intercept = _fit_line(xs, ys)
    return {"s_per_eqn": slope, "base_s": intercept}


def probe_workload_items(runner_factory, make_inputs, sizes, *, target_items: int,
                         reps: int = 7) -> dict:
    """A workload's own item term: its PLAINTEXT round at small per-shard sizes.

    `runner_factory(n_local)` builds the workload's plaintext runner (as a
    runner cache would: on the card a CUDA graph of one round) for `n_local`
    items a shard, and `make_inputs(n_local)` gives its (inputs, state).
    Each size's runner is timed by `_interleaved_best_us` (warmed first,
    trials interleaved, the least kept) and divided by the rounds the call
    executed; `_fit_line` fits (us_per_item, base_us) over the sizes. Every
    size must be at most 1/8 of `target_items`, the per-shard size the term
    will price, so a prediction made with it extrapolates and never measures
    the cell it predicts. `probe_s` is the probe's own wall time, capture
    included.
    """
    sizes = [int(n) for n in sizes]
    if len(sizes) < 2 or len(set(sizes)) < 2:
        raise ValueError(f"need two or more distinct sizes to fit a line, got {sizes}")
    over = [n for n in sizes if n < 1 or 8 * n > target_items]
    if over:
        raise ValueError(f"probe sizes {over} are not in [1, {target_items // 8}]: each must "
                         f"be at most 1/8 of the {target_items} items a shard it predicts")
    t0 = time.perf_counter()
    entries, executed = [], []
    for n in sizes:
        runner = runner_factory(n)
        inputs, state = make_inputs(n)
        done: dict = {}

        def call(runner=runner, inputs=inputs, state=state, done=done):
            done["rounds"] = int(runner(inputs, state, 0)[3])

        entries.append((call, ()))
        executed.append(done)
    best = _interleaved_best_us(entries, reps=reps)
    round_us = [us / max(1, d["rounds"]) for us, d in zip(best, executed)]
    slope, intercept = _fit_line(sizes, round_us)
    return {"us_per_item": slope, "base_us": intercept, "sizes": sizes,
            "round_us": round_us, "rounds_per_call": [d["rounds"] for d in executed],
            "target_items": int(target_items), "probe_s": time.perf_counter() - t0}


# -- entry points ------------------------------------------------------------


def run_calibration(mesh=None, *, impls=("auto",), quick: bool = False) -> Calibration:
    """Run every probe on `mesh`; return the Calibration.

    `mesh` defaults to `VirtualMesh(8)` on the card (raising without one); a
    CPU calibration needs a CPU mesh passed explicitly. `impls` are the
    keystream selectors to probe (`repro_torch.kernels.IMPLS`; on the card
    only 'auto' runs the kernel). `quick` trims the anchors and repeats: under
    ~20 s on the card.
    """
    if mesh is None:
        mesh = VirtualMesh(DEFAULT_SHARDS)
    pick = 1 if quick else 0
    sizes = {f: pair[pick] for f, pair in vars(_SIZES[mesh.device.type]).items()}
    n_rounds, reps = sizes["rounds"], sizes["reps"]
    return Calibration(
        backend=backend_of(mesh.device),
        n_devices=torch.cuda.device_count() if mesh.device.type == "cuda" else 1,
        chacha={impl: _probe_chacha(impl, mesh, sizes["chacha"], n_rounds, reps)
                for impl in impls},
        all_to_all=_probe_all_to_all(mesh, sizes["a2a_bytes"], reps),
        dispatch=_probe_dispatch(mesh, reps),
        round=_probe_round(mesh, sizes["round_items"], n_rounds, reps),
        compile=_probe_compile(mesh, reps),
        n_shards=mesh.n_shards,
    )


def save_calibration(cal: Calibration, path: str) -> None:
    """Merge `cal` into the JSON at `path`, keyed by backend/device count."""
    doc = {"schema": SCHEMA, "calibrations": {}}
    try:
        with open(path) as f:
            loaded = json.load(f)
        if isinstance(loaded.get("calibrations"), dict):
            doc = loaded
    except (OSError, ValueError):
        pass
    doc["calibrations"][cal.key] = cal.to_dict()
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)


def load_calibration(path: str, *, backend: str | None = None,
                     n_devices: int | None = None) -> Calibration | None:
    """Load the entry matching (backend, n_devices); None when absent.

    Defaults to this process's key: "torch-cuda/<cards>" with a card,
    "torch-cpu/1" without. A calibration probed elsewhere says nothing about
    this process, so a missing key gives no model (and the historical
    defaults), never a wrong one.
    """
    default_backend, default_n = _default_key()
    backend = default_backend if backend is None else backend
    n_devices = default_n if n_devices is None else n_devices
    with open(path) as f:
        doc = json.load(f)
    entry = doc.get("calibrations", {}).get(f"{backend}/{n_devices}")
    return None if entry is None else Calibration.from_dict(entry)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="calibration.json")
    ap.add_argument("--quick", action="store_true", help="fewer anchors and repeats")
    args = ap.parse_args(argv)
    cal = run_calibration(quick=args.quick)
    save_calibration(cal, args.out)
    print(f"calibrated {cal.key} ({cal.n_shards} shards): "
          + ", ".join(f"{i}={c['us_per_block']:.6f}us/blk+{c['launch_us']:.3f}us"
                      for i, c in cal.chacha.items())
          + f"; a2a {cal.all_to_all['us_per_byte'] * 1e3:.6f}ns/B"
          + f"+{cal.all_to_all['base_us']:.3f}us"
          + f"; round {cal.round['base_us']:.3f}us+{cal.round['us_per_item'] * 1e3:.6f}ns/item"
          + f"; dispatch {cal.dispatch['base_us']:.3f}us"
          + f"; capture {cal.compile['s_per_eqn'] * 1e3:.6f}ms/op+{cal.compile['base_s']:.6f}s"
          + f" -> {args.out}")


if __name__ == "__main__":
    main()
