"""Offline knob search of the port: hillclimb cells A, B, C, S and K.

Counterpart of `repro/launch/hillclimb.py`. It sets no `XLA_FLAGS` and
imports model code only when an LM cell runs.

  A  rwkv6-1.6b|train_4k        WKV form (scan or blocked) x remat
  B  qwen2-moe-a2.7b|decode_32k expert placement, bf16 scores, bf16
                                serving weights
  C  granite-moe-3b-a800m|train_4k  the paper's technique: the encrypted
                                expert exchange, its remat, bf16 scores,
                                expert FSDP
  S  serving admission knobs    bucket growth x resident-runner cap, swept
                                through the virtual-time AdmissionSim
                                (`runtime/sim.py`) on burst + straggler
                                traces: no device, makespans only
  K  calibrated knob vectors    the auto-knob cross product (keystream
                                selector x coalesce x chunk growth x bucket
                                growth x residency cap), each priced by a
                                per-vector TimingModel from the calibrated
                                cost model (`repro_torch/perf/model.py`) and
                                ranked by predicted AdmissionSim makespan

A, B and C carry the reference's variants verbatim (`CELLS`; C also runs
the port's `x0`, see `EXTRA_VARIANTS`). Each variant is counted by
`launch/dryrun.py::run_cell` on `meta`, with the serving weights as the
reference's `input_specs` holds them (`serve_params="reference"`), where
the reference re-lowers the cell for a pod; rows are keyed as the
reference's, with the mesh `one_card`. The training cells at train_4k are
counted one microbatch at a time (`run_cell(..., one_microbatch=True)`).
`shard_strategy` and `moe_fsdp` place tensors on a pod: on one card their
variants run their baseline's program, and their rows say so. `--plan`
counts every variant instead at the shapes the card runs it
(`measure_plan`); `--measure` runs every variant on the card
(`measure_lm_cell`: a training step or a decode step, one warm-up, the
median of 3, host clock to a synchronise) at the largest shape at which
the cell's variants run on one card, beside its abstract counts there.

S variants go through the serving resolvers, so an invalid setting fails
with the error that names its environment variable. Cell K needs a
calibration: the active model ($REPRO_CALIBRATION), else
`run_calibration(quick=True)` on the card. Results merge into
`reports/perf_torch.json` (never the reference's `reports/perf.json`).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell A|B|C|S|K] [--force]
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell A --plan      # no card
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell A --measure   # on the card
"""

from __future__ import annotations

import argparse
import itertools as it
import json
import os
import statistics
import time
import traceback

import torch

REPORT = os.path.join(os.path.dirname(__file__), "..", "..", "..", "reports", "perf_torch.json")
MESH = "one_card"

# The reference's LM cells, verbatim (`repro/launch/hillclimb.py::CELLS`).
CELLS = {
    "A": {
        "arch": "rwkv6-1.6b",
        "shape": "train_4k",
        "variants": [
            ("v0_scan_wkv_paper_faithful", {"wkv_impl": "scan"}),
            ("v1_blocked_wkv", {"wkv_impl": "blocked"}),
            ("v2_blocked_no_remat", {"wkv_impl": "blocked", "remat": "none"}),
            ("v3_blocked_remat_dots", {"wkv_impl": "blocked", "remat": "dots"}),
        ],
    },
    "B": {
        "arch": "qwen2-moe-a2.7b",
        "shape": "decode_32k",
        "variants": [
            ("v0_tp_baseline", {}),
            ("v1_ep_only", {"shard_strategy": "ep_only"}),
            ("v2_ep_only_bf16_scores", {"shard_strategy": "ep_only",
                                        "softmax_dtype": "bfloat16"}),
            ("v3_bf16_serve_params", {"serve_bf16_params": True}),
        ],
    },
    "C": {
        "arch": "granite-moe-3b-a800m",
        "shape": "train_4k",
        "variants": [
            ("v0_secure_shuffle_paper_faithful", {"secure_moe": True}),
            ("v1_secure_save_shuffle_remat", {"secure_moe": True,
                                              "moe_remat": "save_shuffle"}),
            ("v2_secure_saveshuf_bf16_scores", {"secure_moe": True,
                                                "moe_remat": "save_shuffle",
                                                "softmax_dtype": "bfloat16"}),
            ("v3_plain_saveshuf_bf16", {"secure_moe": False,
                                        "moe_remat": "save_shuffle",
                                        "softmax_dtype": "bfloat16"}),
            ("v4_secure_saveshuf_no_expert_fsdp", {"secure_moe": True,
                                                   "moe_remat": "save_shuffle",
                                                   "moe_fsdp": False}),
        ],
    },
}

# Port-only variants, run beside the reference's. granite-moe's config sets
# `moe_remat="save_shuffle"` (`configs/granite_moe_3b_a800m.py`, the cell's
# adopted result), so the reference's v0, whose override leaves `moe_remat`
# alone, runs v1's program; `x0` is the paper-faithful remat it is named for:
# the backward replays the encrypted exchange.
EXTRA_VARIANTS = {
    "C": [("x0_secure_full_moe_remat", {"secure_moe": True, "moe_remat": "full"})],
}


def variants(cell_id: str) -> list:
    """The cell's (name, override) pairs: the reference's, then the port's own."""
    return CELLS[cell_id]["variants"] + EXTRA_VARIANTS.get(cell_id, [])


# Knobs that place tensors on a pod's mesh: one card has nothing to place.
POD_ONLY = {
    "shard_strategy": "places weights and activations over a pod's mesh (tensor- or "
                      "expert-parallel); one card places nothing, so this variant runs "
                      "its baseline's program",
    "moe_fsdp": "shards the expert weights over a pod's data-parallel axis; one card "
                "holds them whole, so this variant runs its baseline's program",
}

# The shapes the card measures at: every variant of a cell at one shape, the
# largest at which all of them run on one card. A: the 4 x 4,096 tokens
# chip_smoke's lm_ssm trains (the per-token scan, ~30 host launches a token
# and layer, at 4 x 64, beside the blocked WKV at the same shape); B: the
# cell's own 32,768-token context at the batch that fits beside the float32
# weights (`decode_batch`); C: lm_train's 4 x 1,024. One microbatch a step.
MEASURE_SHAPES = {"A": (4, 4096), "B": (None, 32768), "C": (4, 1024)}
SCAN_SHAPE = (4, 64)
MEASURE_SEED, MEASURE_REPS, DECODE_TAIL = 0, 3, 16
CARD_MARGIN = 4e9  # bytes kept free past a variant's reckoned resident bytes

# Serving-knob sweep (cell S): each variant is a (bucket growth, resident
# runner cap) point, the two knobs the job service exposes via
# $REPRO_BUCKET_GROWTH / $REPRO_SERVICE_MAX_RUNNERS.
SERVICE_VARIANTS = [
    ("v0_g2_unbounded", {"bucket_growth": 2.0, "max_resident": None}),
    ("v1_g1.5_unbounded", {"bucket_growth": 1.5, "max_resident": None}),
    ("v2_g4_unbounded", {"bucket_growth": 4.0, "max_resident": None}),
    ("v3_g2_rmax8", {"bucket_growth": 2.0, "max_resident": 8}),
    ("v4_g2_rmax2", {"bucket_growth": 2.0, "max_resident": 2}),
]


def run_service_cell(bucket_growth, max_resident):
    """Sweep point for cell S: AdmissionSim makespans under the two knobs."""
    from repro_torch.runtime.sim import AdmissionSim, burst_trace, straggler_trace
    from repro_torch.serve.service import resolve_bucket_growth, resolve_max_resident

    growth = resolve_bucket_growth(bucket_growth)
    cap = resolve_max_resident(max_resident if max_resident is None else int(max_resident))
    sim = AdmissionSim(bucket_growth=growth, max_resident=cap)
    out = {"status": "OK", "bucket_growth": growth, "max_resident": cap, "traces": {}}
    for name, trace in [("burst", burst_trace()), ("straggler", straggler_trace())]:
        bucketed = sim.run(trace, "bucketed")
        per_job = sim.run(trace, "compile-per-job")
        out["traces"][name] = {
            "bucketed_makespan_s": bucketed["makespan_s"],
            "per_job_makespan_s": per_job["makespan_s"],
            "compiles": bucketed["compiles"],
            "evictions": bucketed["evictions"],
            "mean_latency_s": bucketed["mean_latency_s"],
        }
    return out


# Calibrated knob-vector search (cell K): the cross product every `auto`
# resolver draws from, ranked offline by predicted makespan. The reference's
# 'loop_impl' axis has no counterpart (one loop shape), and the keystream
# selector has one value per device: 1 x 2 x 3 x 3 x 2 = 36 vectors.
KNOB_SPACE = {
    "chacha_impl": ("auto",),
    "coalesce": (True, False),
    "chunk_growth": (2, 3, 4),
    "bucket_growth": (1.5, 2.0, 4.0),
    "max_resident": (None, 8),
}


def rank_knob_vectors(model=None, *, top: int = 10) -> dict:
    """Cell K: rank the auto-knob cross product by PREDICTED makespan.

    Each vector gets its own `TimingModel` (the keystream selector sets the
    crypto bandwidth, a per-leaf wire multiplies exchange latency) and is
    replayed through AdmissionSim on the burst + straggler traces: pure
    prediction, no device work beyond the (active or quick) calibration.
    `resolver_vector` is what the `auto` resolvers pick one knob at a time;
    agreement with the top vector is a model-consistency check.
    """
    from repro_torch.perf.model import CostModel, active_model
    from repro_torch.runtime.sim import AdmissionSim, burst_trace, straggler_trace

    if model is None:
        model = active_model()
    if model is None:
        from repro_torch.perf.calibrate import run_calibration

        model = CostModel(run_calibration(quick=True))

    traces = [("burst", burst_trace()), ("straggler", straggler_trace())]
    names = list(KNOB_SPACE)
    ranked = []
    for combo in it.product(*KNOB_SPACE.values()):
        vec = dict(zip(names, combo))
        timing = model.timing_model(impl=vec["chacha_impl"], coalesce=vec["coalesce"])
        sim = AdmissionSim(timing, bucket_growth=vec["bucket_growth"],
                           max_resident=vec["max_resident"],
                           chunk_growth=vec["chunk_growth"])
        total = sum(sim.run(t, "bucketed")["makespan_s"] for _, t in traces)
        ranked.append({"vector": vec, "predicted_makespan_s": total})
    ranked.sort(key=lambda r: r["predicted_makespan_s"])
    resolver_vec = {
        "chacha_impl": model.recommend("chacha_impl"),
        "coalesce": model.recommend("coalesce"),
        "chunk_growth": model.recommend("chunk_growth"),
        "bucket_growth": model.recommend("bucket_growth"),
        "max_resident": model.recommend("max_resident"),
    }
    return {
        "status": "OK",
        "backend": model.cal.backend,
        "n_vectors": len(ranked),
        "best": ranked[0],
        "top": ranked[:top],
        "resolver_vector": resolver_vec,
    }


def lm_key(cell_id: str, shape_name: str, variant: str) -> str:
    """A row's key, the reference's format with the mesh `one_card`."""
    return f"{cell_id}|{CELLS[cell_id]['arch']}|{shape_name}|{MESH}|{variant}"


def pod_note(override: dict) -> str | None:
    """Why a variant's knob changes nothing on one card, or None."""
    return "; ".join(POD_ONLY[k] for k in override if k in POD_ONLY) or None


def lm_variant_counts(cell_id: str, override: dict, shape=None, base: dict | None = None) -> dict:
    """One variant's abstract counts (`dryrun.run_cell` on `meta`, serving
    weights as the reference's `input_specs` holds them). `shape` None
    counts the cell's own shape, a training step one microbatch at a time;
    a `ShapeConfig` counts one step of one microbatch there, as the card
    measures it. `base` (config fields) goes under `override`: a test's
    reduced config."""
    from repro_torch.configs import get_shape
    from repro_torch.launch import dryrun

    cell = CELLS[cell_id]
    train = get_shape(cell["shape"]).kind == "train"
    r = dryrun.run_cell(cell["arch"], cell["shape"], {**(base or {}), **override}, shape=shape,
                        serve_params="reference", accum=1 if shape is not None else None,
                        one_microbatch=train and shape is None)
    return dict(r, override=override, note=pod_note(override))


def _shape(kind: str, b: int, t: int):
    from repro_torch.configs import ShapeConfig

    return ShapeConfig(f"{kind}_{b}x{t}", kind, t, b)


def _median_s(fn, reps: int, sync) -> tuple:
    """(the last result, [seconds of each of `reps` calls]), one warm-up
    call first; host clock to a synchronise."""
    out = fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync()
        times.append(time.perf_counter() - t0)
    return out, times


def _cell_cfg(cell_id: str, override: dict, base: dict | None):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(CELLS[cell_id]["arch"]), **{**(base or {}), **override})


class _Card:
    """The card's memory figures (zeros, and no limit, off the card)."""

    def __init__(self, dev):
        self.dev, self.cuda = dev, dev.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def allocated(self) -> int:
        return torch.cuda.memory_allocated(self.dev) if self.cuda else 0

    def free(self) -> float:
        """Bytes a variant may take: the card's free bytes less CARD_MARGIN."""
        if not self.cuda:
            return float("inf")
        torch.cuda.empty_cache()
        return torch.cuda.mem_get_info(self.dev)[0] - CARD_MARGIN

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)

    def peak(self) -> int | None:
        return torch.cuda.max_memory_allocated(self.dev) if self.cuda else None


def _train_variant(cfg, dev, b: int, t: int, card: _Card, reps: int) -> dict:
    """The variant's float32 masters and AdamW state from the seed, then its
    step at b x t: one warm-up and `reps` timed steps (`reps` 0: the one
    step alone). The row carries `resident_bytes` (the state) and
    `param_bytes`."""
    from repro_torch.crypto.keys import make_session_keys
    from repro_torch.data.pipeline import SecureShardedSource
    from repro_torch.kernels import kernel_calls
    from repro_torch.launch import dryrun
    from repro_torch.mesh import VirtualMesh
    from repro_torch.train.step import SecureIngest, init_train_state, make_train_step

    moe = cfg.family == "moe"
    n_model = dryrun.MOE_SHARDS if moe else 1
    base = card.allocated()
    card.reset_peak()
    model, opt = init_train_state(cfg, torch.Generator(device=dev).manual_seed(MEASURE_SEED),
                                  n_model, dev)
    resident = card.allocated() - base
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    ingest = None
    if moe:  # cell C: the paper's data path, batches arrive encrypted
        session = make_session_keys(b"\x42" * 32)
        ingest = SecureIngest(session.words("data"), session.nonce_words("data", 0))
        rng = torch.Generator().manual_seed(MEASURE_SEED + 1)
        toks = torch.randint(0, cfg.vocab_size, ((b + 4) * t,), generator=rng,
                             dtype=torch.int32).numpy()
        src = SecureShardedSource(toks, batch=b, seq=t, session=session, device=dev)
        batches = [src.next_batch() for _ in range(reps + 1)]
    else:
        g = torch.Generator(device=dev).manual_seed(MEASURE_SEED + 1)
        batches = [{"tokens": torch.randint(0, cfg.vocab_size, (b, t), generator=g, device=dev,
                                            dtype=torch.int32)} for _ in range(reps + 1)]
    step_fn = make_train_step(cfg, VirtualMesh(n_model, dev) if moe else None,
                              secure_ingest=ingest, secure_moe=dryrun.secure_moe_config(cfg),
                              peak_lr=1e-4, warmup=1, total_steps=100)
    feed = iter(range(reps + 1))
    launches, losses = [], []

    def one():
        nonlocal model, opt
        i = next(feed)
        with kernel_calls.recording() as calls:
            model, opt, m = step_fn(model, opt, batches[i], i)
        launches.append(calls.get("chacha20_xor_packed", 0))
        losses.append(m["loss"])

    if reps:
        _, times = _median_s(one, reps, card.sync)
    else:
        one()
        card.sync()
        times = []
    peak = card.peak()
    row = {"status": "OK", "batch": b, "seq_len": t, "resident_bytes": resident,
           "param_bytes": param_bytes,
           "peak_memory_bytes": None if peak is None else peak - base,
           "chacha_launches_per_step": launches[-1], "chacha_launches_by_step": launches,
           "losses_finite": bool(torch.isfinite(torch.stack(losses).float()).all()),
           "secure_ingest": ingest is not None}
    if times:
        step_s = statistics.median(times)
        row.update(step_ms=1e3 * step_s, steps_ms=[1e3 * x for x in times],
                   tokens_per_s=b * t / step_s)
    del model, opt, batches
    return row


def _train_batch(cell_id, jobs, dev, card, base, b: int, t: int) -> tuple:
    """The batch every variant of a training cell runs at: `b`, halved
    until each variant's step fits the card's free bytes, reckoned from one
    step at batch 1 (its peak less the resident state and the float32
    gradients: one sequence's activations). (batch, {variant: the
    reckoning}); off the card `b` and no reckoning."""
    reckoned = {}
    if not card.cuda:
        return b, reckoned
    free = card.free()
    for vname, override, _ in jobs:
        row = _train_variant(_cell_cfg(cell_id, override, base), dev, 1, t, card, 0)
        card.free()
        fixed = row["resident_bytes"] + row["param_bytes"]
        act = max(row["peak_memory_bytes"] - fixed, 0)
        while b > 1 and fixed + b * act > free:
            b //= 2
        reckoned[vname] = {"resident_bytes": row["resident_bytes"],
                           "gradient_bytes": row["param_bytes"],
                           "batch1_peak_bytes": row["peak_memory_bytes"],
                           "activation_bytes_per_sequence": act, "free_bytes": free}
    for r in reckoned.values():
        r.update(batch=b, reckoned_bytes=r["resident_bytes"] + r["gradient_bytes"]
                 + b * r["activation_bytes_per_sequence"])
        r["fits"] = r["reckoned_bytes"] <= free
    return b, reckoned


def measure_plan(cell_id: str, *, base: dict | None = None, shapes: dict | None = None,
                 free: float | None = None, halvings: bool = False) -> list:
    """[(variant, override, (batch, seq))]: what `measure_lm_cell` runs
    before any batch is cut on the card. A training cell at
    `MEASURE_SHAPES` (A's scan, and the blocked WKV beside it, first at
    `SCAN_SHAPE`), and with `halvings` then at each halved batch the card
    may cut it to; cell B at its context, the batch `decode_batch` reckons
    beside v0's float32 weights in `free` bytes (default: the card's 80 GB
    less CARD_MARGIN). `base` and `shapes` as `measure_lm_cell`'s."""
    from repro_torch.configs import get_shape

    shapes = shapes or {}
    cell = CELLS[cell_id]
    b, t = shapes.get(cell_id, MEASURE_SHAPES[cell_id])
    if get_shape(cell["shape"]).kind == "decode":
        if b is None:
            from repro_torch.tools.roofline import CARD_BYTES

            b = decode_batch(cell_id, t, base, CARD_BYTES - CARD_MARGIN if free is None
                             else free)[0]
        return [(v, o, (b, t)) for v, o in variants(cell_id)]
    jobs = [(v, o, (b, t)) for v, o in variants(cell_id) if o.get("wkv_impl") != "scan"]
    scans = [(v, o) for v, o in variants(cell_id) if o.get("wkv_impl") == "scan"]
    if scans:
        blocked = next((v, o) for v, o in variants(cell_id) if o.get("wkv_impl") == "blocked")
        jobs = [(v, o, shapes.get("scan", SCAN_SHAPE)) for v, o in scans + [blocked]] + jobs
    while halvings and b > 1:
        b //= 2
        jobs += [(v, o, (b, t)) for v, o in variants(cell_id) if o.get("wkv_impl") != "scan"]
    return jobs


def measure_lm_cell(cell_id: str, device="cuda", *, reps: int = MEASURE_REPS,
                    base: dict | None = None, shapes: dict | None = None) -> dict:
    """Every variant of cell A, B or C run on `device` (see the module's
    docstring), as `measure_plan` lays them out: {(variant, shape name):
    row}. A row has the step's ms (median of `reps` after one warm-up),
    every timed step's ms, tokens/s, peak memory over what was allocated
    before, and ChaCha kernel calls a step. A training cell's batch is
    halved until each variant's step fits (`_train_batch`); a variant that
    cannot run on one card has status "NO_FIT" and the bytes that rule it
    out, and is not run. `base` (config fields) and `shapes` ({cell:
    (batch, seq)}, A's scan under "scan") shrink the cell for a test."""
    from repro_torch.configs import get_shape
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    card = _Card(dev)
    shapes = shapes or {}
    if get_shape(CELLS[cell_id]["shape"]).kind == "decode":
        return _measure_decode(cell_id, dev, card, reps, base, shapes.get(cell_id))
    b, t = shapes.get(cell_id, MEASURE_SHAPES[cell_id])
    jobs = measure_plan(cell_id, base=base, shapes=shapes)
    b_fit, reckoned = _train_batch(cell_id, [j for j in jobs if j[2] == (b, t)], dev, card,
                                   base, b, t)
    out = {}
    for vname, override, (vb, vt) in jobs:
        reduced = None
        if (vb, vt) == (b, t) and b_fit != b:
            reduced = {"batch": [b, b_fit], "why": "the reckoned step does not fit at "
                       f"batch {b}", "reckoning": reckoned}
            vb = b_fit
        elif (vb, vt) != (b, t):
            reduced = {"shape": [[b, t], [vb, vt]], "why": "the per-token scan issues ~30 "
                       "host launches a token and layer; the blocked WKV runs here too"}
        if vname in reckoned and not reckoned[vname]["fits"] and (vb, vt) == (b_fit, t):
            row = {"status": "NO_FIT"}  # not even one sequence fits: the reckoning says why
        else:
            row = _train_variant(_cell_cfg(cell_id, override, base), dev, vb, vt, card, reps)
        name = _shape("train", vb, vt).name
        row.update(variant=vname, override=override, note=pod_note(override), shape_name=name,
                   reckoning=reckoned.get(vname), reduced=reduced)
        out[(vname, name)] = row
        card.free()
    return out


def decode_batch(cell_id: str, seq: int, base: dict | None, free: float,
                 start: int = 8) -> tuple:
    """(batch, the reckoning) for the decode cell's step at `seq` tokens of
    context beside its first variant's weights as the reference holds them
    (float32): halved from `start` until the weights, the KV cache, one
    layer's weights cast to the compute dtype and one layer's K/V copied
    for the score product fit `free`."""
    from repro_torch.launch import dryrun
    from repro_torch.models.layers import compute_dtype
    from repro_torch.models.lm import LM

    cfg = _cell_cfg(cell_id, CELLS[cell_id]["variants"][0][1], base)
    meta = LM(cfg, dryrun.MOE_SHARDS, torch.device("meta"),
              dryrun.serve_param_dtype(cfg, "reference"))
    weight_bytes = sum(p.numel() * p.element_size() for p in meta.parameters())
    kv_seq = 2 * cfg.n_layers * seq * cfg.n_kv_heads * cfg.head_dim * compute_dtype(cfg).itemsize

    def need(n):
        return weight_bytes + n * kv_seq + weight_bytes / cfg.n_layers + n * kv_seq / cfg.n_layers

    b = start
    while b > 1 and need(b) > free:
        b //= 2
    return b, {"batch": b, "weight_bytes": weight_bytes, "kv_bytes_per_sequence": kv_seq,
               "free_bytes": free, "reckoned_bytes": need(b), "fits": need(b) <= free}


def _measure_decode(cell_id, dev, card, reps, base, shape):
    """Cell B: one decode step at the cell's context, the cache filled with
    seeded random K/V and its position DECODE_TAIL short of the end (a step
    reads the same bytes whatever the values: no prefill is run). v0-v2
    hold the reference's float32 weights, v3 bfloat16 (`serve_bf16_params`);
    the batch is reckoned once, beside the float32 weights (`decode_batch`)."""
    from repro_torch.configs import get_shape
    from repro_torch.kernels import kernel_calls
    from repro_torch.launch import dryrun
    from repro_torch.mesh import VirtualMesh
    from repro_torch.models.lm import init_params
    from repro_torch.serve.engine import decode_step, init_cache

    cell = CELLS[cell_id]
    b, t = shape or MEASURE_SHAPES[cell_id]
    mesh = VirtualMesh(dryrun.MOE_SHARDS, dev)
    reckoning = None
    if b is None:
        b, reckoning = decode_batch(cell_id, t, base, card.free())
    name = _shape("decode", b, t).name
    full = get_shape(cell["shape"]).global_batch
    reduced = None if b == full else {"batch": [full, b], "why": "the KV cache beside the "
                                      "float32 weights", "reckoning": reckoning}
    out, model, model_dtype, cache = {}, None, None, None
    for vname, override in variants(cell_id):
        head = {"variant": vname, "override": override, "note": pod_note(override),
                "shape_name": name, "reduced": reduced}
        if reckoning is not None and not reckoning["fits"]:
            out[(vname, name)] = dict(head, status="NO_FIT", reckoning=reckoning)
            continue
        cfg = _cell_cfg(cell_id, override, base)
        dtype = dryrun.serve_param_dtype(cfg, "reference")
        if cache is None:
            cache = init_cache(cfg, b, t, dev)
            g = torch.Generator(device=dev).manual_seed(MEASURE_SEED + 2)
            for kv in ("k", "v"):
                for layer in cache[kv]:
                    layer.normal_(generator=g)
        if model_dtype != dtype:
            model = None
            card.free()
            model = init_params(cfg, torch.Generator(device=dev).manual_seed(MEASURE_SEED),
                                dryrun.MOE_SHARDS, dev, dtype)
            model_dtype = dtype
        cache["pos"].fill_(t - DECODE_TAIL)
        g = torch.Generator(device=dev).manual_seed(MEASURE_SEED + 3)
        tokens = torch.randint(0, cfg.vocab_size, (b, 1), generator=g, device=dev,
                               dtype=torch.int32)
        base_bytes = card.allocated()
        card.reset_peak()
        launches = []

        def one():
            with kernel_calls.recording() as calls:
                lg = decode_step(cfg, model, cache, tokens, mesh=mesh)
            launches.append(calls.get("chacha20_xor_packed", 0))
            return lg

        lg, times = _median_s(one, reps, card.sync)
        step_s, peak = statistics.median(times), card.peak()
        out[(vname, name)] = dict(
            head, status="OK", batch=b, seq_len=t, param_dtype=str(dtype).split(".")[-1],
            param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
            cache_bytes=sum(v.numel() * v.element_size() for v in cache.values()),
            step_ms=1e3 * step_s, steps_ms=[1e3 * x for x in times], tokens_per_s=b / step_s,
            peak_memory_bytes=None if peak is None else peak - base_bytes,
            resident_bytes=base_bytes, chacha_launches_per_step=launches[-1],
            logits_finite=bool(torch.isfinite(lg[:, :cfg.vocab_size]).all()),
            kv_len=int(cache["pos"][0]), reckoning=reckoning)
    del model, cache
    card.free()
    return out


def run_lm_cell(cell_id: str, *, measure=None, plan: bool = False,
                results: dict | None = None, path: str | None = None, force: bool = False,
                base: dict | None = None, shapes: dict | None = None,
                reps: int = MEASURE_REPS) -> dict:
    """Cell A, B or C into `results` (merged by key; written to `path` after
    each row). By default each variant's abstract counts at the cell's own
    shape. With `plan`, instead, its abstract counts at the shapes the card
    runs, whatever batch it is cut to (`measure_plan` with its halvings),
    each under the key of its shape. With `measure` (a
    device), its measured step there (`measure_lm_cell`), beside its
    abstract counts at that shape (a planned row's, when `results` has
    one)."""
    from repro_torch.configs import get_shape

    results = {} if results is None else results
    cell = CELLS[cell_id]
    for vname, override in variants(cell_id) if not (plan or measure) else ():
        key = lm_key(cell_id, cell["shape"], vname)
        if key in results and not force:
            print(f"[cached] {key}")
            continue
        r = _record(results, key, lambda: dict(
            lm_variant_counts(cell_id, override, base=base), variant=vname), path)
        _print_lm(r)
    kind = get_shape(cell["shape"]).kind
    if plan and measure is None:  # each row written as soon as it is counted
        for vname, override, (b, t) in measure_plan(cell_id, base=base, shapes=shapes,
                                                    halvings=True):
            at = _shape(kind, b, t)
            key = lm_key(cell_id, at.name, vname)
            if key not in results or force:
                _record(results, key, lambda: {
                    "status": "OK", "variant": vname, "shape_name": at.name,
                    "override": override, "note": pod_note(override),
                    "abstract": lm_variant_counts(cell_id, override, at, base)}, path)
    if measure is None:
        return results
    for (vname, shape_name), row in measure_lm_cell(cell_id, measure, base=base,
                                                    shapes=shapes, reps=reps).items():
        key = lm_key(cell_id, shape_name, vname)

        def counted(row=row, prior=results.get(key, {}).get("abstract")):
            if row["status"] != "OK":
                return row
            at = _shape(kind, row["batch"], row["seq_len"])
            return dict(row, abstract=prior or lm_variant_counts(cell_id, row["override"], at,
                                                                 base))

        r = _record(results, key, counted, path)
        if r["status"] == "OK":
            print(f"   measured {r['step_ms']:.1f} ms a step, {r['tokens_per_s']:.0f} tokens/s, "
                  f"ChaCha {r['chacha_launches_per_step']} a step")
    return results


def _print_lm(r: dict) -> None:
    if r["status"] == "OK":
        rf = r["roofline"]
        print(f"   c={rf['compute_s']:.3e} m={rf['memory_s']:.3e} x={rf['collective_s']:.3e} "
              f"dom={rf['dominant']} peak={r['memory']['peak_per_device'] / 2**30:.2f}GiB "
              f"chacha={r['kernel_calls'].get('chacha20_xor_packed', 0)}")
    else:
        print(f"   {r['status']} {r.get('error', '')[:160]}")


def _record(results: dict, key: str, run, path: str | None):
    """Run one cell variant into `results[key]` (a failure is recorded, not
    raised, as the reference does) and write the report to `path`."""
    print(f"[run] {key}", flush=True)
    try:
        r = run()
    except Exception as e:  # one variant's failure must not stop the sweep
        r = {"status": "FAIL", "error": f"{type(e).__name__}: {e}",
             "trace": traceback.format_exc()[-1500:]}
    results[key] = r
    if path is not None:
        with open(path, "w") as f:
            json.dump(results, f, indent=1)
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default=None, choices=[None, "A", "B", "C", "S", "K"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--measure", action="store_true",
                    help="run cells A, B and C on the card (measure_lm_cell), each "
                         "variant beside its abstract counts at the measured shape")
    ap.add_argument("--plan", action="store_true",
                    help="count cells A, B and C at the shapes --measure runs, without "
                         "the card, instead of at the cells' own shapes")
    ap.add_argument("--out", default=REPORT, help="report JSON (merged by key)")
    args = ap.parse_args(argv)

    path = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    results = {}
    if os.path.exists(path):
        with open(path) as f:
            results = json.load(f)

    if args.cell in (None, "S"):
        for vname, knobs in SERVICE_VARIANTS:
            key = f"S|service|sim|{vname}"
            if key in results and not args.force:
                print(f"[cached] {key}")
                continue
            r = _record(results, key, lambda: dict(run_service_cell(**knobs), variant=vname),
                        path)
            if r["status"] == "OK":
                burst = r["traces"]["burst"]
                print(f"   burst bucketed={burst['bucketed_makespan_s']:.0f}s "
                      f"per-job={burst['per_job_makespan_s']:.0f}s "
                      f"compiles={burst['compiles']} evict={burst['evictions']}")
            else:
                print(f"   FAIL {r['error'][:160]}")

    if args.cell in (None, "K"):
        key = "K|knobs|costmodel|v0_full_cross"
        if key in results and not args.force:
            print(f"[cached] {key}")
        else:
            r = _record(results, key, rank_knob_vectors, path)
            if r["status"] == "OK":
                best = r["best"]
                print(f"   best={best['vector']} "
                      f"pred_makespan={best['predicted_makespan_s']:.3f}s")
                print(f"   resolver_vector={r['resolver_vector']}")
            else:
                print(f"   FAIL {r['error'][:160]}")

    for cell_id in CELLS:
        if args.cell in (None, cell_id):
            run_lm_cell(cell_id, measure="cuda" if args.measure else None, plan=args.plan,
                        results=results, path=path, force=args.force)


if __name__ == "__main__":
    main()
