"""Offline knob search of the port: hillclimb cells S and K.

Counterpart of cells S and K of `repro/launch/hillclimb.py`; its LM cells
A, B and C wait for the LM scaffolding, so this module imports no model code
and no `dryrun`, and sets no `XLA_FLAGS`.

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

S variants go through the serving resolvers, so an invalid setting fails
with the error that names its environment variable. Cell K needs a
calibration: the active model ($REPRO_CALIBRATION), else
`run_calibration(quick=True)` on the card. Results merge into
`reports/perf_torch.json` (never the reference's `reports/perf.json`).

Usage: PYTHONPATH=src python -m repro_torch.launch.hillclimb [--cell S|K] [--force]
"""

from __future__ import annotations

import argparse
import itertools as it
import json
import os

REPORT = os.path.join(os.path.dirname(__file__), "..", "..", "..", "reports", "perf_torch.json")

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


def _record(results: dict, key: str, run, path: str):
    """Run one cell variant into `results[key]` (a failure is recorded, not
    raised, as the reference does) and write the report."""
    print(f"[run] {key}", flush=True)
    try:
        r = run()
    except Exception as e:  # one variant's failure must not stop the sweep
        r = {"status": "FAIL", "error": str(e)}
    results[key] = r
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default=None, choices=[None, "S", "K"])
    ap.add_argument("--force", action="store_true")
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


if __name__ == "__main__":
    main()
