"""Tiny versions of the cells, for the CPU tests: the same files and code
paths, sizes a test run can hold (and float32 models, so that the port and
the reference agree to rounding)."""

from __future__ import annotations

TINY_MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 32,
              "moe_d_ff": 32, "vocab_size": 256, "n_experts": 8, "n_experts_per_tok": 2,
              "attn_chunk": 0, "dtype": "float32"}


def shrink(cs: dict) -> None:
    """Cut a cell's configuration and traffic (as loaded) to a tiny size: a
    language model to `TINY_MODEL`, then to its file's own `tiny` sizes."""
    kind = cs["traffic"]["kind"]
    if kind == "jobs":
        cs["config"]["deployment"].update(k=8, d=4)
        cs["traffic"].update(sizes=[300, 700, 1200], inits_per_dataset=2,
                             outstanding=2, check_jobs=3, max_rounds=16, warm_rounds=3)
        # a hundred points to a centre: a point that changes centre on
        # rounding moves its centres by a hundredth of their spread
        cs["limits"]["numbers"]["centers_step_gap"] = {"limit": 0.05}
        return
    cs["config"]["model"].update(TINY_MODEL, **cs["config"].get("tiny", {}))
    cs["config"]["deployment"]["shards"] = 4
    cs["traffic"].update(batch=2, prompt_tokens=16)
    # float32 on both sides: the port and the reference agree to rounding
    cs["limits"]["numbers"].update({n: {"limit": 1e-4} for n in cs["limits"]["numbers"]
                                    if n != "wire_faults"})
    if kind == "decode":
        cs["traffic"].update(contexts=2, new_tokens=3)


# Cells whose files are in bench/ (traffic, limits, metrics) but whose
# entries are not in BENCHMARK.json (PERF.md, Open questions): the tests run
# them from these entries. The decode cell brings its own metrics; the
# small-jobs cell reports what the large-jobs cell reports.
DECODE = "granite-moe-3b-a800m.decode"
SMALL_JOBS = "kmeans-d64-k256.small_jobs"
UNLISTED = {
    "workloads": [
        {"name": DECODE, "config": "granite-moe-3b-a800m", "traffic": "decode", "chips": 1,
         "why": "4 cached contexts of 8 x 4,096 tokens, each request restores one and "
                "decodes 128 greedy tokens at batch 8: bypasses the exchange; host-bound"},
        {"name": SMALL_JOBS, "config": "kmeans-d64-k256", "traffic": "small_jobs", "chips": 1,
         "why": "closed loop, 8 jobs outstanding (4 queued) over 8 datasets of 25K and 100K "
                "points: bypasses the kernel's cost; the service and host path do the work"}],
    "end_to_end": [{"name": "decode_tokens_per_s", "unit": "tokens/s", "better": "higher",
                    "source": "host_clock", "workloads": [DECODE]}],
    "per_layer": [
        {"name": "mfu.decode", "unit": "%", "better": "higher", "source": "program_span",
         "layer": "serve.engine", "moves": "decode_tokens_per_s", "workloads": [DECODE]},
        {"name": "device_ops_per_step.decode", "unit": "ops/step", "better": "lower",
         "source": "device_trace", "layer": "serve.engine", "moves": "decode_tokens_per_s",
         "workloads": [DECODE]},
        {"name": "device_idle_pct.decode", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device", "moves": "decode_tokens_per_s",
         "workloads": [DECODE]}],
}
REPORTS_LIKE = {SMALL_JOBS: "kmeans-d64-k256.large_jobs"}


def with_unlisted(spec: dict) -> dict:
    """`spec` (BENCHMARK.json as loaded) with the unlisted cells' entries
    added (those it does not hold already)."""
    listed = {w["name"] for w in spec["workloads"]}
    out = {}
    for key, entries in UNLISTED.items():
        have = {e["name"] for e in spec[key]}
        out[key] = [dict(e) for e in spec[key]] + [dict(e) for e in entries
                                                    if e["name"] not in have]
    for key in ("end_to_end", "per_layer"):
        for m in out[key]:
            for cell, like in REPORTS_LIKE.items():
                if cell not in listed and like in m.get("workloads", []):
                    m["workloads"] = m["workloads"] + [cell]
    return dict(spec, **out)
