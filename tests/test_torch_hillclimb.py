"""The port's hillclimb cells (repro_torch.launch.hillclimb) against the
reference's (repro.launch.hillclimb).

The reference module sets `XLA_FLAGS` (512 host devices) when it is imported
and imports the LM `dryrun`, so it runs in a subprocess; its results come
back as JSON, whose float text round-trips exactly. Cell S must equal the
reference's for every variant, exactly. Cell K, under one hand-built
calibration (the reference's 'jnp' entry, and the same numbers under the
port's 'auto'), must rank its 36 vectors exactly as the reference ranks its
vectors with loop_impl='while' and chacha_impl='jnp', makespans equal.

Cells A, B and C: the port's `CELLS` equals the reference's verbatim. On
reduced configs at a small shape (B and C in bf16 compute, as their
published configs run), every variant's abstract counts (`meta`) equal a
real CPU run's, exactly (bytes within 1%, as tests/test_torch_dryrun.py
holds them); the knobs move what they move: no remat counts fewer FLOPs
than dots, the per-token scan counts other operations than the blocked
WKV, bf16 scores move fewer bytes, the paper's full MoE remat makes more
ChaCha calls than save_shuffle, the pod-only knobs change nothing, and with
`serve_params="reference"` a serving cell's parameter bytes equal the sum
of the reference's `input_specs(...)["params"]` leaves, with and without
`serve_bf16_params` (which halves them).
"""

import dataclasses
from functools import lru_cache

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import hillclimb as thc
from repro_torch.perf.calibrate import Calibration
from repro_torch.perf.model import CostModel, clear_active_model, set_active_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cal_dict() -> dict:
    e = {"us_per_block": 0.0015, "launch_us": 3.0, "compile_s": 0.2, "compile_eqns": 400,
         "resolved": ["jnp", True]}
    return {"backend": "cpu", "n_devices": 1,
            "chacha": {"jnp": e, "auto": dict(e, resolved=["torch", False])},
            "all_to_all": {"us_per_byte": 0.0004, "base_us": 40.0},
            "dispatch": {"base_us": 60.0},
            "round": {"us_per_item": 0.002, "base_us": 900.0, "compile_s": 0.05,
                      "compile_eqns": 150},
            "compile": {"s_per_eqn": 0.0001, "base_s": 0.01}, "schema": 1, "extra": {}}


@pytest.fixture(scope="module")
def reference():
    """The reference's cell S for every variant, its full cell K ranking,
    its LM cells and a reduced qwen2-moe decode cell's parameter bytes by
    `input_specs` on a (1, 8) mesh, without and with serve_bf16_params."""
    code = textwrap.dedent(f"""
        import dataclasses, json
        import jax, numpy as np
        from repro import compat
        from repro.configs import get_config
        from repro.configs.base import ShapeConfig
        from repro.launch import hillclimb as h
        from repro.launch.specs import input_specs
        from repro.perf.calibrate import Calibration
        from repro.perf.model import CostModel
        model = CostModel(Calibration.from_dict(json.loads({json.dumps(json.dumps(_cal_dict()))})))
        mesh = compat.make_mesh((1, 8), ("data", "model"))
        nbytes = {{}}
        for flag in (False, True):
            cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                                      serve_bf16_params=flag)
            spec = input_specs(cfg, ShapeConfig("d", "decode", 16, 2), mesh)
            nbytes[str(flag)] = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                                    for x in jax.tree.leaves(spec["params"]))
        print(json.dumps({{"S": {{v: h.run_service_cell(**k) for v, k in h.SERVICE_VARIANTS}},
                          "K": h.rank_knob_vectors(model, top=10**6),
                          "CELLS": h.CELLS, "param_bytes": nbytes}}))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("variant", [v for v, _ in thc.SERVICE_VARIANTS])
def test_cell_s_equals_reference(reference, variant):
    knobs = dict(thc.SERVICE_VARIANTS)[variant]
    got = json.loads(json.dumps(thc.run_service_cell(**knobs)))
    assert got == reference["S"][variant]


def test_cell_k_ranking_equals_reference_on_the_shared_knobs(reference):
    port = thc.rank_knob_vectors(CostModel(Calibration.from_dict(_cal_dict())), top=100)
    assert port["n_vectors"] == len(port["top"]) == 36
    want = []
    for r in reference["K"]["top"]:
        vec = dict(r["vector"])
        if vec.pop("loop_impl") == "while" and vec["chacha_impl"] == "jnp":
            want.append({"vector": dict(vec, chacha_impl="auto"),
                         "predicted_makespan_s": r["predicted_makespan_s"]})
    assert json.loads(json.dumps(port["top"])) == want
    ref_res, res = reference["K"]["resolver_vector"], port["resolver_vector"]
    for knob in ("coalesce", "chunk_growth", "bucket_growth", "max_resident"):
        assert res[knob] == ref_res[knob], knob
    assert res["chacha_impl"] == "auto"  # the port's one selector on any device


def test_cli_writes_only_its_own_report_keys(tmp_path):
    out = tmp_path / "reports" / "perf_torch.json"
    set_active_model(CostModel(Calibration.from_dict(_cal_dict())))
    lm = {thc.lm_key(c, thc.CELLS[c]["shape"], v): {"status": "OK"}
          for c in thc.CELLS for v, _ in thc.variants(c)}
    try:
        thc.main(["--cell", "S", "--out", str(out)])
        thc.main(["--cell", "K", "--out", str(out)])
        first = json.loads(out.read_text())
        out.write_text(json.dumps({**first, **lm}))  # the LM cells' rows cached too
        thc.main(["--out", str(out)])  # every key cached: nothing rewritten
        assert json.loads(out.read_text()) == {**first, **lm}
    finally:
        clear_active_model()
    assert set(first) == {f"S|service|sim|{v}" for v, _ in thc.SERVICE_VARIANTS} | {
        "K|knobs|costmodel|v0_full_cross"}
    assert all(r["status"] == "OK" for r in first.values())
    assert first["K|knobs|costmodel|v0_full_cross"]["backend"] == "cpu"


def test_import_sets_no_xla_flags_and_loads_no_lm_code():
    code = textwrap.dedent("""
        import os, sys
        import repro_torch.launch.hillclimb
        assert "XLA_FLAGS" not in os.environ
        assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
    """)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=env)
    assert p.returncode == 0, p.stderr[-3000:]


# --- cells A, B and C -------------------------------------------------------------

SMALL = {"A": ShapeConfig("train_small", "train", 16, 2),
         "B": ShapeConfig("decode_small", "decode", 32, 2),
         "C": ShapeConfig("train_small", "train", 16, 2)}


def _base(cell_id: str) -> dict:
    """The cell's arch reduced; B and C in bf16 compute, as published."""
    red = get_config(thc.CELLS[cell_id]["arch"]).reduced()
    base = {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if f.name not in ("name", "source")}
    if cell_id in "BC":
        base["dtype"] = "bfloat16"
    return base


@lru_cache(maxsize=None)
def _counts(cell_id: str, variant: str, device: str) -> dict:
    override = dict(thc.variants(cell_id))[variant]
    cell = thc.CELLS[cell_id]
    return dryrun.run_cell(cell["arch"], cell["shape"], {**_base(cell_id), **override},
                           shape=SMALL[cell_id], device=device, serve_params="reference",
                           accum=1)


def test_lm_cells_equal_reference(reference):
    assert json.loads(json.dumps(thc.CELLS)) == reference["CELLS"]
    # the port's own variant beside them is the remat that the reference's v0
    # is named for: granite's config already sets save_shuffle
    assert get_config("granite-moe-3b-a800m").moe_remat == "save_shuffle"
    assert thc.EXTRA_VARIANTS["C"] == [("x0_secure_full_moe_remat",
                                        {"secure_moe": True, "moe_remat": "full"})]


@pytest.mark.parametrize("cell_id,variant", [(c, v) for c in thc.CELLS
                                             for v, _ in thc.variants(c)])
def test_lm_variant_abstract_counts_equal_a_real_cpu_run(cell_id, variant):
    meta, real = _counts(cell_id, variant, "meta"), _counts(cell_id, variant, "cpu")
    assert meta["flops"] == real["flops"] > 0
    assert meta["kernel_calls"] == real["kernel_calls"]
    assert meta["collectives"] == real["collectives"]
    assert meta["memory"] == real["memory"]
    assert meta["device_ops"] == pytest.approx(real["device_ops"], rel=1e-2)
    assert meta["bytes_accessed"] == pytest.approx(real["bytes_accessed"], rel=1e-2)


def _same_program(a: dict, b: dict) -> bool:
    keys = ("flops", "bytes_accessed", "device_ops", "kernel_calls", "collectives", "memory",
            "roofline")
    return all(a[k] == b[k] for k in keys)


def test_lm_knobs_move_what_they_should():
    a = {v: _counts("A", v, "meta") for v, _ in thc.variants("A")}
    assert a["v2_blocked_no_remat"]["flops"] < a["v3_blocked_remat_dots"]["flops"]
    assert a["v2_blocked_no_remat"]["flops"] < a["v1_blocked_wkv"]["flops"]
    scan, blocked = a["v0_scan_wkv_paper_faithful"], a["v1_blocked_wkv"]
    assert scan["device_ops"] != blocked["device_ops"]
    assert scan["flops"] != blocked["flops"] and scan["bytes_accessed"] != blocked[
        "bytes_accessed"]

    b = {v: _counts("B", v, "meta") for v, _ in thc.variants("B")}
    assert _same_program(b["v1_ep_only"], b["v0_tp_baseline"])  # shard_strategy: a pod's
    assert b["v2_ep_only_bf16_scores"]["bytes_accessed"] < b["v1_ep_only"]["bytes_accessed"]
    assert b["v2_ep_only_bf16_scores"]["flops"] == b["v1_ep_only"]["flops"]
    f32, bf16 = b["v0_tp_baseline"]["memory"], b["v3_bf16_serve_params"]["memory"]
    assert 2 * bf16["params_bytes"] == f32["params_bytes"]
    assert bf16["cache_bytes"] == f32["cache_bytes"]

    c = {v: _counts("C", v, "meta") for v, _ in thc.variants("C")}
    v0, v1 = c["v0_secure_shuffle_paper_faithful"], c["v1_secure_save_shuffle_remat"]
    assert _same_program(v0, v1)  # v0 inherits save_shuffle from the config
    assert _same_program(c["v4_secure_saveshuf_no_expert_fsdp"], v1)  # moe_fsdp: a pod's
    chacha = {v: r["kernel_calls"].get("chacha20_xor_packed", 0) for v, r in c.items()}
    layers = _base("C")["n_layers"]
    assert chacha["v1_secure_save_shuffle_remat"] == 8 * layers  # 2 legs x 2 crypts, x2 bwd
    assert chacha["x0_secure_full_moe_remat"] > chacha["v1_secure_save_shuffle_remat"]
    assert chacha["v3_plain_saveshuf_bf16"] == 0
    v2 = c["v2_secure_saveshuf_bf16_scores"]
    assert v2["bytes_accessed"] < v1["bytes_accessed"] and v2["flops"] == v1["flops"]
    rows = {v: thc.pod_note(o) for v, o in thc.variants("C")}
    assert rows["v4_secure_saveshuf_no_expert_fsdp"] and not rows["v1_secure_save_shuffle_remat"]


def test_reference_serve_params_count_the_reference_weights(reference):
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    shape = ShapeConfig("d", "decode", 16, 2)
    for flag in (False, True):
        over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                if f.name not in ("name", "source")}
        over["serve_bf16_params"] = flag
        got = dryrun.run_cell("qwen2-moe-a2.7b", "decode_32k", over, shape=shape,
                              serve_params="reference")
        assert got["memory"]["params_bytes"] == reference["param_bytes"][str(flag)]
        compute = dryrun.run_cell("qwen2-moe-a2.7b", "decode_32k", over, shape=shape)
        assert compute["memory"]["params_bytes"] == reference["param_bytes"]["False"]  # f32


def test_run_lm_cell_writes_reference_keys_and_measures_on_the_cpu(tmp_path):
    """Cell B through `run_lm_cell` on the reduced config: a row per variant
    under the reference's key, and with `measure="cpu"` a measured step per
    variant beside its abstract counts at the measured shape."""
    path = tmp_path / "perf_torch.json"
    base, shapes = dict(_base("B"), dtype="float32"), {"B": (2, 32)}
    res = thc.run_lm_cell("B", base=base, path=str(path))
    planned = thc.run_lm_cell("B", plan=True, base=base, shapes=shapes)
    res = thc.run_lm_cell("B", measure="cpu", base=base, path=str(path), shapes=shapes, reps=1,
                          results={**res, **planned})
    assert json.loads(path.read_text()) == json.loads(json.dumps(res))
    names = [v for v, _ in thc.variants("B")]
    assert set(res) == {f"B|qwen2-moe-a2.7b|{s}|one_card|{v}" for v in names
                        for s in ("decode_32k", "decode_2x32")}
    assert set(planned) == {f"B|qwen2-moe-a2.7b|decode_2x32|one_card|{v}" for v in names}
    for v in names:
        row = res[f"B|qwen2-moe-a2.7b|decode_2x32|one_card|{v}"]
        assert row["status"] == "OK" and row["step_ms"] > 0 and row["logits_finite"]
        assert row["chacha_launches_per_step"] == 0 and row["kv_len"] == 32 - thc.DECODE_TAIL + 2
        assert row["abstract"]["batch"] == 2 and row["abstract"]["seq_len"] == 32
        assert row["abstract"] == planned[f"B|qwen2-moe-a2.7b|decode_2x32|one_card|{v}"][
            "abstract"]
        assert row["param_dtype"] == ("bfloat16" if v == "v3_bf16_serve_params" else "float32")
    assert res["B|qwen2-moe-a2.7b|decode_2x32|one_card|v1_ep_only"]["note"]
