"""The port's hillclimb cells S and K (repro_torch.launch.hillclimb) against
the reference's (repro.launch.hillclimb).

The reference module sets `XLA_FLAGS` (512 host devices) when it is imported
and imports the LM `dryrun`, so it runs in a subprocess; its results come
back as JSON, whose float text round-trips exactly. Cell S must equal the
reference's for every variant, exactly. Cell K, under one hand-built
calibration (the reference's 'jnp' entry, and the same numbers under the
port's 'auto'), must rank its 36 vectors exactly as the reference ranks its
vectors with loop_impl='while' and chacha_impl='jnp', makespans equal.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

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
    """The reference's cell S for every variant and its full cell K ranking."""
    code = textwrap.dedent(f"""
        import json
        from repro.launch import hillclimb as h
        from repro.perf.calibrate import Calibration
        from repro.perf.model import CostModel
        model = CostModel(Calibration.from_dict(json.loads({json.dumps(json.dumps(_cal_dict()))})))
        print(json.dumps({{"S": {{v: h.run_service_cell(**k) for v, k in h.SERVICE_VARIANTS}},
                          "K": h.rank_knob_vectors(model, top=10**6)}}))
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
    try:
        thc.main(["--cell", "S", "--out", str(out)])
        thc.main(["--cell", "K", "--out", str(out)])
        first = json.loads(out.read_text())
        thc.main(["--out", str(out)])  # every key cached: nothing rewritten
        assert json.loads(out.read_text()) == first
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
