"""The port's roofline tools (repro_torch.tools.roofline, report_md) against
the reference's (repro.tools.roofline).

`param_counts` and `model_flops` are the reference's formulas over the
port's copy of the configs: equal exactly for all ten archs and every
shape. `generate_report` digests a hand-written dry-run JSON into the
reference's row fields: the same JSON under the reference's mesh name gives
the reference's rows, field for field (the note included), apart from the
key and the mesh's name. `roofline_terms` uses the H100's peaks, never the
TPU's.
"""

import json

import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.tools import hlo as jhlo
from repro.tools import roofline as jroofline
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.models import ssm as tssm
from repro_torch.tools import report_md, roofline


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_the_reference(arch):
    assert roofline.param_counts(get_config(arch)) == jroofline.param_counts(jget_config(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference_for_every_shape(arch):
    assert list(SHAPES) == list(JSHAPES)
    for name in SHAPES:
        assert roofline.model_flops(get_config(arch), SHAPES[name]) == \
            jroofline.model_flops(jget_config(arch), JSHAPES[name]), name


def test_ssm_dims_copy_equals_the_models():
    assert roofline.HEAD_P == tssm.HEAD_P
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        assert roofline.ssm_dims(cfg) == tssm.ssm_dims(cfg)


def test_roofline_terms_use_the_cards_peaks():
    """989 TFLOP/s bf16 and 3.35 TB/s: one second of each term at its peak;
    the exchange's wire is read and written once at the HBM rate."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) != (jhlo.PEAK_FLOPS, jhlo.HBM_BW)
    t = roofline.roofline_terms(989e12, 3.35e12 / 2, 3.35e12 / 8)
    assert t["compute_s"] == 1.0 and t["memory_s"] == 0.5 and t["collective_s"] == 0.25
    assert t["dominant"] == "compute"
    assert roofline.roofline_terms(1.0, 3.35e12, 0)["dominant"] == "memory"
    assert roofline.roofline_terms(1.0, 1.0, 3.35e12)["dominant"] == "collective"
    assert (t["flops_per_chip"], t["bytes_per_chip"], t["link_bytes_per_chip"]) == (
        989e12, 3.35e12 / 2, 3.35e12 / 8)


def _cell(flops, dominant, peak, colls, t):
    return {"status": "OK", "n_chips": 1, "t_compile_s": t,
            "roofline": {"flops_per_chip": flops, "compute_s": flops / 989e12,
                         "memory_s": 0.25, "collective_s": 0.0, "dominant": dominant},
            "memory": {"peak_per_device": peak},
            "collectives": {"collective_counts": colls}}


DRYRUN = {
    "glm4-9b|prefill_32k|{m}": _cell(6.2e14, "memory", 61_000_000_000, {}, 3.1),
    "glm4-9b|decode_32k|{m}": _cell(2.3e12, "memory", 190e9, {}, 0.8),
    "glm4-9b|long_500k|{m}": {"status": "SKIP", "reason": "full-attention arch"},
    "qwen2-moe-a2.7b|train_4k|{m}": _cell(9.9e15, "compute", 3.3e11, {"all_to_all": 96},
                                          40.0),
    "deepseek-67b|prefill_32k|{m}": {"status": "FAIL", "error": "x"},
    "rwkv6-1.6b|long_500k|{m}": _cell(1.9e9, "memory", 3.0e9, {}, 0.2),
}


def _write(tmp_path, mesh):
    path = tmp_path / f"{mesh}.json"
    path.write_text(json.dumps({k.format(m=mesh): v for k, v in DRYRUN.items()}))
    return str(path)


def test_generate_report_gives_the_reference_rows(tmp_path):
    port = roofline.generate_report(_write(tmp_path, "one_card"))["rows"]
    ref = jroofline.generate_report(_write(tmp_path, "single_pod"))["rows"]
    assert len(port) == len(ref) == len(DRYRUN)
    assert [r["status"] for r in port] == [r["status"] for r in ref]
    assert sorted(r["status"] for r in port) == ["FAIL", "OK", "OK", "OK", "OK", "SKIP"]
    by_key = {r["key"].rsplit("|", 1)[0]: r for r in ref}
    for row in port:
        want = by_key[row["key"].rsplit("|", 1)[0]]
        assert row["mesh"] == "one_card" and want["mesh"] == "single_pod"
        assert set(row) == set(want)
        for field in row:
            if field not in ("key", "mesh"):
                assert row[field] == want[field], (row["key"], field)


def test_report_md_prints_the_tables(tmp_path, capsys):
    report_md.main([_write(tmp_path, "one_card")])
    out = capsys.readouterr().out
    assert "### Dry-run matrix" in out and "### Roofline terms" in out
    assert "989 TF/s bf16, 3.35 TB/s HBM3" in out and "v5e" not in out
    assert "| glm4-9b | prefill_32k | one_card | OK | 3.1 | 56.81 |" in out
    assert "| deepseek-67b | prefill_32k | one_card | **FAIL** |" in out
    assert "| qwen2-moe-a2.7b | 14.00B | 2.38B |" in out
