"""Each cell's control: the plain reference put in the program's place at
the nearest precision below the configuration's comes out not correct
under the cell's own limits. Here at a size a test run holds on the CPU;
at the cell's own size on the card (marked `gpu`, through
`bench/readings.py`'s control path)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bench import common, tiny
from bench.drivers import jobs, lm
from bench.reference import kmeans as ref_kmeans

KMEANS = ("kmeans-d64-k256.large_jobs", "kmeans-d64-k256.small_jobs")
LM_CELLS = ("granite-moe-3b-a800m.secure_prefill", "granite-moe-3b-a800m.decode")


def _points(seed: int, n: int, k: int = 256, d: int = 64):
    g = torch.Generator().manual_seed(seed)
    true_c = torch.rand((k, d), generator=g) * 0.8 + 0.1
    pts = (true_c[torch.randint(0, k, (n,), generator=g)]
           + 0.05 * torch.randn((n, d), generator=g)).contiguous()
    return pts, pts[torch.randperm(n, generator=g)[:k]].contiguous()


@pytest.mark.parametrize("workload", KMEANS)
@pytest.mark.parametrize("seed", [1, 2])
def test_bench_kmeans_tf32_control_is_not_correct(workload, seed):
    pts, init = _points(seed, 60_000)
    thr = ref_kmeans.paper_threshold(pts)
    history, _, _, n = ref_kmeans.fit(pts, init, threshold=thr, max_rounds=64,
                                      precision="tf32")
    gap, _ = jobs.step_check(history[:n], n < 64, pts, init, 64)
    numbers = {"centers_step_gap": gap, "wire_faults": 0.0, "job_faults": 0.0}
    correct, checks = common.judge(numbers, common.read_json("limits", workload))
    assert not correct, checks


@pytest.mark.parametrize("workload", LM_CELLS)
def test_bench_lm_fp8_control_is_not_correct(workload):
    cs = common.cell_spec(workload, tiny.with_unlisted(common.load_spec()))
    m = dict(cs["config"]["model"], n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
             moe_d_ff=64, d_ff=64, vocab_size=1024, attn_chunk=0)
    ref_lm = lm.reference_module(cs["config"])
    w = lm.make_weights(ref_lm, m, 3, "cpu", 8)
    toks = lm.prompts(m, 3, "c", 2, 64, "cpu")
    pos = list(range(32, 64))
    kw = dict(logit_positions=pos, shards=8, prompt_len=64)
    ref = ref_lm.forward(w, m, toks, **kw)
    got = ref_lm.forward(w, m, toks, quant="fp8", **kw)
    numbers = {"logits_rel_err": lm.rel_err(got, ref), "wire_faults": 0.0,
               "cache_rel_err": 0.0}
    correct, checks = common.judge(numbers, cs["limits"])
    assert not correct, checks


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in common.load_spec()["workloads"]])
def test_bench_control_at_cell_size_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    proc = subprocess.run([sys.executable, str(common.BENCH / "readings.py"), "--workload",
                           workload, "--seconds", "3", "--control-seeds", "2147483649"],
                          capture_output=True, text=True, cwd=common.ROOT, timeout=1200)
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    correct, checks = common.judge(dict(line["control"], wire_faults=0.0),
                                   common.read_json("limits", workload))
    assert not correct, checks
