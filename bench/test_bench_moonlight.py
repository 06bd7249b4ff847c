"""The Moonlight-16B-A3B cell's own files: its configuration against the
published config, its reference's counts at the cell's shape and weight
names against the port's, its tiny run (correct, and with the timed path
broken underneath each way not correct), and its control on the CPU."""

from __future__ import annotations

import json
import math

import pytest
import torch

from bench import common, tiny
from bench.drivers import lm
from bench.reference import moonlight
from bench.run import run_cell

CELL = "moonlight-16b-a3b.secure_prefill"
SEED = 2**31 + 4242


def _model():
    return json.loads((common.BENCH / "configs" / "moonlight-16b-a3b.json").read_text())["model"]


def _run():
    result, _ = run_cell(CELL, SEED, 1.0, False, device="cpu", adjust=tiny.shrink,
                         spec=tiny.with_unlisted(common.load_spec()))
    return result


def test_bench_moonlight_config_holds_the_published_config():
    """The file holds the source's config.json, key for key, beside the
    model the port runs; nothing is reduced."""
    conf = json.loads((common.BENCH / "configs" / "moonlight-16b-a3b.json").read_text())
    m = conf["model"]
    assert conf["reduced"] == [] and conf["reference_module"] == "moonlight"
    pairs = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
             "num_attention_heads": "n_heads", "intermediate_size": "d_ff",
             "moe_intermediate_size": "moe_d_ff", "vocab_size": "vocab_size",
             "n_routed_experts": "n_experts", "num_experts_per_tok": "n_experts_per_tok",
             "n_shared_experts": "n_shared_experts", "first_k_dense_replace": "first_dense_layers",
             "kv_lora_rank": "kv_lora_rank", "qk_nope_head_dim": "qk_nope_head_dim",
             "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
             "routed_scaling_factor": "routed_scaling", "rope_theta": "rope_theta",
             "rms_norm_eps": "norm_eps"}
    for src, port in pairs.items():
        assert conf[src] == m[port], src
    assert m["shared_d_ff"] == conf["n_shared_experts"] * conf["moe_intermediate_size"]
    assert conf["q_lora_rank"] is None and "q_lora_rank" not in m
    assert conf["tie_word_embeddings"] is False and m["separate_head"] is True
    assert conf["scoring_func"] == "sigmoid" and m["router"] == "sigmoid_bias"
    assert conf["n_group"] == conf["topk_group"] == 1 and conf["norm_topk_prob"] is True


def test_bench_moonlight_counts_from_shapes():
    """At the cell's shape (4 x 8,192 on 8 shards): 15.29e9 parameters in
    the layers (2.24e9 active a token), the exchange's 52 legs of
    1,015,021,568 bytes (capacity 484: 8 shards x 8 shards x 8 experts x 484
    x 2,048 x 2 B), causal attention 2 H (192 + 128) a pair, and the latent
    cache's 1.019 GB a prefill."""
    m = _model()
    total, active = moonlight.param_counts(m)
    assert 15.28e9 < total < 15.30e9 and 2.24e9 < active < 2.25e9
    assert moonlight.capacity(4096, 6, 64, 1.25) == 484
    assert moonlight.exchange_legs(m) == 52
    assert moonlight.leg_wire_bytes(m, 4, 8192, 8) == 8 * 8 * 8 * 484 * 2048 * 2
    pairs = 4 * 8192 * 8193 / 2
    assert moonlight.prefill_attention_flops(m, 4, 8192) == 2 * 16 * 320 * pairs * 27
    assert moonlight.prefill_flops(m, 4, 8192) == (2.0 * active * 4 * 8192 + 2 * 16 * 320 * pairs
                                                   * 27 + 2.0 * 163840 * 2048 * 4)
    assert 27 * 4 * 8192 * (512 + 64) * 2 / 1e9 == pytest.approx(1.019215872)


def test_bench_moonlight_weight_specs_cover_the_ports_names():
    """The reference's specs name every parameter of the port's model once
    (`layers.attn.*` over all layers, `layers.0.mlp.*`, `layers.1:<L>.moe.*`,
    the head), shapes equal; the router's bias drawn N(0, 0.01^2)."""
    from repro_torch.models.lm import LM

    m = dict(_model(), **tiny.TINY_MODEL)
    m.update(json.loads((common.BENCH / "configs" / "moonlight-16b-a3b.json").read_text())["tiny"])
    w = lm.make_weights(moonlight, m, 3, "cpu", 4)
    sd = lm.port_state_dict(w, m)
    model = LM(lm.arch_config(m), 4, "meta").state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in model.items()}
    bias = w["layers.1:3.moe.router_bias"]
    assert 0.005 < float(bias.std()) < 0.02


def _cache_unchanged(mp):
    from repro_torch.serve import engine

    mp.setattr(engine, "_store_kv", lambda *a: None)


def _plain_wire(mp):
    from repro_torch.core import shuffle

    mp.setattr(shuffle, "_crypt_wire_coalesced", lambda wire, *a, **k: wire)


def _unrotated_key(mp):
    from repro_torch.models import attention

    real = attention.mla_project

    def fault(cfg, params, x, positions):  # the shared key left unrotated
        q, c, _ = real(cfg, params, x, positions)
        return q, c, (x @ params.wkva.to(x.dtype))[..., None, cfg.kv_lora_rank:]

    mp.setattr(attention, "mla_project", fault)


def _bias_ignored(mp):
    from repro_torch.models import moe

    real = moe._route
    mp.setattr(moe, "_route", lambda cfg, w, x2, e_pad, bias=None:
               real(cfg, w, x2, e_pad, None if bias is None else torch.zeros_like(bias)))


def _shared_dropped(mp):
    from repro_torch.models import moe

    real = moe._shared_expert
    mp.setattr(moe, "_shared_expert", lambda cfg, sp, x2: 0.0 * real(cfg, sp, x2))


def test_bench_moonlight_cell_correct_on_cpu():
    result = _run()
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [_cache_unchanged, _plain_wire, _unrotated_key,
                                   _bias_ignored, _shared_dropped])
def test_bench_moonlight_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not _run()["correct"]


def test_bench_moonlight_fp8_control_is_not_correct():
    """The reference in fp8 e4m3 in the program's place, under the cell's
    own limits, at a size a test run holds: the layers the check reads
    (`moonlight.checked_layers`: the dense first layer and two more), its
    64 experts, top 6, its router and scaling, widths cut (d_model 256, 4
    heads of r 64, nope 32, rope 16, v 32)."""
    cs = common.cell_spec(CELL)
    m = dict(cs["config"]["model"], d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
             moe_d_ff=64, shared_d_ff=128, vocab_size=1024, kv_lora_rank=64,
             qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, attn_chunk=0)
    m["n_layers"] = moonlight.checked_layers(m)
    w = lm.make_weights(moonlight, m, 3, "cpu", 8)
    toks = lm.prompts(m, 3, "c", 2, 64, "cpu")
    kw = dict(logit_positions=[63], shards=8, prompt_len=64)
    kept, numbers = {}, {"cache_rel_err": 0.0, "wire_faults": 0.0}
    moonlight.forward(w, m, toks, cache_sink=kept.__setitem__, **kw)

    def sink(layer, tensors):
        for name, got in tensors.items():
            numbers["cache_rel_err"] = max(numbers["cache_rel_err"],
                                           lm.rel_err(got, kept[layer][name]))

    moonlight.forward(w, m, toks, quant="fp8", cache_sink=sink, **kw)
    assert sorted(kept) == [0, 1, 2]
    correct, checks = common.judge(numbers, cs["limits"])
    assert not correct, checks
    assert all(math.isfinite(v) for v in numbers.values())
