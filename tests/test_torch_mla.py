"""Moonlight-16B-A3B's mechanisms in the port against the benchmark's plain
reference (`bench/reference/moonlight.py`), on the CPU, without JAX for the
model itself.

The model is the benchmark's configuration file at its `tiny` sizes
(`bench.tiny.shrink`: float32, 3 layers, the first dense, d_model 64, 4
heads of latent attention with r 32, nope 16, rope 8, v 16, 32 experts
top 6 and a shared expert), its weights drawn by the benchmark from a seed, the
experts on a `VirtualMesh` of 4 shards, the exchange encrypted. The same
weights go to the reference, whose equations are written apart from the
port's.

Tolerances. Logits and cache entries: relative (Frobenius) error 1e-5.
Both sides compute in float32 with TF32 off; they differ only in the order
of their sums (the port's latent expansion and absorbed decode against the
reference's per-block attention; the port's combine in slot order), which
moves float32 results by ~1e-7 relative: 1e-5 leaves two orders of room and
fails at once on any mathematical departure (a missing rotation, scale or
norm reads ~1e-1). Integers exactly: the experts chosen, the dropped
entries, the counts of kernel calls, spans and cache bytes.
"""

from __future__ import annotations

import sys
from dataclasses import fields, replace
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = str(Path(__file__).resolve().parents[1])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench import common, tiny  # noqa: E402
from bench.drivers import lm as lm_drv  # noqa: E402
from bench.reference import moonlight as ref  # noqa: E402
from repro_torch import VirtualMesh  # noqa: E402
from repro_torch.configs import ALL_ARCH_IDS, ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import kernel_calls  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.lm import LM, forward, layer_kind  # noqa: E402
from repro_torch.serve.engine import decode_step, init_cache, prefill  # noqa: E402
from repro_torch.tools.opcount import counters, spans  # noqa: E402

CELL = "moonlight-16b-a3b.secure_prefill"
TOL = 1e-5
B, T, SHARDS = 2, 16, 4
SEED = 2**31 + 77


def _cell(seed=SEED, **model):
    """The tiny Moonlight model built on the mesh from the seed's weights
    (`bench.drivers.lm.LMBase`), `model` overriding its sizes."""
    cs = common.cell_spec(CELL)
    tiny.shrink(cs)
    cs["config"]["model"].update(model)
    cell = lm_drv.LMBase(cs, seed=seed, device="cpu", rec=None)
    cell.build(VirtualMesh(SHARDS, "cpu"))
    return cell


def _tokens(cell, n, tag="t"):
    return lm_drv.prompts(cell.m, cell.seed, tag, B, n, "cpu")


def _ref_logits(cell, toks, positions, **kw):
    return cell.reference(toks, positions, **kw)


def test_config_is_the_published_one():
    """The port's config at the source's sizes, and the benchmark's model
    entry the same config."""
    cfg = get_config("moonlight-16b-a3b")
    assert "moonlight-16b-a3b" in ALL_ARCH_IDS and "moonlight-16b-a3b" not in ARCH_IDS
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab_size) == (27, 2048, 16, 163840)
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim) == (512, 128, 64, 128)
    assert (cfg.n_experts, cfg.n_experts_per_tok, cfg.moe_d_ff, cfg.n_shared_experts,
            cfg.shared_d_ff, cfg.d_ff, cfg.first_dense_layers) == (64, 6, 1408, 2, 2816,
                                                                  11264, 1)
    assert (cfg.router, cfg.routed_scaling, cfg.shared_expert_gate, cfg.separate_head,
            cfg.norm_eps, cfg.rope_theta) == ("sigmoid_bias", 2.446, False, True, 1e-5,
                                               50000.0)
    bench_cfg = lm_drv.arch_config(common.cell_spec(CELL)["config"]["model"])
    assert {f.name: getattr(bench_cfg, f.name) for f in fields(cfg) if f.name != "source"} \
        == {f.name: getattr(cfg, f.name) for f in fields(cfg) if f.name != "source"}
    assert [layer_kind(cfg, i) for i in range(3)] == ["attn", "moe", "moe"]


def test_engine_prefill_then_decode_matches_the_reference():
    """A prefill's last-token logits and its latent cache (`ckv`, `kpe`),
    then each of 3 decode steps' logits against the reference's full
    forward at that position (the decoded tokens never dropped, on either
    side)."""
    cell = _cell()
    toks = _tokens(cell, T + 3)
    cache = init_cache(cell.cfg, B, T + 3, "cpu")
    assert set(cache) == {"pos", "ckv", "kpe"}
    assert cache["ckv"].shape == (3, B, T + 3, 32) and cache["kpe"].shape == (3, B, T + 3, 8)
    got = [prefill(cell.cfg, cell.model, toks[:, :T], cache, mesh=cell.mesh,
                   secure_moe=cell.secure)]
    kept = {}
    want = _ref_logits(cell, toks[:, :T], [T - 1], cache_sink=kept.__setitem__)[:, 0]
    v = cell.m["vocab_size"]
    assert lm_drv.rel_err(got[0][:, :v], want) < TOL
    assert sorted(kept) == [0, 1, 2]
    for layer, tensors in kept.items():
        assert set(tensors) == {"ckv", "kpe"}
        for name, w in tensors.items():
            assert lm_drv.rel_err(cache[name][layer, :, :T], w) < TOL, (layer, name)
            assert not cache[name][layer, :, T:].any()
    for j in range(3):
        got.append(decode_step(cell.cfg, cell.model, cache, toks[:, T + j:T + j + 1],
                               mesh=cell.mesh))
    full = _ref_logits(cell, toks, list(range(T, T + 3)))
    for j in range(3):
        assert lm_drv.rel_err(got[j + 1][:, :v], full[:, j]) < TOL, j
    assert torch.equal(cache["pos"], torch.full((B,), T + 3, dtype=torch.int32))


@pytest.mark.parametrize("grad", [False, True])
def test_lm_forward_matches_the_reference(grad):
    """`lm.forward`'s logits at every position: with no gradient (the slot
    map's dispatch) and with one (the k-fold broadcast, training's path)."""
    cell = _cell()
    toks = _tokens(cell, T)
    with torch.set_grad_enabled(grad):
        logits, aux = forward(cell.cfg, cell.model, {"tokens": toks}, mesh=cell.mesh,
                              secure_moe=cell.secure)
    want = _ref_logits(cell, toks, list(range(T)))
    assert lm_drv.rel_err(logits[..., :cell.m["vocab_size"]].detach(), want) < TOL
    stats = {}
    _ref_logits(cell, toks, [T - 1], stats=stats)
    assert int(aux["moe_dropped"]) == stats["dropped"]


def _router_case(e_pad=8, n=64, d=16, seed=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g)
    w = torch.randn((d, e_pad), generator=g) * 0.5
    bias = torch.randn((e_pad,), generator=g) * 0.3
    return x, w, bias


def _ref_route(cfg, x, w, bias):
    m = {"n_experts": cfg.n_experts, "n_experts_per_tok": cfg.n_experts_per_tok,
         "routed_scaling": cfg.routed_scaling}
    return ref._route(m, {"moe.router": w, "moe.router_bias": bias}, x, None)


def test_sigmoid_bias_router_picks_the_reference_experts():
    """The experts are the top k of the biased scores, exactly the
    reference's; the bias changes the choice but not the gates, which are
    the unbiased scores of the chosen experts, renormalised, times
    `routed_scaling`."""
    cfg = replace(get_config("moonlight-16b-a3b"), n_experts=8, n_experts_per_tok=2)
    x, w, bias = _router_case()
    gates, experts, _ = tmoe._route(cfg, w, x, 8, bias)
    want_g, want_e = _ref_route(cfg, x, w, bias)
    assert torch.equal(experts.long(), want_e)
    torch.testing.assert_close(gates, want_g, rtol=1e-6, atol=1e-6)
    unbiased_g, unbiased_e, _ = tmoe._route(cfg, w, x, 8, torch.zeros(8))
    assert not torch.equal(unbiased_e, experts)  # the bias moved some choices
    scores = torch.sigmoid(x @ w)
    picked = torch.gather(scores, -1, experts.long())
    torch.testing.assert_close(gates, picked / picked.sum(-1, keepdim=True) * 2.446)


def test_sigmoid_bias_router_ties_go_to_the_lower_index_and_padding_never_wins():
    """Two experts of equal biased score: the lower index first, as the
    reference's stable sort; a padding expert (past `n_experts`) is never
    chosen, whatever its bias."""
    cfg = replace(get_config("moonlight-16b-a3b"), n_experts=6, n_experts_per_tok=2)
    x, w, bias = _router_case(e_pad=8)
    w[:, 4] = w[:, 1]  # experts 1 and 4 score alike on every token
    bias[4] = bias[1] = 5.0  # ... and win
    bias[6:] = 100.0  # padding
    _, experts, _ = tmoe._route(cfg, w, x, 8, bias)
    assert torch.equal(experts, torch.tensor([[1, 4]] * x.shape[0], dtype=torch.int32))
    assert torch.equal(experts.long(), _ref_route(cfg, x, w, bias)[1])


def test_dropped_entries_equal_the_references_count():
    """A bias that sends most tokens to two experts makes them drop past
    capacity: the port's `moe.dropped_entries` over a prefill equals the
    reference's count, and `moe.routed_entries` counts the MoE layers
    only (B·T·k each)."""
    cell = _cell()
    for i in (1, 2):
        bias = cell.model.layers[i].moe.router_bias
        bias.zero_()
        bias[0] = bias[3] = 1.0
    toks = _tokens(cell, T)
    cache = init_cache(cell.cfg, B, T, "cpu")
    with counters.recording() as counts:
        prefill(cell.cfg, cell.model, toks, cache, mesh=cell.mesh, secure_moe=cell.secure)
    weights = cell.weights()
    for name in ("layers.1:3.moe.router_bias",):
        weights[name].zero_()
        weights[name][:, 0] = weights[name][:, 3] = 1.0
    stats = {}
    cell.reference(toks, [T - 1], weights=weights, stats=stats)
    assert stats["dropped"] > 0
    assert counts["moe.dropped_entries"] == stats["dropped"]
    k = cell.cfg.n_experts_per_tok
    assert counts["moe.routed_entries"] == stats["routed"] == 2 * B * T * k


def test_prefill_calls_spans_and_cache_bytes():
    """A prefill: one attention kernel call a layer, one dispatch and one
    combine a MoE layer, none of them in a decode step; the spans
    `mla.expand` (a layer) inside `engine.attention` and `moe.shared` (a
    MoE layer); `engine.cache_bytes` = L·B·T·(r + rope)·itemsize, the
    latent cache's."""
    cell = _cell()
    toks = _tokens(cell, T + 1)
    cache = init_cache(cell.cfg, B, T + 1, "cpu")
    with kernel_calls.recording() as calls, spans.recording() as recorded, \
            counters.recording() as counts:
        prefill(cell.cfg, cell.model, toks[:, :T], cache, mesh=cell.mesh,
                secure_moe=cell.secure)
    assert calls["attention_prefill"] == 3
    assert calls["moe_dispatch"] == calls["moe_combine"] == 2
    names = [s[0] for s in recorded]
    assert names.count("mla.expand") == 3 and names.count("moe.shared") == 2
    assert names.count("engine.attention") == 3
    assert {s[3]["parent"] for s in recorded if s[0] == "mla.expand"} == {"engine.attention"}
    assert counts["engine.cache_bytes"] == 3 * B * T * (32 + 8) * 4
    with kernel_calls.recording() as dec:
        decode_step(cell.cfg, cell.model, cache, toks[:, T:], mesh=cell.mesh)
    assert not any(dec.get(k, 0) for k in ("attention_prefill", "moe_dispatch", "moe_combine"))


def test_granite_counts_its_kv_cache_bytes():
    """Every model counts what a prefill writes into its cache: granite's K
    and V, L·B·T·2·Hkv·Dh·itemsize."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    model = LM(cfg, 1, "cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.1)
    cache = init_cache(cfg, B, T, "cpu")
    with counters.recording() as counts:
        prefill(cfg, model, torch.zeros((B, T), dtype=torch.int32), cache)
    assert counts["engine.cache_bytes"] == cfg.n_layers * B * T * 2 * cfg.n_kv_heads * \
        cfg.head_dim * 4


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"])
def test_existing_configs_build_the_reference_parameter_tree(arch):
    """The new fields left at their defaults change nothing of an existing
    model: at the reduced and the published sizes, the port builds exactly
    the parameter names and shapes of the JAX reference's tree, and its
    cache holds the same tensors."""
    import jax

    from repro.models import lm as jlm

    def flat(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", tuple(v.shape)

    for cfg in (get_config(arch).reduced(), get_config(arch)):
        n = 8
        tree = jax.eval_shape(lambda k: jlm.init_params(cfg, k, n), jax.random.key(0))
        want = {name: shape for name, shape in flat({k: v for k, v in tree.items()
                                                     if k != "layers"})}
        for name, shape in flat(tree["layers"]):  # stacked on a leading layer axis
            want.update({f"layers.{i}.{name}": shape[1:] for i in range(cfg.n_layers)})
        model = LM(cfg, n, "meta").state_dict()
        assert {k: tuple(v.shape) for k, v in model.items()} == want
        assert set(init_cache(cfg, 1, 4, "meta")) == {"pos", "k", "v"}
