"""Each cell run end to end at a tiny size on the CPU (the harness's look for
a card skipped): `correct` is true; and with the timed path broken
underneath in each way the cell can be, `correct` comes out false."""

from __future__ import annotations

import collections
import json
import sys
import types

import pytest
import torch

from bench import common, tiny
from bench.drivers import prefill
from bench.run import run_cell

KMEANS = "kmeans-d64-k256.large_jobs"
PREFILL = "granite-moe-3b-a800m.secure_prefill"
DECODE = tiny.DECODE
SEED = 2**31 + 12345  # past 32 signed bits, as seeds may be


def _run(workload, seed=SEED):
    result, _ = run_cell(workload, seed, 1.0, False, device="cpu", adjust=tiny.shrink,
                         spec=tiny.with_unlisted(common.load_spec()))
    return result


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      tiny.with_unlisted(common.load_spec())["workloads"]])
def test_bench_cell_correct_on_cpu(workload):
    result = _run(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(m["value"] >= 0 for m in result["metrics"].values())


def _state_unchanged(mp):
    from repro_torch.core import kmeans

    real = kmeans._reduce_centers

    def fault(centers, rk, rv, valid, *, mesh):
        new, shift = real(centers, rk, rv, valid, mesh=mesh)
        return centers.expand_as(new), torch.zeros_like(shift)

    mp.setattr(kmeans, "_reduce_centers", fault)


def _half_batch(mp):
    from repro_torch.core import kmeans

    real = kmeans._assign_partials

    def fault(points, weights, centers, impl):
        w = weights.clone()
        w[:, w.shape[1] // 2:] = 0.0
        return real(points, w, centers, impl)

    mp.setattr(kmeans, "_assign_partials", fault)


def _plain_wire(mp):
    from repro_torch.core import shuffle

    mp.setattr(shuffle, "_crypt_wire_coalesced", lambda wire, *a, **k: wire)


def _answer_altered(mp):
    from repro_torch.core import kmeans

    real = kmeans._reduce_centers

    def fault(centers, rk, rv, valid, *, mesh):
        new, shift = real(centers, rk, rv, valid, mesh=mesh)
        new = new.clone()
        new[:, 0] += 0.2
        return new, shift

    mp.setattr(kmeans, "_reduce_centers", fault)


def _keystream_reused(mp):
    from repro_torch.serve import service

    real = service.SecureJobService._submit

    def fault(self, *a, **k):
        self._round_base = 0  # every job encrypts under the same round ids
        return real(self, *a, **k)

    mp.setattr(service.SecureJobService, "_submit", fault)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _plain_wire, _answer_altered,
                                   _keystream_reused])
def test_bench_kmeans_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not _run(KMEANS)["correct"]


def _cache_unchanged(mp):
    from repro_torch.serve import engine

    mp.setattr(engine, "_store_kv", lambda *a: None)


def _decode_cache_unchanged(mp):
    from repro_torch.models import attention

    real = attention.decode_self_attention
    mp.setattr(attention, "decode_self_attention",
               lambda cfg, p, x, k, v, pos: real(cfg, p, x, k.clone(), v.clone(), pos))


def _lm_half_batch(mp):
    from repro_torch.serve import engine

    real = engine.embed_apply

    def fault(cfg, params, tokens):
        x = real(cfg, params, tokens)
        half = x.shape[0] // 2
        return torch.cat([x[:half], x[:half]])[:x.shape[0]]

    mp.setattr(engine, "embed_apply", fault)


def _token_altered(mp):
    from repro_torch.serve import engine

    real = engine.unembed_apply

    def fault(cfg, params, x):
        out = real(cfg, params, x).clone()
        out[..., 7] += 50.0
        return out

    mp.setattr(engine, "unembed_apply", fault)


@pytest.mark.parametrize("fault", [_cache_unchanged, _lm_half_batch, _plain_wire,
                                   _token_altered])
def test_bench_prefill_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not _run(PREFILL)["correct"]


@pytest.mark.parametrize("fault", [_decode_cache_unchanged, _lm_half_batch, _token_altered])
def test_bench_decode_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not _run(DECODE)["correct"]


def _run_prefill_through(mp, tmp_path, module):
    """The tiny prefill cell run with a configuration of 3 layers whose file
    names `module` (a test-only `bench.reference.<name>`) as its reference."""
    name = module.__name__.rsplit(".", 1)[1]
    mp.setitem(sys.modules, module.__name__, module)
    config = json.loads((common.BENCH / "configs" / "granite-moe-3b-a800m.json").read_text())
    config.update(name=name, reference_module=name, tiny={"n_layers": 3})
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(config))
    spec = tiny.with_unlisted(common.load_spec())
    spec["configs"] = spec["configs"] + [dict(spec["configs"][-1], name=name, file=str(path))]
    spec["workloads"] = [dict(w, config=name) if w["name"] == PREFILL else w
                         for w in spec["workloads"]]
    result, _ = run_cell(PREFILL, SEED, 1.0, False, device="cpu", adjust=tiny.shrink, spec=spec)
    return result


def test_bench_lm_driver_takes_the_configs_reference_module(monkeypatch, tmp_path):
    """A language model enters by files of its own: a configuration whose
    file names another reference module (and tiny sizes of its own) runs
    the prefill cell through that module. Here a test-only module that
    re-exports granite_moe's functions under another name, counting calls."""
    from bench.reference import granite_moe

    calls = collections.Counter()
    alias = types.ModuleType("bench.reference.granite_alias")
    for name in ("weight_specs", "forward", "prefill_flops", "prefill_attention_flops",
                 "decode_step_flops", "exchange_legs", "leg_wire_bytes"):
        def counted(*a, _real=getattr(granite_moe, name), _name=name, **k):
            calls[_name] += 1
            if _name == "exchange_legs":
                calls["n_layers"] = a[0]["n_layers"]
            return _real(*a, **k)
        setattr(alias, name, counted)
    result = _run_prefill_through(monkeypatch, tmp_path, alias)
    assert result["correct"], result["checks"]
    assert calls["weight_specs"] >= 2 and calls["forward"] >= 2  # the model's, the check's
    assert calls["exchange_legs"] >= 1 and calls["leg_wire_bytes"] >= 1
    assert calls["n_layers"] == 3


def test_bench_lm_harness_loads_per_layer_and_range_weights(monkeypatch, tmp_path):
    """A reference module may name one layer's tensor (`layers.0.<name>`)
    and stack a range of layers (`layers.1:<L>.<name>`), as a model whose
    first layer differs would: the port's strict load takes every name, and
    the cell is correct. Here a test-only module that draws granite's layer
    0 and layers 1..L-1 apart and joins them back for granite's forward."""
    from bench.reference import granite_moe

    split = types.ModuleType("bench.reference.granite_split")
    seen = []

    def weight_specs(m, shards):
        n, out = m["n_layers"], {}
        for name, (shape, kind, fan_in) in granite_moe.weight_specs(m, shards).items():
            if not name.startswith("layers."):
                out[name] = (shape, kind, fan_in)
                continue
            rest = name[len("layers."):]
            out[f"layers.0.{rest}"] = (shape[1:], kind, fan_in)
            out[f"layers.1:{n}.{rest}"] = ((n - 1, *shape[1:]), kind, fan_in)
        seen.append(sorted(out))
        return out

    def forward(W, m, tokens, **kw):
        n = m["n_layers"]
        joined = {k: v for k, v in W.items() if not k.startswith("layers.")}
        for k, v in W.items():
            if k.startswith("layers.0."):
                rest = k[len("layers.0."):]
                joined[f"layers.{rest}"] = torch.cat([v[None], W[f"layers.1:{n}.{rest}"]])
        return granite_moe.forward(joined, m, tokens, **kw)

    split.weight_specs, split.forward = weight_specs, forward
    for name in ("prefill_flops", "prefill_attention_flops", "decode_step_flops",
                 "exchange_legs", "leg_wire_bytes"):
        setattr(split, name, getattr(granite_moe, name))
    result = _run_prefill_through(monkeypatch, tmp_path, split)
    assert result["correct"], result["checks"]
    assert seen and "layers.0.moe.wi" in seen[0] and "layers.1:3.moe.wi" in seen[0]
    assert all(k.split(".")[1][0].isdigit() for k in seen[0] if k.startswith("layers."))


def test_bench_prefill_cache_check_compares_tensors_by_name():
    """The check compares each cache tensor the reference names with the
    program's of the same name, over the prompt's positions, and fails
    loudly on a name the program's cache lacks."""
    cell = prefill.Cell.__new__(prefill.Cell)
    want = torch.ones((2, 4, 3))
    kept = torch.zeros((2, 2, 6, 3))  # (L, B, S, ...)
    kept[1, :, :4] = 1.0
    kept[1, 0, 0, 0] = 1.0 + 0.5  # one element off in layer 1's "latent"
    cell.kept = {"latent": kept, "k": torch.zeros((2, 2, 6, 3))}
    numbers = {"cache_rel_err": 0.0}
    sink = cell._cache_sink(numbers)
    sink(1, {"latent": want})
    assert numbers["cache_rel_err"] == pytest.approx(0.5 / 24 ** 0.5)
    sink(1, {"k": want})
    assert numbers["cache_rel_err"] == pytest.approx(1.0)
    with pytest.raises(KeyError):
        sink(0, {"v": want})
