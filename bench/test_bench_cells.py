"""Each cell run end to end at a tiny size on the CPU (the harness's look for
a card skipped): `correct` is true; and with the timed path broken
underneath in each way the cell can be, `correct` comes out false."""

from __future__ import annotations

import pytest
import torch

from bench import common, tiny
from bench.run import run_cell

KMEANS = "kmeans-d64-k256.large_jobs"
PREFILL = "granite-moe-3b-a800m.secure_prefill"
DECODE = tiny.DECODE
SEED = 2**31 + 12345  # past 32 signed bits, as seeds may be


def _run(workload, seed=SEED):
    result, _ = run_cell(workload, seed, 1.0, False, device="cpu", adjust=tiny.shrink,
                         spec=tiny.with_unlisted(common.load_spec()))
    return result


@pytest.mark.parametrize("workload", [KMEANS, "kmeans-d64-k256.small_jobs", PREFILL, DECODE])
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
