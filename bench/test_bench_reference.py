"""The frozen plain references: ChaCha20 against RFC 8439's vectors, and
Lloyd's k-means and the granite-moe forward against the port at a tiny
size on the CPU (the tests may import the port; the references may not)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench import tiny
from bench.drivers import lm
from bench.reference import chacha20, granite_moe
from bench.reference import kmeans as ref_kmeans

RFC_KEY = bytes(range(32))
RFC_BLOCK_232 = [0xE4E7F110, 0x15593BD1, 0x1FDD0F50, 0xC47120A3, 0xC7F4D1C7, 0x0368C033,
                 0x9AAA2204, 0x4E6CD4C3, 0x466482D2, 0x09AA9F07, 0x05D7C214, 0xA2028BD9,
                 0xD19C12B5, 0xB94E16DE, 0xE883D0CB, 0x4E3C50A2]
RFC_PLAINTEXT = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
                 b"only one tip for the future, sunscreen would be it.")
RFC_CIPHERTEXT = bytes.fromhex(
    "6e2e359a2568f98041ba0728dd0d6981e97e7aec1d4360c20a27afccfd9fae0b"
    "f91b65c5524733ab8f593dabcd62b3571639d624e65152ab8f530c359f0861d8"
    "07ca0dbf500d6a6156a38e088a22b65e52bc514d16ccf806818ce91ab7793736"
    "5af90bbf74a35be6b40b8eedf2785e42874d")


def test_bench_chacha20_block_rfc8439_232():
    nonce = chacha20.words_from_bytes(bytes.fromhex("000000090000004a00000000"))
    got = chacha20.keystream(chacha20.words_from_bytes(RFC_KEY), torch.tensor(nonce),
                             torch.tensor(1))
    assert got.tolist() == RFC_BLOCK_232


def test_bench_chacha20_encryption_rfc8439_242():
    nonce = bytes.fromhex("000000000000004a00000000")
    assert chacha20.xor_bytes(RFC_KEY, nonce, 1, RFC_PLAINTEXT) == RFC_CIPHERTEXT
    assert chacha20.xor_bytes(RFC_KEY, nonce, 1, RFC_CIPHERTEXT) == RFC_PLAINTEXT


def test_bench_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-12, 1.0 + 2.0**-11 + 2.0**-13, -3.0])
    got = ref_kmeans.tf32_round(x)
    assert got.tolist() == [1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-10, -3.0]


@pytest.mark.parametrize("secure", [False, True])
def test_bench_lloyd_matches_port_kmeans_fit(secure):
    from repro_torch.core.kmeans import kmeans_fit
    from repro_torch.core.shuffle import SecureShuffleConfig
    from repro_torch.mesh import VirtualMesh

    g = torch.Generator().manual_seed(7)
    centres = torch.rand((6, 5), generator=g) * 0.8 + 0.1
    pts = (centres[torch.randint(0, 6, (800,), generator=g)]
           + 0.05 * torch.randn((800, 5), generator=g)).contiguous()
    init = pts[torch.randperm(800, generator=g)[:6]].contiguous()
    sec = SecureShuffleConfig(key_words=np.arange(8, dtype=np.uint32),
                              nonce_words=np.arange(3, dtype=np.uint32)) if secure else None
    got = kmeans_fit(pts, 6, VirtualMesh(4, "cpu"), secure=sec, init_centers=init)
    thr = ref_kmeans.paper_threshold(pts)
    history, shifts, _, n = ref_kmeans.fit(pts, init, threshold=thr, max_rounds=200)
    assert got.n_iter == n == len(shifts)
    assert torch.allclose(got.centers, history[-1], atol=1e-5)
    np.testing.assert_allclose(got.center_shift, shifts, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("secure", [False, True])
def test_bench_granite_reference_matches_port_prefill(secure):
    from repro_torch.mesh import VirtualMesh
    from repro_torch.serve.engine import init_cache, prefill

    cs = {"config": {"model": dict(_granite_model()), "deployment": {"shards": 4,
                                                                      "secure_moe": secure}},
          "traffic": {"kind": "prefill", "batch": 2, "prompt_tokens": 16}}
    cell = lm.LMBase(cs, seed=11, device="cpu", rec=None)
    cell.build(VirtualMesh(4, "cpu"))
    toks = lm.prompts(cell.m, 11, "t", 2, 16, "cpu")
    cache = init_cache(cell.cfg, 2, 16, "cpu")
    got = prefill(cell.cfg, cell.model, toks, cache, mesh=cell.mesh, secure_moe=cell.secure)
    kv = {}
    want = cell.reference(toks, [15], cache_sink=kv.__setitem__)[:, 0]
    assert lm.rel_err(got[:, :cell.m["vocab_size"]], want) < 1e-5
    assert len(kv) == cell.m["n_layers"]
    for i, tensors in kv.items():
        assert set(tensors) == {"k", "v"}
        for name, want in tensors.items():
            assert lm.rel_err(cache[name][i], want) < 1e-5


def test_bench_granite_reference_drops_past_capacity():
    """Every token routed to expert 0: each shard keeps `capacity` entries,
    the earliest, and the rest add nothing."""
    m = dict(_granite_model(), n_layers=1)
    n, shards = 32, 4
    cap = granite_moe.capacity(n // shards, m["n_experts_per_tok"], m["n_experts"],
                               m["capacity_factor"])
    lw = {"moe.router": torch.zeros(m["d_model"], m["n_experts"]),
          "moe.wi": torch.ones(m["n_experts"], m["d_model"], 4),
          "moe.wg": torch.ones(m["n_experts"], m["d_model"], 4),
          "moe.wo": torch.ones(m["n_experts"], 4, m["d_model"])}
    lw["moe.router"][:, 0] = 10.0
    h = torch.full((1, n, m["d_model"]), 0.01)
    y = granite_moe._moe(m, lw, h, None, shards=shards, prompt_len=n, factor=m["capacity_factor"])
    kept = (y.abs().sum(-1) > 0)[0].reshape(shards, -1)
    assert cap < n // shards
    assert kept[:, :cap].all() and not kept[:, cap:].any()


def _granite_model():
    import json

    from bench.common import BENCH

    m = json.loads((BENCH / "configs" / "granite-moe-3b-a800m.json").read_text())["model"]
    return dict(m, **tiny.TINY_MODEL)
