"""Port LM serving (repro_torch.serve.engine, repro_torch.models.lm) against the
JAX reference (repro.serve.engine, repro.models.lm).

Every dense, vlm and moe config, reduced, with capacity_factor 8.0 as the
reference's own serving test has it: prefill and two decode steps from the
reference's weights (`convert.lm_params`) give the reference's logits and
KV cache. Secure MoE serving on a mesh of R=1 (in process) and R=4 (a
subprocess with forced host devices; its results come back in an npz) gives
the reference's prefill and decode logits on a ("data", "model") mesh of
Auto axes, the only mesh on which the reference's secure prefill runs, and
per layer the wire records of the reference's one traced layer; the port's
secure prefill equals its plain prefill bit for bit.

Tolerances: logits and caches within rtol/atol 1e-4 (float32; the
reference's own serving test allows 2e-3); cache positions and wire
records exactly.
"""

import json
import os
from dataclasses import replace
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from conftest import run_in_subprocess
from repro import compat
from repro.core import shuffle as jsh
from repro.crypto import chacha as jch
from repro.models import lm as jlm
from repro.serve import engine as jeng
from repro_torch import VirtualMesh
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params, secure_config
from repro_torch.core import shuffle as tsh
from repro_torch.models.lm import LM, forward
from repro_torch.serve import decode_step, init_cache, prefill

TOL = dict(rtol=1e-4, atol=1e-4)
B, TP, SMAX = 2, 16, 24
SERVED = [a for a in ARCH_IDS if get_config(a).family in ("dense", "vlm", "moe")]
KW = jch.key_to_words(bytes(range(32)))
NW = jch.nonce_to_words(b"\x07" * 12)
COUNTER0 = 9
RECORD_FIELDS = ("secure", "bytes", "wire_bytes", "pad_bytes", "leaves", "coalesced",
                 "collectives", "keystream_launches", "keystream_blocks")


def serve_cfg(arch):
    return replace(get_config(arch).reduced(), capacity_factor=8.0)


def prompt(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, TP + 2)).astype(np.int32)


def ref_weights(cfg, n_model=1):
    tree = jax.jit(lambda k: jlm.init_params(cfg, k, n_model))(jax.random.key(0))
    return jax.tree.map(np.array, tree)


def port_model(cfg, np_params, n_model=1):
    model = LM(cfg, n_model, "cpu")
    model.load_state_dict(lm_params(cfg, np_params, n_model))
    return model


def records(recs):
    return [{f: r[f] for f in RECORD_FIELDS} for r in recs]


def ref_serve(cfg, np_params, toks, mesh=None, secure=None) -> dict:
    """The reference's prefill and two decode steps (jitted), with the wire
    records each traced; also its cache after the last step."""
    params = jax.tree.map(jnp.asarray, np_params)
    pre = jax.jit(lambda p, t, c: jeng.prefill(cfg, p, t, c, mesh=mesh, secure_moe=secure))
    dec = jax.jit(lambda p, c, t: jeng.decode_step(cfg, p, c, t, mesh=mesh))
    cache = jeng.init_cache(cfg, B, SMAX)
    out = {}
    with jsh.record_wire_bytes() as recs:
        lg, cache = pre(params, jnp.asarray(toks[:, :TP]), cache)
    out["prefill"], out["prefill_records"] = np.asarray(lg, np.float32), json.dumps(records(recs))
    for i in (0, 1):
        lg, cache = dec(params, cache, jnp.asarray(toks[:, TP + i:TP + i + 1]))
        out[f"decode{i}"] = np.asarray(lg, np.float32)
    out.update({f"cache_{k}": np.asarray(v) for k, v in cache.items()})
    return out


def port_serve(cfg, model, toks, mesh=None, secure=None) -> dict:
    cache = init_cache(cfg, B, SMAX, "cpu")
    t = torch.from_numpy(toks)
    out = {}
    with tsh.record_wire_bytes() as recs:
        out["prefill"] = prefill(cfg, model, t[:, :TP], cache, mesh=mesh, secure_moe=secure)
    out["prefill_records"] = records(recs)
    for i in (0, 1):
        out[f"decode{i}"] = decode_step(cfg, model, cache, t[:, TP + i:TP + i + 1], mesh=mesh)
    out.update({f"cache_{k}": v for k, v in cache.items()})
    return out


def assert_serves_alike(got, want):
    for key in ("prefill", "decode0", "decode1", "cache_k", "cache_v"):
        np.testing.assert_allclose(got[key].float().numpy(), want[key], **TOL, err_msg=key)
    np.testing.assert_array_equal(got["cache_pos"].numpy(), want["cache_pos"])
    assert got["decode0"].dtype == torch.float32


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_and_decode_match_reference(arch):
    cfg = serve_cfg(arch)
    np_params = ref_weights(cfg)
    toks = prompt(cfg)
    want = ref_serve(cfg, np_params, toks)
    got = port_serve(cfg, port_model(cfg, np_params), toks)
    assert_serves_alike(got, want)
    assert got["prefill"].shape == (B, cfg.padded_vocab)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "chameleon-34b"])
def test_forward_matches_reference_and_serving(arch):
    """Full forward: logits and the MoE aux within tolerance, dropped exactly;
    its last prompt position equals the port's own prefill logits."""
    cfg = serve_cfg(arch)
    np_params = ref_weights(cfg)
    toks = prompt(cfg)
    jl, jaux = jax.jit(lambda p, t: jlm.forward(cfg, p, {"tokens": t}))(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(toks))
    model = port_model(cfg, np_params)
    tl, taux = forward(cfg, model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux["moe_aux"]), float(jaux["moe_aux"]), **TOL)
    assert int(taux["moe_dropped"]) == int(jaux["moe_dropped"])
    cache = init_cache(cfg, B, SMAX, "cpu")
    lg = prefill(cfg, model, torch.from_numpy(toks[:, :TP]), cache)
    np.testing.assert_allclose(lg.numpy(), tl[:, TP - 1].numpy(), rtol=1e-5, atol=1e-5)


# --- secure MoE serving on a mesh ---------------------------------------------------------


def ref_secure_serve(arch: str, r: int) -> dict:
    """The reference's secure prefill and decode on a (1, R) mesh of Auto
    axes, with its weights; runs in the calling process (R host devices)."""
    cfg = get_config(arch).reduced()
    np_params = ref_weights(cfg, r)
    mesh = compat.make_mesh((1, r), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                            devices=jax.devices()[:r])
    sec = jsh.SecureShuffleConfig(key_words=KW, nonce_words=NW, counter0=COUNTER0)
    out = ref_serve(cfg, np_params, prompt(cfg, 2), mesh=mesh, secure=sec)
    out.update({"param_" + k: v for k, v in _flat(np_params)})
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _unflat(flat):
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


_SUBPROCESS = """
import sys, numpy as np
sys.path.insert(0, {tests!r})
import test_torch_lm_serve as T
np.savez({path!r}, **T.ref_secure_serve({arch!r}, {r}))
print("OK")
"""


@lru_cache(maxsize=None)
def secure_case(arch: str, r: int, tmp: str) -> dict:
    if r == 1:
        return ref_secure_serve(arch, 1)
    path = os.path.join(tmp, f"{arch}_r{r}.npz")
    run_in_subprocess(_SUBPROCESS.format(tests=os.path.dirname(os.path.abspath(__file__)),
                                         path=path, arch=arch, r=r), devices=r)
    return dict(np.load(path))


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("lm_serve"))


@pytest.mark.parametrize("arch,r", [("granite-moe-3b-a800m", 1), ("granite-moe-3b-a800m", 4),
                                    ("qwen2-moe-a2.7b", 4)])
def test_secure_moe_serving_matches_reference(arch, r, case_dir):
    want = secure_case(arch, r, case_dir)
    cfg = get_config(arch).reduced()
    np_params = _unflat({k[len("param_"):]: v for k, v in want.items()
                         if k.startswith("param_")})
    model = port_model(cfg, np_params, r)
    mesh = VirtualMesh(r, "cpu")
    toks = prompt(cfg, 2)
    got = port_serve(cfg, model, toks, mesh=mesh, secure=secure_config(KW, NW, COUNTER0))
    assert_serves_alike(got, want)
    # the reference traces its scanned layer once; the port records each layer
    layer = json.loads(str(want["prefill_records"]))
    assert len(layer) == 2 and all(rec["secure"] for rec in layer)
    assert got["prefill_records"] == layer * cfg.n_layers
    plain = port_serve(cfg, model, toks, mesh=mesh)
    assert torch.equal(plain["prefill"], got["prefill"])
    assert torch.equal(plain["cache_k"], got["cache_k"])


def test_prefill_zeroes_the_cache_past_the_prompt():
    cfg = serve_cfg("glm4-9b")
    model = port_model(cfg, ref_weights(cfg))
    toks = torch.from_numpy(prompt(cfg))
    cache = init_cache(cfg, B, SMAX, "cpu")
    cache["k"].fill_(7.0)
    prefill(cfg, model, toks[:, :TP], cache)
    assert torch.all(cache["k"][:, :, TP:] == 0) and torch.all(cache["pos"] == TP)
    fresh = init_cache(cfg, B, SMAX, "cpu")
    prefill(cfg, model, toks[:, :TP], fresh)
    assert torch.equal(fresh["k"], cache["k"])


def test_serve_lm_cli_runs_on_the_cpu(capsys):
    from repro_torch.serve_lm import main

    res = main(["--arch", "granite-moe-3b-a800m", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--tokens", "3", "--shards", "2", "--secure"])
    assert res["tokens"].shape == (2, 3)
    assert np.all((res["tokens"] >= 0) & (res["tokens"] < get_config(
        "granite-moe-3b-a800m").reduced().vocab_size))
    assert "ms/token" in capsys.readouterr().out
