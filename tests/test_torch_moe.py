"""Port MoE (repro_torch.models.moe) against the JAX reference (repro.models.moe).

The router, the capacity, the local path and both mesh bodies (the sequence
shuffle of prefill and the replicated dispatch of decode), plain and
secure, on `VirtualMesh(R, "cpu")` against the reference's `shard_map` over
a ("data", "model") mesh of Auto axes (the only mesh its MoE runs on). R=1
runs in process, R=4 in a subprocess with forced host devices whose results
come back in an npz. Parameters are the reference's, inputs numpy-seeded.

Tolerances: outputs within rtol/atol 1e-4 (float32; the skewed cases reach
|y| ~ 100; the reference's own serving test allows 2e-3), routed experts, dropped
counts and wire records exactly; the port's secure output equals its plain
output bit for bit.
"""

import json
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
from repro.models import moe as jmoe
from repro_torch import VirtualMesh
from repro_torch.configs import get_config
from repro_torch.convert import secure_config
from repro_torch.core import shuffle as tsh
from repro_torch.models import moe as tmoe

TOL = dict(rtol=1e-4, atol=1e-4)
KW = jch.key_to_words(bytes(range(32)))
NW = jch.nonce_to_words(b"\x07" * 12)
COUNTER0 = 5
RECORD_FIELDS = ("secure", "bytes", "wire_bytes", "pad_bytes", "leaves", "coalesced",
                 "collectives", "keystream_launches", "keystream_blocks")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def port_moe(cfg, flat_params: dict, n_model: int) -> tmoe.MoE:
    m = tmoe.moe_init(cfg, n_model, "cpu")
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in flat_params.items()})
    return m


def ref_params(cfg, n_model: int, seed: int = 0) -> dict:
    tree = jax.jit(lambda k: jmoe.moe_init(k, cfg, n_model))(jax.random.key(seed))
    return {k: np.array(v) for k, v in _flat(tree)}


def unflat(flat: dict) -> dict:
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v)
    return out


def tokens(cfg, shape, seed, skew=0.0):
    """Activations; `skew` adds a shared direction so that routing piles up
    on a few experts and a tight capacity drops tokens."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape + (cfg.d_model,)).astype(np.float32)
    return (x + skew * rng.normal(size=(cfg.d_model,))).astype(np.float32)


def records(recs):
    return [{f: r[f] for f in RECORD_FIELDS} for r in recs]


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


# --- the local path --------------------------------------------------------------------


@pytest.mark.parametrize("n_experts,n_model", [(8, 1), (6, 4)])
def test_route_matches(n_experts, n_model):
    cfg = replace(get_config("granite-moe-3b-a800m").reduced(), n_experts=n_experts)
    e_pad = tmoe.padded_experts(cfg, n_model)
    assert e_pad == jmoe.padded_experts(cfg, n_model) == 8
    p = ref_params(cfg, n_model)
    x = tokens(cfg, (40,), 1)
    jg, je, ja = jmoe._route(cfg, jnp.asarray(p["router"]), jnp.asarray(x), e_pad)
    tg, te, ta = tmoe._route(cfg, torch.from_numpy(p["router"]), torch.from_numpy(x), e_pad)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert int(te.max()) < n_experts  # padding experts never win
    close(tg, jg)
    close(ta, ja)


def test_route_ties_go_to_the_lower_expert():
    """Equal probabilities: the experts come in index order, as lax.top_k's."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    router = np.zeros((cfg.d_model, 8), np.float32)
    router[:, 5] = 1.0
    x = np.abs(tokens(cfg, (6,), 2))
    _, je, _ = jmoe._route(cfg, jnp.asarray(router), jnp.asarray(x), 8)
    _, te, _ = tmoe._route(cfg, torch.from_numpy(router), torch.from_numpy(x), 8)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(te.numpy()[:, 1], 0)


def test_capacity_matches():
    for cf in (1.0, 1.25, 8.0):
        cfg = replace(get_config("granite-moe-3b-a800m"), capacity_factor=cf)
        for n in (1, 3, 8, 100, 4096, 32768):
            for e_pad in (8, 40, 64):
                assert tmoe._capacity(cfg, n, e_pad) == jmoe._capacity(cfg, n, e_pad)


@pytest.mark.parametrize("arch,cf,skew", [("granite-moe-3b-a800m", 1.25, 0.0),
                                          ("granite-moe-3b-a800m", 1.0, 3.0),
                                          ("qwen2-moe-a2.7b", 1.25, 0.0),
                                          ("qwen2-moe-a2.7b", 1.0, 3.0)])
def test_moe_local_matches(arch, cf, skew):
    """No mesh: pack, every expert, combine; qwen2 adds its shared expert.
    At capacity_factor 1.0 with skewed routing tokens drop, by equal counts."""
    cfg = replace(get_config(arch).reduced(), capacity_factor=cf)
    p = ref_params(cfg, 1)
    x = tokens(cfg, (2, 16), 3, skew)
    jy, ja, jd = jmoe.moe_apply(cfg, unflat(p), jnp.asarray(x))
    ty, ta, td = tmoe.moe_apply(cfg, port_moe(cfg, p, 1), torch.from_numpy(x))
    close(ty, jy)
    close(ta, ja)
    assert int(td) == int(jd)
    assert (int(td) > 0) == (skew > 0)


# --- the mesh bodies ---------------------------------------------------------------------


def _ref_mesh_outputs(cfg, p, x, r: int) -> dict:
    """The reference's shuffle body (plain, secure) and decode body on a
    (1, R) ("data", "model") mesh with Auto axes, jitted; runs in the
    calling process (R host devices)."""
    mesh = compat.make_mesh((1, r), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                            devices=jax.devices()[:r])
    sec = jsh.SecureShuffleConfig(key_words=KW, nonce_words=NW, counter0=COUNTER0)
    params = unflat(p)
    out = {}
    for name, s, xs in (("plain", None, x), ("secure", sec, x), ("decode", None, x[:, :1])):
        fn = jax.jit(lambda pp, xx, s=s: jmoe.moe_apply(cfg, pp, xx, mesh=mesh,
                                                         dp_spec=("data",), secure=s))
        with jsh.record_wire_bytes() as recs:
            y, aux, dropped = fn(params, jnp.asarray(xs))
        out[f"{name}_y"] = np.asarray(y)
        out[f"{name}_aux"] = np.asarray(aux)
        out[f"{name}_dropped"] = np.asarray(dropped)
        out[f"{name}_records"] = json.dumps(records(recs))
    return out


_SUBPROCESS = """
import json, numpy as np
from dataclasses import replace
import sys
sys.path.insert(0, {tests!r})
import test_torch_moe as T
from repro.configs import get_config
cfg = replace(get_config({arch!r}).reduced(), n_experts={n_experts}, capacity_factor={cf})
p = T.ref_params(cfg, {r})
x = T.tokens(cfg, (2, 32), {seed}, {skew})
out = T._ref_mesh_outputs(cfg, p, x, {r})
out.update({{"param_" + k: v for k, v in p.items()}})
np.savez({path!r}, **out)
print("OK")
"""

MESH_CASES = {  # name: (arch, n_experts, capacity_factor, skew, R)
    "granite_r1": ("granite-moe-3b-a800m", 8, 1.25, 0.0, 1),
    "qwen2_shared_r1": ("qwen2-moe-a2.7b", 8, 1.25, 0.0, 1),
    "granite_r4": ("granite-moe-3b-a800m", 8, 1.25, 0.0, 4),
    "padded6_drops_r4": ("granite-moe-3b-a800m", 6, 1.0, 3.0, 4),
}


@lru_cache(maxsize=None)
def mesh_case(name: str, tmp: str):
    """(cfg, flat params, x, reference outputs) of a mesh case, computed once."""
    arch, n_experts, cf, skew, r = MESH_CASES[name]
    cfg = replace(get_config(arch).reduced(), n_experts=n_experts, capacity_factor=cf)
    seed = 11
    x = tokens(cfg, (2, 32), seed, skew)
    if r == 1:
        p = ref_params(cfg, 1)
        return cfg, p, x, _ref_mesh_outputs(cfg, p, x, 1)
    import os
    path = os.path.join(tmp, f"{name}.npz")
    run_in_subprocess(_SUBPROCESS.format(tests=os.path.dirname(os.path.abspath(__file__)),
                                         arch=arch, n_experts=n_experts, cf=cf, r=r,
                                         seed=seed, skew=skew, path=path), devices=r)
    got = dict(np.load(path))
    p = {k[len("param_"):]: v for k, v in got.items() if k.startswith("param_")}
    return cfg, p, x, got


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("moe_mesh"))


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_bodies_match_the_reference(name, case_dir):
    """Shuffle body plain and secure (T divides R) and decode body (T=1):
    outputs within tolerance; aux; dropped counts and each call's wire
    records exactly; the port's secure output == its plain output bit for bit."""
    cfg, p, x, want = mesh_case(name, case_dir)
    r = MESH_CASES[name][4]
    mesh = VirtualMesh(r, "cpu")
    model = port_moe(cfg, p, r)
    sec = secure_config(KW, NW, COUNTER0)
    got = {}
    for case, s, xs in (("plain", None, x), ("secure", sec, x), ("decode", None, x[:, :1])):
        with tsh.record_wire_bytes() as recs:
            got[case] = tmoe.moe_apply(cfg, model, torch.from_numpy(np.ascontiguousarray(xs)),
                                       mesh=mesh, secure=s)
        y, aux, dropped = got[case]
        close(y, want[f"{case}_y"])
        close(aux, want[f"{case}_aux"])
        assert int(dropped) == int(want[f"{case}_dropped"]), case
        assert records(recs) == json.loads(str(want[f"{case}_records"])), case
    assert torch.equal(got["secure"][0], got["plain"][0])
    if MESH_CASES[name][3] > 0:
        assert int(got["plain"][2]) > 0  # the skewed case drops tokens
    if r == 1:  # at R=1 a one-token step still takes the shuffle body
        assert len(json.loads(str(want["decode_records"]))) == 2
    else:
        assert json.loads(str(want["decode_records"])) == []


def test_secure_moe_keystreams_cover_both_legs():
    """Each secure shuffle call encrypts both legs: 2 exchanges, each 2
    keystream launches, the return leg at counter0 + 2**20."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    p = {k: v for k, v in _flat(jax.tree.map(
        np.asarray, jmoe.moe_init(jax.random.key(4), cfg, 2)))}
    model = port_moe(cfg, p, 2)
    x = torch.from_numpy(tokens(cfg, (1, 4), 5))
    with tsh.record_wire_bytes() as recs:
        tmoe.moe_apply(cfg, model, x, mesh=VirtualMesh(2, "cpu"),
                       secure=secure_config(KW, NW, COUNTER0))
    assert [r["keystream_launches"] for r in recs] == [2, 2]
    assert all(r["secure"] and r["coalesced"] for r in recs)


def test_moe_rejects_experts_that_do_not_split():
    cfg = replace(get_config("granite-moe-3b-a800m").reduced(), n_experts=6)
    model = tmoe.moe_init(cfg, 1, "cpu")  # 6 experts, not padded for 4 shards
    with pytest.raises(ValueError, match="do not split over 4 shards"):
        tmoe.moe_apply(cfg, model, torch.zeros(1, 4, cfg.d_model), mesh=VirtualMesh(4, "cpu"))
