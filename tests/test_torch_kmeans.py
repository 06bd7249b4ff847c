"""Port k-means and driver (repro_torch.core) against repro.core.kmeans.

The slice as a whole: one secure `make_kmeans_step` round and a secure
`kmeans_fit` on virtual meshes of R in {1, 4, 8} shards against the JAX
reference on meshes of R devices, on the same numpy data and key material.
Round counts (`n_iter`, `rounds_executed`, `rounds_dispatched`,
`n_dispatches`) must be equal; centres within rtol/atol 1e-5 (float sums
are taken in another order). The data (seed 28) was picked so that the
last centre shift sits well below the paper's threshold and the one before
it well above; the tests assert that margin, so float noise cannot move
`n_iter`. The reference runs in process for R=1 and in a subprocess with R
forced host devices otherwise, one chunk size per mesh
(min_chunk = rounds_per_dispatch) to bound its compiles.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import run_in_subprocess
from repro.core import kmeans as jkm
from repro_torch import VirtualMesh
from repro_torch.convert import secure_config, to_tensors
from repro_torch.core import driver as tdrv
from repro_torch.core import kmeans as tkm
from repro_torch.core import shuffle as tsh
from repro_torch.core.engine import MapReduceSpec, run_mapreduce

N, K, D, SEED = 1024, 8, 3, 28
KEY = bytes(range(32))
NONCE = b"\x09" * 12
COUNTER0 = 5
RPD = 4  # rounds per dispatch == min_chunk: one chunk size per mesh
MARGIN = 2.0  # last shift < thr / 2, the one before > 2 * thr

_REF = """
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.core.kmeans import generate_points, kmeans_fit, make_kmeans_step
from repro.core.shuffle import SecureShuffleConfig
from repro.crypto import chacha
R = {r}
mesh = make_mesh((R,), ("data",), devices=jax.devices()[:R])
cfg = SecureShuffleConfig(key_words=chacha.key_to_words({key!r}),
                          nonce_words=chacha.nonce_to_words({nonce!r}), counter0={c0})
pts, _ = generate_points({n}, {k}, d={d}, seed={seed})
w = jnp.ones(({n},), jnp.float32)
step_c, step_s = make_kmeans_step(mesh, secure=cfg)(jnp.asarray(pts), w, jnp.asarray(pts[:{k}]))
res = kmeans_fit(pts, {k}, mesh, secure=cfg, max_iter=32, rounds_per_dispatch={rpd},
                 min_chunk={rpd})
np.savez({path!r}, step_c=np.asarray(step_c), step_s=np.asarray(step_s),
         centers=np.asarray(res.centers), shifts=np.asarray(res.center_shift, np.float64),
         counts=np.array([res.n_iter, res.n_rounds_dispatched, res.n_dispatches]),
         inertia=np.array(res.inertia))
print("OK")
"""


@pytest.fixture(scope="module", params=[1, 4, 8])
def ref(request, tmp_path_factory):
    """(R, the JAX reference's results on a mesh of R devices)."""
    r = request.param
    path = str(tmp_path_factory.mktemp(f"kmeans_ref{r}") / "ref.npz")
    code = _REF.format(r=r, key=KEY, nonce=NONCE, c0=COUNTER0, n=N, k=K, d=D, seed=SEED,
                       rpd=RPD, path=path)
    if r == 1:
        exec(code, {})
    else:
        run_in_subprocess(code, devices=r)
    return r, dict(np.load(path))


def _points():
    return tkm.generate_points(N, K, d=D, seed=SEED)[0]


def _cfg(**kw):
    from repro_torch.crypto import chacha
    return secure_config(chacha.key_to_words(KEY), chacha.nonce_to_words(NONCE), COUNTER0, **kw)


def test_generate_points_identical_to_jax():
    a, ta = tkm.generate_points(100, 5, d=4, seed=3)
    b, tb = jkm.generate_points(100, 5, d=4, seed=3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ta, tb)


def test_secure_step_matches_jax(ref):
    r, want = ref
    pts = _points()
    t = to_tensors({"p": pts, "w": np.ones(N, np.float32), "c": pts[:K]}, "cpu")
    step = tkm.make_kmeans_step(VirtualMesh(r, "cpu"), secure=_cfg())
    c, s = step(t["p"], t["w"], t["c"])
    np.testing.assert_allclose(c.numpy(), want["step_c"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(s), float(want["step_s"]), rtol=1e-5, atol=1e-6)


def test_kmeans_fit_matches_jax(ref):
    r, want = ref
    pts = _points()
    res = tkm.kmeans_fit(pts, K, VirtualMesh(r, "cpu"), secure=_cfg(), max_iter=32,
                         rounds_per_dispatch=RPD, min_chunk=RPD)
    n_iter, n_rd, n_disp = (int(x) for x in want["counts"])
    assert (res.n_iter, res.n_rounds_dispatched, res.n_dispatches) == (n_iter, n_rd, n_disp)
    assert res.halted and n_iter == len(want["shifts"])
    np.testing.assert_allclose(res.centers.numpy(), want["centers"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res.center_shift, want["shifts"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(res.inertia, float(want["inertia"]), rtol=1e-4)
    thr = tkm.paper_threshold(torch.from_numpy(pts))
    for shifts in (res.center_shift, list(want["shifts"])):
        assert shifts[-1] < thr / MARGIN and shifts[-2] > thr * MARGIN, (shifts, thr)


def test_secure_equals_plain_bitexact():
    pts = _points()
    mesh = VirtualMesh(4, "cpu")
    sec = tkm.kmeans_fit(pts, K, mesh, secure=_cfg(), max_iter=32, rounds_per_dispatch=RPD)
    sec_leaf = tkm.kmeans_fit(pts, K, mesh, secure=_cfg(coalesce=False), max_iter=32,
                              rounds_per_dispatch=RPD)
    plain = tkm.kmeans_fit(pts, K, mesh, secure=None, max_iter=32, rounds_per_dispatch=RPD)
    for other in (sec_leaf, plain):
        assert torch.equal(sec.centers, other.centers)
        assert sec.center_shift == other.center_shift
        assert sec.n_iter == other.n_iter


def test_keystream_rounds_gapless_across_chunks(monkeypatch):
    """Every executed round draws its own round index; chunk k+1 resumes at
    round_offset + rounds executed, so keystreams stay disjoint across chunks."""
    seen = []
    orig = tsh._crypt_wire_coalesced

    def spy(wire, layout, cfg, nonce_ids, ctr_rows, round_id=None):
        seen.append(round_id)
        return orig(wire, layout, cfg, nonce_ids, ctr_rows, round_id)

    monkeypatch.setattr(tsh, "_crypt_wire_coalesced", spy)
    pts = _points()
    res = tkm.kmeans_fit(pts, K, VirtualMesh(2, "cpu"), secure=_cfg(), max_iter=32,
                         rounds_per_dispatch=2)
    assert res.n_dispatches > 2  # the job spans several chunks
    assert seen == [r for r in range(res.n_iter) for _ in (0, 1)]

    seen.clear()
    spec = tkm.make_kmeans_iterative_spec(K, VirtualMesh(2, "cpu"), threshold=0.0)
    out = tdrv.run_until(spec, {"p": pts, "w": np.ones(N, np.float32)}, pts[:K],
                         VirtualMesh(2, "cpu"), secure=_cfg(), max_rounds=5, round_offset=10)
    assert not out.halted and out.rounds_executed == 5 and out.n_dispatches == 3
    assert out.rounds_dispatched == 5 and out.aux["shift"].shape == (5,)
    assert seen == [r for r in range(10, 15) for _ in (0, 1)]


def test_run_iterative_mapreduce_zero_fills_after_halt():
    pts = _points()
    mesh = VirtualMesh(2, "cpu")
    spec = tkm.make_kmeans_iterative_spec(K, mesh, n_rounds=6, threshold=float("inf"))
    state, aux, dropped, n_exec, halted = tdrv.run_iterative_mapreduce(
        spec, {"p": pts, "w": np.ones(N, np.float32)}, pts[:K], mesh, secure=_cfg())
    assert n_exec == 1 and halted
    assert aux["shift"].shape == (6,) and float(aux["shift"][1:].abs().sum()) == 0.0
    assert torch.equal(aux["centers"][0], state) and int(dropped.sum()) == 0


def test_overflow_warned_once_with_global_rounds():
    mesh = VirtualMesh(2, "cpu")

    def map_fn(state, inputs, r):
        s, n = inputs["x"].shape
        return torch.zeros((s, n), dtype=torch.int32), {"x": inputs["x"]}

    def reduce_fn(state, rk, rv, valid, r):
        total = mesh.psum(torch.where(valid, rv["x"], 0.0).sum(dim=1))
        return total, {"total": total}

    spec = tdrv.IterativeSpec(map_fn=map_fn, reduce_fn=reduce_fn, capacity=2,
                              halt_fn=lambda st, aux, r: aux["total"] > 1e9)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = tdrv.run_until(spec, {"x": np.ones(8, np.float32)}, torch.tensor(0.0), mesh,
                             max_rounds=3, round_offset=4)
    msgs = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1 and "round 4" in msgs[0] and "round 6" in msgs[0]
    assert "capacity 2" in msgs[0]
    np.testing.assert_array_equal(res.dropped, [4, 4, 4])  # 2 per shard, summed


def test_sharded_state_raises_not_implemented():
    mesh = VirtualMesh(2, "cpu")
    spec = tdrv.IterativeSpec(map_fn=None, reduce_fn=None, state_specs={"a": tdrv.P("data")})
    with pytest.raises(NotImplementedError, match="sort slice"):
        tdrv.run_until(spec, {"x": np.ones(4, np.float32)}, {"a": torch.zeros(2)}, mesh)


def test_farthest_init_and_step_ref_match_jax():
    pts = _points()
    np.testing.assert_array_equal(
        tkm._farthest_point_init(torch.from_numpy(pts), K).numpy(),
        np.asarray(jkm._farthest_point_init(jnp.asarray(pts), K)))
    want_c, want_s = jkm.kmeans_step_ref(jnp.asarray(pts), jnp.asarray(pts[:K]))
    got_c, got_s = tkm.kmeans_step_ref(torch.from_numpy(pts), torch.from_numpy(pts[:K]))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got_s), float(want_s), rtol=1e-5)


def test_run_mapreduce_matches_jax_r1():
    """A one-round keyed count through both engines (secure, R=1)."""
    from repro.compat import make_mesh
    from repro.core import engine as jeng
    from repro.core.shuffle import SecureShuffleConfig
    from repro.crypto import chacha

    rng = np.random.default_rng(0)
    keys = rng.integers(0, 6, 64).astype(np.int32)
    vals = rng.random(64).astype(np.float32)
    jcfg = SecureShuffleConfig(key_words=chacha.key_to_words(KEY),
                               nonce_words=chacha.nonce_to_words(NONCE), counter0=COUNTER0)

    def jreduce(k, v, valid):
        return jnp.zeros(6).at[jnp.where(valid, k, 0)].add(jnp.where(valid, v, 0.0))

    jout, jdrop = jeng.run_mapreduce(jeng.MapReduceSpec(map_fn=lambda k, v: (k, v),
                                                        reduce_fn=jreduce),
                                     jnp.asarray(keys), jnp.asarray(vals),
                                     make_mesh((1,), ("data",)), secure=jcfg)

    def treduce(k, v, valid):
        seg = torch.where(valid, k, 0).long()
        return torch.zeros((k.shape[0], 6)).scatter_add_(1, seg, torch.where(valid, v, 0.0))

    tout, tdrop = run_mapreduce(MapReduceSpec(map_fn=lambda k, v: (k, v), reduce_fn=treduce),
                                keys, vals, VirtualMesh(1, "cpu"), secure=_cfg())
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    assert int(tdrop) == int(jdrop) == 0


def test_runtime_threshold_spec_equals_baked_threshold():
    """The serving variant reads the threshold from carried state and stops
    at the same round, with the same centres, as the baked-in predicate."""
    pts = _points()
    mesh = VirtualMesh(4, "cpu")
    thr = tkm.paper_threshold(torch.from_numpy(pts))
    inputs = {"p": pts, "w": np.ones(N, np.float32)}
    baked = tdrv.run_until(tkm.make_kmeans_iterative_spec(K, mesh, threshold=thr), inputs,
                           pts[:K], mesh, secure=_cfg(), max_rounds=32, max_chunk=RPD)
    state = {"c": torch.from_numpy(pts[:K]), "thr": torch.tensor(thr, dtype=torch.float32)}
    served = tdrv.run_until(tkm.make_kmeans_iterative_spec(K, mesh, runtime_threshold=True),
                            inputs, state, mesh, secure=_cfg(), max_rounds=32, max_chunk=RPD)
    assert served.halted and served.rounds_executed == baked.rounds_executed
    assert torch.equal(served.state["c"], baked.state)
    assert float(served.state["thr"]) == np.float32(thr)


def test_virtual_mesh_collectives():
    mesh = VirtualMesh(3, "cpu")
    x = torch.arange(12, dtype=torch.float32).reshape(3, 2, 2)
    total = mesh.psum(x)
    assert total.shape == x.shape and torch.equal(total[1], x[0] + x[1] + x[2])
    assert torch.equal(mesh.axis_index(), torch.arange(3))
    assert mesh.all_gather(x).shape == (3, 3, 2, 2)
    assert torch.equal(mesh.all_gather(x, tiled=True)[2], x.reshape(6, 2))
    y = torch.arange(9).reshape(3, 3)
    assert torch.equal(mesh.all_to_all(y), y.T)  # row i of shard j -> row j of shard i
    assert torch.equal(mesh.unshard(mesh.shard(torch.arange(6))), torch.arange(6))
    with pytest.raises(ValueError):
        mesh.shard(torch.arange(4))
