"""Port sampling sort (repro_torch.core.sort) against repro.core.sort.

Exact comparisons throughout, on numpy-seeded data and the same key
material: the refined and initial edges bit for bit, the sorted table,
counts, per-round drops, rounds executed and dispatched and the halt flag
exactly, the sorted output bit for bit (±0.0 and repeated values included),
and the shuffle ciphertext of one sort round bit for bit. Both layouts of
the sorted table (sharded, replicated) must give identical bits, and so must
the serving variant (`dynamic_total`) with +inf padding. The reference runs
in process for R=1 and in a subprocess with 8 forced host devices for R=8.

`equidepth_edges` is held to the reference as its compiled round computes
it (`jax.jit`): XLA turns the division by the static R into a multiply by
the float32 reciprocal and fuses the interpolation's multiply-add. At a
power-of-two R the reciprocal is exact and the eager reference agrees too.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import run_in_subprocess
from repro.core import shuffle as jsh
from repro.core import sort as js
from repro.crypto import chacha as jch
from repro_torch import VirtualMesh
from repro_torch.convert import secure_config
from repro_torch.core import driver as tdrv
from repro_torch.core import shuffle as tsh
from repro_torch.core import sort as ts
from repro_torch.core.engine import identity_hash

KEY = bytes(range(32))
NONCE = b"\x0b" * 12
COUNTER0 = 3
N_PER_SHARD = 64


def _values(r: int, seed: int = 5) -> np.ndarray:
    """Lognormal (skewed: round 0 is unbalanced) with ±0.0 and repeats."""
    rng = np.random.default_rng(seed)
    v = rng.lognormal(0.0, 1.0, N_PER_SHARD * r).astype(np.float32)
    v[rng.permutation(v.size)[:8]] = np.float32(1.5)
    v[rng.permutation(v.size)[:6]] = np.array([0.0, -0.0, 0.0, -0.0, 0.0, -0.0], np.float32)
    return v


def _dynamic(r: int):
    """The serving variant's input: real records padded with +inf."""
    rng = np.random.default_rng(6)
    v = rng.lognormal(0.0, 1.0, N_PER_SHARD * r).astype(np.float32)
    pad = rng.permutation(v.size)[: 16 * r]
    v[pad] = np.inf
    return v, np.float32(v.size - pad.size)


_REF = """
import warnings
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.core import sort as js
from repro.core.driver import run_until
from repro.core.shuffle import SecureShuffleConfig
from repro.crypto import chacha
R = {r}
mesh = make_mesh((R,), ("data",), devices=jax.devices()[:R])
cfg = SecureShuffleConfig(key_words=chacha.key_to_words({key!r}),
                          nonce_words=chacha.nonce_to_words({nonce!r}), counter0={c0})
v = np.load({vpath!r})
out = {{}}

def keep(name, res):
    for k, x in res.state.items():
        out[name + "_state_" + k] = np.asarray(x)
    out[name + "_aux_counts"] = np.asarray(res.aux["counts"])
    out[name + "_dropped"] = np.asarray(res.dropped)
    out[name + "_rounds"] = np.array([res.rounds_executed, res.rounds_dispatched,
                                      res.n_dispatches, int(res.halted)])

for name, sec in (("secure", cfg), ("plain", None)):
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        o, c, d = js.sample_sort(v["v"], mesh, secure=sec, n_rounds=6)
    out[name + "_out"], out[name + "_counts"], out[name + "_drops"] = o, c, np.asarray(d)
    out[name + "_warned"] = np.array(sum("TRUNCATED" in str(w.message) for w in got))
# through run_until, capacity {cap}: round 0 overflows (the sampling pass)
n = v["v"].size
spec = js.make_sample_sort_spec(R, {cap}, halt_total=n, shard_state=True)
init = {{"edges": jnp.asarray(v["edges"]), "sorted": jnp.full((R, R * {cap}), jnp.inf),
        "counts": jnp.zeros((R,), jnp.float32)}}
keep("until", run_until(spec, {{"v": v["v"]}}, init, mesh, secure=cfg, max_rounds=5,
                        warn_on_overflow=False))
# the serving variant: +inf padding, the total in state
spec = js.make_sample_sort_spec(R, {dcap}, dynamic_total=True, shard_state=True)
init = {{"edges": jnp.asarray(v["dedges"]), "sorted": jnp.full((R, R * {dcap}), jnp.inf),
        "counts": jnp.zeros((R,), jnp.float32), "total": jnp.float32(v["dtotal"])}}
keep("dynamic", run_until(spec, {{"v": v["d"]}}, init, mesh, secure=cfg, max_rounds=6,
                          min_chunk=2, warn_on_overflow=False))
np.savez({path!r}, **out)
print("OK")
"""

CAP_OVERFLOW = 24  # per (source, destination): round 0's hot range overflows it


@pytest.fixture(scope="module", params=[1, 8])
def ref(request, tmp_path_factory):
    """(R, inputs, the JAX reference's results on a mesh of R devices)."""
    r = request.param
    d = tmp_path_factory.mktemp(f"sort_ref{r}")
    v = _values(r)
    dv, dtotal = _dynamic(r)
    finite = dv[np.isfinite(dv)]
    inputs = {"v": v, "edges": ts.initial_edges(float(v.min()), float(v.max()), r),
              "d": dv, "dtotal": dtotal,
              "dedges": ts.initial_edges(float(finite.min()), float(finite.max()), r)}
    np.savez(d / "in.npz", **inputs)
    code = _REF.format(r=r, key=KEY, nonce=NONCE, c0=COUNTER0, vpath=str(d / "in.npz"),
                       cap=CAP_OVERFLOW if r > 1 else N_PER_SHARD, dcap=N_PER_SHARD,
                       path=str(d / "ref.npz"))
    if r == 1:
        exec(code, {})
    else:
        run_in_subprocess(code, devices=r)
    return r, inputs, dict(np.load(d / "ref.npz"))


def _cfg():
    return secure_config(jch.key_to_words(KEY), jch.nonce_to_words(NONCE), COUNTER0)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _truncations(caught) -> int:
    """Warnings of data loss among those caught (JAX adds warnings of its own)."""
    return sum("TRUNCATED" in str(w.message) for w in caught)


def _assert_result(res, want, name):
    for k, x in res.state.items():
        np.testing.assert_array_equal(_bits(x.numpy()), _bits(want[f"{name}_state_{k}"]),
                                      err_msg=k)
    np.testing.assert_array_equal(res.aux["counts"], want[f"{name}_aux_counts"])
    np.testing.assert_array_equal(res.dropped, want[f"{name}_dropped"])
    assert [res.rounds_executed, res.rounds_dispatched, res.n_dispatches,
            int(res.halted)] == list(want[f"{name}_rounds"])


# --- edges -------------------------------------------------------------------------------


def _counts_case(rng, r: int, case: str) -> np.ndarray:
    c = rng.integers(0, 1000, r).astype(np.float32)
    if case == "zero":
        c[:] = 0
    elif case == "one_bin":
        c[:] = 0
        c[rng.integers(r)] = rng.integers(1, 100)
    elif case == "repeated_cum":  # empty bins: repeated cumulative values
        c[rng.random(r) < 0.5] = 0
    elif case == "large":  # partial sums up to 2**24
        c = rng.integers(0, 2**24 // r, r).astype(np.float32)
    return c


EDGE_CASES = ["random", "zero", "one_bin", "repeated_cum", "large"]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_equidepth_edges_bitexact(case):
    rng = np.random.default_rng(EDGE_CASES.index(case))
    jitted = jax.jit(js.equidepth_edges)
    for trial in range(60):
        r = int(rng.integers(1, 13))
        counts = _counts_case(rng, r, case)
        edges = (np.sort(rng.normal(size=r + 1)) * 10.0 ** rng.integers(-3, 4)).astype(np.float32)
        got = _bits(ts.equidepth_edges(torch.from_numpy(edges), torch.from_numpy(counts)))
        want = jitted(jnp.asarray(edges), jnp.asarray(counts))
        np.testing.assert_array_equal(got, _bits(want), err_msg=f"R={r} {counts} {edges}")
        if r & (r - 1) == 0:  # 1/R exact: the eager reference agrees too
            eager = js.equidepth_edges(jnp.asarray(edges), jnp.asarray(counts))
            np.testing.assert_array_equal(got, _bits(eager))
        if case == "zero":
            np.testing.assert_array_equal(got, _bits(edges))


def test_interp_matches_jnp_interp_bitexact():
    rng = np.random.default_rng(11)
    for trial in range(100):
        n = int(rng.integers(2, 12))
        xp = np.sort(rng.integers(0, 20, n)).astype(np.float32)  # repeats: flat segments
        fp = np.sort(rng.normal(size=n)).astype(np.float32)
        x = rng.uniform(-2, 22, 9).astype(np.float32)
        x[:3] = xp[[0, n // 2, n - 1]]
        got = ts._interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp))
        want = jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp))
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("r", [1, 3, 8])
def test_initial_edges_bitexact(r):
    """sample_sort's first edges: `lo + span * arange(r + 1) / r` in weakly
    typed float32 and the top edge in Python floats, as the reference writes
    them (src/repro/core/sort.py)."""
    rng = np.random.default_rng(r)
    for lo, hi in [(0.0, 1.0), (2.5, 2.5)] + [
            tuple(sorted(map(float, rng.normal(size=2).astype(np.float32) * 50)))
            for _ in range(20)]:
        span = max(hi - lo, 1e-6)
        want = jnp.asarray(lo + span * jnp.arange(r + 1) / r, jnp.float32)
        want = want.at[-1].set(hi + 1e-3 * span)
        np.testing.assert_array_equal(_bits(ts.initial_edges(lo, hi, r)), _bits(want))


# --- the job -------------------------------------------------------------------------------


def test_sample_sort_matches_jax_both_layouts(ref):
    """Secure (both layouts of the sorted table) and plaintext, against the
    reference's sample_sort (its default layout, sharded)."""
    r, inputs, want = ref
    mesh = VirtualMesh(r, "cpu")
    outs = {}
    for name, sec, shard in (("secure", _cfg(), True), ("secure", _cfg(), False),
                             ("plain", None, "auto")):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            o, c, d = ts.sample_sort(inputs["v"], mesh, secure=sec, n_rounds=6,
                                     shard_state=shard)
        np.testing.assert_array_equal(_bits(o), _bits(want[name + "_out"]))
        np.testing.assert_array_equal(c, want[name + "_counts"])
        np.testing.assert_array_equal(d, want[name + "_drops"])
        assert _truncations(got) == int(want[name + "_warned"]) == 0
        outs[(name, shard)] = (o, c, d)
    first = outs[("secure", True)]
    np.testing.assert_array_equal(_bits(first[0]), _bits(np.sort(inputs["v"], kind="stable")))
    for other in list(outs.values())[1:]:
        for a, b in zip(first, other):
            np.testing.assert_array_equal(np.asarray(a).view(np.uint8), np.asarray(b).view(np.uint8))


def test_sample_sort_overflowing_sampling_round_matches_jax(ref):
    """Round 0 overflows its capacity (the sampling pass); refinement makes
    the job lossless, so nothing warns (at R=1 every round drops and the
    final round's loss warns). The expected output is the reference
    run_until job's table, each row cut at its count."""
    r, inputs, want = ref
    cap = CAP_OVERFLOW if r > 1 else N_PER_SHARD
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        o, c, d = ts.sample_sort(inputs["v"], VirtualMesh(r, "cpu"), secure=_cfg(), n_rounds=5,
                                 capacity=cap)
    rows, counts = want["until_state_sorted"], want["until_state_counts"]
    np.testing.assert_array_equal(
        _bits(o), _bits(np.concatenate([rows[i, :int(counts[i])] for i in range(r)])))
    np.testing.assert_array_equal(c, counts)
    np.testing.assert_array_equal(d, want["until_dropped"])
    assert _truncations(got) == int(d[-1] > 0)
    if r > 1:
        assert d[0] > 0 and d[-1] == 0 and not _truncations(got)


def test_run_until_sort_state_and_rounds_match_jax(ref):
    r, inputs, want = ref
    mesh = VirtualMesh(r, "cpu")
    cap = CAP_OVERFLOW if r > 1 else N_PER_SHARD
    n = inputs["v"].size
    for shard in (True, False):
        spec = ts.make_sample_sort_spec(mesh, cap, halt_total=n, shard_state=shard)
        init = {"edges": torch.from_numpy(inputs["edges"]),
                "sorted": torch.full((r, r * cap), torch.inf),
                "counts": torch.zeros(r)}
        res = tdrv.run_until(spec, {"v": inputs["v"]}, init, mesh, secure=_cfg(), max_rounds=5,
                             warn_on_overflow=False)
        _assert_result(res, want, "until")


def test_dynamic_total_with_inf_padding_matches_jax(ref):
    r, inputs, want = ref
    mesh = VirtualMesh(r, "cpu")
    results = []
    for shard in (True, False):
        spec = ts.make_sample_sort_spec(mesh, N_PER_SHARD, dynamic_total=True, shard_state=shard)
        init = {"edges": torch.from_numpy(inputs["dedges"]),
                "sorted": torch.full((r, r * N_PER_SHARD), torch.inf),
                "counts": torch.zeros(r), "total": torch.tensor(inputs["dtotal"])}
        res = tdrv.run_until(spec, {"v": inputs["d"]}, init, mesh, secure=_cfg(), max_rounds=6,
                             min_chunk=2, warn_on_overflow=False)
        _assert_result(res, want, "dynamic")
        results.append(res)
    assert results[0].halted
    counts = results[0].state["counts"].to(torch.int64)
    rows = results[0].state["sorted"]
    got = torch.cat([rows[i, :counts[i]] for i in range(r)]).numpy()
    np.testing.assert_array_equal(got, np.sort(inputs["d"][np.isfinite(inputs["d"])], kind="stable"))


def test_final_round_drop_warns_like_jax():
    v = _values(1)
    with pytest.warns(RuntimeWarning, match="TRUNCATED"):
        o, c, d = ts.sample_sort(v, VirtualMesh(1, "cpu"), n_rounds=2, capacity=16)
    with pytest.warns(RuntimeWarning, match="TRUNCATED"):
        jo, jc, jd = js.sample_sort(v, jax.make_mesh((1,), ("data",)), n_rounds=2, capacity=16)
    np.testing.assert_array_equal(_bits(o), _bits(jo))
    np.testing.assert_array_equal(d, np.asarray(jd))
    assert o.size == 16 and list(d) == [v.size - 16] * 2


@pytest.mark.parametrize("r", [1, 8])
def test_sort_round_ciphertext_matches_jax(r):
    """One secure sort round's sender wire, for each source shard, equals the
    reference's: the range partition, bucket_pack and the keystream."""
    v = _values(r, seed=9)
    cap = 16
    edges = ts.initial_edges(float(v.min()), float(v.max()), r)
    round_id = 5
    mesh = VirtualMesh(r, "cpu")
    tspec = ts.make_sample_sort_spec(mesh, cap)
    mk, mv = tspec.map_fn({"edges": torch.from_numpy(edges)}, {"v": mesh.shard(
        torch.from_numpy(v))}, round_id)
    bk, bv, _ = tsh.bucket_pack(mk, identity_hash(mk) % r, mv, r, cap)
    twire, tlay, _ = tsh._pack_wire_coalesced({"k": bk, "v": bv}, lead=2)
    ids = tsh._exchange_ids(r, r, twire.device)
    got = tsh._crypt_wire_coalesced(twire.reshape(r * r, -1), tlay, _cfg(), ids[0], ids[1],
                                    round_id).reshape(r, r, -1).numpy().view(np.uint32)
    jspec = js.make_sample_sort_spec(r, cap)
    jcfg = jsh.SecureShuffleConfig(key_words=jch.key_to_words(KEY),
                                   nonce_words=jch.nonce_to_words(NONCE), counter0=COUNTER0)
    for s in range(r):
        jk, jv = jspec.map_fn({"edges": jnp.asarray(edges)},
                              {"v": jnp.asarray(v.reshape(r, -1)[s])}, round_id)
        jbk, jbv, _ = jsh.bucket_pack(jk, (jk.astype(jnp.uint32) % r).astype(jnp.int32), jv, r,
                                      cap)
        jwire, jlay, _ = jsh._pack_wire_coalesced({"k": jbk, "v": jbv})
        want = jsh._crypt_wire_coalesced(jwire, jlay, jcfg, jnp.full((r,), s, jnp.uint32),
                                         jnp.arange(r, dtype=jnp.uint32), jnp.uint32(round_id))
        np.testing.assert_array_equal(got[s], np.asarray(want))


def test_sort_spec_state_specs_follow_shard_state(monkeypatch):
    mesh = VirtualMesh(2, "cpu")
    assert ts.make_sample_sort_spec(mesh, 4, shard_state=True).state_specs["sorted"] == tdrv.P("data")
    assert ts.make_sample_sort_spec(mesh, 4, shard_state=False).state_specs["sorted"] == tdrv.P()
    assert ts.make_sample_sort_spec(mesh, 4, shard_state="replicated").state_specs["sorted"] == tdrv.P()
    # 'auto' follows $REPRO_STATE_SPECS, as the reference's does; without it
    # the reference's default, 'sharded'
    monkeypatch.setenv("REPRO_STATE_SPECS", "replicated")
    assert ts.make_sample_sort_spec(mesh, 4).state_specs["sorted"] == tdrv.P()
    monkeypatch.delenv("REPRO_STATE_SPECS")
    auto = ts.make_sample_sort_spec(mesh, 4)
    assert auto.state_specs["sorted"] == tdrv.P("data")
    assert auto.state_specs["edges"] == auto.state_specs["counts"] == tdrv.P()
    dyn = ts.make_sample_sort_spec(mesh, 4, dynamic_total=True)
    assert dyn.state_specs["total"] == tdrv.P()
