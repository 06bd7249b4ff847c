"""Port streaming grep (repro_torch.core.grep) against repro.core.grep.

Exact comparisons on numpy-seeded tokens (with -1 padding and duplicate
patterns): per-pattern hits, per-round hits, per-round drops, rounds
executed and dispatched, the halt flag and the stream cursor (the reference
holds it as uint32, the port as int64: compared by value), secure and
plaintext, with and without a `max_matches` limit; and the shuffle
ciphertext of one grep round bit for bit. The reference runs in process
for R=1 and in a subprocess with 8 forced host devices for R=8.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import run_in_subprocess
from repro.core import grep as jg
from repro.core import shuffle as jsh
from repro.crypto import chacha as jch
from repro_torch import VirtualMesh
from repro_torch.convert import secure_config
from repro_torch.core import driver as tdrv
from repro_torch.core import grep as tg
from repro_torch.core import shuffle as tsh
from repro_torch.core.engine import identity_hash

KEY = bytes(range(32))
NONCE = b"\x0c" * 12
COUNTER0 = 11
ROUNDS, CHUNK = 4, 16
PATTERNS = [3, 5, 3, 7, 39, 1]  # 3 twice: the first match wins


def _tokens(r: int, seed: int = 2) -> np.ndarray:
    """Zipf-like tokens over 40 ids, with -1 padding."""
    rng = np.random.default_rng(seed)
    t = np.minimum(rng.zipf(1.3, ROUNDS * CHUNK * r), 40) - 1
    t[rng.random(t.size) < 0.1] = -1
    return t.astype(np.int32)


def _limit(r: int) -> int:
    return int(np.isin(_tokens(r), PATTERNS).sum()) // 2


_REF = """
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.core import grep as jg
from repro.core.driver import run_until
from repro.core.shuffle import SecureShuffleConfig
from repro.crypto import chacha
R = {r}
mesh = make_mesh((R,), ("data",), devices=jax.devices()[:R])
cfg = SecureShuffleConfig(key_words=chacha.key_to_words({key!r}),
                          nonce_words=chacha.nonce_to_words({nonce!r}), counter0={c0})
t = np.load({tpath!r})
out = {{}}
for name, sec in (("secure", cfg), ("plain", None)):
    h, rh, d = jg.grep_count(t, {pats!r}, mesh, secure=sec, n_rounds={rounds})
    out[name + "_hits"], out[name + "_round_hits"], out[name + "_dropped"] = (
        np.asarray(h), np.asarray(rh), np.asarray(d))
# the limited job through run_until (what grep_count runs): state and rounds
spec = jg.make_grep_spec(jnp.asarray({pats!r}, jnp.int32), {chunk}, max_matches={limit})
init = {{"hits": jnp.zeros(({npat},), jnp.float32), "cursor": jnp.uint32(0)}}
res = run_until(spec, {{"t": t}}, init, mesh, secure=cfg, max_rounds={rounds}, min_chunk=1)
out["limited_hits"] = np.asarray(res.state["hits"])
out["limited_cursor"] = np.asarray(res.state["cursor"]).astype(np.int64)
out["limited_round_hits"] = np.asarray(res.aux["round_hits"])
out["limited_dropped"] = np.asarray(res.dropped)
out["limited_rounds"] = np.array([res.rounds_executed, res.rounds_dispatched,
                                  res.n_dispatches, int(res.halted)])
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module", params=[1, 8])
def ref(request, tmp_path_factory):
    """(R, the JAX reference's results on a mesh of R devices)."""
    r = request.param
    d = tmp_path_factory.mktemp(f"grep_ref{r}")
    np.save(d / "t.npy", _tokens(r))
    code = _REF.format(r=r, key=KEY, nonce=NONCE, c0=COUNTER0, tpath=str(d / "t.npy"),
                       pats=PATTERNS, rounds=ROUNDS, chunk=CHUNK * 1, limit=_limit(r),
                       npat=len(PATTERNS), path=str(d / "ref.npz"))
    if r == 1:
        exec(code, {})
    else:
        run_in_subprocess(code, devices=r)
    return r, dict(np.load(d / "ref.npz"))


def _cfg():
    return secure_config(jch.key_to_words(KEY), jch.nonce_to_words(NONCE), COUNTER0)


def _numpy_hits(t: np.ndarray, r: int, rounds: int) -> np.ndarray:
    """Per-pattern hits over each shard's first `rounds` chunks (first match wins)."""
    seen = t.reshape(r, ROUNDS, CHUNK)[:, :rounds].reshape(-1)
    first = {p: i for i, p in reversed(list(enumerate(PATTERNS)))}
    hits = np.zeros(len(PATTERNS), np.float32)
    for p, i in first.items():
        hits[i] = np.sum(seen == p)
    return hits


def test_grep_count_matches_jax(ref):
    r, want = ref
    t = _tokens(r)
    mesh = VirtualMesh(r, "cpu")
    for name, sec in (("secure", _cfg()), ("plain", None)):
        h, rh, d = tg.grep_count(t, PATTERNS, mesh, secure=sec, n_rounds=ROUNDS)
        np.testing.assert_array_equal(h.numpy(), want[name + "_hits"])
        np.testing.assert_array_equal(rh, want[name + "_round_hits"])
        np.testing.assert_array_equal(d, want[name + "_dropped"])
        np.testing.assert_array_equal(h.numpy(), _numpy_hits(t, r, ROUNDS))
        assert rh.shape == (ROUNDS, len(PATTERNS))
    # the duplicate pattern never matches: the first of equal ids wins
    assert want["secure_hits"][2] == 0 and want["secure_hits"][0] > 0


def test_grep_max_matches_halts_like_jax(ref):
    r, want = ref
    t = _tokens(r)
    mesh = VirtualMesh(r, "cpu")
    h, rh, d = tg.grep_count(t, PATTERNS, mesh, secure=_cfg(), n_rounds=ROUNDS,
                             max_matches=_limit(r))
    np.testing.assert_array_equal(h.numpy(), want["limited_hits"])
    np.testing.assert_array_equal(rh, want["limited_round_hits"])
    np.testing.assert_array_equal(d, want["limited_dropped"])
    executed = int(want["limited_rounds"][0])
    assert rh.shape[0] == executed < ROUNDS and float(h.sum()) >= _limit(r)
    np.testing.assert_array_equal(h.numpy(), _numpy_hits(t, r, executed))

    spec = tg.make_grep_spec(PATTERNS, CHUNK, mesh, max_matches=_limit(r))
    init = {"hits": torch.zeros(len(PATTERNS)), "cursor": torch.tensor(0)}
    res = tdrv.run_until(spec, {"t": t}, init, mesh, secure=_cfg(), max_rounds=ROUNDS)
    assert [res.rounds_executed, res.rounds_dispatched, res.n_dispatches,
            int(res.halted)] == list(want["limited_rounds"])
    assert int(res.state["cursor"]) == int(want["limited_cursor"]) == executed


def test_grep_cursor_not_round_index_selects_chunk():
    """A job admitted at round_offset 100 streams from chunk 0 all the same."""
    r = 2
    t = _tokens(r)
    mesh = VirtualMesh(r, "cpu")
    spec = tg.make_grep_spec(PATTERNS, CHUNK, mesh)
    init = {"hits": torch.zeros(len(PATTERNS)), "cursor": torch.tensor(0)}
    res = tdrv.run_until(spec, {"t": t}, init, mesh, secure=_cfg(), max_rounds=2,
                         round_offset=100)
    np.testing.assert_array_equal(res.state["hits"].numpy(), _numpy_hits(t, r, 2))
    assert int(res.state["cursor"]) == 2


@pytest.mark.parametrize("r", [1, 8])
def test_grep_round_ciphertext_matches_jax(r):
    """One secure grep round's sender wire (chunk at cursor 2), for each
    source shard, equals the reference's."""
    t = _tokens(r, seed=7)
    round_id, cursor = 9, 2
    mesh = VirtualMesh(r, "cpu")
    tspec = tg.make_grep_spec(PATTERNS, CHUNK, mesh)
    mk, mv = tspec.map_fn({"cursor": torch.tensor(cursor)}, {"t": mesh.shard(
        torch.from_numpy(t))}, round_id)
    bk, bv, _ = tsh.bucket_pack(mk, identity_hash(mk) % r, mv, r, CHUNK)
    twire, tlay, _ = tsh._pack_wire_coalesced({"k": bk, "v": bv}, lead=2)
    ids = tsh._exchange_ids(r, r, twire.device)
    got = tsh._crypt_wire_coalesced(twire.reshape(r * r, -1), tlay, _cfg(), ids[0], ids[1],
                                    round_id).reshape(r, r, -1).numpy().view(np.uint32)
    jspec = jg.make_grep_spec(jnp.asarray(PATTERNS, jnp.int32), CHUNK)
    jcfg = jsh.SecureShuffleConfig(key_words=jch.key_to_words(KEY),
                                   nonce_words=jch.nonce_to_words(NONCE), counter0=COUNTER0)
    for s in range(r):
        jk, jv = jspec.map_fn({"cursor": jnp.uint32(cursor)},
                              {"t": jnp.asarray(t.reshape(r, -1)[s])}, round_id)
        np.testing.assert_array_equal(mk[s].numpy(), np.asarray(jk))
        jbk, jbv, _ = jsh.bucket_pack(jk, (jk.astype(jnp.uint32) % r).astype(jnp.int32), jv, r,
                                      CHUNK)
        jwire, jlay, _ = jsh._pack_wire_coalesced({"k": jbk, "v": jbv})
        want = jsh._crypt_wire_coalesced(jwire, jlay, jcfg, jnp.full((r,), s, jnp.uint32),
                                         jnp.arange(r, dtype=jnp.uint32), jnp.uint32(round_id))
        np.testing.assert_array_equal(got[s], np.asarray(want))


def test_segment_sum_drops_out_of_range_like_jax():
    import jax

    rng = np.random.default_rng(4)
    vals = rng.integers(0, 5, (3, 50)).astype(np.float32)
    seg = rng.integers(-3, 12, (3, 50)).astype(np.int32)
    got = tg.segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), 9)
    for s in range(3):
        want = jax.ops.segment_sum(jnp.asarray(vals[s]), jnp.asarray(seg[s]), num_segments=9)
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))


def test_grep_count_rejects_uneven_split():
    with pytest.raises(ValueError, match="must split"):
        tg.grep_count(np.zeros(30, np.int32), [1], VirtualMesh(2, "cpu"), n_rounds=4)
