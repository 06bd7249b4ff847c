"""Port word count (repro_torch.core.wordcount) against repro.core.wordcount.

Exact comparisons of the float32 counts and the drop count on numpy-seeded
tokens, secure and plaintext, at R=1 in process and R=8 in a subprocess
with 8 forced host devices. The tokens hold -1 padding (which the
reference's combiner counts toward word 0) and ids past the vocabulary
(which its segment sum drops); the port keeps both behaviours.
"""

import numpy as np
import pytest

from conftest import run_in_subprocess
from repro.crypto import chacha as jch
from repro_torch import VirtualMesh
from repro_torch.convert import secure_config
from repro_torch.core import wordcount as tw

KEY = bytes(range(32))
NONCE = b"\x0d" * 12
COUNTER0 = 2
VOCAB = 40


def _tokens(r: int) -> np.ndarray:
    rng = np.random.default_rng(8)
    t = np.minimum(rng.zipf(1.2, 96 * r), VOCAB + 3) - 1  # a few ids past the vocabulary
    t[rng.random(t.size) < 0.05] = -1
    return t.astype(np.int32)


_REF = """
import numpy as np, jax
from repro.compat import make_mesh
from repro.core.wordcount import wordcount
from repro.core.shuffle import SecureShuffleConfig
from repro.crypto import chacha
R = {r}
mesh = make_mesh((R,), ("data",), devices=jax.devices()[:R])
cfg = SecureShuffleConfig(key_words=chacha.key_to_words({key!r}),
                          nonce_words=chacha.nonce_to_words({nonce!r}), counter0={c0})
t = np.load({tpath!r})
out = {{}}
for name, sec in (("secure", cfg), ("plain", None)):
    c, d = wordcount(t, {vocab}, mesh, secure=sec)
    out[name + "_counts"], out[name + "_dropped"] = np.asarray(c), np.asarray(d)
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module", params=[1, 8])
def ref(request, tmp_path_factory):
    r = request.param
    d = tmp_path_factory.mktemp(f"wordcount_ref{r}")
    np.save(d / "t.npy", _tokens(r))
    code = _REF.format(r=r, key=KEY, nonce=NONCE, c0=COUNTER0, tpath=str(d / "t.npy"),
                       vocab=VOCAB, path=str(d / "ref.npz"))
    if r == 1:
        exec(code, {})
    else:
        run_in_subprocess(code, devices=r)
    return r, dict(np.load(d / "ref.npz"))


@pytest.mark.parametrize("secure", [True, False], ids=["secure", "plain"])
def test_wordcount_matches_jax(ref, secure):
    r, want = ref
    name = "secure" if secure else "plain"
    cfg = secure_config(jch.key_to_words(KEY), jch.nonce_to_words(NONCE), COUNTER0) \
        if secure else None
    t = _tokens(r)
    counts, dropped = tw.wordcount(t, VOCAB, VirtualMesh(r, "cpu"), secure=cfg)
    np.testing.assert_array_equal(counts.numpy(), want[name + "_counts"])
    assert int(dropped) == int(want[name + "_dropped"]) == 0
    # numpy: -1 counts toward word 0, ids past the vocabulary are dropped
    expect = np.bincount(np.where(t >= 0, t, 0), minlength=VOCAB + 3)[:VOCAB]
    np.testing.assert_array_equal(counts.numpy(), expect.astype(np.float32))


def test_wordcount_secure_equals_plain_odd_vocab():
    rng = np.random.default_rng(1)
    t = rng.integers(0, 13, 6 * 40).astype(np.int32)
    mesh = VirtualMesh(6, "cpu")
    cfg = secure_config(jch.key_to_words(KEY), jch.nonce_to_words(NONCE), COUNTER0)
    sec, d1 = tw.wordcount(t, 13, mesh, secure=cfg)
    plain, d2 = tw.wordcount(t, 13, mesh)
    np.testing.assert_array_equal(sec.numpy(), plain.numpy())
    np.testing.assert_array_equal(sec.numpy(), np.bincount(t, minlength=13).astype(np.float32))
    assert int(d1) == int(d2) == 0
