"""Port input pipeline (repro_torch.data) against the JAX reference (repro.data).

`synthetic_tokens` and `batches` are numpy copies and must give the same
tokens exactly; `SecureShardedSource` must give the reference's ciphertext
and counter bit for bit, batch after batch and across a `state`/`restore`
resume; the train step's decryption recovers the plaintext batch.
"""

import json

import numpy as np
import pytest
import torch

from repro.crypto.keys import make_session_keys as jkeys
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro_torch.crypto.keys import make_session_keys as tkeys
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn
from repro_torch.train.step import SecureIngest, decrypt_batch

MASTER = b"\x21" * 32


@pytest.mark.parametrize("n,vocab,seed,noise", [(2000, 256, 1, 0.3), (5000, 49155, 0, 0.3),
                                                (300, 7, 4, 0.0), (300, 64, 2, 1.0)])
def test_synthetic_tokens_equal_reference(n, vocab, seed, noise):
    got = tsyn.synthetic_tokens(n, vocab, seed=seed, noise=noise)
    want = jsyn.synthetic_tokens(n, vocab, seed=seed, noise=noise)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_batches_equal_reference():
    toks = tsyn.synthetic_tokens(1000, 256, seed=3)
    got, want = tsyn.batches(toks, 4, 16, seed=5), jsyn.batches(toks, 4, 16, seed=5)
    for _ in range(5):
        np.testing.assert_array_equal(next(got), next(want))


def _sources(batch, seq, seed, n=3000, vocab=256):
    toks = tsyn.synthetic_tokens(n, vocab, seed=1)
    port = tpipe.SecureShardedSource(toks, batch=batch, seq=seq, session=tkeys(MASTER),
                                     seed=seed, device="cpu")
    ref = jpipe.SecureShardedSource(toks, batch=batch, seq=seq, session=jkeys(MASTER),
                                    seed=seed)
    return port, ref


@pytest.mark.parametrize("batch,seq,seed", [(2, 16, 3), (4, 64, 0), (3, 7, 9)])
def test_secure_source_ciphertext_and_counter_equal_reference(batch, seq, seed):
    """Four batches: the same ciphertext bits and counters; the counter is a
    0-d tensor on the source's device."""
    port, ref = _sources(batch, seq, seed)
    for _ in range(4):
        got, want = port.next_batch(), ref.next_batch()
        assert got["tokens"].dtype == torch.int32 and got["tokens"].shape == (batch, seq)
        np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
        assert got["ctr"].dim() == 0 and int(got["ctr"]) == int(want["ctr"])
    assert port.state["ctr"] == ref.state["ctr"]


def test_secure_source_state_restores_exactly():
    """A source restored from another's JSON-round-tripped state (as a
    checkpoint's `extra` carries it) continues that stream bit for bit,
    and so does the reference restored from the port's state."""
    port, ref = _sources(2, 16, 3)
    for _ in range(2):
        port.next_batch()
        ref.next_batch()
    state = json.loads(json.dumps(port.state))
    assert state == json.loads(json.dumps(ref.state))
    resumed, ref_resumed = _sources(2, 16, 99)
    resumed.restore(state)
    ref_resumed.restore(json.loads(json.dumps(port.state)))
    for _ in range(3):
        want = port.next_batch()
        for got in (resumed.next_batch(), ref_resumed.next_batch()):
            np.testing.assert_array_equal(np.asarray(got["tokens"]), want["tokens"].numpy())
            assert int(got["ctr"]) == int(want["ctr"])


def test_step_decryption_recovers_the_batch():
    """The train step's ingest (decrypt at the batch's counter) gives the
    plaintext that `batches` draws from the same seed; without ingest the
    counter is dropped and the tokens pass as they are."""
    toks = tsyn.synthetic_tokens(3000, 256, seed=1)
    src = tpipe.SecureShardedSource(toks, batch=4, seq=16, session=tkeys(MASTER), seed=7,
                                    device="cpu")
    plain = tsyn.batches(toks, 4, 16, seed=7)
    session = tkeys(MASTER)
    ingest = SecureIngest(key_words=session.words("data"),
                          nonce_words=session.nonce_words("data", 0))
    for _ in range(3):
        batch = src.next_batch()
        want = next(plain)
        assert not np.array_equal(batch["tokens"].numpy(), want)
        got = decrypt_batch(batch, ingest)
        assert set(got) == {"tokens"}
        np.testing.assert_array_equal(got["tokens"].numpy(), want)
        assert decrypt_batch(batch, None)["tokens"] is batch["tokens"]
