"""Quickstart: the paper's word-count example on both execution levels.

Counterpart of `examples/quickstart.py`:

1. Cluster level -- the full pub/sub protocol: hiring, encrypted code/data
   provisioning, mapper-side shuffle, EOS counting (paper Figs. 3-4), with
   the user logic shipped as a <30-LOC script (paper Listings 1-2).
2. Device level -- the same job on the card's virtual mesh, with the
   shuffle payload ChaCha20-encrypted on the wire by the hand-written kernel.

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
(the card by default; without one it raises unless the CPU is named).
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.convert import secure_config
from repro_torch.core.wordcount import wordcount
from repro_torch.crypto import chacha
from repro_torch.device import resolve_device
from repro_torch.mesh import VirtualMesh
from repro_torch.runtime.jobs import WORDCOUNT_MAP, make_cluster, run_wordcount

LINES = [
    "the quick brown fox jumps over the lazy dog",
    "mapreduce inside enclaves keeps the data private",
    "the router only ever sees ciphertext",
] * 5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    print("=== cluster level (pub/sub protocol, simulated nodes) ===")
    print(f"user map script:\n{WORDCOUNT_MAP}")
    cluster, client, _ = make_cluster(8)
    counts, info = run_wordcount(cluster, client, LINES, n_mappers=5, n_reducers=3)
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:5]
    print(f"job finished in {info['elapsed']*1e3:.2f} virtual ms; top words: {top}")
    st = cluster.router.stats
    print(f"router: {st.publications} publications, {st.deliveries} deliveries, "
          f"{st.wire_bytes} wire bytes (all payloads encrypted)")

    print(f"\n=== device level (virtual mesh on {dev}, encrypted all-to-all) ===")
    vocab = 1000
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, 20000, dtype=np.int32)
    mesh = VirtualMesh(1, dev)
    secure = secure_config(chacha.key_to_words(bytes(range(32))),
                           chacha.nonce_to_words(b"\x01" * 12))
    hist, dropped = wordcount(tokens, vocab, mesh, secure=secure)
    assert int(dropped) == 0
    ref = np.bincount(tokens, minlength=vocab)
    np.testing.assert_array_equal(hist.cpu().numpy(), ref)
    print(f"token histogram verified over {len(tokens)} tokens, 0 dropped pairs")
    return counts, hist


if __name__ == "__main__":
    main()
