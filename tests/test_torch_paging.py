"""The port's SecurePager: the reference's five tests (`tests/test_paging.py`)
on `repro_torch.core.paging`, and one sequence of stores and loads through
both packages' pagers giving the same sealed pages and the same counts."""

import numpy as np
import pytest

from repro.core import paging as jpaging
from repro_torch.core.paging import PAGE_BYTES, FreshnessError, IntegrityError, SecurePager

KEY = b"\x11" * 32


def test_under_budget_no_paging():
    p = SecurePager(budget_bytes=1 << 20, key=KEY)
    for i in range(10):
        p.store(f"p{i}", bytes(1000))
    for i in range(10):
        p.load(f"p{i}")
    assert p.stats.evictions == 0 and p.stats.fetches == 0 and p.stats.hits == 10


def test_eviction_and_fetch_roundtrip():
    p = SecurePager(budget_bytes=4096, key=KEY)
    data = {f"p{i}": bytes([i]) * 2048 for i in range(4)}
    for k, v in data.items():
        p.store(k, v)
    assert p.stats.evictions >= 2
    for k, v in data.items():
        assert p.load(k) == v
    assert p.stats.fetches >= 2
    assert p.stats.bytes_encrypted > 0 and p.stats.modeled_seconds > 0


def test_tamper_detected():
    p = SecurePager(budget_bytes=2048, key=KEY)
    p.store("a", b"x" * 2048)
    p.store("b", b"y" * 2048)  # evicts a
    p.tamper("a", 10)
    with pytest.raises(IntegrityError):
        p.load("a")


def test_replay_detected():
    p = SecurePager(budget_bytes=2048, key=KEY)
    p.store("a", b"1" * 2048)
    p.store("b", b"2" * 2048)  # evicts a
    stale = p.capture("a")
    p.load("a")  # fetch a back (evicts b), trusted again
    p.store("c", b"3" * 2048)  # evict a again with a NEW counter
    p.replay("a", stale)
    with pytest.raises(FreshnessError):
        p.load("a")


def test_working_set_cliff_shape():
    """Paging volume explodes once the working set exceeds the budget."""
    budget = 64 * 1024
    page = 4096

    def paged_bytes(working_set_pages):
        p = SecurePager(budget_bytes=budget, key=KEY)
        ids = [f"p{i}" for i in range(working_set_pages)]
        for i in ids:
            p.store(i, bytes(page))
        for _ in range(3):  # three sequential sweeps (k-means iterations)
            for i in ids:
                p.load(i)
        return p.stats.bytes_encrypted + p.stats.bytes_decrypted

    fits = paged_bytes(8)  # 32 KB working set < 64 KB budget
    over = paged_bytes(64)  # 256 KB working set > 64 KB budget
    assert fits == 0
    assert over > 100 * max(fits, 1)


def test_pager_seals_pages_as_the_reference():
    """The same stores and loads through both pagers: identical ciphertext,
    MAC tag and freshness counter for every evicted page, identical loads
    and identical counts (wall seconds aside)."""
    assert PAGE_BYTES == jpaging.PAGE_BYTES == 4096
    rng = np.random.default_rng(4)
    pages = {f"p{i}": rng.integers(0, 256, int(rng.integers(1, 3000)), np.uint8).tobytes()
             for i in range(12)}
    ops = [("store", k) for k in pages] + [("load", f"p{int(i)}") for i in
                                           rng.integers(0, 12, 40)]
    pagers = [SecurePager(budget_bytes=8192, key=KEY),
              jpaging.SecurePager(budget_bytes=8192, key=KEY)]
    for op, k in ops:
        if op == "store":
            for p in pagers:
                p.store(k, pages[k])
        else:
            assert pagers[0].load(k) == pagers[1].load(k) == pages[k]
    t, j = pagers
    assert set(t._untrusted) == set(j._untrusted)
    for k in t._untrusted:
        (tc, tt, tn), (jc, jt, jn) = t.capture(k), j.capture(k)
        assert tc == jc and tn == jn
        np.testing.assert_array_equal(tt, jt)
    fields = ("evictions", "fetches", "hits", "bytes_encrypted", "bytes_decrypted",
              "modeled_seconds")
    assert [getattr(t.stats, f) for f in fields] == [getattr(j.stats, f) for f in fields]
    assert t.trusted_bytes == j.trusted_bytes and t.stats.evictions > 10
