"""SecurePager — the enclave-paging (EPC) analogue.

Counterpart of `repro/core/paging.py`, over the port's host ChaCha20 and
host MAC.

Paper §V: "one page has to be evicted from cache (and hence, encrypted),
while the one that is fetched must be decrypted and checked for integrity and
freshness (that prevents tamper and replay attacks, respectively)". The SGX
EPC limit is what produces the paper's >200 % overhead cliff at n = 1M.

This module models that mechanism explicitly: a trusted store with a byte
budget; pages evicted past the budget are ChaCha20-encrypted and MAC-tagged
with a per-page freshness counter into untrusted storage; every fetch
decrypts, verifies the tag, and checks the counter. Stats feed the paging
benchmark (Fig. 8 analogue) and the capacity-rule estimate (paper: ≈3× cache).

Cost model (for the modeled-seconds counters): a chacha20 software stream at
`CRYPTO_BYTES_PER_SEC` plus a per-page `PAGE_LATENCY_S`, calibrated against
the SGX paging cost the paper cites — these feed *modeled* overhead numbers;
wall-clock numbers in the benchmarks are real measurements of the real
cipher.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from repro_torch.crypto.chacha import chacha20_encrypt_bytes
from repro_torch.crypto.mac import mac_keys_from_keystream, mac_tag_host, mac_verify_host
from repro_torch.crypto.keys import SessionKeys

PAGE_BYTES = 4096
CRYPTO_BYTES_PER_SEC = 2.0e9  # modeled EPC encrypt/decrypt bandwidth
PAGE_LATENCY_S = 5.0e-6  # modeled per-page fault cost


class IntegrityError(RuntimeError):
    pass


class FreshnessError(RuntimeError):
    pass


@dataclass
class PagerStats:
    evictions: int = 0
    fetches: int = 0
    hits: int = 0
    bytes_encrypted: int = 0
    bytes_decrypted: int = 0
    modeled_seconds: float = 0.0
    wall_seconds: float = 0.0

    def reset(self):
        self.__init__()


class SecurePager:
    """LRU trusted store with encrypt-on-evict / verify-on-fetch semantics."""

    def __init__(self, budget_bytes: int, key: bytes, page_bytes: int = PAGE_BYTES):
        self.budget = budget_bytes
        self.page_bytes = page_bytes
        self.key = key
        self._trusted: OrderedDict[str, bytes] = OrderedDict()
        self._trusted_bytes = 0
        self._untrusted: dict[str, tuple[bytes, np.ndarray, int]] = {}
        self._fresh: dict[str, int] = {}
        self._next_ctr = 0
        self.stats = PagerStats()

    # -- internals ---------------------------------------------------------

    def _nonce(self, page_id: str) -> bytes:
        return SessionKeys.nonce("page:" + page_id)

    def _mac_keys(self, ctr: int):
        kw = np.frombuffer(self.key, dtype="<u4")
        nw = np.frombuffer(b"pager-mac---", dtype="<u4")
        return mac_keys_from_keystream(kw, nw, ctr)

    def _evict_one(self):
        page_id, data = self._trusted.popitem(last=False)
        self._trusted_bytes -= len(data)
        t0 = time.perf_counter()
        ctr = self._next_ctr
        self._next_ctr += 1
        ct = chacha20_encrypt_bytes(self.key, self._nonce(page_id), ctr, data)
        rs, ss = self._mac_keys(ctr)
        pad = (-len(ct)) % 4
        words = np.frombuffer(ct + b"\x00" * pad, dtype="<u4")
        tag = mac_tag_host(words, rs, ss)
        self._untrusted[page_id] = (ct, tag, ctr)
        self._fresh[page_id] = ctr
        self.stats.evictions += 1
        self.stats.bytes_encrypted += len(ct)
        self.stats.modeled_seconds += len(ct) / CRYPTO_BYTES_PER_SEC + PAGE_LATENCY_S
        self.stats.wall_seconds += time.perf_counter() - t0

    def _make_room(self, nbytes: int):
        while self._trusted and self._trusted_bytes + nbytes > self.budget:
            self._evict_one()

    # -- public API ----------------------------------------------------------

    def store(self, page_id: str, data: bytes):
        if page_id in self._trusted:
            self._trusted_bytes -= len(self._trusted.pop(page_id))
        self._untrusted.pop(page_id, None)
        self._make_room(len(data))
        self._trusted[page_id] = data
        self._trusted_bytes += len(data)

    def load(self, page_id: str) -> bytes:
        if page_id in self._trusted:
            self._trusted.move_to_end(page_id)
            self.stats.hits += 1
            return self._trusted[page_id]
        if page_id not in self._untrusted:
            raise KeyError(page_id)
        t0 = time.perf_counter()
        ct, tag, ctr = self._untrusted.pop(page_id)
        if self._fresh.get(page_id) != ctr:
            raise FreshnessError(f"replayed page {page_id}")  # replay protection
        rs, ss = self._mac_keys(ctr)
        pad = (-len(ct)) % 4
        words = np.frombuffer(ct + b"\x00" * pad, dtype="<u4")
        if not mac_verify_host(words, rs, ss, tag):
            raise IntegrityError(f"tampered page {page_id}")
        data = chacha20_encrypt_bytes(self.key, self._nonce(page_id), ctr, ct)
        self.stats.fetches += 1
        self.stats.bytes_decrypted += len(ct)
        self.stats.modeled_seconds += len(ct) / CRYPTO_BYTES_PER_SEC + PAGE_LATENCY_S
        self.stats.wall_seconds += time.perf_counter() - t0
        self._make_room(len(data))
        self._trusted[page_id] = data
        self._trusted_bytes += len(data)
        return data

    def tamper(self, page_id: str, byte_index: int = 0):
        """Test hook: flip a ciphertext bit in untrusted storage."""
        ct, tag, ctr = self._untrusted[page_id]
        buf = bytearray(ct)
        buf[byte_index] ^= 1
        self._untrusted[page_id] = (bytes(buf), tag, ctr)

    def replay(self, page_id: str, stale: tuple):
        """Test hook: put back a previously captured (ct, tag, ctr) blob."""
        self._untrusted[page_id] = stale

    def capture(self, page_id: str):
        return self._untrusted[page_id]

    @property
    def trusted_bytes(self) -> int:
        return self._trusted_bytes
