"""Key hierarchy + simulated attestation / session establishment.

Counterpart of `repro/crypto/keys.py`, over the port's host ChaCha20: the
same labels, nonces and derivations, so both packages derive the same keys
from one master key.

The paper leaves key provisioning to its SCBR predecessor [12]: subscriptions
and publication *headers* use one key, payloads another, and enclaves receive
keys after (SGX remote) attestation. We keep the protocol flow and simulate
the hardware quote:

  master key (client / data owner)
    ├── k_header   — pub/sub headers + subscriptions (router enclave key)
    ├── k_code     — map/reduce code payloads (worker enclave key)
    ├── k_data     — data split payloads
    ├── k_shuffle  — mapper→reducer traffic
    └── k_page     — SecurePager page encryption + MAC

Derivation is a ChaCha20-as-PRF expand: subkey = keystream(master,
nonce=H(label), counter=0)[:32], i.e. HKDF-expand shape with the block
function as PRF. Workers "attest" by presenting a measurement (a hash of
their code identity); the client releases wrapped session keys only for
expected measurements — `Attestation.verify` is where a real SGX quote check
would sit.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from repro_torch.crypto.chacha import chacha20_encrypt_bytes, key_to_words, nonce_to_words

LABELS = ("header", "code", "data", "shuffle", "page", "aggregate")


def _label_nonce(label: str) -> bytes:
    return hashlib.sha256(b"repro.kdf:" + label.encode()).digest()[:12]


def derive_key(master: bytes, label: str) -> bytes:
    """Derive a 32-byte subkey from `master` for `label` (ChaCha20 PRF expand)."""
    if len(master) != 32:
        raise ValueError("master key must be 32 bytes")
    return chacha20_encrypt_bytes(master, _label_nonce(label), 0, b"\x00" * 32)


@dataclass(frozen=True)
class SessionKeys:
    """Per-job session keys, as word arrays ready for use on the device."""

    header: bytes
    code: bytes
    data: bytes
    shuffle: bytes
    page: bytes
    aggregate: bytes

    def words(self, label: str) -> np.ndarray:
        return key_to_words(getattr(self, label))

    @staticmethod
    def nonce(label: str, stream: int = 0) -> bytes:
        """Deterministic per-(label, stream) nonce; stream = split/worker id."""
        return hashlib.sha256(f"repro.nonce:{label}:{stream}".encode()).digest()[:12]

    @staticmethod
    def nonce_words(label: str, stream: int = 0) -> np.ndarray:
        return nonce_to_words(SessionKeys.nonce(label, stream))


def make_session_keys(master: bytes) -> SessionKeys:
    return SessionKeys(**{lbl: derive_key(master, lbl) for lbl in LABELS})


@dataclass
class Attestation:
    """Simulated SGX attestation: measurement check gates key release."""

    expected_measurements: set = field(default_factory=set)

    @staticmethod
    def measure(code_identity: bytes) -> str:
        return hashlib.sha256(b"MRENCLAVE:" + code_identity).hexdigest()

    def enroll(self, code_identity: bytes) -> str:
        m = self.measure(code_identity)
        self.expected_measurements.add(m)
        return m

    def verify(self, measurement: str) -> bool:
        # A real deployment verifies an SGX quote (EPID/DCAP) here.
        return measurement in self.expected_measurements


@dataclass
class KeyHierarchy:
    """Client-held master key + attestation-gated session key release."""

    master: bytes
    attestation: Attestation = field(default_factory=Attestation)

    def __post_init__(self):
        if len(self.master) != 32:
            raise ValueError("master key must be 32 bytes")
        self.session = make_session_keys(self.master)

    def release_keys(self, measurement: str) -> SessionKeys:
        if not self.attestation.verify(measurement):
            raise PermissionError(f"attestation failed for measurement {measurement[:16]}…")
        return self.session

    def wrap_key(self, label: str, worker_kek: bytes) -> bytes:
        """Key-wrap a session key under a worker's KEK (transport form)."""
        nonce = SessionKeys.nonce("wrap:" + label)
        return chacha20_encrypt_bytes(worker_kek, nonce, 0, getattr(self.session, label))

    @staticmethod
    def unwrap_key(label: str, worker_kek: bytes, wrapped: bytes) -> bytes:
        nonce = SessionKeys.nonce("wrap:" + label)
        return chacha20_encrypt_bytes(worker_kek, nonce, 0, wrapped)
