"""ChaCha20 (RFC 8439), counter-mode encryption of tensors, the universal
MAC and the key hierarchy: the counterpart of `repro.crypto`, with the same
exports. The hand-written ChaCha20 kernel is `repro_torch.kernels.chacha20`."""

from repro_torch.crypto.chacha import (
    chacha20_block_words,
    chacha20_encrypt_bytes,
    chacha20_keystream_words,
    key_to_words,
    nonce_to_words,
)
from repro_torch.crypto.ctr import decrypt_array, decrypt_tree, encrypt_array, encrypt_tree
from repro_torch.crypto.keys import KeyHierarchy, SessionKeys, derive_key
from repro_torch.crypto.mac import mac_tag_host, mac_tag_words, mac_verify_host

__all__ = [
    "chacha20_block_words",
    "chacha20_encrypt_bytes",
    "chacha20_keystream_words",
    "key_to_words",
    "nonce_to_words",
    "encrypt_array",
    "decrypt_array",
    "encrypt_tree",
    "decrypt_tree",
    "mac_tag_words",
    "mac_tag_host",
    "mac_verify_host",
    "KeyHierarchy",
    "SessionKeys",
    "derive_key",
]
