"""ChaCha20 (RFC 8439) and counter-mode encryption of tensors."""
