"""ChaCha20 keystream XOR: Hopper kernel, plain version and layout wrappers."""
