"""Plain references: ChaCha20 per RFC 8439, Lloyd's k-means, and the
granite-moe forward pass, in plain PyTorch. They import nothing of the
program under test and take only what the benchmark made."""
