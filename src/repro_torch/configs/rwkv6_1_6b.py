"""rwkv6-1.6b "Finch" — [arXiv:2404.05892; unverified]. Attention-free.

24L d_model=2048 d_ff=7168 vocab=65536; data-dependent per-channel decay.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    source="arXiv:2404.05892; unverified",
)
