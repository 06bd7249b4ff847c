"""zamba2-1.2b — [arXiv:2411.15242; hf]. Mamba2 backbone + shared attn.

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64; one
weight-shared attention(+MLP) block applied every 6 mamba layers
(simplified vs upstream: no per-invocation LoRA, no embedding concat —
noted in DESIGN.md).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    attn_every=6,
    attn_chunk=2048,
    source="arXiv:2411.15242; hf",
)
