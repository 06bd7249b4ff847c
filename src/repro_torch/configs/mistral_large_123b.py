"""mistral-large-123b — [hf:mistralai/Mistral-Large-Instruct-2407; unverified].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    attn_chunk=1024,
    source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
)
