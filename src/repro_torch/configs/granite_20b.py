"""granite-20b — [arXiv:2405.04324; hf]. llama-arch, code; MQA (kv=1).

52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    attn_chunk=2048,
    source="arXiv:2405.04324; hf",
)
