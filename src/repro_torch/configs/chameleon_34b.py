"""chameleon-34b — [arXiv:2405.09818; unverified]. Early-fusion VLM.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 with VQ image tokens
in-vocab; qk-norm per the paper. The VQ tokenizer frontend is a STUB:
input_specs provides token ids (image tokens are ordinary vocab entries).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    attn_chunk=2048,
    source="arXiv:2405.09818; unverified",
)
