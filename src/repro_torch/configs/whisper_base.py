"""whisper-base — [arXiv:2212.04356; unverified].

6L d_model=512 8H d_ff=2048 vocab=51865, encoder-decoder; the conv/mel
frontend is a STUB: input_specs provides precomputed frame embeddings
(B, 1500, d_model), the standard 30 s window.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    n_encoder_layers=6,
    encoder_seq=1500,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    attn_chunk=2048,
    source="arXiv:2212.04356; unverified",
)
