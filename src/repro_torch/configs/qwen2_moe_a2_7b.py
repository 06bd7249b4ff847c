"""qwen2-moe-a2.7b — [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, 4 shared + 60
routed experts top-4 (shared-expert hidden = 4x1408 = 5632).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    moe_d_ff=1408,
    shared_d_ff=5632,
    vocab_size=151936,
    n_experts=60,
    n_experts_per_tok=4,
    n_shared_experts=4,
    attn_chunk=2048,
    moe_remat="save_shuffle",  # §Perf cell C: -14% mem, -17% coll, -28% compute
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)
