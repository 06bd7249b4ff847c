"""moonlight-16b-a3b — [hf:moonshotai/Moonlight-16B-A3B; config.json].

The published config (model_type deepseek_v3): 27 layers, hidden 2048, 16
heads of multi-head latent attention (q_lora_rank null: q projected
straight from the hidden state, the one query projection the port
implements; kv_lora_rank 512, qk_nope_head_dim 128, qk_rope_head_dim 64,
v_head_dim 128), vocabulary
163,840 with an untied output head, rms_norm_eps 1e-5, rope_theta 50,000
(no scaling), context 8,192. Layer 0 is a dense SwiGLU MLP of 11,264
(first_k_dense_replace 1); layers 1-26 hold 64 routed experts of 1,408,
top-6, and 2 shared experts (one SwiGLU of 2 x 1,408, ungated). The router
is noaux_tc: sigmoid scores, the top 6 of score + e_score_correction_bias
chosen (n_group = topk_group = 1), the chosen experts' unbiased scores
renormalised (norm_topk_prob) times routed_scaling_factor 2.446.

Not one of the reference's ten: the port's own (`configs.PORT_ARCH_IDS`).
Rotary embeddings rotate the 64 rope columns in the port's half-split
convention (the published model's interleaved one is a fixed permutation
of W_q's and W_kva's rope columns).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonlight-16b-a3b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,
    moe_d_ff=1408,
    shared_d_ff=2816,
    vocab_size=163840,
    n_experts=64,
    n_experts_per_tok=6,
    n_shared_experts=2,
    first_dense_layers=1,
    router="sigmoid_bias",
    routed_scaling=2.446,
    shared_expert_gate=False,
    attention="mla",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=50000.0,
    norm_eps=1e-5,
    separate_head=True,
    attn_chunk=2048,
    moe_remat="save_shuffle",
    source="hf:moonshotai/Moonlight-16B-A3B; config.json",
)
