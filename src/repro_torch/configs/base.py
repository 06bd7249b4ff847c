"""Architecture + shape configuration schema (one config file per arch)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim
    shared_d_ff: int = 0
    moe_dispatch: str = "shuffle"  # "shuffle" (paper technique) | "dense"
    capacity_factor: float = 1.25
    secure_moe: bool = False  # encrypt expert all_to_all payloads
    first_dense_layers: int = 0  # moe: layers [0, n) are dense MLP blocks of d_ff
    router: str = "softmax"  # "softmax" | "sigmoid_bias" (biased choice, unbiased gates)
    routed_scaling: float = 1.0  # the routed experts' gates times this
    shared_expert_gate: bool = True  # False: the shared experts add ungated

    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0  # hybrid: shared attention block every N ssm layers

    # attention
    attention: str = "gqa"  # "gqa" | "mla" (multi-head latent attention)
    kv_lora_rank: int = 0  # mla: the cached latent's width
    qk_nope_head_dim: int = 0  # mla: a head's query/key columns without rotation
    qk_rope_head_dim: int = 0  # mla: ... with rotation (the key's shared by all heads)
    v_head_dim: int = 0  # mla: a head's value width
    rope_theta: float = 10000.0
    causal: bool = True
    qk_norm: bool = False
    attn_chunk: int = 0  # 0 -> dense attention; else query-chunked (memory-safe)

    # encoder-decoder
    n_encoder_layers: int = 0
    encoder_seq: int = 0  # fixed encoder frames (audio frontend stub)

    # misc
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6  # rmsnorm's
    act: str = "silu"
    tie_embeddings: bool = False  # not read: the output is the embedding unless separate_head
    separate_head: bool = False  # an output head of its own (`head.table`)
    dtype: str = "bfloat16"
    remat: str = "sqrt"  # sqrt (two-level) | full | dots | none
    # perf knobs (hillclimbed in EXPERIMENTS.md §Perf)
    softmax_dtype: str = "float32"  # "bfloat16": halve attention-score bytes
    moe_remat: str = "full"  # "save_shuffle": don't replay all_to_all in bwd
    shard_strategy: str = "tp"  # "dp_sp": replicate weights, shard sequence
    wkv_impl: str = "blocked"  # "scan": paper-faithful per-token recurrence
    serve_bf16_params: bool = False  # serve with bf16 weights (no f32 masters)
    moe_fsdp: bool = True  # False: replicate expert weights across dp (no per-layer AG)
    source: str = ""  # provenance bracket from the assignment

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def n_moe_layers(self) -> int:
        """Layers of a moe model that are MoE blocks (after the dense ones)."""
        return self.n_layers - self.first_dense_layers if self.family == "moe" else 0

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 256 (Megatron-style) so the
        vocab dim shards evenly over any mesh axis; pad logits are masked."""
        return -(-self.vocab_size // 256) * 256

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / linear attention)."""
        return self.family in ("ssm", "hybrid")

    def reduced(self) -> "ArchConfig":
        """Smoke-test scale: same family/topology, tiny dims."""
        return replace(
            self,
            n_layers=min(self.n_layers, 2 + (2 if self.attn_every else 0)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_head=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 8),
            n_experts_per_tok=min(self.n_experts_per_tok, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_d_ff=32 if self.moe_d_ff else 0,
            shared_d_ff=64 if self.shared_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            attn_every=2 if self.attn_every else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            kv_lora_rank=min(self.kv_lora_rank, 32),
            qk_nope_head_dim=min(self.qk_nope_head_dim, 16),
            qk_rope_head_dim=min(self.qk_rope_head_dim, 8),
            v_head_dim=min(self.v_head_dim, 16),
            dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


# The assigned shape set (applies to every LM arch; skips handled per-arch).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_skips(arch: ArchConfig) -> dict[str, str]:
    """Cells skipped for this arch, with reasons (recorded in EXPERIMENTS.md)."""
    skips = {}
    if not arch.sub_quadratic:
        skips["long_500k"] = "full-attention arch: 500k KV decode requires sub-quadratic attention (DESIGN.md §5)"
    return skips
