"""Fused causal self-attention of a prefill: the Hopper kernel (`kernel.py`).
Its plain version is the model's own `attend`, and its dispatch
`models.attention.prefill_self_attention`."""
