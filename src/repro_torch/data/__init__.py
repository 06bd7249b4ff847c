"""Input pipeline (counterpart of `repro.data`): synthetic token streams and
the secure sharded source that feeds the training step ciphertext."""

from repro_torch.data.pipeline import SecureShardedSource
from repro_torch.data.synthetic import batches, synthetic_tokens

__all__ = ["SecureShardedSource", "batches", "synthetic_tokens"]
