"""MAC-verified, atomic checkpoints (counterpart of `repro.checkpoint`)."""

from repro_torch.checkpoint.manager import CheckpointError, CheckpointManager

__all__ = ["CheckpointError", "CheckpointManager"]
