"""AdamW and the learning-rate schedule (counterpart of `repro.optim`)."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "warmup_cosine"]
