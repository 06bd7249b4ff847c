"""Training (counterpart of `repro.train`): the step factory with secure
batch ingest, and the training state."""

from repro_torch.train.step import SecureIngest, init_train_state, make_train_step

__all__ = ["SecureIngest", "init_train_state", "make_train_step"]
