"""Serving: the persistent secure job service and its runner cache, and the
LM engine (KV cache, prefill, decode)."""

from repro_torch.serve.engine import decode_step, init_cache, prefill
from repro_torch.serve.service import (
    JobHandle,
    RunnerCache,
    SecureJobService,
    bucket_for,
    default_runner_cache,
    resolve_bucket_growth,
    resolve_max_resident,
)

__all__ = ["JobHandle", "RunnerCache", "SecureJobService", "bucket_for",
           "decode_step", "default_runner_cache", "init_cache", "prefill",
           "resolve_bucket_growth", "resolve_max_resident"]
