"""Serving: the persistent secure job service and its runner cache."""

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
           "default_runner_cache", "resolve_bucket_growth", "resolve_max_resident"]
