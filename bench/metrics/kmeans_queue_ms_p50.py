"""Median wait of the window's k-means jobs before the service admitted
them (`JobHandle.queue_s`, the service's own host clock), in ms."""

from bench.common import quantile


def read(run):
    waits = [q for q in run.facts["queue_s"] if q is not None]
    return 1e3 * quantile(waits, 0.5) if waits else None
