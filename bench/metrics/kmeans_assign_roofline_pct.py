"""The map kernel's share of its roofline: the least time of every executed
round's assignment pass at its job's real (unpadded) size, over the device
time of the assignment kernel in the trace, in %."""

from bench import yardstick
from bench.common import kernel_names

KERNEL = "kmeans_assign"


def read(run):
    spent = run.trace.kernel_s(kernel_names(KERNEL))
    if spent <= 0:
        return None
    f = run.facts
    least = sum(r * yardstick.kmeans_assign_s(n, f["k"], f["d"]) for n, r in f["rounds"])
    return 100.0 * least / spent
