"""Useful operations of the rounds the window's jobs executed (distances
and sums at each job's real size) over the traced window at the TF32 peak,
in %: the whole round's share of the chip, which bounds its kernels'."""

from bench import yardstick


def read(run):
    f = run.facts
    flops = sum(r * yardstick.kmeans_round_flops(n, f["k"], f["d"]) for n, r in f["rounds"])
    return 100.0 * flops / (run.trace.window_s * yardstick.PEAK_TF32)
