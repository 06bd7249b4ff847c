"""Model FLOPs of the window's decode steps (2 N_active a token, attention
over each step's real context, as the configuration's reference module
counts them) over the window at the bf16 peak, in %."""

from bench import yardstick


def read(run):
    f = run.facts
    return 100.0 * f["decode_flops"] / (f["window_s"] * yardstick.PEAK_BF16)
