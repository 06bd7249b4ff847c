"""Model FLOPs of the window's decode steps (2 N_active a token, attention
over each step's real context) over the window at the bf16 peak, in %."""

from bench import yardstick


def read(run):
    f = run.facts
    flops = sum(yardstick.decode_step_flops(f["model"], f["batch"], c) for c in f["contexts"])
    return 100.0 * flops / (f["window_s"] * yardstick.PEAK_BF16)
