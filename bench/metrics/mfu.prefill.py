"""Model FLOPs of the window's prefills (2 N_active a token, causal
attention once) over their time at the bf16 peak, in %."""

from bench import yardstick


def read(run):
    f = run.facts
    flops = f["prefills"] * yardstick.prefill_flops(f["model"], f["batch"], f["tokens"])
    return 100.0 * flops / (f["span_s"] * yardstick.PEAK_BF16)
