"""Model FLOPs of the window's prefills (the configuration's reference
module counts them: 2 N_active a token, causal attention once) over their
time on the host clock, first start to last end, at the bf16 peak, in %."""

from bench import yardstick


def read(run):
    f = run.facts
    return 100.0 * f["prefills"] * f["prefill_flops"] / (f["span_s"] * yardstick.PEAK_BF16)
