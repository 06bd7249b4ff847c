"""The fused attention kernel's share of its roofline in the prefill: the
causal score and value products of every layer of the window's prefills
(the configuration's reference module counts them from shapes: 4 B H Dh
T (T + 1) / 2 a layer for grouped-query attention) at the bf16 peak, over
the kernel's device time in the trace, in %."""

from bench import yardstick
from bench.common import kernel_names

KERNEL = "attention_prefill"
SAMPLE = {"events": [("attention_prefill_kernel", 0.62, 0.68)]}


def read(run):
    spent = run.trace.kernel_s(kernel_names(KERNEL))
    if spent <= 0:
        return None
    f = run.facts
    return 100.0 * f["prefills"] * f["attention_flops"] / (yardstick.PEAK_BF16 * spent)
