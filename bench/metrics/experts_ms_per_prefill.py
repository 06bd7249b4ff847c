"""Device milliseconds launched inside the port's `moe.experts` spans (the
experts' FFN and its transposes) over the `engine.prefill` spans of the
traced window: a prefill's expert computation, on the device.

Read by `bench/program_trace.py`'s `READERS["experts_ms_per_prefill"]`,
which holds the arithmetic; the cell's `--trace 1` window opens the port's
sinks for it."""

from bench import program_trace

PROGRAM = True
SAMPLE = program_trace.PREFILL_SAMPLE
read = program_trace.READERS["experts_ms_per_prefill"][1]
