"""Device milliseconds launched inside the port's `engine.attention` spans
(ln1, the QKV projections and rope, the fused attention kernel, the
out-projection and the KV store) over the `engine.prefill` spans of the
traced window: a prefill's attention, on the device.

Read by `bench/program_trace.py`'s `READERS["attention_ms_per_prefill"]`,
which holds the arithmetic; the cell's `--trace 1` window opens the port's
sinks for it."""

from bench import program_trace

PROGRAM = True
SAMPLE = program_trace.PREFILL_SAMPLE
read = program_trace.READERS["attention_ms_per_prefill"][1]
