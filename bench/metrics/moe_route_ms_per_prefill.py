"""Device milliseconds launched inside the port's `moe.route` spans (the
split, the router, the sort, `bucket_pack`) over the `engine.prefill`
spans of the traced window: a prefill's expert routing, on the device.

Read by `bench/program_trace.py`'s `READERS["moe_route_ms_per_prefill"]`,
which holds the arithmetic; the cell's `--trace 1` window opens the port's
sinks for it."""

from bench import program_trace

PROGRAM = True
SAMPLE = program_trace.PREFILL_SAMPLE
read = program_trace.READERS["moe_route_ms_per_prefill"][1]
