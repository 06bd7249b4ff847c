"""Device milliseconds launched inside the port's `shuffle.exchange` spans
(pack, encrypt, transpose, decrypt, unpack; one a leg) over the
`engine.prefill` spans of the traced window: a prefill's encrypted expert
exchange, on the device.

Read by `bench/program_trace.py`'s `READERS["exchange_ms_per_prefill"]`,
which holds the arithmetic; the cell's `--trace 1` window opens the port's
sinks for it."""

from bench import program_trace

PROGRAM = True
SAMPLE = program_trace.PREFILL_SAMPLE
read = program_trace.READERS["exchange_ms_per_prefill"][1]
