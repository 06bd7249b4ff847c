"""Expert entries the port dropped past capacity, as a share of those it
routed (B·T·k a MoE layer), over the traced window's prefills, in %: the
port's counters `moe.dropped_entries` over `moe.routed_entries`, summed on
the card and read once when the sinks close.

A guard against departing from the configuration, not a lever on the
throughput it names: the capacity factor and the seed's routing fix the
share. A lower reading means more expert work and a slower prefill, a
higher one entries dropped beyond the configuration's rule.

Read by `bench/program_trace.py`'s `READERS["moe_dropped_pct.prefill"]`,
which holds the arithmetic; the cell's `--trace 1` window opens the port's
sinks for it."""

from bench import program_trace

PROGRAM = True
SAMPLE = program_trace.PREFILL_SAMPLE
read = program_trace.READERS["moe_dropped_pct.prefill"][1]
