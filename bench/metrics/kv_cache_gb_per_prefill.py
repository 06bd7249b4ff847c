"""Bytes a prefill writes into the serving cache, in GB (1e9 bytes): the
port's counter `engine.cache_bytes` (each layer's entries of the prompt's
tokens, as the cache holds them) over the `engine.prefill` spans of the
traced window.

Exact, from shapes: L x B x T x (the entries a token keeps) x the itemsize.
With latent attention a token keeps its latent and its rotary key (512 +
64 values a layer at Moonlight's widths), where expanded per-head keys and
values would be 16 x (192 + 128): a guard that the cache stays latent."""

from bench import program_trace

PROGRAM = True
SAMPLE = {"spans": [("engine.prefill", 0.62, 0.98)],
          "counts": {"engine.cache_bytes": 1_019_215_872}}


def read(run):
    written = run.trace.sinks.counts.get("engine.cache_bytes", 0)
    prefills = sum(1 for s in program_trace.program_spans(run.trace) if s[0] == "engine.prefill")
    return written / prefills / 1e9 if written and prefills else None
