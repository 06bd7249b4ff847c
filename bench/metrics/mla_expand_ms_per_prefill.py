"""Device milliseconds launched inside the port's `mla.expand` spans (latent
attention's W_kvb product, which expands the cached latent to per-head keys
and values, and the keys' assembly with the shared rotary key) over the
`engine.prefill` spans of the traced window: a prefill's latent expansion,
on the device. Nothing to read where the model has no latent attention.

`mla.expand` lies inside `engine.attention`: its time is taken out of
`attention_ms_per_prefill`'s reading (device time goes to the innermost
span), so the two add up to the attention layer's."""

from bench import program_trace

PROGRAM = True
SAMPLE = {"spans": [("engine.prefill", 0.62, 0.98), ("engine.attention", 0.63, 0.70),
                    ("mla.expand", 0.64, 0.66)],
          "events": [("gemm", 0.645, 0.655, 0.641)]}
read = program_trace.device_ms_per("mla.expand", "engine.prefill")
