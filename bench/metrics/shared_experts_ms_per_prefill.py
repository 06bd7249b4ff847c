"""Device milliseconds launched inside the port's `moe.shared` spans (the
shared experts' SwiGLU over every token of a MoE layer, and its gate where
the model has one) over the `engine.prefill` spans of the traced window: a
prefill's shared experts, on the device. Nothing to read where the model
has no shared expert.

`moe.shared` lies inside `moe.combine` in a prefill; device time goes to the
innermost span."""

from bench import program_trace

PROGRAM = True
SAMPLE = {"spans": [("engine.prefill", 0.62, 0.98), ("moe.combine", 0.90, 0.97),
                    ("moe.shared", 0.91, 0.95)],
          "events": [("gemm", 0.92, 0.94, 0.911)]}
read = program_trace.device_ms_per("moe.shared", "engine.prefill")
