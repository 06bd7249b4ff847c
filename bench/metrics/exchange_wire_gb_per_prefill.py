"""Bytes on the expert exchange's wire in one prefill, every shard's, as
`core.shuffle.record_wire_bytes` counts them, in GB (1e9 bytes)."""


def read(run):
    wire = run.facts["wire_bytes"]
    return wire[-1] / 1e9 if wire and wire[-1] else None
