"""Calibrated performance model of the port.

`calibrate` runs micro-probes once per (backend, device count) and keeps them
as a calibration JSON; `model` combines a calibration with one round's own
records (wire bytes and keystream blocks from `core/shuffle.py`'s accounting,
device operations from `tools/opcount.py`) into per-round, capture-time and
wire-byte predictions, and answers the `auto` resolvers' knob questions.
With no calibration active every resolver keeps its historical default bit
for bit. The package imports neither module, so `python -m
repro_torch.perf.calibrate` runs it once.
"""
