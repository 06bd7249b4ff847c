"""Benchmark of the PyTorch and CUDA port (`repro_torch`) on one H100.

`python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once. Configurations, traffic mixes,
limits and per-layer metrics are files of their own, found by name (see
`run.py`); the plain references under `reference/` import nothing of the
port.
"""
