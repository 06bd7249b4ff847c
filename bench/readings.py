#!/usr/bin/env python3
"""The readings a cell's limits are set from, many seeds in one process.

    python3 bench/readings.py --workload <name> --seconds <s> --seeds <n>... \
        [--control-seeds <n>...]

For each seed the cell runs as `run.py` runs it (set-up, a window of
`--seconds`, the program's state freed) and its check prints the numbers
it compares, with no limit: the lower readings. For each control seed the
same run's sample is judged again with the reference put in the program's
place at the nearest precision below the configuration's (TF32 for the
k-means cells' float32, fp8 for the model's bfloat16): the upper readings.
One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == _ROOT / "bench":
    sys.path.pop(0)
sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    for var in [v for v in os.environ if v.startswith("REPRO_")]:
        del os.environ[var]  # the port's knobs at their defaults

    import torch

    from bench import common, profiling

    cs = common.cell_spec(args.workload)
    drv = common.driver(cs["traffic"]["kind"])
    for seed in args.seeds + [s for s in args.control_seeds if s not in args.seeds]:
        t0 = time.perf_counter()
        cell = drv.Cell(cs, seed=seed, device="cuda", rec=common.Recorder())
        cell.setup()
        cell.window(args.seconds, profiling.Window("cuda"))
        cell.release()
        line = {"seed": seed, "program": cell.check()}
        if hasattr(cell, "dropped_share"):
            line["moe_dropped_share"] = cell.dropped_share
        if seed in args.control_seeds:
            line["control"] = cell.control(cell.checked)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
