"""Abstract dry-run of every (arch x shape) cell on one card.

Counterpart of `repro/launch/dryrun.py`, which lowers and compiles each cell
for a 256- or 512-chip pod and reads XLA's `cost_analysis`. The port runs
eagerly and targets one card, so its counterpart runs the cell's entry
(train step, prefill or decode, as the reference's `entry_fn` builds it)
once on the `meta` device: every tensor has a shape and a dtype and no
storage, so no parameter is drawn and nothing is computed. What it counts:

  flops           `torch.utils.flop_counter.FlopCounterMode` over the entry
                  (matrix products, forward and backward, remat's recompute
                  included);
  bytes_accessed  the bytes every dispatched operation reads and writes
                  (its tensor inputs and outputs; views and allocations move
                  none): an eager run's traffic, no fusion assumed;
  device_ops, kernel_calls, collectives
                  `tools/opcount.py` (the two kernels' calls by their
                  dispatch points, whose registered fake implementations
                  give their shapes here; the virtual mesh's exchanges);
  wire_bytes      the MoE exchanges' wire records (`record_wire_bytes`);
  memory          bytes of the parameters (float32 masters for training;
                  for serving, `serve_params`: "compute" counts the compute
                  dtype, "reference" the reference's `input_specs`), the
                  optimizer state, the cache and the inputs, from the
                  tensors' sizes; their sum is
                  `peak_per_device`, and `fits_one_card` compares it with the
                  card's 80 GB (activations are not counted: an abstract run
                  holds no allocator);
  roofline        `tools/roofline.roofline_terms` at the H100's peaks.

Serving weights. The port's serving entry points hold every matrix in the
compute dtype (norm scales in float32): they serve as the reference does
under `serve_bf16_params=True`. `serve_params="compute"` (the default)
counts that. `serve_params="reference"` counts what the reference's
`launch/specs.py::input_specs` holds: its `init_params` leaves, all float32,
or all bfloat16 under `cfg.serve_bf16_params` (its norms too); the port's
serving walk casts each float32 matrix to the compute dtype where it uses
it, and that traffic is counted. Hillclimb cells A, B and C use
"reference", so that `serve_bf16_params` moves what it moves there.

MoE cells run their experts on 8 virtual shards (the port's serving and
training layout on one card), the others on one; the expert exchange is
encrypted when the config asks for it (`secure_moe`). Gradient accumulation
follows the reference's `pick_accum` with one data-parallel replica. The
production meshes, `launch/specs.py`'s NamedSharding specs and
`parallel/sharding.py`'s logical-axis rules place a cell on a pod; one card
has no placement to describe, so they have no counterpart here.

`run_cell(..., device="cpu")` runs the same entry for real on the CPU (with
seeded weights): the tests hold the abstract counts to it. `accum` replaces
`pick_accum`'s factor. `one_microbatch=True` runs a training step's first
microbatch and adds its counts again for each later one instead of running
it: every microbatch runs the same operations on tensors of the same
shapes, so the totals are the same (the tests hold both ways equal), at a
fraction of the time (the meta dispatch costs ~0.5 ms an operation on the
CPU).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape prefill_32k
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ALL_ARCH_IDS, SHAPES, get_config, get_shape, shape_skips
from repro_torch.tools.roofline import CARD_BYTES, param_counts, roofline_terms

REPORT = os.path.join(os.path.dirname(__file__), "..", "..", "..", "reports",
                      "dryrun_torch.json")
MESH = "one_card"
MOE_SHARDS = 8  # virtual expert shards of a MoE cell
_NO_TRAFFIC = ("aten.empty", "aten.new_empty", "aten.empty_like", "aten.empty_strided")
SERVE_PARAMS = ("compute", "reference")


def pick_accum(cfg, shape) -> int:
    """The reference's gradient-accumulation factor with one data-parallel
    replica: 16 microbatches past 80 B parameters, else 8, at most the batch."""
    total, _ = param_counts(cfg)
    return min(16 if total > 80e9 else 8, max(1, shape.global_batch))


class _Traffic(TorchDispatchMode):
    """Bytes each dispatched operation reads and writes: its tensor inputs
    and outputs, none for a view or an allocation."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        if not func.is_view and not name.startswith(_NO_TRAFFIC):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs or {}, out))
                              if isinstance(t, torch.Tensor))
        return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def secure_moe_config(cfg):
    """The cell's MoE exchange encryption (a fixed key), or None when the
    config asks for none."""
    if not (cfg.secure_moe and cfg.family == "moe"):
        return None
    from repro_torch.convert import secure_config
    from repro_torch.crypto import chacha

    return secure_config(chacha.key_to_words(b"\x42" * 32), chacha.nonce_to_words(b"\x0a" * 12))


def _model(cfg, n_model: int, device, param_dtype):
    """The cell's model: shapes only on `meta`, seeded weights elsewhere."""
    from repro_torch.models.lm import LM, init_params

    if device.type == "meta":
        return LM(cfg, n_model, device, param_dtype)
    return init_params(cfg, torch.Generator(device=device).manual_seed(0), n_model, device,
                       param_dtype)


def _tokens(cfg, b: int, t: int, device):
    if device.type == "meta":
        return torch.empty((b, t), dtype=torch.int32, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (b, t), generator=g, device=device,
                         dtype=torch.int32)


def _frames(cfg, b: int, device):
    if cfg.family != "audio":
        return None
    if device.type == "meta":
        return torch.empty((b, cfg.encoder_seq, cfg.d_model), device=device)
    g = torch.Generator(device=device).manual_seed(2)
    return torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=g, device=device)


def serve_param_dtype(cfg, serve_params: str = "compute"):
    """The `param_dtype` of a serving cell's `LM` (see the module's
    docstring): None (matrices in the compute dtype, norms float32) for
    "compute"; every leaf float32, or bfloat16 under
    `cfg.serve_bf16_params`, for "reference"."""
    if serve_params not in SERVE_PARAMS:
        raise ValueError(f"serve_params={serve_params!r}; one of {SERVE_PARAMS}")
    if serve_params == "compute":
        return None
    return torch.bfloat16 if cfg.serve_bf16_params else torch.float32


def entry(cfg, shape, device, *, serve_params: str = "compute", accum: int | None = None):
    """(the cell's entry as a no-argument function, {name: its resident
    tensors}), as the reference's `entry_fn` and `input_specs` build them;
    `serve_params` as `serve_param_dtype`, `accum` the training step's
    microbatches (default `pick_accum`)."""
    from repro_torch.mesh import VirtualMesh

    n_model = MOE_SHARDS if cfg.family == "moe" else 1
    mesh = VirtualMesh(n_model, device)
    secure = secure_moe_config(cfg)
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        from repro_torch.optim.adamw import adamw_init
        from repro_torch.train.step import make_train_step

        model = _model(cfg, n_model, device, torch.float32)
        opt = adamw_init(dict(model.named_parameters()))
        batch = {"tokens": _tokens(cfg, b, t, device)}
        if cfg.family == "audio":
            batch["frames"] = _frames(cfg, b, device)
        step_fn = make_train_step(cfg, mesh, secure_moe=secure,
                                  accum_steps=accum or pick_accum(cfg, shape))
        step = torch.zeros((), dtype=torch.int32, device=device)
        return (lambda: step_fn(model, opt, batch, step),
                {"params": list(model.parameters()), "opt_state": opt, "inputs": batch})

    from repro_torch.serve.engine import decode_step, init_cache, prefill

    model = _model(cfg, n_model, device, serve_param_dtype(cfg, serve_params))
    cache = init_cache(cfg, b, t, device)
    resident = {"params": list(model.parameters()), "cache": cache}
    if shape.kind == "prefill":
        tokens, frames = _tokens(cfg, b, t, device), _frames(cfg, b, device)
        resident["inputs"] = [tokens, frames]
        return (lambda: prefill(cfg, model, tokens, cache, mesh=mesh, frames=frames,
                                secure_moe=secure), resident)
    tokens = _tokens(cfg, b, 1, device)
    resident["inputs"] = [tokens]
    return lambda: decode_step(cfg, model, cache, tokens, mesh=mesh), resident


def _memory(resident: dict) -> dict:
    """Bytes of each group of resident tensors, their sum (`peak_per_device`),
    and whether the sum, and the weights alone, fit one card."""
    memory = {f"{k}_bytes": _nbytes(v) for k, v in resident.items()}
    memory["peak_per_device"] = sum(memory.values())
    memory["fits_one_card"] = memory["peak_per_device"] <= CARD_BYTES
    memory["weights_fit_one_card"] = memory["params_bytes"] <= CARD_BYTES
    return memory


def cell_memory(arch: str, shape_name: str) -> dict:
    """A cell's resident bytes (`_memory`), from its entry built on `meta`
    and not run."""
    return _memory(entry(get_config(arch), get_shape(shape_name), torch.device("meta"))[1])


@contextlib.contextmanager
def _first_microbatch_repeated(snapshot):
    """Inside: the train step's `value_and_grad` runs for its first call
    only; each later call returns the first call's results and appends the
    counts the first call added (`snapshot()` after less before) to the
    yielded list."""
    from repro_torch.train import step as step_mod

    real, memo, extra = step_mod.value_and_grad, {}, []

    def once(*args, **kwargs):
        if not memo:
            before = snapshot()
            memo["out"] = real(*args, **kwargs)
            after = snapshot()
            memo["delta"] = [a[len(b):] if isinstance(a, list) else a - b
                             for a, b in zip(after, before)]
        else:
            extra.append(memo["delta"])
        return memo["out"]

    step_mod.value_and_grad = once
    try:
        yield extra
    finally:
        step_mod.value_and_grad = real


def count_run(fn, n_shards: int = 1, *, one_microbatch: bool = False) -> dict:
    """Run `fn()` once under the counters (see the module's docstring):
    flops, bytes_accessed, device_ops, kernel_calls, collectives (the wire
    bytes over `n_shards` senders) and the roofline's terms.
    `one_microbatch` runs a training step's first microbatch only and
    counts it once for each microbatch."""
    from repro_torch.core.shuffle import record_wire_bytes
    from repro_torch.tools.opcount import counting, total_ops

    traffic = _Traffic()
    repeated = []
    with record_wire_bytes() as recs, counting() as c, \
            FlopCounterMode(display=False) as flops, traffic:
        def snapshot():
            return [flops.get_total_flops(), traffic.bytes, Counter(c.ops),
                    Counter(c.kernels), Counter(c.collectives), list(recs)]

        with (_first_microbatch_repeated(snapshot) if one_microbatch
              else contextlib.nullcontext([])) as repeated:
            fn()
    total, n_bytes = flops.get_total_flops(), traffic.bytes
    ops, kernels, colls, recs = Counter(c.ops), Counter(c.kernels), Counter(c.collectives), \
        list(recs)
    for d_flops, d_bytes, d_ops, d_kernels, d_colls, d_recs in repeated:
        total, n_bytes = total + d_flops, n_bytes + d_bytes
        ops.update(d_ops)
        kernels.update(d_kernels)
        colls.update(d_colls)
        recs += d_recs
    live = [r for r in recs if not r["halted"]]
    wire = sum(r["wire_bytes"] for r in live) * n_shards
    return {"flops": total, "bytes_accessed": n_bytes, "device_ops": total_ops(ops),
            "kernel_calls": dict(kernels),
            "collectives": {"collective_counts": dict(colls), "wire_bytes": wire,
                            "exchanges": len(live)},
            "roofline": roofline_terms(total, n_bytes, wire)}


def run_cell(arch: str, shape_name: str, cfg_override: dict | None = None, *,
             shape=None, device="meta", serve_params: str = "compute",
             accum: int | None = None, one_microbatch: bool = False) -> dict:
    """One cell's counts (see the module's docstring). `shape` (a
    `ShapeConfig`) replaces the named shape's sizes; `device="cpu"` runs the
    entry for real; `serve_params`, `accum` as `entry`'s; `one_microbatch`
    as `count_run`'s."""
    cfg = get_config(arch)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    shape = shape or get_shape(shape_name)
    skips = shape_skips(cfg)
    if shape_name in skips:
        return {"status": "SKIP", "reason": skips[shape_name]}
    device = torch.device(device)
    t0 = time.time()
    fn, resident = entry(cfg, shape, device, serve_params=serve_params, accum=accum)
    memory = _memory(resident)
    counts = count_run(fn, MOE_SHARDS if cfg.family == "moe" else 1,
                       one_microbatch=one_microbatch and shape.kind == "train")
    del fn, resident
    return {
        "status": "OK", "arch": arch, "shape": shape_name, "mesh": MESH, "n_chips": 1,
        "device": device.type, "batch": shape.global_batch, "seq_len": shape.seq_len,
        "serve_params": serve_params if shape.kind != "train" else None,
        "accum": (accum or pick_accum(cfg, shape)) if shape.kind == "train" else None,
        "t_compile_s": round(time.time() - t0, 2),
        "memory": memory, "fits_one_card": memory["fits_one_card"], **counts,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--report", default=REPORT)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    results = {}
    if os.path.exists(args.report):
        with open(args.report) as f:
            results = json.load(f)
    archs = [args.arch] if args.arch else ALL_ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            key = f"{arch}|{shape_name}|{MESH}"
            if key in results and results[key].get("status") in ("OK", "SKIP") \
                    and not args.force:
                print(f"[cached] {key}: {results[key]['status']}")
                continue
            print(f"[run]    {key} ...", flush=True)
            try:
                r = run_cell(arch, shape_name)
            except Exception as e:  # a failed cell is recorded; the others still run
                r = {"status": "FAIL", "error": f"{type(e).__name__}: {e}",
                     "trace": traceback.format_exc()[-2000:]}
                n_fail += 1
            results[key] = r
            with open(args.report, "w") as f:
                json.dump(results, f, indent=1)
            msg = r["status"]
            if r["status"] == "OK":
                msg += (f"  run={r['t_compile_s']}s dom={r['roofline']['dominant']} "
                        f"fits_one_card={r['fits_one_card']}")
            elif r["status"] == "FAIL":
                msg += "  " + r["error"][:200]
            print(f"         {key}: {msg}", flush=True)
    print(f"done; {n_fail} failures; report at {args.report}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
