"""AdamW with decoupled weight decay and global-norm gradient clipping.

Counterpart of `repro/optim/adamw.py`, in the reference's arithmetic order:
clip by the float32 global norm; mu, nu; (m / c1) / (sqrt(v / c2) + eps);
then p - lr · (step + wd · p). `torch.optim.AdamW` rounds differently
(decay before the step) and is not used.

Parameters, gradients and moments are dicts of tensors keyed by parameter
name. The update works in place, as the reference's donated step does: the
parameters, `mu` and `nu` are overwritten and the gradients are consumed
(scaled in place). It walks one parameter at a time, so its temporaries are
one parameter's size. Scalars (the norm, the clip scale, the bias
corrections, the learning rate) stay 0-d tensors on the parameters' device:
the update reads nothing back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params: dict) -> dict:
    """{"mu", "nu": zeros like each parameter, "count": 0-d int32}."""
    first = next(iter(params.values()))
    return {"mu": {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ g²), in float32, leaves in the dict's order."""
    total = None
    for g in grads.values():
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, lr,
                 cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step in place. Returns (params, state, {"grad_norm"}).

    `lr` is a float or a 0-d float32 tensor (`warmup_cosine`). Every key of
    `params` must be in `grads`, `state["mu"]` and `state["nu"]`."""
    count = state["count"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    cf = count.float()
    c1 = 1 - torch.pow(torch.full_like(cf, cfg.b1), cf)
    c2 = 1 - torch.pow(torch.full_like(cf, cfg.b2), cf)
    for name, p in params.items():
        g = grads[name]
        g = g.mul_(scale) if g.dtype == torch.float32 else g.float() * scale
        m, v = state["mu"][name], state["nu"][name]
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
        step = (m / c1).div_(torch.sqrt(v / c2).add_(cfg.eps))
        upd = step.add_(p.float() * cfg.weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(upd)
        else:
            p.copy_(p.float() - upd)
    state = {"mu": state["mu"], "nu": state["nu"], "count": count}
    return params, state, {"grad_norm": gn}
