"""Training step factory: loss, gradients, AdamW update, secure batch ingest.

Counterpart of `repro/train/step.py`. Secure ingest is the paper's data
path applied to training: batches arrive as ChaCha20 ciphertext (encrypted
by the data pipeline, `repro_torch.data`) and are decrypted inside the step
by `crypto/ctr.py::encrypt_array`; on the card that is one ChaCha20 kernel
launch (two for an audio batch: the tokens, then the frames), its counter
read from device memory, so the plaintext exists only in device memory. The per-step counter comes in-band (`batch["ctr"]`),
so a restart resumes the keystream exactly.

The step runs eagerly: the reference's `jax.jit` has no counterpart here.
`make_train_step` returns the step alone; the reference also returns
PartitionSpec trees for its mesh, which have no counterpart on one card.
The model is an `LM` with float32 masters (`init_train_state`), the
optimizer state `optim.adamw_init` of its named parameters. With
`donate=True` (the reference's default) the step updates both in place and
returns them; with `donate=False` it leaves them as they were and returns
updated copies.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core.shuffle import SecureShuffleConfig
from repro_torch.crypto.ctr import decrypt_array
from repro_torch.models.lm import init_params, loss_fn
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import warmup_cosine


@dataclass(frozen=True)
class SecureIngest:
    """Session material for encrypted training batches (paper: k_data)."""

    key_words: Any
    nonce_words: Any


def value_and_grad(cfg, model, batch, mesh=None, secure_moe=None):
    """(loss, metrics, grads): `loss_fn` and its gradient with respect to
    every named parameter of `model` (a dict in `named_parameters` order;
    a parameter the loss does not reach gets zeros)."""
    named = dict(model.named_parameters())
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, model, batch, mesh, secure_moe)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(named, grads))


FRAMES_CTR_OFFSET = 1 << 16  # the audio frames' keystream starts here past "ctr"


def decrypt_batch(batch: dict, ingest: SecureIngest | None) -> dict:
    """The step's batch: tokens decrypted under `ingest` at `batch["ctr"]`
    (a host int or a 0-d tensor), and an audio batch's "frames" at "ctr" +
    2**16, as the reference's step does; "ctr" dropped either way. On the
    card each is one ChaCha20 launch, the counter read from device memory.

    The frames' offset is the reference's, kept for parity: a frames
    tensor longer than 2**16 blocks (whisper's 8 x 1,500 x 512 float32
    frames span 384,000) overlaps the keystream of the next counters, so a
    caller spaces its steps' counters past 2**16 + the frames' blocks."""
    out = {k: v for k, v in batch.items() if k != "ctr"}
    if ingest is not None:
        kw, nw, ctr = ingest.key_words, ingest.nonce_words, batch["ctr"]
        out["tokens"] = decrypt_array(batch["tokens"], kw, nw, ctr)
        if "frames" in batch:
            out["frames"] = decrypt_array(batch["frames"], kw, nw, ctr + FRAMES_CTR_OFFSET)
    return out


def _copy_state(model, opt_state):
    return copy.deepcopy(model), {"mu": {k: v.clone() for k, v in opt_state["mu"].items()},
                                  "nu": {k: v.clone() for k, v in opt_state["nu"].items()},
                                  "count": opt_state["count"].clone()}


def make_train_step(cfg, mesh=None, *, adamw: AdamWConfig = AdamWConfig(),
                    peak_lr: float = 3e-4, warmup: int = 100, total_steps: int = 10000,
                    secure_ingest: SecureIngest | None = None,
                    secure_moe: SecureShuffleConfig | None = None, accum_steps: int = 1,
                    donate: bool = True):
    """Returns train_step(model, opt_state, batch, step) -> (model, opt_state,
    metrics).

    `batch["tokens"]` is ciphertext (same shape and dtype) when
    `secure_ingest` is set; `batch["ctr"]` carries the keystream block
    offset for this step. `accum_steps > 1` runs the batch as that many
    microbatches and averages their float32 gradients, loss and metrics.
    `mesh` (a `VirtualMesh`) carries a MoE's expert exchange, encrypted by
    `secure_moe`. Metrics are 0-d tensors: loss, lr, nll, moe_aux,
    moe_dropped, grad_norm.
    """

    def train_step(model, opt_state, batch, step):
        batch = decrypt_batch(batch, secure_ingest)
        if accum_steps == 1:
            loss, metrics, grads = value_and_grad(cfg, model, batch, mesh, secure_moe)
        else:
            micro = [{k: v.reshape((accum_steps, v.shape[0] // accum_steps) + v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(accum_steps)]
            grads, losses, ms = None, [], []
            for mb in micro:
                l, m, g = value_and_grad(cfg, model, mb, mesh, secure_moe)
                if grads is None:
                    grads = {k: v.float() for k, v in g.items()}
                else:
                    for k, v in g.items():
                        grads[k].add_(v.float())
                losses.append(l)
                ms.append(m)
            grads = {k: g.div_(accum_steps) for k, g in grads.items()}
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k].float() for m in ms]).mean() for k in ms[0]}
        if not donate:
            model, opt_state = _copy_state(model, opt_state)
        device = next(model.parameters()).device
        lr = warmup_cosine(step, peak_lr=peak_lr, warmup=warmup, total=total_steps,
                           device=device)
        _, opt_state, opt_metrics = adamw_update(dict(model.named_parameters()), grads,
                                                 opt_state, lr, adamw)
        return model, opt_state, {"loss": loss, "lr": lr, **metrics, **opt_metrics}

    return train_step


def init_train_state(cfg, generator: torch.Generator, n_model: int = 1, device=None):
    """(model with float32 masters drawn from `generator`, AdamW state)."""
    model = init_params(cfg, generator, n_model, device, param_dtype=torch.float32)
    return model, adamw_init(dict(model.named_parameters()))
