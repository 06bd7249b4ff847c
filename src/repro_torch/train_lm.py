"""End-to-end training driver: secure-ingest LM training with checkpoints.

    PYTHONPATH=src python -m repro_torch.train_lm --arch granite-moe-3b-a800m [--device cpu]

The port's counterpart of `examples/train_lm.py`: the arch's reduced config
(any family but audio, which the reference's driver refuses too), float32 masters from a seeded `torch.Generator`,
structured synthetic tokens, the paper's data path (batches encrypted by
`SecureShardedSource`, decrypted inside the step), MAC-verified checkpoints
every `--ckpt-every` steps, and the loss falling. A MoE arch dispatches its
experts over `--shards` virtual shards, ChaCha20-encrypting the expert
exchange (both directions of the backward too) with `--secure`.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ALL_ARCH_IDS, get_config
from repro_torch.core.shuffle import SecureShuffleConfig
from repro_torch.crypto.chacha import key_to_words, nonce_to_words
from repro_torch.crypto.keys import make_session_keys
from repro_torch.data.pipeline import SecureShardedSource
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.device import resolve_device
from repro_torch.mesh import VirtualMesh
from repro_torch.train.step import SecureIngest, init_train_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-moe-3b-a800m", choices=ALL_ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--shards", type=int, default=1, help="virtual shards of a MoE's experts")
    ap.add_argument("--secure", action="store_true", help="encrypt the MoE expert exchange")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    if cfg.family == "audio":
        raise SystemExit("audio arch: use serve_lm.py (training driver is LM-style)")
    session = make_session_keys(b"\x42" * 32)
    ingest = SecureIngest(key_words=session.words("data"),
                          nonce_words=session.nonce_words("data", 0))
    toks = synthetic_tokens(200_000, cfg.vocab_size, seed=0)
    src = SecureShardedSource(toks, batch=args.batch, seq=args.seq, session=session,
                              device=device)
    mesh = VirtualMesh(args.shards, device) if cfg.family == "moe" else None
    secure = None
    if args.secure:
        secure = SecureShuffleConfig(key_words=key_to_words(bytes(range(32))),
                                     nonce_words=nonce_to_words(b"\x07" * 12))
    step_fn = make_train_step(cfg, mesh, secure_ingest=ingest, secure_moe=secure,
                              peak_lr=1e-3, warmup=20, total_steps=args.steps)
    model, opt = init_train_state(cfg, torch.Generator(device=device).manual_seed(0),
                                  args.shards, device)
    mgr = CheckpointManager(args.ckpt_dir)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} (reduced) params={n_params / 1e6:.2f}M device={device} "
          f"shards={args.shards} secure_moe={args.secure} secure_ingest=on "
          f"vocab={cfg.vocab_size}")

    t0 = time.perf_counter()
    losses = []
    for i in range(args.steps):
        batch = src.next_batch()  # ciphertext + counter
        model, opt, metrics = step_fn(model, opt, batch, i)
        losses.append(float(metrics["loss"]))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  lr {float(metrics['lr']):.2e}")
        if (i + 1) % args.ckpt_every == 0:
            path = mgr.save(i + 1, (dict(model.named_parameters()), opt),
                            extra={"step": i + 1, "data_cursor": src.state})
            print(f"  checkpoint -> {path}")
    dt = time.perf_counter() - t0
    print(f"\n{args.steps} steps in {dt:.1f}s ({dt / args.steps * 1e3:.0f} ms/step); "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    if not losses[-1] < losses[0]:
        raise SystemExit("training should reduce loss")
    return {"losses": losses, "ms_per_step": dt / args.steps * 1e3,
            "checkpoints": mgr.list_steps()}


if __name__ == "__main__":
    main()
