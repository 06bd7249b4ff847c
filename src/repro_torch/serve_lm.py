"""Batched serving driver: prefill + sampled decode on any assigned arch.

    PYTHONPATH=src python -m repro_torch.serve_lm --arch granite-moe-3b-a800m [--device cpu]

The port's counterpart of `examples/serve_lm.py`: the arch's reduced config,
weights from a seeded `torch.Generator` (an audio arch's frame embeddings
too: its frontend is a stub). A MoE arch dispatches its
experts over `--shards` virtual shards, ChaCha20-encrypting the prefill's
expert exchange with `--secure`. Prints prefill ms, decode ms per token and
aggregate tokens/s, host clock up to a synchronise.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCH_IDS, get_config
from repro_torch.crypto.chacha import key_to_words, nonce_to_words
from repro_torch.core.shuffle import SecureShuffleConfig
from repro_torch.device import resolve_device
from repro_torch.mesh import VirtualMesh
from repro_torch.models.lm import init_params
from repro_torch.serve.engine import decode_step, init_cache, prefill


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sample(logits, vocab_size: int, temperature: float, generator) -> torch.Tensor:
    """One token per row from softmax(logits / temperature) over the live vocab."""
    probs = torch.softmax(logits[:, :vocab_size].float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-moe-3b-a800m", choices=ALL_ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--shards", type=int, default=1, help="virtual shards of a MoE's experts")
    ap.add_argument("--secure", action="store_true", help="encrypt the MoE expert exchange")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = init_params(cfg, torch.Generator(device=device).manual_seed(0), args.shards, device)
    mesh = VirtualMesh(args.shards, device) if cfg.family == "moe" else None
    secure = None
    if args.secure:
        secure = SecureShuffleConfig(key_words=key_to_words(bytes(range(32))),
                                     nonce_words=nonce_to_words(b"\x07" * 12))
    b, tp = args.batch, args.prompt_len
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (b, tp), generator=gen, device=device,
                            dtype=torch.int32)
    frames = None
    if cfg.family == "audio":
        frames = torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen, device=device)
    cache = init_cache(cfg, b, tp + args.tokens + 1, device)

    _sync(device)
    t0 = time.perf_counter()
    logits = prefill(cfg, model, prompts, cache, mesh=mesh, frames=frames,
                     secure_moe=secure)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = []
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        nxt = sample(logits, cfg.vocab_size, args.temperature, gen)
        out.append(nxt)
        logits = decode_step(cfg, model, cache, nxt, mesh=mesh)
    _sync(device)
    t_decode = time.perf_counter() - t0

    gen_tokens = torch.cat(out, dim=1).cpu().numpy() if out else np.zeros((b, 0), np.int32)
    print(f"arch={cfg.name} (reduced)  device={device}  batch={b}  prompt={tp}  "
          f"generated={args.tokens}  shards={args.shards}  secure={args.secure}")
    per_tok = t_decode / max(args.tokens, 1)
    print(f"prefill: {t_prefill * 1e3:.1f} ms   decode: {per_tok * 1e3:.1f} ms/token "
          f"({b * args.tokens / max(t_decode, 1e-9):.1f} tok/s aggregate)")
    for row in gen_tokens[:2]:
        print("sample:", row[:16].tolist(), "...")
    return {"prefill_ms": t_prefill * 1e3, "decode_ms_per_token": per_tok * 1e3,
            "tokens": gen_tokens}


if __name__ == "__main__":
    main()
