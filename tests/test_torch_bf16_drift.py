"""bf16 decode against prefill: the port's drift held to the reference's.

In bf16 compute the 16th decode step's logits after a prefill differ from a
prefill of the same tokens, because the two take their roundings in other
orders (the blocked WKV and the chunked SSD against the per-token
recurrence, a GEMM against a GEMV). rwkv6-1.6b and zamba2-1.2b at full
depth (24 and 38 layers; zamba2's last two after its sixth shared block),
d_model 256 with head dims of 64 and the published ratios of d_ff, bf16
compute, the reference's float32 weights from `init_params` carried over
by `convert.lm_params` (the port's bf16 matrices are the same roundings
the reference's casts take), one sequence of 64 + 16 tokens from a numpy
seed: drift = max |decode_16 - prefill_80| / max |prefill_80| over the
vocabulary, in the reference (JAX on the CPU) and in the port. The port's
drift is held to at most twice the reference's.
"""

from dataclasses import replace
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro.serve import engine as jeng
from repro_torch.configs import get_config
from repro_torch.convert import lm_params
from repro_torch.models.lm import LM
from repro_torch.serve import decode_step, init_cache, prefill

ARCHS = ["rwkv6-1.6b", "zamba2-1.2b"]
PROMPT, STEPS, WIDTH, HEAD = 64, 16, 256, 64
FACTOR = 2.0  # the port's drift at most FACTOR x the reference's


def _narrow(cfg):
    """Full depth, d_model 256, heads of 64, d_ff at the published ratio, bf16."""
    heads = WIDTH // HEAD
    return replace(cfg, d_model=WIDTH, n_heads=heads, n_kv_heads=heads,
                   d_ff=cfg.d_ff * WIDTH // cfg.d_model, dtype="bfloat16")


def _tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, vocab, (1, PROMPT + STEPS)).astype(np.int32)


def _drift(decoded, full, vocab: int) -> float:
    decoded, full = np.asarray(decoded, np.float32)[:, :vocab], np.asarray(full, np.float32)[
        :, :vocab]
    return float(np.abs(decoded - full).max() / np.abs(full).max())


@lru_cache(maxsize=None)
def reference(arch: str) -> tuple:
    """(the reference's drift, its float32 weights as numpy)."""
    cfg = _narrow(jget(arch))
    params = jax.jit(lambda k: jlm.init_params(cfg, k))(jax.random.key(0))
    toks = jnp.asarray(_tokens(cfg.vocab_size))
    pre = jax.jit(lambda p, t, c: jeng.prefill(cfg, p, t, c))
    dec = jax.jit(lambda p, c, t: jeng.decode_step(cfg, p, c, t))
    smax = PROMPT + STEPS + 1
    lg, cache = pre(params, toks[:, :PROMPT], jeng.init_cache(cfg, 1, smax))
    for i in range(PROMPT, PROMPT + STEPS):
        lg, cache = dec(params, cache, toks[:, i:i + 1])
    full, _ = pre(params, toks, jeng.init_cache(cfg, 1, smax))
    return _drift(lg, full, cfg.vocab_size), jax.tree.map(np.asarray, params)


def port_drift(arch: str, np_params) -> float:
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # one row a matrix product: a thread pool only waits
    try:
        return _port_drift(arch, np_params)
    finally:
        torch.set_num_threads(threads)


def _port_drift(arch: str, np_params) -> float:
    cfg = _narrow(get_config(arch))
    model = LM(cfg, 1, "cpu")
    model.load_state_dict(lm_params(cfg, np_params))
    toks = torch.from_numpy(_tokens(cfg.vocab_size))
    smax = PROMPT + STEPS + 1
    cache = init_cache(cfg, 1, smax, "cpu")
    lg = prefill(cfg, model, toks[:, :PROMPT], cache)
    for i in range(PROMPT, PROMPT + STEPS):
        lg = decode_step(cfg, model, cache, toks[:, i:i + 1])
    full = prefill(cfg, model, toks, init_cache(cfg, 1, smax, "cpu"))
    return _drift(lg.float().numpy(), full.float().numpy(), cfg.vocab_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_bf16_drift_within_twice_the_reference(arch):
    ref, np_params = reference(arch)
    got = port_drift(arch, np_params)
    print(f"{arch}: bf16 drift of the 16th decode step against a prefill, "
          f"reference {ref:.6g}, port {got:.6g} ({got / ref:.3f}x)")
    assert np.isfinite(ref) and np.isfinite(got) and ref > 0
    assert got <= FACTOR * ref, (arch, got, ref)
