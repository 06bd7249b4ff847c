"""The port's ssm, hybrid and audio families (repro_torch.models.lm,
repro_torch.serve.engine, repro_torch.train.step) against the JAX reference
(repro.models.lm, repro.serve.engine, repro.train.step).

Reduced rwkv6-1.6b (ssm), zamba2-1.2b (hybrid: 4 mamba layers, the shared
attention block after every 2) and whisper-base (audio: 2 encoder and 2
decoder layers over 32 frames), float32, the reference's weights carried
over by `convert.lm_params`, tokens and frames from numpy seeds. The
reference runs with `mesh=None` (none of these families dispatches
experts), but for its train step, which needs a mesh: a (1, 1) ("data",
"model") mesh of Auto axes. Its results are shared through a cache per
arch.

Tolerances: logits and caches within rtol/atol 1e-4 (the reference's own
serving test allows 2e-3); losses within rtol 1e-5; gradients, and the
AdamW moments a train step builds from them, within rtol 1e-4 and an
absolute 1e-4 of the leaf's largest magnitude; after a train step,
parameters within rtol 1e-5 and 1e-3·lr where the element's gradient was
at least 1e-2 of its leaf's largest at both steps (chip_smoke.py's
`adam_steady_mask` rule: Adam normalises each element, so a smaller
gradient's rounding, ~1e-6 of the leaf's scale, reaches its update at
full size; zamba2's embedding has such rows); the
prefill's and decode's logits against the port's own forward within
rtol/atol 1e-5 (the blocked WKV and the chunked SSD against the scan and
the smaller chunks of the longer forward: 1e-4); remat changes no bit.
"""

from dataclasses import replace
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro import compat
from repro.configs import get_config as jget
from repro.crypto.ctr import encrypt_array as jencrypt
from repro.crypto.keys import make_session_keys
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.serve import engine as jeng
from repro.train.step import make_train_step as jstep
from repro_torch.configs import get_config
from repro_torch.convert import adamw_state, lm_params, to_tensor
from repro_torch.models.lm import LM, forward
from repro_torch.models.layers import init_module
from repro_torch.serve import decode_step, init_cache, prefill
from repro_torch.train.step import SecureIngest, make_train_step, value_and_grad

ARCHS = ["rwkv6-1.6b", "zamba2-1.2b", "whisper-base"]
B, TP, SMAX = 2, 16, 24
TOL = dict(rtol=1e-4, atol=1e-4)
STEP_KW = dict(peak_lr=1e-3, warmup=1, total_steps=10)
INGEST_KEY = b"\x21" * 32
CTRS = (0, 500_000)  # the two steps' counters: past 2**16 + the frames' 768 blocks


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def inputs(cfg, seed):
    """(tokens (B, TP + 2), frames (B, S_enc, d) or None), from numpy seeds."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, TP + 2)).astype(np.int32)
    frames = None
    if cfg.family == "audio":
        frames = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return toks, frames


def ingest_material():
    session = make_session_keys(INGEST_KEY)
    return session.words("data"), session.nonce_words("data", 0)


_encrypt = jax.jit(jencrypt)


@lru_cache(maxsize=None)
def reference(arch: str) -> dict:
    """Every reference figure the tests read (jitted), as numpy."""
    cfg = jget(arch).reduced()
    params = jax.jit(lambda k: jlm.init_params(cfg, k))(jax.random.key(0))
    out = {"params": jax.tree.map(np.asarray, params)}
    toks, frames = inputs(cfg, 1)
    batch = {"tokens": jnp.asarray(toks)}
    if frames is not None:
        batch["frames"] = jnp.asarray(frames)
    out["logits"] = np.asarray(jax.jit(lambda p, b: jlm.forward(cfg, p, b)[0])(params, batch))
    b16 = dict(batch, tokens=batch["tokens"][:, :TP])
    (loss, m), g = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss_fn(cfg, p, b),
                                              has_aux=True))(params, b16)
    out["loss"], out["nll"], out["grads"] = float(loss), float(m["nll"]), jax.tree.map(
        np.asarray, g)

    pre = jax.jit(lambda p, t, c, f: jeng.prefill(cfg, p, t, c, frames=f))
    dec = jax.jit(lambda p, c, t: jeng.decode_step(cfg, p, c, t))
    cache = jeng.init_cache(cfg, B, SMAX)
    lg, cache = pre(params, batch["tokens"][:, :TP], cache, batch.get("frames"))
    out["serve"] = [np.asarray(lg, np.float32)]
    for i in (0, 1):
        lg, cache = dec(params, cache, batch["tokens"][:, TP + i:TP + i + 1])
        out["serve"].append(np.asarray(lg))
    out["cache"] = {k: np.asarray(v) for k, v in cache.items()}

    # the train step: the reference's plain step (its secure ingest decrypts
    # to these tokens and frames bit for bit), the port's secure one fed the
    # reference's ciphertexts
    kw, nw = ingest_material()
    mesh = compat.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                            devices=jax.devices()[:1])
    step = jstep(cfg, mesh, donate=False, **STEP_KW)[0]
    opt = jax.jit(jadamw.adamw_init)(params)
    for i, ctr in enumerate(CTRS):
        toks_i, frames_i = inputs(cfg, 10 + i)
        plain = {"tokens": jnp.asarray(toks_i[:, :TP])}
        if frames_i is not None:
            plain["frames"] = jnp.asarray(frames_i)
        if i == 1:
            out["step_in"] = jax.tree.map(np.asarray, (params, opt))
            out["step_batch"] = {k: np.asarray(_encrypt(v, kw, nw, np.uint32(
                ctr + (1 << 16 if k == "frames" else 0)))) for k, v in plain.items()}
            out["step_batch"]["ctr"] = np.uint32(ctr)
        params, opt, metrics = step(params, opt, plain, jnp.int32(i))
    out["step_out"] = jax.tree.map(np.asarray, (params, opt))
    out["step_metrics"] = {k: float(v) for k, v in metrics.items()}
    return out


def port_model(cfg, np_params, param_dtype=None) -> LM:
    model = LM(cfg, 1, "cpu", param_dtype)
    model.load_state_dict(lm_params(cfg, np_params))
    return model


def port_batch(toks, frames):
    batch = {"tokens": torch.from_numpy(toks)}
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames)
    return batch


def assert_leaf_close(got, want, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * max(float(np.abs(want).max()), 1e-30),
                               err_msg=err_msg)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_carries_the_tree(arch):
    """Every leaf lands in the port's state_dict, each stacked tree sliced
    per layer (`layers`, `encoder`, `decoder`) and `shared_attn` /
    `enc_norm` whole; a stack of the wrong depth is refused."""
    cfg = get_config(arch).reduced()
    np_params = reference(arch)["params"]
    sd = lm_params(cfg, np_params)
    model = port_model(cfg, np_params)
    assert set(sd) == set(model.state_dict())
    flat = dict(_flat(np_params))
    for name, t in model.state_dict().items():
        stack, _, rest = name.partition(".")
        if stack in ("layers", "encoder", "decoder"):
            i, _, leaf = rest.partition(".")
            np.testing.assert_array_equal(t.numpy(), flat[f"{stack}.{leaf}"][int(i)])
        else:
            np.testing.assert_array_equal(t.numpy(), flat[name])
    if cfg.family == "hybrid":
        assert any(k.startswith("shared_attn.mlp.") for k in sd)
        bad, field = replace(cfg, n_layers=cfg.n_layers + 1), "n_layers"
    elif cfg.family == "audio":
        assert "enc_norm.scale" in sd and f"encoder.{cfg.n_encoder_layers - 1}.mlp.wi" in sd
        bad, field = replace(cfg, n_encoder_layers=cfg.n_encoder_layers + 1), "n_encoder_layers"
    else:
        bad, field = replace(cfg, n_layers=cfg.n_layers - 1), "n_layers"
    with pytest.raises(ValueError, match=field):
        lm_params(bad, np_params)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """At T = 18 (rwkv's per-token scan, zamba2's SSD in chunks of 2)."""
    cfg = get_config(arch).reduced()
    ref = reference(arch)
    logits, aux = forward(cfg, port_model(cfg, ref["params"]), port_batch(*inputs(cfg, 1)))
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **TOL)
    assert float(aux["moe_aux"]) == 0.0 and int(aux["moe_dropped"]) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """At T = 16 (rwkv's blocked WKV, zamba2's SSD in one chunk): the loss
    and its gradient with respect to every parameter, the shared block's
    (summed over its invocations) and the encoder's included."""
    cfg = get_config(arch).reduced()
    ref = reference(arch)
    model = port_model(cfg, ref["params"], torch.float32)
    toks, frames = inputs(cfg, 1)
    loss, metrics, grads = value_and_grad(cfg, model, port_batch(toks[:, :TP], frames))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["nll"]), ref["nll"], rtol=1e-5)
    want = lm_params(cfg, ref["grads"])
    assert set(grads) == set(want)
    for name, w in want.items():
        assert_leaf_close(grads[name], w.numpy(), name)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_and_forward(arch):
    """Prefill of 16 tokens and two decode steps: logits and every cache
    entry against the reference's; logits against the port's own forward
    at the same positions."""
    cfg = get_config(arch).reduced()
    ref = reference(arch)
    model = port_model(cfg, ref["params"])
    toks, frames = inputs(cfg, 1)
    t = torch.from_numpy(toks)
    fr = None if frames is None else torch.from_numpy(frames)
    cache = init_cache(cfg, B, SMAX, "cpu")
    got = [prefill(cfg, model, t[:, :TP], cache, frames=fr)]
    for i in (0, 1):
        got.append(decode_step(cfg, model, cache, t[:, TP + i:TP + i + 1]))
    assert got[1].dtype == torch.float32
    for g, w in zip(got, ref["serve"]):
        np.testing.assert_allclose(g.float().numpy(), w, **TOL)
    assert set(cache) == set(ref["cache"])
    for k, v in cache.items():
        assert v.dtype == to_tensor(np.array(ref["cache"][k]), "cpu").dtype, k
        np.testing.assert_allclose(v.numpy(), ref["cache"][k], **TOL, err_msg=k)
    full, _ = forward(cfg, model, port_batch(toks, frames))
    for pos, g in zip((TP - 1, TP, TP + 1), got):
        np.testing.assert_allclose(g.float().numpy(), full[:, pos].numpy(), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """Secure ingest (the reference's ciphertexts and counter; for whisper
    the frames too, at ctr + 2**16): from the reference's state after one
    step, carried by `lm_params` and `adamw_state`, one more step. Metrics,
    moments and parameters within the tolerances above."""
    cfg = get_config(arch).reduced()
    ref = reference(arch)
    np_params, np_opt = ref["step_in"]
    model = port_model(cfg, np_params, torch.float32)
    opt = adamw_state(cfg, np_opt, 1, "cpu")
    kw, nw = ingest_material()
    step = make_train_step(cfg, secure_ingest=SecureIngest(key_words=kw, nonce_words=nw),
                           **STEP_KW)
    batch = {k: to_tensor(np.array(v), "cpu") for k, v in ref["step_batch"].items()}
    batch["ctr"] = torch.tensor(int(ref["step_batch"]["ctr"]), dtype=torch.int64)
    model, opt, metrics = step(model, opt, batch, 1)
    for k in ("loss", "nll", "lr", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), ref["step_metrics"][k], rtol=1e-5,
                                   err_msg=k)
    out_params, out_opt = ref["step_out"]
    want = {"p": lm_params(cfg, out_params), "mu": lm_params(cfg, out_opt["mu"]),
            "nu": lm_params(cfg, out_opt["nu"])}
    assert int(opt["count"]) == int(out_opt["count"]) == 2
    mu_in = lm_params(cfg, np_opt["mu"])
    compared = 0
    for k, p in model.named_parameters():
        for name in ("mu", "nu"):
            assert_leaf_close(opt[name][k], want[name][k].numpy(), f"{name} {k}")
        mu1, mu2 = mu_in[k].numpy(), want["mu"][k].numpy()
        live = np.ones(mu1.shape, bool)
        for g in (np.abs(mu1), np.abs(mu2 - 0.9 * mu1)):  # ∝ each step's clipped gradient
            live &= g >= 1e-2 * g.max()
        compared += int(live.sum())
        np.testing.assert_allclose(p.detach().numpy()[live], want["p"][k].numpy()[live],
                                   rtol=1e-5, atol=1e-3 * STEP_KW["peak_lr"], err_msg=k)
    assert compared > sum(p.numel() for p in model.parameters()) // 4


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_none_equals_sqrt(arch):
    """At 12 layers (12 encoder layers for whisper), where `sqrt` walks two
    levels (3 groups of 4) and zamba2 6 checkpointed groups: the loss and
    every gradient equal bit for bit under remat `none` and `sqrt`."""
    base = get_config(arch).reduced()
    cfg = replace(base, n_layers=12, n_encoder_layers=12 if base.n_encoder_layers else 0)
    model = init_module(LM(cfg, 1, "cpu", torch.float32), torch.Generator().manual_seed(5))
    toks, frames = inputs(cfg, 6)
    batch = port_batch(toks[:, :TP], frames)
    lq, _, gq = value_and_grad(replace(cfg, remat="sqrt"), model, batch)
    ln, _, gn = value_and_grad(replace(cfg, remat="none"), model, batch)
    assert torch.equal(lq, ln)
    for name in gq:
        assert torch.equal(gq[name], gn[name]), name
    assert all(bool(torch.isfinite(g).all()) for g in gq.values())


# zamba2 with a mamba layer after its last shared block: 5 layers, the shared
# block after every 2 (the published config's 38 layers at every 6 leave 2)
REMAINDER_LAYERS = 5


@lru_cache(maxsize=None)
def reference_remainder() -> dict:
    """The reference's 5-layer reduced zamba2: forward logits, a prefill of
    16 tokens and two decode steps, and the cache."""
    cfg = replace(jget("zamba2-1.2b").reduced(), n_layers=REMAINDER_LAYERS)
    params = jax.jit(lambda k: jlm.init_params(cfg, k))(jax.random.key(4))
    toks, _ = inputs(cfg, 7)
    tokens = jnp.asarray(toks)
    out = {"params": jax.tree.map(np.asarray, params), "tokens": toks,
           "logits": np.asarray(jax.jit(lambda p, t: jlm.forward(cfg, p, {"tokens": t})[0])(
               params, tokens))}
    pre = jax.jit(lambda p, t, c: jeng.prefill(cfg, p, t, c))
    dec = jax.jit(lambda p, c, t: jeng.decode_step(cfg, p, c, t))
    lg, cache = pre(params, tokens[:, :TP], jeng.init_cache(cfg, B, SMAX))
    out["serve"] = [np.asarray(lg, np.float32)]
    for i in (0, 1):
        lg, cache = dec(params, cache, tokens[:, TP + i:TP + i + 1])
        out["serve"].append(np.asarray(lg))
    out["cache"] = {k: np.asarray(v) for k, v in cache.items()}
    return out


def _remainder_cfg():
    cfg = replace(get_config("zamba2-1.2b").reduced(), n_layers=REMAINDER_LAYERS)
    every = cfg.attn_every
    assert cfg.n_layers % every and cfg.n_layers > (cfg.n_layers // every) * every
    return cfg


def test_zamba2_remainder_forward_matches_reference():
    """A mamba layer runs after the last shared block (`_walk_hybrid`'s
    remainder): the forward's logits within 1e-4."""
    cfg = _remainder_cfg()
    ref = reference_remainder()
    model = port_model(cfg, ref["params"])
    logits, _ = forward(cfg, model, {"tokens": torch.from_numpy(ref["tokens"])})
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=1e-4, atol=1e-4)


def test_zamba2_remainder_prefill_decode_and_caches_match_reference():
    """The engine's hybrid branches with the remainder layer: prefill and two
    decode steps' logits within 1e-4, and every cache entry (the remainder
    layer's SSM state and conv among them) within 1e-4."""
    cfg = _remainder_cfg()
    ref = reference_remainder()
    model = port_model(cfg, ref["params"])
    t = torch.from_numpy(ref["tokens"])
    cache = init_cache(cfg, B, SMAX, "cpu")
    got = [prefill(cfg, model, t[:, :TP], cache)]
    for i in (0, 1):
        got.append(decode_step(cfg, model, cache, t[:, TP + i:TP + i + 1]))
    for g, w in zip(got, ref["serve"]):
        np.testing.assert_allclose(g.float().numpy(), w, rtol=1e-4, atol=1e-4)
    assert set(cache) == set(ref["cache"])
    assert cache["ssm_h"].shape[0] == REMAINDER_LAYERS
    for k, v in cache.items():
        np.testing.assert_allclose(v.numpy(), ref["cache"][k], rtol=1e-4, atol=1e-4, err_msg=k)
