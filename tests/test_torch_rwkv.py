"""Port RWKV-6 (repro_torch.models.rwkv) against the JAX reference
(repro.models.rwkv), forward and gradient, and the port's blocked WKV
against its own per-token scan (the cases of tests/test_rwkv_wkv.py).

Inputs come from numpy seeds; the block's parameters are the reference's
`rwkv_init` tree, loaded into the port's `RWKV` module. A config of
d_model 128 gives two heads of 64. Everything runs in float32 on the CPU.

Tolerances: forward outputs and states within rtol/atol 1e-5 of the
reference's; gradients within rtol 1e-4 and an absolute 1e-5 of the
leaf's largest magnitude (float32 sums in other orders); the port's
blocked WKV against its scan within 2e-4 (the reference's own tolerance,
tests/test_rwkv_wkv.py), 3e-4 for the hypothesis cases as there; the
bfloat16 time-mix within 2e-2 of the output's largest magnitude (each
mix, product and cast rounds to bf16; the check is the cast order: the
output dtypes and the float32 WKV state).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from repro.models import rwkv as jr
from repro_torch.configs import get_config
from repro_torch.models import rwkv as tr

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = replace(get_config("rwkv6-1.6b").reduced(), d_model=128, d_ff=256)


def t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


def grad_close(got, want, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5 * max(float(np.abs(want).max()), 1e-30),
                               err_msg=err_msg)


def ref_params(seed=0):
    tree = jax.tree.map(np.asarray, jr.rwkv_init(jax.random.key(seed), CFG))
    # a nonzero bonus, so the u terms are exercised
    tree["u"] = np.random.default_rng(seed).normal(size=tree["u"].shape).astype(np.float32)
    return tree


def port_params(tree, grad=False):
    mod = tr.RWKV(CFG, "cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in tree.items()})
    return mod.requires_grad_(grad)


def wkv_inputs(b, t_, h, c, seed=0, decay_strength=1.0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t_, h, c)).astype(np.float32) for _ in range(3))
    # decay in (0, 1) with the production clamp |log w| <= exp(1.2)
    ww = rng.uniform(-12, 1.2, size=(b, t_, h, c)) * decay_strength
    w = np.exp(-np.exp(ww)).astype(np.float32)
    u = rng.normal(size=(h, c)).astype(np.float32)
    s0 = rng.normal(size=(b, h, c, c)).astype(np.float32)
    return r, k, v, w, u, s0


# --- the WKV forms against the reference's --------------------------------------------


@pytest.mark.parametrize("form,t_", [("blocked", 32), ("scan", 20)])
def test_wkv_matches_reference_forward_and_gradient(form, t_):
    """y and the end state, and the gradient of Σy² + Σs² with respect to
    r, k, v, w, u and s0."""
    args = wkv_inputs(2, t_, 2, 16, seed=t_)

    def jfn(*a):
        if form == "blocked":
            return jr._wkv_blocked(*a)
        return jr._wkv_scan(*a, chunk=8)

    def tfn(*a):
        if form == "blocked":
            return tr._wkv_blocked(*a)
        return tr._wkv_scan(*a, chunk=8)

    jy, js = jfn(*map(jnp.asarray, args))
    targs = [t(a, grad=True) for a in args]
    ty, ts = tfn(*targs)
    close(ty, jy)
    close(ts, js)
    jg = jax.grad(lambda a: sum(jnp.sum(o ** 2) for o in jfn(*a)))(tuple(map(jnp.asarray, args)))
    tg = torch.autograd.grad(torch.sum(ty ** 2) + torch.sum(ts ** 2), targs)
    for name, got, want in zip("rkvwus", tg, jg):
        grad_close(got, want, name)


def test_decay_matches_reference_forward_and_gradient():
    """The decay's low-rank MLP and clamp, in float32 from a bf16 mix; a
    scale that drives part of ww past both clamp bounds."""
    tree = ref_params()
    rng = np.random.default_rng(1)
    zw = (rng.normal(size=(2, 5, CFG.d_model)) * 60).astype(np.float32)
    tree["w_lora_b"] = tree["w_lora_b"] * 50
    jw = jr._decay(jax.tree.map(jnp.asarray, tree), jnp.asarray(zw))
    mod = port_params(tree, grad=True)
    tz = t(zw, grad=True)
    tw = tr._decay(mod, tz)
    assert tw.dtype == torch.float32
    close(tw, jw)
    wv = np.asarray(jw)
    assert (wv < np.exp(-np.exp(1.2)) * 1.0001).any() and (wv > np.exp(-np.exp(-12)) * 0.9999).any()
    jg = jax.grad(lambda p, z: jnp.sum(jr._decay(p, z) ** 2), argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(zw))
    tg = torch.autograd.grad(torch.sum(tw ** 2), [mod.w0, mod.w_lora_a, mod.w_lora_b, tz])
    for name, got in zip(("w0", "w_lora_a", "w_lora_b"), tg[:3]):
        grad_close(got, jg[0][name], name)
    grad_close(tg[3], jg[1], "zw")


# --- the block's pieces -----------------------------------------------------------------


def _states(b, seed):
    rng = np.random.default_rng(seed)
    h, dk = tr.rwkv_dims(CFG)
    return (rng.normal(size=(b, 1, CFG.d_model)).astype(np.float32),
            rng.normal(size=(b, h, dk, dk)).astype(np.float32) * 0.1)


@pytest.mark.parametrize("t_,impl,with_state", [(32, "blocked", False), (32, "blocked", True),
                                                (20, "blocked", True), (32, "scan", False)])
def test_time_mix_matches_reference(t_, impl, with_state):
    """rwkv_time_mix: blocked at T % 16 == 0, the scan otherwise or when the
    config asks for it; output, shift and wkv state, and the gradient of the
    output's Σ² with respect to every parameter and x."""
    cfg = replace(CFG, wkv_impl=impl)
    tree = ref_params(2)
    x = np.random.default_rng(3).normal(size=(2, t_, CFG.d_model)).astype(np.float32)
    shift, wkv = _states(2, 4) if with_state else (None, None)

    def jfn(p, xx):
        return jr.rwkv_time_mix(cfg, p, xx, None if shift is None else jnp.asarray(shift),
                                None if wkv is None else jnp.asarray(wkv), chunk=8)

    jo, (jsh, jwkv) = jfn(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    mod = port_params(tree, grad=True)
    tx = t(x, grad=True)
    to, (tsh, twkv) = tr.rwkv_time_mix(cfg, mod, tx, None if shift is None else t(shift),
                                       None if wkv is None else t(wkv), chunk=8)
    close(to, jo)
    close(tsh, jsh)
    close(twkv, jwkv)
    jg = jax.grad(lambda p, xx: jnp.sum(jfn(p, xx)[0] ** 2), argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    names = ["mix", "wr", "wk", "wv", "wg", "wo", "w0", "w_lora_a", "w_lora_b", "u"]
    tg = torch.autograd.grad(torch.sum(to ** 2), [getattr(mod, n) for n in names] + [tx])
    for name, got in zip(names, tg):
        grad_close(got, jg[0][name], name)
    grad_close(tg[-1], jg[1], "x")


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_reference(with_state):
    tree = ref_params(5)
    x = np.random.default_rng(6).normal(size=(2, 7, CFG.d_model)).astype(np.float32)
    shift = _states(2, 7)[0] if with_state else None
    jo, jsh = jr.rwkv_channel_mix(CFG, jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                                  None if shift is None else jnp.asarray(shift))
    mod = port_params(tree, grad=True)
    tx = t(x, grad=True)
    to, tsh = tr.rwkv_channel_mix(CFG, mod, tx, None if shift is None else t(shift))
    close(to, jo)
    close(tsh, jsh)
    jg = jax.grad(lambda p, xx: jnp.sum(jr.rwkv_channel_mix(
        CFG, p, xx, None if shift is None else jnp.asarray(shift))[0] ** 2), argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    names = ["cm_mix", "cm_k", "cm_v", "cm_r"]
    tg = torch.autograd.grad(torch.sum(to ** 2), [getattr(mod, n) for n in names] + [tx])
    for name, got in zip(names, tg):
        grad_close(got, jg[0][name], name)
    grad_close(tg[-1], jg[1], "x")


def test_time_mix_step_matches_reference_and_the_sequence():
    """One-token decode against the reference's, and three steps from a
    state against rwkv_time_mix of the three tokens (the scan)."""
    tree = ref_params(8)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 3, CFG.d_model)).astype(np.float32)
    shift, wkv = _states(2, 10)
    jo, jsh, jwkv = jr.rwkv_time_mix_step(CFG, jax.tree.map(jnp.asarray, tree),
                                          jnp.asarray(x[:, :1]), jnp.asarray(shift),
                                          jnp.asarray(wkv))
    mod = port_params(tree)
    to, tsh, twkv = tr.rwkv_time_mix_step(CFG, mod, t(x[:, :1]), t(shift), t(wkv))
    close(to, jo)
    close(tsh, jsh)
    close(twkv, jwkv)
    seq, (seq_sh, seq_wkv) = tr.rwkv_time_mix(CFG, mod, t(x), t(shift), t(wkv))
    sh, s, outs = t(shift), t(wkv), []
    for i in range(3):
        o, sh, s = tr.rwkv_time_mix_step(CFG, mod, t(x[:, i:i + 1]), sh, s)
        outs.append(o)
    close(torch.cat(outs, 1), seq.numpy())
    close(s, seq_wkv.numpy())
    close(sh, seq_sh.numpy())


def test_bf16_time_mix_keeps_the_reference_dtypes():
    """With bf16 activations: the output and shift in bf16, the wkv state in
    float32, and the values within the bf16 tolerance of the reference's."""
    cfg = replace(CFG, dtype="bfloat16")
    tree = ref_params(11)
    x = np.random.default_rng(12).normal(size=(2, 32, CFG.d_model)).astype(np.float32)
    jo, (jsh, jwkv) = jr.rwkv_time_mix(cfg, jax.tree.map(jnp.asarray, tree),
                                       jnp.asarray(x).astype(jnp.bfloat16))
    mod = tr.RWKV(cfg, "cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in tree.items()})
    assert mod.wr.dtype == torch.bfloat16 and mod.mix.dtype == torch.bfloat16
    assert all(getattr(mod, n).dtype == torch.float32 for n in ("w0", "w_lora_a", "w_lora_b", "u"))
    to, (tsh, twkv) = tr.rwkv_time_mix(cfg, mod, t(x).to(torch.bfloat16))
    assert (to.dtype, tsh.dtype, twkv.dtype) == (torch.bfloat16, torch.bfloat16, torch.float32)
    for got, want in ((to, jo), (twkv, jwkv)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2e-2 * float(np.abs(want).max()))
    assert torch.equal(tsh, t(x).to(torch.bfloat16)[:, -1:])


# --- blocked == scan (the port's own forms, the cases of test_rwkv_wkv.py) -------------


@pytest.mark.parametrize("t_", [16, 64, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_blocked_matches_scan(t_, seed):
    args = [t(a) for a in wkv_inputs(2, t_, 2, 16, seed)]
    y_b, s_b = tr._wkv_blocked(*args)
    y_s, s_s = tr._wkv_scan(*args, chunk=64)
    close(y_b, y_s.numpy(), rtol=2e-4, atol=2e-4)
    close(s_b, s_s.numpy(), rtol=2e-4, atol=2e-4)


def test_blocked_extreme_decay_no_overflow():
    """The strongest decay the clamp allows, across a whole block, stays finite."""
    r, k, v, _, u, s0 = (t(a) for a in wkv_inputs(1, 64, 1, 8, 3))
    w = torch.full((1, 64, 1, 8), float(np.exp(-np.exp(1.2))), dtype=torch.float32)
    y_b, s_b = tr._wkv_blocked(r, k, v, w, u, s0)
    assert bool(torch.isfinite(y_b).all()) and bool(torch.isfinite(s_b).all())
    y_s, _ = tr._wkv_scan(r, k, v, w, u, s0, chunk=64)
    close(y_b, y_s.numpy(), rtol=2e-4, atol=2e-4)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10_000))
def test_hypothesis_blocked_equals_scan(seed):
    args = [t(a) for a in wkv_inputs(1, 32, 1, 8, seed)]
    y_b, s_b = tr._wkv_blocked(*args)
    y_s, s_s = tr._wkv_scan(*args, chunk=32)
    close(y_b, y_s.numpy(), rtol=3e-4, atol=3e-4)
    close(s_b, s_s.numpy(), rtol=3e-4, atol=3e-4)


def test_blocked_gradients_are_finite_and_equal_the_scans():
    args = [t(a, grad=True) for a in wkv_inputs(1, 32, 1, 8, 7)]

    def grads(fn):
        y, s = fn(*args)
        return torch.autograd.grad(torch.sum(y ** 2) + torch.sum(s ** 2), args)

    gb = grads(tr._wkv_blocked)
    gs = grads(lambda *a: tr._wkv_scan(*a, chunk=8))
    for name, a, b in zip("rkvwus", gb, gs):
        assert bool(torch.isfinite(a).all()), name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-4 * float(b.abs().max()), err_msg=name)


def test_blocked_rejects_a_length_off_the_block():
    args = [t(a) for a in wkv_inputs(1, 20, 1, 8, 0)]
    with pytest.raises(ValueError, match="multiple of the WKV block"):
        tr._wkv_blocked(*args)
