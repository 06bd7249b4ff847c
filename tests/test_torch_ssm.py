"""Port Mamba-2 SSD (repro_torch.models.ssm) against the JAX reference
(repro.models.ssm), forward and gradient, and against its own per-token
recurrence.

Inputs come from numpy seeds; the block's parameters are the reference's
`ssm_init` tree (with nonzero a_log and dt_bias), loaded into the port's
`SSM` module, on the reduced zamba2-1.2b (d_model 64, two heads of 64,
state 16). Everything runs in float32 on the CPU.

The reference's `ssd_chunked` exponentiates the whole decay matrix and
then selects its causal half: above the diagonal the exponent passes
fp32's range within ~100 steps of a softplus dt, so its gradient for dt
is NaN (0 · inf) at its default chunk of 256. The port masks before the
exp. It is held to the reference where the reference is finite (T =
chunk = 64), and above that to the gradient of a per-token recurrence.

Tolerances: forward outputs and states within rtol/atol 1e-5 (the
reference's; the recurrence's 1e-4, summed in another order); gradients
within rtol 1e-4 and an absolute 1e-5 of the leaf's largest magnitude.
Past T = 64 the log-decays' cumulative sums reach ~-200, where XLA's
scan and the port's sum differ in the last bits that feed each exp:
there the forward is held within rtol 1e-4 and 1e-5 of its largest
magnitude (measured: 5.6e-6), and the gradients against the recurrence's
within rtol 1e-4 and 1e-4 of the leaf's largest (measured: <= 1.1e-5 over
256 and 512 steps), the rule of tests/test_torch_train.py.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import ssm as js
from repro_torch.configs import get_config
from repro_torch.models import ssm as ts

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = get_config("zamba2-1.2b").reduced()
D_INNER, H = ts.ssm_dims(CFG)
N, P = CFG.ssm_state, ts.HEAD_P


def t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


def grad_close(got, want, err_msg="", rel_atol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=rel_atol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=err_msg)


def ref_params(seed=0):
    tree = jax.tree.map(np.asarray, js.ssm_init(jax.random.key(seed), CFG))
    rng = np.random.default_rng(seed)
    tree["a_log"] = rng.normal(size=(H,)).astype(np.float32) * 0.1
    tree["dt_bias"] = rng.normal(size=(H,)).astype(np.float32) * 0.5
    tree["d_skip"] = rng.normal(size=(H,)).astype(np.float32)
    return tree


def port_params(tree, grad=False):
    mod = ts.SSM(CFG, "cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in tree.items()})
    return mod.requires_grad_(grad)


def ssd_inputs(b, t_, h=H, p=8, n=4, seed=0):
    """The SSD's inputs: x, a softplus of normal dt, a_log, B, C, h0."""
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, t_, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, t_, h)))).astype(np.float32)
    a_log = rng.normal(size=(h,)).astype(np.float32) * 0.3
    bm, cm = (rng.normal(size=(b, t_, n)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(b, h, n, p)).astype(np.float32)
    return xh, dt, a_log, bm, cm, h0


def ssd_recurrence(xh, dt, a_log, bm, cm, h0):
    """The SSD as a per-token recurrence: h = a h + dt B ⊗ x, y = C · h."""
    a = torch.exp(-dt * torch.exp(a_log)[None, None, :])
    hs, ys = h0, []
    for i in range(xh.shape[1]):
        upd = bm[:, i, None, :, None] * (xh[:, i] * dt[:, i, :, None])[:, :, None, :]
        hs = hs * a[:, i, :, None, None] + upd
        ys.append((cm[:, i, None, None, :] @ hs)[:, :, 0])
    return torch.stack(ys, dim=1), hs


# --- the conv ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    """Output and the new state: the padded pre-activation input's last W-1
    steps (the state in, when T < W-1)."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(CFG.ssm_conv, 12)).astype(np.float32)
    for t_ in (1, 2, 9):
        x = rng.normal(size=(2, t_, 12)).astype(np.float32)
        st = rng.normal(size=(2, CFG.ssm_conv - 1, 12)).astype(np.float32) if with_state else None
        jy, jst = js._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  None if st is None else jnp.asarray(st))
        ty, tst = ts._causal_conv(t(x), t(w), None if st is None else t(st))
        close(ty, jy)
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


# --- the scan -----------------------------------------------------------------------------


@pytest.mark.parametrize("t_,chunk", [(64, 16), (64, 64), (48, 16), (8, 8)])
def test_ssd_chunked_matches_reference_and_recurrence(t_, chunk):
    args = ssd_inputs(2, t_, seed=t_ + chunk)
    jy, jh = js.ssd_chunked(*map(jnp.asarray, args), chunk)
    ty, th = ts.ssd_chunked(*map(t, args), chunk)
    close(ty, jy)
    close(th, jh)
    ry, rh = ssd_recurrence(*map(t, args))
    close(ty, ry.numpy(), rtol=1e-4, atol=1e-4)
    close(th, rh.numpy(), rtol=1e-4, atol=1e-4)


def test_ssd_gradients_match_reference_at_chunk_64():
    """T = chunk = 64 and a_log = 0 (as at init), where the reference's
    gradient is finite: the gradient of Σy² + Σh_end² with respect to
    every input."""
    args = ssd_inputs(1, 64, seed=3)
    args = args[:2] + (np.zeros(H, np.float32),) + args[3:]

    def jloss(a):
        y, h = js.ssd_chunked(*a, 64)
        return jnp.sum(y ** 2) + jnp.sum(h ** 2)

    jg = jax.grad(jloss)(tuple(map(jnp.asarray, args)))
    targs = [t(a, grad=True) for a in args]
    y, h = ts.ssd_chunked(*targs, 64)
    tg = torch.autograd.grad(torch.sum(y ** 2) + torch.sum(h ** 2), targs)
    for name, got, want in zip(("x", "dt", "a_log", "B", "C", "h0"), tg, jg):
        assert bool(np.isfinite(np.asarray(want)).all()), name
        grad_close(got, want, name)


@pytest.mark.parametrize("t_,chunk", [(256, 256), (512, 256)])
def test_ssd_gradient_is_finite_where_the_reference_is_nan(t_, chunk):
    """B=1, H=2, P=8, N=4, a softplus of normal dt, loss Σy²: the
    reference's grad_dt is NaN (its exp of the unmasked decay overflows);
    the port's is finite, equals the gradient of the per-token recurrence,
    and its forward equals the reference's."""
    args = ssd_inputs(1, t_, h=2, seed=5)
    args = args[:2] + (np.zeros(2, np.float32),) + args[3:]  # a_log = 0, as at init

    jg = jax.grad(lambda dt: jnp.sum(js.ssd_chunked(
        jnp.asarray(args[0]), dt, *map(jnp.asarray, args[2:]), chunk)[0] ** 2))(
        jnp.asarray(args[1]))
    assert np.isnan(np.asarray(jg)).any()
    targs = [t(a, grad=True) for a in args]
    y, _ = ts.ssd_chunked(*targs, chunk)
    grad_close(y, js.ssd_chunked(*map(jnp.asarray, args), chunk)[0], "y")
    got = torch.autograd.grad(torch.sum(y ** 2), targs)
    ry, _ = ssd_recurrence(*targs)
    want = torch.autograd.grad(torch.sum(ry ** 2), targs)
    for name, g, w in zip(("x", "dt", "a_log", "B", "C", "h0"), got, want):
        assert bool(torch.isfinite(g).all()), name
        grad_close(g, w.numpy(), name, rel_atol=1e-4)


# --- the block ------------------------------------------------------------------------------


def _block_states(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, H, N, P)).astype(np.float32) * 0.1,
            rng.normal(size=(b, CFG.ssm_conv - 1, D_INNER)).astype(np.float32))


@pytest.mark.parametrize("t_,with_state", [(64, False), (48, True), (6, True)])
def test_ssm_apply_matches_reference(t_, with_state):
    """ssm_apply (its chunk halved from 256 until it divides T): output,
    end state and conv state, and the gradient of Σout² with respect to
    every parameter and x (at T = 64 and 48 every chunk is <= 64)."""
    tree = ref_params(1)
    x = np.random.default_rng(2).normal(size=(2, t_, CFG.d_model)).astype(np.float32)
    h0, conv0 = _block_states(2, 3) if with_state else (None, None)

    def jfn(p, xx):
        return js.ssm_apply(CFG, p, xx, None if h0 is None else jnp.asarray(h0),
                            None if conv0 is None else jnp.asarray(conv0))

    jo, (jh, jc) = jfn(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    mod = port_params(tree, grad=True)
    tx = t(x, grad=True)
    to, (th, tc) = ts.ssm_apply(CFG, mod, tx, None if h0 is None else t(h0),
                                None if conv0 is None else t(conv0))
    close(to, jo)
    close(th, jh)
    close(tc, jc)
    jg = jax.grad(lambda p, xx: jnp.sum(jfn(p, xx)[0] ** 2), argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    names = ["in_proj", "conv_w", "a_log", "dt_bias", "d_skip", "out_proj"]
    tg = torch.autograd.grad(torch.sum(to ** 2), [getattr(mod, n) for n in names] + [tx])
    for name, got in zip(names, tg):
        grad_close(got, jg[0][name], name)
    grad_close(tg[-1], jg[1], "x")


def test_ssm_decode_step_matches_reference_and_ssm_apply():
    """One step against the reference's; five steps from a state against
    ssm_apply of the five tokens."""
    tree = ref_params(4)
    mod = port_params(tree)
    x = np.random.default_rng(5).normal(size=(2, 5, CFG.d_model)).astype(np.float32)
    h0, conv0 = _block_states(2, 6)
    jo, jh, jc = js.ssm_decode_step(CFG, jax.tree.map(jnp.asarray, tree), jnp.asarray(x[:, :1]),
                                    jnp.asarray(h0), jnp.asarray(conv0))
    to, th, tc = ts.ssm_decode_step(CFG, mod, t(x[:, :1]), t(h0), t(conv0))
    close(to, jo)
    close(th, jh)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    seq, (sh, sc) = ts.ssm_apply(CFG, mod, t(x), t(h0), t(conv0))
    hs, cs, outs = t(h0), t(conv0), []
    for i in range(5):
        o, hs, cs = ts.ssm_decode_step(CFG, mod, t(x[:, i:i + 1]), hs, cs)
        outs.append(o)
    close(torch.cat(outs, 1), seq.numpy(), rtol=1e-4, atol=1e-5)
    close(hs, sh.numpy(), rtol=1e-4, atol=1e-5)
    assert torch.equal(cs, sc)


def test_bf16_ssm_apply_keeps_the_reference_dtypes():
    """bf16 activations: output and conv state in bf16, the SSD state in
    float32; a_log, dt_bias and d_skip float32 in a bf16 model."""
    cfg = replace(CFG, dtype="bfloat16")
    mod = ts.SSM(cfg, "cpu")
    assert mod.in_proj.dtype == torch.bfloat16 and mod.conv_w.dtype == torch.bfloat16
    assert all(getattr(mod, n).dtype == torch.float32 for n in ("a_log", "dt_bias", "d_skip"))
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in ref_params(7).items()})
    x = t(np.random.default_rng(8).normal(size=(1, 32, CFG.d_model)).astype(np.float32))
    out, (h, conv) = ts.ssm_apply(cfg, mod, x.to(torch.bfloat16))
    assert (out.dtype, h.dtype, conv.dtype) == (torch.bfloat16, torch.float32, torch.bfloat16)
    assert bool(torch.isfinite(out.float()).all())


def test_ssd_rejects_a_length_off_the_chunk():
    args = [t(a) for a in ssd_inputs(1, 24, seed=0)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ts.ssd_chunked(*args, 16)
