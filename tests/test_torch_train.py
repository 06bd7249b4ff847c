"""Port training (repro_torch.models.lm.loss_fn, repro_torch.optim,
repro_torch.train.step, the differentiable exchange of repro_torch.core.shuffle)
against the JAX reference (repro.models.lm, repro.optim, repro.train.step).

Reduced granite-moe-3b-a800m (the moe family, experts on R virtual shards)
and reduced glm4-9b (dense), float32 masters, numpy-seeded tokens. The
reference runs on a ("data", "model") mesh of Auto axes (the only mesh its
train step runs on), jitted, in one subprocess with two host devices; its
results come back in an npz, shared by a module-scoped fixture.

The reference's shuffle gives every expert weight a zero gradient on its
default (coalesced) and its secure wire: both pack leaves into u32 words by
a bitcast, which JAX differentiates as zero. Its plaintext per-leaf wire
(`REPRO_SHUFFLE_COALESCE=0`, `lax.all_to_all` on float leaves) gives the
true gradient, and the port is held to that on every wire: its exchange is
an operator whose backward is the same exchange of the cotangents.

Tolerances: losses within rtol 1e-5; gradients, and the AdamW moments a
train step builds from them, within rtol 1e-4 and an absolute 1e-4 of the
leaf's largest magnitude (float32 sums taken in other orders by XLA's fused
reductions; measured <= 3e-6 of the largest); one AdamW update from a
common state: moments rtol 1e-5, atol 1e-9; updated parameters rtol 1e-5,
atol 1e-7 where Adam's denominator sqrt(nu_hat) exceeds 1e3·eps (near eps
the update is close to sign(g), and a last-bit difference moves a parameter
by up to lr); after a whole train step, parameters within rtol 1e-5 and
1e-3·lr on the same elements (the update lr·step has |step| <~ 1, and a
small gradient's relative error, within the gradients' tolerance, moves
it by that share); the port's secure gradients equal its plain ones bit
for bit, and remat changes no bit.
"""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import run_in_subprocess
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro_torch import VirtualMesh
from repro_torch.configs import get_config
from repro_torch.convert import adamw_state, lm_params, secure_config, to_tensor
from repro_torch.core import shuffle as tsh
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import LM, _remat_groups, loss_fn
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.step import SecureIngest, make_train_step, value_and_grad

MOE, DENSE = "granite-moe-3b-a800m", "glm4-9b"
B, T = 2, 16
KW = np.arange(8, dtype=np.uint32) * 0x01010101
NW = np.array([7, 9, 11], np.uint32)
COUNTER0 = 9
GRAD_TOL = dict(rtol=1e-4, rel_atol=1e-4)
EXPERT_LEAVES = ("moe.wi", "moe.wg", "moe.wo")
STEP_KW = dict(peak_lr=1e-3, warmup=1, total_steps=10)
INGEST_KEY = b"\x21" * 32


def tokens(cfg, seed, shape=(B, T)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _unflat(flat: dict) -> dict:
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


# --- the reference, in a subprocess with two host devices ------------------------------


def reference_results(path: str) -> None:
    """Every reference figure the tests read, into an npz at `path`: the loss
    and gradients of reduced granite-moe (per-leaf wire) and glm4-9b at R=1
    and R=2, and two train steps with secure ingest at accum_steps 1 and 2
    (the second step's input state, output state and metrics)."""
    os.environ["REPRO_SHUFFLE_COALESCE"] = "0"
    from jax.sharding import AxisType

    from repro import compat
    from repro.configs import get_config as jget
    from repro.crypto.keys import make_session_keys
    from repro.data.pipeline import SecureShardedSource
    from repro.data.synthetic import synthetic_tokens
    from repro.models import lm as jlm
    from repro.train.step import SecureIngest as JIngest, make_train_step as jstep

    out = {}

    def mesh_of(r):
        return compat.make_mesh((1, r), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                                devices=jax.devices()[:r])

    for arch in (MOE, DENSE):
        cfg = jget(arch).reduced()
        for r in (1, 2):
            mesh = mesh_of(r)
            params = jax.jit(lambda k, r=r: jlm.init_params(cfg, k, r))(jax.random.key(0))
            f = jax.jit(jax.value_and_grad(
                lambda p, b: jlm.loss_fn(cfg, p, b, mesh=mesh), has_aux=True))
            (loss, m), g = f(params, {"tokens": jnp.asarray(tokens(cfg, 1))})
            pre = f"{arch}|{r}|"
            out[pre + "loss"] = np.asarray(loss)
            for k, v in m.items():
                out[pre + "m|" + k] = np.asarray(v)
            for k, v in _flat(jax.tree.map(np.asarray, params)):
                out[pre + "p|" + k] = v
            for k, v in _flat(jax.tree.map(np.asarray, g)):
                out[pre + "g|" + k] = v

    cfg = jget(MOE).reduced()
    mesh = mesh_of(2)
    session = make_session_keys(INGEST_KEY)
    ingest = JIngest(key_words=session.words("data"),
                     nonce_words=session.nonce_words("data", 0))
    toks = synthetic_tokens(4000, cfg.vocab_size, seed=1)
    for accum in (1, 2):
        src = SecureShardedSource(toks, batch=4, seq=T, session=session, seed=3)
        step = jstep(cfg, mesh, secure_ingest=ingest, accum_steps=accum, donate=False,
                     **STEP_KW)[0]
        params = jax.jit(lambda k: jlm.init_params(cfg, k, 2))(jax.random.key(0))
        opt = jadamw.adamw_init(params)
        params, opt, _ = step(params, opt, src.next_batch(), jnp.int32(0))
        batch = src.next_batch()
        pre = f"step|{accum}|"
        out[pre + "ct"], out[pre + "ctr"] = np.asarray(batch["tokens"]), np.asarray(batch["ctr"])
        for name, tree in (("p", params), ("mu", opt["mu"]), ("nu", opt["nu"])):
            for k, v in _flat(jax.tree.map(np.asarray, tree)):
                out[pre + f"in|{name}|" + k] = v
        out[pre + "in|count"] = np.asarray(opt["count"])
        params, opt, metrics = step(params, opt, batch, jnp.int32(1))
        for name, tree in (("p", params), ("mu", opt["mu"]), ("nu", opt["nu"])):
            for k, v in _flat(jax.tree.map(np.asarray, tree)):
                out[pre + f"out|{name}|" + k] = v
        for k, v in metrics.items():
            out[pre + "metrics|" + k] = np.asarray(v)
    np.savez(path, **out)


_SUBPROCESS = """
import sys
sys.path.insert(0, {tests!r})
import test_torch_train as T
T.reference_results({path!r})
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory) -> dict:
    path = str(tmp_path_factory.mktemp("train") / "ref.npz")
    run_in_subprocess(_SUBPROCESS.format(tests=os.path.dirname(os.path.abspath(__file__)),
                                         path=path), devices=2)
    return dict(np.load(path))


def _tree(ref: dict, prefix: str) -> dict:
    return _unflat({k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)})


def port_model(cfg, np_params, r) -> LM:
    model = LM(cfg, r, "cpu", torch.float32)
    model.load_state_dict(lm_params(cfg, np_params, r))
    return model


def port_grads(cfg, model, toks, r, secure=None, records=None):
    mesh = VirtualMesh(r, "cpu") if cfg.family == "moe" else None
    with tsh.record_wire_bytes() as recs:
        loss, metrics, grads = value_and_grad(cfg, model, {"tokens": torch.from_numpy(toks)},
                                              mesh, secure)
    if records is not None:
        records.extend(recs)
    return loss, metrics, grads


def assert_leaf_close(got: torch.Tensor, want, err_msg=""):
    """Within GRAD_TOL: rtol, and an absolute tolerance relative to the
    leaf's largest magnitude."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=GRAD_TOL["rtol"],
                               atol=GRAD_TOL["rel_atol"] * max(scale, 1e-30), err_msg=err_msg)


def assert_grads_close(got: dict, want: dict):
    for name, w in want.items():
        assert_leaf_close(got[name], w, name)


# --- loss and gradients ----------------------------------------------------------------


@pytest.mark.parametrize("arch,r", [(MOE, 1), (MOE, 2), (DENSE, 1), (DENSE, 2)])
def test_loss_and_grads_match_reference(ref, arch, r):
    """loss_fn and its gradient with respect to every parameter; the
    expert weights' gradients are nonzero (the reference's per-leaf wire)."""
    cfg = get_config(arch).reduced()
    pre = f"{arch}|{r}|"
    model = port_model(cfg, _tree(ref, pre + "p|"), r)
    loss, metrics, grads = port_grads(cfg, model, tokens(cfg, 1), r)
    np.testing.assert_allclose(float(loss), float(ref[pre + "loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["nll"]), float(ref[pre + "m|nll"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["moe_aux"]), float(ref[pre + "m|moe_aux"]),
                               rtol=1e-5, atol=1e-7)
    assert int(metrics["moe_dropped"]) == int(ref[pre + "m|moe_dropped"])
    want = lm_params(cfg, _tree(ref, pre + "g|"), r)
    assert set(grads) == set(want)
    assert_grads_close(grads, {k: v.numpy() for k, v in want.items()})
    if cfg.family == "moe":
        for i in range(cfg.n_layers):
            for leaf in EXPERT_LEAVES:
                assert float(grads[f"layers.{i}.{leaf}"].abs().sum()) > 0, (i, leaf)


@pytest.mark.parametrize("r", [1, 2])
def test_secure_grads_equal_plain_bit_for_bit(ref, r):
    """Secure MoE (the exchange and its backward encrypted) against plain:
    loss and every gradient equal bit for bit, expert gradients nonzero;
    each layer records its two forward legs and then, in the backward, two
    legs of the cotangents, secure ones with their own keystream launches."""
    cfg = get_config(MOE).reduced()
    model = port_model(cfg, _tree(ref, f"{MOE}|{r}|p|"), r)
    toks = tokens(cfg, 1)
    plain_recs, sec_recs = [], []
    lp, _, gp = port_grads(cfg, model, toks, r, records=plain_recs)
    ls, _, gs = port_grads(cfg, model, toks, r, secure_config(KW, NW, COUNTER0), sec_recs)
    assert torch.equal(lp, ls)
    for name in gp:
        assert torch.equal(gp[name], gs[name]), name
    for i in range(cfg.n_layers):
        for leaf in EXPERT_LEAVES:
            assert float(gs[f"layers.{i}.{leaf}"].abs().sum()) > 0
    assert len(sec_recs) == len(plain_recs) == 4 * cfg.n_layers
    assert all(rec["secure"] and rec["keystream_launches"] == 2 for rec in sec_recs)
    assert not any(rec["secure"] for rec in plain_recs)


@pytest.mark.parametrize("remat,moe_remat,replays", [("none", "save_shuffle", 0),
                                                     ("full", "save_shuffle", 0),
                                                     ("dots", "save_shuffle", 1),
                                                     ("sqrt", "full", 1)])
def test_remat_changes_no_bit(remat, moe_remat, replays):
    """At 12 layers (so `sqrt` runs its two levels, 3 groups of 4): every
    remat policy gives the gradients of `sqrt` with `save_shuffle` bit for
    bit, secure MoE on 2 shards. `save_shuffle` keeps both legs' outputs at
    both levels, so the backward replays no exchange: 4 records a layer
    (2 forward legs, 2 cotangent legs); a policy that does not keep them
    replays each forward leg once more."""
    base_cfg = replace(get_config(MOE).reduced(), n_layers=12)
    assert _remat_groups(base_cfg, 12) == 3
    model = LM(base_cfg, 2, "cpu", torch.float32)
    from repro_torch.models.layers import init_module

    init_module(model, torch.Generator().manual_seed(5))
    toks = tokens(base_cfg, 6)
    sec = secure_config(KW, NW, COUNTER0)
    base_recs, recs = [], []
    lb, _, gb = port_grads(base_cfg, model, toks, 2, sec, base_recs)
    cfg = replace(base_cfg, remat=remat, moe_remat=moe_remat)
    lg, _, g = port_grads(cfg, model, toks, 2, sec, recs)
    assert torch.equal(lb, lg)
    for name in gb:
        assert torch.equal(gb[name], g[name]), name
    assert len(base_recs) == 4 * 12
    assert len(recs) == (4 + 2 * replays) * 12


# --- the exchange's backward -------------------------------------------------------------


@pytest.mark.parametrize("wire", ["coalesced", "per_leaf", "secure", "secure_per_leaf"])
@pytest.mark.parametrize("r", [1, 4])
def test_exchange_backward_is_the_transposed_exchange(wire, r):
    """On every wire the exchange's cotangent is the transpose of the
    shard axes of the output's cotangent, exactly; the forward's bits are
    those of the exchange without autograd; an integer leaf beside it gets
    no gradient."""
    rng = np.random.default_rng(r)
    x = torch.from_numpy(rng.normal(size=(r, r, 3, 5)).astype(np.float32)).requires_grad_()
    keys = torch.from_numpy(rng.integers(0, 9, (r, r, 3)).astype(np.int32))
    sec = None
    if wire.startswith("secure"):
        sec = secure_config(KW, NW, COUNTER0, coalesce=wire == "secure")
    coalesce = wire != "per_leaf"
    mesh = VirtualMesh(r, "cpu")
    out = tsh.keyed_all_to_all({"x": x, "k": keys}, mesh, sec, coalesce=coalesce)
    with torch.no_grad():
        plain = tsh.keyed_all_to_all({"x": x, "k": keys}, mesh, sec, coalesce=coalesce)
    assert torch.equal(out["x"], plain["x"]) and torch.equal(out["k"], plain["k"])
    assert out["x"].untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
    ct = torch.from_numpy(rng.normal(size=(r, r, 3, 5)).astype(np.float32))
    (gx,) = torch.autograd.grad(out["x"], x, ct)
    assert torch.equal(gx, ct.transpose(0, 1))


def test_exchange_backward_leg_is_encrypted_under_its_own_round(monkeypatch):
    """The cotangents' leg draws the pad of round index ^ 2**31: its
    ciphertext is the forward leg's exchange at that round, and differs
    from the pad of round 0."""
    r = 2
    sec = secure_config(KW, NW, COUNTER0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(r, r, 4, 8)).astype(np.float32)).requires_grad_()
    ct = torch.from_numpy(rng.normal(size=(r, r, 4, 8)).astype(np.float32))
    seen = []
    real = tsh._crypt_wire_coalesced

    def spy(wire, layout, cfg, nonce_ids, ctr_rows, round_id=None, **kw):
        seen.append(round_id)
        return real(wire, layout, cfg, nonce_ids, ctr_rows, round_id, **kw)

    monkeypatch.setattr(tsh, "_crypt_wire_coalesced", spy)
    out = tsh.keyed_all_to_all({"x": x}, VirtualMesh(r, "cpu"), sec, round_index=5)["x"]
    torch.autograd.grad(out, x, ct)
    assert seen == [5, 5, 5 ^ (1 << 31), 5 ^ (1 << 31)]


# --- the keystream layout of the MoE's legs ---------------------------------------------------


def _leg_pads(cfg, n_tokens: int, r: int, counter0: int = 0) -> dict:
    """Per leg, sender 0's (nonce word 1 XOR, first counter, end counter):
    the span of counters its rows draw, from `_capacity`, `padded_experts`
    and the wire's blocks per row (a bf16 (E_loc·cap, d) row)."""
    e_pad = tmoe.padded_experts(cfg, r)
    cap = tmoe._capacity(cfg, n_tokens // r, e_pad)
    blocks = tsh._row_blocks((e_pad // r * cap, cfg.d_model), torch.bfloat16)
    span = r * blocks  # destination rows 0..R-1, `blocks` counters each
    back = tsh.BACKWARD_ROUND_BIT
    return {"dispatch": (0, counter0, counter0 + span),
            "return": (0, counter0 + (1 << 20), counter0 + (1 << 20) + span),
            "dispatch_cotangent": (back, counter0, counter0 + span),
            "return_cotangent": (back, counter0 + (1 << 20), counter0 + (1 << 20) + span),
            "blocks_per_row": blocks}


def _overlap(a, b) -> bool:
    return a[0] == b[0] and a[1] < b[2] and b[1] < a[2]


@pytest.mark.parametrize("shape,overlaps", [((8, 4096), True), ((4, 1024), False)])
def test_keystream_layout_of_the_moe_legs(shape, overlaps):
    """granite-moe-3b-a800m on 8 shards. At the serving shape (8 x 4096
    tokens, 246,720 blocks a row) a sender's dispatch and return legs draw
    overlapping counters under one nonce, as the reference's (a two-time pad
    inside a layer); at the training shape (4 x 1024, 31,680 blocks a row)
    they do not. The cotangents' legs draw under nonce word 1 XOR 2**31, so
    they meet neither forward leg at either shape."""
    cfg = get_config(MOE)
    legs = _leg_pads(cfg, shape[0] * shape[1], 8)
    assert legs["blocks_per_row"] == {True: 246_720, False: 31_680}[overlaps]
    assert _overlap(legs["dispatch"], legs["return"]) == overlaps
    for fwd in ("dispatch", "return"):
        for bwd in ("dispatch_cotangent", "return_cotangent"):
            assert not _overlap(legs[fwd], legs[bwd])


# --- AdamW and the schedule ------------------------------------------------------------------


def _adamw_case(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 8), "b": (16,), "c": (3, 5, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: (rng.normal(size=s) * 10.0 ** rng.integers(-6, 1, s)).astype(np.float32)
             for k, s in shapes.items()}
    state = {"mu": {k: (rng.normal(size=s) * 1e-2).astype(np.float32) for k, s in shapes.items()},
             "nu": {k: (rng.random(size=s) * 1e-3).astype(np.float32) for k, s in shapes.items()},
             "count": np.int32(seed)}
    return params, grads, state


@pytest.mark.parametrize("seed,clip", [(0, 1.0), (3, 1.0), (7, 1e3)])
def test_adamw_update_matches_reference(seed, clip):
    """One update from the same state: the global norm, the moments and the
    parameters (where Adam's denominator sqrt(nu_hat) exceeds 1e3·eps;
    elsewhere the update is near sign(g) and a last-bit difference in nu
    moves a parameter by up to lr); the clip binds at clip 1.0."""
    params, grads, state = _adamw_case(seed)
    cfg_j = jadamw.AdamWConfig(clip_norm=clip)
    cfg_t = tadamw.AdamWConfig(clip_norm=clip)
    lr = np.float32(1e-3)
    jp, js, jm = jadamw.adamw_update(jax.tree.map(jnp.asarray, params),
                                     jax.tree.map(jnp.asarray, grads),
                                     jax.tree.map(jnp.asarray, state), lr, cfg_j)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tg = {k: torch.from_numpy(v.copy()) for k, v in grads.items()}
    ts = {"mu": {k: torch.from_numpy(v.copy()) for k, v in state["mu"].items()},
          "nu": {k: torch.from_numpy(v.copy()) for k, v in state["nu"].items()},
          "count": torch.tensor(int(state["count"]), dtype=torch.int32)}
    tp2, ts2, tm = tadamw.adamw_update(tp, tg, ts, torch.tensor(lr), cfg_t)
    assert tp2 is tp  # in place
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts2["count"]) == int(js["count"])
    c2 = 1 - 0.95 ** float(js["count"])
    for k in params:
        for name in ("mu", "nu"):
            np.testing.assert_allclose(ts2[name][k].numpy(), np.asarray(js[name][k]),
                                       rtol=1e-5, atol=1e-9, err_msg=f"{name} {k}")
        live = np.sqrt(np.asarray(js["nu"][k]) / c2) > 1e3 * 1e-8
        assert live.mean() > 0.5
        np.testing.assert_allclose(tp2[k].numpy()[live], np.asarray(jp[k])[live],
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_adamw_init_and_global_norm():
    params, grads, _ = _adamw_case(1)
    ts = tadamw.adamw_init({k: torch.from_numpy(v) for k, v in params.items()})
    js = jadamw.adamw_init(jax.tree.map(jnp.asarray, params))
    for name in ("mu", "nu"):
        for k in params:
            assert ts[name][k].dtype == torch.float32 and not ts[name][k].any()
            assert ts[name][k].shape == js[name][k].shape
    assert int(ts["count"]) == 0 and ts["count"].dtype == torch.int32
    np.testing.assert_allclose(
        float(tadamw.global_norm({k: torch.from_numpy(v) for k, v in grads.items()})),
        float(jadamw.global_norm(jax.tree.map(jnp.asarray, grads))), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 5, 99, 100, 101, 5000, 9999, 10000, 12000])
def test_warmup_cosine_matches_reference(step):
    kw = dict(peak_lr=3e-4, warmup=100, total=10000)
    got = warmup_cosine(step, **kw, device="cpu")
    assert torch.equal(warmup_cosine(torch.tensor(step), **kw), got)
    want = jsched.warmup_cosine(jnp.int32(step), **kw)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=2e-7)


# --- the train step -----------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(ref, accum):
    """Reduced granite-moe on 2 shards, secure ingest (the reference's
    ciphertext and counter, decrypted inside the port's step): from the
    reference's state after one step, carried by `lm_params` and
    `adamw_state`, one more step with accum_steps 1 and 2. Metrics, the
    moments and the parameters within the tolerances above; the port runs
    its exchange encrypted (equal to plain bit for bit) against the
    reference's plaintext per-leaf wire."""
    from repro.crypto.keys import make_session_keys

    cfg = get_config(MOE).reduced()
    pre = f"step|{accum}|"
    model = port_model(cfg, _tree(ref, pre + "in|p|"), 2)
    opt = adamw_state(cfg, {"mu": _tree(ref, pre + "in|mu|"), "nu": _tree(ref, pre + "in|nu|"),
                            "count": ref[pre + "in|count"]}, 2, "cpu")
    session = make_session_keys(INGEST_KEY)
    ingest = SecureIngest(key_words=session.words("data"),
                          nonce_words=session.nonce_words("data", 0))
    step = make_train_step(cfg, VirtualMesh(2, "cpu"), secure_ingest=ingest,
                           secure_moe=secure_config(KW, NW, COUNTER0), accum_steps=accum,
                           **STEP_KW)
    batch = {"tokens": to_tensor(ref[pre + "ct"], "cpu"),
             "ctr": torch.tensor(int(ref[pre + "ctr"]), dtype=torch.int64)}
    model2, opt2, metrics = step(model, opt, batch, 1)
    assert model2 is model and opt2["mu"] is opt["mu"]  # donated: updated in place
    for k in ("loss", "nll", "lr", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(ref[pre + "metrics|" + k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(metrics["moe_aux"]), float(ref[pre + "metrics|moe_aux"]),
                               rtol=1e-5, atol=1e-7)
    assert float(metrics["moe_dropped"]) == float(ref[pre + "metrics|moe_dropped"])
    assert int(opt2["count"]) == 2
    want = {name: lm_params(cfg, _tree(ref, pre + f"out|{name}|"), 2)
            for name in ("p", "mu", "nu")}
    for k, p in model.named_parameters():
        for name in ("mu", "nu"):  # built from the gradients: their tolerance
            assert_leaf_close(opt2[name][k], want[name][k].numpy(), f"{name} {k}")
        live = np.sqrt(want["nu"][k].numpy() / (1 - 0.95 ** 2)) > 1e3 * 1e-8
        np.testing.assert_allclose(p.detach().numpy()[live], want["p"][k].numpy()[live],
                                   rtol=1e-5, atol=1e-3 * STEP_KW["peak_lr"], err_msg=k)


def test_train_step_without_donation_leaves_the_state():
    """donate=False returns updated copies and leaves the caller's model and
    optimizer state as they were; the copies equal a donated step's."""
    from repro_torch.train.step import init_train_state

    cfg = get_config(DENSE).reduced()
    toks = {"tokens": torch.from_numpy(tokens(cfg, 2))}
    model, opt = init_train_state(cfg, torch.Generator().manual_seed(0), 1, "cpu")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    m2, o2, _ = make_train_step(cfg, donate=False, **STEP_KW)(model, opt, toks, 1)
    assert m2 is not model
    for k, p in model.named_parameters():
        assert torch.equal(p, before[k])
    assert int(opt["count"]) == 0 and int(o2["count"]) == 1
    m3, _, _ = make_train_step(cfg, **STEP_KW)(model, opt, toks, 1)
    for (k, a), (_, b) in zip(m2.named_parameters(), m3.named_parameters()):
        assert torch.equal(a, b), k


def test_loss_mask_weights_the_positions():
    """loss_mask of width T or T - 1; an all-zero mask gives nll 0."""
    cfg = get_config(DENSE).reduced()
    model = LM(cfg, 1, "cpu", torch.float32)
    from repro_torch.models.layers import init_module

    init_module(model, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(tokens(cfg, 3))
    full, _ = loss_fn(cfg, model, {"tokens": toks})
    ones_t = torch.ones(toks.shape)
    same, _ = loss_fn(cfg, model, {"tokens": toks, "loss_mask": ones_t})
    assert torch.equal(full, same)
    half = torch.ones(toks.shape[0], toks.shape[1] - 1)
    half[:, ::2] = 0
    part, m = loss_fn(cfg, model, {"tokens": toks, "loss_mask": half})
    assert not torch.equal(part, full)
    zero, m0 = loss_fn(cfg, model, {"tokens": toks, "loss_mask": torch.zeros_like(half)})
    assert float(m0["nll"].detach()) == 0.0
    assert sorted(m) == ["moe_aux", "moe_dropped", "nll"]


def test_training_entry_points_without_device_raise_without_cuda(monkeypatch, tmp_path):
    """With no CUDA card, a training entry point given no device raises
    instead of running on the CPU."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.crypto.keys import make_session_keys
    from repro_torch.data.pipeline import SecureShardedSource
    from repro_torch.train.step import init_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(DENSE).reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SecureShardedSource(np.zeros(100, np.int32), 2, 8, make_session_keys(b"k" * 32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warmup_cosine(3, peak_lr=1e-3, warmup=1, total=10)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore(1, {"w": np.zeros(3, np.float32)})
