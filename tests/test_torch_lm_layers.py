"""Port LM layers and attention (repro_torch.models.{layers,attention}) against
the JAX reference (repro.models.{layers,attention}).

Inputs come from numpy seeds; parameters are the reference's, carried over
through the modules' `load_state_dict` (names follow the reference's dict
keys). Everything runs in float32 on the CPU: outputs within rtol/atol 1e-5
of the reference (its own serving test allows 2e-3), integer results and
masks exactly; bfloat16 norms and rope within one bf16 ulp (rtol 2**-7), the
bfloat16-softmax attention within 2e-2 (its scores round to bf16 before the
softmax).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models import lm as jlm
from repro_torch.configs import ALL_ARCH_IDS, ARCH_IDS, get_config
from repro_torch.convert import lm_params
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models.lm import LM, init_params
from repro_torch.serve.engine import init_cache

TOL = dict(rtol=1e-5, atol=1e-5)
SERVED = [a for a in ARCH_IDS if get_config(a).family in ("dense", "vlm", "moe")]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def load(module, tree):
    """A port module holding the reference's parameter tree (numpy copies)."""
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in _flat(tree)})
    return module


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


def test_config_registry_is_the_reference_copy():
    """The reference's ten configs field for field; the port's own fields
    (latent attention, the biased router, a dense first layer, a separate
    head, the norm's eps) at their defaults, which change nothing."""
    from dataclasses import fields

    from repro_torch.configs import PORT_ARCH_IDS, ArchConfig

    assert ARCH_IDS == list(__import__("repro.configs", fromlist=["ARCH_IDS"]).ARCH_IDS)
    defaults = {f.name: f.default for f in fields(ArchConfig)}
    for arch in ARCH_IDS:
        mine, ref = get_config(arch), jget(arch)
        own = set(mine.__dict__) - set(ref.__dict__)
        assert own == {"attention", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                       "v_head_dim", "first_dense_layers", "router",
                       "routed_scaling", "shared_expert_gate", "separate_head", "norm_eps"}
        for a, b in ((mine, ref), (mine.reduced(), ref.reduced())):
            assert {k: v for k, v in a.__dict__.items() if k not in own} == b.__dict__
            assert {k: a.__dict__[k] for k in own} == {k: defaults[k] for k in own}
        assert (mine.head_dim, mine.padded_vocab) == (ref.head_dim, ref.padded_vocab)
    assert len(SERVED) == 7 and PORT_ARCH_IDS == ["moonlight-16b-a3b"]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_norms_match(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(48,)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)
    tx = t(x).to(torch.bfloat16) if dtype == "bfloat16" else t(x)
    norm = load(tl.Norm(48, "cpu"), {"scale": scale})
    tol = dict(rtol=2**-7, atol=2**-7) if dtype == "bfloat16" else TOL
    for jf, tf in ((jl.rmsnorm, tl.rmsnorm), (jl.layernorm, tl.layernorm)):
        got = tf(norm, tx)
        assert got.dtype == tx.dtype
        close(got, jf({"scale": jnp.asarray(scale)}, jx).astype(jnp.float32), **tol)
    cfg = replace(get_config("whisper-base").reduced())  # the layernorm config
    close(tl.apply_norm(cfg, norm, t(x)), jl.apply_norm(cfg, {"scale": scale}, x))


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_gated_mlp_matches(act):
    cfg = replace(get_config("glm4-9b").reduced(), act=act)
    params = jl.mlp_init(jax.random.key(1), cfg.d_model, cfg.d_ff)
    mlp = load(tl.MLP(cfg, cfg.d_model, cfg.d_ff, "cpu"), params)
    x = np.random.default_rng(1).normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    close(tl.mlp_apply(cfg, mlp, t(x)), jl.mlp_apply(cfg, params, jnp.asarray(x)))


def test_embed_and_unembed_mask_padded_vocab():
    cfg = replace(get_config("granite-20b").reduced(), vocab_size=250)
    assert cfg.padded_vocab == 256
    params = jl.embed_init(jax.random.key(2), cfg.padded_vocab, cfg.d_model)
    emb = load(tl.Embed(cfg, cfg.padded_vocab, cfg.d_model, "cpu"), params)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    close(tl.embed_apply(cfg, emb, t(toks)), jl.embed_apply(cfg, params, jnp.asarray(toks)))
    x = np.random.default_rng(3).normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    got = tl.unembed_apply(cfg, emb, t(x))
    want = np.asarray(jl.unembed_apply(cfg, params, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 7, 256)
    assert np.all(got[..., 250:].numpy() == -1e30) and np.all(want[..., 250:] == -1e30)
    close(got[..., :250], want[..., :250])


def test_rope_matches():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    close(tl.rope(t(x), t(pos), 10000.0), jl.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0),
          rtol=1e-5, atol=2e-5)
    xb = t(x).to(torch.bfloat16)
    got = tl.rope(xb, t(pos), 500000.0)
    assert got.dtype == torch.bfloat16
    want = jl.rope(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos), 500000.0)
    close(got, want.astype(jnp.float32), rtol=2**-7, atol=2**-7)


# --- attention ----------------------------------------------------------------------


def _attn(cfg, seed=5):
    params = jattn.attn_init(jax.random.key(seed), cfg)
    return params, load(tattn.Attention(cfg, "cpu"), params)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "chameleon-34b", "granite-20b"])
def test_projections_and_dense_self_attention(arch):
    cfg = get_config(arch).reduced()  # chameleon: qk_norm; granite-20b: MQA
    jp, tp = _attn(cfg)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    close(tattn.project_q(cfg, tp, t(x), t(pos)),
          jattn.project_q(cfg, jp, jnp.asarray(x), jnp.asarray(pos)))
    for g, w in zip(tattn.project_kv(cfg, tp, t(x), t(pos)),
                    jattn.project_kv(cfg, jp, jnp.asarray(x), jnp.asarray(pos))):
        close(g, w)
    for causal in (True, False):
        close(tattn.self_attention(cfg, tp, t(x), t(pos), causal=causal),
              jattn.self_attention(cfg, jp, jnp.asarray(x), jnp.asarray(pos), causal=causal))
    valid = rng.random((2, 12)) < 0.7
    valid[:, 0] = True
    close(tattn.self_attention(cfg, tp, t(x), t(pos), k_valid=t(valid)),
          jattn.self_attention(cfg, jp, jnp.asarray(x), jnp.asarray(pos),
                               k_valid=jnp.asarray(valid)))


@pytest.mark.parametrize("seq", [16, 12])
def test_query_chunked_attention(seq):
    """attn_chunk=8: T=16 takes two query chunks, T=12 (not a multiple) the
    dense fallback; both equal the reference and the unchunked port."""
    cfg = replace(get_config("glm4-9b").reduced(), attn_chunk=8)
    jp, tp = _attn(cfg, 7)
    x = np.random.default_rng(7).normal(size=(2, seq, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (2, seq))
    got = tattn.self_attention(cfg, tp, t(x), t(pos))
    close(got, jattn.self_attention(cfg, jp, jnp.asarray(x), jnp.asarray(pos)))
    dense = tattn.self_attention(replace(cfg, attn_chunk=0), tp, t(x), t(pos))
    close(got, dense.numpy(), rtol=1e-6, atol=1e-6)


def test_bf16_softmax_dtype_attention():
    cfg = replace(get_config("glm4-9b").reduced(), softmax_dtype="bfloat16")
    jp, tp = _attn(cfg, 8)
    x = np.random.default_rng(8).normal(size=(1, 10, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (1, 10))
    close(tattn.self_attention(cfg, tp, t(x), t(pos)),
          jattn.self_attention(cfg, jp, jnp.asarray(x), jnp.asarray(pos)),
          rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("positions", [[3, 7], [9, 15], [16, 40]])
def test_decode_attention_writes_in_place_and_clamps(positions):
    """The new K/V land at `position`; a position >= S writes slot S - 1, as
    the reference's dynamic_update_slice clamps its start."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    jp, tp = _attn(cfg, 9)
    s = 16
    rng = np.random.default_rng(9)
    ck = rng.normal(size=(2, s, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    cv = rng.normal(size=ck.shape).astype(np.float32)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    jo, jk, jv = jattn.decode_self_attention(cfg, jp, jnp.asarray(x), jnp.asarray(ck),
                                             jnp.asarray(cv), jnp.asarray(pos))
    tk, tv = t(ck), t(cv)
    to, rk, rv = tattn.decode_self_attention(cfg, tp, t(x), tk, tv, t(pos))
    assert rk is tk and rv is tv  # written in place
    close(to, jo)
    close(tk, jk)
    close(tv, jv)
    for b, p in enumerate(pos):
        slot = min(int(p), s - 1)
        untouched = np.arange(s) != slot
        np.testing.assert_array_equal(tk[b].numpy()[untouched], ck[b][untouched])


# --- the model's parameters -----------------------------------------------------------


@pytest.mark.parametrize("arch", SERVED)
def test_parameter_names_and_init_rules_follow_the_reference(arch):
    """The port model's state_dict names are the reference tree's paths
    (layers unstacked), with the same shapes; init_params draws each with
    the reference's distribution (matrices N(0, 1/fan_in) in the compute
    dtype, norms ones)."""
    cfg = replace(get_config(arch).reduced(), n_layers=2)
    n_model = 4 if cfg.family == "moe" else 1
    shapes = jax.eval_shape(lambda k: jlm.init_params(cfg, k, n_model), jax.random.key(0))
    want = {}
    for name, leaf in _flat(shapes):
        if name.startswith("layers."):
            for i in range(cfg.n_layers):
                want[f"layers.{i}.{name[7:]}"] = tuple(leaf.shape[1:])
        else:
            want[name] = tuple(leaf.shape)
    model = init_params(cfg, torch.Generator().manual_seed(0), n_model, "cpu")
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    for name, p in sd.items():
        if name.endswith("scale"):
            assert p.dtype == torch.float32 and torch.all(p == 1)
            continue
        mod = model.get_submodule(name.rsplit(".", 1)[0])
        rule = mod.inits[name.rsplit(".", 1)[1]]
        assert rule[0] == "normal" and p.dtype == torch.float32
        if p.numel() >= 2000:
            assert abs(float(p.std()) / rule[1] - 1) < 0.1, name
    moe = sd.get("layers.0.moe.wi")
    if moe is not None:  # the reference's ninit fan-in: shape[0], the experts
        assert model.layers[0].moe.inits["wi"][1] == (1.0 / moe.shape[0]) ** 0.5


def test_bf16_config_holds_matrices_in_bf16_and_norms_in_f32():
    cfg = get_config("granite-moe-3b-a800m")
    small = replace(cfg, n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                    moe_d_ff=32, vocab_size=300)
    model = init_params(small, torch.Generator().manual_seed(1), 8, "cpu")
    assert model.layers[0].moe.wi.dtype == torch.bfloat16
    assert model.embed.table.dtype == torch.bfloat16
    assert model.layers[0].ln1.scale.dtype == torch.float32
    assert model.layers[0].moe.wi.shape[0] == 40


def test_lm_params_loads_the_reference_tree():
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    params = jax.tree.map(np.asarray, jlm.init_params(cfg, jax.random.key(3), 2))
    model = LM(cfg, 2, "cpu")
    model.load_state_dict(lm_params(cfg, params, 2))
    np.testing.assert_array_equal(model.layers[1].moe.shared.gate.numpy(),
                                  params["layers"]["moe"]["shared"]["gate"][1])
    np.testing.assert_array_equal(model.embed.table.numpy(), params["embed"]["table"])
    with pytest.raises(ValueError, match="experts"):
        lm_params(cfg, params, 3)


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_every_arch_inits_caches_and_prefills(arch):
    """Every config of the registry, reduced: `init_params`, `init_cache`
    and one `prefill` (with seeded frames for audio) on the CPU give finite
    logits of the padded vocabulary's width and the cache's position."""
    from repro_torch.serve.engine import prefill

    cfg = get_config(arch).reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), 1, "cpu")
    cache = init_cache(cfg, 2, 12, "cpu")
    rng = np.random.default_rng(0)
    toks = t(rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32))
    frames = None
    if cfg.family == "audio":
        frames = t(rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    logits = prefill(cfg, model, toks, cache, frames=frames)
    assert logits.shape == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(logits[:, :cfg.vocab_size]).all())
    assert torch.equal(cache["pos"], torch.full((2,), 8, dtype=torch.int32))


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    """With no CUDA card, the LM's entry points given no device raise instead
    of running on the CPU."""
    from repro_torch.serve_lm import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("granite-moe-3b-a800m").reduced()
    for call in (lambda: LM(cfg), lambda: init_cache(cfg, 1, 8),
                 lambda: main(["--tokens", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
