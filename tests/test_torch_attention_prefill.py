"""The prefill's attention entry point (`models.attention.prefill_self_attention`)
and the wrapper of its kernel (`kernels.attention.kernel`) on the CPU,
without a card and without JAX.

On a CPU tensor the entry point runs the plain path, so it must equal
`self_attention` bit for bit; the Hopper kernel's own tests are in
`tests/test_torch_gpu.py`. `kernel_calls["attention_prefill"]` counts one
call per self-attention of a serving prefill (each layer of the dense, MoE
and VLM families, each invocation of the hybrid's shared block, each audio
decoder layer) and none in a decode step or a training forward, which keep
the plain path.
"""

from dataclasses import replace

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build, kernel_calls
from repro_torch.kernels.attention import kernel as akernel
from repro_torch.models import attention as attn
from repro_torch.models.lm import LM, forward, init_params
from repro_torch.serve.engine import decode_step, init_cache, prefill

CHUNK = 16  # attn_chunk of the entry-point cases: T = 2 * CHUNK takes the chunked path


def _attn_case(g: int, dh: int, dtype: torch.dtype):
    hkv = 2
    cfg = replace(get_config("granite-moe-3b-a800m").reduced(), n_heads=g * hkv,
                  n_kv_heads=hkv, d_head=dh, attn_chunk=CHUNK,
                  dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    params = attn.Attention(cfg, "cpu")
    gen = torch.Generator().manual_seed(100 * g + dh)
    with torch.no_grad():
        for p in params.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3 + (1.0 if p.dim() == 1 else 0.0))
    return cfg, params.to(dtype) if dtype == torch.bfloat16 else params, gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 37, 2 * CHUNK])
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("g", [1, 3, 4])
def test_prefill_entry_point_equals_self_attention_on_the_cpu(g, dh, t, dtype):
    cfg, params, gen = _attn_case(g, dh, dtype)
    b = 2
    x = torch.randn((b, t, cfg.d_model), generator=gen).to(dtype)
    positions = torch.arange(t)[None].expand(b, t)
    with torch.no_grad():
        want = attn.self_attention(cfg, params, x, positions)
        kv = attn.project_kv(cfg, params, x, positions)
        got = attn.prefill_self_attention(cfg, params, x, positions, kv)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


def _model(arch: str):
    cfg = get_config(arch).reduced()
    return cfg, init_params(cfg, torch.Generator().manual_seed(1), 1, "cpu")


def _frames(cfg, b: int):
    if cfg.family != "audio":
        return None
    gen = torch.Generator().manual_seed(2)
    return torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen)


def _self_attentions(cfg) -> int:
    """Self-attentions a prefill runs: every layer (dense, MoE, VLM; audio's
    decoder layers), each invocation of the hybrid's shared block, none in
    an RWKV model."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "glm4-9b", "chameleon-34b",
                                  "zamba2-1.2b", "whisper-base", "rwkv6-1.6b"])
def test_kernel_calls_count_each_prefill_self_attention_and_no_decode_step(arch):
    cfg, model = _model(arch)
    b, t = 2, 9
    toks = torch.randint(0, cfg.vocab_size, (b, t + 2), generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    cache = init_cache(cfg, b, t + 2, "cpu")
    with kernel_calls.recording() as pre:
        prefill(cfg, model, toks[:, :t], cache, frames=_frames(cfg, b))
    with kernel_calls.recording() as dec:
        for i in (t, t + 1):
            decode_step(cfg, model, cache, toks[:, i:i + 1])
    want = _self_attentions(cfg)
    assert pre.get("attention_prefill", 0) == want
    assert (want > 0) == (cfg.family != "ssm")
    assert dec.get("attention_prefill", 0) == 0


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "glm4-9b", "zamba2-1.2b",
                                  "whisper-base"])
def test_training_forward_keeps_the_plain_attention(arch):
    cfg = get_config(arch).reduced()
    model = LM(cfg, 1, "cpu", torch.float32)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(4), 1, "cpu").state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(5),
                         dtype=torch.int32)
    batch = {"tokens": toks}
    if cfg.family == "audio":
        batch["frames"] = _frames(cfg, 2)
    with kernel_calls.recording() as calls:
        logits, _ = forward(cfg, model, batch)
        logits.float().sum().backward()
    assert calls.get("attention_prefill", 0) == 0
    assert any(p.grad is not None for p in model.parameters())


def test_entry_point_runs_the_plain_path_for_cpu_and_meta_tensors():
    """Off the card the dispatch is `kernels.uses_kernel`'s: no launch, one
    note a call; a meta tensor (the abstract counts) keeps its shapes."""
    cfg, params, gen = _attn_case(3, 16, torch.float32)
    x = torch.randn((2, 5, cfg.d_model), generator=gen)
    positions = torch.arange(5)[None].expand(2, 5)
    before = akernel.launches
    with torch.no_grad(), kernel_calls.recording() as calls:
        kv = attn.project_kv(cfg, params, x, positions)
        attn.prefill_self_attention(cfg, params, x, positions, kv)
        meta = attn.Attention(cfg, "meta")
        xm = x.to("meta")
        got = attn.prefill_self_attention(cfg, meta, xm, positions.to("meta"),
                                          attn.project_kv(cfg, meta, xm, positions.to("meta")))
    assert calls["attention_prefill"] == 2 and akernel.launches == before
    assert got.is_meta and got.shape == x.shape


def test_entry_point_refuses_a_non_causal_config():
    cfg, params, gen = _attn_case(1, 16, torch.float32)
    x = torch.randn((1, 3, cfg.d_model), generator=gen)
    positions = torch.arange(3)[None]
    with pytest.raises(ValueError, match="causal"):
        attn.prefill_self_attention(replace(cfg, causal=False), params, x, positions,
                                    attn.project_kv(cfg, params, x, positions))


def test_kernel_wrapper_refuses_cpu_tensors_before_any_build():
    q = torch.zeros((1, 4, 2, 64), dtype=torch.bfloat16)
    before = akernel.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        akernel.attention_prefill_cuda(q, q[:, :, :1], q[:, :, :1])
    assert akernel.launches == before
    assert akernel.HEAD_DIMS == (16, 32, 48, 64, 80, 96, 112, 128)


def test_each_head_size_is_a_library_of_its_own():
    """One library a (Dqk, Dv) build: every grouped-query head size with Dv =
    Dh, and latent attention's (192, 128)."""
    assert akernel.BUILDS == tuple((d, d) for d in akernel.HEAD_DIMS) + ((192, 128),)
    paths = {(dqk, dv): _build.library_path("attention", {"QK_DIM": dqk, "V_DIM": dv})
             for dqk, dv in akernel.BUILDS}
    assert len(set(paths.values())) == len(paths)
    assert all(p.name.startswith(f"libattention_qk_dim{dqk}_v_dim{dv}-")
               for (dqk, dv), p in paths.items())
    assert _build.library_path("kmeans").name.startswith("libkmeans-")
    assert _build._flags({"QK_DIM": 192, "V_DIM": 128})[-2:] == ["-DQK_DIM=192", "-DV_DIM=128"]
    assert _build._flags(None) == list(_build.NVCC_FLAGS)
