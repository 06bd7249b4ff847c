"""The MoE prefill's dispatch and combine by the routing's slot map
(`repro_torch.kernels.moe`, `models.moe._dispatch_rows`, `_combine_rows`).

On the CPU: each plain version equals what the gradient path computes,
bit for bit (the dispatch `bucket_pack` of the k-fold copy, the combine
`_combine` over the received buffer with its zero row), on random
routings that drop entries, leave an expert empty or send a whole shard to
one expert, in bf16 and float32; the no-gradient `_moe_shuffle_body`
equals the gradient path bit for bit; `kernel_calls` notes each once per
MoE layer of a prefill and never in a decode or a training step.

On the card (marked `gpu`, skipped without one; this file imports no JAX):
each kernel equals its plain version bit for bit at granite-moe's and
qwen2-moe's per-layer shapes and at odd widths, and the whole no-gradient
`_moe_shuffle_body` equals the gradient path's bits, plain and secure:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_moe_kernels.py
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch import VirtualMesh
from repro_torch.configs import get_config
from repro_torch.convert import secure_config
from repro_torch.core.shuffle import bucket_pack
from repro_torch.kernels import kernel_calls
from repro_torch.kernels.moe import kernel as mk
from repro_torch.kernels.moe.ref import moe_combine_ref, moe_dispatch_ref
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import init_params
from repro_torch.serve.engine import decode_step, init_cache, prefill

KEY = np.arange(8, dtype=np.uint32) * 0x01010101
NONCE = np.array([7, 8, 9], dtype=np.uint32)
ROUTINGS = ("random", "empty_expert", "one_expert")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def routing(r, n, k, e_pad, cap, kind, seed, device="cpu"):
    """(gates (R, n, k) f32, experts (R, n, k) int32, slots (R, E_pad, C), dropped
    (R,), pos (R, n·k)): `random` top-k sets (a capacity below n·k/E_pad drops
    entries), `empty_expert` (expert 1 never chosen), `one_expert` (every
    entry of shard 0 on expert 0)."""
    rng = np.random.default_rng(seed)
    experts = np.argsort(rng.random((r, n, e_pad)), axis=-1)[..., :k]
    if kind == "empty_expert":
        experts = np.where(experts == 1, 0, experts)
    if kind == "one_expert":
        experts[0] = 0
    gates = rng.random((r, n, k)).astype(np.float32) + 0.01
    gates /= gates.sum(-1, keepdims=True)
    eidx = torch.from_numpy(experts.astype(np.int32)).to(device)
    keys = torch.arange(n * k, dtype=torch.int32, device=device).expand(r, -1)
    slots, _, dropped, pos = bucket_pack(keys, eidx.reshape(r, -1), {}, e_pad, cap,
                                         return_positions=True)
    return torch.from_numpy(gates).to(device), eidx, slots, dropped, pos


def rows(shape, dtype, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def gradient_path_send(x2, eidx, e_pad, cap, k):
    """What the gradient path packs: `bucket_pack` of the k-fold copy."""
    r, n, d = x2.shape
    keys = torch.arange(n * k, dtype=torch.int32, device=x2.device).expand(r, -1)
    _, packed, dropped, pos = bucket_pack(keys, eidx.reshape(r, -1),
                                          {"x": tmoe._entry_values(x2, k)}, e_pad, cap,
                                          return_positions=True)
    return packed["x"].reshape(r, e_pad * cap, d), dropped, pos


# --- the plain versions on the CPU ---------------------------------------------------

CPU_SHAPES = [  # R, n, k, E_pad, C, d
    (4, 24, 4, 8, 8, 16),    # capacity 8 < 24·4/8 = 12 entries an expert: drops
    (2, 9, 3, 6, 8, 13),     # d odd
    (1, 5, 2, 4, 4, 1),
]


@pytest.mark.parametrize("kind", ROUTINGS)
@pytest.mark.parametrize("shape", CPU_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_dispatch_equals_bucket_pack_of_the_kfold_copy(dtype, shape, kind):
    r, n, k, e_pad, cap, d = shape
    _, eidx, slots, dropped, pos = routing(r, n, k, e_pad, cap, kind, seed=sum(shape))
    x2 = rows((r, n, d), dtype, seed=d)
    want, want_dropped, want_pos = gradient_path_send(x2, eidx, e_pad, cap, k)
    got = moe_dispatch_ref(x2, slots.reshape(r, -1), k)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got.flatten().view(torch.uint8), want.flatten().view(torch.uint8))
    assert torch.equal(dropped, want_dropped) and torch.equal(pos, want_pos)
    if kind == "random" and shape[0] == 4:
        assert int(dropped.sum()) > 0
    if kind == "empty_expert":
        assert not bool(got.reshape(r, e_pad, cap, d)[:, 1].any())  # expert 1: zeros


@pytest.mark.parametrize("kind", ROUTINGS)
@pytest.mark.parametrize("shape", CPU_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_combine_equals_combine_over_the_zero_row(dtype, shape, kind):
    r, n, k, e_pad, cap, d = shape
    gates, _, _, _, pos = routing(r, n, k, e_pad, cap, kind, seed=sum(shape) + 1)
    gates = gates.to(dtype)
    got_rows = rows((r, e_pad * cap, d), dtype, seed=d + 1)
    want = tmoe._combine(tmoe._with_zero_row(got_rows), pos, gates, n)
    got = moe_combine_ref(got_rows, pos, gates)
    assert got.dtype == dtype
    assert torch.equal(got.flatten().view(torch.uint8), want.flatten().view(torch.uint8))
    for b in (1, n) if n > 1 else (1,):  # straight in (B, T, d) order
        bt = moe_combine_ref(got_rows, pos, gates, b)
        assert torch.equal(bt, want.reshape(r, b, n // b, d).transpose(0, 1).reshape(
            b, r * n // b, d))


def test_plain_versions_keep_shapes_on_meta():
    r, n, k, e_pad, cap, d = CPU_SHAPES[0]
    _, _, slots, _, pos = routing(r, n, k, e_pad, cap, "random", seed=3)
    x2 = torch.empty((r, n, d), device="meta", dtype=torch.bfloat16)
    send = moe_dispatch_ref(x2, slots.reshape(r, -1).to("meta"), k)
    gates = torch.empty((r, n, k), device="meta", dtype=torch.bfloat16)
    y = moe_combine_ref(send, pos.to("meta"), gates, 2)
    assert send.is_meta and send.shape == (r, e_pad * cap, d)
    assert y.is_meta and y.shape == (2, r * n // 2, d)


def _launches():
    return mk.dispatch_launches, mk.combine_launches


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Without a card the wrappers refuse before any build or launch."""
    x2 = torch.zeros((2, 4, 8), dtype=torch.bfloat16)
    slots = torch.zeros((2, 8), dtype=torch.int32)
    before = _launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        mk.moe_dispatch_cuda(x2, slots, 2)
    with pytest.raises(ValueError, match="one of"):
        mk.moe_dispatch_cuda(x2.half(), slots, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mk.moe_combine_cuda(x2, slots, torch.zeros((2, 4, 2), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="one of"):
        mk.moe_combine_cuda(x2.half(), slots, torch.zeros((2, 4, 2), dtype=torch.float16))
    assert _launches() == before


def _moe_case(arch, n_model, dtype, seed=5):
    """A reduced model's MoE layer, random weights; capacity factor 0.5, so
    full experts drop entries."""
    cfg = replace(get_config(arch).reduced(), capacity_factor=0.5,
                  dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    params = tmoe.moe_init(cfg, n_model, "cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in params.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    return cfg, params.to(dtype)


def _body(cfg, params, x, mesh, secure, grad):
    with torch.set_grad_enabled(grad):
        return tmoe._moe_shuffle_body(cfg, params, x, mesh, secure)


@pytest.mark.parametrize("secure", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"])
def test_shuffle_body_by_slot_equals_the_gradient_path_on_the_cpu(arch, dtype, secure):
    r = 4
    cfg, params = _moe_case(arch, r, dtype)
    x = rows((2, 24, cfg.d_model), dtype, seed=9)
    sec = secure_config(KEY, NONCE, 3) if secure else None
    mesh = VirtualMesh(r, "cpu")
    with kernel_calls.recording() as calls:
        got = _body(cfg, params, x, mesh, sec, grad=False)
    assert calls["moe_dispatch"] == calls["moe_combine"] == 1
    with kernel_calls.recording() as grad_calls:
        want = _body(cfg, params.requires_grad_(False), x, mesh, sec, grad=True)
    assert "moe_dispatch" not in grad_calls and "moe_combine" not in grad_calls
    assert torch.equal(got[0].flatten().view(torch.uint8), want[0].flatten().view(torch.uint8))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert int(got[2]) > 0


def test_kernel_calls_note_each_moe_layer_of_a_prefill_and_no_decode_or_training_step():
    cfg = get_config("granite-moe-3b-a800m").reduced()
    model = init_params(cfg, torch.Generator().manual_seed(1), 2, "cpu")
    mesh = VirtualMesh(2, "cpu")
    b, t = 2, 8
    toks = torch.randint(0, cfg.vocab_size, (b, t + 1), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    cache = init_cache(cfg, b, t + 1, "cpu")
    with kernel_calls.recording() as pre:
        prefill(cfg, model, toks[:, :t], cache, mesh=mesh, secure_moe=secure_config(KEY, NONCE, 0))
    with kernel_calls.recording() as dec:
        decode_step(cfg, model, cache, toks[:, t:], mesh=mesh)
    assert pre["moe_dispatch"] == pre["moe_combine"] == cfg.n_layers
    assert "moe_dispatch" not in dec and "moe_combine" not in dec

    from repro_torch.models.lm import LM, forward

    train_model = LM(cfg, 2, "cpu", torch.float32)
    train_model.load_state_dict(model.state_dict())
    with kernel_calls.recording() as train:
        logits, _ = forward(cfg, train_model, {"tokens": toks[:, :t]}, mesh=mesh)
        logits.float().sum().backward()
    assert "moe_dispatch" not in train and "moe_combine" not in train


# --- the kernels on the card --------------------------------------------------------

CARD_SHAPES = {  # R, n, k, E_pad, C, d
    "granite": (8, 4096, 8, 40, 1028, 1536),
    "qwen2-moe": (8, 4096, 4, 64, 324, 2048),
    "d_odd": (3, 100, 6, 12, 40, 77),
    "d_not_multiple_of_8": (2, 64, 2, 8, 12, 100),
    "d_12": (2, 33, 5, 10, 16, 12),
}


def _bits(t):
    return t.contiguous().flatten().view(torch.uint8)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ROUTINGS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_kernels_equal_their_plain_versions_bit_for_bit(cuda, shape, dtype, kind):
    r, n, k, e_pad, cap, d = CARD_SHAPES[shape]
    gates, eidx, slots, _, pos = routing(r, n, k, e_pad, cap, kind, seed=d, device=cuda)
    gates = gates.to(dtype)
    x2 = rows((r, n, d), dtype, seed=d, device=cuda)
    before = _launches()
    send = mk.moe_dispatch_cuda(x2, slots.reshape(r, -1), k)
    assert _launches() == (before[0] + 1, before[1])
    plain = moe_dispatch_ref(x2, slots.reshape(r, -1), k)
    assert torch.equal(_bits(send), _bits(plain))
    if shape in ("granite", "d_odd"):  # and the gradient path's packing
        assert torch.equal(_bits(send), _bits(gradient_path_send(x2, eidx, e_pad, cap, k)[0]))
    del plain
    got_rows = rows((r, e_pad * cap, d), dtype, seed=d + 1, device=cuda)
    y = mk.moe_combine_cuda(got_rows, pos, gates)
    assert _launches() == (before[0] + 1, before[1] + 1)
    want = moe_combine_ref(got_rows, pos, gates)
    assert torch.equal(_bits(y), _bits(want))
    assert torch.equal(_bits(y), _bits(tmoe._combine(tmoe._with_zero_row(got_rows), pos, gates,
                                                     n)))
    if shape in ("d_odd", "d_12"):  # the CPU's bits too
        assert torch.equal(_bits(y).cpu(), _bits(moe_combine_ref(got_rows.cpu(), pos.cpu(),
                                                                 gates.cpu())))
    b = 4 if n % 4 == 0 else 1
    bt = mk.moe_combine_cuda(got_rows, pos, gates, b)
    assert torch.equal(_bits(bt), _bits(moe_combine_ref(got_rows, pos, gates, b)))
    assert torch.equal(mk.moe_combine_cuda(got_rows, pos, gates), y)  # no atomics


@pytest.mark.gpu
def test_kernels_read_strided_rows(cuda):
    """x2 and got as row-strided views (d contiguous): the same bits as
    from contiguous copies."""
    r, n, k, e_pad, cap, d = 2, 40, 4, 8, 24, 64
    gates, _, slots, _, pos = routing(r, n, k, e_pad, cap, "random", seed=1, device=cuda)
    wide = rows((r, n, 2 * d), torch.bfloat16, seed=2, device=cuda)
    x2 = wide[..., d:]
    assert not x2.is_contiguous()
    send = mk.moe_dispatch_cuda(x2, slots.reshape(r, -1), k)
    assert torch.equal(send, mk.moe_dispatch_cuda(x2.contiguous(), slots.reshape(r, -1), k))
    got_rows = rows((r, e_pad * cap + 3, d), torch.bfloat16, seed=3, device=cuda)[:, 3:]
    y = mk.moe_combine_cuda(got_rows, pos, gates.to(torch.bfloat16))
    assert torch.equal(y, moe_combine_ref(got_rows, pos, gates.to(torch.bfloat16)))


@pytest.mark.gpu
def test_kernel_wrappers_refuse_what_they_do_not_take(cuda):
    r, n, k, d = 2, 8, 2, 16
    x2 = rows((r, n, d), torch.bfloat16, seed=0, device=cuda)
    slots = torch.zeros((r, 12), dtype=torch.int32, device=cuda)
    pos = torch.zeros((r, n * k), dtype=torch.int32, device=cuda)
    gates = torch.ones((r, n, k), dtype=torch.bfloat16, device=cuda)
    got_rows = rows((r, 12, d), torch.bfloat16, seed=1, device=cuda)
    before = _launches()
    with pytest.raises(ValueError, match="one of"):
        mk.moe_dispatch_cuda(x2.half(), slots, k)
    with pytest.raises(ValueError, match="one of"):
        mk.moe_combine_cuda(got_rows.half(), pos, gates.half())
    with pytest.raises(ValueError, match="CUDA tensor"):  # two devices
        mk.moe_dispatch_cuda(x2, slots.cpu(), k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mk.moe_combine_cuda(got_rows, pos.cpu(), gates)
    with pytest.raises(ValueError, match="must be"):  # gates in another dtype
        mk.moe_combine_cuda(got_rows, pos, gates.float())
    with pytest.raises(ValueError, match="contiguous"):
        mk.moe_dispatch_cuda(x2[..., ::2], slots, k)
    assert _launches() == before


@pytest.mark.gpu
@pytest.mark.parametrize("secure", [False, True])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"])
def test_shuffle_body_with_the_kernels_equals_the_gradient_path(cuda, arch, secure):
    """A reduced model's MoE layer on 8 shards, bf16: `torch.no_grad()` (the
    kernels, one launch each) against `torch.enable_grad()` with no input
    requiring a gradient (the k-fold copy and `_combine`), bit for bit."""
    r = 8
    cfg, params = _moe_case(arch, r, torch.bfloat16)
    params = params.to(cuda).requires_grad_(False)
    x = rows((4, 256, cfg.d_model), torch.bfloat16, seed=4, device=cuda)
    sec = secure_config(KEY, NONCE, 11) if secure else None
    mesh = VirtualMesh(r, cuda)
    before = _launches()
    got = _body(cfg, params, x, mesh, sec, grad=False)
    assert _launches() == (before[0] + 1, before[1] + 1)
    want = _body(cfg, params, x, mesh, sec, grad=True)
    assert _launches() == (before[0] + 1, before[1] + 1)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert int(got[2]) > 0
