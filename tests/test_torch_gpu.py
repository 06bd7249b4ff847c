"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `gpu` and skips without a CUDA card: the kernels
have no CPU mode. This file imports no JAX, so it also runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Sort, grep and wordcount (secure) run on the card and on the CPU plain path
on the same inputs, at small and odd sizes with one wire on each side of the
ChaCha kernel's lanes threshold, and must agree bit for bit; a warm sort or
grep round must not synchronise before the driver's halt read.

Tolerances: ChaCha20 output exact (kernel == plain version bit for bit,
on row-aligned and packed wires, both kernel designs), one launch and no
synchronising call per crypt of a warm wire layout; k-means assignments equal to the plain
version's except at near-ties (the two smallest plain d2 within 1e-5 of
|x|^2 + |c|^2, the rule of chip_smoke.py; at most 1 in 1,000 points here
for D > 1)
and exactly equal on well-separated blobs, sums within rtol/atol 1e-5 and
counts within rtol 1e-6 of the plain accumulate fed the kernel's own
assignments, and two runs identical bit for bit in every case.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.kmeans import generate_points
from repro_torch.kernels.chacha20 import ops as tops
from repro_torch.kernels.chacha20.ref import chacha20_xor_packed_ref
from repro_torch.kernels.chacha20.table import block_table
from repro_torch.kernels.kmeans.ops import kmeans_assign
from repro_torch.kernels.kmeans.ref import kmeans_accumulate_ref, kmeans_assign_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def w(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32))


def _rand_table(rng, blocks, device):
    """Random counters (wrapping at 2**32) on a row-aligned table."""
    j = np.arange(blocks, dtype=np.int64)
    base = rng.integers(0, 2**32, blocks)
    mul = rng.integers(0, 2**32, blocks)
    base[: blocks // 2 + 1] = 2**32 - 1 - j[: blocks // 2 + 1]
    mul[: blocks // 2 + 1] = j[: blocks // 2 + 1] % 5
    return block_table(base, mul, 16 * j, np.full(blocks, 16), device)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [4, 1])
@pytest.mark.parametrize("rows,blocks", [(1, 1), (64, 132), (5, 1000)])
def test_chacha20_kernel_matches_plain(cuda, rows, blocks, lanes):
    from repro_torch.kernels.chacha20 import kernel

    rng = np.random.default_rng(rows + blocks)
    x = w(rng.integers(0, 2**32, (rows, 16 * blocks), dtype=np.uint32)).to(cuda)
    table = _rand_table(rng, blocks, cuda)
    nid, crow = (w(rng.integers(0, 2**32, rows, dtype=np.uint32)).to(cuda) for _ in range(2))
    key = rng.integers(0, 2**32, 8, dtype=np.uint32)
    nonce = rng.integers(0, 2**32, 3, dtype=np.uint32)
    args = (x, table, key, nonce, 2**32 - 3, nid, crow)
    before = kernel.launches
    got = kernel.chacha20_xor_packed_cuda(*args, lanes=lanes)
    assert kernel.launches == before + 1
    want = chacha20_xor_packed_ref(*[a.cpu() if torch.is_tensor(a) else a for a in args])
    assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="impl='torch'"):
        tops.chacha20_xor_words(x.reshape(-1), tops.make_state0(key, nonce, 0, device=cuda),
                                impl="torch")


def _packed_tree(rng, s, r, c, device):
    """Leaves of odd word counts, an (.., 0) leaf, bf16 and uint8: a packed wire
    whose leaves do not start on 16-word boundaries."""
    t = {"a": torch.as_tensor(rng.normal(size=(s, r, c, 3)).astype(np.float32)),
         "b": torch.as_tensor(rng.integers(0, 2**16, (s, r, c)).astype(np.int16)).view(
             torch.bfloat16),
         "e": torch.zeros((s, r, c, 0), dtype=torch.float32),
         "k": torch.as_tensor(rng.integers(-5, 100, (s, r, c)).astype(np.int32)),
         "u8": torch.as_tensor(rng.integers(0, 256, (s, r, c + 2)).astype(np.uint8))}
    return {k: v.to(device) for k, v in t.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("s,r,c,counter0,round_id", [
    (1, 1, 5, 0, None),                 # a 1-row wire
    (4, 4, 7, 2**32 - 40, 0),           # counters wrap inside the wire
    (8, 8, 33, 7, 2**32 - 1),           # the k-means round's row count
    (3, 3, 1, 2**31, 5),
])
def test_chacha20_fused_packed_matches_plain(cuda, s, r, c, counter0, round_id):
    from repro_torch.convert import secure_config
    from repro_torch.core import shuffle

    rng = np.random.default_rng(s * 100 + c)
    cfg = secure_config(rng.integers(0, 2**32, 8, dtype=np.uint32),
                        rng.integers(0, 2**32, 3, dtype=np.uint32), counter0)
    ids = w(rng.integers(0, 2**32, (2, s * r), dtype=np.uint32))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        wire, layout, _ = shuffle._pack_wire_coalesced(_packed_tree(np.random.default_rng(c), s,
                                                                    r, c, dev), lead=2)
        flat = wire.reshape(s * r, -1)
        out[dev.type] = shuffle._crypt_wire_coalesced(flat, layout, cfg, ids[0].to(dev),
                                                      ids[1].to(dev), round_id).cpu()
    assert torch.equal(out["cuda"], out["cpu"])


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [4, 1])
def test_chacha20_fused_64mib_unaligned_matches_plain(cuda, lanes):
    """64 MiB over 64 rows whose two leaves break the 16-word grid."""
    from repro_torch.core import shuffle
    from repro_torch.kernels.chacha20 import kernel

    rng = np.random.default_rng(64)
    tree = {"x": torch.as_tensor(rng.integers(0, 2**31, (8, 8, 262143)).astype(np.int32)),
            "y": torch.as_tensor(rng.integers(0, 256, (8, 8, 3)).astype(np.uint8))}
    wire, layout, _ = shuffle._pack_wire_coalesced({k: v.to(cuda) for k, v in tree.items()},
                                                   lead=2)
    flat = wire.reshape(64, -1)
    assert flat.numel() * 4 == 64 << 20
    table = shuffle._layout_table(layout, flat.device)
    ids = w(rng.integers(0, 2**32, (2, 64), dtype=np.uint32)).to(cuda)
    key = rng.integers(0, 2**32, 8, dtype=np.uint32)
    nonce = rng.integers(0, 2**32, 3, dtype=np.uint32)
    args = (flat, table, key, nonce, 2**32 - 1000, ids[0], ids[1])
    got = kernel.chacha20_xor_packed_cuda(*args, lanes=lanes)
    assert torch.equal(got, chacha20_xor_packed_ref(*args))


@pytest.mark.gpu
def test_chacha20_crypt_is_one_launch_and_never_syncs(cuda):
    from repro_torch import VirtualMesh
    from repro_torch.convert import secure_config
    from repro_torch.core import shuffle
    from repro_torch.kernels.chacha20 import kernel

    s = 8
    tree = _packed_tree(np.random.default_rng(1), s, s, 9, cuda)
    cfg = secure_config(np.arange(8, dtype=np.uint32), np.arange(3, dtype=np.uint32), 11)
    send_ids, send_rows, recv_ids, recv_rows = shuffle._exchange_ids(s, s, cuda)
    wire, layout, _ = shuffle._pack_wire_coalesced(tree, lead=2)
    flat = wire.reshape(s * s, -1)
    shuffle._crypt_wire_coalesced(flat, layout, cfg, send_ids, send_rows, 3)  # warm
    torch.cuda.synchronize()
    before = kernel.launches
    mesh = VirtualMesh(s, cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ct = shuffle._crypt_wire_coalesced(flat, layout, cfg, send_ids, send_rows, 3)
        assert kernel.launches == before + 1
        moved = mesh.all_to_all(ct.reshape(s, s, -1)).reshape(s * s, -1)
        back = shuffle._crypt_wire_coalesced(moved, layout, cfg, recv_ids, recv_rows, 3)
        assert kernel.launches == before + 2
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(back, mesh.all_to_all(wire).reshape(s * s, -1))


def _near_ties(pts, ctr):
    """(plain assignments, near-tie mask) by the chip_smoke.py rule, FP32."""
    x2 = torch.sum(pts * pts, dim=-1, keepdim=True)
    c2 = torch.sum(ctr * ctr, dim=-1)
    d2 = x2 + c2 - 2.0 * (pts @ ctr.T)
    best = torch.argmin(d2, dim=-1)
    if ctr.shape[0] < 2:
        return best.to(torch.int32), torch.zeros_like(best, dtype=torch.bool)
    top = torch.topk(d2, 2, dim=-1, largest=False).values
    tie = (top[..., 1] - top[..., 0]) <= 1e-5 * (x2[..., 0] + c2[best])
    return best.to(torch.int32), tie


def _run_twice(pts, ctr, wt):
    from repro_torch.kernels.kmeans import kernel

    before = kernel.launches
    a, sums, counts = kmeans_assign(pts, ctr, wt)
    a2, sums2, counts2 = kmeans_assign(pts, ctr, wt)
    torch.cuda.synchronize()
    assert kernel.launches == before + (2 if pts.shape[-2] else 0)
    assert torch.equal(a, a2) and torch.equal(sums, sums2) and torch.equal(counts, counts2)
    return a, sums, counts


@pytest.mark.gpu
@pytest.mark.parametrize("s,n,d,k", [
    (1, 77, 3, 7), (8, 1000, 4, 8), (2, 5000, 64, 256),
    (3, 1001, 5, 10),     # D=5: unaligned rows (4-byte copies), K padded to 16
    (2, 3000, 3, 300),    # D=3 with K past 256
    (2, 2999, 64, 300),   # K=300 at D=64, n not a multiple of the tiles
    (1, 4000, 64, 435),   # the largest K at D=64: centre table streamed in chunks
    (2, 1500, 1, 2000),   # D=1, K=2000: one column, the table whole
    (1, 700, 1, 8000),    # D=1, K=8000: one column, the table in chunks
])
def test_kmeans_kernel_matches_plain(cuda, s, n, d, k):
    rng = np.random.default_rng(n)
    pts = torch.as_tensor(rng.random((s, n, d)).astype(np.float32), device=cuda)
    ctr = torch.as_tensor(rng.random((k, d)).astype(np.float32), device=cuda)
    wt = torch.as_tensor((rng.random((s, n)) > 0.2).astype(np.float32), device=cuda)
    a, sums, counts = _run_twice(pts, ctr, wt)
    ra, tie = _near_ties(pts, ctr)
    assert int(((ra != a) & ~tie).sum()) == 0
    if d > 1:  # one column against thousands of centres is mostly near-ties
        assert float((ra != a).float().mean()) <= 1e-3
    ps, pc = kmeans_accumulate_ref(pts, a, wt, k)
    torch.testing.assert_close(sums, ps, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(counts, pc, rtol=1e-6, atol=0.0)
    with pytest.raises(ValueError, match="impl='torch'"):
        kmeans_assign(pts, ctr, wt, impl="torch")


@pytest.mark.gpu
def test_kmeans_kernel_blobs_assign_exactly(cuda):
    """Well-separated blobs: no near-ties, so the assignments are equal exactly."""
    pts_np, true_c = generate_points(3 * 4099, 16, d=8, seed=5, spread=0.01)
    pts = torch.as_tensor(pts_np.reshape(3, 4099, 8), device=cuda)
    ctr = torch.as_tensor(true_c, device=cuda)
    wt = torch.ones((3, 4099), dtype=torch.float32, device=cuda)
    a, sums, counts = _run_twice(pts, ctr, wt)
    ra, rs, rc = kmeans_assign_ref(pts, ctr, wt)
    assert torch.equal(a, ra)
    torch.testing.assert_close(sums, rs, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(counts, rc, rtol=1e-6, atol=0.0)


@pytest.mark.gpu
def test_kmeans_kernel_zero_weights_and_empty(cuda):
    rng = np.random.default_rng(9)
    pts = torch.as_tensor(rng.random((2, 333, 16)).astype(np.float32), device=cuda)
    ctr = torch.as_tensor(rng.random((50, 16)).astype(np.float32), device=cuda)
    a, sums, counts = _run_twice(pts, ctr, torch.zeros((2, 333), device=cuda))
    ra, tie = _near_ties(pts, ctr)
    assert int(((ra != a) & ~tie).sum()) == 0
    assert not bool(sums.any()) and not bool(counts.any())

    empty = torch.zeros((4, 0, 8), device=cuda)
    a, sums, counts = _run_twice(empty, ctr[:, :8].contiguous(), torch.zeros((4, 0), device=cuda))
    assert a.shape == (4, 0) and sums.shape == (4, 50, 8) and counts.shape == (4, 50)
    assert not bool(sums.any()) and not bool(counts.any())


@pytest.mark.gpu
def test_kmeans_kernel_refuses_shapes_out_of_range(cuda):
    pts = torch.zeros((1, 10, 64), device=cuda)
    with pytest.raises(ValueError, match="does not take K=436"):
        kmeans_assign(pts, torch.zeros((436, 64), device=cuda))
    with pytest.raises(ValueError, match="D <= 64"):
        kmeans_assign(torch.zeros((1, 10, 65), device=cuda), torch.zeros((4, 65), device=cuda))


# --- sort, grep and wordcount on the card against the CPU plain path --------------------

WIRE_LANES_LIMIT = 512 * 132  # kernel.lanes_for: four lanes up to one wave of an H100


def _cfg():
    from repro_torch.convert import secure_config

    return secure_config(np.arange(8, dtype=np.uint32) * 7, np.arange(3, dtype=np.uint32), 5)


def _wire_blocks(s: int, cap: int, leaves: int = 2) -> int:
    """Keystream blocks of a round's wire: S·R rows of `leaves` int32/f32
    leaves of `cap` words each."""
    return s * s * leaves * -(-cap // 16)


def _sort_values(n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    v = rng.lognormal(0.0, 1.0, n).astype(np.float32)
    v[rng.permutation(n)[:4]] = np.array([0.0, -0.0, 0.0, -0.0], np.float32)
    v[rng.permutation(n)[:5]] = np.float32(1.25)
    return v


@pytest.mark.gpu
@pytest.mark.parametrize("s,n_loc", [(3, 13), (8, 16384)], ids=["lanes4", "lanes1"])
def test_sample_sort_card_matches_cpu(cuda, s, n_loc):
    from repro_torch import VirtualMesh
    from repro_torch.core import driver
    from repro_torch.core.sort import initial_edges, make_sample_sort_spec, sample_sort
    from repro_torch.kernels.chacha20 import kernel

    v = _sort_values(s * n_loc)
    assert (kernel.lanes_for(_wire_blocks(s, n_loc), cuda) == 4) == (
        _wire_blocks(s, n_loc) <= WIRE_LANES_LIMIT)
    outs = {}
    for dev in ("cuda", "cpu"):
        mesh = VirtualMesh(s, dev)
        before = kernel.launches
        o, c, d = sample_sort(v, mesh, secure=_cfg(), n_rounds=5)
        spec = make_sample_sort_spec(mesh, n_loc, halt_total=v.size, shard_state=False)
        init = {"edges": torch.from_numpy(initial_edges(float(v.min()), float(v.max()), s)),
                "sorted": torch.full((s, s * n_loc), torch.inf), "counts": torch.zeros(s)}
        res = driver.run_until(spec, {"v": v}, init, mesh, secure=_cfg(), max_rounds=5)
        launched = kernel.launches - before
        outs[dev] = (o, c, d, res.rounds_executed, res.rounds_dispatched, res.halted,
                     res.state["edges"].cpu().numpy())
        if dev == "cuda":
            assert launched == 2 * (len(d) + res.rounds_executed)
    for a, b in zip(outs["cuda"], outs["cpu"]):
        a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    np.testing.assert_array_equal(outs["cuda"][0].view(np.uint32),
                                  np.sort(v, kind="stable").view(np.uint32))


@pytest.mark.gpu
@pytest.mark.parametrize("s,chunk,rounds", [(3, 7, 5), (8, 16384, 2)], ids=["lanes4", "lanes1"])
def test_grep_card_matches_cpu(cuda, s, chunk, rounds):
    from repro_torch import VirtualMesh
    from repro_torch.core.grep import grep_count

    rng = np.random.default_rng(chunk)
    t = (np.minimum(rng.zipf(1.2, s * chunk * rounds), 300) - 2).astype(np.int32)  # -1 pads
    pats = [0, 4, 0, 17, 299, 2]
    limit = int(np.isin(t, pats).sum()) // 2
    for mm in (None, limit):
        got = {dev: grep_count(t, pats, VirtualMesh(s, dev), secure=_cfg(), n_rounds=rounds,
                               max_matches=mm) for dev in ("cuda", "cpu")}
        np.testing.assert_array_equal(got["cuda"][0].cpu().numpy(), got["cpu"][0].numpy())
        np.testing.assert_array_equal(got["cuda"][1], got["cpu"][1])
        np.testing.assert_array_equal(got["cuda"][2], got["cpu"][2])
    assert got["cuda"][1].shape[0] < rounds or rounds == 2


@pytest.mark.gpu
@pytest.mark.parametrize("s,vocab", [(8, 65536), (8, 2**17 + 1)], ids=["lanes4", "lanes1"])
def test_wordcount_card_matches_cpu(cuda, s, vocab):
    from repro_torch import VirtualMesh
    from repro_torch.core.wordcount import wordcount
    from repro_torch.kernels.chacha20 import kernel

    cap = -(-vocab // s)
    assert (kernel.lanes_for(_wire_blocks(s, cap), cuda) == 4) == (vocab == 65536)
    rng = np.random.default_rng(vocab)
    t = (rng.zipf(1.1, s * 4099) % vocab).astype(np.int32)
    got = {dev: wordcount(t, vocab, VirtualMesh(s, dev), secure=_cfg())[0].cpu().numpy()
           for dev in ("cuda", "cpu")}
    np.testing.assert_array_equal(got["cuda"], got["cpu"])
    np.testing.assert_array_equal(got["cuda"], np.bincount(t, minlength=vocab).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["grep", "sort"])
def test_round_syncs_only_at_the_halt_read(cuda, workload):
    """A warm secure round runs clean under set_sync_debug_mode("error"); only
    the driver's halt read, after it, synchronises."""
    from repro_torch import VirtualMesh
    from repro_torch.core import driver
    from repro_torch.core.grep import make_grep_spec
    from repro_torch.core.sort import initial_edges, make_sample_sort_spec

    s = 8
    mesh = VirtualMesh(s, cuda)
    rng = np.random.default_rng(3)
    if workload == "grep":
        spec = make_grep_spec([1, 2, 3], 64, mesh, max_matches=10**6)
        inputs = {"t": rng.integers(0, 8, s * 64 * 4).astype(np.int32)}
        init = {"hits": torch.zeros(3), "cursor": torch.tensor(0)}
    else:
        v = rng.lognormal(0.0, 1.0, s * 64).astype(np.float32)
        spec = make_sample_sort_spec(mesh, 64, halt_total=v.size)
        inputs = {"v": v}
        init = {"edges": torch.from_numpy(initial_edges(float(v.min()), float(v.max()), s)),
                "sorted": torch.full((s, s * 64), torch.inf), "counts": torch.zeros(s)}
    sec, state, inp, layout = driver._prepare(spec, inputs, init, mesh, _cfg(), None, None)
    driver._round(spec, mesh, inp, state, 0, sec, None, {}, layout)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, aux, _ = driver._round(spec, mesh, inp, state, 1, sec, None, {}, layout)
        flag = spec.halt_fn(layout.for_halt(st), aux, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(flag) in (True, False)
