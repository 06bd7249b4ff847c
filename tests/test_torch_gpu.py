"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `gpu` and skips without a CUDA card: the kernels
have no CPU mode. This file imports no JAX, so it also runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Sort, grep and wordcount (secure) run on the card and on the CPU plain path
on the same inputs, at small and odd sizes with one wire on each side of the
ChaCha kernel's lanes threshold, and must agree bit for bit; a warm sort or
grep round must not synchronise before the driver's halt read.

The LM families' scans (the blocked WKV, the chunked SSD) run on the card
against the CPU on the same float32 inputs within rtol 1e-4 (the WKV also
against its per-token scan within 2e-4), and an audio batch's frames
decrypt on the card equal to the CPU's ARX bit for bit.

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
    (2, 3001, 64, 436),   # past the old range at D=64: partial sums in centre blocks
    (1, 2000, 64, 4096),
    (2, 1777, 65, 436),   # D=65: a chunk of 64 columns and a ragged one of 1
    (1, 2500, 128, 1024), # two full chunks, two column blocks
    (3, 999, 256, 4096),  # four chunks; 33 centre blocks of 128 in the assign
    (2, 1234, 200, 1024), # a ragged last chunk of 8 columns
    (1, 1500, 65, 1024),
    (2, 700, 128, 436),
    (1, 600, 256, 1024),
    (1, 800, 100, 4096),  # D not a multiple of 4: 4-byte copies in the accumulate
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
    """Every K >= 1 and D >= 1 is in range; no centre or no column is not."""
    with pytest.raises(ValueError, match="K >= 1 and D >= 1"):
        kmeans_assign(torch.zeros((1, 10, 64), device=cuda), torch.zeros((0, 64), device=cuda))
    with pytest.raises(ValueError, match="K >= 1 and D >= 1"):
        kmeans_assign(torch.zeros((1, 10, 0), device=cuda), torch.zeros((4, 0), device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("d,k", [(65, 436), (128, 1024), (256, 4096)])
def test_kmeans_kernel_empty_and_zero_weights_past_the_old_range(cuda, d, k):
    """n = 0 and all-zero weights at the shapes the old kernel refused."""
    rng = np.random.default_rng(d + k)
    ctr = torch.as_tensor(rng.random((k, d)).astype(np.float32), device=cuda)
    a, sums, counts = _run_twice(torch.zeros((3, 0, d), device=cuda), ctr,
                                 torch.zeros((3, 0), device=cuda))
    assert a.shape == (3, 0) and sums.shape == (3, k, d) and counts.shape == (3, k)
    assert not bool(sums.any()) and not bool(counts.any())
    pts = torch.as_tensor(rng.random((2, 333, d)).astype(np.float32), device=cuda)
    a, sums, counts = _run_twice(pts, ctr, torch.zeros((2, 333), device=cuda))
    ra, tie = _near_ties(pts, ctr)
    assert int(((ra != a) & ~tie).sum()) == 0
    assert not bool(sums.any()) and not bool(counts.any())


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
    sec = _cfg()
    inp, state, layout = driver._place(spec, mesh, inputs, init)
    driver._round(spec, mesh, inp, state, 0, sec, None, {}, layout,
                  capacity_factor=2.0)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, aux, _ = driver._round(spec, mesh, inp, state, 1, sec, None, {}, layout,
                                   capacity_factor=2.0)
        flag = spec.halt_fn(layout.for_halt(st), aux, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(flag) in (True, False)


# --- the round id from device memory, and the graph runner -----------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [4, 1])
@pytest.mark.parametrize("round_id", [0, 1, 2**31, 2**32 - 1])
@pytest.mark.parametrize("rows,blocks", [(64, 132), (5, 1000)])
def test_chacha20_round_dev_matches_by_value_and_plain(cuda, rows, blocks, round_id, lanes):
    """The round id read from device memory keys the keystream of the round
    XORed into nonce word 1 on the host, bit for bit, on both cores."""
    from repro_torch.kernels.chacha20 import kernel

    rng = np.random.default_rng(rows + blocks + lanes)
    x = w(rng.integers(0, 2**32, (rows, 16 * blocks), dtype=np.uint32)).to(cuda)
    table = _rand_table(rng, blocks, cuda)
    nid, crow = (w(rng.integers(0, 2**32, rows, dtype=np.uint32)).to(cuda) for _ in range(2))
    key = rng.integers(0, 2**32, 8, dtype=np.uint32)
    nonce = rng.integers(0, 2**32, 3, dtype=np.uint32)
    xored = nonce.copy()
    xored[1] ^= np.uint32(round_id)
    rd = w([round_id]).to(cuda)
    got = kernel.chacha20_xor_packed_cuda(x, table, key, nonce, 9, nid, crow, round_dev=rd,
                                          lanes=lanes)
    by_value = kernel.chacha20_xor_packed_cuda(x, table, key, xored, 9, nid, crow, lanes=lanes)
    assert torch.equal(got, by_value)
    assert torch.equal(got, chacha20_xor_packed_ref(x, table, key, nonce, 9, nid, crow,
                                                    round_dev=rd))


@pytest.mark.gpu
def test_graph_replays_at_two_rounds_give_those_rounds_ciphertext(cuda):
    """A crypt captured once, replayed with two round ids written by fill_,
    gives each round's own ciphertext."""
    from repro_torch.core import shuffle

    s = 8
    wire, layout, _ = shuffle._pack_wire_coalesced(
        _packed_tree(np.random.default_rng(2), s, s, 9, cuda), lead=2)
    flat = wire.reshape(s * s, -1)
    ids = shuffle._exchange_ids(s, s, cuda)
    r = torch.zeros((1,), dtype=torch.int32, device=cuda)
    shuffle._crypt_wire_coalesced(flat, layout, _cfg(), ids[0], ids[1], r)  # warm the caches
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = shuffle._crypt_wire_coalesced(flat, layout, _cfg(), ids[0], ids[1], r)
    got = {}
    for rnd in (5, 2**32 - 2):
        r.fill_(np.uint32(rnd).view(np.int32).item())
        graph.replay()
        got[rnd] = out.clone()
        assert torch.equal(got[rnd], shuffle._crypt_wire_coalesced(flat, layout, _cfg(), ids[0],
                                                                   ids[1], rnd))
    assert not torch.equal(got[5], got[2**32 - 2])


# --- the placed store: each row's output at the row its receiver reads ------------------


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [4, 1])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("rows,blocks,place", [(64, 132, 8), (9, 1000, 3), (12, 300, 4)])
def test_chacha20_place_rows_is_the_plain_version_transposed(cuda, rows, blocks, place,
                                                             aligned, lanes):
    """`place_rows` moves row s·R + r's store to row r·(n_rows/R) + s and
    nothing else, on both cores and on aligned and unaligned tables (a
    packed wire whose leaves break the 16-word grid): the placed kernel ==
    the plain version with its rows placed, and the unplaced kernel == the
    plain version."""
    from repro_torch.kernels.chacha20 import kernel
    from repro_torch.kernels.chacha20.ref import place_rows_ref

    rng = np.random.default_rng(rows + blocks + lanes + aligned)
    if aligned:
        x = w(rng.integers(0, 2**32, (rows, 16 * blocks), dtype=np.uint32)).to(cuda)
        table = _rand_table(rng, blocks, cuda)
    else:
        from repro_torch.core import shuffle

        tree = {"a": torch.as_tensor(rng.integers(0, 2**31, (rows, 1, 16 * blocks - 9))
                                     .astype(np.int32)),
                "b": torch.as_tensor(rng.integers(0, 256, (rows, 1, 7)).astype(np.uint8))}
        wire, layout, _ = shuffle._pack_wire_coalesced({k: v.to(cuda) for k, v in tree.items()},
                                                       lead=2)
        x = wire.reshape(rows, -1)
        table = shuffle._layout_table(layout, cuda)
        assert not table.aligned
    nid, crow = (w(rng.integers(0, 2**32, rows, dtype=np.uint32)).to(cuda) for _ in range(2))
    key = rng.integers(0, 2**32, 8, dtype=np.uint32)
    nonce = rng.integers(0, 2**32, 3, dtype=np.uint32)
    args = (x, table, key, nonce, 2**32 - 7, nid, crow)
    want = chacha20_xor_packed_ref(*args)
    assert torch.equal(kernel.chacha20_xor_packed_cuda(*args, lanes=lanes), want)
    before = kernel.launches
    placed = kernel.chacha20_xor_packed_cuda(*args, place_rows=place, lanes=lanes)
    assert kernel.launches == before + 1
    assert torch.equal(placed, place_rows_ref(want, place))
    for bad in (-1, rows + 1):
        with pytest.raises(ValueError, match="place_rows"):
            kernel.chacha20_xor_packed_cuda(*args, place_rows=bad, lanes=lanes)


@pytest.mark.gpu
def test_chacha20_place_rows_in_a_graph_with_round_dev(cuda):
    """A placed crypt captured once, replayed at two device round ids, gives
    each round's unplaced ciphertext in the receivers' row order."""
    from repro_torch.core import shuffle

    s = 8
    wire, layout, _ = shuffle._pack_wire_coalesced(
        _packed_tree(np.random.default_rng(5), s, s, 9, cuda), lead=2)
    flat = wire.reshape(s * s, -1)
    ids = shuffle._exchange_ids(s, s, cuda)
    r = torch.zeros((1,), dtype=torch.int32, device=cuda)
    shuffle._crypt_wire_coalesced(flat, layout, _cfg(), ids[0], ids[1], r, place_rows=s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = shuffle._crypt_wire_coalesced(flat, layout, _cfg(), ids[0], ids[1], r,
                                            place_rows=s)
    for rnd in (3, 2**32 - 1):
        r.fill_(np.uint32(rnd).view(np.int32).item())
        graph.replay()
        unplaced = shuffle._crypt_wire_coalesced(flat, layout, _cfg(), ids[0], ids[1], rnd)
        assert torch.equal(out.reshape(s, s, -1), unplaced.reshape(s, s, -1).transpose(0, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("several", [False, True])
def test_placed_exchange_is_two_launches_and_never_syncs(cuda, several):
    """A warm secure exchange on the card: one launch a crypt, nothing
    synchronises, the placed buffer is what the all_to_all returns, and the
    tree equals the CPU's bit for bit."""
    from repro_torch import VirtualMesh
    from repro_torch.core import shuffle
    from repro_torch.kernels.chacha20 import kernel

    s = 8
    g = torch.Generator().manual_seed(11)
    tree = {"x": torch.randint(-2**15, 2**15, (s, s, 40, 96), dtype=torch.int16,
                               generator=g).view(torch.bfloat16)}
    if several:
        tree["k"] = torch.randint(-1, 40, (s, s, 40), dtype=torch.int32, generator=g)
    seen = []

    class Tapped(VirtualMesh):
        def all_to_all(self, x):
            out = super().all_to_all(x)
            seen.append(out)
            return out

    on_card = {k: v.to(cuda) for k, v in tree.items()}
    mesh = Tapped(s, cuda)
    shuffle.keyed_all_to_all(on_card, mesh, _cfg(), round_index=4)  # warm
    torch.cuda.synchronize()
    seen.clear()
    before = kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        with shuffle.record_wire_bytes() as recs:
            got = shuffle.keyed_all_to_all(on_card, mesh, _cfg(), round_index=4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernel.launches == before + 2 and len(seen) == 1
    assert [rec["copies"] for rec in recs] == [1 if several else 0]
    want = shuffle.keyed_all_to_all(tree, VirtualMesh(s, "cpu"), _cfg(), round_index=4)
    for k in tree:
        a, b = got[k].cpu(), want[k]
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)


def _runner_case(workload, mesh):
    """(spec, inputs, init) of a secure job that halts inside an 8-round chunk
    (grep: 'grep_all' runs its whole stream without a halt)."""
    from repro_torch.core.grep import make_grep_spec
    from repro_torch.core.kmeans import make_kmeans_iterative_spec
    from repro_torch.core.sort import initial_edges, make_sample_sort_spec

    s = mesh.n_shards
    dev = mesh.device
    if workload == "kmeans":
        pts, _ = generate_points(s * 2048, 8, d=16, seed=5)
        spec = make_kmeans_iterative_spec(8, mesh, runtime_threshold=True)
        init = {"c": torch.from_numpy(pts[:8]).to(dev),
                "thr": torch.tensor(2e-3, device=dev)}
        return spec, {"p": pts, "w": np.ones(len(pts), np.float32)}, init
    if workload.startswith("sort"):
        v = _sort_values(s * 4096)
        v[:s * 64] = np.inf  # serving padding
        finite = v[np.isfinite(v)]
        spec = make_sample_sort_spec(mesh, 4096, dynamic_total=True,
                                     shard_state=workload == "sort_sharded")
        init = {"edges": torch.from_numpy(initial_edges(float(finite.min()),
                                                        float(finite.max()), s)).to(dev),
                "sorted": torch.full((s, s * 4096), torch.inf, device=dev),
                "counts": torch.zeros(s, device=dev),
                "total": torch.tensor(float(finite.size), device=dev)}
        return spec, {"v": v}, init
    rng = np.random.default_rng(9)
    t = (np.minimum(rng.zipf(1.2, s * 512 * 8), 300) - 2).astype(np.int32)
    limit = None if workload == "grep_all" else int(np.isin(t, [0, 4, 17]).sum()) // 3
    spec = make_grep_spec([0, 4, 17], 512, mesh, max_matches=limit)
    init = {"hits": torch.zeros(3, device=dev),
            "cursor": torch.zeros((), dtype=torch.int64, device=dev)}
    return spec, {"t": t}, init


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["kmeans", "sort_sharded", "sort_replicated", "grep",
                                      "grep_all"])
def test_graph_runner_equals_eager_chunk(cuda, workload):
    """The CUDA-graph runner gives the eager chunk's state, aux, drops, rounds
    and halt bit for bit, at two round offsets; in a chunk that halts, the
    card ran 2 ChaCha launches (and 1 k-means launch) per executed round and
    none after the halt."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import VirtualMesh
    from repro_torch.core import driver

    mesh = VirtualMesh(8, cuda)
    spec, inputs, init = _runner_case(workload, mesh)
    graph = driver.make_iterative_runner(spec, mesh, _cfg(), 8)
    eager = driver._EagerRunner(spec, mesh, _cfg(), 8)
    assert isinstance(graph, driver._GraphRunner)
    for offset in (3, 2**32 - 2):
        got, want = graph(inputs, init, offset), eager(inputs, init, offset)
        assert got[3:] == want[3:]
        for a, b in zip(driver.tree_flatten(got[:3])[0], driver.tree_flatten(want[:3])[0]):
            assert torch.equal(a, b)
    assert graph.captures == 1 and graph.pool_bytes > 0
    n_exec, halted = got[3], got[4]
    assert (halted, n_exec < 8) == ((workload != "grep_all"),) * 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # a first kernel that the counts leave out: a session's tracer has
        # been seen to miss what the card runs right after it starts
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        graph(inputs, init, 100)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("chacha20" in n for n in names) == 2 * n_exec
    assert sum("kmeans_assign_kernel" in n for n in names) == (
        n_exec if workload == "kmeans" else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["kmeans", "grep_all"])
def test_graph_runner_counts_kernel_calls_per_executed_round(cuda, workload):
    """`kernel_calls` sees every replayed round: a cold call counts its eager
    warm-up round and each executed round (the capture itself runs nothing
    and counts none); a warm call counts each executed round, as many as the
    profiler's ChaCha launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import VirtualMesh
    from repro_torch.core import driver
    from repro_torch.kernels import kernel_calls

    mesh = VirtualMesh(8, cuda)
    spec, inputs, init = _runner_case(workload, mesh)
    runner = driver.make_iterative_runner(spec, mesh, _cfg(), 8)
    per_round = {"chacha20_xor_packed": 2}
    if workload == "kmeans":
        per_round["kmeans_assign"] = 1
    with kernel_calls.recording() as cold:
        n_cold = runner(inputs, init, 0)[3]
    assert cold == {k: v * (1 + n_cold) for k, v in per_round.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            kernel_calls.recording() as warm:
        torch.cuda._sleep(1000)  # a first kernel the counts leave out
        torch.cuda.synchronize()
        n_warm = runner(inputs, init, 100)[3]
        torch.cuda.synchronize()
    assert warm == {k: v * n_warm for k, v in per_round.items()}
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("chacha20" in n for n in names) == warm["chacha20_xor_packed"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["kmeans", "grep_all"])
def test_warm_graph_chunk_syncs_once_per_executed_round(cuda, workload):
    """The one-round graph design: the host reads the halt flag after each
    replay (one synchronising call per executed round) and nothing else
    synchronises; a chunk without a halt makes none."""
    import warnings

    from repro_torch import VirtualMesh
    from repro_torch.core import driver

    mesh = VirtualMesh(8, cuda)
    spec, inputs, init = _runner_case(workload, mesh)
    inputs = {k: torch.as_tensor(v, device=cuda) for k, v in inputs.items()}
    runner = driver.make_iterative_runner(spec, mesh, _cfg(), 8)
    runner(inputs, init, 0)  # capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            out = runner(inputs, init, 8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(m.message) for m in got)
    assert syncs == (out[3] if spec.halt_fn is not None else 0)


def _service_mix(s):
    rng = np.random.default_rng(3)
    pts, _ = generate_points(s * 700, 4, d=8, seed=3)
    vals = rng.lognormal(0.0, 1.0, s * 900).astype(np.float32)
    toks = (np.minimum(rng.zipf(1.2, s * 1000), 300) - 2).astype(np.int32)
    return pts, vals, toks, np.array([0, 4, 17], np.int32)


@pytest.mark.gpu
def test_service_on_the_card_warm_resubmit_and_interleaved_equal_serial(cuda):
    """On the card: a warm resubmit captures nothing and misses nothing; a
    secure k-means, sort and grep mix served interleaved equals the same
    submissions served one at a time, bit for bit, the rerun all warm."""
    from repro_torch import VirtualMesh
    from repro_torch.serve import RunnerCache, SecureJobService

    s = 8
    pts, vals, toks, pats = _service_mix(s)
    cache = RunnerCache()

    def run(max_concurrent):
        with SecureJobService(VirtualMesh(s, cuda), secure=_cfg(), cache=cache,
                              max_concurrent=max_concurrent) as svc:
            hs = (svc.submit_kmeans(pts, 4, max_rounds=12),
                  svc.submit_sort(vals, max_rounds=5),
                  svc.submit_grep(toks, pats, n_rounds=4, max_matches=40))
            return hs, [h.result(timeout=600) for h in hs]

    cold, first = run(3)
    assert cache.captures() == len(cache) > 0
    captures = cache.captures()
    warm, again = run(1)
    assert all(h.warm for h in warm) and cache.captures() == captures
    for a, b in zip(first, again):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    np.testing.assert_array_equal(first[1]["sorted"], np.sort(vals))
    assert first[0]["halted"] and first[2]["halted"]


@pytest.mark.gpu
def test_a_jobs_graph_runners_share_their_statics_and_equal_eager(cuda):
    """run_until through a runner dict: the chunk sizes' runners (1, 2, 4)
    share one set of static buffers and one memory pool, and the job equals
    the eager run_until bit for bit."""
    from repro_torch import VirtualMesh
    from repro_torch.core import driver

    mesh = VirtualMesh(8, cuda)
    spec, inputs, init = _runner_case("sort_sharded", mesh)
    runners = {}
    got = driver.run_until(spec, inputs, init, mesh, secure=_cfg(), max_rounds=7,
                           runners=runners)
    want = driver.run_until(spec, inputs, init, mesh, secure=_cfg(), max_rounds=7)
    assert sorted(runners) == [1, 2] and got.rounds_executed == want.rounds_executed == 3
    assert runners[1]._statics is runners[2]._statics
    for k in got.state:
        assert torch.equal(got.state[k], want.state[k]), k
    np.testing.assert_array_equal(got.aux["counts"], want.aux["counts"])
    np.testing.assert_array_equal(got.dropped, want.dropped)


@pytest.mark.gpu
def test_graph_runner_halt_guard_raises_before_capture(cuda):
    """A halt_fn touching a sharded leaf raises the guard's ValueError in the
    runner's warm-up round, before any capture."""
    from repro_torch import VirtualMesh
    from repro_torch.core import driver

    mesh = VirtualMesh(8, cuda)
    base, inputs, init = _runner_case("sort_sharded", mesh)
    spec = driver.IterativeSpec(map_fn=base.map_fn, reduce_fn=base.reduce_fn,
                                hash_fn=base.hash_fn, capacity=base.capacity,
                                halt_fn=lambda state, aux, r: state["sorted"].sum() > 0,
                                state_specs=base.state_specs)
    runner = driver.make_iterative_runner(spec, mesh, _cfg(), 4)
    for _ in range(2):  # the runner kept nothing of the failed warm-up: a retry raises again
        with pytest.raises(ValueError, match=r"SHARDED carried-state leaf state\['sorted'\]"):
            runner(inputs, init, 0)
        assert runner.captures == 0 and not runner._statics


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["kmeans", "sort_sharded"])
def test_cold_graph_runner_warms_up_on_the_jobs_own_round(cuda, monkeypatch, workload):
    """A cold runner called at round 200 draws, in its eager warm-up, the
    keystream of round 200 (which its first replay redraws on the same
    plaintext) and no other round's; a sibling runner's capture runs no
    crypt. Both equal the eager chunk bit for bit."""
    from repro_torch import VirtualMesh
    from repro_torch.core import driver, shuffle
    from repro_torch.crypto.chacha import MASK32

    real = shuffle.chacha20_xor_packed
    seen = []

    def recording(*args, round_dev=None, **kwargs):
        if not torch.cuda.is_current_stream_capturing():
            seen.append(None if round_dev is None else int(round_dev.reshape(-1)[0]) & MASK32)
        return real(*args, round_dev=round_dev, **kwargs)

    monkeypatch.setattr(shuffle, "chacha20_xor_packed", recording)
    mesh = VirtualMesh(8, cuda)
    spec, inputs, init = _runner_case(workload, mesh)
    runner = driver.make_iterative_runner(spec, mesh, _cfg(), 4)
    got = runner(inputs, init, 200)
    assert seen == [200, 200]
    sibling = driver.make_iterative_runner(spec, mesh, _cfg(), 2, share_with=runner)
    got2 = sibling(inputs, init, 300)
    assert seen == [200, 200] and sibling.captures == 1
    monkeypatch.setattr(shuffle, "chacha20_xor_packed", real)
    for out, n, offset in ((got, 4, 200), (got2, 2, 300)):
        want = driver._EagerRunner(spec, mesh, _cfg(), n)(inputs, init, offset)
        assert out[3:] == want[3:]
        for a, b in zip(driver.tree_flatten(out[:3])[0], driver.tree_flatten(want[:3])[0]):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_graph_runner_replays_after_the_constant_caches_evict(cuda):
    """The device constants a captured round reads (block table, exchange
    ids) stay with the runner's statics: after the LRU caches are cleared
    and their memory handed out again, the cached runner still equals the
    eager chunk, and a sibling captured since copies nothing from the host."""
    import gc

    from repro_torch import VirtualMesh
    from repro_torch.core import driver, shuffle
    from repro_torch.kernels.chacha20 import ops, table

    mesh = VirtualMesh(8, cuda)
    spec, inputs, init = _runner_case("kmeans", mesh)
    runner = driver.make_iterative_runner(spec, mesh, _cfg(), 4)
    runner(inputs, init, 0)
    for fn in (shuffle._layout_table, shuffle._exchange_ids, table.row_table, ops._zero_id):
        fn.cache_clear()
    gc.collect()
    junk = [torch.full((n,), -7, dtype=torch.int32, device=cuda)  # noqa: F841
            for n in (16, 64, 128, 256, 512, 1024, 4096) for _ in range(16)]
    sibling = driver.make_iterative_runner(spec, mesh, _cfg(), 2, share_with=runner)
    for r, n in ((runner, 4), (sibling, 2), (runner, 4)):
        got = r(inputs, init, 17)
        want = driver._EagerRunner(spec, mesh, _cfg(), n)(inputs, init, 17)
        assert got[3:] == want[3:]
        for a, b in zip(driver.tree_flatten(got[:3])[0], driver.tree_flatten(want[:3])[0]):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_kmeans_runner_serves_fits_of_two_sizes_on_the_card(cuda):
    """One `make_kmeans_runner(...)` fits two sizes of points, each equal bit
    for bit to the eager fit; its runners hold one capture per size."""
    from repro_torch import VirtualMesh
    from repro_torch.core.kmeans import kmeans_fit, make_kmeans_runner

    mesh = VirtualMesh(8, cuda)
    runner = make_kmeans_runner(mesh, 8, secure=_cfg(), threshold=2e-3, rounds_per_dispatch=4)
    for n in (8 * 2048, 8 * 1024):
        pts, _ = generate_points(n, 8, d=16, seed=5)
        got = kmeans_fit(pts, 8, mesh, runner=runner, max_iter=12)
        want = kmeans_fit(pts, 8, mesh, secure=_cfg(), threshold=2e-3, max_iter=12,
                          rounds_per_dispatch=4)
        assert torch.equal(got.centers, want.centers), n
        assert (got.n_iter, got.center_shift) == (want.n_iter, want.center_shift)
    assert runner.runners.get_or_build(1, None).captures == 2  # a hit: nothing is built


# --- the k-means kernel past the old range, through the fit and the service --------


@pytest.mark.gpu
def test_kmeans_fit_d128_k1024_on_the_card_gives_the_cpus_rounds(cuda):
    """kmeans_fit at D=128, K=1024 (a shape the old kernel refused) on the
    card: the CPU plain path's n_iter and rounds, centres within rtol 1e-4
    and atol 1e-5 (sums taken in another order)."""
    from repro_torch import VirtualMesh
    from repro_torch.core.kmeans import kmeans_fit

    pts, true_c = generate_points(8 * 2048, 1024, d=128, seed=11, spread=0.01)
    fits = {dev: kmeans_fit(pts, 1024, VirtualMesh(8, dev), max_iter=6, threshold=1e-6,
                            init_centers=true_c)
            for dev in ("cuda", "cpu")}
    card, cpu = fits["cuda"], fits["cpu"]
    assert (card.n_iter, card.n_rounds_dispatched) == (cpu.n_iter, cpu.n_rounds_dispatched)
    torch.testing.assert_close(card.centers.cpu(), cpu.centers, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("d,k", [(65, 436), (128, 1024), (256, 4096)])
def test_submit_kmeans_takes_shapes_past_the_old_range(cuda, d, k):
    """The card service serves k-means at (D, K) the old kernel refused;
    the result matches the CPU service's within rtol 1e-4 and atol 1e-5, in
    the same number of rounds."""
    from repro_torch import VirtualMesh
    from repro_torch.serve import SecureJobService

    pts, true_c = generate_points(2 * k + 77, k, d=d, seed=d, spread=0.01)
    out = {}
    for dev in ("cuda", "cpu"):
        with SecureJobService(VirtualMesh(8, dev), secure=_cfg(), max_chunk=2) as svc:
            out[dev] = svc.submit_kmeans(pts, k, threshold=1e-6, max_rounds=3,
                                         init_centers=true_c).result(600)
    assert out["cuda"]["n_iter"] == out["cpu"]["n_iter"]
    np.testing.assert_allclose(out["cuda"]["centers"], out["cpu"]["centers"], rtol=1e-4,
                               atol=1e-5)


# --- graph runners shared across threads, and their shape bound --------------------


@pytest.mark.gpu
def test_two_services_on_one_cache_from_two_threads_equal_serial(cuda):
    """Two SecureJobServices on one RunnerCache serve same-bucket k-means
    jobs at once (each its own scheduler thread, one graph runner between
    them): every result equals the serial one bit for bit."""
    from repro_torch import VirtualMesh
    from repro_torch.serve import RunnerCache, SecureJobService

    mesh = VirtualMesh(8, cuda)
    jobs = [generate_points(8 * 3000, 8, d=16, seed=s)[0] for s in range(6)]

    def serve(services):
        handles = [services[i % len(services)].submit_kmeans(p, 8, threshold=1e-5,
                                                              max_rounds=6)
                   for i, p in enumerate(jobs)]
        return [h.result(600) for h in handles]

    cache = RunnerCache()
    with SecureJobService(mesh, secure=_cfg(), cache=cache, max_chunk=2) as one:
        serial = serve([one])
    a = SecureJobService(mesh, secure=_cfg(), cache=cache, max_chunk=2)
    b = SecureJobService(mesh, secure=_cfg(), cache=cache, max_chunk=2)
    try:
        for _ in range(2):
            together = serve([a, b])
            for got, want in zip(together, serial):
                np.testing.assert_array_equal(got["centers"], want["centers"])
                assert got["n_iter"] == want["n_iter"]
    finally:
        a.close()
        b.close()
    # one shape between the two services: every call used the same statics
    assert len(cache.shape_budget) == 1


@pytest.mark.gpu
def test_fits_at_three_sizes_through_a_cache_capped_at_two_hold_two_statics(cuda):
    """A fit runner on a RunnerCache(max_resident=2): fits at three sizes
    keep the statics (input copies and captures) of the two most recently
    used sizes; each fit equals the eager fit bit for bit; clearing the
    cache frees them."""
    from repro_torch import VirtualMesh
    from repro_torch.core.kmeans import kmeans_fit, make_kmeans_runner
    from repro_torch.serve import RunnerCache

    mesh = VirtualMesh(8, cuda)
    cache = RunnerCache(max_resident=2)
    runner = make_kmeans_runner(mesh, 8, secure=_cfg(), threshold=2e-3, rounds_per_dispatch=2,
                                cache=cache)
    for n in (8 * 1024, 8 * 2048, 8 * 3072, 8 * 1024):
        pts, _ = generate_points(n, 8, d=16, seed=n)
        got = kmeans_fit(pts, 8, mesh, runner=runner, max_iter=8)
        want = kmeans_fit(pts, 8, mesh, secure=_cfg(), threshold=2e-3, max_iter=8,
                          rounds_per_dispatch=2)
        assert torch.equal(got.centers, want.centers), n
    statics = {id(st) for r in cache._resident() for st in r._statics.values()}
    assert len(statics) == len(cache.shape_budget) == 2
    assert cache.shape_budget.evictions == 2
    held = torch.cuda.memory_allocated(cuda)
    cache.clear()  # frees the statics and captures at once
    assert len(cache.shape_budget) == 0 and cache.captures() == 0
    assert torch.cuda.memory_allocated(cuda) < held


# --- the enclave layers on the card -------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 1024, 1 << 20])
def test_mac_tag_words_on_the_card_equals_the_host_tag(cuda, n):
    from repro_torch.crypto import mac

    rng = np.random.default_rng(n)
    msg = rng.integers(0, 2**32, n, dtype=np.uint32)
    rs, ss = mac.mac_keys_from_keystream(np.arange(8, dtype=np.uint32),
                                         np.arange(3, dtype=np.uint32), 5)
    tag = mac.mac_tag_words(torch.from_numpy(msg.view(np.int32)).to(cuda), rs, ss)
    assert tag.device.type == "cuda"
    np.testing.assert_array_equal(tag.cpu().numpy().view(np.uint32), mac.mac_tag_host(msg, rs, ss))


def _secvm_progs():
    from repro_torch.core import secvm

    poly = secvm.assemble([("LOADC", 2, 0, 0), ("LOADC", 3, 0, 1), ("LOADC", 0, 0, 2),
                           ("MUL", 4, 1, 1), ("FMA", 0, 4, 2), ("FMA", 0, 1, 3),
                           ("NOP", 0, 0, 0)], consts=[2.0, 3.0, 1.0])
    dist = secvm.assemble([("LOADC", 3, 0, 0), ("LOADC", 4, 0, 1), ("SUB", 5, 1, 3),
                           ("SUB", 6, 2, 4), ("MUL", 5, 5, 5), ("FMA", 5, 6, 6),
                           ("SQRT", 0, 5, 0)], consts=[0.5, -1.5, 0.0])
    return poly, dist


def _kernel_sequences(fns) -> list:
    """Each fn's kernel names in order, all in one profiler session, split at
    spin-kernel markers before each fn and after the last; a sacrificial
    spin kernel goes first after each synchronise (the profiler has been
    seen to lose the first kernel launched after one)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for fn in list(fns) + [None]:
            torch.cuda._sleep(1000)
            torch.cuda._sleep(1000)
            if fn is not None:
                fn()
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    segments, cur = [], None
    for e in events:
        if "spin_kernel" in e.name:
            if cur:
                segments.append(tuple(cur))
            cur = []
        elif cur is not None:
            cur.append(e.name)
    assert len(segments) == len(fns)
    return segments


@pytest.mark.gpu
def test_secvm_on_the_card_matches_the_oracle_without_a_sync(cuda):
    """run_encrypted on the card equals the oracle (rtol 1e-5) and, warm,
    makes no synchronising call; two programs of one length launch the same
    kernels in the same order (profiler: three calls of each in turns, each
    program's sequence the one two of its calls agree on)."""
    from repro_torch.core import secvm
    from repro_torch.crypto import chacha

    kw, nw = chacha.key_to_words(bytes(range(32))), chacha.nonce_to_words(b"\x03" * 12)
    x = np.random.default_rng(0).normal(size=(2, 4099)).astype(np.float32)
    xd = torch.from_numpy(x).to(cuda)
    calls = []
    for prog in _secvm_progs():
        code_ct, consts_ct = secvm.encrypt_program(prog, kw, nw, 9, device=cuda)
        got = secvm.run_encrypted(code_ct, consts_ct, xd, kw, nw, 9)
        np.testing.assert_allclose(got.cpu().numpy(), secvm.run_oracle(prog, x), rtol=1e-5,
                                   atol=1e-5)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            secvm.run_encrypted(code_ct, consts_ct, xd, kw, nw, 9)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append(lambda c=code_ct, k=consts_ct: secvm.run_encrypted(c, k, xd, kw, nw, 9))
    seqs = _kernel_sequences(calls * 3)
    agreed = []
    for i in (0, 1):
        mine = seqs[i::2]
        best = max(set(mine), key=mine.count)
        assert mine.count(best) >= 2
        agreed.append(best)
    assert len(agreed[0]) > 18 * 7 and agreed[0] == agreed[1]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape", [(torch.int32, (7, 4)), (torch.float32, (3,)),
                                         (torch.uint8, (37,)), (torch.bfloat16, (5, 3)),
                                         (torch.int32, (0,))])
def test_ctr_encrypt_array_on_the_card_is_one_kernel_launch(cuda, dtype, shape):
    """crypto/ctr.py on a CUDA tensor: one launch of the ChaCha20 kernel per
    crypt, the CPU ARX's bits (a counter wrapping at 2**32), whether the
    counter is a host int or a 0-d device tensor (read by the kernel from
    device memory, never on the host: the crypt is clean under
    set_sync_debug_mode("error"))."""
    from repro_torch.crypto import chacha, ctr
    from repro_torch.kernels.chacha20 import kernel

    kw, nw = chacha.key_to_words(bytes(range(32))), chacha.nonce_to_words(b"\x07" * 12)
    n = int(np.prod(shape))
    raw = np.random.default_rng(3).integers(0, 256, (4 * max(n, 1),), np.uint8)
    x = torch.from_numpy(raw).view(dtype)[:n].reshape(shape)
    want = ctr.encrypt_array(x, kw, nw, 2**32 - 1)
    before = kernel.launches
    got = ctr.encrypt_array(x.to(cuda), kw, nw, 2**32 - 1)
    assert kernel.launches == before + (1 if x.numel() else 0)
    assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))
    xd, counter = x.to(cuda), torch.tensor(2**32 - 1, dtype=torch.int64, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dev_ctr = ctr.encrypt_array(xd, kw, nw, counter)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernel.launches == before + (2 if x.numel() else 0)
    assert torch.equal(dev_ctr.cpu().view(torch.uint8), want.view(torch.uint8))


# --- the calibrated cost model on the card ---------------------------------------------


@pytest.fixture(scope="module")
def card_calibration():
    """One quick calibration on 8 virtual shards of the card, for the tests below."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the calibration probes the card)")
    from repro_torch import VirtualMesh
    from repro_torch.perf.calibrate import run_calibration

    return run_calibration(VirtualMesh(8, torch.device("cuda")), quick=True)


@pytest.mark.gpu
def test_quick_calibration_on_the_card(cuda, card_calibration):
    """Finite constants >= 0 under the card's key, the probes' capture
    seconds > 0 (a cold graph runner warms up and captures), and each probe
    round's device operations counted."""
    cal = card_calibration
    assert cal.key == f"torch-cuda/{torch.cuda.device_count()}" and cal.n_shards == 8
    (entry,) = cal.chacha.values()
    assert list(cal.chacha) == ["auto"] and entry["resolved"] == ["cuda", False]
    for v in (entry["us_per_block"], entry["launch_us"], cal.all_to_all["us_per_byte"],
              cal.all_to_all["base_us"], cal.dispatch["base_us"], cal.round["us_per_item"],
              cal.round["base_us"], cal.compile["s_per_eqn"], cal.compile["base_s"]):
        assert np.isfinite(v) and v >= 0
    assert entry["compile_s"] > 0 and cal.round["compile_s"] > 0
    assert cal.compile["s_per_eqn"] > 0 or cal.compile["base_s"] > 0
    assert entry["compile_eqns"] > cal.round["compile_eqns"] > 0


_KNOB_ENVS = ("REPRO_SHUFFLE_COALESCE", "REPRO_CHUNK_GROWTH", "REPRO_STATE_SPECS",
              "REPRO_BUCKET_GROWTH", "REPRO_SERVICE_MAX_RUNNERS", "REPRO_CALIBRATION")


@pytest.mark.gpu
def test_resolvers_follow_the_card_calibration(cuda, card_calibration, monkeypatch):
    from repro_torch.core import driver, shuffle
    from repro_torch.perf.model import CostModel, clear_active_model, set_active_model
    from repro_torch.serve import service

    for var in _KNOB_ENVS:
        monkeypatch.delenv(var, raising=False)
    model = CostModel(card_calibration)
    set_active_model(model)
    try:
        assert shuffle.resolve_coalesce("auto") is model.recommend("coalesce") is True
        assert driver.resolve_chunk_growth("auto") == model.recommend(
            "chunk_growth", min_chunk=1, max_rounds=64, max_chunk=None)
        assert driver.resolve_capacity_factor() == 2.0  # no measured skew in the probes
        assert service.resolve_bucket_growth() == model.recommend("bucket_growth")
        assert service.resolve_max_resident("auto") is None
        assert model.recommend("chacha_impl") == "auto"
    finally:
        clear_active_model()
    assert driver.resolve_chunk_growth("auto") == 2 and service.resolve_bucket_growth() == 2.0


@pytest.mark.gpu
def test_warm_served_kmeans_chunk_resolves_no_knob(cuda, card_calibration, monkeypatch):
    """A warm 2-round chunk of a served k-means runner, with a calibration
    active, makes 14 host launch calls (7 a round, as without one), and still
    runs with every knob variable invalid and a model that raises: the graph
    replays resolve nothing."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import VirtualMesh
    from repro_torch.core import driver
    from repro_torch.perf.model import CostModel, clear_active_model, set_active_model
    from repro_torch.serve import RunnerCache, SecureJobService

    class Raising:
        def recommend(self, knob, **ctx):
            raise AssertionError(f"knob {knob!r} resolved in a warm chunk")

    host_calls = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
                  "cudaMemsetAsync")
    s, n, k, d = 8, 65536, 16, 8
    pts, _ = generate_points(n, k, d=d, seed=3)
    mesh = VirtualMesh(s, cuda)
    cache = RunnerCache()
    for var in _KNOB_ENVS:
        monkeypatch.delenv(var, raising=False)
    set_active_model(CostModel(card_calibration))
    try:
        with SecureJobService(mesh, secure=_cfg(), cache=cache, min_chunk=2, max_chunk=2,
                              bucket_growth=2.0) as svc:  # bucket n, whatever the model says
            svc.submit_kmeans(pts, k, max_rounds=4).result(timeout=600)
        runner = cache.view(spec_id=("kmeans", k, d, n), mesh=mesh,
                            secure=_cfg()).get_or_build(2, lambda: None)
        assert isinstance(runner, driver._GraphRunner)
        points = torch.from_numpy(pts).to(cuda)
        inputs = {"p": points, "w": torch.ones(n, device=cuda)}
        init = {"c": points[:k].clone(), "thr": torch.zeros((), device=cuda)}  # never halts
        runner(inputs, init, 0)  # copies these inputs in: later calls copy the state only
        counts = []
        for poisoned in (False, True):
            if poisoned:
                set_active_model(Raising())
                for var in _KNOB_ENVS[:-1]:
                    monkeypatch.setenv(var, "sideways")
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = runner(inputs, init, 0)
                torch.cuda.synchronize()
            assert out[3] == 2
            counts.append(sum(any(e.name.startswith(c) for c in host_calls)
                              for e in prof.events()
                              if e.device_type == torch.autograd.DeviceType.CPU))
    finally:
        clear_active_model()
    assert counts == [14, 14]


# --- LM serving: the MoE's secure expert exchange on the card ---------------------------


def _lm_serve(cfg, model, toks, mesh, secure):
    from repro_torch.serve.engine import decode_step, init_cache, prefill

    cache = init_cache(cfg, toks.shape[0], toks.shape[1] + 2, toks.device)
    tp = toks.shape[1] - 2
    out = [prefill(cfg, model, toks[:, :tp], cache, mesh=mesh, secure_moe=secure)]
    for i in (tp, tp + 1):
        out.append(decode_step(cfg, model, cache, toks[:, i:i + 1], mesh=mesh))
    return out, cache


@pytest.mark.gpu
@pytest.mark.parametrize("arch,shards", [("granite-moe-3b-a800m", 4), ("qwen2-moe-a2.7b", 2)])
def test_secure_moe_serving_card_equals_cpu(cuda, arch, shards):
    """Reduced config (float32), secure prefill and two decode steps: the card
    within rtol/atol 1e-3 of the CPU's plain versions, 4 ChaCha launches a
    layer in the prefill, and secure logits == plain logits bit for bit."""
    from repro_torch import VirtualMesh
    from repro_torch.configs import get_config
    from repro_torch.kernels.chacha20 import kernel as ck
    from repro_torch.models.lm import LM, init_params

    cfg = get_config(arch).reduced()
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0), shards, "cpu")
    card_model = LM(cfg, shards, cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 18)).astype(np.int32))
    sec = _cfg()
    want, _ = _lm_serve(cfg, cpu_model, toks, VirtualMesh(shards, "cpu"), sec)
    before = ck.launches
    got, cache = _lm_serve(cfg, card_model, toks.to(cuda), VirtualMesh(shards, cuda), sec)
    assert ck.launches - before == 4 * cfg.n_layers
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float().cpu(), w.float(), rtol=1e-3, atol=1e-3)
    plain, plain_cache = _lm_serve(cfg, card_model, toks.to(cuda), VirtualMesh(shards, cuda),
                                   None)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    assert torch.equal(cache["k"], plain_cache["k"])


@pytest.mark.gpu
@pytest.mark.parametrize("shards,e_loc,cap,d", [(8, 5, 12, 1536), (4, 1, 5, 33), (2, 3, 4, 7)])
def test_chacha_on_a_bf16_moe_wire_equals_plain(cuda, shards, e_loc, cap, d):
    """The MoE's send buffers (S, S, E_loc * cap, d) bf16, odd row widths
    included (a padded last word): the kernel == its plain version bit for bit."""
    from repro_torch import VirtualMesh
    from repro_torch.core import shuffle

    g = torch.Generator().manual_seed(shards * 1000 + d)
    send = torch.randint(-2**15, 2**15, (shards, shards, e_loc * cap, d), dtype=torch.int16,
                         generator=g).view(torch.bfloat16)
    outs = {}
    for dev in ("cpu", cuda):
        wire, layout, treedef = shuffle._pack_wire_coalesced({"x": send.to(dev)}, lead=2)
        s, r, w = wire.shape
        ids = shuffle._exchange_ids(s, r, wire.device)
        outs[str(dev)] = shuffle._crypt_wire_coalesced(wire.reshape(s * r, w), layout, _cfg(),
                                                       ids[0], ids[1], 3).cpu()
    assert torch.equal(outs["cpu"], outs[str(cuda)])
    recv = shuffle.keyed_all_to_all({"x": send.to(cuda)}, VirtualMesh(shards, cuda), _cfg())
    bits = recv["x"].cpu().view(torch.int16)  # random bits hold NaNs: compare patterns
    assert torch.equal(bits, send.view(torch.int16).transpose(0, 1))


def _train_steps(cfg, device, shards, cpu_model, n_steps, secure_moe):
    """`n_steps` donated train steps of a copy of `cpu_model` on `device`,
    secure ingest from a seeded `SecureShardedSource`; (model, opt,
    per-step metrics, per-step ChaCha launches)."""
    from repro_torch import VirtualMesh
    from repro_torch.crypto.keys import make_session_keys
    from repro_torch.data.pipeline import SecureShardedSource
    from repro_torch.data.synthetic import synthetic_tokens
    from repro_torch.kernels.chacha20 import kernel as ck
    from repro_torch.models.lm import LM
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import SecureIngest, make_train_step

    model = LM(cfg, shards, device, torch.float32)
    model.load_state_dict(cpu_model.state_dict())
    opt = adamw_init(dict(model.named_parameters()))
    session = make_session_keys(b"\x21" * 32)
    ingest = SecureIngest(key_words=session.words("data"),
                          nonce_words=session.nonce_words("data", 0))
    src = SecureShardedSource(synthetic_tokens(3000, cfg.vocab_size, seed=1), batch=4,
                              seq=16, session=session, seed=3, device=device)
    step = make_train_step(cfg, VirtualMesh(shards, device), secure_ingest=ingest,
                           secure_moe=secure_moe, peak_lr=1e-3, warmup=1, total_steps=10)
    metrics, launches, mus = [], [], []
    for i in range(n_steps):
        batch = src.next_batch()
        before = ck.launches
        model, opt, m = step(model, opt, batch, i + 1)
        launches.append(ck.launches - before)
        metrics.append({k: float(v) for k, v in m.items()})
        mus.append({k: v.detach().cpu().clone() for k, v in opt["mu"].items()})
    opt["mu_by_step"] = mus
    return model, opt, metrics, launches


@pytest.mark.gpu
def test_train_step_card_equals_cpu(cuda):
    """Reduced granite-moe (float32), secure ingest and secure MoE on 4
    shards, two steps at lr 1e-3: losses and grad norms within rtol 1e-4 of
    the CPU's plain versions; parameters within 1e-2·lr where the gradient
    is at least 1e-2 of its leaf's largest at both steps (float32 sums in
    other orders round a gradient by ~1e-6 of its leaf's scale, which Adam's
    per-element normalisation passes into a smaller element's update at full
    size; at step 1 the update is lr·sign(g): the rule of chip_smoke.py's
    lm_train phase)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_params

    cfg = get_config("granite-moe-3b-a800m").reduced()
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0), 4, "cpu", torch.float32)
    sec = _cfg()
    want_model, want_opt, want_m, _ = _train_steps(cfg, "cpu", 4, cpu_model, 2, sec)
    got_model, _, got_m, _ = _train_steps(cfg, cuda, 4, cpu_model, 2, sec)
    for g, w in zip(got_m, want_m):
        for k in ("loss", "grad_norm", "nll"):
            assert g[k] == pytest.approx(w[k], rel=1e-4), k
    for (k, g), (_, w) in zip(got_model.named_parameters(), want_model.named_parameters()):
        prev, live = 0.0, True
        for mu in want_opt["mu_by_step"]:  # mu_t - 0.9 mu_{t-1}: step t's gradient / 10
            step_g = (mu[k] - 0.9 * prev).abs()
            live = live & (step_g >= 1e-2 * step_g.max())
            prev = mu[k]
        torch.testing.assert_close(g.detach().cpu()[live], w.detach()[live], rtol=0,
                                   atol=1e-2 * 1e-3, msg=k)


@pytest.mark.gpu
def test_train_secure_step_equals_plain_bit_for_bit_on_card(cuda):
    """On the card, reduced granite-moe on 4 shards, three steps: secure MoE
    and plain MoE give the same metrics, parameters and moments bit for bit
    (the backward adds in a fixed order: no float atomics), and so does a
    second secure run; a step launches the ChaCha kernel 1 + 8 times a
    layer (the ingest decrypt; per layer 2 forward legs and 2 cotangent legs,
    2 crypts each), the plain one once (the decrypt)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_params

    cfg = get_config("granite-moe-3b-a800m").reduced()
    cpu_model = init_params(cfg, torch.Generator().manual_seed(2), 4, "cpu", torch.float32)
    runs = {name: _train_steps(cfg, cuda, 4, cpu_model, 3, sec)
            for name, sec in (("secure", _cfg()), ("plain", None), ("again", _cfg()))}
    sm, so, smet, slaunch = runs["secure"]
    assert slaunch == [1 + 8 * cfg.n_layers] * 3
    assert runs["plain"][3] == [1] * 3
    for name in ("plain", "again"):
        m, o, met, _ = runs[name]
        assert met == smet, name
        for (k, a), (_, b) in zip(sm.named_parameters(), m.named_parameters()):
            assert torch.equal(a, b), (name, k)
        for part in ("mu", "nu"):
            for k in so[part]:
                assert torch.equal(so[part][k], o[part][k]), (name, part, k)
    for i in range(cfg.n_layers):
        assert float(so["mu"][f"layers.{i}.moe.wi"].abs().sum()) > 0


@pytest.mark.gpu
def test_embedding_backward_is_fixed_order_on_card(cuda):
    """The embedding lookup's backward on the card equals the CPU's bit for
    bit (both add each row's cotangents in token order, in float32), with
    repeated tokens and untouched rows."""
    from repro_torch.models.layers import _EmbedLookup

    g = torch.Generator().manual_seed(0)
    table = torch.randn(300, 40, generator=g)
    tokens = torch.randint(0, 50, (4, 64), generator=g)
    ct = torch.randn(4, 64, 40, generator=g).to(torch.bfloat16)
    grads = []
    for dev in ("cpu", cuda):
        t = table.to(dev).requires_grad_()
        out = _EmbedLookup.apply(t, tokens.to(dev), torch.bfloat16)
        (gt,) = torch.autograd.grad(out, t, ct.to(dev))
        grads.append(gt.cpu())
    assert torch.equal(grads[0], grads[1])
    assert not grads[0][50:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("t", [16, 1024])
def test_blocked_wkv_card_equals_cpu(cuda, t):
    """The blocked WKV (float32) on the card against the CPU on the same
    inputs, output and end state within rtol/atol 1e-4 (float32 products
    summed in other orders), and against the card's own per-token scan
    within 2e-4 (tests/test_rwkv_wkv.py's tolerance)."""
    from repro_torch.models.rwkv import _wkv_blocked, _wkv_scan

    g = torch.Generator().manual_seed(t)
    r, k, v = (torch.randn(2, t, 2, 64, generator=g) for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand(2, t, 2, 64, generator=g) * 13.2 - 12.0))
    u, s0 = torch.randn(2, 64, generator=g), torch.randn(2, 2, 64, 64, generator=g)
    args = (r, k, v, w, u, s0)
    want = _wkv_blocked(*args)
    got = _wkv_blocked(*(a.to(cuda) for a in args))
    scan = _wkv_scan(*(a.to(cuda) for a in args), chunk=256)
    for a, b, c in zip(got, want, scan):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(a, c, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("t,chunk", [(64, 64), (1024, 256)])
def test_chunked_ssd_card_equals_cpu(cuda, t, chunk):
    """The chunked SSD (float32) on the card against the CPU on the same
    inputs within rtol 1e-4 and 1e-5 of the output's largest magnitude;
    its gradient for dt finite on the card at chunk 256 (the decay is
    masked before its exp)."""
    from repro_torch.models.ssm import ssd_chunked

    g = torch.Generator().manual_seed(t)
    xh = torch.randn(1, t, 2, 8, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(1, t, 2, generator=g))
    a_log = torch.zeros(2)
    bm, cm = (torch.randn(1, t, 4, generator=g) for _ in range(2))
    h0 = torch.randn(1, 2, 4, 8, generator=g)
    args = (xh, dt, a_log, bm, cm, h0)
    want = ssd_chunked(*args, chunk)
    card = [a.to(cuda) for a in args]
    card[1].requires_grad_()
    got = ssd_chunked(*card, chunk)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.detach().cpu(), b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))
    (gdt,) = torch.autograd.grad(torch.sum(got[0] ** 2), card[1])
    assert bool(torch.isfinite(gdt).all())


@pytest.mark.gpu
def test_frames_decrypt_on_card_equals_cpu_arx(cuda):
    """An audio batch's secure ingest on the card: tokens at ctr and frames
    at ctr + 2**16 (a device counter), two ChaCha launches, equal bit for
    bit to the CPU's plain ARX and to the plaintext."""
    from repro_torch.crypto.ctr import encrypt_array
    from repro_torch.kernels.chacha20 import kernel
    from repro_torch.train.step import SecureIngest, decrypt_batch

    rng = np.random.default_rng(0)
    key = rng.integers(0, 2**32, 8, dtype=np.uint32)
    nonce = rng.integers(0, 2**32, 3, dtype=np.uint32)
    toks = torch.from_numpy(rng.integers(0, 51865, (2, 448)).astype(np.int32))
    frames = torch.from_numpy(rng.normal(size=(2, 1500, 512)).astype(np.float32))
    ctr = 450_000
    ct = {"tokens": encrypt_array(toks, key, nonce, ctr),
          "frames": encrypt_array(frames, key, nonce, ctr + (1 << 16))}
    ingest = SecureIngest(key_words=key, nonce_words=nonce)
    want = decrypt_batch(dict(ct, ctr=ctr), ingest)
    before = kernel.launches
    got = decrypt_batch({"tokens": ct["tokens"].to(cuda), "frames": ct["frames"].to(cuda),
                         "ctr": torch.tensor(ctr, dtype=torch.int64, device=cuda)}, ingest)
    assert kernel.launches == before + 2
    for name, plain in (("tokens", toks), ("frames", frames)):
        assert torch.equal(got[name].cpu(), want[name]), name
        assert torch.equal(want[name], plain), name


# --- the eleventh slice: the cost model's item term, the paper's script, the
# dense and shared-expert models at full width ---------------------------------


@pytest.mark.gpu
def test_probe_workload_items_on_card(cuda):
    """The per-workload item probe through the card's graph runner: secure
    k-means' own plaintext round at three small sizes, a finite line >= 0,
    two rounds a call, and a trace priced by it."""
    from repro_torch import VirtualMesh
    from repro_torch.core.driver import make_iterative_runner
    from repro_torch.core.kmeans import make_kmeans_iterative_spec
    from repro_torch.perf import calibrate
    from repro_torch.perf.model import CostModel, trace_workload

    mesh = VirtualMesh(8, cuda)
    pts = torch.from_numpy(generate_points(8 * 8192, 16, d=8, seed=3)[0]).to(cuda)
    spec = make_kmeans_iterative_spec(16, mesh, threshold=0.0)

    def inputs(n):
        return {"p": pts[:8 * n], "w": torch.ones(8 * n, device=cuda)}, pts[:16].contiguous()

    got = calibrate.probe_workload_items(
        lambda n: make_iterative_runner(spec, mesh, None, n_rounds=2), inputs,
        [256, 512, 1024], target_items=8192, reps=3)
    assert got["rounds_per_call"] == [2, 2, 2]
    assert all(np.isfinite(got[k]) and got[k] >= 0 for k in ("us_per_item", "base_us"))
    cal = calibrate.run_calibration(mesh, quick=True)
    runner = make_iterative_runner(spec, mesh, _cfg(), n_rounds=2)
    tr = trace_workload(runner, *inputs(8192), n_shards=8, n_local_items=8192, items=got)
    assert tr.item_us == got["us_per_item"]
    model = CostModel(cal)
    assert model.predict_round_us(tr) - model.predict_round_us(tr.with_item_us(None)) == \
        pytest.approx(8192 * (got["us_per_item"] - cal.round["us_per_item"]), rel=1e-9, abs=1e-6)


@pytest.mark.gpu
def test_paper_script_on_card_equals_cpu(cuda):
    """`python -m repro_torch.kmeans_secure` on the card: the fit's n_iter
    and rounds equal the CPU's and its centres within 1e-4 (float sums in
    another order); both kernels launched."""
    from repro_torch import kmeans_secure
    from repro_torch.kernels.chacha20 import kernel as ck
    from repro_torch.kernels.kmeans import kernel as kk

    before = (ck.launches, kk.launches)
    card = kmeans_secure.main(device="cuda")
    assert ck.launches > before[0] and kk.launches > before[1]
    pts, true_centers = generate_points(kmeans_secure.N_POINTS, kmeans_secure.K,
                                        d=kmeans_secure.D, seed=kmeans_secure.SEED,
                                        spread=kmeans_secure.SPREAD)
    cpu = kmeans_secure.convergence(pts, true_centers, torch.device("cpu"))
    for k in ("n_iter", "n_rounds_dispatched", "n_dispatches"):
        assert card["convergence"][k] == cpu[k], k
    np.testing.assert_allclose(card["convergence"]["centers"], cpu["centers"], atol=1e-4,
                               rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,shards,secure", [("glm4-9b", 1, False),
                                                ("qwen2-moe-a2.7b", 8, True)])
def test_published_width_depth_2_card_equals_cpu(cuda, arch, shards, secure):
    """glm4-9b (GQA with 2 KV heads) and qwen2-moe-a2.7b (60 experts padded to
    64 over 8 shards, shared experts, a secure exchange) at their published
    widths, 2 layers, float32: a prefill of 16 tokens and two decode steps,
    the card within rtol/atol 1e-3 (chip_smoke's LM_SMALL_TOL) of the CPU's
    plain versions."""
    from dataclasses import replace

    from repro_torch import VirtualMesh
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM, init_params

    cfg = replace(get_config(arch), n_layers=2, dtype="float32")
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0), shards, "cpu")
    card_model = LM(cfg, shards, cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 18)).astype(np.int32))
    sec = _cfg() if secure else None
    want, _ = _lm_serve(cfg, cpu_model, toks, VirtualMesh(shards, "cpu"), sec)
    del cpu_model
    got, _ = _lm_serve(cfg, card_model, toks.to(cuda), VirtualMesh(shards, cuda), sec)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g.float().cpu(), w_.float(), rtol=1e-3, atol=1e-3)


# --- the prefill's fused causal attention kernel --------------------------------
# Tolerance, bf16: against a float32 softmax of the same bf16 q, k, v, the
# kernel's relative (Frobenius) error may not pass ATTN_REL_TOL, two bf16
# roundings (its weights P before the P V product, the context it writes:
# 2**-9 each), nor the plain path's own error on the same inputs (the kernel
# replaces it and must be at least as precise: it keeps the scores in float32
# where the plain path rounds them to bf16 first).
ATTN_REL_TOL = 2 * 2**-9
# float32: against a float64 softmax, ATTN_F32_REL_TOL = 2**-16. The kernel's
# products and sums are float32, ~1e-7 apart from float64; a kernel that
# rounded an input or a weight to 16 bits (2**-9 for bf16, 2**-11 for fp16)
# would read 100 times more.
ATTN_F32_REL_TOL = 2**-16


def _attn_inputs(b, t, h, hkv, dh, device, seed=0, dtype=torch.bfloat16):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((b, t, n, dh), generator=g, device=device).to(dtype)
            for n in (h, hkv, hkv)]


def _attn_exact(q, k, v, dtype=torch.float32):
    """Causal softmax(q k^T / sqrt(Dqk)) v in `dtype`, a batch row at a time:
    (B, T, H, Dv)."""
    h, dh = q.shape[2], q.shape[3]
    g = h // k.shape[2]
    kk = k.to(dtype).repeat_interleave(g, dim=2)
    vv = v.to(dtype).repeat_interleave(g, dim=2)
    out = torch.empty(q.shape[:3] + v.shape[3:], dtype=dtype, device=q.device)
    for i in range(q.shape[0]):
        s = torch.einsum("thd,shd->hts", q[i].to(dtype), kk[i]) / dh ** 0.5
        keep = torch.ones(s.shape[1:], dtype=torch.bool, device=q.device).tril()
        out[i] = torch.einsum("hts,shd->thd", s.masked_fill(~keep, float("-inf")).softmax(-1),
                              vv[i])
    return out


def _rel(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def _plain_attend(q, k, v):
    """The plain path a prefill took before the kernel: `attend` with the
    serving config's query chunks, at these heads."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models.attention import attend

    cfg = replace(get_config("granite-moe-3b-a800m"), n_heads=q.shape[2],
                  n_kv_heads=k.shape[2], d_head=q.shape[3])
    pos = torch.arange(q.shape[1], device=q.device)[None].expand(q.shape[0], -1)
    return attend(cfg, q, k, v, pos, pos, None, True)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h,hkv,dh", [
    (2, 4096, 24, 8, 64),    # granite-moe's prefill shape, two prompts
    (2, 1, 16, 16, 128), (2, 77, 16, 16, 128), (2, 2085, 16, 16, 128),  # Dh 128, G 1
    (2, 1, 48, 1, 128), (2, 77, 48, 1, 128), (2, 2085, 48, 1, 128),     # Dh 128, G 48 (MQA)
    (3, 77, 6, 2, 16), (1, 2085, 4, 4, 80),
])
def test_attention_prefill_kernel_matches_plain(cuda, b, t, h, hkv, dh):
    from repro_torch.kernels.attention import kernel

    q, k, v = _attn_inputs(b, t, h, hkv, dh, cuda, seed=t + dh)
    before = kernel.launches
    got = kernel.attention_prefill_cuda(q, k, v)
    again = kernel.attention_prefill_cuda(q, k, v)
    assert kernel.launches == before + 2
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, again)  # no atomics: the same bits
    want = _attn_exact(q, k, v)
    err, plain_err = _rel(got, want), _rel(_plain_attend(q, k, v), want)
    assert err <= ATTN_REL_TOL and err <= plain_err + 1e-6, (err, plain_err)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h,hkv,dh", [
    (1, 64, 32, 32, 64),      # zamba2's shared attention, the card-against-CPU prompt
    (2, 77, 16, 16, 128), (2, 2085, 48, 1, 128),  # Dh 128, G 1 and G 48
    (3, 33, 6, 2, 16), (1, 1, 4, 4, 80), (1, 1000, 12, 4, 64),
])
def test_attention_prefill_kernel_float32_matches_float64(cuda, b, t, h, hkv, dh):
    """A float32 model on the card: the kernel's float32 specialisation,
    products on the CUDA cores, against float64."""
    from repro_torch.kernels.attention import kernel

    q, k, v = _attn_inputs(b, t, h, hkv, dh, cuda, seed=t + dh, dtype=torch.float32)
    before = kernel.launches
    got = kernel.attention_prefill_cuda(q, k, v)
    assert kernel.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.float32
    assert torch.equal(got, kernel.attention_prefill_cuda(q, k, v))
    assert _rel(got, _attn_exact(q, k, v, torch.float64)) <= ATTN_F32_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_prefill_kernel_reads_strided_inputs(cuda, dtype):
    """q, k, v as views of one fused (B, T, H + 2 Hkv, Dh) projection: no
    copy in, the same bits as from contiguous copies."""
    from repro_torch.kernels.attention import kernel

    b, t, h, hkv, dh = 2, 300, 8, 2, 64
    qkv = torch.randn((b, t, h + 2 * hkv, dh), device=cuda).to(dtype)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + hkv], qkv[:, :, h + hkv:]
    assert not q.is_contiguous()
    got = kernel.attention_prefill_cuda(q, k, v)
    tol = ATTN_REL_TOL if dtype == torch.bfloat16 else ATTN_F32_REL_TOL
    assert _rel(got, _attn_exact(q, k, v, torch.float64)) <= tol
    assert torch.equal(got, kernel.attention_prefill_cuda(q.contiguous(), k.contiguous(),
                                                         v.contiguous()))


@pytest.mark.gpu
def test_attention_prefill_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.attention import kernel

    q, k, v = _attn_inputs(1, 64, 4, 2, 64, cuda)
    before = kernel.launches
    cases = [
        ((q[..., :48].contiguous(), k, v), r"\(B, T, Hkv, Dh\)"),  # Dh differs, q to k
        ((q, k[:, :32], v[:, :32]), r"\(B, T, Hkv, Dh\)"),        # fewer keys than queries
        ((q.half(), k.half(), v.half()), "one of"),           # float16
        ((q, k.float(), v.float()), "one of"),                 # dtypes differ
        ((q.cpu(), k.cpu(), v.cpu()), "CUDA tensor"),         # device
        ((q[..., ::2], k[..., ::2], v[..., ::2]), "contiguous"),  # Dh not contiguous
    ]
    for args, msg in cases:
        with pytest.raises(ValueError, match=msg):
            kernel.attention_prefill_cuda(*args)
    for dh in (8, 72, 144):  # head sizes outside 16..128 in steps of 16
        qd, kd, vd = _attn_inputs(1, 16, 2, 2, dh, cuda)
        with pytest.raises(ValueError, match="Dh in"):
            kernel.attention_prefill_cuda(qd, kd, vd)
    q3, k3, v3 = _attn_inputs(1, 16, 3, 2, 64, cuda)
    with pytest.raises(ValueError, match="multiple"):
        kernel.attention_prefill_cuda(q3, k3, v3)
    assert kernel.launches == before


# One warm call under the profiler in a process of its own: in a long test
# process the profiler has been seen to report no device events at all once
# earlier tests profiled, and to lose the first kernel after a synchronise
# (hence the two spin kernels, filtered out).
_ATTN_PROFILED = """
import json, sys, torch
from repro_torch.kernels.attention import kernel
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn((2, 1000, n, 64), generator=g, device="cuda").to(getattr(torch, sys.argv[1]))
           for n in (12, 4, 4))
kernel.attention_prefill_cuda(q, k, v)
torch.cuda.synchronize()
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    torch.cuda._sleep(1000)
    torch.cuda._sleep(1000)
    kernel.attention_prefill_cuda(q, k, v)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]))
"""


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "attention_prefill_kernel"),
                                        (torch.float32, "attention_prefill_f32_kernel")])
def test_attention_prefill_kernel_is_one_launch_and_never_syncs(cuda, dtype, name):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.kernels.attention import kernel

    q, k, v = _attn_inputs(2, 1000, 12, 4, 64, cuda, dtype=dtype)
    kernel.attention_prefill_cuda(q, k, v)  # the build and the first launch
    torch.cuda.synchronize()
    before = kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernel.attention_prefill_cuda(q, k, v)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernel.launches == before + 1
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p)}
    out = subprocess.run([sys.executable, "-c", _ATTN_PROFILED, str(dtype).split(".")[-1]],
                         env=env, capture_output=True, text=True, timeout=600, check=True)
    names = [n for n in json.loads(out.stdout.splitlines()[-1]) if "spin_kernel" not in n]
    assert len(names) == 1 and name in names[0], names


@pytest.mark.gpu
def test_engine_prefill_with_the_kernel_matches_the_plain_path(cuda, monkeypatch):
    """granite-moe at its published widths, 4 layers, bf16, experts on 8
    virtual shards, the exchange encrypted: a prefill of 2 x 2,085 tokens
    through the kernel against the same prefill through the plain path on
    the card, within the secure_prefill cell's limits (logits 0.10, the
    worst layer's K or V 0.19); one kernel launch and one `kernel_calls`
    note a layer, none in a decode step."""
    from dataclasses import replace

    from repro_torch import VirtualMesh
    from repro_torch.configs import get_config
    from repro_torch.kernels import kernel_calls
    from repro_torch.kernels.attention import kernel
    from repro_torch.models import attention
    from repro_torch.models.lm import init_params
    from repro_torch.serve.engine import decode_step, init_cache, prefill

    cfg = replace(get_config("granite-moe-3b-a800m"), n_layers=4)
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), 8, cuda)
    mesh = VirtualMesh(8, cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 2086), device=cuda, dtype=torch.int32,
                         generator=torch.Generator(device=cuda).manual_seed(1))

    def run():
        cache = init_cache(cfg, 2, 2086, cuda)
        return prefill(cfg, model, toks[:, :2085], cache, mesh=mesh, secure_moe=_cfg()), cache

    before = kernel.launches
    with kernel_calls.recording() as calls:
        got, cache = run()
    assert kernel.launches - before == calls["attention_prefill"] == cfg.n_layers
    with kernel_calls.recording() as dec:
        decode_step(cfg, model, cache, toks[:, 2085:], mesh=mesh)
    assert dec.get("attention_prefill", 0) == 0 and kernel.launches - before == cfg.n_layers
    monkeypatch.setattr(attention, "uses_kernel", lambda impl, q: False)
    want, want_cache = run()
    assert kernel.launches - before == cfg.n_layers
    assert _rel(got, want) <= 0.10
    for name in ("k", "v"):
        for layer in range(cfg.n_layers):
            assert _rel(cache[name][layer, :, :2085], want_cache[name][layer, :, :2085]) <= 0.19


# --- the kernel's latent-attention build: q and k of 192 beside v of 128 ----------
# Moonlight-16B-A3B's heads (`models/attention.py`'s MLA): scores over 192
# columns (128 + the 64-wide rotary part), scaled by 1 / sqrt(192), a
# context of 128. The same tolerances as the grouped-query builds.


def _latent_inputs(b, t, h, device, seed=0, dtype=torch.bfloat16, dqk=192, dv=128):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((b, t, h, d), generator=g, device=device).to(dtype)
            for d in (dqk, dqk, dv)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h", [
    (4, 8192, 16),   # moonlight's prefill layer: 4 prompts of 8,192, 16 heads
    (1, 77, 16), (2, 2085, 16), (3, 1, 4),  # odd T, one query
])
def test_attention_prefill_latent_build_matches_plain(cuda, b, t, h):
    from repro_torch.kernels.attention import kernel

    q, k, v = _latent_inputs(b, t, h, cuda, seed=t)
    before = kernel.launches
    got = kernel.attention_prefill_cuda(q, k, v)
    assert kernel.launches == before + 1
    assert got.shape == (b, t, h, 128) and got.dtype == torch.bfloat16
    assert torch.equal(got, kernel.attention_prefill_cuda(q, k, v))
    want = _attn_exact(q, k, v)
    err, plain_err = _rel(got, want), _rel(_plain_attend(q, k, v), want)
    assert err <= ATTN_REL_TOL and err <= plain_err + 1e-6, (err, plain_err)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h", [(1, 1000, 16), (2, 77, 4), (1, 1, 16)])
def test_attention_prefill_latent_build_float32_matches_float64(cuda, b, t, h):
    from repro_torch.kernels.attention import kernel

    q, k, v = _latent_inputs(b, t, h, cuda, seed=t + 1, dtype=torch.float32)
    got = kernel.attention_prefill_cuda(q, k, v)
    assert got.shape == (b, t, h, 128) and got.dtype == torch.float32
    assert torch.equal(got, kernel.attention_prefill_cuda(q, k, v))
    assert _rel(got, _attn_exact(q, k, v, torch.float64)) <= ATTN_F32_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_prefill_latent_build_reads_v_in_place(cuda, dtype):
    """v as latent attention leaves it: the value columns of W_kvb's
    (B, T, H, 128 + 128) product, a strided view read with no copy; the
    same bits as from a contiguous copy."""
    from repro_torch.kernels.attention import kernel

    b, t, h = 2, 300, 16
    q, k, _ = _latent_inputs(b, t, h, cuda, dtype=dtype)
    kv = torch.randn((b, t, h, 256), device=cuda).to(dtype)
    v = kv[..., 128:]
    assert not v.is_contiguous()
    got = kernel.attention_prefill_cuda(q, k, v)
    assert torch.equal(got, kernel.attention_prefill_cuda(q, k, v.contiguous()))
    tol = ATTN_REL_TOL if dtype == torch.bfloat16 else ATTN_F32_REL_TOL
    assert _rel(got, _attn_exact(q, k, v, torch.float64)) <= tol


@pytest.mark.gpu
def test_attention_prefill_wrapper_refuses_widths_it_has_no_build_for(cuda):
    """Dv != Dqk only as latent attention's (192, 128); q and k of one
    width; nothing launched."""
    from repro_torch.kernels.attention import kernel

    before = kernel.launches
    for dqk, dv in ((192, 64), (128, 64), (64, 128), (192, 192), (176, 128)):
        q, k, v = _latent_inputs(1, 16, 2, cuda, dqk=dqk, dv=dv)
        with pytest.raises(ValueError, match="Dh in"):
            kernel.attention_prefill_cuda(q, k, v)
    q, k, v = _latent_inputs(1, 16, 2, cuda)
    with pytest.raises(ValueError, match=r"\(B, T, Hkv, Dh\)"):
        kernel.attention_prefill_cuda(q, k[..., :128].contiguous(), v)
    with pytest.raises(ValueError, match=r"\(B, T, Hkv, Dh\)"):
        kernel.attention_prefill_cuda(q, k, v[:, :8])
    assert kernel.launches == before


@pytest.mark.gpu
def test_moonlight_float32_at_published_widths_matches_the_reference(cuda):
    """Moonlight's published widths in float32, 4 layers (the dense one and
    3 MoE), a prefill of 1 x 1,024 tokens through the fused kernel's float32
    192/128 build, the exchange encrypted, then 3 decode steps through the
    latent cache (the absorbed form): the port's logits for the prompt's
    last token and every step, and every layer's latent cache, the prompt's
    and the decoded tokens' entries, against the float32 reference within
    1e-4. Both compute in float32 (TF32 off), apart only in the order of
    their sums (3e-6 seen); a bf16 rounding anywhere would read ~3e-3 at
    layer 0."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from bench import common
    from bench.drivers import lm as lm_drv
    from repro_torch import VirtualMesh
    from repro_torch.serve.engine import decode_step, init_cache, prefill

    cs = common.cell_spec("moonlight-16b-a3b.secure_prefill")
    cs["config"]["model"].update(n_layers=4, dtype="float32")
    cs["traffic"].update(batch=1, prompt_tokens=1024)
    cell = lm_drv.LMBase(cs, seed=2**31 + 5, device="cuda", rec=None)
    cell.build(VirtualMesh(8, cuda))
    t = 1024
    toks = lm_drv.prompts(cell.m, cell.seed, "f32", 1, t + 3, cuda)
    cache = init_cache(cell.cfg, 1, t + 3, cuda)
    got = [prefill(cell.cfg, cell.model, toks[:, :t], cache, mesh=cell.mesh,
                   secure_moe=cell.secure)]
    for j in range(3):
        got.append(decode_step(cell.cfg, cell.model, cache, toks[:, t + j:t + j + 1],
                               mesh=cell.mesh))
    cell.free_model()
    kept = {}
    want = cell.ref.forward(cell.weights(), cell.m, toks,
                            logit_positions=list(range(t - 1, t + 3)), shards=cell.shards,
                            prompt_len=t, cache_sink=kept.__setitem__,
                            cache_layers=cell.m["n_layers"])
    v = cell.m["vocab_size"]
    for j in range(4):
        assert lm_drv.rel_err(got[j][:, :v], want[:, j]) <= 1e-4, j
    assert sorted(kept) == [0, 1, 2, 3]
    for layer, tensors in kept.items():
        for name, w in tensors.items():
            assert lm_drv.rel_err(cache[name][layer], w) <= 1e-4, (layer, name)
            assert lm_drv.rel_err(cache[name][layer][:, t:], w[:, t:]) <= 1e-4, (layer, name)


@pytest.mark.gpu
def test_moonlight_prefill_then_decode_at_published_widths_matches_the_reference(cuda):
    """Moonlight-16B-A3B whole (27 layers, its published widths, bf16) on
    the virtual mesh of 8 shards, the exchange encrypted, its weights the
    benchmark's: a prefill of 1 x 1,024 tokens through the fused kernel's
    192/128 build and 3 decode steps through the latent cache, against the
    float32 reference's forward over the whole sequence. As the
    secure_prefill cell checks (`bench/limits/`): the latent cache of the
    layers the reference shows (`checked_layers`) within the cell's
    `cache_rel_err`, and the decoded tokens' entries of the layers before
    the first routed one alone as well. Past those layers bf16 parts from
    float32 on near-tied expert choices, so the logits' values are held in
    float32, at 4 layers, by the test above; here the prefill's last token
    and every step within 0.95, a guard against gross faults alone (sound
    bf16 reads 0.47-0.83 at the cell's size, the fp8 control 1.01-1.08,
    another model's logits ~1.41)."""
    import json
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from bench import common
    from bench.drivers import lm as lm_drv
    from repro_torch import VirtualMesh
    from repro_torch.kernels import kernel_calls
    from repro_torch.serve.engine import decode_step, init_cache, prefill

    cell_name = "moonlight-16b-a3b.secure_prefill"
    limit = json.loads((common.BENCH / "limits" / f"{cell_name}.json").read_text()
                       )["numbers"]["cache_rel_err"]["limit"]
    cs = common.cell_spec(cell_name)
    cs["traffic"].update(batch=1, prompt_tokens=1024)
    cell = lm_drv.LMBase(cs, seed=2**31 + 9, device="cuda", rec=None)
    cell.build(VirtualMesh(8, cuda))
    t = 1024
    toks = lm_drv.prompts(cell.m, cell.seed, "card", 1, t + 3, cuda)
    cache = init_cache(cell.cfg, 1, t + 3, cuda)
    with kernel_calls.recording() as calls:
        got = [prefill(cell.cfg, cell.model, toks[:, :t], cache, mesh=cell.mesh,
                       secure_moe=cell.secure)]
    assert calls["attention_prefill"] == 27 and calls["moe_dispatch"] == 26
    for j in range(3):
        got.append(decode_step(cell.cfg, cell.model, cache, toks[:, t + j:t + j + 1],
                               mesh=cell.mesh))
    cell.free_model()
    weights = cell.weights()  # drawn again from the seed, the model's freed
    kept = {}
    want = cell.reference(toks, list(range(t - 1, t + 3)), weights=weights,
                          cache_sink=kept.__setitem__)
    v = cell.m["vocab_size"]
    for j in range(4):
        assert lm_drv.rel_err(got[j][:, :v].float(), want[:, j]) <= 0.95, j
    dense = cell.m["first_dense_layers"]
    assert sorted(kept) == list(range(dense + 2))
    for layer, tensors in kept.items():
        for name, w in tensors.items():
            assert lm_drv.rel_err(cache[name][layer], w) <= limit, (layer, name)
            if layer <= dense:
                assert lm_drv.rel_err(cache[name][layer][:, t:], w[:, t:]) <= limit, \
                    (layer, name)
