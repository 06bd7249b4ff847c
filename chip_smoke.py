#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Builds the hand-written kernels from `src/repro_torch/csrc/` (nvcc, sm_90a),
then runs six phases, each printing one JSON line:

  device         the card's name and power limit; ptxas register and
                 shared-memory lines of both kernels
  chacha20       RFC 8439 vectors through the kernel; kernel == plain version
                 bit for bit at the k-means wire (64 rows x 132 blocks) and
                 at a 64 MiB wire with random counters (wrapping at 2**32);
                 CUDA-event times
  kmeans_assign  S=8 x 524,288 points, D=64, K=256: sums/counts against the
                 plain accumulate fed the kernel's assignments, assignments
                 against the plain version outside near-ties, two runs equal
                 bit for bit; kernel, plain and cuBLAS distance-product times
  kmeans_fit     secure k-means, 4,194,304 x 64 points, K=256, 8 virtual
                 shards, to the paper's threshold; kernel launches counted on
                 this run alone; plaintext fit identical bit for bit
  parity_small   the same fit at N=4096, K=8, D=4 on the card and on the CPU
                 (plain versions), and one fixed wire encrypted on both
  kernels        per kernel: launches on the main path, time, bound, plain
                 and library times

Then the nvidia-smi line and, last, {"ok": true, "device": {...}}. Any failed
check raises, and the script exits non-zero. It needs a CUDA card and the
repository's `src/` beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

N_POINTS, K, D, SHARDS = 4_194_304, 256, 64, 8
MAX_ITER, ROUNDS_PER_DISPATCH = 200, 8
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_S = 67e12  # H100 SXM FP32 outside the tensor cores
# 32-bit integer ops: per SM and clock, 64 on the INT32 pipe (add, logic,
# shifts) plus 64 integer multiply-adds on the FMA pipe; x 132 SMs x 1.98 GHz
# boost (the same count gives the FP32 67 TFLOP/s: 128 lanes, FMA = 2 ops).
# With 64 per clock alone the 64 MiB wire ran faster than that bound.
PEAK_I32_S = 128 * 132 * 1.98e9
CHACHA_OPS_PER_BLOCK = 80 * 12 + 16 + 16 + 2  # QRs, feed-forward, XOR, counter
KEY = bytes(range(32))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean milliseconds per call over `reps` calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def u32(a, dev):
    return torch.as_tensor(np.asarray(a, np.uint64).astype(np.uint32).view(np.int32), device=dev)


def phase_device(build):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    build.build("chacha20", "kmeans")
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(time.time() - t0, 3),
          "ptxas": {n: [ln for ln in build.ptxas_info(n)
                        if "registers" in ln or "smem" in ln or "spill" in ln]
                    for n in ("chacha20", "kmeans")}})
    return smi


def phase_chacha(dev):
    from repro_torch.crypto import chacha
    from repro_torch.kernels.chacha20 import kernel as ck, ops, ref as cr

    # RFC 8439 §2.3.2 block and §2.4.2 encryption, through the kernel
    rfc_block = np.array([0xE4E7F110, 0x15593BD1, 0x1FDD0F50, 0xC47120A3, 0xC7F4D1C7,
                          0x0368C033, 0x9AAA2204, 0x4E6CD4C3, 0x466482D2, 0x09AA9F07,
                          0x05D7C214, 0xA2028BD9, 0xD19C12B5, 0xB94E16DE, 0xE883D0CB,
                          0x4E3C50A2], np.uint32)
    s0 = ops.make_state0(chacha.key_to_words(KEY),
                         chacha.nonce_to_words(bytes.fromhex("000000090000004a00000000")), 1,
                         device=dev)
    blk = ops.chacha20_xor_words(torch.zeros(16, dtype=torch.int32, device=dev), s0)
    check(np.array_equal(blk.cpu().numpy().view(np.uint32), rfc_block), "RFC 8439 2.3.2")
    pt = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
          b"only one tip for the future, sunscreen would be it.")
    ct = ops.ctr_crypt_array(torch.frombuffer(bytearray(pt), dtype=torch.uint8).to(dev),
                             chacha.key_to_words(KEY),
                             chacha.nonce_to_words(bytes.fromhex("000000000000004a00000000")), 1)
    check(bytes(ct.cpu().numpy()) == chacha.chacha20_encrypt_bytes(
        KEY, bytes.fromhex("000000000000004a00000000"), 1, pt), "RFC 8439 2.4.2")

    rng = np.random.default_rng(1)
    out = {}
    for label, rows, blocks, reps in (("wire", 64, 132, 500), ("64MiB", 64, 16384, 50)):
        x = u32(rng.integers(0, 2**32, (rows, blocks, 16)), dev)
        state0 = u32(rng.integers(0, 2**32, 16), dev)
        nid = u32(rng.integers(0, 2**32, rows), dev)
        crow = u32(rng.integers(0, 2**32, rows), dev)
        base = u32(rng.integers(0, 2**32, blocks), dev)
        mul = u32(rng.integers(0, 2**32, blocks), dev)
        # counters near 2**32 with small strides wrap inside the buffer
        base[: blocks // 2] = u32(2**32 - 1 - np.arange(blocks // 2), dev)
        mul[: blocks // 2] = u32(np.arange(blocks // 2) % 5, dev)
        args = (x, state0, nid, crow, base, mul)
        y = ck.chacha20_xor_rows_cuda(*args)
        y_ref = cr.chacha20_xor_rows_ref(*args)
        torch.cuda.synchronize()
        check(torch.equal(y, y_ref), f"chacha20 kernel != plain at {label}")
        n_blocks = rows * blocks
        out[label] = {
            "rows": rows, "blocks": blocks, "bit_exact": True,
            "ms": cuda_ms(lambda: ck.chacha20_xor_rows_cuda(*args), reps),
            "plain_ms": cuda_ms(lambda: cr.chacha20_xor_rows_ref(*args), 3 if blocks < 1000 else 1, 1),
            "bound_ms": 1e3 * max(n_blocks * 128 / PEAK_BYTES_S,
                                  n_blocks * CHACHA_OPS_PER_BLOCK / PEAK_I32_S),
            "bound_by": "operations" if CHACHA_OPS_PER_BLOCK / PEAK_I32_S > 128 / PEAK_BYTES_S
            else "bytes",
        }
    emit({"phase": "chacha20", "rfc8439": True, **out})
    return out


def phase_kmeans_assign(dev, points, centers):
    from repro_torch.kernels.kmeans import kernel as kk, ref as kr

    s, n, d = points.shape
    k = centers.shape[0]
    weights = torch.ones((s, n), dtype=torch.float32, device=dev)
    a1, s1, c1 = kk.kmeans_assign_cuda(points, centers, weights)
    a2, s2, c2 = kk.kmeans_assign_cuda(points, centers, weights)
    torch.cuda.synchronize()
    check(torch.equal(a1, a2) and torch.equal(s1, s2) and torch.equal(c1, c2),
          "kmeans kernel not deterministic")
    ps, pc = kr.kmeans_accumulate_ref(points, a1, weights, k)
    check(torch.allclose(s1, ps, rtol=1e-5, atol=1e-5), "kmeans sums vs plain accumulate")
    check(torch.allclose(c1, pc, rtol=1e-6, atol=0.0), "kmeans counts vs plain accumulate")
    max_err = float((s1 - ps).abs().max())

    # plain assignments, with near-ties: the two smallest plain d2 closer than
    # 1e-5 of the operands' magnitude |x|^2 + |c|^2 (the rounding scale of
    # the expanded distance)
    c2n = torch.sum(centers * centers, dim=1)
    mism = ties = total_mism = 0
    for sh in range(s):
        for i in range(0, n, 1 << 17):
            x = points[sh, i:i + (1 << 17)]
            x2 = torch.sum(x * x, dim=1, keepdim=True)
            d2 = x2 + c2n[None, :] - 2.0 * (x @ centers.T)
            top = torch.topk(d2, 2, dim=1, largest=False)
            best = torch.argmin(d2, dim=1).to(torch.int32)
            scale = x2[:, 0] + c2n[best.long()]
            tie = (top.values[:, 1] - top.values[:, 0]) <= 1e-5 * scale
            diff = best != a1[sh, i:i + (1 << 17)]
            ties += int(tie.sum())
            total_mism += int(diff.sum())
            mism += int((diff & ~tie).sum())
    check(mism == 0, f"{mism} assignments differ from the plain version outside near-ties")

    flat = points.reshape(-1, d)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        library_ms = cuda_ms(lambda: torch.matmul(flat, centers.T), 10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    n_all = s * n
    ops_ = 2 * n_all * k * d + 4 * n_all * k + 4 * n_all * d
    bytes_ = n_all * d * 4 + n_all * 4 + n_all * 4 + k * d * 4 + s * k * (d + 1) * 4
    res = {"phase": "kmeans_assign", "shards": s, "points_per_shard": n, "d": d, "k": k,
           "near_ties": ties, "mismatches": total_mism, "mismatches_outside_ties": mism, "deterministic": True,
           "max_abs_err": max_err,
           "ms": cuda_ms(lambda: kk.kmeans_assign_cuda(points, centers, weights), 10),
           "plain_ms": cuda_ms(lambda: kr.kmeans_assign_ref(points, centers, weights), 2, 1),
           "library_ms": library_ms, "library_call": "torch.matmul(points, centers.T) FP32, "
           "allow_tf32=False: the distance product alone",
           "bound_ms": 1e3 * max(ops_ / PEAK_F32_S, bytes_ / PEAK_BYTES_S),
           "bound_by": "operations" if ops_ / PEAK_F32_S > bytes_ / PEAK_BYTES_S else "bytes"}
    emit(res)
    return res


def _secure_cfg():
    from repro_torch.convert import secure_config
    from repro_torch.crypto import chacha
    return secure_config(chacha.key_to_words(KEY), chacha.nonce_to_words(b"\x09" * 12),
                         counter0=7)


def _profiled(fn):
    """Run fn under torch.profiler; (result, device busy ms, top ops by device ms).

    Busy time is the sum of kernel and copy durations on the card; None when
    the profiler saw no device activity (then the idle share is not measured).
    """
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return out, None, []
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return out, busy_us / 1e3, [[name[:80], us / 1e3] for name, us in top]


def phase_kmeans_fit(dev, points):
    from repro_torch import VirtualMesh
    from repro_torch.core.kmeans import kmeans_fit
    from repro_torch.core.shuffle import record_wire_bytes
    from repro_torch.kernels.chacha20 import kernel as ck
    from repro_torch.kernels.kmeans import kernel as kk

    mesh = VirtualMesh(SHARDS, dev)
    torch.cuda.synchronize()
    ck.launches = 0
    kk.launches = 0
    t0 = time.perf_counter()
    with record_wire_bytes() as recs:
        sec = kmeans_fit(points, K, mesh, secure=_secure_cfg(), init="first",
                         max_iter=MAX_ITER, rounds_per_dispatch=ROUNDS_PER_DISPATCH)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"chacha20": ck.launches, "kmeans_assign": kk.launches}

    rounds = sec.n_iter
    check(sec.halted, "secure fit did not halt")
    check(launches["kmeans_assign"] == rounds,
          f"kmeans kernel launches {launches['kmeans_assign']} != rounds {rounds}")
    check(launches["chacha20"] == 2 * rounds,
          f"chacha20 kernel launches {launches['chacha20']} != 2 x rounds {rounds}")
    check(len(recs) == rounds and all(r["keystream_launches"] == 2 for r in recs),
          "one secure shuffle with 2 keystream launches per round")
    check(bool(torch.isfinite(sec.centers).all()) and tuple(sec.centers.shape) == (K, D),
          "centres finite, (K, D)")

    def fit(secure):
        t = time.perf_counter()
        out = kmeans_fit(points, K, mesh, secure=secure, init="first", max_iter=MAX_ITER,
                         rounds_per_dispatch=ROUNDS_PER_DISPATCH)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # warm runs in turns: plain, secure, secure, plain
    plain, plain_s1 = fit(None)
    _, sec_s1 = fit(_secure_cfg())
    prof, busy_ms, top = _profiled(lambda: fit(_secure_cfg()))
    sec_s2 = prof[1]
    _, plain_s2 = fit(None)
    check(torch.equal(sec.centers, plain.centers), "secure centres != plaintext centres")
    check(sec.center_shift == plain.center_shift, "secure shifts != plaintext shifts")
    check(torch.equal(prof[0].centers, sec.centers), "secure fit not repeatable")
    warm_sec = min(sec_s1, sec_s2)
    warm_plain = min(plain_s1, plain_s2)
    res = {"phase": "kmeans_fit", "n": N_POINTS, "k": K, "d": D, "shards": SHARDS,
           "n_iter": sec.n_iter, "rounds_executed": rounds,
           "rounds_dispatched": sec.n_rounds_dispatched, "n_dispatches": sec.n_dispatches,
           "halted": sec.halted, "first_fit_s": fit_s,
           "fit_s": warm_sec, "ms_per_round": 1e3 * warm_sec / rounds,
           "plain_fit_s": warm_plain, "plain_ms_per_round": 1e3 * warm_plain / plain.n_iter,
           "fit_s_runs": {"plain": [plain_s1, plain_s2], "secure": [sec_s1, sec_s2]},
           "profiled_fit_s": sec_s2,
           "device_busy_ms": busy_ms,
           "device_idle_share": None if busy_ms is None else 1 - busy_ms / (1e3 * sec_s2),
           "top_device_ops": top,
           "wire_bytes_per_round_per_shard": recs[0]["wire_bytes"],
           "wire_bytes_per_round": recs[0]["wire_bytes"] * SHARDS,
           "keystream_blocks_per_round_per_shard": recs[0]["keystream_blocks"],
           "inertia": sec.inertia, "last_shifts": sec.center_shift[-3:],
           "launches": launches, "secure_equals_plain": True}
    emit(res)
    return res


def phase_parity_small(dev):
    from repro_torch import VirtualMesh
    from repro_torch.core import shuffle
    from repro_torch.core.kmeans import generate_points, kmeans_fit

    pts, _ = generate_points(4096, 8, d=4, seed=3)
    fits = {}
    for name in ("cuda", "cpu"):
        fits[name] = kmeans_fit(pts, 8, VirtualMesh(SHARDS, name), secure=_secure_cfg(),
                                max_iter=MAX_ITER, rounds_per_dispatch=ROUNDS_PER_DISPATCH)
    g, c = fits["cuda"], fits["cpu"]
    check(g.n_iter == c.n_iter and g.n_rounds_dispatched == c.n_rounds_dispatched,
          "card and CPU differ in rounds")
    check(np.allclose(g.centers.cpu().numpy(), c.centers.numpy(), rtol=1e-5, atol=1e-5),
          "card and CPU centres differ")

    rng = np.random.default_rng(4)
    cap = 1
    tree = {"k": rng.integers(-1, 8, (SHARDS, SHARDS, cap)).astype(np.int32),
            "v": {"c": rng.random((SHARDS, SHARDS, cap)).astype(np.float32),
                  "s": rng.normal(size=(SHARDS, SHARDS, cap, 4)).astype(np.float32)}}
    wires = {}
    for name in ("cuda", "cpu"):
        t = {"k": torch.as_tensor(tree["k"], device=name),
             "v": {kk: torch.as_tensor(v, device=name) for kk, v in tree["v"].items()}}
        wire, layout, _ = shuffle._pack_wire_coalesced(t, lead=2)
        w = wire.reshape(SHARDS * SHARDS, -1)
        shard = torch.arange(SHARDS, device=name).repeat_interleave(SHARDS)
        dest = torch.arange(SHARDS, device=name).repeat(SHARDS)
        wires[name] = shuffle._crypt_wire_coalesced(w, layout, _secure_cfg(), shard, dest,
                                                    round_id=0).cpu()
    check(torch.equal(wires["cuda"], wires["cpu"]), "fixed wire ciphertext differs")
    res = {"phase": "parity_small", "n_iter": g.n_iter, "rounds_dispatched": g.n_rounds_dispatched,
           "max_centre_diff": float(np.abs(g.centers.cpu().numpy() - c.centers.numpy()).max()),
           "wire_words": int(wires["cpu"].numel()), "wire_bit_exact": True}
    emit(res)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's sources are missing ({SRC}/repro_torch)", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.core.kmeans import generate_points
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    smi = phase_device(_build)
    cha = phase_chacha(dev)

    pts_np, _ = generate_points(N_POINTS, K, d=D, seed=0)
    points = torch.from_numpy(pts_np).to(dev)
    del pts_np
    km = phase_kmeans_assign(dev, points.reshape(SHARDS, -1, D), points[:K].contiguous())
    fit = phase_kmeans_fit(dev, points)
    phase_parity_small(dev)

    rounds = fit["rounds_executed"]
    emit({"kernels": [
        {"name": "chacha20_xor_rows", "route": "cuda",
         "source": "src/repro_torch/csrc/chacha20.cu",
         "replaces": "src/repro/kernels/chacha20/kernel.py:180",
         "replaces_function": "chacha20_xor_row_lanes",
         "launches": fit["launches"]["chacha20"],
         "launches_per_round": fit["launches"]["chacha20"] / rounds,
         "max_abs_err": 0, "ms": cha["wire"]["ms"], "plain_ms": cha["wire"]["plain_ms"],
         "bound_ms": cha["wire"]["bound_ms"], "bound_by": cha["wire"]["bound_by"],
         "library_ms": None, "shape": "64 rows x 132 blocks",
         "ms_64MiB": cha["64MiB"]["ms"], "bound_ms_64MiB": cha["64MiB"]["bound_ms"],
         "plain_ms_64MiB": cha["64MiB"]["plain_ms"]},
        {"name": "kmeans_assign", "route": "cuda",
         "source": "src/repro_torch/csrc/kmeans.cu",
         "replaces": "src/repro/kernels/kmeans/kernel.py:84",
         "replaces_function": "kmeans_assign_tiles",
         "launches": fit["launches"]["kmeans_assign"],
         "launches_per_round": fit["launches"]["kmeans_assign"] / rounds,
         "max_abs_err": km["max_abs_err"], "ms": km["ms"], "plain_ms": km["plain_ms"],
         "bound_ms": km["bound_ms"], "bound_by": km["bound_by"],
         "library_ms": km["library_ms"], "shape": "8 x 524288 x 64 points, K=256"},
    ]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
