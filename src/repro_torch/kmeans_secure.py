"""The paper's evaluation workload: secure k-means, convergence + overheads.

Counterpart of `examples/kmeans_secure.py`, at its seeds and sizes:

1. Convergence under the diag/1000 threshold (paper Figs. 5-6): `kmeans_fit`
   of 20,000 points in 2 dimensions, K = 10, farthest-point seeding, its
   shuffle ChaCha20-encrypted, on a one-shard virtual mesh of the device
   (on the card: the k-means and ChaCha20 kernels).
2. The 4-way encryption x enclave sweep on the simulated cluster (Fig. 9):
   k-means over 400 of the points through the pub/sub protocol; virtual
   times from `TimingModel(epc_budget_bytes=32 MiB)`.
3. The paging cliff (Fig. 8): `SecurePager` at working sets of 16, 64 and
   512 pages of 4 KiB against a 256 KiB trusted budget.

Run:  PYTHONPATH=src python -m repro_torch.kmeans_secure [--device cpu]
(the card by default; without one it raises unless the CPU is named).
`main` returns the printed figures as a dict.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.convert import secure_config
from repro_torch.core.kmeans import generate_points, kmeans_fit
from repro_torch.core.paging import SecurePager
from repro_torch.crypto import chacha
from repro_torch.device import resolve_device
from repro_torch.mesh import VirtualMesh
from repro_torch.runtime.jobs import make_cluster, run_kmeans
from repro_torch.runtime.node import SecurityPolicy
from repro_torch.runtime.sim import TimingModel

N_POINTS, K, D, SEED, SPREAD = 20000, 10, 2, 0, 0.05
SWEEP_POINTS, SWEEP_K, SWEEP_WORKERS = 400, 5, 6
WORKING_SETS, PAGE_BYTES, PAGER_BUDGET = (16, 64, 512), 4096, 256 * 1024


def convergence(pts, true_centers, device) -> dict:
    """Section 1: the secure fit on a one-shard mesh of `device`."""
    secure = secure_config(chacha.key_to_words(bytes(range(32))),
                           chacha.nonce_to_words(b"\x02" * 12))
    res = kmeans_fit(pts, K, VirtualMesh(1, device), secure=secure, init="farthest")
    centers = res.centers.cpu().numpy()
    d = np.linalg.norm(centers[:, None] - true_centers[None], axis=-1)
    return {"n_iter": res.n_iter, "n_dispatches": res.n_dispatches,
            "n_rounds_dispatched": res.n_rounds_dispatched,
            "final_shift": res.center_shift[-1], "inertia": res.inertia,
            "max_distance_to_true_center": float(d.min(axis=0).max()), "centers": centers}


def overheads(pts) -> dict:
    """Section 2: mean virtual seconds per k-means iteration of each
    (enclave, encryption) policy, and the two overheads the paper reports."""
    times = {}
    for encl in (False, True):
        for enc in (False, True):
            cluster, client, _ = make_cluster(
                SWEEP_WORKERS, policy=SecurityPolicy(encryption=enc, enclave=encl),
                timing=TimingModel(epc_budget_bytes=32 << 20))
            _, hist = run_kmeans(cluster, client, pts[:SWEEP_POINTS], SWEEP_K, n_mappers=4,
                                 n_reducers=2, max_iter=2, threshold=0.0)
            times[(encl, enc)] = float(np.mean([h["elapsed"] for h in hist]))
    enc = 0.5 * ((times[(0, 1)] / times[(0, 0)] - 1) + (times[(1, 1)] / times[(1, 0)] - 1))
    encl = 0.5 * ((times[(1, 0)] / times[(0, 0)] - 1) + (times[(1, 1)] / times[(0, 1)] - 1))
    return {"times": {f"enclave={int(a)},encryption={int(b)}": t for (a, b), t in times.items()},
            "encryption_overhead": enc, "enclave_overhead": encl}


def paging() -> list:
    """Section 3: bytes encrypted plus decrypted per working set."""
    rows = []
    for ws_pages in WORKING_SETS:
        pager = SecurePager(budget_bytes=PAGER_BUDGET, key=b"\x07" * 32)
        for i in range(ws_pages):
            pager.store(f"p{i}", b"\0" * PAGE_BYTES)
        for i in range(ws_pages):
            pager.load(f"p{i}")
        rows.append({"working_set_pages": ws_pages,
                     "working_set_kib": ws_pages * PAGE_BYTES // 1024,
                     "bytes_paged": pager.stats.bytes_encrypted + pager.stats.bytes_decrypted})
    return rows


def main(argv=None, *, device=None) -> dict:
    """Run the three sections, print them as the reference does, return them.

    `device` (e.g. "cpu") wins over `--device`; neither means the card.
    """
    if device is None:
        ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
        ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
        device = ap.parse_args(argv).device
    dev = resolve_device(device)
    pts, true_centers = generate_points(N_POINTS, K, d=D, seed=SEED, spread=SPREAD)

    print(f"=== convergence (paper Figs. 5-6) on {dev} ===")
    conv = convergence(pts, true_centers, dev)
    print(f"diag/1000 threshold: converged in {conv['n_iter']} iterations "
          f"({conv['n_dispatches']} host dispatches via the convergence-aware driver; "
          f"{conv['n_rounds_dispatched']} rounds dispatched), "
          f"final shift {conv['final_shift']:.2e}, inertia {conv['inertia']:.1f}")
    print(f"max distance to a true center: {conv['max_distance_to_true_center']:.4f}")

    print("\n=== encryption x enclave overheads (paper Fig. 9) ===")
    ovh = overheads(pts)
    print(f"encryption overhead: {ovh['encryption_overhead'] * 100:.1f}%   (paper: ~5%)")
    print(f"enclave overhead:    {ovh['enclave_overhead'] * 100:.1f}%  (paper: ~30% inside EPC)")

    print("\n=== paging cliff (paper Fig. 8) ===")
    pages = paging()
    for row in pages:
        print(f"working set {row['working_set_kib']:5d} KiB vs {PAGER_BUDGET // 1024} KiB "
              f"budget: {row['bytes_paged']:9d} bytes paged")
    return {"device": str(dev), "convergence": conv, "overheads": ovh, "paging": pages}


if __name__ == "__main__":
    main()
