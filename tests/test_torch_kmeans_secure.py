"""The port's paper script (repro_torch.kmeans_secure) against the reference's
`examples/kmeans_secure.py`, on the CPU, at the same seeds and sizes.

The reference's `main` prints and returns nothing, so its three sections are
rebuilt here from the same reference calls (`kmeans_fit` secure on a
one-device mesh, `make_cluster`/`run_kmeans` under the four policies,
`SecurePager`). Round counts, virtual times, overheads and paged bytes must
be equal exactly (the simulated cluster and the pager are deterministic
host code); centres within the tolerances of `tests/test_torch_kmeans.py`
(rtol/atol 1e-5: float sums in another order), inertia within rtol 1e-4.
Both sides run once per module: the reference's secure fit compiles, and
the cluster sweep runs ChaCha20 on the host for every message.
"""

import numpy as np
import pytest

from repro.compat import make_mesh
from repro.core.kmeans import generate_points as jgenerate_points
from repro.core.kmeans import kmeans_fit as jkmeans_fit
from repro.core.paging import SecurePager as JSecurePager
from repro.core.shuffle import SecureShuffleConfig
from repro.crypto import chacha as jchacha
from repro.runtime.jobs import make_cluster as jmake_cluster
from repro.runtime.jobs import run_kmeans as jrun_kmeans
from repro.runtime.node import SecurityPolicy as JSecurityPolicy
from repro.runtime.sim import TimingModel as JTimingModel
from repro_torch import kmeans_secure


@pytest.fixture(scope="module")
def port():
    return kmeans_secure.main(device="cpu")


@pytest.fixture(scope="module")
def ref():
    """The reference script's figures, section by section, at its seeds."""
    mesh = make_mesh((1,), ("data",))
    pts, true_centers = jgenerate_points(20000, 10, seed=0, spread=0.05)
    secure = SecureShuffleConfig(key_words=jchacha.key_to_words(bytes(range(32))),
                                 nonce_words=jchacha.nonce_to_words(b"\x02" * 12))
    res = jkmeans_fit(pts, 10, mesh, secure=secure, init="farthest")
    centers = np.asarray(res.centers)
    d = np.linalg.norm(centers[:, None] - true_centers[None], axis=-1)
    times = {}
    for encl in (False, True):
        for enc in (False, True):
            cluster, client, _ = jmake_cluster(
                6, policy=JSecurityPolicy(encryption=enc, enclave=encl),
                timing=JTimingModel(epc_budget_bytes=32 << 20))
            _, hist = jrun_kmeans(cluster, client, pts[:400], 5, n_mappers=4, n_reducers=2,
                                  max_iter=2, threshold=0.0)
            times[(encl, enc)] = np.mean([h["elapsed"] for h in hist])
    enc_ovh = 0.5 * ((times[(0, 1)] / times[(0, 0)] - 1) + (times[(1, 1)] / times[(1, 0)] - 1))
    encl_ovh = 0.5 * ((times[(1, 0)] / times[(0, 0)] - 1) + (times[(1, 1)] / times[(0, 1)] - 1))
    paged = []
    for ws_pages in (16, 64, 512):
        pager = JSecurePager(budget_bytes=256 * 1024, key=b"\x07" * 32)
        for i in range(ws_pages):
            pager.store(f"p{i}", b"\0" * 4096)
        for i in range(ws_pages):
            pager.load(f"p{i}")
        paged.append(pager.stats.bytes_encrypted + pager.stats.bytes_decrypted)
    return {"n_iter": res.n_iter, "n_dispatches": res.n_dispatches,
            "n_rounds_dispatched": res.n_rounds_dispatched,
            "shifts": [float(s) for s in res.center_shift], "inertia": float(res.inertia),
            "centers": centers, "max_distance": float(d.min(axis=0).max()),
            "times": {f"enclave={int(a)},encryption={int(b)}": float(t)
                      for (a, b), t in times.items()},
            "encryption_overhead": float(enc_ovh), "enclave_overhead": float(encl_ovh),
            "paged": paged}


def test_convergence_rounds_equal_exactly(port, ref):
    conv = port["convergence"]
    assert (conv["n_iter"], conv["n_dispatches"], conv["n_rounds_dispatched"]) == (
        ref["n_iter"], ref["n_dispatches"], ref["n_rounds_dispatched"])


def test_convergence_centres_and_inertia_within_tolerance(port, ref):
    conv = port["convergence"]
    np.testing.assert_allclose(conv["centers"], ref["centers"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(conv["final_shift"], ref["shifts"][-1], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(conv["inertia"], ref["inertia"], rtol=1e-4)
    np.testing.assert_allclose(conv["max_distance_to_true_center"], ref["max_distance"],
                               rtol=1e-5, atol=1e-5)


def test_overhead_sweep_virtual_times_equal_exactly(port, ref):
    ovh = port["overheads"]
    assert ovh["times"] == ref["times"]
    assert ovh["encryption_overhead"] == ref["encryption_overhead"]
    assert ovh["enclave_overhead"] == ref["enclave_overhead"]


def test_paging_cliff_bytes_equal_exactly(port, ref):
    assert [row["bytes_paged"] for row in port["paging"]] == ref["paged"]
    assert [row["working_set_kib"] for row in port["paging"]] == [64, 256, 2048]
    # the cliff: nothing pages inside the budget, everything past it
    assert ref["paged"][0] == ref["paged"][1] == 0 < ref["paged"][2]


def test_main_runs_on_the_named_device_and_parses_its_options(port):
    """`device="cpu"` runs on the CPU; an unknown option is refused by the
    command line's parser before anything runs."""
    assert port["device"] == "cpu"
    with pytest.raises(SystemExit):
        kmeans_secure.main(["--bogus"])
