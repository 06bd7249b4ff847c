"""The port's structural counts (repro_torch.tools.opcount) against the
reference's jaxpr counts (repro.tools.jaxprs).

The reference proves its round structure on a traced jaxpr; the port runs one
round and counts what it did: collectives through `VirtualMesh`'s recording
hook, keystream launches through the ChaCha20 dispatch point (kernel or plain
version alike), device operations through a `TorchDispatchMode`. Exact
integer counts throughout. The reference is traced in process at R=1 (one
host device); at R=8 the port's counts are held to the same structural
numbers the reference's own tests assert (`tests/test_shuffle_coalesced.py`,
`tests/test_sharded_state.py`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.compat import make_mesh
from repro.core import driver as jdrv
from repro.core import kmeans as jkm
from repro.core import sort as js
from repro.core.shuffle import SecureShuffleConfig as JSecure
from repro.crypto import chacha as jch
from repro.tools import jaxprs
from repro_torch import VirtualMesh
from repro_torch.convert import secure_config
from repro_torch.core import driver as tdrv
from repro_torch.core import kmeans as tkm
from repro_torch.core import sort as ts
from repro_torch.tools import opcount

KW = jch.key_to_words(bytes(range(32)))
NW = jch.nonce_to_words(b"\x05" * 12)


def _kmeans_round(r: int, secure, coalesce):
    """(inputs, state, runner) of one k-means round on R shards of the CPU."""
    mesh = VirtualMesh(r, "cpu")
    pts, _ = tkm.generate_points(64 * r, 4, seed=5)
    spec = tkm.make_kmeans_iterative_spec(4, mesh, n_rounds=1)
    runner = tdrv.make_iterative_runner(spec, mesh, secure, coalesce=coalesce)
    inputs = {"p": torch.from_numpy(pts), "w": torch.ones(64 * r)}
    return inputs, torch.from_numpy(pts[:4]), runner


def _reference_kmeans_counts(secure: bool, coalesce):
    mesh = make_mesh((1,), ("data",))
    pts, _ = jkm.generate_points(64, 4, seed=5)
    inputs = {"p": jnp.asarray(pts), "w": jnp.ones((64,), jnp.float32)}
    spec = jkm.make_kmeans_iterative_spec(4, 1, n_rounds=2)
    cfg = JSecure(key_words=KW, nonce_words=NW, counter0=100, impl="pallas-interpret",
                  coalesce=coalesce) if secure else None
    runner = jdrv.make_iterative_runner(spec, mesh, secure=cfg,
                                        coalesce=None if secure else coalesce)
    jaxpr = jax.make_jaxpr(runner.abstract_fn)(inputs, jnp.asarray(pts[:4]), jnp.uint32(0))
    # the scan body traces once: whole-program counts are per-round counts
    return (jaxprs.count_primitives(jaxpr, "all_to_all"),
            jaxprs.count_primitives(jaxpr, "pallas_call"))


@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("secure,coalesce,want_a2a,want_launches",
                         [(True, True, 1, 2), (True, False, 3, 6),
                          (False, True, 1, 0), (False, False, 3, 0)],
                         ids=["secure-coalesced", "secure-per-leaf", "plain-coalesced",
                              "plain-per-leaf"])
def test_exchanges_and_keystream_launches_per_round(r, secure, coalesce, want_a2a,
                                                    want_launches):
    """A coalesced secure round makes ONE all_to_all and TWO keystream
    launches; the per-leaf wire one and two per leaf of the 3-leaf k-means
    tree; a plaintext round no launch -- the reference's jaxpr counts."""
    cfg = secure_config(KW, NW, 100, coalesce=coalesce) if secure else None
    inputs, state, runner = _kmeans_round(r, cfg, coalesce)
    with opcount.counting() as c:
        runner(inputs, state, 0)
    got = (c.collectives["all_to_all"], c.kernels["chacha20_xor_packed"])
    assert got == (want_a2a, want_launches)
    assert c.kernels["kmeans_assign"] == 1
    if r == 1:
        assert got == _reference_kmeans_counts(secure, coalesce)
    # the one-call helpers count the same
    assert opcount.collective_counts(runner, inputs, state, 0)["all_to_all"] == want_a2a
    assert opcount.kernel_call_counts(runner, inputs, state, 0).get(
        "chacha20_xor_packed", 0) == want_launches


def _sort_counts(r: int, shard_state: bool, secure):
    mesh = VirtualMesh(r, "cpu")
    n = 32
    spec = ts.make_sample_sort_spec(mesh, n, halt_total=n * r, shard_state=shard_state)
    runner = tdrv.make_iterative_runner(spec, mesh, secure, n_rounds=1)
    state = {"edges": torch.zeros(r + 1), "sorted": torch.full((r, r * n), torch.inf),
             "counts": torch.zeros(r)}
    values = torch.from_numpy(np.random.default_rng(3).random(n * r, dtype=np.float32))
    return opcount.collective_counts(runner, {"v": values}, state, 0)


def _reference_sort_counts(shard_state: bool, secure: bool):
    mesh = make_mesh((1,), ("data",))
    n = 32
    spec = js.make_sample_sort_spec(1, n, halt_total=n, shard_state=shard_state)
    cfg = JSecure(key_words=KW, nonce_words=NW, counter0=9,
                  impl="pallas-interpret") if secure else None
    runner = jdrv.make_iterative_runner(spec, mesh, secure=cfg)
    state = {"edges": jnp.zeros((2,), jnp.float32), "sorted": jnp.full((1, n), jnp.inf),
             "counts": jnp.zeros((1,), jnp.float32)}
    jaxpr = jax.make_jaxpr(runner.abstract_fn)({"v": jnp.zeros((n,), jnp.float32)}, state,
                                               jnp.uint32(0))
    return jaxprs.collective_counts(jaxpr)


@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("secure", [False, True], ids=["plaintext", "secure"])
def test_sharded_sort_round_drops_one_all_gather_only(r, secure):
    """The sharded table removes exactly ONE all_gather per round and changes
    no other collective; the reference's jaxpr shows the same difference."""
    cfg = secure_config(KW, NW, 9) if secure else None
    sharded, replicated = _sort_counts(r, True, cfg), _sort_counts(r, False, cfg)
    assert set(sharded) == set(opcount.COLLECTIVE_PRIMITIVES) == set(jaxprs.COLLECTIVE_PRIMITIVES)
    assert sharded["all_to_all"] == replicated["all_to_all"] == 1
    assert replicated["all_gather"] == sharded["all_gather"] + 1
    assert sharded["all_gather"] >= 1
    delta = {k: replicated[k] - sharded[k] for k in sharded}
    assert delta == {k: int(k == "all_gather") for k in sharded}
    if r == 1:
        jsh_, jrep = _reference_sort_counts(True, secure), _reference_sort_counts(False, secure)
        assert delta == {k: jrep[k] - jsh_[k] for k in jrep}


def test_count_ops_names_and_totals():
    def f(x):
        y = x + 1
        y = y + x
        y.add_(2)
        return torch.sin(y).sum()

    counts = opcount.count_ops(f, torch.ones(4))
    assert counts["aten.add.Tensor"] == 2
    assert opcount.count_primitives(counts, "aten.add") == 2  # add_ is another operator
    assert opcount.count_primitives(counts, "aten.add_") == 1
    assert opcount.count_primitives(counts, "aten.add.Tensor") == 2
    assert opcount.count_primitives(counts, "aten.mul") == 0
    assert opcount.total_ops(counts) == sum(counts.values()) == 5


def test_call_counter_sinks_are_independent_and_exit_in_any_order():
    counter = opcount.CallCounter()
    counter.note("x")  # nothing open: counted nowhere
    outer_cm, inner_cm = counter.recording(), counter.recording()
    outer = outer_cm.__enter__()
    counter.note("x")
    inner = inner_cm.__enter__()
    counter.note("y")
    outer_cm.__exit__(None, None, None)  # out of stack order
    counter.note("y")
    inner_cm.__exit__(None, None, None)
    counter.note("x")
    assert outer == {"x": 1, "y": 1}
    assert inner == {"y": 2}


def test_device_ops_of_a_round_count_every_dispatch():
    """The secure round's device operations exceed the plaintext round's by
    the two crypts' (pack, keystream, unpack), and the counts of a warm round
    repeat (a first round also builds the wire's device tables)."""
    plain = _kmeans_round(2, None, True)
    sec = _kmeans_round(2, secure_config(KW, NW, 100), True)
    for runner in (plain, sec):
        runner[2](*runner[:2], 0)
    n_plain = opcount.total_ops(opcount.count_ops(plain[2], *plain[:2], 0))
    n_sec = opcount.total_ops(opcount.count_ops(sec[2], *sec[:2], 0))
    assert n_sec > n_plain > 0
    assert opcount.total_ops(opcount.count_ops(sec[2], *sec[:2], 0)) == n_sec
