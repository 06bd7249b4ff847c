"""Port checkpoints (repro_torch.checkpoint) against the JAX reference's
(repro.checkpoint), and the training contracts that rest on them.

The file format and manifest are the reference's: a tree of arrays saved by
either package restores in the other, bit for bit, with its `extra`. As the
reference's own tests: a flipped byte fails the MAC, a shape mismatch is
refused, garbage collection keeps the newest `keep`. Then the documented
contracts of two reference tests that fail on the CPU (ROADMAP Queue 3),
held on configs the port has: an interrupted run resumed from a checkpoint
equals the uninterrupted run bit for bit (`test_checkpoint.py::
test_train_resume_bitexact`, here reduced granite-moe with secure ingest
and a secure MoE on 2 shards), and the loss falls at step 2 with
accum_steps=2, warmup=1 (`test_distributed.py::test_train_step_sharded_2x4`,
here reduced glm4-9b).
"""

import os

import numpy as np
import pytest
import torch

import jax

from repro.checkpoint.manager import CheckpointManager as JManager
from repro_torch import VirtualMesh
from repro_torch.checkpoint.manager import CheckpointError, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import secure_config
from repro_torch.crypto.keys import make_session_keys
from repro_torch.data.pipeline import SecureShardedSource
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.train.step import SecureIngest, init_train_state, make_train_step


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layers": {"w": rng.normal(size=(4, 8, 8)).astype(np.float32),
                   "b": rng.normal(size=(4, 8)).astype(np.float32)},
        "embed": rng.normal(size=(32, 8)).astype(np.float32),
        "count": np.int32(7),
        "ids": [np.arange(5, dtype=np.int64), np.uint32(3)],
    }


def _tensors(tree):
    return jax.tree.map(torch.from_numpy, jax.tree.map(np.asarray, tree))


def _zeros(tree):
    return jax.tree.map(np.zeros_like, tree)


def _assert_tree_equal(got, want):
    got_leaves, want_leaves = jax.tree.leaves(
        jax.tree.map(np.asarray, got, is_leaf=lambda x: isinstance(x, torch.Tensor))), \
        jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_save_restore_roundtrip(tmp_path):
    """Tensors in, tensors on the named device out, with the data cursor."""
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(10, _tensors(t), extra={"data_cursor": {"ctr": 123}})
    restored, extra = mgr.restore(10, _zeros(t), device="cpu")
    assert all(isinstance(x, torch.Tensor) for x in jax.tree.leaves(
        restored, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    _assert_tree_equal(restored, t)
    assert extra["data_cursor"]["ctr"] == 123


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_checkpoints_cross_between_packages(tmp_path, direction):
    """Same files, same manifest, same MACs: each package restores the
    other's checkpoint bit for bit, tuples and lists included."""
    t = (_tree(1), {"opt": {"count": np.int32(2)}})
    extra = {"step": 2, "data_cursor": {"ctr": 9, "rng": {"state": [1, 2]}}}
    if direction == "reference_to_port":
        JManager(str(tmp_path)).save(2, t, extra=extra)
        got, got_extra = CheckpointManager(str(tmp_path)).restore(2, _zeros(t), device="cpu")
        assert isinstance(got, tuple)
    else:
        CheckpointManager(str(tmp_path)).save(2, _tensors(t), extra=extra)
        got, got_extra = JManager(str(tmp_path)).restore(2, _zeros(t))
    _assert_tree_equal(got, t)
    assert got_extra == extra
    with open(os.path.join(tmp_path, "step_00000002", "manifest.json")) as f:
        assert '"leaves"' in f.read()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tamper_detected(tmp_path, writer):
    """A flipped byte in a leaf file fails the port's restore, whichever
    package wrote it."""
    t = _tree()
    mgr = CheckpointManager(str(tmp_path))
    path = (mgr.save(5, _tensors(t)) if writer == "port"
            else JManager(str(tmp_path)).save(5, t))
    fn = sorted(f for f in os.listdir(path) if f.endswith(".npy"))[0]
    p = os.path.join(path, fn)
    data = bytearray(open(p, "rb").read())
    data[-1] ^= 0xFF
    open(p, "wb").write(bytes(data))
    with pytest.raises(CheckpointError, match="MAC"):
        mgr.restore(5, _zeros(t), device="cpu")


def test_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tensors(_tree())
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
    assert mgr.list_steps() == [3, 4]
    assert mgr.latest_step() == 4
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_shape_mismatch_and_missing_leaf_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(1, _tensors(t))
    bad = dict(t, embed=torch.zeros((16, 8)))
    with pytest.raises(CheckpointError, match="shape"):
        mgr.restore(1, bad, device="cpu")
    with pytest.raises(CheckpointError, match="missing leaf"):
        mgr.restore(1, dict(t, extra_leaf=np.zeros(3)), device="cpu")


def test_bfloat16_leaves_are_refused(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(1, {"w": torch.zeros(4, dtype=torch.bfloat16)})
    assert mgr.list_steps() == []


# --- the training contracts ----------------------------------------------------------------


def _resume_run(tmp_path, n_steps, save_at=None, resume_from=None):
    """Reduced granite-moe, secure ingest, secure MoE on 2 shards, donated
    steps; optionally checkpoint after `save_at` steps, or start from the
    checkpoint at `resume_from`."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    session = make_session_keys(b"\x21" * 32)
    ingest = SecureIngest(key_words=session.words("data"),
                          nonce_words=session.nonce_words("data", 0))
    toks = synthetic_tokens(2000, cfg.vocab_size, seed=1)
    src = SecureShardedSource(toks, batch=2, seq=16, session=session, seed=3, device="cpu")
    step_fn = make_train_step(cfg, VirtualMesh(2, "cpu"), secure_ingest=ingest,
                              secure_moe=secure_config(np.arange(8), np.arange(3), 5),
                              peak_lr=1e-3, warmup=1, total_steps=10)
    model, opt = init_train_state(cfg, torch.Generator().manual_seed(0), 2, "cpu")
    mgr = CheckpointManager(str(tmp_path))
    start = 0
    if resume_from is not None:
        (params, opt), extra = mgr.restore(resume_from,
                                           (dict(model.named_parameters()), opt), device="cpu")
        model.load_state_dict(params)
        src.restore(extra["data_cursor"])
        start = extra["step"]
    losses = []
    for i in range(start, n_steps):
        model, opt, metrics = step_fn(model, opt, src.next_batch(), i)
        losses.append(metrics["loss"])
        if save_at is not None and i + 1 == save_at:
            mgr.save(save_at, (dict(model.named_parameters()), opt),
                     extra={"step": save_at, "data_cursor": src.state})
    return model, opt, losses


def test_train_resume_bitexact(tmp_path):
    """2 steps, checkpoint, a fresh process state resumed from it for 2 more:
    parameters, moments and losses equal 4 straight steps bit for bit."""
    full_model, full_opt, full_losses = _resume_run(tmp_path / "a", 4)
    _resume_run(tmp_path / "b", 2, save_at=2)
    res_model, res_opt, res_losses = _resume_run(tmp_path / "b", 4, resume_from=2)
    for (k, a), (_, b) in zip(full_model.named_parameters(), res_model.named_parameters()):
        assert torch.equal(a, b), k
    for name in ("mu", "nu"):
        for k in full_opt[name]:
            assert torch.equal(full_opt[name][k], res_opt[name][k]), (name, k)
    assert int(full_opt["count"]) == int(res_opt["count"]) == 4
    assert [float(x) for x in full_losses[2:]] == [float(x) for x in res_losses]


def test_loss_falls_at_step_two_with_accumulation():
    """Reduced glm4-9b, batch 8 x 32, accum_steps=2, warmup=1 (so the first
    step has a non-zero learning rate): finite loss, lower at step 2."""
    cfg = get_config("glm4-9b").reduced()
    model, opt = init_train_state(cfg, torch.Generator().manual_seed(0), 1, "cpu")
    step_fn = make_train_step(cfg, accum_steps=2, donate=False, warmup=1)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, 32)).astype(np.int32))
    model, opt, m1 = step_fn(model, opt, {"tokens": toks}, 1)
    assert np.isfinite(float(m1["loss"]))
    model, opt, m2 = step_fn(model, opt, {"tokens": toks}, 2)
    assert float(m2["loss"]) < float(m1["loss"])


def test_train_lm_cli_runs_on_the_cpu(tmp_path, capsys):
    """The driver: reduced granite-moe, secure ingest and a secure MoE on 2
    shards, checkpoints every 15 steps, the loss falling (it raises if not)."""
    from repro_torch.train_lm import main

    res = main(["--arch", "granite-moe-3b-a800m", "--device", "cpu", "--steps", "30",
                "--batch", "4", "--seq", "32", "--ckpt-every", "15", "--ckpt-dir",
                str(tmp_path), "--shards", "2", "--secure"])
    assert res["checkpoints"] == [15, 30]
    assert res["losses"][-1] < res["losses"][0]
    assert "checkpoint ->" in capsys.readouterr().out
