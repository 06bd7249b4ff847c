"""The port's SecVM against the JAX package's: oracle agreement, encrypted
transport, code confidentiality, SecVM as a secure map function.

Floats agree with the oracle and with `repro.core.secvm` within the
reference test's rtol 1e-5; ciphertexts of `encrypt_program` equal the
reference's bit for bit. The reference proves code confidentiality by
identical HLO for two programs of one length; the port, which dispatches
eagerly, by an identical sequence of dispatched operations (op, shapes,
dtypes) under a `TorchDispatchMode`.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from repro.core import secvm as jvm
from repro_torch import VirtualMesh
from repro_torch.convert import secure_config
from repro_torch.core import secvm
from repro_torch.core.engine import MapReduceSpec, identity_hash, run_mapreduce
from repro_torch.core.grep import segment_sum
from repro_torch.crypto import chacha

KW = chacha.key_to_words(bytes(range(32)))
NW = chacha.nonce_to_words(b"\x03" * 12)


def _poly_prog(mod=secvm):
    # r0 = 2*x^2 + 3*x + 1   (x in r1)
    return mod.assemble(
        [("LOADC", 2, 0, 0), ("LOADC", 3, 0, 1), ("LOADC", 0, 0, 2), ("MUL", 4, 1, 1),
         ("FMA", 0, 4, 2), ("FMA", 0, 1, 3)],
        consts=[2.0, 3.0, 1.0])


def _dist_prog(mod=secvm):
    # r0 = sqrt((x-a)^2 + (y-b)^2), a=0.5 b=-1.5; inputs x=r1, y=r2
    return mod.assemble(
        [("LOADC", 3, 0, 0), ("LOADC", 4, 0, 1), ("SUB", 5, 1, 3), ("SUB", 6, 2, 4),
         ("MUL", 5, 5, 5), ("FMA", 5, 6, 6), ("SQRT", 0, 5, 0)],
        consts=[0.5, -1.5])


def _every_op_prog(mod=secvm):
    """All 18 opcodes; DIV, LOG, SQRT and MOD see zeros and negatives."""
    ins = [("LOADC", 3, 0, 0), ("LOADC", 4, 0, 1), ("ADD", 5, 1, 2), ("SUB", 6, 1, 2),
           ("MUL", 7, 1, 2), ("DIV", 8, 1, 2), ("MIN", 9, 1, 2), ("MAX", 10, 1, 2),
           ("NEG", 11, 1, 0), ("ABS", 12, 11, 0), ("SQRT", 13, 12, 0), ("EXP", 14, 2, 0),
           ("LOG", 15, 12, 0), ("FLOOR", 6, 1, 0), ("CMPLT", 7, 1, 2), ("FMA", 8, 9, 10),
           ("MOD", 9, 1, 4), ("MOV", 10, 3, 0), ("NOP", 0, 0, 0), ("ADD", 0, 13, 14),
           ("FMA", 0, 7, 4), ("ADD", 0, 0, 12)]
    return mod.assemble(ins, consts=[1.5, 0.75])


def _inputs(n_in, lanes=64, seed=0):
    x = np.random.default_rng(seed).normal(size=(n_in, lanes)).astype(np.float32)
    x[:, :4] = 0.0  # zeros for DIV and LOG
    return x


@pytest.mark.parametrize("prog_fn,n_in", [(_poly_prog, 1), (_dist_prog, 2), (_every_op_prog, 2)])
def test_vm_matches_oracle_and_jax(prog_fn, n_in):
    prog, jprog = prog_fn(), prog_fn(jvm)
    np.testing.assert_array_equal(prog.code, jprog.code)
    x = _inputs(n_in)
    got = secvm.run_program(torch.from_numpy(prog.code), torch.from_numpy(prog.consts),
                            torch.from_numpy(x), prog.out_reg).numpy()
    want = secvm.run_oracle(prog, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    ref = np.asarray(jvm.run_program(jnp.asarray(jprog.code), jnp.asarray(jprog.consts),
                                     jnp.asarray(x), jprog.out_reg))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


def test_branches_not_taken_leak_no_nan():
    """r0 = r1 + r2 with r2 = 0: the DIV, LOG and MOD results of the same
    instruction are inf or NaN, and must not reach r0 (select by gather)."""
    prog = secvm.assemble([("ADD", 0, 1, 2)])
    x = np.stack([np.linspace(-1, 1, 16, dtype=np.float32), np.zeros(16, np.float32)])
    got = secvm.run_program(torch.from_numpy(prog.code), torch.from_numpy(prog.consts),
                            torch.from_numpy(x))
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got.numpy(), x[0])


def test_opcodes_and_registers_out_of_range_follow_the_reference():
    """Opcodes clip to [0, 17]; register reads clamp to the file and a write
    past it is dropped, as the reference's gathers and scatters do."""
    code = np.array([[2, 5, 0, 1], [99, 6, 1, 5], [-4, 1, 1, 1], [3, 0, 6, 20],
                     [3, 16, 1, 1], [3, 7, 30, 1]], np.int32)
    consts = np.array([2.5, 4.0], np.float32)
    x = _inputs(1, 32, seed=3) + 3.0
    got = secvm.run_program(torch.from_numpy(code), torch.from_numpy(consts),
                            torch.from_numpy(x), 0)
    want = np.asarray(jvm.run_program(jnp.asarray(code), jnp.asarray(consts), jnp.asarray(x), 0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for reg in (7, 15):
        g = secvm.run_program(torch.from_numpy(code), torch.from_numpy(consts),
                              torch.from_numpy(x), reg)
        w = np.asarray(jvm.run_program(jnp.asarray(code), jnp.asarray(consts), jnp.asarray(x),
                                       reg))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


def test_encrypted_program_roundtrip():
    prog = _poly_prog()
    code_ct, consts_ct = secvm.encrypt_program(prog, KW, NW, 7, device="cpu")
    assert not np.array_equal(code_ct.numpy(), prog.code)
    x = np.linspace(-2, 2, 32, dtype=np.float32)[None]
    got = secvm.run_encrypted(code_ct, consts_ct, torch.from_numpy(x), KW, NW, 7)
    np.testing.assert_allclose(got.numpy(), 2 * x[0] ** 2 + 3 * x[0] + 1, rtol=1e-5)


@pytest.mark.parametrize("counter0", [0, 7, 2**32 - 9])
def test_encrypt_program_equals_the_reference_bit_for_bit(counter0):
    for prog_fn in (_poly_prog, _dist_prog, _every_op_prog):
        prog = prog_fn()
        code_ct, consts_ct = secvm.encrypt_program(prog, KW, NW, counter0, device="cpu")
        jcode, jconsts = jvm.encrypt_program(prog_fn(jvm), KW, NW, counter0)
        np.testing.assert_array_equal(code_ct.numpy(), np.asarray(jcode))
        np.testing.assert_array_equal(consts_ct.numpy().view(np.uint32),
                                      np.asarray(jconsts).view(np.uint32))
        # each package runs the other's ciphertext
        x = _inputs(2, 16, seed=counter0 % 7)
        got = secvm.run_encrypted(torch.from_numpy(np.array(jcode)),
                                  torch.from_numpy(np.array(jconsts)), torch.from_numpy(x),
                                  KW, NW, counter0)
        want = np.asarray(jvm.run_encrypted(jcode, jconsts, jnp.asarray(x), KW, NW, counter0))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


class _Record(TorchDispatchMode):
    """Every dispatched operation as (op, input shapes and dtypes)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        sig = tuple((tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else type(a).__name__
                    for a in list(args) + list(kwargs.values()))
        self.ops.append((str(func), sig))
        return func(*args, **kwargs)


def _padded(prog, length, n_consts=4):
    code = np.zeros((length, 4), np.int32)
    code[:prog.length] = prog.code
    consts = np.zeros((n_consts,), np.float32)
    consts[:len(prog.consts)] = prog.consts
    return secvm.Program(code, consts, prog.out_reg)


def test_code_confidentiality_identical_dispatch():
    """Two different programs of equal length dispatch the identical sequence
    of operations, plain and encrypted: the host sees the interpreter, not
    the code, and reads no opcode or register index."""
    p1, p2 = _poly_prog(), _dist_prog()
    ln = max(p1.length, p2.length)
    x = torch.zeros((2, 16))
    seqs, enc_seqs = [], []
    for p in (_padded(p1, ln), _padded(p2, ln)):
        with _Record() as rec:
            secvm.run_program(torch.from_numpy(p.code), torch.from_numpy(p.consts), x, 0)
        seqs.append(rec.ops)
        code_ct, consts_ct = secvm.encrypt_program(p, KW, NW, 3, device="cpu")
        with _Record() as rec:
            secvm.run_encrypted(code_ct, consts_ct, x, KW, NW, 3)
        enc_seqs.append(rec.ops)
    assert len(seqs[0]) > 18 * ln and seqs[0] == seqs[1]
    assert enc_seqs[0] == enc_seqs[1]
    assert not any("item" in op or "_local_scalar_dense" in op for op, _ in enc_seqs[0])


@pytest.mark.parametrize("shards", [1, 4])
def test_vm_in_mapreduce_map_fn(shards):
    """A SecVM program as the map function of a secure MapReduce job."""
    mesh = VirtualMesh(shards, "cpu")
    prog = _poly_prog()
    code_ct, consts_ct = secvm.encrypt_program(prog, KW, NW, 0, device="cpu")

    def map_fn(k, v):
        out = secvm.run_encrypted(code_ct, consts_ct, v.reshape(1, -1), KW, NW, 0)
        return k, out.reshape(v.shape)

    def reduce_fn(k, v, valid):
        seg = torch.where(valid, k, -1)
        return mesh.psum(segment_sum(torch.where(valid, v, 0.0), seg, 4))

    keys = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int32)
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0], np.float32)
    cfg = secure_config(KW, chacha.nonce_to_words(b"\x05" * 12), 9)
    out, dropped = run_mapreduce(MapReduceSpec(map_fn, reduce_fn, hash_fn=identity_hash,
                                               capacity=8), keys, vals, mesh, secure=cfg)
    def f(x):
        return 2 * x**2 + 3 * x + 1
    want = [f(1) + f(5), f(2) + f(6), f(3) + f(7), f(4) + f(8)]
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5)
    assert int(dropped) == 0
