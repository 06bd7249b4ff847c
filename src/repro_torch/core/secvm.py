"""SecVM -- code confidentiality via a bytecode interpreter on the card.

Counterpart of `repro/core/secvm.py`. The paper ports a Lua VM into the
enclave so user map/reduce code ships as encrypted scripts the host never
sees. Here the user program travels as data (encrypted int32 bytecode + f32
constant pool), is decrypted on the inputs' device and interpreted there:
the host dispatches the same operations for any two programs of one length
and never reads an opcode or a register index (tests/test_torch_secvm.py
records the dispatched sequence).

The reference picks each instruction's branch with a `lax.switch` on the
device. PyTorch has no device-side branch, so every instruction reads
r[a], r[b], r[d] and const[b] with device-indexed gathers, computes all 18
opcode results and takes the one its (clipped) opcode indexes, then writes
r[d] with a device-indexed `index_copy_`. The results are selected by a
gather, never by a one-hot product: the branches not taken make inf and NaN
(DIV, LOG, SQRT, MOD), and 0 * NaN is NaN. Register reads clamp their index
to the file, and a write outside it is dropped, as the reference's gathers
and scatters do.

Machine model: NREG vector registers of shape (lanes,) f32; a program is an
(L, 4) int32 array of [opcode, dst, a, b]; constants live in a separate pool
(register-indexed LOADC).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.crypto.ctr import decrypt_array, encrypt_array

NREG = 16

OPS = {
    "NOP": 0,
    "MOV": 1,    # r[d] = r[a]
    "LOADC": 2,  # r[d] = const[b]
    "ADD": 3,    # r[d] = r[a] + r[b]
    "SUB": 4,
    "MUL": 5,
    "DIV": 6,
    "MIN": 7,
    "MAX": 8,
    "NEG": 9,
    "ABS": 10,
    "SQRT": 11,
    "EXP": 12,
    "LOG": 13,
    "FLOOR": 14,
    "CMPLT": 15,  # r[d] = r[a] < r[b] ? 1 : 0
    "FMA": 16,    # r[d] = r[d] + r[a] * r[b]
    "MOD": 17,    # r[d] = r[a] mod r[b]
}
N_OPS = len(OPS)


@dataclass(frozen=True)
class Program:
    """Assembled SecVM program."""

    code: np.ndarray  # (L, 4) int32
    consts: np.ndarray  # (NC,) float32
    out_reg: int = 0

    @property
    def length(self) -> int:
        return int(self.code.shape[0])


def assemble(instrs: Sequence[tuple], consts: Sequence[float] = (), out_reg: int = 0) -> Program:
    """instrs: [("ADD", d, a, b), ("LOADC", d, 0, const_idx), ...]"""
    code = np.zeros((len(instrs), 4), np.int32)
    for i, ins in enumerate(instrs):
        name, *ops = ins
        code[i, 0] = OPS[name]
        code[i, 1 : 1 + len(ops)] = ops
    return Program(code=code, consts=np.asarray(consts, np.float32), out_reg=out_reg)


def _exec_instr(regs, consts, instr):
    """One instruction on the (NREG, lanes) register file, in place."""
    op = instr[0:1].clamp(0, N_OPS - 1)
    d, a, b = instr[1:2], instr[2:3], instr[3:4]
    dc = d.clamp(0, NREG - 1)
    ra = regs.index_select(0, a.clamp(0, NREG - 1))  # (1, lanes)
    rb = regs.index_select(0, b.clamp(0, NREG - 1))
    rd = regs.index_select(0, dc)
    cb = consts.index_select(0, b.clamp(0, consts.shape[0] - 1)).expand_as(rd)
    results = torch.stack([
        rd,  # NOP
        ra,  # MOV
        cb,  # LOADC
        ra + rb,
        ra - rb,
        ra * rb,
        ra / rb,
        torch.minimum(ra, rb),
        torch.maximum(ra, rb),
        -ra,
        torch.abs(ra),
        torch.sqrt(ra),
        torch.exp(ra),
        torch.log(ra),
        torch.floor(ra),
        (ra < rb).to(torch.float32),
        rd + ra * rb,
        ra - torch.floor(ra / rb) * rb,
    ])  # (N_OPS, 1, lanes)
    val = results.index_select(0, op)[0]
    val = torch.where((d >= 0) & (d < NREG), val, rd)  # a write outside the file is dropped
    regs.index_copy_(0, dc, val)


def run_program(code, consts, inputs, out_reg=0, length: int | None = None):
    """Execute bytecode on vector lanes.

    code:   (L, 4) int32 tensor (e.g. freshly decrypted; never read on the host)
    consts: (NC,) f32 tensor
    inputs: (n_in, lanes) f32 tensor loaded into r1..r{n_in} (r0 zeroed: output acc)

    Runs on the inputs' device; returns register `out_reg`, (lanes,) f32.
    """
    dev = inputs.device
    code = torch.as_tensor(code, device=dev)
    consts = torch.as_tensor(consts, dtype=torch.float32, device=dev).reshape(-1)
    if consts.shape[0] == 0:
        consts = torch.zeros((1,), dtype=torch.float32, device=dev)
    lanes = inputs.shape[1]
    regs = torch.zeros((NREG, lanes), dtype=torch.float32, device=dev)
    regs[1 : 1 + inputs.shape[0]] = inputs
    n = length if length is not None else code.shape[0]
    code = code.to(torch.int64)
    for i in range(n):
        _exec_instr(regs, consts, code[i])
    return regs[out_reg]


# ---------------------------------------------------------------------------
# Encrypted-program transport ("provisioning of code", paper Fig. 4)
# ---------------------------------------------------------------------------


def encrypt_program(prog: Program, key_words, nonce_words, counter0=0, device=None):
    """Returns (code_ct, consts_ct) -- ciphertext tensors safe to hand the host.

    `device` is where the ciphertext is made (None: the card)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    code_ct = encrypt_array(torch.as_tensor(prog.code, device=dev), key_words, nonce_words,
                            counter0)
    c_blocks = -(-prog.code.size // 16)
    consts_ct = encrypt_array(torch.as_tensor(prog.consts, dtype=torch.float32, device=dev),
                              key_words, nonce_words, counter0 + c_blocks)
    return code_ct, consts_ct


def run_encrypted(code_ct, consts_ct, inputs, key_words, nonce_words, counter0=0, out_reg=0):
    """Decrypt on the inputs' device (on the card: two launches of the
    ChaCha20 kernel, through `crypto/ctr.py`), then execute. Nothing of the
    program is read back to the host."""
    dev = inputs.device
    code = decrypt_array(torch.as_tensor(code_ct, device=dev), key_words, nonce_words, counter0)
    c_blocks = -(-code_ct.numel() // 16)
    consts = decrypt_array(torch.as_tensor(consts_ct, device=dev), key_words, nonce_words,
                           counter0 + c_blocks)
    return run_program(code, consts, inputs, out_reg=out_reg)


# -- python oracle for tests --------------------------------------------------


def run_oracle(prog: Program, inputs: np.ndarray) -> np.ndarray:
    regs = np.zeros((NREG, inputs.shape[1]), np.float32)
    regs[1 : 1 + inputs.shape[0]] = inputs
    inv = {v: k for k, v in OPS.items()}
    with np.errstate(all="ignore"):
        for op, d, a, b in prog.code:
            name = inv[int(op)]
            if name == "NOP":
                continue
            elif name == "MOV":
                regs[d] = regs[a]
            elif name == "LOADC":
                regs[d] = prog.consts[b]
            elif name == "ADD":
                regs[d] = regs[a] + regs[b]
            elif name == "SUB":
                regs[d] = regs[a] - regs[b]
            elif name == "MUL":
                regs[d] = regs[a] * regs[b]
            elif name == "DIV":
                regs[d] = regs[a] / regs[b]
            elif name == "MIN":
                regs[d] = np.minimum(regs[a], regs[b])
            elif name == "MAX":
                regs[d] = np.maximum(regs[a], regs[b])
            elif name == "NEG":
                regs[d] = -regs[a]
            elif name == "ABS":
                regs[d] = np.abs(regs[a])
            elif name == "SQRT":
                regs[d] = np.sqrt(regs[a])
            elif name == "EXP":
                regs[d] = np.exp(regs[a])
            elif name == "LOG":
                regs[d] = np.log(regs[a])
            elif name == "FLOOR":
                regs[d] = np.floor(regs[a])
            elif name == "CMPLT":
                regs[d] = (regs[a] < regs[b]).astype(np.float32)
            elif name == "FMA":
                regs[d] = regs[d] + regs[a] * regs[b]
            elif name == "MOD":
                regs[d] = regs[a] - np.floor(regs[a] / regs[b]) * regs[b]
    return regs[prog.out_reg]
