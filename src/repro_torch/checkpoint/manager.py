"""MAC-verified, atomic checkpoints of trees of tensors.

Counterpart of `repro/checkpoint/manager.py`, with its file format and
manifest: a checkpoint written by either package restores in the other.
  * atomic: write to `step_<n>.tmp/`, fsync the manifest, rename -- a crash
    mid-save never corrupts the latest checkpoint;
  * integrity: every leaf file carries a ChaCha20-keyed polynomial MAC
    (`crypto/mac.py`; the key and per-leaf counter are the reference's), so
    a flipped bit fails restore loudly;
  * leaves are independent .npy files keyed by their path in the tree
    (dicts by sorted key, lists and tuples by index);
  * data cursor: `extra` (JSON) carries the input pipeline's state, so a
    secure-ingest stream resumes exactly.

A tree's leaves are tensors (on any device) or numpy arrays and scalars;
bfloat16 tensors are refused (numpy has no bfloat16 to write). The
reference's elastic restore onto a mesh has no counterpart on one card:
`restore` puts the leaves on `device` instead.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib

import numpy as np
import torch

from repro_torch.crypto.mac import mac_keys_from_keystream, mac_tag_host, mac_verify_host
from repro_torch.device import resolve_device


class CheckpointError(RuntimeError):
    pass


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("bfloat16 tensors cannot be checkpointed: numpy has no "
                            "bfloat16; save float32 masters")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(np.shape(x))


class CheckpointManager:
    def __init__(self, directory: str, key: bytes = b"\x5c" * 32, keep: int = 3):
        self.dir = directory
        self.key = key
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _mac(self, path_label: str, arr: np.ndarray):
        kw = np.frombuffer(self.key, "<u4")
        nw = np.frombuffer(b"ckpt-mac----", "<u4")
        ctr = (zlib.crc32(path_label.encode()) ^ 0x5A5A) & 0x7FFFFFFF  # process-stable
        rs, ss = mac_keys_from_keystream(kw, nw, ctr)
        pad = (-arr.nbytes) % 4
        words = np.frombuffer(arr.tobytes() + b"\x00" * pad, "<u4")
        return rs, ss, words

    def save(self, step: int, tree, extra: dict | None = None) -> str:
        """Atomic save of a tree of tensors or arrays; returns its directory."""
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        flat = {path: _to_numpy(leaf) for path, leaf in _flatten(tree).items()}
        manifest = {"step": step, "leaves": {}, "extra": extra or {}}
        for path, arr in flat.items():
            fname = path.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            rs, ss, words = self._mac(path, arr)
            tag = mac_tag_host(words, rs, ss)
            manifest["leaves"][path] = {
                "file": fname,
                "dtype": str(arr.dtype),
                "shape": list(arr.shape),
                "mac": [int(t) for t in tag],
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def list_steps(self):
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_") and not n.endswith(".tmp"):
                out.append(int(n[5:]))
        return sorted(out)

    def latest_step(self):
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, device=None):
        """Restore into the STRUCTURE of `target_tree` (leaves give the
        expected shapes), every leaf a tensor on `device` (the card unless
        named). Returns (tree, extra)."""
        device = resolve_device(device)
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat_target = _flatten(target_tree)
        loaded = {}
        for path, want in flat_target.items():
            meta = manifest["leaves"].get(path)
            if meta is None:
                raise CheckpointError(f"missing leaf {path} in checkpoint {step}")
            arr = np.load(os.path.join(d, meta["file"]))
            rs, ss, words = self._mac(path, arr)
            if not mac_verify_host(words, rs, ss, np.array(meta["mac"], np.uint32)):
                raise CheckpointError(f"MAC mismatch for {path} — tampered/corrupt")
            if tuple(arr.shape) != _shape(want):
                raise CheckpointError(
                    f"shape mismatch for {path}: ckpt {arr.shape} vs target {_shape(want)}")
            loaded[path] = torch.from_numpy(arr).to(device)
        return _rebuild(target_tree, loaded), manifest["extra"]


def _rebuild(tree, loaded, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], loaded, f"{prefix}{k}/") for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, loaded, f"{prefix}{i}/") for i, v in enumerate(tree))
    return loaded[prefix[:-1]]
