"""Build the CUDA sources under `repro_torch/csrc/` and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and becomes one shared
library, compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v

into `<repo>/build/kernels/` (git-ignored). The library's file name carries
a hash of its source and flags, so an edited source rebuilds and an
unchanged one loads at once. A build writes to a temporary name and renames
it into place, so concurrent processes never load a half-written library.
`ptxas -v`'s register and shared-memory report is kept beside the library
(`ptxas_info`). Nothing here runs at import: the CPU tests import every
module, and this machine may have no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"the kernels in {CSRC_DIR}")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` is built: keyed by its source and flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp, out) or None if built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build(*names: str) -> None:
    """Build the named sources, all nvcc processes running at once."""
    started = {n: _start(n) for n in names}
    try:
        for n, s in started.items():
            if s is not None:
                _finish(n, s)
    finally:
        for s in started.values():
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()


def ptxas_info(name: str) -> list[str]:
    """The `ptxas info` lines (registers, shared memory, spills) of a build."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    return [ln.strip() for ln in log.read_text().splitlines() if "ptxas info" in ln]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (`cudaGetLastError`)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
