"""Build the CUDA sources under `repro_torch/csrc/` and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and becomes one shared
library, compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v

into `<repo>/build/kernels/` (git-ignored). A source built once for each
value of a compile-time constant (the attention kernel's head size) takes
`defines`, passed as `-D<name>=<value>` and named in the library's file
name. The file name carries a hash of the source and flags, so an edited
source rebuilds and an unchanged one loads at once. A build writes to a
temporary name and renames it into place, so concurrent processes never
load a half-written library.
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

_loaded: dict[tuple, ctypes.CDLL] = {}


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


def _flags(defines: dict | None) -> list[str]:
    return [*NVCC_FLAGS, *(f"-D{k}={v}" for k, v in sorted((defines or {}).items()))]


def library_path(name: str, defines: dict | None = None) -> Path:
    """Where `csrc/<name>.cu` is built: keyed by its source and flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    variant = "".join(f"_{k.lower()}{v}" for k, v in sorted((defines or {}).items()))
    return BUILD_DIR / f"lib{name}{variant}-{digest}.so"


def _start(name: str, defines: dict | None = None):
    """Start nvcc for one source; returns (process, tmp, out) or None if built."""
    out = library_path(name, defines)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
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


def build(*names: str, defines: dict | None = None) -> None:
    """Build the named sources (each with `defines`), all nvcc processes
    running at once."""
    started = {n: _start(n, defines) for n in names}
    try:
        for n, s in started.items():
            if s is not None:
                _finish(n, s)
    finally:
        for s in started.values():
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()


def ptxas_info(name: str, defines: dict | None = None) -> list[str]:
    """The `ptxas info` lines of a build (entry functions, registers, shared
    memory) and the stack/spill line that follows each function's properties."""
    log = library_path(name, defines).with_suffix(".log")
    if not log.exists():
        return []
    return [ln.strip() for ln in log.read_text().splitlines()
            if "ptxas info" in ln or "spill" in ln]


def load(name: str, defines: dict | None = None) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu` (with `defines`), built first
    if needed."""
    key = (name, tuple(sorted((defines or {}).items())))
    lib = _loaded.get(key)
    if lib is None:
        build(name, defines=defines)
        lib = _loaded[key] = ctypes.CDLL(str(library_path(name, defines)))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (`cudaGetLastError`)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
