"""Build and load the package's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into a shared library with a
plain C interface on first use, and loaded with ctypes. The library lands
in `miniraytracer_tpu_torch/_build/` under a name keyed on a hash of the
sources and the flags, so an edited source rebuilds (in the next process) and an
unchanged one loads at once. A failed build raises with nvcc's output: there is no
fallback to another implementation.

Flags: `-O3 --fmad=false` without `--use_fast_math`, so that the kernels
round like their plain PyTorch versions (no contracted multiply-adds,
IEEE division and square root); `-Xptxas -v` records registers and spills
in `<library>.log` beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]

_loaded: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to under the current sources/flags."""
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{name}.cu:\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_log(name: str) -> str:
    """nvcc/ptxas output of the current build of `name` (registers, spills)."""
    return build(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use. A process
    looks at the sources once per library: a scan launches its kernels
    hundreds of times a step, and hashing the sources on each launch would
    cost more than the launch."""
    if name not in _loaded:
        lib = ctypes.CDLL(str(build(name)))
        lib.mrt_error_string.argtypes = [ctypes.c_int]
        lib.mrt_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


def error_string(lib: ctypes.CDLL, code: int) -> str:
    """CUDA's message for an error code returned by a kernel's C function."""
    return f"CUDA error {code}: {lib.mrt_error_string(code).decode()}"
