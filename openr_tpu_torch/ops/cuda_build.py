"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each source under `openr_tpu_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into a shared library with a plain C interface, at first use,
into `openr_tpu_torch/_build/`. The file name carries a hash of the
source and the flags, so an edited source never loads a stale library.
Nothing here falls back: a missing `nvcc` or a failed build raises.

The route is nvcc + ctypes rather than `torch.utils.cpp_extension.load`
because a source that includes PyTorch's headers takes minutes to
compile, a plain C interface seconds, and every run on a fresh machine
builds anew.

The libraries are loaded as `ctypes.PyDLL`, whose calls keep the GIL:
every entry point only enqueues work on a stream (or reads a device
attribute) and never waits for the card, so a call is a few
microseconds. Through `ctypes.CDLL` each launch would release the GIL
and take it back; with other Python threads busy (the rebuild workers
of many nodes' Decisions in one process) taking it back costs up to the
interpreter's switch interval, for each of the hundreds of launches of
a solve.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from openr_tpu_torch.monitor import compile_ledger

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_LIBS: dict[str, ctypes.PyDLL] = {}
#: the library file each loaded source came from (the build ledger,
#: `monitor/compile_ledger.py`, counts builds with their seconds and
#: loads per source)
_PATHS: dict[str, Path] = {}


def find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", "") and os.path.join(
            os.environ["CUDA_HOME"], "bin", "nvcc"
        ),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of openr_tpu_torch are built from source at first use"
    )


def _lib_path(name: str, src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` (if not built yet); returns the path."""
    src = CSRC_DIR / f"{name}.cu"
    out = _lib_path(name, src)
    if out.exists():
        compile_ledger.record_load(name)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {src.name} (rc={res.returncode}):\n"
            f"{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    compile_ledger.record_build(name, time.perf_counter() - t0)
    return out


def load(name: str) -> ctypes.PyDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use; its
    calls hold the GIL (see the module docstring)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build(name)
        lib = ctypes.PyDLL(str(path))
        _LIBS[name] = lib
        _PATHS[name] = path
    return lib


def library_bytes(name: str) -> int:
    """Size of the loaded library of `csrc/<name>.cu`, 0 if none is
    loaded in this process."""
    path = _PATHS.get(name)
    return path.stat().st_size if path is not None else 0
