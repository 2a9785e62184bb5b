"""Build, load and launch the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library under ``build/kernels/`` at the repository root,
then loaded with ``ctypes``. A library's file name carries a hash of its
source, the shared headers and the flags, so an edited source rebuilds and
an unchanged one is reused. Nothing is built at import time: the first
launch builds what it needs, and ``build_all`` builds every kernel at once
(one ``nvcc`` per source, all started together). Without ``nvcc`` the
build raises; nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gemm", "conv_im2col")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory report) per built library.
BUILD_LOG: Dict[str, str] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else the toolkit PyTorch's extension builder
    finds (``CUDA_HOME``, ``which nvcc``, ``/usr/local/cuda``)."""
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit "
                       "(the CUDA kernels are built from source at first use)")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)              # atomic: readers see whole libraries
    BUILD_LOG[name] = log


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Build every named kernel library that is not built yet, one ``nvcc``
    per source, all running at once. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    nvcc = find_nvcc()
    jobs = {name: _start(name, nvcc) for name in names}
    try:
        for name, job in jobs.items():
            if job is not None:
                _finish(name, job)
    finally:
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return time.perf_counter() - t0


def load_library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


class CudaKernel:
    """One C entry point of a kernel library, with its launch count.

    ``launch`` calls the entry (which enqueues the kernel on the stream it
    is given and returns ``cudaGetLastError()``), raises on a nonzero
    code, and adds one to ``launches`` — the count a run reads to show
    that its path went through the kernel."""

    def __init__(self, source: str, symbol: str,
                 argtypes: Sequence[type]) -> None:
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load_library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: kernel launch failed with "
                               f"CUDA error {err}")
        self.launches += 1
