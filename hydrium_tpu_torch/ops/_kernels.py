"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

The sources have a plain C interface, so they are compiled with nvcc
(one process per source, all started together, then one link) into one
shared library and bound with ctypes: seconds to build, where a PyTorch
C++ extension takes minutes.  The library lands in
build/torch_kernels/lib<hash>.so (hash of the sources and flags), is
built on first use and reused after that.  Nothing here runs at import
time, so the package imports on machines without nvcc or a card.

Every entry point takes device pointers and the CUDA stream as void*
and returns cudaGetLastError() after its launch; `check` raises on a
non-zero code (a refused launch never runs, and a later synchronize
would not report it).
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

import torch

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return path


def sources():
    return sorted(_SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the kernels if the library for these sources is missing;
    returns the seconds spent (0 when it was already built)."""
    so = library_path()
    if so.exists():
        return 0.0
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc, srcs = _nvcc(), sources()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{src.stem}.o") for src in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                                   str(src)], stderr=subprocess.PIPE,
                                  text=True)
                 for src, obj in zip(srcs, objs)]
        errors = [f"{src.name}:\n{p.communicate()[1]}"
                  for src, p in zip(srcs, procs)]
        errors = [e for e, p in zip(errors, procs) if p.returncode != 0]
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib_tmp = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp,
                              *objs], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(lib_tmp, so)
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        build()
        L = ctypes.CDLL(str(library_path()))
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        L.hyd_transport_prep.restype = I
        L.hyd_transport_prep.argtypes = [P] * 7 + [I, LL, I] + [P] * 7
        L.hyd_chunk_pack.restype = I
        L.hyd_chunk_pack.argtypes = [P, P, LL, I, I, P, P] * 2 + [P]
        L.hyd_frontend.restype = I
        L.hyd_frontend.argtypes = [P] + [I] * 7 + [ctypes.c_float, I] \
            + [P, P, I, P, P, P, I] + [P] * 6
        _lib = L
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of tensor t's device, as an int."""
    return torch.cuda.current_stream(t.device).cuda_stream
