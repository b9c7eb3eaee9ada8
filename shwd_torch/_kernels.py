"""Build the package's native libraries at first use and load them via ctypes.

Each source has a plain C interface and is compiled by one compiler call
into ``_build/lib<name>-<hash>.so`` (the hash is the source's, so an edited
source never loads a stale library): the CUDA kernels ``csrc/<name>.cu``
with ``nvcc`` for sm_90a, the host network simplex
``runtime/emd/network_simplex.cpp`` with ``g++``. ``build_all`` starts one
``nvcc`` per kernel source at once. Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("emd2_warmup", "auction", "sinkhorn_points", "chamfer",  # CUDA kernels
           "residual_chain", "sinkhorn_warm")
_HOST_SOURCES = {"network_simplex": _PKG / "runtime" / "emd" / "network_simplex.cpp"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source(name: str) -> Path:
    return _HOST_SOURCES.get(name, CSRC / f"{name}.cu")


def lib_path(name: str) -> Path:
    digest = hashlib.sha1(_source(name).read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start the compiler for one source; returns (process, tmp path,
    final path) or None when the library is already built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    src = _source(name)
    compiler = ([_nvcc(), *NVCC_FLAGS] if src.suffix == ".cu"
                else ["g++", *CXX_FLAGS])
    cmd = [*compiler, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {_source(name).name} failed:\n{log}")
    os.replace(tmp, out)          # atomic: concurrent builders never see half a file


def build_all(names=SOURCES) -> None:
    """Compile every CUDA kernel source in parallel (one nvcc each)."""
    with _lock:
        started = {n: _start_build(n) for n in names}
        for n, s in started.items():
            _finish_build(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish_build(name, _start_build(name))
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib


def stream_ptr(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device, as a C pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
