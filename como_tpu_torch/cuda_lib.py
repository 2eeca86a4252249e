"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by its own `nvcc` process into a shared library
with a plain C interface (all processes started together), loaded with
ctypes.  The libraries land in como_tpu_torch/_build/<hash>/, keyed by a
hash of the sources and flags, so a checkout builds everything on first
use and reuses it afterwards.  Nothing here runs at import time: the CPU
tests import every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
SOURCES = ("gp_kernels", "sampler_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}
build_info: dict = {}   # seconds, ptxas report per source (filled by build)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((_CSRC / f"{name}.cu").read_bytes())
    return _BUILD / h.hexdigest()[:16]


def build() -> dict:
    """Compile every source (in parallel) unless already built; load the
    libraries.  Returns build_info.  Raises if any compile fails."""
    if len(_libs) == len(SOURCES):
        return build_info
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        so = out / f"lib{name}.so"
        if so.exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, so)
    for name, (p, tmp, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, so)
        build_info.setdefault("ptxas", {})[name] = log.strip()
    build_info["seconds"] = time.perf_counter() - t0
    build_info["compiled"] = sorted(procs)
    for name in SOURCES:
        _libs[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    return build_info


def lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build()
    return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
