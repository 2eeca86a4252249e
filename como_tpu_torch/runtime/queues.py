"""Bounded drop-stale queues for the pipelined runtime (port of
como_tpu/runtime/queues.py).

Backed by the native C++ ring (native/como_runtime.cpp, via ctypes): the
native side moves 64-bit tokens and blocks without holding the
interpreter lock; Python keeps a token -> object registry.  The shared
library is compiled with g++ at first use into como_tpu_torch/_build/
(keyed by a hash of the source and flags), the way cuda_lib builds the
CUDA kernels; nothing is built at import time.  `PyQueue` has the same
semantics in pure Python and is what `make_queue` returns on a host
without a C++ compiler.  Semantics mirror the reference TupleTensorQueue
(como/utils/multiprocessing.py): blocking push with backpressure, pop
with timeout, pop_until_latest that drains and keeps only the newest.

Messages carry tensors by reference: nothing is copied or serialized, so
whatever is pushed must own its storage (see runtime/pipeline.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import logging
import os
import shutil
import subprocess
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Optional

log = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG.parent / "native" / "como_runtime.cpp"
_BUILD = _PKG / "_build"
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_LIB = None
_LIB_LOCK = threading.Lock()
build_info: dict = {}   # seconds, compiled (bool), path (filled by build_native)


def build_native() -> Path:
    """Compile native/como_runtime.cpp unless already built; returns the
    library's path.  Raises if there is no compiler or the compile fails."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    out = _BUILD / f"runtime_{h.hexdigest()[:16]}"
    so = out / "libcomo_runtime.so"
    t0 = time.perf_counter()
    compiled = not so.exists()
    if compiled:
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler: the native queue ring cannot be built")
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / f"libcomo_runtime.{os.getpid()}.tmp.so"
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"{cxx} failed for {_SOURCE.name}:\n{r.stderr}")
        os.replace(tmp, so)
    build_info.update(seconds=time.perf_counter() - t0, compiled=compiled, path=str(so))
    return so


def _load_native():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build_native()))
        lib.crq_create.restype = ctypes.c_void_p
        lib.crq_create.argtypes = [ctypes.c_int]
        lib.crq_push.restype = ctypes.c_int64
        lib.crq_push.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                                 ctypes.c_long]
        lib.crq_pop.restype = ctypes.c_int64
        lib.crq_pop.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.crq_pop_latest.restype = ctypes.c_int64
        lib.crq_pop_latest.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                       ctypes.POINTER(ctypes.c_uint64),
                                       ctypes.POINTER(ctypes.c_int)]
        lib.crq_size.restype = ctypes.c_int
        lib.crq_size.argtypes = [ctypes.c_void_p]
        lib.crq_close.argtypes = [ctypes.c_void_p]
        lib.crq_destroy.argtypes = [ctypes.c_void_p]
        lib.crt_now.restype = ctypes.c_double
        lib.crt_sleep_until.argtypes = [ctypes.c_double]
        _LIB = lib
        return lib


class NativeQueue:
    """Bounded queue of Python objects over the native token ring."""

    def __init__(self, maxsize: int = 8):
        self._lib = _load_native()
        self._h = self._lib.crq_create(maxsize)
        self._maxsize = maxsize
        self._objs: dict[int, Any] = {}
        self._next = itertools.count(1)
        self._reg_lock = threading.Lock()

    def _register(self, obj) -> int:
        with self._reg_lock:
            tok = next(self._next)
            self._objs[tok] = obj
        return tok

    def _resolve(self, tok: int):
        with self._reg_lock:
            return self._objs.pop(tok, None)

    def push(self, obj, block: bool = True, timeout: Optional[float] = None):
        """block=True waits for space (False when closed or timed out);
        block=False on a full queue drops the oldest entry."""
        tok = self._register(obj)
        ms = int(timeout * 1000) if timeout else 0
        r = self._lib.crq_push(self._h, tok, 1 if block else 0, ms)
        if r == -2:  # closed / timed out while full
            self._resolve(tok)
            return False
        if r >= 0:   # drop-stale: release the displaced object
            self._resolve(int(r))
        return True

    def pop(self, timeout: Optional[float] = None):
        ms = -1 if timeout is None else int(timeout * 1000)
        tok = self._lib.crq_pop(self._h, ms)
        return None if tok < 0 else self._resolve(int(tok))

    def pop_until_latest(self, timeout: Optional[float] = None):
        """Drain the queue and return its newest entry (None if empty
        after `timeout`; no wait when timeout is None)."""
        ms = 0 if timeout is None else int(timeout * 1000)
        n = ctypes.c_int(0)
        stale = (ctypes.c_uint64 * self._maxsize)()   # per call: any thread may pop
        tok = self._lib.crq_pop_latest(self._h, ms, stale, ctypes.byref(n))
        for i in range(n.value):
            self._resolve(int(stale[i]))
        return None if tok < 0 else self._resolve(int(tok))

    def qsize(self):
        return self._lib.crq_size(self._h)

    def close(self):
        """Wake every blocked push (-> False) and pop (-> None, once empty)."""
        self._lib.crq_close(self._h)


class PyQueue:
    """Pure-Python queue with identical semantics."""

    def __init__(self, maxsize: int = 8):
        self._dq: deque = deque()
        self._maxsize = maxsize
        self._cv = threading.Condition()
        self._closed = False

    def push(self, obj, block: bool = True, timeout: Optional[float] = None):
        with self._cv:
            if block:
                ok = self._cv.wait_for(
                    lambda: len(self._dq) < self._maxsize or self._closed,
                    timeout or None)
                if self._closed or not ok:
                    return False
            elif len(self._dq) >= self._maxsize:
                self._dq.popleft()  # drop stale
            self._dq.append(obj)
            self._cv.notify_all()
            return True

    def pop(self, timeout: Optional[float] = None):
        with self._cv:
            self._cv.wait_for(lambda: self._dq or self._closed, timeout)
            if not self._dq:
                return None
            out = self._dq.popleft()
            self._cv.notify_all()
            return out

    def pop_until_latest(self, timeout: Optional[float] = None):
        with self._cv:
            if not self._dq and timeout:
                self._cv.wait_for(lambda: self._dq or self._closed, timeout)
            out = None
            while self._dq:
                out = self._dq.popleft()
            if out is not None:
                self._cv.notify_all()
            return out

    def qsize(self):
        with self._cv:
            return len(self._dq)

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()


def make_queue(maxsize: int = 8):
    """A NativeQueue; a PyQueue (with a warning) where the native ring
    cannot be built."""
    try:
        return NativeQueue(maxsize)
    except (RuntimeError, OSError) as e:
        log.warning("native queue ring unavailable (%s); using the Python queue", e)
        return PyQueue(maxsize)


def monotonic_now() -> float:
    """CLOCK_MONOTONIC seconds (time.monotonic()'s clock on Linux)."""
    try:
        return _load_native().crt_now()
    except (RuntimeError, OSError):
        return time.monotonic()


def sleep_until(t_mono: float) -> None:
    """Sleep to an absolute monotonic_now() deadline (no per-frame drift,
    unlike relative sleeps); a past deadline returns at once."""
    try:
        _load_native().crt_sleep_until(t_mono)
    except (RuntimeError, OSError):
        dt = t_mono - time.monotonic()
        if dt > 0:
            time.sleep(dt)
