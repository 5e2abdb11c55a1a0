"""ctypes bindings for the native threaded image loader.

Builds ``libofloader.so`` on first use (``make -C optflow/native``) and
exposes :class:`NativeLoader`. Falls back gracefully: callers check
:func:`available` and use the Python loader otherwise.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libofloader.so")
_lib = None
_build_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO):
            try:
                subprocess.run(
                    ["make", "-C", _DIR],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except (subprocess.SubprocessError, OSError):
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.ofl_create.restype = ctypes.c_void_p
        lib.ofl_create.argtypes = [ctypes.c_int]
        lib.ofl_submit.restype = ctypes.c_int
        lib.ofl_submit.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.c_float,
        ]
        lib.ofl_wait_meta.restype = ctypes.c_int
        lib.ofl_wait_meta.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.ofl_fetch.restype = ctypes.c_int
        lib.ofl_fetch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.ofl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeLoader:
    """Threaded decode+resize with async submit/wait."""

    def __init__(self, n_threads: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._h = lib.ofl_create(n_threads)
        self._next_id = 0
        self._lock = threading.Lock()

    def submit(self, path: str, scale: float) -> int:
        with self._lock:
            job_id = self._next_id
            self._next_id += 1
        self._lib.ofl_submit(
            self._h, job_id, path.encode("utf-8"), float(scale)
        )
        return job_id

    def wait(self, job_id: int) -> np.ndarray:
        """Block for a submitted job; returns float32 (H, W) or raises."""
        h = ctypes.c_int()
        w = ctypes.c_int()
        rc = self._lib.ofl_wait_meta(
            self._h, job_id, ctypes.byref(h), ctypes.byref(w)
        )
        if rc != 0:
            from optflow.core.imgio import ImageReadError

            raise ImageReadError(f"native decode failed (job {job_id})")
        out = np.empty((h.value, w.value), np.float32)
        rc = self._lib.ofl_fetch(
            self._h, job_id, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )
        if rc != 0:  # pragma: no cover
            from optflow.core.imgio import ImageReadError

            raise ImageReadError(f"native fetch failed (job {job_id})")
        return out

    def load(self, path: str, scale: float) -> np.ndarray:
        return self.wait(self.submit(path, scale))

    def close(self):
        if self._h:
            self._lib.ofl_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
