"""ctypes binding and on-demand build of the native C++ image loader: the
port's own copy of ``splat_one_tpu/utils/native_loader.py``.

``native/loader.cpp`` (at the repository root, outside both packages) is
a C++ thread pool doing JPEG/PNG decode (libjpeg, libpng), bilinear
resize, radial undistortion and float conversion behind a plain C ABI.
The port compiles it with ``g++`` into its git-ignored
``splat_one_tpu_torch/_build/`` (never into ``native/``): the file name
carries a hash of the source and the command, and the library is written
to a temporary file first and renamed into place, so processes building
at once never load a half-written file.

Where the toolchain or the libraries are missing the build fails,
``available()`` is False and ``build_error()`` says why; callers
(``data.streaming``) then decode with PIL and say so.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SRC = PKG_DIR.parent / "native" / "loader.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-ljpeg", "-lpng", "-lpthread"]

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None


def _target() -> Path:
    digest = hashlib.sha1(SRC.read_bytes()
                          + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libsplatloader-{digest}.so"


def _build() -> Path:
    """The built library's path; compiles it first if needed. Raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    if not SRC.exists():
        raise RuntimeError(f"native loader source {SRC} not found")
    target = _target()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC), *LIBS],
                                  capture_output=True, text=True, timeout=120)
        except (FileNotFoundError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"g++ did not run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stderr.strip()}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return target


def get_lib():
    """Build (once a process) and load the library; None if it cannot be
    built or loaded (``build_error()`` says why)."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (RuntimeError, OSError) as e:
            _error = str(e)
            return None
        lib.loader_create.argtypes = [ctypes.c_int]
        lib.loader_create.restype = ctypes.c_int
        lib.loader_destroy.argtypes = [ctypes.c_int]
        lib.loader_submit.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.loader_submit.restype = ctypes.c_int
        lib.loader_wait.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.loader_wait.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (None if it loaded or was not tried)."""
    return _error


class NativeImageLoader:
    """Threaded prefetching image loader.

    ``submit`` queues a decode + resize (+ undistort) into a float32
    ``[H, W, 3]`` buffer; ``wait`` blocks for it."""

    def __init__(self, n_threads: int = 4):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError(f"native loader unavailable: {_error}")
        self._id = self._lib.loader_create(n_threads)
        self._bufs = {}

    def submit(self, path: str, out_w: int, out_h: int,
               K: Optional[np.ndarray] = None,
               dist: Optional[np.ndarray] = None) -> int:
        buf = np.empty((out_h, out_w, 3), np.float32)
        fx = fy = cx = cy = k1 = k2 = 0.0
        if K is not None and dist is not None and np.any(np.abs(dist[:2]) > 1e-12):
            fx, fy = float(K[0, 0]), float(K[1, 1])
            cx, cy = float(K[0, 2]), float(K[1, 2])
            k1, k2 = float(dist[0]), float(dist[1])
        ticket = self._lib.loader_submit(
            self._id, path.encode(), out_w, out_h, fx, fy, cx, cy, k1, k2,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        self._bufs[ticket] = buf
        return ticket

    def wait(self, ticket: int) -> np.ndarray:
        ok = self._lib.loader_wait(self._id, ticket)
        buf = self._bufs.pop(ticket)
        if not ok:
            raise IOError(f"native decode failed (ticket {ticket})")
        return buf

    def load_batch(self, paths, out_w, out_h, Ks=None, dists=None):
        tickets = [self.submit(p, out_w, out_h, None if Ks is None else Ks[i],
                               None if dists is None else dists[i])
                   for i, p in enumerate(paths)]
        return np.stack([self.wait(t) for t in tickets])

    def close(self):
        if self._id is not None:
            self._lib.loader_destroy(self._id)
            self._id = None

    def __del__(self):
        if getattr(self, "_id", None) is not None:
            self.close()
