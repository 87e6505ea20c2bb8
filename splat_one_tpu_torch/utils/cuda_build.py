"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, in ``splat_one_tpu_torch/_build/``
(git-ignored), at first use; the library is loaded with ``ctypes``. The
file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt.
``launch_counts`` holds one count per kernel, raised by each wrapper where
it launches its kernel.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # no mul+add contraction: the kernels round each operation as the
    # plain PyTorch versions do, so the two agree slot for slot
    "--fmad=false",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each kernel's launcher: (argtypes); every launcher
# returns the cudaError_t of its launch as an int.
SIGNATURES = {
    # st_starts, packed, out, cs, sw, sh, tw, st_offset, wrap_x, width,
    # inv_width, term_thresh, stream
    "stream_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P],
    # st_starts, st_starts_al, packed, fwd_out, gout, pgrad, cs, pad_cap, sw,
    # sh, tw, st_offset, wrap_x, width, inv_width, absgrad, stream
    "stream_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
    # rows, perm, bounds, out_index (or NULL), out, m0, n_payload, stream
    "seg_reduce": [_P, _P, _P, _P, _P, _I, _I, _P],
    # rows, cap, m0, cnt_n, tot, list, perm_u, perm, bounds, stream
    "keyed_perm": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    # starts, packed, out, ct, tw, tiles_per_cam, tile_offset, wrap_x, width,
    # inv_width, term_thresh, stream
    "tile_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P],
    # starts, packed, fwd_out, gout, pgrad, ct, align_cap, tw, tiles_per_cam,
    # tile_offset, wrap_x, width, inv_width, stream
    "tile_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    # pbases, offs_pad, sx0, sy0, span, ka, depth, key, g, nb, mp, slab,
    # exp_cap, n, sw, ns, cs, st_lo, wrap, segmented, stream
    "seg_broadcast": [_P] * 9 + [_I] * 11 + [_P],
    # means, quats, scales, opacities, sh (or NULL), alive (or NULL),
    # viewmats, Ks, means2d, conics, depths, radii, colors (or NULL),
    # opacities out, valid, n, c, k, nb, model, antialiased, width, height,
    # near_plane, far_plane, radius_clip, eps2d, stream
    "project_fwd": [_P] * 15 + [_I] * 8 + [_F] * 4 + [_P],
    # sorted_g, means2d, conics, opacities, colors, depths, radii, packed,
    # exp_cap, m0, rows, stream
    "stream_pack": [_P] * 8 + [_I] * 3 + [_P],
    # means, features, colour logits, centre, centre stride, embeds,
    # image id, w0, b0, w1 (or NULL), b1 (or NULL), w_last, b_last, out, n,
    # e, f, nb, stream
    "appearance_fwd": [_P] * 4 + [_I] + [_P] * 9 + [_I] * 4 + [_P],
    # means, quats, scales, opacities, sh, viewmats, Ks, means2d,
    # transforms, depths, boxes, colors, valid, n, c, k, nb, width, height,
    # near_plane, far_plane, stream
    "surfel_project": [_P] * 13 + [_I] * 6 + [_F] * 2 + [_P],
    # sorted_g, means2d, transforms, opacities, colors, depths, packed,
    # exp_cap, m0, rows, stream
    "surfel_pack": [_P] * 7 + [_I] * 3 + [_P],
    # st_starts, packed, out, cs, sw, sh, term_thresh, stream
    "surfel_fwd": [_P, _P, _P, _I, _I, _I, _F, _P],
}

launch_counts: collections.Counter = collections.Counter()
build_log: dict = {}  # name -> {"seconds": float, "ptxas": str}
_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")
    return path


def _target(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha1(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict:
    """Compile the named kernels (default: every ``csrc/*.cu``) that are
    not built yet: one ``nvcc`` per source, all started together. Returns
    ``build_log``. Raises with the compiler's output if a build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, target)
        build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": out}
    return build_log


def load(path, name: str) -> ctypes.CDLL:
    """Load the shared library at ``path`` holding kernel ``name``'s
    launcher and bind its C signature."""
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, name)
    fn.argtypes = SIGNATURES[name]
    fn.restype = ctypes.c_int
    lib.splat_cuda_error_string.argtypes = [ctypes.c_int]
    lib.splat_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = load(_target(name), name)
    return lib


@contextlib.contextmanager
def swapped(name: str, lib: ctypes.CDLL):
    """Within the block, kernel ``name``'s wrapper launches ``lib`` (another
    build of the same launcher, from ``load``) in place of its own."""
    with _lock:
        saved = _libs.get(name)
        _libs[name] = lib
    try:
        yield
    finally:
        with _lock:
            if saved is None:
                _libs.pop(name, None)
            else:
                _libs[name] = saved


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        msg = lib.splat_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")
