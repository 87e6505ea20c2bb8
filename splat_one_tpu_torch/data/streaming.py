"""Streaming image store: disk-backed ``SceneData.images`` with prefetch;
the port's own copy of ``splat_one_tpu/data/streaming.py``.

``StreamingImages`` presents the ndarray surface the Trainer reads
(``.shape``, integer and array indexing) while decoding from disk on
demand, with an LRU cache bounding resident memory and ``prefetch()`` so
the next batch decodes while the current step runs on the card (the
Trainer calls it right after each step). The decoder is the native C++
thread pool (``utils.native_loader``: JPEG/PNG decode, bilinear resize,
radial undistortion) where it builds, else PIL on a thread pool;
``backend`` says which ("native" or "pil") and ``native_error`` why the
native one is not used.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np

from splat_one_tpu_torch.utils import native_loader


class StreamingImages:
    """Disk-backed ``[M, H, W, 3]`` float32 image collection."""

    def __init__(
        self,
        paths: Sequence[str],
        width: int,
        height: int,
        Ks: Optional[np.ndarray] = None,  # [M, 3, 3] for undistortion
        dists: Optional[np.ndarray] = None,  # [M, >=2] radial k1,k2
        camera_types: Optional[Sequence[str]] = None,  # per image:
        # "perspective" (Brown radial) or "fisheye" (theta-polynomial);
        # the native loader only implements Brown — fisheye undistorts
        # host-side through data.opensfm.undistort_image
        cache_images: int = 64,
        n_threads: int = 4,
    ):
        self.paths = [os.fspath(p) for p in paths]
        self.width = width
        self.height = height
        self.Ks = Ks
        self.dists = dists
        self.camera_types = camera_types
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._pending: Dict[int, Future] = {}
        self._cap = max(cache_images, 2)
        self._lock = threading.Lock()
        self._native = None
        if native_loader.available():
            self._native = native_loader.NativeImageLoader(n_threads=n_threads)
        self.backend = "pil" if self._native is None else "native"
        self.native_error = native_loader.build_error()
        self._pool = ThreadPoolExecutor(max_workers=n_threads)

    # ---- ndarray-like surface --------------------------------------
    @property
    def shape(self):
        return (len(self.paths), self.height, self.width, 3)

    @property
    def dtype(self):
        return np.float32

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return self._get(int(idx))
        idx = np.asarray(idx)
        self.prefetch(idx)
        return np.stack([self._get(int(i)) for i in idx])

    # ---- loading ----------------------------------------------------
    def _ctype(self, i: int) -> str:
        if self.camera_types is None:
            return "perspective"
        return self.camera_types[i]

    def _needs_undistort(self, i: int) -> bool:
        if self.dists is None:
            return False
        return self._ctype(i) == "fisheye" or bool(
            np.any(np.abs(np.asarray(self.dists[i])[:2]) > 1e-12)
        )

    def _decode(self, i: int) -> np.ndarray:
        brown = self._ctype(i) != "fisheye"
        if self._native is not None:
            # the native remap implements the Brown radial model only;
            # fisheye theta-polynomial coefficients must NOT be fed to it
            K = None if self.Ks is None else self.Ks[i]
            d = self.dists[i] if (self.dists is not None and brown) else (
                None)
            t = self._native.submit(
                self.paths[i], self.width, self.height, K, d
            )
            img = self._native.wait(t)
            if brown or not self._needs_undistort(i):
                return img
        else:
            from PIL import Image

            im = Image.open(self.paths[i]).convert("RGB").resize(
                (self.width, self.height), Image.BILINEAR
            )
            img = np.asarray(im).astype(np.float32) / 255.0
        if self._needs_undistort(i):
            # PIL fallback (any model) or native fisheye: host-side
            # undistortion, same math as the non-streaming path
            from splat_one_tpu_torch.data.opensfm import undistort_image

            img = undistort_image(
                img, np.asarray(self.Ks[i]), np.asarray(self.dists[i]),
                camera_type=self._ctype(i),
            )
        return img

    def _get(self, i: int) -> np.ndarray:
        with self._lock:
            if i in self._cache:
                self._cache.move_to_end(i)
                return self._cache[i]
            fut = self._pending.get(i)
        if fut is None:
            img = self._decode(i)
        else:
            img = fut.result()
        with self._lock:
            self._pending.pop(i, None)
            self._cache[i] = img
            self._cache.move_to_end(i)
            while len(self._cache) > self._cap:
                self._cache.popitem(last=False)
        return img

    def prefetch(self, indices) -> None:
        """Queue background decodes for the given indices (the Trainer
        calls this for the NEXT batch right after dispatching a step)."""
        for i in np.atleast_1d(np.asarray(indices)):
            i = int(i)
            with self._lock:
                if i in self._cache or i in self._pending:
                    continue
                self._pending[i] = self._pool.submit(self._decode, i)

    def astype(self, dtype):  # Trainer._batch compatibility (no-op view)
        assert np.dtype(dtype) == np.float32
        return self

    @property
    def cached_count(self) -> int:
        with self._lock:
            return len(self._cache)
