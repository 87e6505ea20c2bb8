"""PNG splat compression (quantize, Morton-order sort, PNG planes): the
port's own copy of ``splat_one_tpu/train/compression.py`` (host-side
numpy and PIL), so a compressed directory written by either package reads
in the other.

Gaussians are ordered by a Morton (Z-order) code of their positions, so
neighbouring pixels of each plane hold nearby splats and PNG's filters
compress them well. Means are stored as 16 bits (two 8-bit planes) after
per-axis min/max normalization; scales, quats, opacities and sh0 as 8
bits; shN as 8 bits with one global range. Metadata in ``meta.json``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10 bits per axis -> 30-bit Morton code."""
    q = np.clip((x * 1023).astype(np.int64), 0, 1023)

    def split3(a):
        a = (a | (a << 16)) & 0x030000FF
        a = (a | (a << 8)) & 0x0300F00F
        a = (a | (a << 4)) & 0x030C30C3
        a = (a | (a << 2)) & 0x09249249
        return a

    return split3(q[:, 0]) | (split3(q[:, 1]) << 1) | (split3(q[:, 2]) << 2)


def _to_grid(x: np.ndarray, side: int) -> np.ndarray:
    pad = side * side - x.shape[0]
    x = np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
    return x.reshape(side, side, -1)


def _write_png(path: str, arr_u8: np.ndarray):
    from PIL import Image

    if arr_u8.shape[-1] == 1:
        img = Image.fromarray(arr_u8[..., 0], mode="L")
    elif arr_u8.shape[-1] == 3:
        img = Image.fromarray(arr_u8, mode="RGB")
    elif arr_u8.shape[-1] == 4:
        img = Image.fromarray(arr_u8, mode="RGBA")
    else:
        raise ValueError(arr_u8.shape)
    img.save(path, optimize=True)


def _read_png(path: str) -> np.ndarray:
    from PIL import Image

    arr = np.asarray(Image.open(path))
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def compress(
    out_dir: str, params: Dict[str, np.ndarray], alive: np.ndarray
) -> Dict:
    """Write compressed splats to ``out_dir``; returns metadata dict."""
    os.makedirs(out_dir, exist_ok=True)
    alive = np.asarray(alive)
    idx = np.nonzero(alive)[0]
    means = np.asarray(params["means"])[idx]
    lo = means.min(axis=0)
    hi = means.max(axis=0)
    mn = (means - lo) / np.maximum(hi - lo, 1e-12)
    order = np.argsort(_morton3(mn))
    idx = idx[order]
    n = len(idx)
    side = int(np.ceil(np.sqrt(n)))

    meta = {"n": int(n), "side": side, "ranges": {}}

    def quant8(name, x):
        lo_, hi_ = x.min(axis=0), x.max(axis=0)
        meta["ranges"][name] = [lo_.tolist(), hi_.tolist()]
        q = np.clip(
            (x - lo_) / np.maximum(hi_ - lo_, 1e-12) * 255.0, 0, 255
        ).astype(np.uint8)
        return q

    # means: 16-bit as (high, low) byte planes per axis
    mq = np.clip(
        (np.asarray(params["means"])[idx] - lo)
        / np.maximum(hi - lo, 1e-12)
        * 65535.0,
        0,
        65535,
    ).astype(np.uint16)
    meta["ranges"]["means"] = [lo.tolist(), hi.tolist()]
    _write_png(
        os.path.join(out_dir, "means_hi.png"),
        _to_grid((mq >> 8).astype(np.uint8), side),
    )
    _write_png(
        os.path.join(out_dir, "means_lo.png"),
        _to_grid((mq & 0xFF).astype(np.uint8), side),
    )

    if "sh0" not in params:
        raise NotImplementedError(
            "PNG compression covers the SH color path (reference parity: "
            "gsplat PngCompression); app_opt feature/color splats are not "
            "compressible"
        )
    scales = quant8("scales", np.asarray(params["scales"])[idx])
    _write_png(os.path.join(out_dir, "scales.png"), _to_grid(scales, side))
    quats_n = np.asarray(params["quats"])[idx]
    quats_n = quats_n / np.maximum(
        np.linalg.norm(quats_n, axis=-1, keepdims=True), 1e-12
    )
    quats_n *= np.sign(quats_n[:, :1] + 1e-12)
    quats = quant8("quats", quats_n)
    _write_png(os.path.join(out_dir, "quats.png"), _to_grid(quats, side))
    opac = quant8("opacities", np.asarray(params["opacities"])[idx, None])
    _write_png(os.path.join(out_dir, "opacities.png"), _to_grid(opac, side))
    sh0 = quant8(
        "sh0", np.asarray(params["sh0"])[idx].reshape(n, 3)
    )
    _write_png(os.path.join(out_dir, "sh0.png"), _to_grid(sh0, side))
    shn = np.asarray(params["shN"])[idx]
    K1 = shn.shape[1]
    meta["shN_bands"] = int(K1)
    shn = quant8("shN", shn.reshape(n, K1 * 3))
    for b in range(K1):
        _write_png(
            os.path.join(out_dir, f"shN_{b}.png"),
            _to_grid(shn[:, b * 3:(b + 1) * 3], side),
        )
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return meta


def decompress(out_dir: str) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Read compressed splats; returns (params, alive)."""
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    n, side = meta["n"], meta["side"]

    def deq8(name, arr):
        lo, hi = (np.asarray(x, np.float32) for x in meta["ranges"][name])
        return arr.reshape(side * side, -1)[:n] / 255.0 * (hi - lo) + lo

    hi8 = _read_png(os.path.join(out_dir, "means_hi.png"))
    lo8 = _read_png(os.path.join(out_dir, "means_lo.png"))
    mq = (
        hi8.astype(np.uint16) << 8 | lo8.astype(np.uint16)
    ).reshape(side * side, 3)[:n]
    lo, hi = (np.asarray(x, np.float32) for x in meta["ranges"]["means"])
    means = mq.astype(np.float32) / 65535.0 * (hi - lo) + lo

    scales = deq8("scales", _read_png(os.path.join(out_dir, "scales.png")))
    quats = deq8("quats", _read_png(os.path.join(out_dir, "quats.png")))
    opac = deq8(
        "opacities", _read_png(os.path.join(out_dir, "opacities.png"))
    )[:, 0]
    sh0 = deq8("sh0", _read_png(os.path.join(out_dir, "sh0.png")))
    K1 = meta["shN_bands"]
    shn = np.concatenate(
        [
            _read_png(os.path.join(out_dir, f"shN_{b}.png")).reshape(
                side * side, 3
            )[:n]
            for b in range(K1)
        ],
        axis=1,
    ).astype(np.float32)
    lo_s, hi_s = (
        np.asarray(x, np.float32) for x in meta["ranges"]["shN"]
    )
    shn = shn / 255.0 * (hi_s - lo_s) + lo_s
    params = {
        "means": means.astype(np.float32),
        "scales": scales.astype(np.float32),
        "quats": quats.astype(np.float32),
        "opacities": opac.astype(np.float32),
        "sh0": sh0.reshape(n, 1, 3).astype(np.float32),
        "shN": shn.reshape(n, K1, 3).astype(np.float32),
    }
    alive = np.ones(n, bool)
    return params, alive
