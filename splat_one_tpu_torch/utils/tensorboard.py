"""Minimal TensorBoard event writer (no tensorflow/tensorboard dependency).

The port's own copy of ``splat_one_tpu/utils/tensorboard.py``: scalar and
PNG image summaries written as TFRecord-framed Event protobufs by hand,
readable by standard TensorBoard. The Trainer writes loss, l1, ssim and
num_GS under ``<result_dir>/tb`` every ``tb_every`` steps.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire-format helpers (just what Event/Summary need)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), masked per the TFRecord spec
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


class SummaryWriter:
    """Drop-in scalar/image writer: ``add_scalar``, ``add_image``, ``flush``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.splat_one_tpu_torch"
        self._f = open(os.path.join(log_dir, fname), "ab")
        # initial file-version event
        self._write_event(
            _double(1, time.time()) + _len_delim(3, b"brain.Event:2")
        )

    def _write_event(self, event_payload: bytes):
        data = event_payload
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int):
        sv = _len_delim(1, tag.encode()) + _float(2, float(value))
        summary = _len_delim(1, sv)  # Summary.value
        event = (
            _double(1, time.time())
            + _int64(2, int(step))
            + _len_delim(5, summary)
        )
        self._write_event(event)

    def add_image(self, tag: str, image: np.ndarray, step: int):
        """image: [H, W, 3] float in [0,1] or uint8."""
        import io

        from PIL import Image as PILImage

        if image.dtype != np.uint8:
            image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        buf = io.BytesIO()
        PILImage.fromarray(image).save(buf, format="PNG")
        img_proto = (
            _int64(1, image.shape[0])
            + _int64(2, image.shape[1])
            + _int64(3, 3)
            + _len_delim(4, buf.getvalue())
        )
        sv = _len_delim(1, tag.encode()) + _len_delim(4, img_proto)
        event = (
            _double(1, time.time())
            + _int64(2, int(step))
            + _len_delim(5, _len_delim(1, sv))
        )
        self._write_event(event)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
