"""EXIF extraction -> per-image metadata + camera-model bootstrap: the
port's own copy of ``splat_one_tpu/app/exif.py`` (PIL's EXIF reader; no
device work). Focal length from FocalLengthIn35mmFilm (or FocalLength and a
1/2.3" sensor guess); GPS tags become lat/lon/altitude; unknown cameras get
the 0.85 normalized focal prior.
"""

from __future__ import annotations

from typing import Dict


def _rational(v):
    try:
        return float(v)
    except TypeError:
        return float(v[0]) / float(v[1])


def _dms_to_deg(dms, ref):
    deg = _rational(dms[0]) + _rational(dms[1]) / 60 + _rational(dms[2]) / 3600
    if ref in ("S", "W"):
        deg = -deg
    return deg


def extract_exif(image_path: str) -> Dict:
    """Extract the metadata fields the pipeline consumes."""
    from PIL import ExifTags, Image

    img = Image.open(image_path)
    width, height = img.size
    out: Dict = {
        "width": width,
        "height": height,
        "camera": "unknown",
        "make": "", "model": "",
        "projection_type": "perspective",
        "focal_ratio": 0.85,  # OpenSfM default prior
        "capture_time": 0.0,
        "gps": {},
        "orientation": 1,
    }
    try:
        raw = img._getexif() or {}
    except Exception:
        raw = {}
    tags = {ExifTags.TAGS.get(k, k): v for k, v in raw.items()}
    make = str(tags.get("Make", "")).strip()
    model = str(tags.get("Model", "")).strip()
    out["make"], out["model"] = make, model
    out["camera"] = f"{make} {model}".strip() or "unknown"
    out["orientation"] = int(tags.get("Orientation", 1) or 1)
    f35 = tags.get("FocalLengthIn35mmFilm")
    if f35:
        out["focal_ratio"] = float(f35) / 36.0
    elif tags.get("FocalLength"):
        # assume 1/2.3" sensor (6.17 mm) when sensor size is unknown
        out["focal_ratio"] = _rational(tags["FocalLength"]) / 6.17
    if tags.get("DateTimeOriginal"):
        import time as _t

        try:
            out["capture_time"] = _t.mktime(
                _t.strptime(
                    str(tags["DateTimeOriginal"]), "%Y:%m:%d %H:%M:%S"
                )
            )
        except ValueError:
            pass
    gps_raw = tags.get("GPSInfo")
    if gps_raw:
        g = {ExifTags.GPSTAGS.get(k, k): v for k, v in gps_raw.items()}
        try:
            if "GPSLatitude" in g:
                out["gps"]["latitude"] = _dms_to_deg(
                    g["GPSLatitude"], g.get("GPSLatitudeRef", "N")
                )
                out["gps"]["longitude"] = _dms_to_deg(
                    g["GPSLongitude"], g.get("GPSLongitudeRef", "E")
                )
                alt = g.get("GPSAltitude")
                out["gps"]["altitude"] = _rational(alt) if alt else 0.0
        except Exception:
            out["gps"] = {}
    # equirectangular detection: 2:1 aspect is the convention
    if width == 2 * height:
        out["projection_type"] = "spherical"
    return out


def camera_id_from_exif(exif: Dict) -> str:
    """Stable camera-model key (OpenSfM-style naming)."""
    if exif["projection_type"] == "spherical":
        return f"v2 {exif['camera']} {exif['width']} {exif['height']} spherical"
    return (
        f"v2 {exif['camera']} {exif['width']} {exif['height']} perspective "
        f"{exif['focal_ratio']:.4f}"
    )


def default_camera_model(exif: Dict) -> Dict:
    if exif["projection_type"] == "spherical":
        return {
            "projection_type": "spherical",
            "width": exif["width"],
            "height": exif["height"],
        }
    return {
        "projection_type": "perspective",
        "width": exif["width"],
        "height": exif["height"],
        "focal": exif["focal_ratio"],
        "k1": 0.0,
        "k2": 0.0,
    }
