"""Camera-model management: base models + user overrides -> per-image
EXIF. The port's own copy of ``splat_one_tpu/app/camera_models.py``:
``camera_models.json`` holds extracted models,
``camera_models_overrides.json`` the user's edits; ``propagate_to_exif``
writes the merged focal, distortion and projection into every image's
``exif/*.exif``.
"""

from __future__ import annotations

import json
import os
from typing import Dict


class CameraModelManager:
    def __init__(self, workdir: str):
        self.workdir = workdir
        self.models_path = os.path.join(workdir, "camera_models.json")
        self.overrides_path = os.path.join(
            workdir, "camera_models_overrides.json"
        )
        self.models: Dict[str, Dict] = {}
        self.overrides: Dict[str, Dict] = {}
        self.load()

    # ---- persistence -------------------------------------------------
    def load(self):
        if os.path.exists(self.models_path):
            with open(self.models_path) as f:
                self.models = json.load(f)
        if os.path.exists(self.overrides_path):
            with open(self.overrides_path) as f:
                self.overrides = json.load(f)

    def save(self):
        with open(self.models_path, "w") as f:
            json.dump(self.models, f, indent=2)
        with open(self.overrides_path, "w") as f:
            json.dump(self.overrides, f, indent=2)

    # ---- merge semantics (reference :240-294) ------------------------
    def merged(self) -> Dict[str, Dict]:
        out = {k: dict(v) for k, v in self.models.items()}
        for cam, ov in self.overrides.items():
            if cam in out:
                out[cam].update(ov)
            else:
                out[cam] = dict(ov)
        return out

    def set_override(self, camera: str, **fields):
        ov = self.overrides.setdefault(camera, {})
        ov.update(fields)

    def clear_override(self, camera: str):
        self.overrides.pop(camera, None)

    # ---- EXIF propagation (reference :161-222) -----------------------
    def propagate_to_exif(self):
        """Write merged camera parameters into each image's exif JSON:
        focal/k1/k2/projection_type are updated for images whose camera
        matches an overridden model."""
        exif_dir = os.path.join(self.workdir, "exif")
        if not os.path.isdir(exif_dir):
            return 0
        merged = self.merged()
        n = 0
        for fn in os.listdir(exif_dir):
            if not fn.endswith(".exif"):
                continue
            path = os.path.join(exif_dir, fn)
            with open(path) as f:
                exif = json.load(f)
            cam = exif.get("camera_id")
            if cam not in merged:
                continue
            m = merged[cam]
            changed = False
            if "focal" in m and exif.get("focal_ratio") != m["focal"]:
                exif["focal_ratio"] = m["focal"]
                changed = True
            for k in ("k1", "k2", "projection_type"):
                if k in m and exif.get(k) != m[k]:
                    exif[k] = m[k]
                    changed = True
            if changed:
                with open(path, "w") as f:
                    json.dump(exif, f, indent=2)
                n += 1
        return n
