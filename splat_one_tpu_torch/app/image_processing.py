"""Image listing, resizing with backup/restore, EXIF GPS/time injection:
the port's own copy of ``splat_one_tpu/app/image_processing.py`` (PIL on
the host; no tensor). ``list_images`` orders every stage;
``resize_images`` moves the originals to ``images_org/`` (restorable by
``restore_originals``); ``apply_image_descriptions`` writes geotags from a
Mapillary-style ``image_descriptions.json`` into the workdir exif JSONs.
"""

from __future__ import annotations

import json
import os
import shutil


class ImageProcessor:
    def __init__(self, workdir: str):
        self.workdir = workdir
        self.images_dir = os.path.join(workdir, "images")
        self.backup_dir = os.path.join(workdir, "images_org")

    def list_images(self):
        exts = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")
        if not os.path.isdir(self.images_dir):
            return []
        return sorted(
            f for f in os.listdir(self.images_dir)
            if f.lower().endswith(exts)
        )

    # ---- resize with originals backup (reference :92-150) ------------
    def resize_images(self, max_dimension: int) -> int:
        from PIL import Image

        if not os.path.isdir(self.backup_dir):
            os.makedirs(self.backup_dir, exist_ok=True)
            for f in self.list_images():
                shutil.copy2(
                    os.path.join(self.images_dir, f),
                    os.path.join(self.backup_dir, f),
                )
        n = 0
        for f in self.list_images():
            path = os.path.join(self.images_dir, f)
            img = Image.open(path)
            w, h = img.size
            m = max(w, h)
            if m <= max_dimension:
                continue
            s = max_dimension / m
            img = img.resize(
                (int(w * s), int(h * s)), Image.LANCZOS
            )
            # keep EXIF (focal/GPS/orientation feed the SfM stages) and
            # avoid recompressing JPEGs at PIL's default quality 75
            kw = {}
            if "exif" in img.info:
                kw["exif"] = img.info["exif"]
            if path.lower().endswith((".jpg", ".jpeg")):
                kw["quality"] = 95
            img.save(path, **kw)
            n += 1
        return n

    def restore_originals(self) -> int:
        if not os.path.isdir(self.backup_dir):
            return 0
        n = 0
        for f in os.listdir(self.backup_dir):
            shutil.copy2(
                os.path.join(self.backup_dir, f),
                os.path.join(self.images_dir, f),
            )
            n += 1
        shutil.rmtree(self.backup_dir)
        return n

    # ---- mapillary-style geotag injection (reference :182-268) -------
    def apply_image_descriptions(
        self, descriptions_path: str
    ) -> int:
        """Inject lat/lon/altitude/capture-time from a mapillary_tools
        ``image_descriptions.json`` into the workdir exif JSONs."""
        with open(descriptions_path) as f:
            desc = json.load(f)
        exif_dir = os.path.join(self.workdir, "exif")
        os.makedirs(exif_dir, exist_ok=True)
        n = 0
        for item in desc:
            name = os.path.basename(item.get("filename", ""))
            path = os.path.join(exif_dir, name + ".exif")
            exif = {}
            if os.path.exists(path):
                with open(path) as f:
                    exif = json.load(f)
            gps = exif.setdefault("gps", {})
            if "MAPLatitude" in item:
                gps["latitude"] = item["MAPLatitude"]
                gps["longitude"] = item["MAPLongitude"]
            if "MAPAltitude" in item:
                gps["altitude"] = item["MAPAltitude"]
            if "MAPCaptureTime" in item:
                import time as _t

                try:
                    exif["capture_time"] = _t.mktime(
                        _t.strptime(
                            item["MAPCaptureTime"], "%Y_%m_%d_%H_%M_%S_%f"
                        )
                    )
                except ValueError:
                    pass
            with open(path, "w") as f:
                json.dump(exif, f, indent=2)
            n += 1
        return n
