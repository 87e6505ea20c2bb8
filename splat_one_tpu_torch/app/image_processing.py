"""Image listing + EXIF GPS/time injection: the port's own copy of
``splat_one_tpu/app/image_processing.py`` without the resize with
originals backup (``resize_images`` / ``restore_originals`` come with the
``resize`` subcommands). ``list_images`` orders every stage;
``apply_image_descriptions`` writes geotags from a Mapillary-style
``image_descriptions.json`` into the workdir exif JSONs.
"""

from __future__ import annotations

import json
import os

class ImageProcessor:
    def __init__(self, workdir: str):
        self.workdir = workdir
        self.images_dir = os.path.join(workdir, "images")

    def list_images(self):
        exts = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")
        if not os.path.isdir(self.images_dir):
            return []
        return sorted(
            f for f in os.listdir(self.images_dir)
            if f.lower().endswith(exts)
        )

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
