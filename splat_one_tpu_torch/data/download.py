"""Benchmark-dataset downloader: the port's copy of
``splat_one_tpu/data/download.py`` (reference
utils/datasets/download_dataset.py: mipnerf360 / bilarf / zipnerf; here
argparse + urllib). ``download`` fetches each archive that ``save_dir``
does not hold yet and unpacks it there; it needs network access.
"""

from __future__ import annotations

import argparse
import os
import zipfile

DATASETS = {
    "mipnerf360": [
        "http://storage.googleapis.com/gresearch/refraw360/360_v2.zip",
        "https://storage.googleapis.com/gresearch/refraw360/360_extra_scenes.zip",
    ],
    "bilarf": [
        "https://huggingface.co/datasets/Yuehao/bilarf_data/resolve/main/bilarf_data.zip"
    ],
    "zipnerf": [
        f"https://storage.googleapis.com/gresearch/refraw360/zipnerf/{s}.zip"
        for s in ("berlin", "london", "nyc", "alameda")
    ],
}


def download(dataset: str, save_dir: str):
    import urllib.request

    os.makedirs(save_dir, exist_ok=True)
    for url in DATASETS[dataset]:
        name = os.path.basename(url)
        dst = os.path.join(save_dir, name)
        if not os.path.exists(dst):
            print(f"downloading {url}")
            urllib.request.urlretrieve(url, dst)
        with zipfile.ZipFile(dst) as z:
            z.extractall(save_dir)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("dataset", choices=sorted(DATASETS))
    p.add_argument("--save-dir", default="data")
    a = p.parse_args()
    download(a.dataset, a.save_dir)


if __name__ == "__main__":
    main()
