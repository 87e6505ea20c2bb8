"""File + console logging: the port's copy of ``splat_one_tpu/utils/logger.py``
(stdlib logging into ``<workdir>/logs/app.log``)."""

from __future__ import annotations

import logging
import os


def setup_logger(workdir: str = ".", name: str = "splat_one_tpu_torch"):
    # key the logger by workdir: a second call with a different workdir
    # must not silently keep appending to the first one's file
    logger = logging.getLogger(f"{name}@{os.path.abspath(workdir)}")
    if logger.handlers:
        return logger
    log_dir = os.path.join(workdir, "logs")
    os.makedirs(log_dir, exist_ok=True)
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "%(asctime)s | %(levelname)s | %(name)s | %(message)s"
    )
    fh = logging.FileHandler(os.path.join(log_dir, "app.log"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger
