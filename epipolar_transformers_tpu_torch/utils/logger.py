"""Per-name stdout + file loggers (reference utils/logger.py:6-25).

The port's own copy of epipolar_transformers_tpu/utils/logger.py."""

from __future__ import annotations

import logging
import os
import sys


def setup_logger(name: str, save_dir: str = "", filename: str = "log.txt"):
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.DEBUG)
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, filename))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
