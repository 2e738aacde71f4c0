"""Logging setup (port of unicorn_tpu/utils/logger.py: stdlib logging,
idempotent per output directory)."""
from __future__ import annotations

import logging
import os
import sys


def setup_logger(output_dir: str | None = None, name: str = "unicorn_torch"):
    """Idempotent per (name, output_dir): repeated calls never duplicate the
    console handler, and a new output_dir gets a file handler of its own
    (train_log.txt), so two trainer runs in one process each get their
    log."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S")
    if not any(isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(output_dir, "train_log.txt"))
        if not any(isinstance(h, logging.FileHandler)
                   and getattr(h, "baseFilename", None) == path
                   for h in logger.handlers):
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
