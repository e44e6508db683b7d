"""Logging setup: role-tagged, rotating, with an EVENT level.

The port's copy of ``dvdx_tpu/utils/logging.py``: the same logger
(``dvdx``), format, file names (``<role><index>.log``) and EVENT level (38).
"""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional

EVENT_LEVEL = 38
logging.addLevelName(EVENT_LEVEL, "EVENT")


class RoleFilter(logging.Filter):
    """Tag every record with the neuron role / process index (the per-rank
    filter analog)."""

    def __init__(self, role: str = "main", index: int = 0):
        super().__init__()
        self.role = role
        self.index = index

    def filter(self, record):
        record.role = f"{self.role}{self.index}"
        return True


def setup_logging(role: str = "main", index: int = 0,
                  log_dir: Optional[str] = None,
                  level: int = logging.INFO,
                  rotate_mb: int = 10) -> logging.Logger:
    """Configure the dvdx root logger: stream + optional rotating file, with
    an `.event()`-style channel at level 38 for protocol events."""
    logger = logging.getLogger("dvdx")
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s | %(levelname)-7s | %(role)s | %(name)s | %(message)s")
    filt = RoleFilter(role, index)

    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    sh.addFilter(filt)
    logger.addHandler(sh)

    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, f"{role}{index}.log"),
            maxBytes=rotate_mb * 2**20, backupCount=3)
        fh.setFormatter(fmt)
        fh.addFilter(filt)
        logger.addHandler(fh)
    return logger


def event(logger: logging.Logger, msg: str, *args):
    """Protocol-event log (custom level 38, above WARNING)."""
    logger.log(EVENT_LEVEL, msg, *args)
