"""Stdlib logger with the reference's colored format and a log.txt file sink,
port of ``mapdit_tpu/utils/logging.py``: verbose 0/1/2 -> WARNING/INFO/DEBUG."""

from __future__ import annotations

import logging
import os
from typing import Optional


def create_logger(logging_dir: Optional[str] = None, verbose: int = 1) -> logging.Logger:
    level = {0: logging.WARNING, 1: logging.INFO, 2: logging.DEBUG}.get(verbose, logging.INFO)
    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if logging_dir is not None:
        handlers.append(logging.FileHandler(os.path.join(logging_dir, "log.txt")))
    logging.basicConfig(
        level=level,
        format="[\033[34m%(asctime)s\033[0m] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
        handlers=handlers,
        force=True,
    )
    return logging.getLogger("mapdit_tpu_torch")
