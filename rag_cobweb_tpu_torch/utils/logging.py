"""Structured logging (port of ``rag_cobweb_tpu/utils/logging.py``): a
console logger, optionally also writing a file, configured once per
name."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = "rag_cobweb_tpu_torch",
               level: Optional[str] = None,
               log_file: Optional[str] = None) -> logging.Logger:
    """Console (+ optional file) logger; level from the argument or the
    ``RAG_COBWEB_TPU_LOG`` environment variable (default INFO), the
    variable the JAX package reads.  Idempotent per name."""
    logger = logging.getLogger(name)
    if getattr(logger, "_rct_configured", False):
        return logger
    level = level or os.environ.get("RAG_COBWEB_TPU_LOG", "INFO")
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    logger.propagate = False
    logger._rct_configured = True
    return logger
