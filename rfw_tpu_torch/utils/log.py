"""Logging facade (copy of `rfw_tpu/utils/log.py`; reference
crates/rfw-utils/src/log.rs + env_logger init)."""

from __future__ import annotations

import logging
import os

_INITIALIZED = False


def init(level: str | int | None = None) -> None:
    """Initialise root logging once; level from arg or RFW_LOG env var."""
    global _INITIALIZED
    if _INITIALIZED:
        return
    if level is None:
        level = os.environ.get("RFW_LOG", "WARNING").upper()
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)-7s %(name)s: %(message)s",
        datefmt="%H:%M:%S",
    )
    _INITIALIZED = True


def get(name: str) -> logging.Logger:
    return logging.getLogger(f"rfw_tpu_torch.{name}")
