"""Logging under the port's one logger name (copied from
``blendjax/utils/logging.py``)."""

from __future__ import annotations

import logging

from blendjax_torch.constants import LOGGER_NAME


def get_logger(suffix: str | None = None) -> logging.Logger:
    name = LOGGER_NAME if not suffix else f"{LOGGER_NAME}.{suffix}"
    return logging.getLogger(name)
