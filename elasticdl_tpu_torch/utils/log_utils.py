"""Cached structured stderr loggers.

A copy of ``elasticdl_tpu/utils/log_utils.py`` (the port imports nothing
of the JAX package); the logger name is the port's own.
"""

from __future__ import annotations

import logging
import sys
import threading

_FORMAT = (
    "[%(asctime)s] [%(levelname)s] "
    "[%(name)s:%(filename)s:%(lineno)d] %(message)s"
)

_lock = threading.Lock()
_loggers: dict[str, logging.Logger] = {}


def get_logger(
    name: str = "elasticdl_tpu_torch", level: str | int | None = None
):
    """Return a cached logger writing the framework format to stderr.

    ``level`` only takes effect when explicitly passed, so a later
    ``get_logger()`` call cannot clobber a configured ``--log_level``.
    """
    with _lock:
        logger = _loggers.get(name)
        if logger is None:
            logger = logging.getLogger(name)
            logger.propagate = False
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter(_FORMAT))
            logger.addHandler(handler)
            logger.setLevel("INFO")
            _loggers[name] = logger
        if level is not None:
            logger.setLevel(level)
        return logger


default_logger = get_logger()
