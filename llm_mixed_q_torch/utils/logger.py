"""Named logger with level control (counterpart of the JAX package's
``utils/logger.py``)."""

from __future__ import annotations

import logging

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO, "warning": logging.WARNING,
           "error": logging.ERROR}


def get_logger(name: str = "llm_mixed_q_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("[%(levelname)s %(name)s] %(message)s"))
        logger.addHandler(handler)
        logger.propagate = False
    return logger


def set_logging_verbosity(level: str = "info", name: str = "llm_mixed_q_torch"):
    get_logger(name).setLevel(_LEVELS[level.lower()])
