"""Logging for salt_tpu_torch (own copy of ``salt_tpu/core/logging.py``;
both packages log through the same named logger).

Replaces the reference's named-logger setup (reference:
common_blocks/utils.py:46-65) with an equivalent stdlib logger.
"""
import logging
import sys

_LOGGER_NAME = "salt-tpu"


def init_logger(level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setLevel(level)
        handler.setFormatter(
            logging.Formatter(fmt="%(asctime)s %(name)s >>> %(message)s",
                              datefmt="%Y-%m-%d %H-%M-%S"))
        logger.addHandler(handler)
    return logger


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)
