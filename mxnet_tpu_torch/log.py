"""Logging setup (ref: python/mxnet/log.py; a copy of the JAX package's
``log.py``)."""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "getLogger", "DEBUG", "INFO", "WARNING", "ERROR",
           "NOTSET"]

DEBUG = logging.DEBUG
INFO = logging.INFO
WARNING = logging.WARNING
ERROR = logging.ERROR
NOTSET = logging.NOTSET

_LOG_FMT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
_DATE_FMT = "%m%d %H:%M:%S"


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """(ref: log.py getLogger)"""
    logger = logging.getLogger(name)
    if getattr(logger, "_init_done", False):
        logger.setLevel(level)
        return logger
    logger._init_done = True
    if filename:
        mode = filemode if filemode else "a"
        hdlr = logging.FileHandler(filename, mode)
    else:
        hdlr = logging.StreamHandler(sys.stderr)
    hdlr.setFormatter(logging.Formatter(_LOG_FMT, _DATE_FMT))
    logger.addHandler(hdlr)
    logger.setLevel(level)
    return logger


getLogger = get_logger
