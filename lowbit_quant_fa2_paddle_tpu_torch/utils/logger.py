"""File+console logger with the reference's rename-on-success convention
(reference utils/logger_util.py:6-79)."""

from __future__ import annotations

import functools
import logging
import os
import sys
from typing import Optional


class Logger:
    """Console + optional file logger (reference ``Logger``,
    utils/logger_util.py:6-43)."""

    def __init__(self, name: str = "lowbit_fa", log_file: Optional[str] = None,
                 level: int = logging.INFO):
        self.logger = logging.getLogger(name)
        self.logger.setLevel(level)
        self.logger.handlers.clear()
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        self.logger.addHandler(sh)
        self.log_file = log_file
        if log_file:
            os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            self.logger.addHandler(fh)

    def info(self, msg, *a):
        self.logger.info(msg, *a)

    def warning(self, msg, *a):
        self.logger.warning(msg, *a)

    def error(self, msg, *a):
        self.logger.error(msg, *a)


def eval_log(log_file: str):
    """Decorator: run fn logging to ``log_file``; on success rename the log
    with an ``_eval_`` prefix — the reference's success-marker convention
    (utils/logger_util.py:59-79)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            logger = Logger(fn.__name__, log_file)
            result = fn(*args, logger=logger, **kwargs)
            d, base = os.path.split(log_file)
            ok_path = os.path.join(d, f"_eval_{base}")
            for h in logger.logger.handlers:
                h.close()
            if os.path.exists(log_file):
                os.replace(log_file, ok_path)
            return result

        return wrapper

    return deco
