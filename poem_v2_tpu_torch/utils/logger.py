"""Rank-0-gated logging (counterpart of ``poem_v2_tpu/utils/logger.py``).

One logger, ``poem_tpu``, to stdout and optionally a file; other ranks of a
``torch.distributed`` group log errors only, and :func:`master_only`
functions run on rank 0 alone.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_LOGGER: Optional[logging.Logger] = None

_FMT = "%(asctime)s | %(levelname)-7s | %(name)s | %(message)s"


def is_master() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def get_logger(name: str = "poem_tpu", log_file: Optional[str] = None) -> logging.Logger:
    global _LOGGER
    if _LOGGER is not None and log_file is None:
        return _LOGGER
    lg = logging.getLogger(name)
    lg.setLevel(logging.INFO)
    lg.propagate = False
    if not lg.handlers:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter(_FMT))
        lg.addHandler(sh)
    if log_file is not None:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FMT))
        lg.addHandler(fh)
    if not is_master():
        lg.setLevel(logging.ERROR)
    _LOGGER = lg
    return lg


class _Proxy:
    """Lazy logger proxy so ``from ... import logger`` works before setup."""

    def __getattr__(self, item):
        return getattr(get_logger(), item)


logger = _Proxy()


def master_only(fn):
    """Decorator: run only on rank 0."""

    def wrapper(*args, **kwargs):
        if is_master():
            return fn(*args, **kwargs)
        return None

    return wrapper
