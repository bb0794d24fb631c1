"""TensorBoard summary writer, rank-0 gated (counterpart of
``poem_v2_tpu/utils/summary_writer.py``).

Backed by ``torch.utils.tensorboard``; where that cannot import (it needs the
``tensorboard`` package) every method is a no-op, and the first writer says
so once in the log.
"""

from __future__ import annotations

from .logger import get_logger, is_master, master_only

_WARNED = False


class SummaryWriter:
    def __init__(self, log_dir: str):
        global _WARNED
        self.log_dir = log_dir
        self._writer = None
        if not is_master():
            return
        try:
            from torch.utils.tensorboard import SummaryWriter as _TB
        except Exception as e:  # tensorboard missing or broken: summaries are skipped
            if not _WARNED:
                get_logger().info(f"TensorBoard summaries off ({type(e).__name__}: {e})")
                _WARNED = True
            return
        self._writer = _TB(log_dir=log_dir)

    @master_only
    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    @master_only
    def add_image(self, tag: str, img, step: int, dataformats: str = "HWC") -> None:
        if self._writer is not None:
            self._writer.add_image(tag, img, step, dataformats=dataformats)

    @master_only
    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    @master_only
    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
