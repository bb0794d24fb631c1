"""Profiling hooks (counterpart of ``poem_v2_tpu/utils/profiling.py``): a device
trace of any block through ``torch.profiler`` (a Chrome trace, viewable in
Perfetto or chrome://tracing), and a rolling step timer."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from .logger import logger


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json") -> Iterator[torch.profiler.profile]:
    """Trace the enclosed block's host ops and, where a card is present, its
    kernels; the Chrome trace goes to ``log_dir/name``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, name)
        prof.export_chrome_trace(path)
        logger.info(f"profiler trace written to {path}")


class StepTimer:
    """Rolling throughput / latency tracker for the train loop."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def mean_step_time(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def throughput(self, batch_size: int) -> float:
        st = self.mean_step_time
        return batch_size / st if st else 0.0
