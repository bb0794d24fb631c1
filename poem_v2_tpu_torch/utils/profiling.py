"""Profiling (counterpart of ``poem_v2_tpu/utils/profiling.py``): a device trace
of any block through ``torch.profiler`` (a Chrome trace, viewable in Perfetto or
chrome://tracing), and the program's own spans and counters.

Spans and counters
------------------
``with span("forward"):`` brackets a stage of the program. Each span, when it
closes, appends one :class:`SpanRecord` to a process-wide ring of
:data:`RING_SIZE` records: its request id, its name, its parent's name, its
thread, its start and end on the profiler's clock (unix ns, ``time.time_ns``) and
whether the host was waiting on the device inside it (``wait``). The serving
path opens the root span ``request`` (``span("request", request=True)``), which
draws a new request id for every span opened under it on its thread; spans outside
a request (the model's build, training) carry none. While a ``torch.profiler``
profile is collecting, a span also opens ``record_function("poem.<name>")``, so
the stages show in :func:`trace`'s Chrome trace; otherwise a span costs two clock
reads, the flag check and one append.

``with sync_point("readback", device, n):`` brackets a place where the host blocks
on the device (``n`` blocking copies or reads): a ``wait`` span that, on a CUDA
device, also adds ``n`` to the open request's ``host_syncs``. ``count(name, n)``
adds to a counter of the open request (its root record's ``counts``); outside a
request nothing is counted. ``spans()`` returns a copy of the ring,
``counters()`` the sum of the counts of the requests it holds; ``reset()``
empties it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from .logger import logger

RING_SIZE = 1 << 16  # a 30 s window of B1 requests at ~20 spans each, many times over


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json") -> Iterator[torch.profiler.profile]:
    """Trace the enclosed block's host ops and, where a card is present, its
    kernels; the Chrome trace goes to ``log_dir/name``. The program's spans
    show as ``poem.<name>`` ranges."""
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


class SpanRecord(NamedTuple):
    request: Optional[int]    # the request id, None outside a request
    name: str
    parent: Optional[str]     # the enclosing span's name on the same thread
    thread: int
    start_ns: int             # unix ns, the clock torch.profiler's events are given in
    end_ns: int
    wait: bool                # the host was blocked on the device inside it
    counts: Optional[Dict[str, int]]  # a request root's counter increments, else None


class _Thread:
    """One thread's open spans and open request."""

    __slots__ = ("stack", "request", "counts", "ident")

    def __init__(self):
        self.stack: List[str] = []                   # names of the open spans
        self.request: Optional[int] = None           # the open request's id
        self.counts: Optional[Dict[str, int]] = None  # the open request's counter increments
        self.ident = threading.get_ident()


_RING: collections.deque = collections.deque(maxlen=RING_SIZE)
_REQUEST_IDS = itertools.count(1)
_LOCAL = threading.local()


def _thread() -> _Thread:
    try:
        return _LOCAL.state
    except AttributeError:
        _LOCAL.state = _Thread()
        return _LOCAL.state


class span:
    """Context manager that records one span (see the module's docstring):
    ``wait`` marks a span in which the host waits on the device, ``request`` makes
    it a request's root with a new id, ``syncs`` adds to the open request's
    ``host_syncs`` (see :func:`sync_point`)."""

    __slots__ = ("name", "wait", "request", "syncs", "_th", "_start", "_rf", "_outer")

    def __init__(self, name: str, wait: bool = False, request: bool = False, syncs: int = 0):
        self.name = name
        self.wait = wait
        self.request = request
        self.syncs = syncs

    def __enter__(self) -> None:
        th = self._th = _thread()
        if self.syncs and th.counts is not None:
            th.counts["host_syncs"] = th.counts.get("host_syncs", 0) + self.syncs
        if self.request:
            self._outer = (th.request, th.counts)
            th.request, th.counts = next(_REQUEST_IDS), {}
        th.stack.append(self.name)
        self._start = time.time_ns()
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            # inside the record's interval: a profiler's own cost counts to the span
            self._rf = torch.profiler.record_function("poem." + self.name)
            self._rf.__enter__()

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        end = time.time_ns()
        th = self._th
        stack = th.stack
        stack.pop()
        _RING.append((th.request, self.name, stack[-1] if stack else None, th.ident,
                      self._start, end, self.wait, th.counts if self.request else None))
        if self.request:
            th.request, th.counts = self._outer


def sync_point(name: str, device: torch.device, n: int = 1) -> span:
    """A ``wait`` span around ``n`` blocking copies or reads between the host and
    ``device``; on a CUDA device each counts to the open request's ``host_syncs``
    (on the CPU nothing waits, so nothing is counted)."""
    return span(name, wait=True, syncs=n if device.type == "cuda" else 0)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open request's counter ``name`` (outside a request, nothing)."""
    own = _thread().counts
    if own is not None:
        own[name] = own.get(name, 0) + n


def spans() -> List[SpanRecord]:
    """The ring's records, oldest first (a span is appended when it closes)."""
    return [SpanRecord(*r) for r in list(_RING)]


def counters() -> Dict[str, int]:
    """Each counter summed over the requests the ring holds."""
    total: Dict[str, int] = {}
    for r in list(_RING):
        for k, v in (r[7] or {}).items():
            total[k] = total.get(k, 0) + v
    return total


def reset() -> None:
    """Empty the ring."""
    _RING.clear()
