"""Rank-0 progress (counterpart of ``poem_v2_tpu/utils/etqdm.py``; reference
lib/utils/etqdm.py).

Other ranks iterate silently. The port does not use tqdm (the card's machine
has none): on rank 0 a plain line goes to standard error every ``every`` items
and at the end, with the description, the count (of the total where the
iterable has a length) and the rate.
"""

from __future__ import annotations

import sys
import time

from .logger import is_master


class _PlainProgress:
    def __init__(self, iterable, desc: str = "", total=None, every: int = 10, file=None):
        self.iterable = iterable
        self.desc = desc
        self.total = total if total is not None else getattr(iterable, "__len__", lambda: None)()
        self.every = max(1, every)
        self.file = file or sys.stderr

    def __len__(self):
        return len(self.iterable)

    def _line(self, n: int, t0: float) -> None:
        rate = n / max(time.perf_counter() - t0, 1e-9)
        of = f"/{self.total}" if self.total is not None else ""
        head = f"{self.desc}: " if self.desc else ""
        print(f"{head}{n}{of} ({rate:.2f} it/s)", file=self.file, flush=True)

    def __iter__(self):
        t0, n = time.perf_counter(), 0
        for n, item in enumerate(self.iterable, 1):
            yield item
            if n % self.every == 0:
                self._line(n, t0)
        if n % self.every:
            self._line(n, t0)


def etqdm(iterable, desc: str = "", total=None, every: int = 10, **tqdm_kwargs):
    """The plain progress line over ``iterable`` on rank 0, the bare iterable on
    other ranks; tqdm's other keywords are accepted and ignored."""
    if not is_master():
        return iterable
    return _PlainProgress(iterable, desc=desc, total=total, every=every)
