"""What the per-layer metrics read from the program's own spans and counters
(``poem_v2_tpu_torch.utils.profiling``): the records of the window's untraced tail,
the last ``tail_steps`` ``request`` roots and every span under them. Those steps
ran with no profiler collecting, but after both profiles and with the
``bench.*`` forward hooks still attached: on an H100's host a profile leaves every
later request of the process about a tenth slower, and the hooks cost about 3 ms
a B16 batch, so the tail's launch times run above an untraced run's and its
waits below. Compare them between trees read the same way.

A reader that finds nothing to read returns None: without a trace, when the
ring holds fewer roots than the tail has steps, or when the program records no
spans (a tree without the recorder)."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional


def _records():
    try:
        from poem_v2_tpu_torch.utils import profiling
        return profiling.spans()
    except (ImportError, AttributeError):
        return None


def tail_requests(out, records=None) -> Optional[List[Dict]]:
    """The tail's requests, oldest first: each ``{"root": record, "spans": [records
    under it]}``."""
    steps = out.facts.get("tail_steps", 0)
    if out.trace is None or steps <= 0:
        return None
    records = _records() if records is None else records
    if records is None:
        return None
    roots = [r for r in records if r.name == "request" and r.parent is None]
    if len(roots) < steps:
        return None
    tail = {r.request: {"root": r, "spans": []} for r in roots[-steps:]}
    for r in records:
        if r.request in tail and r is not tail[r.request]["root"]:
            tail[r.request]["spans"].append(r)
    return list(tail.values())


def _covered_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, reach = 0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


def _waits(req, within=None) -> int:
    """ns the host spent in the request's ``wait`` spans (inside ``within`` if given)."""
    return _covered_ns((s.start_ns, s.end_ns) for s in req["spans"] if s.wait and (
        within is None or (within.start_ns <= s.start_ns and s.end_ns <= within.end_ns)))


def _mean_ms(reqs, per_request) -> Optional[float]:
    if not reqs:
        return None
    vals = [per_request(r) for r in reqs]
    if any(v is None for v in vals):
        return None
    return statistics.fmean(vals) / 1e6


def _named(req, *names) -> Optional[int]:
    """ns of the request's spans of these names, or None where one is missing."""
    found = [s for s in req["spans"] if s.name in names]
    if {s.name for s in found} != set(names):
        return None
    return sum(s.end_ns - s.start_ns for s in found)


def phase_ms(out, *names, records=None) -> Optional[float]:
    """Mean ms a tail request of the spans of these names."""
    return _mean_ms(tail_requests(out, records), lambda r: _named(r, *names))


def sync_wait_ms(out, records=None) -> Optional[float]:
    """Mean ms a tail request in which the host waited on the device (the union of
    its ``wait`` spans)."""
    reqs = tail_requests(out, records)
    if reqs is None or not any(s.wait for r in reqs for s in r["spans"]):
        return None
    return _mean_ms(reqs, _waits)


def launch_host_ms(out, records=None) -> Optional[float]:
    """Mean ms a tail request of the ``forward`` span less the waits inside it:
    the host issuing the forward's work."""
    def one(req):
        fwd = [s for s in req["spans"] if s.name == "forward"]
        if len(fwd) != 1:
            return None
        return fwd[0].end_ns - fwd[0].start_ns - _waits(req, fwd[0])

    return _mean_ms(tail_requests(out, records), one)


def count_per_request(out, name: str, records=None) -> Optional[float]:
    """Mean increments of the counter ``name`` a tail request (from the roots'
    ``counts``)."""
    reqs = tail_requests(out, records)
    if reqs is None or any(name not in (r["root"].counts or {}) for r in reqs):
        return None
    return statistics.fmean(r["root"].counts[name] for r in reqs)


def build_s(out, records=None) -> Optional[float]:
    """Seconds of the last ``build`` root span (the model's build at set-up)."""
    if out.trace is None:
        return None
    records = _records() if records is None else records
    builds = [r for r in records or () if r.name == "build" and r.parent is None]
    return (builds[-1].end_ns - builds[-1].start_ns) / 1e9 if builds else None
