"""The readers of the program's own spans and counters (``benchmark/program_spans.py``),
on hand-made records."""

import pytest

from benchmark import harness, program_spans
from poem_v2_tpu_torch.utils.profiling import SpanRecord

MS = 1_000_000


def rec(req, name, parent, start_ms, end_ms, wait=False, counts=None):
    return SpanRecord(req, name, parent, 1, int(start_ms * MS), int(end_ms * MS), wait, counts)


def request(req, t0, syncs=14):
    """One request at t0 ms: pad 1, h2d 2 (wait), forward 20 with a 3 ms wait, readback
    4 ms (wait); the children first, as the ring holds them (a span closes before its
    parent)."""
    return [
        rec(req, "pad", "request", t0, t0 + 1),
        rec(req, "h2d", "request", t0 + 1, t0 + 3, wait=True),
        rec(req, "pixel_scale", "joints2d", t0 + 5, t0 + 7, wait=True),
        rec(req, "scramble_check", "head", t0 + 6, t0 + 8, wait=True),  # overlaps: 3 ms in all
        rec(req, "merge", "head", t0 + 10, t0 + 12),
        rec(req, "decoder", "head", t0 + 12, t0 + 20),
        rec(req, "forward", "request", t0 + 3, t0 + 23),
        rec(req, "readback", "request", t0 + 23, t0 + 27, wait=True),
        rec(req, "request", None, t0, t0 + 28, counts={"host_syncs": syncs}),
    ]


RECORDS = ([rec(None, "to_device", "build", 0, 500), rec(None, "build", None, 0, 2500)]
           + request(1, 3000, syncs=99) + request(2, 3100) + request(3, 3200))
TRACE = harness.Trace(window_s=1.0, busy_s=0.1, launches=1, device_ops=[], steps=1,
                      span_device_s={}, span_calls={}, idle_gaps=[])


def outcome(tail_steps=2, trace=TRACE):
    return harness.Outcome(3, 0, 1.0, {}, {}, 0, trace=trace, facts={"tail_steps": tail_steps})


def test_the_tail_is_the_last_requests_with_their_spans():
    reqs = program_spans.tail_requests(outcome(), RECORDS)
    assert [r["root"].request for r in reqs] == [2, 3]
    assert all(len(r["spans"]) == 8 for r in reqs)


def test_phases_waits_and_launches_a_request():
    out = outcome()
    assert program_spans.phase_ms(out, "pad", "h2d", records=RECORDS) == pytest.approx(3.0)
    assert program_spans.phase_ms(out, "merge", "decoder", records=RECORDS) == pytest.approx(10.0)
    # the union of the waits: the h2d's 2 ms, [5, 8] inside the forward, the readback's 4
    assert program_spans.sync_wait_ms(out, RECORDS) == pytest.approx(9.0)
    assert program_spans.launch_host_ms(out, RECORDS) == pytest.approx(17.0)
    # the tail's own counts: request 1 (99 syncs) is outside it
    assert program_spans.count_per_request(out, "host_syncs", RECORDS) == pytest.approx(14.0)
    assert program_spans.build_s(out, RECORDS) == pytest.approx(2.5)


def test_readers_return_none_with_nothing_to_read(monkeypatch):
    readers = [lambda o, r: program_spans.phase_ms(o, "pad", "h2d", records=r),
               program_spans.sync_wait_ms, program_spans.launch_host_ms,
               lambda o, r: program_spans.count_per_request(o, "host_syncs", r),
               program_spans.build_s]
    for read in readers:
        assert read(outcome(trace=None), RECORDS) is None           # no trace
    for read in readers[:4]:
        assert read(outcome(tail_steps=4), RECORDS) is None         # fewer roots than steps
        assert read(outcome(tail_steps=0), RECORDS) is None
        assert read(outcome(), []) is None
    # a tree whose program records nothing: no recorder to import
    monkeypatch.setattr(program_spans, "_records", lambda: None)
    for read in readers:
        assert read(outcome(), None) is None
    no_counts = [r._replace(counts={}) if r.name == "request" else r for r in RECORDS]
    assert program_spans.count_per_request(outcome(), "host_syncs", no_counts) is None
    no_waits = [r._replace(wait=False) for r in RECORDS]
    assert program_spans.sync_wait_ms(outcome(), no_waits) is None
