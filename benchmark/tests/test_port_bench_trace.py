"""The reduction from a profile to the per-layer numbers, on hand-made events."""

import types

import pytest
from torch.autograd import DeviceType

from benchmark import harness, readers


class Ev:
    def __init__(self, name, dev, start, end, corr=0, thread=1, annotation=False):
        self._n, self._d, self._s, self._e = name, dev, start, end
        self._c, self._t, self._a = corr, thread, annotation

    def name(self): return self._n
    def device_type(self): return self._d
    def start_ns(self): return self._s
    def end_ns(self): return self._e
    def duration_ns(self): return self._e - self._s
    def correlation_id(self): return self._c
    def start_thread_id(self): return self._t
    def is_user_annotation(self): return self._a


def prof_of(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


CPU, GPU = DeviceType.CPU, DeviceType.CUDA
EVENTS = [
    Ev("bench.step", CPU, 0, 100), Ev("bench.step", CPU, 100, 200),
    Ev("bench.head", CPU, 10, 60), Ev("bench.vector_attention", CPU, 20, 40),
    Ev("cudaLaunchKernel", CPU, 25, 26, corr=7), Ev("cuLaunchKernel", CPU, 50, 51, corr=8),
    Ev("cudaLaunchKernel", CPU, 120, 121, corr=9),
    Ev("bench.head", CPU, 115, 130, thread=2),
    Ev("cudaLaunchKernel", CPU, 118, 119, corr=10, thread=2),
    Ev("aten::item", CPU, 60, 100),
    Ev("knn_select_kernel", GPU, 30, 50, corr=7), Ev("fprop_conv", GPU, 55, 60, corr=8),
    Ev("gemm_x", GPU, 125, 150, corr=9), Ev("knn_bwd_dx", GPU, 150, 160, corr=10),
    Ev("head", GPU, 30, 60, annotation=True),
]


def test_timeline_window_busy_and_launches():
    t = harness.read_timeline(prof_of(EVENTS), 0, 200)
    assert t["window_s"] == pytest.approx(200e-9)
    # busy: [30, 50] + [55, 60] + [125, 160], the annotation left out
    assert t["busy_s"] == pytest.approx(60e-9) and t["launches"] == 4
    assert dict(t["device_ops"])["K1 (K6 fwd) knn_select + core"] == pytest.approx(20e-9)


def test_spans_take_the_work_launched_inside_them():
    s = harness.read_spans(prof_of(EVENTS))
    assert s["steps"] == 2
    # both launches of the first head span, and the one of the second on its own thread
    assert s["span_device_s"]["head"] == pytest.approx(35e-9) and s["span_calls"]["head"] == 2
    assert s["span_device_s"]["vector_attention"] == pytest.approx(20e-9)
    # the longest gap, [60, 125], starts while the host waits in aten::item
    assert s["idle_gaps"][0] == ("aten::item", pytest.approx(65e-9))


def test_readers_find_nothing_without_a_trace():
    out = harness.Outcome(1, 0, 1.0, {}, {}, 0, trace=None,
                          facts={"tail_steps": 4, "tail_seconds": 2.0})
    assert readers.idle_pct(out) is None and readers.per_step_ms(out, "head") is None
    assert readers.launches_per_step(out) is None
    trace = harness.Trace(window_s=2.0, busy_s=0.5, launches=10, device_ops=[], steps=2,
                          span_device_s={"head": 0.2}, span_calls={"head": 2}, idle_gaps=[])
    out.trace = trace
    # busy 0.25 s a traced step against 0.5 s an untraced step: idle half the time,
    # whatever the traced window's own length
    assert readers.idle_pct(out) == pytest.approx(50.0)
    assert readers.per_step_ms(out, "head") == pytest.approx(100.0)
    assert readers.per_step_ms(out, "backbone") is None and readers.launches_per_step(out) == 5
