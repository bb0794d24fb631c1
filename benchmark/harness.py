"""What every cell shares: the cell's files, the caches, the device check, the
spans the benchmark records around the program's modules, the reading of a
bounded profile, and the result line.

Layout (all found by name from ``BENCHMARK.json``):
  benchmark/workloads/<cell>.json   driver, run parameters, limits of the output check
  benchmark/traffic/<traffic>.json  the traffic mix (``benchmark/generator.py`` reads it)
  benchmark/configs/<config>.json   the configuration as it is run
  benchmark/drivers/<driver>.py     ``run(ctx) -> Outcome``
  benchmark/metrics/<metric>.py     ``read(outcome, cell) -> float | None``
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(BENCH_DIR, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "poem_v2_tpu")


def set_cache_env() -> None:
    """Every build and kernel cache at a fixed directory inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    os.environ["USE_FLAX"] = "0"  # libraries that would load flax by themselves


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    workload: dict       # benchmark/workloads/<cell>.json
    traffic: dict        # benchmark/traffic/<traffic>.json
    config: dict         # benchmark/configs/<config>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else _load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    workload = _load_json(os.path.join(BENCH_DIR, "workloads", name + ".json"))
    traffic = _load_json(os.path.join(BENCH_DIR, "traffic", entry["traffic"] + ".json"))
    config = _load_json(os.path.join(BENCH_DIR, "configs", entry["config"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, entry, workload, traffic, config, e2e, per_layer)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# spans around the program's modules (record_function ranges from hooks)
# ---------------------------------------------------------------------------

class Spans:
    """``bench.<label>`` profiler ranges around the forwards of named submodules:
    opened by a forward pre-hook, closed by a forward hook."""

    def __init__(self):
        self.handles = []

    def attach(self, module, label: str) -> None:
        import torch

        stack = []

        def pre(_m, _args):
            rf = torch.profiler.record_function("bench." + label)
            rf.__enter__()
            stack.append(rf)

        def post(_m, _args, _out):
            stack.pop().__exit__(None, None, None)

        self.handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]

    def attach_model(self, model) -> None:
        """The POEM stages and every vector-attention module."""
        for name in ("backbone", "feat_neck", "uv_neck", "head"):
            self.attach(getattr(model, name), name)
        for _, m in model.named_modules():
            if type(m).__name__ in ("PtSelfAttnBlock", "PtCrossAttnBlock"):
                self.attach(m, "vector_attention")

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


# ---------------------------------------------------------------------------
# the traced part of a window
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    """What the bounded profiles of a window read (``BoundedProfile``)."""
    window_s: float                     # the timeline: host clock, first step's start to last's end
    busy_s: float                       # union of the device's activity inside it
    launches: int                       # kernels, copies and sets inside it
    device_ops: List[Tuple[str, float]]  # device seconds by PROFILE_GROUPS label, largest first
    steps: int                          # steps of each profile
    span_device_s: Dict[str, float]     # device seconds of the work launched inside each span
    span_calls: Dict[str, int]
    idle_gaps: List[Tuple[str, float]]  # the longest idle gaps, by what the host was doing


PROFILER_NOISE = ("Activity Buffer Request", "ProfilerStep")


def _device_events(prof):
    from torch.autograd import DeviceType

    evs = list(prof.profiler.kineto_results.events())
    return evs, [e for e in evs if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]


def _busy_intervals(dev, t0: int, t1: int) -> List[List[int]]:
    """The union of the device events' intervals clipped to [t0, t1], merged."""
    merged: List[List[int]] = []
    for a, b in sorted((max(e.start_ns(), t0), min(e.end_ns(), t1)) for e in dev
                       if e.end_ns() > t0 and e.start_ns() < t1):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def read_timeline(prof, t0_ns: int, t1_ns: int) -> Optional[Dict[str, Any]]:
    """Window, busy time, launches and the largest device operations of a
    device-only profile between two host clock readings (unix ns, the clock the
    profiler's timestamps are given in)."""
    from .counts.groups import group_of

    _, dev = _device_events(prof)
    if not dev:
        return None
    t1 = max(t1_ns, max(e.end_ns() for e in dev))
    inside = [e for e in dev if t0_ns <= e.start_ns() < t1]
    by_group: Dict[str, float] = {}
    for e in inside:
        g = group_of(e.name())
        by_group[g] = by_group.get(g, 0.0) + e.duration_ns() / 1e9
    return {"window_s": (t1 - t0_ns) / 1e9,
            "busy_s": sum(b - a for a, b in _busy_intervals(dev, t0_ns, t1)) / 1e9,
            "launches": len(inside),
            "device_ops": sorted(by_group.items(), key=lambda kv: -kv[1])[:10]}


def _within(intervals, t: int) -> bool:
    """Whether t lies in one of the [a, b] intervals (starts and ends sorted apart)."""
    i = bisect.bisect_right(intervals[0], t) - 1
    return i >= 0 and t <= intervals[1][i]


def read_spans(prof, step_name: str = "bench.step") -> Optional[Dict[str, Any]]:
    """Device time of the work launched inside each ``bench.<label>`` span, and
    the longest idle gaps labelled by what the profiled
    thread was doing at their start, from a host-and-device profile.

    Work is attributed by where its launch was made: the runtime or driver call
    with the same correlation id, on the span's thread, inside its interval; so
    the kernels the port launches through its own C interface count too."""
    from torch.autograd import DeviceType

    evs, dev = _device_events(prof)
    cpu = [e for e in evs if e.device_type() == DeviceType.CPU]
    steps = sorted((e for e in cpu if e.name() == step_name), key=lambda e: e.start_ns())
    if not steps or not dev:
        return None
    launch = {e.correlation_id(): e for e in cpu
              if e.name().startswith(("cuda", "cu")) and e.correlation_id()}
    spans: Dict[Tuple[str, int], List[Tuple[int, int]]] = {}
    for e in cpu:
        name = e.name()
        if name.startswith("bench.") and name != step_name:
            key = name[len("bench."):]
            spans.setdefault((key, e.start_thread_id()), []).append((e.start_ns(), e.end_ns()))
    lookup = {k: ([a for a, _ in sorted(v)], [b for _, b in sorted(v)]) for k, v in spans.items()}
    calls: Dict[str, int] = {}
    for (key, _), v in spans.items():
        calls[key] = calls.get(key, 0) + len(v)
    dev_s = {k: 0.0 for k in calls}
    for g in dev:
        ln = launch.get(g.correlation_id())
        for (key, thread), iv in (lookup.items() if ln is not None else ()):
            if thread == ln.start_thread_id() and _within(iv, ln.start_ns()):
                dev_s[key] += g.duration_ns() / 1e9
    t0 = steps[0].start_ns()
    t1 = max(steps[-1].end_ns(), max(e.end_ns() for e in dev))
    edges = [t0] + [x for iv in _busy_intervals(dev, t0, t1) for x in iv] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    host = [e for e in cpu if e.start_thread_id() == steps[0].start_thread_id()
            and not e.name().startswith(PROFILER_NOISE) and e.name() != step_name]
    idle = []
    for length, start in gaps:
        inside = [e for e in host if e.start_ns() <= start < e.end_ns()]
        spn = [e for e in inside if e.name().startswith("bench.")]
        ops = [e for e in inside if not e.name().startswith("bench.")]
        inner = lambda es: min(es, key=lambda e: e.duration_ns()).name() if es else "host"
        label = (inner(spn)[len("bench."):] + " > " if spn else "") + inner(ops)
        idle.append((label[:100], length / 1e9))
    return {"steps": len(steps), "span_device_s": dev_s, "span_calls": calls, "idle_gaps": idle}


class BoundedProfile:
    """Two profiles of ``active`` steps each, inside a window, after ``skip`` steps:

    * the timeline: device activity alone (``ProfilerActivity.CUDA``), between
      host clock readings at its first step's start and its last step's end
      (after a synchronise): the window, the busy time, the launches and the
      largest device operations. The profiler starts a step early, so its own
      start-up falls outside;
    * the spans: host operations too, one step later, for :func:`read_spans`.
      Recording every host operation slows the host, so this profile's own idle
      share is not used.

    Call :meth:`step` after each step; ``trace`` is set once both are read."""

    def __init__(self, enabled: bool, active: int, skip: int = 2):
        import torch

        if skip < 2:
            raise ValueError("the timeline needs a step under the profiler before it starts")
        # a device timeline needs a device: on the CPU (rehearsals) nothing is traced
        self.enabled = enabled and torch.cuda.is_available()
        self.active, self.skip = active, skip
        self.first_step = skip  # the timeline's first step, counted from the window's first
        self.trace: Optional[Trace] = None
        self.done = 0
        self.last_step = 0  # the steps after this one ran with no profiler
        self.prof = None
        self.t0_ns = 0
        self.timeline = None

    def __enter__(self):
        return self

    def _start(self, host: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
        self.prof = profile(activities=acts)
        self.prof.start()

    def _stop(self):
        import torch

        torch.cuda.synchronize()
        prof, self.prof = self.prof, None
        prof.stop()
        return prof

    def step_range(self):
        import contextlib

        import torch

        spans = self.enabled and self.done >= self.skip + self.active + 1
        return torch.profiler.record_function("bench.step") if spans else contextlib.nullcontext()

    def step(self):
        """After each step of the window."""
        import time

        if not self.enabled:
            return
        self.done += 1
        if self.done == self.skip - 1:
            self._start(host=False)
        elif self.done == self.skip:
            self.t0_ns = time.time_ns()
        elif self.done == self.skip + self.active:
            prof = self._stop()
            self.timeline = read_timeline(prof, self.t0_ns, time.time_ns())
        elif self.done == self.skip + self.active + 1:
            self._start(host=True)
        elif self.done == self.skip + 2 * self.active + 1:
            self.last_step = self.done
            spans = read_spans(self._stop())
            if self.timeline is not None and spans is not None:
                self.trace = Trace(**self.timeline, **spans)

    def __exit__(self, *exc):
        if self.prof is not None:
            self._stop()
        return False

    def untraced_tail(self, ends: List[float], t_end: float, views_of_step) -> Dict[str, Any]:
        """The window's steps after both profiles, which ran as the untraced window
        does: ``tail_views`` (valid views of every sample), ``tail_steps`` and
        ``tail_seconds``; ``ends`` holds each step's end and ``t_end`` the window's
        end, on the host clock."""
        k0 = self.last_step
        if k0 == 0 or k0 >= len(ends):
            return {"tail_views": [], "tail_steps": 0, "tail_seconds": 0.0}
        return {"tail_views": [v for k in range(k0, len(ends)) for v in views_of_step(k)],
                "tail_steps": len(ends) - k0, "tail_seconds": t_end - ends[k0 - 1]}


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Outcome:
    """What a driver hands back to ``run.py``."""
    attempted: int
    failed: int
    setup_s: float
    end_to_end: Dict[str, float]       # name -> value (without setup_s)
    checks: Dict[str, Tuple[float, float]]  # name -> (value, limit): correct iff value <= limit
    memory_peak_bytes: int
    trace: Optional[Trace] = None
    facts: Dict[str, Any] = dataclasses.field(default_factory=dict)  # for the metric readers

    @property
    def correct(self) -> bool:
        import math

        return all(math.isfinite(v) and v <= lim for v, lim in self.checks.values()) \
            and self.failed == 0 and bool(self.checks)


def device_block(count: int, peak: int, trace: Optional[Trace]) -> dict:
    import torch

    block = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
             "memory_peak_bytes": int(peak)}
    if trace is not None:
        block.update(busy_s=trace.busy_s, window_s=trace.window_s)
    return block


def emit(result: dict, checks: Dict[str, Tuple[float, float]]) -> None:
    """Print each compared number beside its limit as the last lines of standard
    error, then the result line (the checks last in it) on standard output."""
    for k, (v, lim) in checks.items():
        print(f"check {k} = {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    print(json.dumps(result), flush=True)
