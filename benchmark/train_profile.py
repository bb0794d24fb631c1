"""The bounded profile of a training window, and what it reads beyond
:class:`~benchmark.harness.BoundedProfile`'s timeline and spans:

* the device seconds of every kernel group (``counts/groups.py``) on the
  timeline, not only the ten largest;
* the device seconds of the work launched in each phase of a profiled step, on
  the host-and-device profile: the backward (every operation launched inside
  one of autograd's ``autograd::engine::evaluate_function`` events, on any
  thread: the engine runs the backward, with the checkpointed blocks'
  recompute, on a device thread of its own), the optimiser (inside the
  benchmark's ``bench.optim`` range around ``Optimizer.step``), and the rest
  (the forward, the loss, the gradient norm).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from . import harness
from .counts.groups import group_of

BACKWARD_EVENT = "autograd::engine::evaluate_function"


def _intervals(events) -> Dict[int, Tuple[List[int], List[int]]]:
    """By thread, the sorted starts and ends of the outermost intervals."""
    by_thread: Dict[int, List[Tuple[int, int]]] = {}
    for e in events:
        by_thread.setdefault(e.start_thread_id(), []).append((e.start_ns(), e.end_ns()))
    out = {}
    for th, iv in by_thread.items():
        merged: List[List[int]] = []
        for a, b in sorted(iv):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        out[th] = ([a for a, _ in merged], [b for _, b in merged])
    return out


def read_phases(prof, step_name: str = "bench.step") -> Dict[str, float]:
    """Device seconds of the work launched in the backward, the optimiser and the
    rest, over the profiled steps (``steps``: how many)."""
    from torch.autograd import DeviceType

    evs, dev = harness._device_events(prof)
    cpu = [e for e in evs if e.device_type() == DeviceType.CPU]
    launch = {e.correlation_id(): e for e in cpu
              if e.name().startswith(("cuda", "cu")) and e.correlation_id()}
    backward = _intervals(e for e in cpu if e.name().startswith(BACKWARD_EVENT))
    optim = _intervals(e for e in cpu if e.name() == "bench.optim")
    out = {"backward": 0.0, "optim": 0.0, "rest": 0.0, "unattributed": 0.0,
           "steps": float(sum(1 for e in cpu if e.name() == step_name))}
    for g in dev:
        ln = launch.get(g.correlation_id())
        dur = g.duration_ns() / 1e9
        if ln is None:
            out["unattributed"] += dur
            continue
        th, t = ln.start_thread_id(), ln.start_ns()
        if th in backward and harness._within(backward[th], t):
            out["backward"] += dur
        elif th in optim and harness._within(optim[th], t):
            out["optim"] += dur
        else:
            out["rest"] += dur
    return out


def read_groups(prof, t0_ns: int, t1_ns: int) -> Dict[str, float]:
    """Device seconds of every kernel group that started in [t0, t1] (the timeline)."""
    _, dev = harness._device_events(prof)
    t1 = max([t1_ns] + [e.end_ns() for e in dev])
    out: Dict[str, float] = {}
    for e in dev:
        if t0_ns <= e.start_ns() < t1:
            g = group_of(e.name())
            out[g] = out.get(g, 0.0) + e.duration_ns() / 1e9
    return out


class TrainProfile(harness.BoundedProfile):
    """:class:`~benchmark.harness.BoundedProfile`, which also keeps every kernel
    group's device seconds on the timeline (``groups``) and the phases of the
    host-and-device profile's steps (``phases``), read from each profile that
    the harness's schedule stops."""

    def __init__(self, enabled: bool, active: int, skip: int = 2):
        super().__init__(enabled, active, skip)
        self.groups: Dict[str, float] = {}
        self.phases: Dict[str, float] = {}
        self.last = None

    def _stop(self):
        self.last = super()._stop()
        return self.last

    def step(self):
        super().step()
        if self.last is None:  # no profile stopped at this step
            return
        if self.done == self.skip + self.active:
            self.groups = read_groups(self.last, self.t0_ns, time.time_ns())
        else:
            self.phases = read_phases(self.last)
        self.last = None


def phase_ms(out, phase: str) -> Optional[float]:
    """Device ms a profiled step of the work launched in ``phase`` (:func:`read_phases`)."""
    p = out.facts.get("phases") or {}
    if out.trace is None or not p.get("steps") or p.get(phase, 0.0) <= 0:
        return None
    return 1e3 * p[phase] / p["steps"]
