"""Run one cell of the port's benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, drivers and per-layer metrics are files found by the
names in ``BENCHMARK.json`` (see ``benchmark/README.md``). The run needs the
CUDA cards the cell asks for and fails without them. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a bounded
profile of the window; both check the window's outputs against the plain
reference and print each compared number beside its limit.
"""

import time

T0 = time.perf_counter()  # set-up counts from the process's start

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

harness.set_cache_env()


class Context:
    """What a driver is handed: the cell, the seed, the window, the device."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device: str, t0: float):
        import torch

        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.t0 = torch.device(device), t0
        self._before_window = 0

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark_window(self) -> None:
        """Start counting the window's own memory peak."""
        import torch

        if self.device.type == "cuda":
            self._before_window = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def window_peak(self) -> int:
        import torch

        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def memory_peak(self) -> int:
        return max(self._before_window, self.window_peak())


def device_note(label: str) -> None:
    """The card's name, power limit, clocks, draw and temperature, on standard error."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.mem,"
                              "power.draw,temperature.gpu", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not available"
    print(f"device {label}: {out}", file=sys.stderr, flush=True)


def execute(cell, seed: int, seconds: float, trace: bool, device: str, t0: float):
    """Run the cell's driver; returns (result dict, checks)."""
    driver = harness.load_module("drivers", cell.workload["driver"])
    ctx = Context(cell, seed, seconds, trace, device, t0)
    out = driver.run(ctx)
    metrics = {}
    if not trace:
        values = dict(out.end_to_end, setup_s=out.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = harness.load_module("metrics", m["name"]).read(out, cell)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics}
    if ctx.device.type == "cuda":
        result["device"] = harness.device_block(cell.entry["chips"], out.memory_peak_bytes,
                                                out.trace if trace else None)
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if trace and out.trace is not None:
        result["breakdown"] = {"device_ops": [list(x) for x in out.trace.device_ops],
                               "idle_gaps": [list(x) for x in out.trace.idle_gaps]}
    return result, out.checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch

    need = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device_note("at start")
    result, checks = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    device_note("after the window")
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
