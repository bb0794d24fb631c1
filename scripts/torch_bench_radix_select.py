"""Micro-benchmark on a CUDA card: radix select vs serial threshold scans for
the exact K-th key (the PyTorch port's counterpart of ``bench_radix_select.py``).

Checks and times the five hand-written CUDA variants of
``poem_v2_tpu_torch/ops/select.py`` (pass1, scan32, radix8, cur, bcast) at the
flagship cross shape (B=16, M=799->832, N=4096, K=32) and prints
``name exact: True`` / ``name: x ms`` lines.

Usage: python scripts/torch_bench_radix_select.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch

    from poem_v2_tpu_torch.ops.select import bench_kth_key

    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_radix_select: no CUDA device")
    print(torch.cuda.get_device_name(0))
    bench_kth_key()


if __name__ == "__main__":
    main()
