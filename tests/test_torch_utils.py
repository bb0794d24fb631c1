"""The port's small utilities against the JAX package's: ``utils/misc.py``
(``CONST``, ``param_size``, ``singleton``), ``utils/etqdm.py`` (the plain progress
line) and ``utils/profiling.py`` (``trace`` on torch.profiler)."""

import io
import json
import os

import numpy as np
import pytest
import torch

from poem_v2_tpu.utils import misc as jmisc
from poem_v2_tpu_torch.utils import misc as tmisc
from poem_v2_tpu_torch.utils.etqdm import _PlainProgress, etqdm
from poem_v2_tpu_torch.utils.profiling import trace


def test_const_equals_jax_and_is_immutable():
    names = [k for k in vars(jmisc.CONST) if k.isupper()]
    assert names and names == [k for k in vars(tmisc.CONST) if k.isupper()]
    for k in names:
        assert getattr(tmisc.CONST, k) == getattr(jmisc.CONST, k), k
    with pytest.raises(AttributeError):
        tmisc.CONST.PI = 3
    with pytest.raises(AttributeError):
        tmisc.CONST()


def test_param_size_and_singleton_match_jax():
    model = torch.nn.Sequential(torch.nn.Linear(300, 700), torch.nn.Conv2d(3, 64, 7))
    params = {n: np.zeros(tuple(p.shape), np.float32) for n, p in model.named_parameters()}
    assert tmisc.param_size(model) == jmisc.param_size(params) == 0.22

    @tmisc.singleton
    class One:
        def __init__(self, x):
            self.x = x

    assert One(1) is One(2) and One(3).x == 1


def test_plain_progress_line():
    out = io.StringIO()
    items = list(_PlainProgress(range(25), desc="draw", every=10, file=out))
    assert items == list(range(25))
    lines = out.getvalue().splitlines()
    assert [ln.split(" (")[0] for ln in lines] == ["draw: 10/25", "draw: 20/25", "draw: 25/25"]
    assert all(ln.endswith(" it/s)") for ln in lines)
    # tqdm's keywords are taken and ignored; a generator has no total
    assert sum(etqdm((i for i in range(5)), desc="x", dynamic_ncols=True, leave=False)) == 10


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path), "block.json") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    events = json.load(open(os.path.join(tmp_path, "block.json")))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
