"""The port's spans and counters (``utils/profiling.py``) on the serving path and
at the model's build: the span tree of one request, the build's spans, the
profiler ranges they open only under a profile (on the profiler's clock), the
ring's bound, and outputs unchanged by the recorder. One test needs the card:
every sync CUDA's sync debug mode flags lies in a ``wait`` span, as many as
``host_syncs`` counts. Imports nothing of JAX.
"""

import copy
import json
import time
import warnings

import numpy as np
import pytest
import torch

from poem_v2_tpu_torch.configs import RELEASE
from poem_v2_tpu_torch.models.poem import create_poem_model
from poem_v2_tpu_torch.serving.predictor import Predictor, ring_cameras
from poem_v2_tpu_torch.utils import profiling

# (name, parent) of every span of one eval request, and which of them wait
REQUEST_TREE = {
    ("request", None), ("pad", "request"), ("h2d", "request"), ("forward", "request"),
    ("readback", "request"),
    ("backbone", "forward"), ("feat_neck", "forward"), ("uv_neck", "forward"),
    ("joints2d", "forward"), ("triangulate", "forward"), ("head", "forward"),
    ("pixel_scale", "joints2d"),
    ("embed", "head"), ("sample", "head"), ("scramble_check", "head"), ("merge", "head"),
    ("decoder", "head"), ("invert_rigid", "sample"), ("pixel_to_grid", "sample"),
}
# the sync points and their blocking copies or reads on the card: 4 input copies,
# the pixel scale, the rigid inverse's bottom row (the BPS projection; the DLT
# inverts in its kernel), the grid resolution, the scramble check, 5 output copies
SYNCS = {"h2d": 4, "pixel_scale": 1, "invert_rigid": 1, "pixel_to_grid": 1,
         "scramble_check": 1, "readback": 5}
SYNCS_PER_REQUEST = sum(SYNCS.values())  # 13


def tiny_model_cfg() -> dict:
    """POEM-medium's structure at width 8 / 64 (head dim 16, the least the card's
    float32 attention kernel takes), 256 BPS points, 2 blocks, K 8."""
    cfg = copy.deepcopy(RELEASE["medium"]["MODEL"])
    cfg["BACKBONE"]["WIDTH"] = 8
    head = cfg["HEAD"]
    head["EMBED_DIMS"] = head["POINTS_FEAT_DIM"] = head["IN_CHANNELS"] = 64
    head["N_SAMPLE"] = 256
    tr = head["TRANSFORMER"]
    tr["INPUT_FEAT_DIM"], tr["N_BLOCKS"], tr["N_NEIGHBOR"], tr["N_NEIGHBOR_QUERY"] = 64, 2, 8, 8
    return cfg


def request_args(views: int, size: int = 64, seed: int = 0):
    rs = np.random.RandomState(seed)
    intr, extr = ring_cameras(views, size)
    return rs.randint(0, 256, (1, views, size, size, 3)).astype(np.uint8), intr[None], extr[None]


@pytest.fixture(scope="module")
def predictor():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    model, _ = create_poem_model(tiny_model_cfg(), device="cpu",
                                 generator=torch.Generator().manual_seed(5))
    yield Predictor(model, view_bucket=3, image_size=64)
    torch.set_num_threads(n)


def test_one_request_gives_the_span_tree_and_its_syncs(predictor):
    profiling.reset()
    predictor(*request_args(3))
    recs = profiling.spans()
    assert {(r.name, r.parent) for r in recs} == REQUEST_TREE and len(recs) == len(REQUEST_TREE)
    root = recs[-1]  # a span is recorded when it closes: the root last
    assert root.name == "request" and root.request is not None
    assert {r.request for r in recs} == {root.request}
    assert {r.name for r in recs if r.wait} == set(SYNCS)
    assert len({r.thread for r in recs}) == 1
    by_name = {r.name: r for r in recs}
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = by_name[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, r.name
    assert root.counts == {}  # on the CPU nothing waits, so no sync is counted
    assert all(r.counts is None for r in recs[:-1])
    # the next request draws a new id
    predictor(*request_args(3, seed=1))
    assert profiling.spans()[-1].request == root.request + 1


def test_the_build_span_and_its_children():
    profiling.reset()
    create_poem_model(tiny_model_cfg(), device="cpu")
    recs = profiling.spans()
    assert [(r.name, r.parent) for r in recs] == [
        ("assets", "build"), ("init", "build"), ("to_device", "build"), ("build", None)]
    assert all(r.request is None and not r.wait for r in recs)
    build = recs[-1]
    assert all(build.start_ns <= r.start_ns and r.end_ns <= build.end_ns for r in recs[:-1])


def test_no_profiler_range_unless_a_profiler_collects(predictor, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function opened with no profiler collecting")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset()
    predictor(*request_args(3))
    assert len(profiling.spans()) == len(REQUEST_TREE)


def test_profiler_ranges_on_the_records_clock(predictor, tmp_path):
    profiling.reset()
    with profiling.trace(str(tmp_path), "request.json") as prof:
        predictor(*request_args(3))
    recs = profiling.spans()
    chrome = json.load(open(tmp_path / "request.json"))["traceEvents"]
    assert {e["name"] for e in chrome if e.get("name", "").startswith("poem.")} == \
        {"poem." + r.name for r in recs}
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("poem."):
            events.setdefault(e.name()[len("poem."):], []).append(e)
    assert set(events) == {r.name for r in recs}
    for name, evs in events.items():  # a name's events and records, in order of start
        mine = sorted((r for r in recs if r.name == name), key=lambda r: r.start_ns)
        assert len(evs) == len(mine), name
        for e, r in zip(sorted(evs, key=lambda e: e.start_ns()), mine):
            assert abs(e.start_ns() - r.start_ns) < 1_000_000, name
            assert abs(e.end_ns() - r.end_ns) < 1_000_000, name


def test_the_ring_is_bounded_and_readers_return_copies():
    assert profiling.RING_SIZE >= 65536
    profiling.reset()
    for i in range(profiling.RING_SIZE + 10):
        with profiling.span(f"s{i}"):
            pass
    recs = profiling.spans()
    assert len(recs) == profiling.RING_SIZE and recs[0].name == "s10"
    assert recs[-1].name == f"s{profiling.RING_SIZE + 9}"
    with profiling.span("request", request=True):
        profiling.count("host_syncs", 2)
    got = profiling.counters()
    got["host_syncs"] = 99
    recs.clear()
    assert profiling.counters() == {"host_syncs": 2} and len(profiling.spans()) == profiling.RING_SIZE
    profiling.reset()
    assert profiling.spans() == [] and profiling.counters() == {}


def test_a_sync_point_is_a_wait_span_that_counts_on_the_card_alone():
    profiling.reset()
    with profiling.span("request", request=True):
        with profiling.sync_point("readback", torch.device("cuda"), 5):
            pass
        with profiling.sync_point("h2d", torch.device("cpu"), 4):
            pass
    with profiling.sync_point("outside", torch.device("cuda")):  # no request: not counted
        pass
    recs = profiling.spans()
    assert [(r.name, r.parent, r.wait) for r in recs] == [
        ("readback", "request", True), ("h2d", "request", True), ("request", None, False),
        ("outside", None, True)]
    assert recs[2].counts == {"host_syncs": 5}
    assert profiling.counters() == {"host_syncs": 5}


def test_outputs_are_bit_identical_across_a_reset(predictor):
    args = request_args(3, seed=2)
    first = predictor(*args)
    profiling.reset()
    second = predictor(*args)
    assert first.keys() == second.keys()
    for k in first:
        np.testing.assert_array_equal(first[k], second[k], err_msg=k)
    # and the same numbers as the model called directly on the padded request
    images, mask, intr, extr = predictor.pad(*args)
    with torch.no_grad():
        want = predictor.model(torch.from_numpy(images).float() / 255.0 - 0.5,
                               torch.from_numpy(mask), torch.from_numpy(intr),
                               torch.from_numpy(extr), torch.zeros(1, 21, 3))
    np.testing.assert_array_equal(first["joints_3d"], want["pred_joints_3d"].numpy())


@pytest.mark.cuda
def test_every_sync_of_a_request_lies_in_a_sync_point():
    """One B1 request of 8 views on the card: each warning of CUDA's sync debug mode
    falls inside a ``wait`` span, each sync point holds as many as it counts, and
    the request's ``host_syncs`` is their number."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model, _ = create_poem_model(tiny_model_cfg(), device="cuda")
    pred = Predictor(model, view_bucket=8, image_size=64)
    args = request_args(8)
    pred(*args)  # the kernels' build, the cached constants
    torch.cuda.synchronize()
    profiling.reset()
    stamps = []  # (time on the records' clock, where) of each warning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda msg, cat, fn, ln, *a, **k: stamps.append(
            (time.time_ns(), f"{fn}:{ln}", str(msg)))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pred(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [(t, where) for t, where, msg in stamps
             if "called a synchronizing CUDA operation" in msg]
    recs = profiling.spans()
    waits = [r for r in recs if r.wait]
    held = {}
    for t, where in syncs:
        inside = [r for r in waits if r.start_ns <= t <= r.end_ns]
        assert len(inside) == 1, where
        held[inside[0].name] = held.get(inside[0].name, 0) + 1
    assert held == SYNCS
    assert recs[-1].name == "request" and recs[-1].counts == {"host_syncs": SYNCS_PER_REQUEST}
    assert profiling.counters() == {"host_syncs": len(syncs)}
