"""The PtEmbedTRv3 decoder's spans and counter on the serving path (``utils/profiling.py``):
a v3 request through ``Predictor.__call__`` on the CPU opens ``metro``,
``coarse_sample`` and ``refine`` under the head's ``decoder`` and counts
``metro_tokens``; the flagship's request keeps its span tree and counts nothing new.
Imports nothing of JAX."""

import pytest
import torch

from test_torch_tracing import REQUEST_TREE, request_args, tiny_model_cfg

import poem_v2_tpu_torch.models.decoder_v3 as decoder_v3
from poem_v2_tpu_torch.models.poem import create_poem_model
from poem_v2_tpu_torch.serving.predictor import Predictor
from poem_v2_tpu_torch.utils import profiling

# the v3 decoder's spans, and the coarse mesh's projection's two sync points
V3_TREE = REQUEST_TREE | {
    ("metro", "decoder"), ("coarse_sample", "decoder"), ("refine", "decoder"),
    ("invert_rigid", "coarse_sample"), ("pixel_to_grid", "coarse_sample"),
}
_FULL_V3 = decoder_v3.PtEmbedTRv3


def small_metro(**kw):
    """A small METRO stage (hidden 64 / 32, outputs 32 / 3, one layer a block)."""
    return _FULL_V3(**{**dict(vt_hidden_dims=(64, 32), vt_output_dims=(32, 3), vt_num_layers=1),
                       **kw})


def predictor(decoder: str) -> Predictor:
    cfg = tiny_model_cfg()
    cfg["HEAD"]["TRANSFORMER"]["TYPE"] = decoder
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decoder_v3, "PtEmbedTRv3", small_metro)
        model, _ = create_poem_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    return Predictor(model, view_bucket=3, image_size=64)


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def one_request(pred, views=3):
    profiling.reset()
    pred(*request_args(views))
    recs = profiling.spans()
    return recs, recs[-1]


def test_a_v3_request_opens_its_spans_and_counts_its_tokens(one_thread):
    pred = predictor("PtEmbedTRv3")
    recs, root = one_request(pred)
    assert {(r.name, r.parent) for r in recs} == V3_TREE
    assert len(recs) == len(V3_TREE)
    assert root.name == "request" and {r.request for r in recs} == {root.request}
    by_name = {}
    for r in recs:
        by_name.setdefault(r.name, []).append(r)
    decoder = by_name["decoder"][0]
    stages = [by_name[n][0] for n in ("metro", "coarse_sample", "refine")]
    assert decoder.start_ns <= stages[0].start_ns and stages[-1].end_ns <= decoder.end_ns
    assert all(a.end_ns <= b.start_ns for a, b in zip(stages, stages[1:]))
    head = pred.model.head
    # one request of batch bucket 1: the 799 queries and the cloud's points, counted once
    assert root.counts == {"metro_tokens": 1 * (head.query_feat_embedding.shape[0] + head.nsample)}


def test_the_flagship_request_is_unchanged(one_thread):
    recs, root = one_request(predictor("PtEmbedTRv4"))
    assert {(r.name, r.parent) for r in recs} == REQUEST_TREE and len(recs) == len(REQUEST_TREE)
    assert root.counts == {}  # on the CPU nothing waits, and no METRO stage ran


def test_a_batch_counts_each_sample(one_thread):
    pred = predictor("PtEmbedTRv3")
    profiling.reset()
    images, intr, extr = request_args(3)
    pred(images.repeat(3, 0), intr.repeat(3, 0), extr.repeat(3, 0))
    # three samples pad to the batch bucket of 4
    assert profiling.spans()[-1].counts == {"metro_tokens": 4 * (799 + 256)}
