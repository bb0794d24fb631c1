"""The training cells on the CPU at a tiny size: a rehearsal of ``train_steps``,
the plain train-step reference against the port's plain CPU step, the planted
faults that the check must catch, the neighbour selection and its judge, the
traffic's view counts and the K6b counts."""

import json
import math
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.counts.kernels import bound_ms
from benchmark.counts.train import knn_bwd_bytes, knn_bwd_flops, knn_bwd_least_ms
from benchmark.reference.poem_ref import Reference
from benchmark.reference.train_ref import invalid_rows, select_packed
from benchmark.tests.tiny import run_module, tiny_config
from benchmark.train_generator import make_train_pool, mixture_counts

RUN = run_module()
SEED = 2 ** 31 + 23


def tiny_train_cell(**workload) -> harness.Cell:
    bench = harness._load_json(f"{harness.ROOT}/BENCHMARK.json")
    cell = harness.load_cell("medium-train-b8-mixed", bench)
    cell.config = tiny_config()
    cell.traffic = dict(cell.traffic, image_size=64, batch=2, view_bucket=3, pool=4,
                        view_ranges=[[1, 3]], mix_ratios=[1.0])
    cell.workload = dict(cell.workload, compute_dtype="float32", profile_steps=2,
                         reference_chunk=1, **workload)
    return cell


def rehearse(cell, trace=False, seconds=0.3):
    return RUN.execute(cell, SEED, seconds, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
def test_train_driver_prints_a_well_formed_line(trace, capsys):
    cell = tiny_train_cell()
    result, checks = rehearse(cell, trace)
    harness.emit(result, checks)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and set(line["checks"]) == set(cell.workload["limits"])
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    if not trace:
        assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:  # no device trace on the CPU: every per-layer reader finds nothing
        assert line["metrics"] == {}


@pytest.fixture(scope="module")
def tiny_steps():
    """The port's plain CPU train step (float32) on a tiny model, three steps
    recorded, and the reference over them."""
    from benchmark import training

    cell = tiny_train_cell()
    pool = make_train_pool(cell.traffic, SEED, "cpu")
    trainer, shapes = training.build_trainer(cell.config, SEED, "cpu", "float32")
    rec = training.StepRecorder(trainer)
    for i in range(3):
        rec.step(pool[i])
        if i == 0:
            grads = training.first_gradients(trainer)
    rec.detach()
    program = training.program_record(
        rec, grads, training.change_norms(trainer.model, shapes, SEED, "cpu"))
    ref = training.run_reference(cell.config, shapes, SEED, rec.steps, "cpu", 1)
    return program, ref, training.compare(program, ref)


def test_reference_follows_the_ports_plain_step(tiny_steps):
    """Loss, predictions and the first gradient agree to float32 round-off on the
    first step; the later steps and the update carry Adam's amplified round-off."""
    program, ref, numbers = tiny_steps
    assert abs(program["loss"][0] - ref["loss"][0]) / ref["loss"][0] < 1e-5
    assert float((program["coords"][0] - ref["coords"][0]).abs().max()) < 1e-5
    for group in ("feat_neck", "uv_neck", "head_in", "decoder"):
        assert numbers[f"grad_gap.{group}"] < 1e-3, (group, numbers)
    assert numbers["grad_gap.backbone"] < 0.1  # GroupNorm over near-constant maps: ill-conditioned
    assert numbers["loss_gap_rel"] < 0.01 and numbers["update_gap"] < 0.25, numbers
    assert numbers["knn_invalid_rows"] == 0
    assert len(program["loss"]) == 3 and all(l > 0 for l in program["loss"])


def test_the_recorder_changes_nothing():
    """Steps recorded by ``StepRecorder`` leave the same parameters and Adam state,
    bit for bit, as the same steps without it: the window's unrecorded steps run
    the code that the check follows."""
    from benchmark import training

    cell = tiny_train_cell()
    pool = make_train_pool(cell.traffic, SEED, "cpu")
    states = []
    for record in (True, False):
        trainer, _ = training.build_trainer(cell.config, SEED, "cpu", "float32")
        rec = training.StepRecorder(trainer) if record else None
        for i in range(2):
            (rec.step if record else trainer.step_sharded)(pool[i])
        if record:
            rec.detach()
        states.append([p.detach().clone() for p in trainer.model.parameters()]
                      + [m.clone() for m in trainer.optimizer.mu])
    assert all(torch.equal(a, b) for a, b in zip(*states))


def test_an_unchanged_state_reads_one(tiny_steps):
    from benchmark import training

    program, ref, _ = tiny_steps
    frozen = dict(program, change={k: 0.0 for k in program["change"]})
    assert training.compare(frozen, ref)["update_gap"] == pytest.approx(1.0)


def test_the_fp8_control_fails_the_check():
    """The reference in fp8 e4m3, choosing from fp8-rounded coordinates, in the
    program's place: the cell's limits refuse it."""
    from benchmark import training

    cell = tiny_train_cell()
    pool = make_train_pool(cell.traffic, SEED, "cpu")
    trainer, shapes = training.build_trainer(cell.config, SEED, "cpu", "float32")
    rec = training.StepRecorder(trainer)
    for i in range(3):
        rec.step(pool[i])
    rec.detach()
    run = lambda steps, **kw: training.run_reference(cell.config, shapes, SEED, steps, "cpu", 1,
                                                     **kw)
    control = run(rec.steps, precision="fp8", select="packed", select_rounded=True)
    held = [dict(s, indices=[i for _, _, i in c]) for s, c in zip(rec.steps, control["chosen"])]
    numbers = training.compare(control, run(held))
    limits = cell.workload["limits"]
    failed = [k for k, lim in limits.items() if k in numbers and not numbers[k] <= lim]
    assert {"rel_coords_gap_m", "knn_invalid_rows"} <= set(failed), numbers


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    from poem_v2_tpu_torch.training import optim

    monkeypatch.setattr(optim.Optimizer, "step", lambda self: None)
    result, checks = rehearse(tiny_train_cell())
    assert result["correct"] is False and checks["update_gap_median"][0] > 0.9
    assert checks["window_unmoved_leaves"][0] > 0


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from poem_v2_tpu_torch.training import trainer

    original = trainer.Trainer.step_sharded

    def half(self, batch):
        n = batch["image"].shape[0] // 2
        return original(self, {k: v[:n] for k, v in batch.items()})

    monkeypatch.setattr(trainer.Trainer, "step_sharded", half)
    result, checks = rehearse(tiny_train_cell())
    assert result["correct"] is False and checks["loss_gap_rel"][0] > checks["loss_gap_rel"][1]


def test_an_altered_prediction_is_caught(monkeypatch):
    from poem_v2_tpu_torch.models import poem

    original = poem.POEMNet.forward

    def altered(self, *a, **k):
        out = original(self, *a, **k)
        coords = out["all_coords_preds"].clone()
        coords[-1, :, 21:] += 0.05  # the vertices 5 cm off, where they are produced
        return dict(out, all_coords_preds=coords)

    monkeypatch.setattr(poem.POEMNet, "forward", altered)
    result, checks = rehearse(tiny_train_cell())
    assert result["correct"] is False and checks["rel_coords_gap_m"][0] > 0.04


def tied_cloud(seed=0):
    """Queries and a cloud on a coarse lattice (exact ties everywhere) plus points
    nudged by less than the key's resolution (ties to the key)."""
    rs = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(*[np.arange(-3, 4)] * 3, indexing="ij"), -1).reshape(-1, 3) * 0.25
    cloud = np.concatenate([grid, grid[:200] * (1 + 1e-5 * rs.randn(200, 1))])
    q = grid[rs.permutation(len(grid))[:64]] + 0.125 * rs.randint(0, 2, (64, 3))
    t = lambda a: torch.as_tensor(a[None], dtype=torch.float32)
    return t(q), t(cloud)


@pytest.mark.parametrize("k", [1, 8, 32])
def test_packed_selection_is_k1s_index_for_index(k):
    from poem_v2_tpu_torch.ops.knn_attn import knn_select_plain

    q, cloud = tied_cloud()
    assert torch.equal(select_packed(q, cloud, k), knn_select_plain(q, cloud, k).long())


def test_invalid_rows_counts_wrong_choices_only():
    q, cloud = tied_cloud(1)
    for sel in (Reference.knn, select_packed):
        assert invalid_rows(q, cloud, sel(q, cloud, 16)) == 0
    idx = Reference.knn(q, cloud, 16)
    far = torch.argmax(((q[0, :, None] - cloud[0, None]) ** 2).sum(-1), -1)
    wrong = idx.clone()
    wrong[0, :5, -1] = far[:5]
    repeated = idx.clone()
    repeated[0, 7:9, 1] = repeated[0, 7:9, 0]
    assert invalid_rows(q, cloud, wrong) == 5 and invalid_rows(q, cloud, repeated) == 2


def test_view_counts_follow_the_mixture():
    ranges = [[1, 5], [1, 8], [1, 8], [1, 8], [1, 4], [1, 1]]
    # by hand: 1 view 128 x (0.18 x (1/5 + 3/8 + 1/4) + 0.1) = 31.808, 5 views 13.248,
    # 2-4 views 19.008 each, 6-8 views 8.64 each; the largest remainders round up
    counts = mixture_counts(128, ranges, [0.18] * 5 + [0.1])
    assert np.bincount(counts, minlength=9)[1:].tolist() == [32, 19, 19, 19, 13, 9, 9, 8]
    equal = mixture_counts(128, ranges, [1] * 6)
    assert np.bincount(equal, minlength=9)[1:].tolist() == [39, 18, 18, 17, 12, 8, 8, 8]
    a = make_train_pool(tiny_train_cell().traffic, 1, "cpu")
    b = make_train_pool(tiny_train_cell().traffic, 2, "cpu")
    sizes = lambda pool: sorted(int(n) for p in pool for n in p["view_mask"].sum(1))
    assert sizes(a) == sizes(b)  # every seed the same multiset of sizes
    for p in a:  # padded views: zero images and 2D joints, identity cameras
        pad = ~p["view_mask"]
        assert not p["image"][pad].any() and not p["target_joints_2d"][pad].any()
        assert torch.equal(p["cam_extr"][pad], torch.eye(4).expand(int(pad.sum()), 4, 4))


def test_knn_bwd_counts_by_hand():
    # one call: 2 samples x 3 queries x 4 neighbours, D 8: 6 products of 8 x 8 a row
    assert knn_bwd_flops(2, 3, 4, 8) == 24 * 6 * 2 * 64
    assert knn_bwd_bytes(2, 3, 5, 8, 2) == 2 * (3 * 2 * 3 * 8 + 2 * 2 * 5 * 8 + 3 * 64)
    cell = harness.load_cell("medium-train-b8-mixed")
    # two KNN blocks (block 0 attends to anchors), self and cross, B8 x 799 x 32 at D 256
    flops = 2 * 2 * 8 * 799 * 32 * 6 * 2.0 * 256 ** 2
    assert math.isclose(knn_bwd_least_ms(cell), bound_ms(0, flops)[0], rel_tol=1e-3)
