"""Rehearsal of ``chip_smoke.py`` on the CPU: its phases 1, 1b, 1c and 1d at tiny shapes, with
the wrappers' plain versions on both sides and the timer stubbed, so that a
wrong argument, shape or key shows here and not on the card."""

import json

import numpy as np
import pytest
import torch

import chip_smoke


@pytest.fixture
def on_cpu(monkeypatch):
    """Send chip_smoke's device copies to the CPU and stub its CUDA timer."""
    real_to = chip_smoke._to
    monkeypatch.setattr(chip_smoke, "_to", lambda x, device, dtype=None: real_to(x, "cpu", dtype))
    monkeypatch.setattr(chip_smoke, "time_cuda",
                        lambda fn, iters=1, warmup=0: (fn(), 1e-3)[1])
    monkeypatch.setattr(chip_smoke, "time_graph", lambda fn, iters=1: (fn(), 1e-3)[1])
    monkeypatch.setattr(chip_smoke, "gpu_line", lambda: "CPU rehearsal")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


SYNTHETIC_TINY = dict(B=2, M=19, D=32, K=4, N=32, V=2, HW=4, N_big=68, A=8)


def test_phase_kernels_rehearsal(on_cpu):
    results = {}
    chip_smoke.phase_kernels(results, B=2, M=19, D=32, K=8, N=64, V=4, wide=(48,),
                             synthetic=SYNTHETIC_TINY)
    # the synthetic ResNet-18 model's shapes: K1 self and cross, K2, K3 at its head
    # dim over two key counts, K4 on its 2 views' maps, K5 on a batch of 1 and 2 views
    assert {c for c in results if c.startswith("synthetic/")} == {
        "synthetic/fused_knn_vector_attention/self_D32_K4",
        "synthetic/fused_knn_vector_attention/cross_D32_K4",
        "synthetic/fused_anchor_vector_attention/D32", "synthetic/dense_cross_attention/hd8_N32",
        "synthetic/dense_cross_attention/hd8_N68",
        "synthetic/grid_sample_points_fused/V2_4x4_D32",
        "synthetic/scrambled_merge_gather/V2_D32"}
    names = {case.split("/")[0] for case in results} - {"wide", "ragged", "synthetic"}
    assert names == {k for k, n in chip_smoke.LAUNCHES_PER_MIXED_FORWARD.items() if n} | {
        "fused_vector_attention"}
    assert set(chip_smoke.LAUNCHES_PER_FORWARD) == set(chip_smoke.LAUNCHES_PER_TRAIN_STEP) \
        == set(chip_smoke.KERNELS) and len(chip_smoke.KERNELS) == 12
    # K3 also at one sample with a key count no tile divides, its lse held everywhere
    dense = [c for c in results if "dense_cross_attention" in c]
    assert sorted(dense) == ["dense_cross_attention", "ragged/dense_cross_attention/B1_N68",
                             "synthetic/dense_cross_attention/hd8_N32",
                             "synthetic/dense_cross_attention/hd8_N68",
                             "wide/dense_cross_attention/D48"]
    for case, by_dtype in results.items():
        assert set(by_dtype) == {"float32", "bfloat16"}, case
        for row in by_dtype.values():
            k1 = case.split("/")[int(case.startswith(("wide/", "synthetic/")))] \
                == "fused_knn_vector_attention"
            assert set(row) == {"max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by"} | ({"lse_max_abs_err"} if case in dense else set()) \
                | ({"bound_five_ms"} if k1 else set())
            if k1:  # the least work (3 products a row, 2 a cloud point) bounds below 5 a row
                assert row["bound_ms"] <= row["bound_five_ms"]
            assert row["bound_by"] in ("bytes", "operations") and row["bound_ms"] > 0
            assert row["max_abs_err"] == 0.0  # the same plain version on both sides
            assert row.get("lse_max_abs_err", 0.0) == 0.0
    for case in ("dense_cross_attention", "grid_sample_points_fused", "scrambled_merge_gather"):
        assert results[case]["bfloat16"]["library_ms"] is not None, case
    # K4 at every width and at four times the batch (medium's B16)
    assert {c for c in results if "grid_sample" in c} == {
        "grid_sample_points_fused", "wide/grid_sample_points_fused/D48",
        "wide/grid_sample_points_fused/B8_D32", "synthetic/grid_sample_points_fused/V2_4x4_D32"}
    for case in ("synthetic/dense_cross_attention/hd8_N32",
                 "synthetic/grid_sample_points_fused/V2_4x4_D32",
                 "synthetic/scrambled_merge_gather/V2_D32"):
        assert results[case]["bfloat16"]["library_ms"] is not None, case
    json.dumps(results)  # what goes into the kernels line is serialisable


def test_phase_core_shapes_rehearsal(on_cpu):
    """Phase 1a at tiny shapes: K1, K2, K8 and K6b at K = 3 and 5 (no divisor of
    32), one and 7 queries, at D = 32 and 48; K1 fed with its own indices, K6b
    launched twice."""
    results = {}
    chip_smoke.phase_core_shapes(results, B=2, N=40, D=32, wide=48, Ks=(3, 5), Ms=(1, 7),
                                 K_wide=5)
    kernels = ("fused_knn_vector_attention", "fused_anchor_vector_attention",
               "fused_vector_attention", "knn_vector_attention_trainable_bwd")
    shapes = [(32, K, M) for K in (3, 5) for M in (1, 7)] + [(48, 5, 1), (48, 5, 7)]
    assert set(results) == {f"shapes/{k}/D{D}_K{K}_M{M}" for k in kernels for D, K, M in shapes}
    for case, by_dtype in results.items():
        assert set(by_dtype) == {"float32", "bfloat16"}
        for dt, row in by_dtype.items():
            # the same plain version on both sides; K6b in bfloat16 is held against
            # float32, where the plain bfloat16 recompute has its own rounding
            if dt == "float32" or "trainable_bwd" not in case:
                assert row["max_abs_err"] == 0.0
            assert row.get("from_idx_bit_identical", True)
            assert ("from_idx_bit_identical" in row) == ("/fused_knn_" in case)
            assert row.get("bit_identical", True)
            assert ("bit_identical" in row) == ("trainable_bwd" in case)
    json.dumps(results)


def test_phase_graph_times_rehearsal(on_cpu):
    results = {}
    chip_smoke.phase_graph_times(results, B=2, M=19, N=64, D=32, K=8, wide=48, bucket_size=16,
                                 n_cand=2, block_q=4)
    assert set(results) == {"graph_times"}
    k6 = {f"knn_vector_attention_trainable{what}/{case}/D{D}" for what in (" fwd + bwd", "_bwd")
          for case in ("self", "cross") for D in (32, 48)}
    sampler = {f"grid_sample_points_fused/B{b}_D{d}" for b, d in ((4, 128), (4, 512),
                                                                   (4, 1024), (16, 256))}
    # the selections alone, with their bounds and plain versions' times
    selections = {"knn_select (K1's selection alone)", "knn_select/self (K1's selection alone)",
                  "knn_select_bucketed (K9's selection alone)"}
    assert set(results["graph_times"]) == sampler | {
        "grid_sample_points_fused", "fused_knn_vector_attention",
        "fused_anchor_vector_attention", "fused_vector_attention", "scatter_add_rows/self",
        "scatter_add_rows/cross", "index_add_/self", "index_add_/cross"} | k6 | selections | {
        "torch.topk of d2/cross (a yardstick)", "torch.topk of d2/self (a yardstick)",
        "select_candidate_buckets (K9's candidate choice)",
        "K9's attention (K1's chain at K9's indices)",
        "fused_knn_vector_attention_bucketed (K9 whole)"}
    for name, row in results["graph_times"].items():
        assert set(row) == {"ms", "graph_ms"} | ({"bound_ms"} if "grid_sample" in name else set()) \
            | ({"bound_ms", "bound_by", "plain_ms"} if name in selections else set())
    json.dumps(results)


def test_phase_selection_shapes_rehearsal(on_cpu):
    """Phase 1a's selections at tiny shapes: K1's with packed keys, K = N and
    duplicated points, K9's with a ragged block, the sentinel margin and a
    bucket size no multiple of 32; both sides run the plain version."""
    results = {}
    chip_smoke.phase_selection_shapes(results, Ns=(1, 33), Ms=(1, 5), Ks=(1, 8), k9_cases=(
        (2, 13, 256, 16, 4, 3, 8, True), (1, 7, 120, 24, 4, 5, 24, False)))
    # N 1: K 1; N 33: K 1, 8, 33; each with and without duplicates, at two M
    assert results["selection_shapes"] == dict(knn_select=16, knn_select_bucketed=2)
    json.dumps(results)


def test_phase_train_kernels_rehearsal(on_cpu):
    """Phase 1b at a tiny shape: K3b, K6 and K6b (self and cross) and K7 at the
    main width and at one other, which takes the branch that holds the kernels
    against the plain version on the same device; K3b from the saved output
    and logsumexp, with and without them, also at one sample and 68 keys."""
    results = {}
    chip_smoke.phase_train_kernels(results, B=2, M=19, D=32, K=8, N=64, wide=(48,),
                                   synthetic=(16, 4, 32))
    cases = ["dense_cross_attention_bwd", "knn_vector_attention_trainable/self",
             "knn_vector_attention_trainable/cross", "knn_vector_attention_trainable_bwd/self",
             "knn_vector_attention_trainable_bwd/cross", "scatter_add_rows/self",
             "scatter_add_rows/cross"]
    ragged = "ragged/dense_cross_attention_bwd/B1_N68"  # one sample, keys no tile divides
    # the synthetic model's width (here 16: head dim 4), K3b also over the main N keys
    synthetic = {f"synthetic/{c}/D16" for c in cases} | {
        "synthetic/dense_cross_attention_bwd/D16_N64"}
    assert set(results) == set(cases) | {f"wide/{c}/D48" for c in cases} | {ragged} | synthetic
    for case, by_dtype in results.items():
        assert set(by_dtype) == {"float32", "bfloat16"}, case
        for dt, row in by_dtype.items():
            assert row["bound_by"] in ("bytes", "operations") and row["bound_ms"] > 0
            assert (row["library_ms"] is None) == ("knn_vector_attention" in case)
            if "trainable_bwd" in case:  # K6b alone: its 14 gradients, launched twice
                assert row["bit_identical"]
                assert (row["max_rel_err_grads"] == 0.0) == (dt == "float32")
            elif "knn_vector_attention" in case:  # the 14 gradients, in both dtypes
                assert row["max_abs_err_grads"] is not None
            if "knn_vector_attention" not in case:
                assert row["max_abs_err"] == 0.0  # the same plain version on both sides
                assert row.get("lse_max_abs_err", 0.0) == 0.0
    # the kernels line takes the main width only
    assert {c.split("/")[0] for c in results} - {"wide", "ragged", "synthetic"} == {
        "dense_cross_attention_bwd", "knn_vector_attention_trainable",
        "knn_vector_attention_trainable_bwd", "scatter_add_rows"}
    json.dumps(results)


def test_phase_bucketed_rehearsal(on_cpu):
    """Phase 1c at a tiny shape: a generated 256-point ball in 16 buckets of 16,
    40 hand queries in blocks of 4 (5 candidate buckets certify some blocks, 11
    most); both sides run the plain version."""
    results = {}
    launches = chip_smoke.phase_bucketed(results, B=2, M=40, N=256, D=32, K=4, bucket_size=16,
                                         block_q=4, n_cand=5, n_cand_most=11, wide=(48,))
    assert launches == {k: 0 for k in chip_smoke.KERNELS}  # no kernel on the CPU
    name = "fused_knn_vector_attention_bucketed"
    assert set(results) == {name, f"wide/{name}/D48"}
    assert set(results[name]) == {"float32", "bfloat16"}
    for row in results[name].values():
        assert {"max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "k1_ms",
                "certified_share", "certified_share_most"} == set(row)
        assert row["max_abs_err"] == 0.0 and row["bound_by"] in ("bytes", "operations")
        assert 0.0 < row["certified_share"] <= row["certified_share_most"] <= 1.0
        assert row["certified_share_most"] >= 0.5
    json.dumps(results)


def test_phase_select_rehearsal(on_cpu):
    """Phase 1d at a tiny shape, the benchmark function included."""
    results = {}
    launches = chip_smoke.phase_select(results, B=2, M=32, N=256, K=8, block_q=16, chunk_j=4,
                                       device="cpu")
    assert launches["radix_select"] == 0
    row = results["radix_select"]["int32"]
    assert row["variant"] in ("scan32", "radix8") and row["max_abs_err"] == 0.0
    assert set(row["variants_ms"]) == set(row["variants_plain_ms"]) == {
        "pass1", "scan32", "radix8", "cur", "bcast"}
    assert row["bound_by"] == "bytes" and row["library_ms"] is not None
    assert set(row["prefix_keys_ms"]) == set(row["variants_ms"])  # the adversarial keys too
    json.dumps(results)


def test_same_neighbours_as_k1_allows_packed_key_ties_only():
    """K9 compares full float32 distances, K1 keys without their low 12 bits: a
    query may differ from K1 where its last two candidates tie in the upper 20
    bits, and nowhere else."""
    d2 = torch.tensor([[[1.0, 2.0, 2.0 + 2.0 ** -15, 3.0]]])   # columns 1 and 2 tie for K1
    idx9 = torch.tensor([[[0, 1]]], dtype=torch.int32)
    certified = torch.ones(1, 1, dtype=torch.bool)
    assert chip_smoke._same_neighbours_as_k1("t", idx9, idx9, d2, certified).all()
    tie = torch.tensor([[[0, 2]]], dtype=torch.int32)
    assert not chip_smoke._same_neighbours_as_k1("t", idx9, tie, d2, certified).any()
    other = torch.tensor([[[0, 3]]], dtype=torch.int32)
    with pytest.raises(AssertionError, match="beyond a packed-key tie"):
        chip_smoke._same_neighbours_as_k1("t", idx9, other, d2, certified)
    # a block that is not certified may differ from K1
    assert not chip_smoke._same_neighbours_as_k1("t", idx9, other, d2, ~certified).any()


def test_bounds_at_the_batch4_shapes():
    """The bounds chip_smoke reckons for K5 and K8 at B=4, V=8, NS=4096, C=D=256,
    bfloat16: 67.1 MB read and as much written over 3.35 TB/s, and three
    (102272 x 256) x (256 x 256) products over 989 TFLOP/s."""
    ms, by = chip_smoke.bound_ms(2 * 4 * 8 * 4096 * 256 * 2, 0.0, torch.bfloat16)
    assert by == "bytes" and ms == pytest.approx(0.0401, abs=1e-4)
    rows = 4 * 799 * 32
    ms, by = chip_smoke.bound_ms(2 * rows * 256 * 2, chip_smoke.attention_flops(rows, 256, 3),
                                 torch.bfloat16)
    assert by == "operations" and ms == pytest.approx(0.0408, abs=1e-4)


def test_mixed_view_mask_mixes_counts():
    for seed in range(5):
        mask = chip_smoke.mixed_view_mask(np.random.RandomState(seed), 4)
        n = mask.sum(1)
        assert mask.shape == (4, 8) and n.min() >= 2 and n.max() == 8 and (n != 8).any()
        assert (mask == (np.arange(8)[None] < n[:, None])).all()  # valid views come first


@pytest.fixture
def one_thread():
    """One intra-op thread for the CLI runs: the tier runs several test files at
    once on the host's cores, and more threads a process only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_phase_front_doors_rehearsal(on_cpu, one_thread, monkeypatch):
    """Phase 5 on the CPU at small sizes: the train CLI's epoch with validation
    and a checkpoint, the resumed run's next loss, the eval CLI with AUC, and the
    medium paths (a tiny HRNet model here); the launch counts each path must
    show on the card are those of the synthetic model and of the tiers."""
    from torch_port_helpers import tiny_cfg

    checked = {}
    monkeypatch.setattr(chip_smoke, "_check_launches",
                        lambda name, got, want: checked.__setitem__(name, (got, want)))
    results = {}
    out = chip_smoke.phase_front_doors(results, device="cpu", dtype="fp32", smoke_epoch=8,
                                       medium_model=tiny_cfg().to_dict(), medium_image=64,
                                       medium_views=2, medium_batch=2, medium_train=4,
                                       medium_test=2)
    assert set(checked) == {"synthetic train CLI", "synthetic eval CLI", "medium train CLI",
                            "medium eval CLI"}
    assert all(got == {k: 0 for k in chip_smoke.KERNELS} for got, _ in checked.values())
    mixed = out["synthetic_train"]["mixed_val_batches"]
    assert 0 < mixed < 4  # the test set mixes 1 and 2 views in some batches
    # 2 steps and 4 validation batches of the synthetic model
    want = checked["synthetic train CLI"][1]
    assert want == {**{k: 0 for k in chip_smoke.KERNELS}, "dense_cross_attention": 2 * 4 + 4 * 4,
                    "dense_cross_attention_bwd": 2 * 4, "fused_knn_vector_attention": 2 * 2 + 4 * 2,
                    "knn_vector_attention_trainable": 2 * 2,
                    "knn_vector_attention_trainable_bwd": 2 * 2, "scatter_add_rows": 2 * 2,
                    "fused_anchor_vector_attention": 4 * 2, "grid_sample_points_fused": 4,
                    "scrambled_merge_gather": mixed}
    want = checked["synthetic eval CLI"][1]
    assert want["dense_cross_attention"] == 16 and want["dense_cross_attention_bwd"] == 0
    want = checked["medium train CLI"][1]
    assert want["dense_cross_attention_bwd"] == 2 * 6 and want["dense_cross_attention"] == 3 * 6
    assert out["resume"]["next_loss"] == out["resume"]["uninterrupted"]
    assert out["synthetic_train"]["steps"] == 2 and out["medium_train"]["steps"] == 2
    assert out["synthetic_train"]["ckpt_bytes"] > 0
    assert 0.0 <= out["synthetic_eval"]["results"]["auc_j"] <= 1.0
    assert results["front_doors"] is out
    json.dumps({k: {kk: vv for kk, vv in v.items()} for k, v in out.items()})


def test_phase_6_rehearsal(on_cpu, one_thread, monkeypatch):
    """Phases 6a-6c on the CPU with the tiny HRNet model (``frozen_bn``, 2 decoder
    blocks), B2 of 2 views at 64 px, float32 timing: the world-1 group (gloo
    here) bit for bit against the single process, two rank processes of the
    script against the single process's step, the no-flash step against the
    flash one, and the reference-named checkpoint served bit-identically (B2 of
    3 views); the launch counts each path must show on the card."""
    from torch_port_helpers import tiny_cfg

    checked = {}
    monkeypatch.setattr(chip_smoke, "_check_launches",
                        lambda name, got, want: checked.__setitem__(name, (got, want)))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the rank processes, as this one
    results = {}
    cfg = tiny_cfg(norm="frozen_bn").to_dict()
    small = dict(device="cpu", model_cfg=cfg, image=64, views=2, batch=2,
                 timing_dtype=torch.float32, warmup=0, timed=1, rounds=1)
    zeros = {k: 0 for k in chip_smoke.KERNELS}
    assert chip_smoke.phase_ddp(results, **small) == zeros
    assert chip_smoke.phase_no_flash(results, **small) == zeros
    assert chip_smoke.phase_reference_checkpoint(results, device="cpu", model_cfg=cfg, image=64,
                                                 batch=2, views=3) == zeros
    assert set(checked) == {"DDP world 1 step (float32)", "DDP world 1 step", "no-flash step"}
    assert checked["no-flash step"][1] == {**zeros, "scatter_add_rows": 4}
    assert chip_smoke.TRAIN_PATH_KERNELS == [
        "dense_cross_attention", "dense_cross_attention_bwd", "fused_knn_vector_attention",
        "knn_vector_attention_trainable", "knn_vector_attention_trainable_bwd",
        "scatter_add_rows"]
    ddp, nf = results["ddp"], results["no_flash"]
    assert set(ddp["timing"]) == {"single process", "DDP world 1"}
    assert set(nf["timing"]) == {"flash step", "no-flash step"}
    for readings in (ddp["world2"], nf["float32"]):
        assert max(readings["loss_rel"].values()) <= chip_smoke.DDP_LOSS_RTOL
        assert set(readings["grad_rel"]) == {"backbone", "feat_neck", "uv_neck", "head",
                                             "head.transformer.block_0",
                                             "head.transformer.block_1"}
    assert results["reference_checkpoint"]["converted"] > 1000
    json.dumps(results)
