"""The port's data parallel (``DistributedDataParallel`` over gloo, two ranks on
the CPU) against the JAX package's global train step.

Two rank processes (``tests/torch_ddp_worker.py``, no JAX in them) take one
sample each of ``test_torch_train_step.py``'s batch (2 samples with 3 and 1 of 3
views) and its JAX reference-jitter draws, at the tiny ``frozen_bn`` config with
dropout 0. What the JAX package's sharded step computes on any data mesh is the
global step of that file's ``_run_jax_step``: the ranks' loss terms, their
averaged gradients and the updated parameters are held to it by that file's
rules. With each rank dividing by its own count of valid views, as a DDP loss
written for one process would, the loss terms miss it. The mesh helpers are
held against a JAX data mesh of two virtual CPU devices, and a two-rank run of
the train CLI against the single-process run.
"""

import copy
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import yaml

from torch_port_helpers import to_numpy_tree
from test_torch_train_step import (STEPS_PER_EPOCH, _cfg, _check_gradients, _check_loss_terms,
                                   _check_updated_params, _jax_step_inputs, _run_jax_step)

from poem_v2_tpu_torch.cli import train as train_cli
from poem_v2_tpu_torch.configs import SYNTHETIC_SMOKE
from poem_v2_tpu_torch.convert import flax_to_state_dict
from poem_v2_tpu_torch.models.poem import draw_ref_noise
from poem_v2_tpu_torch.parallel import mesh

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "torch_ddp_worker.py")


def start_ranks(jobs, tmp_path, world=2):
    """Start each (name, job, inputs) of ``jobs`` as ``world`` rank processes, all
    at once; ``collect`` waits for them."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    procs = []
    for name, job, inputs in jobs:
        inp = str(tmp_path / f"{name}_in.pt")
        torch.save(inputs, inp)
        for r in range(world):
            out = str(tmp_path / f"{name}_out{r}.pt")
            procs.append((name, r, out, subprocess.Popen(
                [sys.executable, WORKER, job, str(r), str(world), str(tmp_path / f"{name}_rdzv"),
                 inp, out], env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    return procs


def collect(procs, timeout=300):
    """{name: [rank 0's result, rank 1's, ...]} of ``start_ranks``' processes."""
    results = {}
    try:
        for name, r, out, proc in procs:
            log, _ = proc.communicate(timeout=timeout)
            assert proc.returncode == 0, f"{name} rank {r}:\n{log[-4000:]}"
            results.setdefault(name, []).append(torch.load(out, weights_only=False))
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The JAX global step, and both ranks of the DDP step with the global loss
    denominators and with per-rank ones; the ranks run while JAX compiles."""
    inp = _jax_step_inputs(_cfg())
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             flax_to_state_dict(to_numpy_tree(inp["variables"])).items()}
    inputs = dict(cfg=inp["cfg"].to_dict(), state_dict=state, batch=inp["batch"],
                  draws=inp["draws"], steps_per_epoch=STEPS_PER_EPOCH)
    procs = start_ranks([("global", "step", dict(inputs, local_denominator=False)),
                         ("local", "step", dict(inputs, local_denominator=True))],
                        tmp_path_factory.mktemp("ddp"))
    try:
        jax_step = _run_jax_step(inp["cfg"], inputs=inp)
    finally:
        ranks = collect(procs)
    return jax_step, ranks


@pytest.fixture(scope="module")
def jax_step(steps):
    return steps[0]


@pytest.fixture(scope="module")
def ranks(steps):
    return steps[1]


def _as_torch_step(rank):
    return dict(metrics=rank["metrics"], grads=rank["grads"], names=list(rank["params"]),
                model=types.SimpleNamespace(named_parameters=lambda: rank["params"].items()))


def test_ddp_step_loss_terms_match_jax(jax_step, ranks):
    """Every loss term and the gradient norm of the global batch, on both ranks:
    1e-5 relative of JAX's, as the single-process step."""
    for rank in ranks["global"]:
        _check_loss_terms(jax_step, _as_torch_step(rank))
    assert ranks["global"][0]["metrics"] == ranks["global"][1]["metrics"]


def test_ddp_step_gradients_match_jax(jax_step, ranks):
    """DDP's averaged gradients per module within 1e-4 of the module's largest JAX
    gradient, the same on both ranks. The parameters outside the step's autograd
    graph (DDP's unused parameters: the last block's FFN, whose features no
    output reads, and the heatmap neck's ``uv_in``) take zero gradients, as in
    JAX."""
    r0, r1 = ranks["global"]
    _check_gradients(jax_step, _as_torch_step(r0))
    assert r0["grads"].keys() == r1["grads"].keys()
    assert all(torch.equal(r0["grads"][k], r1["grads"][k]) for k in r0["grads"])
    unused = [k for k in r0["params"] if k.startswith(("head.transformer.block_1.ffn.",
                                                         "uv_neck.uv_in."))]
    assert len(unused) == 12  # 6 of the FFN (2 dense, 1 norm), 6 of uv_in (conv, frozen norm)
    for k in unused:
        assert not np.abs(jax_step["grads"][k]).any(), k
        assert k not in r0["grads"] or not r0["grads"][k].abs().max() > 0, k


def test_ddp_step_updated_params_match_jax(jax_step, ranks):
    """The parameters after clip + Adam, by the single-process step's rule, equal
    on both ranks."""
    r0, r1 = ranks["global"]
    _check_updated_params(jax_step, _as_torch_step(r0))
    assert all(torch.equal(v, r1["params"][k]) for k, v in r0["params"].items())


def test_per_rank_loss_denominators_miss_the_global_step(jax_step, ranks):
    """With each rank's masked view means divided by its own count of valid views
    (1 and 3 here), the mean over the ranks is not the global batch's mean: the
    loss terms fail the check the global denominators pass."""
    counts = sorted(int(m.sum()) for m in jax_step["batch"]["view_mask"])
    assert counts == [1, 3]
    with pytest.raises(AssertionError):
        _check_loss_terms(jax_step, _as_torch_step(ranks["local"][0]))


def test_ranks_draw_the_global_jitter_rows_and_their_own_dropout(jax_step, ranks):
    """``Trainer.step`` on the global batch: rank r keeps sample r and the rows r
    of the jitter a single process draws for the whole batch (the two scalar draws
    shared); its dropout seed is the step's seed + r, so rank 0 draws the single
    process's masks and rank 1 others."""
    seed = jax_step["cfg"].TRAIN.get("MANUAL_SEED", 1)
    gen = torch.Generator().manual_seed(seed)
    joints, shift, uniform = draw_ref_noise(gen, 2)
    step_seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
    with torch.random.fork_rng():
        torch.manual_seed(step_seed)
        single_mask = torch.nn.functional.dropout(torch.ones(4096), 0.5, training=True)
    for r, rank in enumerate(ranks["global"]):
        np.testing.assert_array_equal(rank["rows"].numpy(),
                                      jax_step["batch"]["master_joints_3d"][r:r + 1])
        assert torch.equal(rank["draws"][0], joints[r:r + 1])
        assert torch.equal(rank["draws"][1], shift) and torch.equal(rank["draws"][2], uniform)
    assert torch.equal(ranks["global"][0]["mask"], single_mask)
    assert not torch.equal(ranks["global"][1]["mask"], single_mask)


def test_shard_batch_is_the_jax_data_meshs_placement():
    """Rank r's rows of a global batch are those JAX's ``P("data")`` sharding puts
    on device r of a ``create_mesh(data=2)`` over two virtual CPU devices."""
    import jax

    from conftest import cpu_devices
    from poem_v2_tpu.parallel import mesh as jax_mesh

    rs = np.random.RandomState(0)
    batch = {"image": rs.rand(4, 2, 8, 8, 3).astype(np.float32),
             "view_mask": rs.rand(4, 2) > 0.5,
             "master_joints_3d": rs.rand(4, 21, 3).astype(np.float32)}
    jm = jax_mesh.create_mesh(data=2, devices=cpu_devices(2))
    sharded = jax_mesh.shard_batch(batch, jm)
    devices = list(jm.devices[:, 0])
    assert mesh.local_batch_size(4, 2) == jax_mesh.local_batch_size(4, jm) == 2
    for k, arr in sharded.items():
        for shard in arr.addressable_shards:
            r = devices.index(shard.device)
            np.testing.assert_array_equal(mesh.shard_batch(batch, r, 2)[k], np.asarray(shard.data))
    with pytest.raises(ValueError, match="does not divide"):
        mesh.local_batch_size(3, 2)
    assert jax.device_count() >= 2


def _smoke(tmp_path):
    """synthetic_smoke for 3 steps of a global batch of 4 at dropout 0, with a
    2-batch validation."""
    cfg = copy.deepcopy(SYNTHETIC_SMOKE)
    cfg["DATASET"]["TRAIN"]["EPOCH_SIZE"] = 12
    cfg["DATASET"]["TEST"]["EPOCH_SIZE"] = 8
    cfg["TRAIN"]["LOG_INTERVAL"] = 1
    cfg["MODEL"]["HEAD"]["TRANSFORMER"]["DROPOUT"] = 0.0
    path = tmp_path / "smoke.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_two_rank_train_cli_repeats_the_single_process_run(tmp_path, monkeypatch, one_thread):
    """``cli/train.py`` over two gloo ranks (``--mesh_data 2``, 2 samples a rank)
    reads the single-process run's losses to 1e-5 relative; rank 0 alone
    validates and writes a checkpoint."""
    path = _smoke(tmp_path)
    argv = ["-c", path, "--exp_id", "default", "--view_max", "2", "-b", "4", "--dtype", "fp32",
            "--device", "cpu"]
    (tmp_path / "ddp").mkdir()
    procs = start_ranks([("cli", "cli", dict(workdir=str(tmp_path / "ddp"),
                                            argv=argv + ["--mesh_data", "2"]))], tmp_path)
    (tmp_path / "single").mkdir()
    monkeypatch.chdir(tmp_path / "single")
    try:
        single = train_cli.main(argv)
    finally:
        r0, r1 = collect(procs)["cli"]
    assert len(single["losses"]) == 3 and (r0["world"], r1["world"]) == (2, 2)
    np.testing.assert_allclose(r0["losses"], single["losses"], rtol=1e-5)
    assert r1["losses"] == r0["losses"]
    assert r0["checkpoint"] is not None and r1["checkpoint"] is None
    assert len(r0["val"]) == 1 and r1["val"] == []
    runs = os.listdir(tmp_path / "ddp" / "exp")
    assert len(runs) == 1 and os.path.isfile(r0["checkpoint"]["path"])
    saved = torch.load(r0["checkpoint"]["path"], weights_only=False)
    assert saved["step"] == 3
