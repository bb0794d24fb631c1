"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Both sides get the same numpy inputs and the same parameters: a flax
parameter tree from ``jax.eval_shape`` filled by ``np.random.RandomState``,
converted for the port by ``poem_v2_tpu_torch.convert``. Where the JAX
side reaches a Pallas kernel, :func:`pallas_interpret` runs it in
interpret mode on the CPU.
"""

from __future__ import annotations

import contextlib

import jax
import numpy as np
import torch

from poem_v2_tpu_torch.convert import flax_to_state_dict
from torch_cameras import look_at_cameras  # noqa: F401 (the tests import it from here)


def fill_params(shapes, seed: int = 0, gain: float = 1.0):
    """Random numpy values for an ``eval_shape`` tree: matrices ~ N(0, gain^2 / fan_in)
    over their input axes, vectors ~ N(0, 0.1) (norm scales around 1)."""
    rs = np.random.RandomState(seed)

    def one(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (gain * rs.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return (1.0 + 0.1 * rs.randn(*s.shape)).astype(np.float32)
        return (0.1 * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def tiny_cfg(norm: str = "gn"):
    """The tiny HRNet POEM config: width 8, embed 32, 256 BPS points, 2 blocks, K=8."""
    from __graft_entry__ import _tiny_cfg as graft_tiny

    cfg = graft_tiny(embed=32, nsample=256, image=64, backbone="HRNet")
    cfg.BACKBONE.WIDTH = 8
    cfg.BACKBONE.NORM = norm
    cfg.HEAD.IN_CHANNELS = 32
    return cfg


def flax_model_shapes(cfg, size: int):
    """``eval_shape`` of the JAX POEMNet's variables for ``cfg`` at ``size`` px
    (parameter shapes do not depend on the image size)."""
    import jax.numpy as jnp

    from poem_v2_tpu.models.poem import create_poem_model as jax_create

    # use_flash=False: the parameter tree is the same, and init traces no Pallas call
    model, _ = jax_create(cfg, use_flash=False)
    B, V = 1, 1
    args = (jnp.zeros((B, V, size, size, 3)), jnp.ones((B, V), bool),
            jnp.tile(jnp.eye(3) * 100, (B, V, 1, 1)), jnp.tile(jnp.eye(4), (B, V, 1, 1)))
    rng = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: model.init(
        {"params": rng, "noise": rng, "dropout": rng}, *args, None, train=False))


def zeros_like_shapes(shapes):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def load_converted(module: torch.nn.Module, variables, prefix: str = "") -> None:
    """Load converted flax ``variables`` into ``module`` (strict: every key once)."""
    sd = flax_to_state_dict(to_numpy_tree(variables))
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                           strict=True)


@contextlib.contextmanager
def pallas_interpret(exact_sampler: bool = False):
    """Run the JAX package's Pallas eval kernels with ``interpret=True``.

    ``exact_sampler`` swaps the fused bilinear kernel (bf16 tap weights) for
    the package's f32 ``grid_sample_points_matmul``."""
    import poem_v2_tpu.ops.pallas_bilinear as pb
    import poem_v2_tpu.ops.pallas_cross_attn as pc
    import poem_v2_tpu.ops.pallas_knn_attn as pk
    from poem_v2_tpu.ops.sampling import grid_sample_points_matmul

    saved = (pk.fused_knn_vector_attention, pk.fused_anchor_vector_attention,
             pc.dense_cross_attention, pb.grid_sample_points_fused)
    knn, anchor, dense, bil = saved

    def interp(fn):
        def run(*a, **kw):
            kw["interpret"] = True
            return fn(*a, **kw)
        return run

    pk.fused_knn_vector_attention = interp(knn)
    pk.fused_anchor_vector_attention = interp(anchor)
    pc.dense_cross_attention = interp(dense)
    pb.grid_sample_points_fused = (
        (lambda feat, coords, **kw: grid_sample_points_matmul(feat, coords))
        if exact_sampler else interp(bil))
    try:
        yield
    finally:
        (pk.fused_knn_vector_attention, pk.fused_anchor_vector_attention,
         pc.dense_cross_attention, pb.grid_sample_points_fused) = saved


def small_metro_stage(monkeypatch):
    """Make the heads of both packages build PtEmbedTRv3 with a small METRO stage
    (hidden 64 / 32, outputs 32 / 3, one layer a block: tests/test_baselines.py's
    sizes) in place of the full one (1024 / 256 / 64 hidden, 4 layers a block),
    whose FFNs over 799 + N_SAMPLE tokens dominate a tiny model's CPU time. The
    full stage is held on the card by chip_smoke.py."""
    import poem_v2_tpu.models.decoder_v3 as jax_v3
    import poem_v2_tpu_torch.models.decoder_v3 as torch_v3

    small = dict(vt_hidden_dims=(64, 32), vt_output_dims=(32, 3), vt_num_layers=1)

    class JaxSmall(jax_v3.PtEmbedTRv3):
        vt_hidden_dims: tuple = small["vt_hidden_dims"]
        vt_output_dims: tuple = small["vt_output_dims"]
        vt_num_layers: int = small["vt_num_layers"]

    class TorchSmall(torch_v3.PtEmbedTRv3):
        def __init__(self, **kw):
            super().__init__(**{**small, **kw})

    monkeypatch.setattr(jax_v3, "PtEmbedTRv3", JaxSmall)
    monkeypatch.setattr(torch_v3, "PtEmbedTRv3", TorchSmall)


@contextlib.contextmanager
def one_thread_no_tf32():
    """TF32 off and one intra-op thread (the tier runs several test files at once
    on the host's cores, and more threads a process only contend)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.get_num_threads()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_num_threads(saved[1])


def assert_grads_match(want_tree, module, extra=(), rel=1e-4):
    """Flax gradients ``want_tree`` (converted like parameters) against the port
    module's ``.grad``, and the ``extra`` (name, got, want) arrays: each to ``rel``
    of the largest gradient of the same tensor, plus 1e-6 of the global peak."""
    want = flax_to_state_dict({"params": to_numpy_tree(want_tree)})
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(want) == set(got) and all(g is not None for g in got.values())
    pairs = [(k, got[k].numpy(), w) for k, w in want.items()] + list(extra)
    peak = max(float(np.abs(w).max()) for _, _, w in pairs)
    assert peak > 0
    for name, g, w in pairs:
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max() + 1e-6 * peak,
                                   err_msg=name)


def baseline_inputs(seed=0, B=2, V=3, image=64):
    """A padded multi-view batch, view V - 1 of sample 1 padded: images (B, V, image,
    image, 3) in [-0.5, 0.5], view mask, intr, extr (``look_at_cameras``)."""
    rs = np.random.RandomState(seed)
    images = rs.uniform(-0.5, 0.5, (B, V, image, image, 3)).astype(np.float32)
    mask = np.ones((B, V), bool)
    mask[1, V - 1] = False
    intr, extr = look_at_cameras(rs, B, V, image)
    return images, mask, intr, extr


# the baseline heads at tiny widths (tests/test_torch_petr.py, test_torch_mvp.py)
PETR_HEAD_KW = dict(embed_dims=32, in_channels=32, num_query=64, num_preds=2, depth_num=8,
                    pe_num_feats=16, num_heads=4, feedforward_channels=64)
MVP_HEAD_KW = dict(embed_dims=32, num_layers=2, num_heads=4, num_points=2, d_ffn=64,
                   image_size=(64, 64))
MVP_LEVELS = ((8, 16), (4, 24), (2, 32))  # (size, channels) of the feature levels, finest first


def petr_head_inputs(seed=0, B=2, V=3, hw=4, C=32, nq=64, image=64):
    """Channels-last features (B, V, hw, hw, C), view V - 1 of sample 1 padded, the
    cameras, and an (nq, 3) template around 0.5 m."""
    rs = np.random.RandomState(seed)
    feat = rs.randn(B, V, hw, hw, C).astype(np.float32)
    mask = np.ones((B, V), bool)
    mask[1, V - 1] = False
    intr, extr = look_at_cameras(rs, B, V, image)
    template = (rs.randn(nq, 3) * 0.05 + [0.0, 0.0, 0.5]).astype(np.float32)
    return feat, mask, intr, extr, template


def mvp_head_inputs(seed=0, B=2, V=3, image=64):
    """The ``MVP_LEVELS`` feature levels (B, V, s, s, c), view V - 1 of sample 1
    padded, and the cameras."""
    rs = np.random.RandomState(seed)
    feats = [rs.randn(B, V, s, s, c).astype(np.float32) for s, c in MVP_LEVELS]
    mask = np.ones((B, V), bool)
    mask[1, V - 1] = False
    intr, extr = look_at_cameras(rs, B, V, image)
    return feats, mask, intr, extr
