"""The port's ResNet-18 POEMNet (``TINY_MODEL_CFG``, the synthetic configs'
model) against the JAX POEMNet on the CPU, and K3's plain versions at its
head dim of 16.

The JAX model runs its serving path (``use_flash=True``) with the Pallas
kernels in interpret mode; the fused bilinear kernel is swapped for the
package's f32 ``grid_sample_points_matmul`` so the comparison measures the
algorithm, not that kernel's bf16 tap weights. The batch mixes view counts
(2 and 1 valid views of 2), so the mixed-view scramble runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from helpers import TINY_MODEL_CFG
from torch_port_helpers import fill_params, load_converted, look_at_cameras, pallas_interpret

from poem_v2_tpu_torch.models.poem import create_poem_model as torch_create
from poem_v2_tpu_torch.ops import cross_attn

# float32 on both sides, summed in other orders through a ResNet-18 and a
# 2-block decoder; 2e-5 m (0.02 mm) leaves margin without hiding a wrong
# neighbour or scramble row (those move points by millimetres)
ATOL_M = 2e-5
# integral 2D joints in pixels on 64 x 64 crops
ATOL_PX = 1e-3
# K3 at head dim 16: 1e-5 of the peak for the output and the gradients,
# 1e-5 absolute for the row logsumexp (float32 sums in other orders)
REL = 1e-5
LSE_ATOL = 1e-5


def _inputs(B=2, V=2, size=64, seed=0):
    rs = np.random.RandomState(seed)
    images = rs.uniform(-0.5, 0.5, (B, V, size, size, 3)).astype(np.float32)
    mask = np.ones((B, V), bool)
    mask[1, 1] = False
    intr, extr = look_at_cameras(rs, B, V, size)
    return images, mask, intr, extr


def test_resnet_slice_matches_jax_poemnet():
    from poem_v2_tpu.models.poem import create_poem_model as jax_create

    cfg = TINY_MODEL_CFG.clone()
    images, mask, intr, extr = _inputs()
    # the single-view sample takes its reference joints from here
    master = np.random.RandomState(1).normal(0, 0.03, (2, 21, 3)).astype(np.float32)
    master[..., 2] += 0.5
    jmodel, _ = jax_create(cfg, use_flash=True)
    rng = jax.random.PRNGKey(0)
    args = tuple(jnp.asarray(a) for a in (images, mask, intr, extr, master))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": rng, "noise": rng, "dropout": rng}, *args, train=False))
    variables = fill_params(shapes, gain=0.5)
    with pallas_interpret(exact_sampler=True), jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(variables, *args)
        want = jax.tree_util.tree_map(np.asarray, want)

    tmodel, _ = torch_create(cfg.to_dict(), device="cpu")
    load_converted(tmodel, variables)
    with torch.no_grad():
        got = tmodel(*(torch.from_numpy(a) for a in (images, mask, intr, extr, master)))

    for key, tol in (("pred_joints_uv", ATOL_PX), ("pred_ref_joints_3d", ATOL_M),
                     ("all_coords_preds", ATOL_M), ("pred_joints_3d", ATOL_M),
                     ("pred_verts_3d", ATOL_M)):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=tol, rtol=0,
                                   err_msg=key)


def _qkvd(B=4, M=133, N=256, nh=4, hd=16, seed=16):
    rs = np.random.RandomState(seed)
    # columns of unequal scale: a head that read another head's columns would show
    cols = np.linspace(0.5, 2.0, nh * hd).astype(np.float32)
    return [(rs.randn(B, n, nh * hd) * cols).astype(np.float32) for n in (M, N, N, M)]


def _close(got, want, rel=REL, msg=""):
    got, want = got.detach().numpy(), np.asarray(want)
    assert float(np.abs(got - want).max()) <= rel * float(np.abs(want).max()), msg


def test_dense_attention_head_dim_16_matches_jax_kernel():
    """K3's plain versions at the synthetic models' 4 heads of 16 against the
    JAX ``dense_cross_attention(interpret=True)``: the output, its gradients,
    and the row logsumexp against the JAX scaled logits'."""
    from poem_v2_tpu.ops.pallas_cross_attn import dense_cross_attention as jdense

    q, k, v, do = _qkvd()
    nh, hd, scale = 4, 16, 0.25
    with jax.default_matmul_precision("highest"):
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        want, vjp = jax.vjp(lambda a, b, c: jdense(a, b, c, num_heads=nh, sm_scale=scale,
                                                   interpret=True), jq, jk, jv)
        want_grads = vjp(jnp.asarray(do))
        qh = jq.reshape(*q.shape[:2], nh, hd)
        kh = jk.reshape(*k.shape[:2], nh, hd)
        want_lse = jax.nn.logsumexp(jnp.einsum("bmhd,bnhd->bhmn", qh, kh) * scale, axis=-1)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    out, lse = cross_attn.dense_cross_attention_forward(*t[:3], nh, scale, return_lse=True)
    _close(out, want, msg="out")
    assert float(np.abs(lse.numpy() - np.asarray(want_lse)).max()) <= LSE_ATOL
    for name, g, w in zip("qkv", cross_attn.dense_cross_attention_bwd(*t, nh, scale),
                          want_grads):
        _close(g, w, msg=f"d{name}")
    # the backward's formulas from the saved (out, lse), as the kernels run them
    for name, g, w in zip("qkv", cross_attn.plain_dense_cross_attention_bwd_from_lse(
            *t[:3], out, lse, t[3], nh, scale), want_grads):
        _close(g, w, msg=f"d{name} from (out, lse)")
