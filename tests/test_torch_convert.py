"""flax -> torch weight bridge: every flax leaf and every torch key is matched once."""

import jax
import numpy as np
import pytest

from torch_port_helpers import flax_model_shapes as _flax_shapes, zeros_like_shapes as _zeros

from poem_v2_tpu_torch.convert import flax_to_state_dict
from poem_v2_tpu_torch.models.poem import create_poem_model as torch_create


def _check_bijection(shapes, cfg_dict):
    n_leaves = len(jax.tree_util.tree_leaves(shapes))
    sd = flax_to_state_dict(_zeros(shapes))
    model, _ = torch_create(cfg_dict, device="cpu")
    tsd = model.state_dict()
    n_bn = sum(k.endswith("num_batches_tracked") for k in tsd)
    assert len(sd) == n_leaves + n_bn  # one key per flax leaf, plus BN step counters
    assert set(sd) == set(tsd), (sorted(set(sd) - set(tsd))[:5], sorted(set(tsd) - set(sd))[:5])
    for k, v in sd.items():
        assert tuple(tsd[k].shape) == v.shape, k


@pytest.mark.parametrize("norm", ["gn", "frozen_bn", "bn"])
def test_tiny_tree_maps_one_to_one(norm):
    from torch_port_helpers import tiny_cfg

    cfg = tiny_cfg(norm)
    _check_bijection(_flax_shapes(cfg, 64), cfg)


def test_medium_tree_maps_one_to_one():
    from poem_v2_tpu.utils.config import Config
    from poem_v2_tpu_torch.configs import MEDIUM

    # parameter shapes do not depend on the image size; 64 px keeps the trace small
    _check_bijection(_flax_shapes(Config(MEDIUM["MODEL"]), 64), MEDIUM["MODEL"])


def test_leaf_layouts():
    """conv HWIO -> OIHW, Dense (in, out) -> (out, in), raw kernels and MLP params as they are."""
    rs = np.random.RandomState(0)
    conv = rs.randn(3, 3, 4, 5).astype(np.float32)
    dense = rs.randn(4, 6).astype(np.float32)
    raw = rs.randn(6, 6).astype(np.float32)
    tree = {"params": {
        "c": {"Conv_0": {"kernel": conv}, "GroupNorm_0": {"scale": np.ones(5), "bias": np.zeros(5)}},
        "d": {"kernel": dense},
        "blk": {"w_ks": {"kernel": raw}, "fc_delta_w1": raw[:3]},
        "fbn": {"mean": np.zeros(2), "var": np.ones(2)},
    }, "batch_stats": {"bn": {"BatchNorm_1": {"mean": np.zeros(3), "var": np.ones(3)}}}}
    sd = flax_to_state_dict(tree)
    np.testing.assert_array_equal(sd["c.Conv_0.weight"], conv.transpose(3, 2, 0, 1))
    assert set(sd) >= {"c.norm_0.weight", "c.norm_0.bias", "fbn.running_mean", "fbn.running_var",
                       "bn.norm_1.running_mean", "bn.norm_1.num_batches_tracked"}
    np.testing.assert_array_equal(sd["d.weight"], dense.T)
    np.testing.assert_array_equal(sd["blk.w_ks.kernel"], raw)
    np.testing.assert_array_equal(sd["blk.fc_delta_w1"], raw[:3])
