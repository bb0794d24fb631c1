"""The baselines' weight converters on the CPU: ``convert.py`` (flax -> port) for
every new leaf, and ``convert_reference.py``'s reference-name tables
(``convert_petr_head``, ``convert_mvp_head``, ``convert_metro_network``) against
the JAX converters of the same names.

The reference state dicts are fabricated: random flax parameters (gain 0.5)
converted to the port and written under the reference names by the port's own
table (:func:`table_to_reference`), plus a random tensor for every key the table
consumes and drops (the PETR reg branch's level aliases, MVP's dead modules and
``num_batches_tracked`` counters, METRO's dead ``bert.embeddings`` /
``bert.pooler``). The JAX converter must then consume exactly the table's keys
(METRO's dead ones aside, which it leaves over) and fill the same arrays, bit
for bit; and the port's forward on the reference-named weights must equal the
JAX forward on the JAX converter's (2e-5 m, as in the heads' parity files).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (MVP_HEAD_KW, MVP_LEVELS, PETR_HEAD_KW, fill_params,
                                mvp_head_inputs, one_thread_no_tf32, petr_head_inputs,
                                to_numpy_tree)

from poem_v2_tpu_torch import convert_reference as cr
from poem_v2_tpu_torch.convert import flax_to_state_dict
from poem_v2_tpu_torch.mano.layer import ManoLayer
from poem_v2_tpu_torch.models import metro, mvp, petr

METRO_CFG = {"BACKBONE": {"TYPE": "resnet18", "NORM": "gn"}, "INPUT_FEAT_DIM": [515, 64, 16],
             "HIDDEN_FEAT_DIM": [64, 32, 16]}


@pytest.fixture(autouse=True)
def cpu_settings():
    with one_thread_no_tf32():
        yield


class Case:
    """One model of both packages: the JAX module, its init arguments, the port
    module, the port's table and the JAX converter."""

    def __init__(self, name, norm="frozen_bn"):
        from poem_v2_tpu.mano import ManoLayer as JaxMano
        from poem_v2_tpu.models.mvp import MVPHead
        from poem_v2_tpu.models.petr import PETRHead, PETRHeadFTL
        from poem_v2_tpu.utils import torch_convert as tc

        self.name, self.kwargs = name, {}
        if name.startswith("petr"):
            ftl = name == "petr_ftl"
            self.jmod = (PETRHeadFTL if ftl else PETRHead)(**PETR_HEAD_KW)
            self.tmod = (petr.PETRHeadFTL if ftl else petr.PETRHead)(**PETR_HEAD_KW)
            self.args = petr_head_inputs()
            self.kwargs = {"inp_res": (64, 64)}
            self.table = lambda keys: cr.convert_petr_head(keys, path=())
            self.jax_convert = tc.convert_petr_head
        elif name == "mvp":
            self.jmod = MVPHead(**MVP_HEAD_KW, delayer_norm=norm, mano_layer=JaxMano(center_idx=0))
            self.tmod = mvp.MVPHead(**MVP_HEAD_KW, delayer_norm=norm,
                                    mano_layer=ManoLayer(center_idx=0), num_views=3,
                                    in_channels=tuple(c for _, c in MVP_LEVELS[::-1]))
            self.args = mvp_head_inputs()
            self.table = lambda keys: cr.convert_mvp_head(keys, path=())
            self.jax_convert = tc.convert_mvp_head
        else:
            from poem_v2_tpu.models.backbones.resnet import ResNet
            from poem_v2_tpu.models.metro import METRONetwork
            from poem_v2_tpu.utils.config import Config

            # the JAX network on the port factory's template and samplers (the JAX
            # factory's are the same, tests/test_torch_metro.py; building them with
            # JAX ops costs seconds of eager compiles and changes no parameter shape)
            self.tmod, aux = metro.create_metro_model(METRO_CFG, device="cpu")
            ref = self.tmod._template_ref
            self.jmod = METRONetwork(
                ResNet.from_config(Config(METRO_CFG["BACKBONE"])), aux["downsample"],
                aux["upsample"], ref[:21], ref[21:], tuple(METRO_CFG["INPUT_FEAT_DIM"]),
                tuple(METRO_CFG["HIDDEN_FEAT_DIM"]))
            self.args = (np.random.RandomState(1).uniform(-0.5, 0.5, (2, 64, 64, 3))
                         .astype(np.float32),)
            self.table = cr.convert_metro_network
            self.jax_convert = tc.convert_metro_network
        self.tmod.eval()

    def jargs(self):
        return [[jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x)
                for x in self.args]

    def shapes(self):
        if not hasattr(self, "_shapes"):
            rng = jax.random.PRNGKey(0)
            self._shapes = jax.eval_shape(lambda: self.jmod.init(
                {"params": rng, "dropout": rng}, *self.jargs(), **self.kwargs))
        return self._shapes

    def jax_forward(self, variables):
        key = "all_coords_preds"
        with jax.default_matmul_precision("highest"):
            out = jax.jit(lambda v, *a: self.jmod.apply(v, *a, **self.kwargs))(
                variables, *self.jargs())
        return np.asarray(out[key]), key

    def torch_forward(self, key):
        t = [[torch.from_numpy(a) for a in x] if isinstance(x, list) else torch.from_numpy(x)
             for x in self.args]
        with torch.no_grad():
            return self.tmod(*t, **self.kwargs)[key].numpy()


def fabricate_reference(case, seed=0):
    """(port state dict from random flax parameters, the table, the reference-named
    state dict the table gives, with every dropped key filled in)."""
    variables = fill_params(case.shapes(), seed=seed, gain=0.5)
    port_sd = flax_to_state_dict(to_numpy_tree({"params": variables["params"]}))
    table = case.table(case.tmod.state_dict().keys())
    ref = cr.table_to_reference({k: torch.from_numpy(np.array(v)) for k, v in port_sd.items()},
                                table)
    g = torch.Generator().manual_seed(seed)
    for k, (port, _) in table.items():
        if port is None and k not in ref:
            ref[k] = torch.randn(4, 3, generator=g)
    ref["unrelated.weight"] = torch.zeros(2)  # not in the table: a leftover on both sides
    return variables, port_sd, table, ref


def jax_params_of(case, ref):
    """(flax params tree filled by the JAX converter from zeros, consumed keys)."""
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                    case.shapes()["params"])
    used = case.jax_convert(ref, params)
    return params, used


@pytest.mark.parametrize("name", ["petr", "mvp", "metro"])
def test_reference_table_is_the_jax_converter(name):
    """The port's table consumes the JAX converter's keys (and METRO's dead BERT
    modules, which JAX leaves over) and gives its arrays bit for bit."""
    case = Case(name)
    _, port_sd, table, ref = fabricate_reference(case)
    params, used = jax_params_of(case, ref)
    dead = {k for k in table if any(k.endswith("bert." + d) for d in cr.METRO_DEAD)}
    assert set(table) == set(used) | dead and (name == "metro") == bool(dead)
    want = flax_to_state_dict({"params": params})
    got, left = cr.apply_table(ref, table)
    assert set(left) == set(ref) - set(used) - dead
    assert "unrelated.weight" in left
    if name == "metro":  # the backbone is in neither converter
        want = {k: v for k, v in want.items() if not k.startswith("backbone.")}
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.array_equal(np.asarray(got[k]), w), k
        assert np.array_equal(w, port_sd[k]), k
    if name == "petr":  # the packed projections split into q / k / v
        w = ref["transformer.decoder.layers.1.attentions.0.attn.in_proj_weight"]
        assert w.shape == (3 * 32, 32)
        assert torch.equal(torch.as_tensor(got["transformer.layer_1.attn_0.v_proj.weight"]),
                           w[64:])


@pytest.mark.parametrize("name", ["petr", "mvp"])
def test_reference_named_weights_give_the_jax_forward(name):
    """A reference-named state dict: the port (through its table) and JAX (through
    its converter) give the same forward. METRO's table gives the JAX converter's
    parameters bit for bit (above), whose forward ``test_torch_metro.py`` holds;
    ``chip_smoke.py`` phase 10d runs its round trip's forward on the card."""
    case = Case(name)
    variables, port_sd, table, ref = fabricate_reference(case, seed=1)
    params, _ = jax_params_of(case, ref)
    want, key = case.jax_forward({**variables, "params": params})
    got_sd, _ = cr.apply_table(ref, table)
    sd = case.tmod.state_dict()
    assert set(got_sd) <= set(sd)
    sd.update({k: torch.as_tensor(v) for k, v in got_sd.items()})
    case.tmod.load_state_dict(sd, strict=True)
    np.testing.assert_allclose(case.torch_forward(key), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name,norm", [("petr", None), ("petr_ftl", None), ("mvp", "bn"),
                                       ("mvp", "frozen_bn")])
def test_flax_trees_convert_to_every_port_key(name, norm):
    """``convert.py`` on the baselines' flax variables: every port key once, with
    its shape (``reference_points``, ``tgt_pose_embedding``, the delayers'
    BatchNorm statistics and counters among them)."""
    case = Case(name, norm or "frozen_bn")
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), case.shapes())
    variables.pop("dropout", None)
    sd = flax_to_state_dict(variables)
    want = case.tmod.state_dict()
    assert set(sd) == set(want)
    assert all(tuple(np.shape(sd[k])) == tuple(v.shape) for k, v in want.items())
    if name == "mvp":
        stats = "feat_delayer_0.norm_0.num_batches_tracked" in sd
        assert stats == (norm == "bn") and "tgt_pose_embedding" in sd
        # the bn head's counters map from the reference's; frozen_bn drops them
        table = cr.convert_mvp_head(want.keys(), path=())
        port = table["feat_delayer.0.norm.num_batches_tracked"][0]
        assert port == ("feat_delayer_0.norm_0.num_batches_tracked" if stats else None)
    else:
        assert sd["reference_points"].shape == (PETR_HEAD_KW["num_query"], 3)
