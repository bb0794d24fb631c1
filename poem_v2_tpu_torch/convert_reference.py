"""The released PyTorch POEM checkpoints <-> the port's ``state_dict``.

The port's own copy of the POEM part of ``poem_v2_tpu/utils/torch_convert.py``
(``convert_poem_checkpoint`` and the functions it calls). The JAX converter
fills a flax tree from a reference state dict; the port's layout is already
torch's, so here the same walk over the reference names builds a table:
reference key -> (port key, transpose). Arrays pass unchanged, except the
reference's ``nn.Linear`` weights that the port keeps (in, out) as flax does:
``w_ks`` / ``w_vs`` (``RawDense.kernel``) and the ``fc_delta`` / ``fc_gamma``
MLPs (``fc_delta_w1`` ...). BatchNorm statistics land in the FrozenBatchNorms
(``NORM: frozen_bn``) under the port's module names (``norm_i``, ``*_norm``).

The table serves both ways: :func:`convert_poem_checkpoint` loads a reference
state dict (leftover reference keys are returned, never dropped), and
:func:`to_reference` writes a port state dict under the reference names.
The reference's ``num_batches_tracked`` counters of the necks' ConvBlocks are
consumed and dropped, as the JAX converter consumes them; the backbone's stay
leftovers there and here. ``petr`` / ``metro`` / ``cmr`` / ``mvp`` wait for
their models.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .convert import _RAW_KERNELS, torch_key

# reference key -> (port key, or None for a key consumed and dropped; transpose)
Table = Dict[str, Tuple[Optional[str], bool]]


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """A reference checkpoint's state dict (under ``state_dict`` / ``model`` /
    ``net`` if the file nests it), DDP ``module.`` prefixes stripped."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "net"):
        if isinstance(payload, dict) and key in payload:
            payload = payload[key]
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in payload.items()}


class _Builder:
    """Collects the entries whose port key the model has."""

    def __init__(self, port_keys: Iterable[str]):
        self.port_keys = set(port_keys)
        self.table: Table = {}

    def put(self, ref: str, path: List[str], kind: str = "plain") -> None:
        """``ref`` -> the port key of the flax leaf ``path``, if the model has it.
        ``kind`` is how the JAX converter reads it: ``conv`` (OIHW -> HWIO, which
        the port's OIHW undoes), ``linear`` ((out, in) -> (in, out)) or ``plain``."""
        key = torch_key(tuple(path[:-1]), path[-1], 0)
        if key not in self.port_keys:
            return
        flax_layout = not (path[-1] == "kernel" and path[-2] not in _RAW_KERNELS)
        self.table[ref] = (key, kind == "linear" and flax_layout)

    def drop(self, ref: str) -> None:
        self.table[ref] = (None, False)


def convert_decoder_block(b: _Builder, prefix: str, path: List[str]) -> None:
    """One reference point_METRO_block (``prefix``, e.g.
    ``ptEmb_head.transformer.pt_metro_encoder.0.``) onto the block at ``path``."""

    def put(ref, sub):
        b.put(ref, path + sub + ["kernel"], "linear")
        b.put(ref.replace("weight", "bias"), path + sub + ["bias"])

    def put_ln(ref_prefix, sub):
        b.put(ref_prefix + "weight", path + sub + ["scale"])
        b.put(ref_prefix + "bias", path + sub + ["bias"])

    put(prefix + "embedding.weight", ["embedding"])
    for t_name, j_name in (("encoder.attn", "attn"), ("encoder.cross_attn", "cross_attn")):
        base = f"{prefix}{t_name}.self."
        for part in ("query", "key", "value"):
            put(f"{base}{part}.weight", [j_name, part])
        put(f"{prefix}{t_name}.output.dense.weight", [j_name, "out"])
        put_ln(f"{prefix}{t_name}.output.LayerNorm.", [j_name, "ln"])
    va = prefix + "encoder.vec_attn."
    for t_sub, j_sub in (("query_self_attn.", "query_self_attn"),
                         ("query_cross_attn.", "query_cross_attn")):
        base = va + t_sub
        for name in ("fc1", "fc2", "w_qs", "w_ks", "w_vs"):
            put(f"{base}{name}.weight", ["vec_attn", j_sub, name])
        for mlp in ("fc_delta", "fc_gamma"):
            for layer, suffix in (("0", "1"), ("2", "2")):
                b.put(f"{base}{mlp}.{layer}.weight", path + ["vec_attn", j_sub, f"{mlp}_w{suffix}"],
                      "linear")
                b.put(f"{base}{mlp}.{layer}.bias", path + ["vec_attn", j_sub, f"{mlp}_b{suffix}"])
    put(va + "reg_branch.0.weight", ["vec_attn", "reg_branch", "Dense_0"])
    put(va + "reg_branch.2.weight", ["vec_attn", "reg_branch", "Dense_1"])
    put(prefix + "encoder.intermediate.dense.weight", ["ffn", "intermediate"])
    put(prefix + "encoder.output.dense.weight", ["ffn", "output"])
    put_ln(prefix + "encoder.output.LayerNorm.", ["ffn", "ln"])
    put(prefix + "mano_linear.weight", ["mano_linear"])  # parametric output, last block only
    put(prefix + "flat_verts.weight", ["flat_verts"])


def convert_head(b: _Builder) -> None:
    """POEM_Generalized_Head: input_proj, adapt_pos3d, the merge nets, the query
    embedding and the decoder blocks."""
    for name in ("input_proj", "adapt_pos3d"):
        b.put(f"ptEmb_head.{name}.weight", ["head", name, "kernel"], "conv")
        b.put(f"ptEmb_head.{name}.bias", ["head", name, "bias"])
    for i in range(2):
        for j in range(2):
            ref = f"ptEmb_head.merge_net_feature.{i}.{2 * j}."
            path = ["head", "merge_feature", f"merge_net_{i}", f"Dense_{j}"]
            b.put(ref + "weight", path + ["kernel"], "linear")
            b.put(ref + "bias", path + ["bias"])
    b.put("ptEmb_head.query_feat_embedding.weight", ["head", "query_feat_embedding"])
    blocks = {int(m.group(1)) for k in b.port_keys
              if (m := re.match(r"head\.transformer\.block_(\d+)\.", k))}
    for i in sorted(blocks):
        convert_decoder_block(b, f"ptEmb_head.transformer.pt_metro_encoder.{i}.",
                              ["head", "transformer", f"block_{i}"])


def convert_frozen_bn(b: _Builder, ref_prefix: str, path: List[str]) -> None:
    """BatchNorm2d (weight / bias / running_mean / running_var) -> FrozenBatchNorm."""
    for ref, leaf in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                      ("running_var", "var")):
        b.put(f"{ref_prefix}.{ref}", path + [leaf])


def convert_resnet_backbone(b: _Builder, prefix: str = "img_backbone.",
                            arch: str = "resnet34") -> None:
    """A torchvision-layout ResNet: conv1 / bn1, then per block conv{i} / bn{i} and
    the downsample pair (``Conv_{n}`` / ``norm_{n}`` after the block's n convs)."""
    bb = ["backbone"]
    b.put(prefix + "conv1.weight", bb + ["stem_conv", "kernel"], "conv")
    convert_frozen_bn(b, prefix + "bn1", bb + ["stem_norm"])
    layers = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3), "resnet50": (3, 4, 6, 3)}[arch]
    n_convs = 3 if arch == "resnet50" else 2
    for li, n_blocks in enumerate(layers):
        for blk in range(n_blocks):
            t_base = f"{prefix}layer{li + 1}.{blk}."
            j_block = bb + [f"layer{li + 1}_block{blk}"]
            for ci in range(n_convs):
                b.put(t_base + f"conv{ci + 1}.weight", j_block + [f"Conv_{ci}", "kernel"], "conv")
                convert_frozen_bn(b, t_base + f"bn{ci + 1}", j_block + [f"FrozenBatchNorm_{ci}"])
            b.put(t_base + "downsample.0.weight", j_block + [f"Conv_{n_convs}", "kernel"], "conv")
            convert_frozen_bn(b, t_base + "downsample.1", j_block + [f"FrozenBatchNorm_{n_convs}"])


def convert_conv_block(b: _Builder, ref_prefix: str, path: List[str]) -> None:
    """The reference ConvBlock (conv + optional bn) -> ConvBlock (Conv_0 + norm_0)."""
    b.put(f"{ref_prefix}.conv.weight", path + ["Conv_0", "kernel"], "conv")
    b.put(f"{ref_prefix}.conv.bias", path + ["Conv_0", "bias"])
    convert_frozen_bn(b, f"{ref_prefix}.norm", path + ["FrozenBatchNorm_0"])
    b.drop(f"{ref_prefix}.norm.num_batches_tracked")


def convert_necks(b: _Builder) -> None:
    """feat_delayer / feat_in and uv_delayer / uv_out / uv_in, the same names for
    the ResNet and the HRNet necks."""
    for i in range(3):
        convert_conv_block(b, f"feat_delayer.{i}", ["feat_neck", f"ConvBlock_{i}"])
        convert_conv_block(b, f"uv_delayer.{i}", ["uv_neck", f"ConvBlock_{i}"])
    convert_conv_block(b, "feat_in", ["feat_neck", "feat_in"])
    convert_conv_block(b, "uv_out", ["uv_neck", "uv_out"])
    convert_conv_block(b, "uv_in", ["uv_neck", "uv_in"])


def convert_hrnet_backbone(b: _Builder, prefix: str = "img_backbone.") -> None:
    """The reference HRNet trunk (lib/models/backbones/hrnet.py): the stem, layer1's
    Bottlenecks, the transitions, stages 2-4 (branch BasicBlocks and fuse layers).
    The stages' module and block counts are the port model's. The ImageNet
    classification head is left to the leftovers."""
    bb = ["backbone"]

    def conv(ref, path):
        b.put(f"{prefix}{ref}.weight", bb + path + ["kernel"], "conv")

    def bn(ref, path):
        convert_frozen_bn(b, prefix + ref, bb + path)

    conv("conv1", ["stem1"])
    bn("bn1", ["stem1_norm"])
    conv("conv2", ["stem2"])
    bn("bn2", ["stem2_norm"])
    for blk in range(4):
        for ci in range(3):
            conv(f"layer1.{blk}.conv{ci + 1}", [f"layer1_block{blk}", f"Conv_{ci}"])
            bn(f"layer1.{blk}.bn{ci + 1}", [f"layer1_block{blk}", f"FrozenBatchNorm_{ci}"])
        conv(f"layer1.{blk}.downsample.0", [f"layer1_block{blk}", "Conv_3"])
        bn(f"layer1.{blk}.downsample.1", [f"layer1_block{blk}", "FrozenBatchNorm_3"])
    # same-resolution transitions are Sequential(conv, bn, relu); new branches nest it once
    for ref, name in (("transition1.0", "t1_b0"), ("transition1.1.0", "t1_b1"),
                      ("transition2.2.0", "t2_b2"), ("transition3.3.0", "t3_b3")):
        conv(ref + ".0", [name])
        bn(ref + ".1", [name + "_norm"])
    modules = {(int(m.group(1)), int(m.group(2))) for k in b.port_keys
               if (m := re.match(r"backbone\.stage(\d)_m(\d+)\.", k))}
    blocks = {int(m.group(1)) for k in b.port_keys
              if (m := re.match(r"backbone\.stage2_m0\.branch0_block(\d+)\.", k))}
    for s_idx, m in sorted(modules):
        t_mod, j_mod = f"stage{s_idx}.{m}.", f"stage{s_idx}_m{m}"
        for i in range(s_idx):
            for blk in sorted(blocks):
                for ci in range(2):
                    ref = f"{t_mod}branches.{i}.{blk}."
                    conv(ref + f"conv{ci + 1}", [j_mod, f"branch{i}_block{blk}", f"Conv_{ci}"])
                    bn(ref + f"bn{ci + 1}", [j_mod, f"branch{i}_block{blk}", f"FrozenBatchNorm_{ci}"])
        for i in range(s_idx):
            for j in range(s_idx):
                if j > i:
                    conv(f"{t_mod}fuse_layers.{i}.{j}.0", [j_mod, "fuse", f"up_{j}_to_{i}_conv"])
                    bn(f"{t_mod}fuse_layers.{i}.{j}.1", [j_mod, "fuse", f"up_{j}_to_{i}_norm"])
                for k in range(i - j):
                    conv(f"{t_mod}fuse_layers.{i}.{j}.{k}.0",
                         [j_mod, "fuse", f"down_{j}_to_{i}_conv{k}"])
                    bn(f"{t_mod}fuse_layers.{i}.{j}.{k}.1",
                       [j_mod, "fuse", f"down_{j}_to_{i}_norm{k}"])


def reference_table(port_keys: Iterable[str], arch: str) -> Table:
    """Reference key -> (port key, transpose) for a port model whose state dict has
    ``port_keys``; ``arch`` is ``BACKBONE.TYPE`` (``HRNet`` or resnet18 / 34 / 50)."""
    b = _Builder(port_keys)
    convert_head(b)
    if arch.lower().startswith("resnet"):
        convert_resnet_backbone(b, arch=arch.lower())
    elif arch == "HRNet":
        convert_hrnet_backbone(b)
    convert_necks(b)
    return b.table


def hrnet_table(port_keys: Iterable[str], prefix: str = "") -> Table:
    """The table of the HRNet trunk alone, for ImageNet weights named without the
    reference model's ``img_backbone.`` (``scripts/torch_prepare_hrnet.py``)."""
    b = _Builder(port_keys)
    convert_hrnet_backbone(b, prefix=prefix)
    return b.table


def _transposed(v):
    if isinstance(v, torch.Tensor):
        return v.t().contiguous()
    return np.ascontiguousarray(np.asarray(v).T)


def apply_table(state: Dict[str, Any], table: Table) -> Tuple[Dict[str, Any], List[str]]:
    """(port state dict, leftover reference keys) of a reference state dict."""
    out = {}
    for ref, v in state.items():
        port, transpose = table.get(ref, (None, False))
        if port is not None:
            out[port] = _transposed(v) if transpose else v
    return out, [k for k in state if k not in table]


def convert_poem_checkpoint(state: Dict[str, Any], port_keys: Iterable[str],
                            arch: str = "resnet34") -> Tuple[Dict[str, Any], List[str]]:
    """A full reference PtEmbedMultiviewStereoV2 state dict -> (the port's state dict
    of what it holds, leftover reference keys). The port model must be built with
    ``NORM: frozen_bn``; its keys come from ``model.state_dict()``."""
    return apply_table(state, reference_table(port_keys, arch))


def to_reference(port_state: Dict[str, Any], arch: str) -> Dict[str, Any]:
    """A port state dict under the reference names (the table read backwards)."""
    return {ref: _transposed(port_state[port]) if transpose else port_state[port]
            for ref, (port, transpose) in reference_table(port_state, arch).items()
            if port is not None}
