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
consumed and dropped, as the JAX converter consumes them (kept where the port's
ConvBlock has a ``bn`` norm with such a counter); the backbone's stay leftovers
there and here.

The baselines' tables come from the JAX converters of the same names:
:func:`convert_petr_head`, :func:`convert_mvp_head` and
:func:`convert_metro_network`. A packed ``nn.MultiheadAttention`` ``in_proj``
maps to a tuple of port keys (q, k, v): :func:`apply_table` splits it into
equal row blocks and :func:`table_to_reference` concatenates them back. CMR's table
(:func:`convert_cmr_network`) follows the JAX converter of the same name.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List, Sequence, Tuple, Union

import numpy as np
import torch

from .convert import _RAW_KERNELS, torch_key

# reference key -> (port key, a tuple of port keys for a packed array split into equal
# row blocks, or None for a key consumed and dropped; transpose)
Table = Dict[str, Tuple[Union[None, str, Tuple[str, ...]], bool]]


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

    def put_packed(self, ref: str, paths: Sequence[List[str]]) -> None:
        """``ref`` -> the port keys of ``paths``, one equal row block each (a packed
        q / k / v projection), if the model has them all."""
        keys = tuple(torch_key(tuple(p[:-1]), p[-1], 0) for p in paths)
        if all(k in self.port_keys for k in keys):
            self.table[ref] = (keys, False)

    def drop(self, ref: str) -> None:
        self.table[ref] = (None, False)


def _put_linear(b: _Builder, ref: str, path: List[str]) -> None:
    """A reference ``nn.Linear`` / ``Conv2d`` (``ref`` ends in ``weight``) and its bias."""
    b.put(ref, path + ["kernel"], "linear")
    b.put(ref[:-len("weight")] + "bias", path + ["bias"])


def _put_norm(b: _Builder, ref_prefix: str, path: List[str]) -> None:
    b.put(ref_prefix + "weight", path + ["scale"])
    b.put(ref_prefix + "bias", path + ["bias"])


def convert_decoder_block(b: _Builder, prefix: str, path: List[str]) -> None:
    """One reference point_METRO_block (``prefix``, e.g.
    ``ptEmb_head.transformer.pt_metro_encoder.0.``) onto the block at ``path``."""

    def put(ref, sub):
        _put_linear(b, ref, path + sub)

    def put_ln(ref_prefix, sub):
        _put_norm(b, ref_prefix, path + sub)

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
                            arch: str = "resnet34", path: Sequence[str] = ("backbone",)) -> None:
    """A torchvision-layout ResNet onto the trunk at ``path``: conv1 / bn1, then per
    block conv{i} / bn{i} and the downsample pair (``Conv_{n}`` / ``norm_{n}`` after
    the block's n convs)."""
    bb = list(path)
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
    counter = f"{ref_prefix}.norm.num_batches_tracked"
    b.put(counter, path + ["FrozenBatchNorm_0", "num_batches_tracked"])
    if counter not in b.table:
        b.drop(counter)


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
        if isinstance(port, tuple):
            n = len(v) // len(port)
            out.update((k, v[i * n:(i + 1) * n]) for i, k in enumerate(port))
        elif port is not None:
            out[port] = _transposed(v) if transpose else v
    return out, [k for k in state if k not in table]


def table_to_reference(port_state: Dict[str, Any], table: Table) -> Dict[str, Any]:
    """A port state dict under the reference names of ``table`` (read backwards);
    dropped reference keys are not written."""
    out = {}
    for ref, (port, transpose) in table.items():
        if isinstance(port, tuple):
            parts = [port_state[k] for k in port]
            out[ref] = (torch.cat(parts) if isinstance(parts[0], torch.Tensor)
                        else np.concatenate(parts))
        elif port is not None:
            out[ref] = _transposed(port_state[port]) if transpose else port_state[port]
    return out


def convert_poem_checkpoint(state: Dict[str, Any], port_keys: Iterable[str],
                            arch: str = "resnet34") -> Tuple[Dict[str, Any], List[str]]:
    """A full reference PtEmbedMultiviewStereoV2 state dict -> (the port's state dict
    of what it holds, leftover reference keys). The port model must be built with
    ``NORM: frozen_bn``; its keys come from ``model.state_dict()``."""
    return apply_table(state, reference_table(port_keys, arch))


def to_reference(port_state: Dict[str, Any], arch: str) -> Dict[str, Any]:
    """A port state dict under the reference names (the table read backwards)."""
    return table_to_reference(port_state, reference_table(port_state, arch))


def _layer_indices(port_keys: Iterable[str], pattern: str) -> List[int]:
    return sorted({int(m.group(1)) for k in port_keys if (m := re.match(pattern, k))})


def _put_mha(b: _Builder, ref_prefix: str, path: List[str]) -> None:
    """A reference ``nn.MultiheadAttention``: its packed in_proj split into the
    port's q / k / v projections, and out_proj."""
    for leaf in ("weight", "bias"):
        b.put_packed(f"{ref_prefix}in_proj_{leaf}",
                     [path + [proj, "kernel" if leaf == "weight" else "bias"]
                      for proj in ("q_proj", "k_proj", "v_proj")])
    _put_linear(b, f"{ref_prefix}out_proj.weight", path + ["out_proj"])


def convert_petr_head(port_keys: Iterable[str], prefix: str = "",
                      path: Sequence[str] = ("head",)) -> Table:
    """Table of a reference ``PETRHead`` (keys under ``prefix``) onto the port's
    PETR head at ``path`` (``()`` for a head alone): the 1x1 convs, the reference
    points' embedding table, the query embedding, ONE shared reg branch read from
    level 0 (the reference repeats one Sequential: the other levels' keys are
    consumed and dropped), and per decoder layer the packed attention split into
    q / k / v, the mmcv FFN and three norms, then the sequence's ``post_norm``."""
    b = _Builder(port_keys)
    h = list(path)
    for ref, sub in (("input_proj", ["input_proj"]), ("adapt_pos3d.0", ["adapt_pos3d_1"]),
                     ("adapt_pos3d.2", ["adapt_pos3d_2"]),
                     ("position_encoder.0", ["position_encoder", "pe_conv1"]),
                     ("position_encoder.2", ["position_encoder", "pe_conv2"]),
                     ("query_embedding.0", ["query_embedding_1"]),
                     ("query_embedding.2", ["query_embedding_2"])):
        _put_linear(b, f"{prefix}{ref}.weight", h + sub)
    b.put(f"{prefix}reference_points.weight", h + ["reference_points"])
    head_keys = [k for k in b.port_keys if k.startswith(".".join(h + ["reg_fc"]))]
    n_fc = len({k.rsplit(".", 1)[0] for k in head_keys})
    for i in range(n_fc):
        _put_linear(b, f"{prefix}reg_branches.0.{2 * i}.weight", h + [f"reg_fc{i}"])
    _put_linear(b, f"{prefix}reg_branches.0.{2 * n_fc}.weight", h + ["reg_out"])
    tr = ".".join(h + ["transformer"])
    layers = _layer_indices(b.port_keys, re.escape(tr) + r"\.layer_(\d+)\.")
    for lvl in layers[1:]:  # the repeated reg branch's aliases
        for i in range(n_fc + 1):
            for leaf in ("weight", "bias"):
                b.drop(f"{prefix}reg_branches.{lvl}.{2 * i}.{leaf}")
    for i in layers:
        t, layer = f"{prefix}transformer.decoder.layers.{i}.", h + ["transformer", f"layer_{i}"]
        for ai in range(2):
            _put_mha(b, f"{t}attentions.{ai}.attn.", layer + [f"attn_{ai}"])
        _put_linear(b, f"{t}ffns.0.layers.0.0.weight", layer + ["ffn_0", "fc1"])
        _put_linear(b, f"{t}ffns.0.layers.1.weight", layer + ["ffn_0", "fc2"])
        for ni in range(3):
            _put_norm(b, f"{t}norms.{ni}.", layer + [f"norm_{ni}"])
    _put_norm(b, f"{prefix}transformer.decoder.post_norm.", h + ["transformer", "post_norm"])
    return b.table


# constructed by the reference's MVPHead.__init__, never called in its forward
MVP_DEAD = ("input_proj", "layer_global_feat", "query_embedding.0", "query_embedding.2")


def convert_mvp_head(port_keys: Iterable[str], prefix: str = "",
                     path: Sequence[str] = ("head",)) -> Table:
    """Table of a reference ``MVPHead`` onto the port's at ``path``: the three
    ``feat_delayer`` ConvBlocks (BatchNorm onto the port's ``bn`` or ``frozen_bn``
    norm), ``reference_feats`` / ``reference_points`` and the ``tgt_pose_embedding``
    table, per decoder layer the packed self-attention split into q / k / v, the
    ProjAttn linears, four norms, the FFN and MANO linears, and the head's per-layer
    reg branches. The reference's dead ``input_proj``, ``layer_global_feat`` and
    ``query_embedding`` are consumed and dropped."""
    b = _Builder(port_keys)
    h = list(path)
    for i in range(3):
        convert_conv_block(b, f"{prefix}feat_delayer.{i}", h + [f"feat_delayer_{i}"])
    _put_linear(b, f"{prefix}reference_feats.weight", h + ["reference_feats"])
    _put_linear(b, f"{prefix}reference_points.weight", h + ["reference_points"])
    b.put(f"{prefix}tgt_pose_embedding.weight", h + ["tgt_pose_embedding"])
    for dead in MVP_DEAD:
        b.drop(f"{prefix}{dead}.weight")
        b.drop(f"{prefix}{dead}.bias")
    head = ".".join(h + [""]) if h else ""
    for i in _layer_indices(b.port_keys, re.escape(head) + r"layer_(\d+)\."):
        t, layer = f"{prefix}decoder.layers.{i}.", h + [f"layer_{i}"]
        _put_mha(b, f"{t}self_attn.", layer + ["self_attn"])
        for name in ("sampling_offsets", "attention_weights", "rayconv", "output_proj"):
            _put_linear(b, f"{t}proj_attn.{name}.weight", layer + ["proj_attn", name])
        for ln in ("norm1", "norm2", "norm3", "norm4"):
            _put_norm(b, f"{t}{ln}.", layer + [ln])
        for name in ("linear1", "linear2", "linear_mano_1", "linear_mano_2"):
            _put_linear(b, f"{t}{name}.weight", layer + [name])
        _put_linear(b, f"{prefix}reg_branches.{i}.0.weight", h + [f"reg_branch_{i}_fc"])
        _put_linear(b, f"{prefix}reg_branches.{i}.2.weight", h + [f"reg_branch_{i}_out"])
    return b.table


# the reference's BertModel builds these in every METRO block; its forward never calls them
METRO_DEAD = ("embeddings.word_embeddings.weight", "embeddings.position_embeddings.weight",
              "embeddings.token_type_embeddings.weight", "embeddings.LayerNorm.weight",
              "embeddings.LayerNorm.bias", "pooler.dense.weight", "pooler.dense.bias")


def convert_metro_network(port_keys: Iterable[str], prefix: str = "") -> Table:
    """Table of a reference ``METRO_Hand_Network`` onto the port's METRONetwork:
    per block ``trans_encoder.{i}`` the image embedding, the learned position table,
    each BERT layer's attention (query / key / value / output and its LayerNorm)
    and FFN, the cls head and the residual; then the 195 -> 778 upsampling and the
    camera head. The blocks' dead ``bert.embeddings`` / ``bert.pooler`` are consumed
    and dropped (the JAX converter leaves them unconsumed); the CNN backbone is not
    in the table, as in the JAX converter."""
    b = _Builder(port_keys)
    for i in _layer_indices(b.port_keys, r"block_(\d+)\."):
        t, blk = f"{prefix}trans_encoder.{i}.", [f"block_{i}"]
        _put_linear(b, f"{t}bert.img_embedding.weight", blk + ["img_embedding"])
        b.put(f"{t}bert.position_embeddings.weight", blk + ["position_embeddings"])
        for dead in METRO_DEAD:
            b.drop(f"{t}bert.{dead}")
        for n in _layer_indices(b.port_keys, rf"block_{i}\.layer(\d+)_attn\."):
            hf, attn, ffn = f"{t}bert.encoder.layer.{n}.", blk + [f"layer{n}_attn"], blk + [
                f"layer{n}_ffn"]
            for part in ("query", "key", "value"):
                _put_linear(b, f"{hf}attention.self.{part}.weight", attn + [part])
            _put_linear(b, f"{hf}attention.output.dense.weight", attn + ["out"])
            _put_norm(b, f"{hf}attention.output.LayerNorm.", attn + ["ln"])
            _put_linear(b, f"{hf}intermediate.dense.weight", ffn + ["intermediate"])
            _put_linear(b, f"{hf}output.dense.weight", ffn + ["output"])
            _put_norm(b, f"{hf}output.LayerNorm.", ffn + ["ln"])
        _put_linear(b, f"{t}cls_head.weight", blk + ["cls_head"])
        _put_linear(b, f"{t}residual.weight", blk + ["residual"])
    for name in ("upsampling", "cam_param_fc", "cam_param_fc2", "cam_param_fc3"):
        _put_linear(b, f"{prefix}{name}.weight", [name])
    return b.table


def convert_cmr_network(port_keys: Iterable[str], prefix: str = "",
                        arch: str = "resnet18") -> Table:
    """Table of a reference ``CMR_G`` onto the port's CMRG (build it with ``NORM:
    frozen_bn`` so the BatchNorm statistics have a place): ``backbone`` (EncodeUV's
    stem and stages) and ``backbone_mesh`` (EncodeMesh's stages, its three
    ``reduce`` ConvBlocks and ``fc``), the two UV decoders (``uv_delayer{,2}.{0..3}``
    and ``uv_head{,2}``), the latent ``attention`` (q / k / v and ``gamma``),
    ``de_layers.0`` (the linear) and ``de_layers.{1..4}`` (each deblock's four
    spiral Linears), and ``heads.{0..3}``."""
    b = _Builder(port_keys)
    convert_resnet_backbone(b, prefix + "backbone.", arch, path=("encode_uv",))
    convert_resnet_backbone(b, prefix + "backbone_mesh.", arch, path=("encode_mesh",))
    for i in range(3):
        convert_conv_block(b, f"{prefix}backbone_mesh.reduce.{i}", ["encode_mesh", f"reduce_{i}"])
    _put_linear(b, f"{prefix}backbone_mesh.fc.weight", ["encode_mesh", "fc"])
    for dec, delayer, head in (("uv_decoder", "uv_delayer", "uv_head"),
                               ("uv_decoder2", "uv_delayer2", "uv_head2")):
        for i in range(4):
            convert_conv_block(b, f"{prefix}{delayer}.{i}", [dec, f"ConvBlock_{i}"])
        convert_conv_block(b, f"{prefix}{head}", [dec, "head"])
    for lin in ("query_conv", "key_conv", "value_conv"):
        _put_linear(b, f"{prefix}attention.{lin}.weight", ["attention", lin])
    b.put(f"{prefix}attention.gamma", ["attention", "gamma"])
    _put_linear(b, f"{prefix}de_layers.0.weight", ["de_linear"])
    for i in _layer_indices(b.port_keys, r"deblock_(\d+)\."):
        for conv in ("conv1", "conv_d3", "conv_2d3", "conv"):
            _put_linear(b, f"{prefix}de_layers.{i}.{conv}.layer.weight",
                        [f"deblock_{i}", conv, "Dense_0"])
        _put_linear(b, f"{prefix}heads.{i - 1}.layer.weight", [f"heads_{i - 1}", "Dense_0"])
    return b.table
