"""The PETR multi-view baseline (counterpart of ``poem_v2_tpu/models/petr.py``).

799 learned 3D reference points are sine-embedded (with the template mesh)
into queries; every view's stride-16 tokens carry a frustum embedding plus
a 3D sine embedding; a 6-layer post-norm DETR decoder cross-attends the
tokens of the valid views, and one shared regression branch maps every
layer's queries to coordinates in the position range. The FTL variant
(:class:`PETRHeadFTL`) mixes the tokens through the feature transform layer
instead of the frustum embedding.

Heads take channels-last features (B, V, H, W, C), as the JAX heads do, so
tokens flatten in (V, H, W) order; :class:`PETRMultiView` permutes the NCHW
backbone level into that layout first. The camera algebra (the frustum, the
FTL's projections) is float32 products and sums outside autocast.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..geometry.camera import inverse_sigmoid, invert_rigid
from ..mano.layer import ManoLayer
from ..utils.registry import HEAD, MODEL, TRANSFORMER
from .backbones.resnet import ResNet
from .bricks.transformer_layer import DEFAULT_ORDER, BaseTransformerLayer, layer_norm
from .frustum import FrustumPositionEncoder
from .positional import pos2posemb3d, sine_positional_encoding_3d

POSITION_RANGE = (-0.6, -0.6, 0.0, 0.6, 0.6, 1.2)


def conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 convolution on channels-last x (..., C_in)."""
    return nn.functional.linear(x, conv.weight[:, :, 0, 0], conv.bias)


def no_autocast(device: torch.device):
    return torch.autocast(device.type, enabled=False)


@TRANSFORMER.register_module("PETRTransformer")
class PETRTransformer(nn.Module):
    """DETR decoder: ``num_layers`` post-norm layers over zero queries; the
    sequence's ``post_norm`` is applied to every intermediate before stacking."""

    def __init__(self, embed_dims: int = 256, num_layers: int = 6, num_heads: int = 8,
                 feedforward_channels: int = 1024, dropout: float = 0.1):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", BaseTransformerLayer(
                embed_dims, num_heads, feedforward_channels, dropout, DEFAULT_ORDER))
        self.post_norm = layer_norm(embed_dims)

    def forward(self, memory: torch.Tensor, memory_pos: torch.Tensor, memory_mask: torch.Tensor,
                query_embed: torch.Tensor) -> torch.Tensor:
        """-> (L, B, Q, C)."""
        query = torch.zeros_like(query_embed)
        outs = []
        for i in range(self.num_layers):
            query = getattr(self, f"layer_{i}")(query, memory, query_embed, memory_pos,
                                                memory_mask)
            outs.append(self.post_norm(query))
        return torch.stack(outs)


@HEAD.register_module("PETRHead")
class PETRHead(nn.Module):
    """Frustum + sine embedded tokens, template-seeded queries, the PETR decoder."""

    ftl_memory = False  # PETRHeadFTL: FTL-mixed tokens, queries without the template

    def __init__(self, embed_dims: int = 256, in_channels: int = 256, num_query: int = 799,
                 num_preds: int = 6, num_reg_fcs: int = 2, depth_num: int = 32,
                 depth_start: float = 0.0, depth_end: float = 1.2, lid: bool = False,
                 position_range: Sequence[float] = POSITION_RANGE, pe_num_feats: int = 128,
                 coord_relative: bool = False, num_heads: int = 8,
                 feedforward_channels: int = 1024, dropout: float = 0.1):
        super().__init__()
        E = embed_dims
        self.embed_dims, self.num_query, self.num_preds = E, num_query, num_preds
        self.num_reg_fcs, self.pe_num_feats = num_reg_fcs, pe_num_feats
        self.coord_relative = coord_relative
        self.position_range = tuple(float(p) for p in position_range)
        self.input_proj = nn.Conv2d(in_channels, E, 1)
        if self.ftl_memory:
            self.ftl = FTLayer(E, depth_num)
        else:
            # the PETR head's position encoder hides at embed_dims * 4
            self.position_encoder = FrustumPositionEncoder(
                E, depth_num, depth_start, depth_end, lid, self.position_range, hidden_mult=4)
        self.adapt_pos3d_1 = nn.Conv2d(3 * pe_num_feats, 4 * E, 1)
        self.adapt_pos3d_2 = nn.Conv2d(4 * E, E, 1)
        self.reference_points = nn.Parameter(torch.rand(num_query, 3))
        q_in = 3 * (E // 2) + (0 if self.ftl_memory else 3)
        self.query_embedding_1 = nn.Linear(q_in, E)
        self.query_embedding_2 = nn.Linear(E, E)
        self.transformer = PETRTransformer(E, num_preds, num_heads, feedforward_channels,
                                           dropout)
        # ONE reg branch for every level: the reference repeats one Sequential
        for i in range(num_reg_fcs):
            self.add_module(f"reg_fc{i}", nn.Linear(E, E))
        self.reg_out = nn.Linear(E, 3)

    def _memory(self, x, view_mask, cam_intr, cam_extr, inp_res):
        """(tokens, their position embedding), both (B, V, H, W, E)."""
        B, V, H, W, _ = x.shape
        sin = sine_positional_encoding_3d(view_mask, H, W, num_feats=self.pe_num_feats)
        sin = sin.to(self.adapt_pos3d_1.weight.dtype)
        pos = conv1x1(self.adapt_pos3d_2, torch.relu(conv1x1(self.adapt_pos3d_1, sin)))
        if self.ftl_memory:
            return self.ftl(x, cam_intr, cam_extr), pos
        coords_embed = self.position_encoder(cam_intr, cam_extr, (H, W), inp_res)[0]
        return x, coords_embed + pos

    def forward(self, feat: torch.Tensor, view_mask: torch.Tensor, cam_intr: torch.Tensor,
                cam_extr: torch.Tensor, template_mesh: torch.Tensor,
                inp_res: Tuple[int, int] = (256, 256)) -> Dict[str, torch.Tensor]:
        """feat (B, V, H, W, C) channels-last (the stride-16 level), view_mask (B, V)
        bool, cam_intr (B, V, 3, 3), cam_extr (B, V, 4, 4) camera -> master,
        template_mesh (799, 3) float32 -> ``all_coords_preds`` (L, B, Q, 3) metres."""
        B, V, H, W, _ = feat.shape
        E, Q = self.embed_dims, self.num_query
        x = conv1x1(self.input_proj, feat.to(self.input_proj.weight.dtype))
        tokens, pos = self._memory(x, view_mask, cam_intr, cam_extr, inp_res)
        memory = tokens.reshape(B, V * H * W, E)
        memory_pos = pos.reshape(B, V * H * W, E)
        token_mask = view_mask.repeat_interleave(H * W, dim=1)

        ref = self.reference_points
        q_in = pos2posemb3d(ref, E // 2)
        if not self.ftl_memory:
            q_in = torch.cat([q_in, template_mesh.to(q_in.dtype)], dim=-1)
        query_embed = self.query_embedding_2(torch.relu(self.query_embedding_1(q_in)))
        outs = self.transformer(memory, memory_pos, token_mask,
                                query_embed[None].expand(B, Q, E))
        outs = torch.nan_to_num(outs.float())

        ref_sig = torch.sigmoid(ref.float())[None].expand(B, Q, 3)
        coords = []
        for lvl in range(self.num_preds):
            h = outs[lvl].to(self.reg_out.weight.dtype)
            for i in range(self.num_reg_fcs):
                h = torch.relu(getattr(self, f"reg_fc{i}")(h))
            delta = self.reg_out(h).float()
            if self.coord_relative:
                delta = delta + inverse_sigmoid(ref_sig)
            coords.append(torch.sigmoid(delta))
        pr = torch.tensor(self.position_range, dtype=torch.float32, device=feat.device)
        return {"all_coords_preds": torch.stack(coords) * (pr[3:] - pr[:3]) + pr[:3]}


class FTLayer(nn.Module):
    """Feature transform layer: lift the channels into ``depth`` 3D triplets a
    token (channel-last order), move them camera -> world by P^-1 = K^-1 [R|t],
    mix, move them back by P = K [R|t]^-1, and project to ``embed_dims``."""

    def __init__(self, embed_dims: int = 256, depth: int = 32):
        super().__init__()
        self.depth = depth
        self.conv1 = nn.Conv2d(embed_dims, 3 * depth, 1)
        self.ln1 = layer_norm(3 * depth)
        self.conv2 = nn.Conv2d(3 * depth, 3 * depth, 1)
        self.ln2 = layer_norm(3 * depth)
        self.conv3 = nn.Conv2d(3 * depth, embed_dims, 1)
        self.ln3 = layer_norm(embed_dims)

    def forward(self, feat: torch.Tensor, cam_intr: torch.Tensor,
                cam_extr: torch.Tensor) -> torch.Tensor:
        """feat (B, V, H, W, C) channels-last -> (B, V, H, W, embed_dims)."""
        B, V, H, W, _ = feat.shape
        d = self.depth
        with no_autocast(feat.device):
            intr, extr = cam_intr.float(), cam_extr.float()
            p_inv = matmul_f32(torch.linalg.inv(intr), extr[..., :3, :])
            p_fwd = matmul_f32(intr, invert_rigid(extr)[..., :3, :])

        def transf(p, x):  # (B, V, 3, 4) applied to (B, V, H, W, 3 d) as (H W d) points
            with no_autocast(x.device):
                pts = x.reshape(B, V, H * W * d, 3).float()
                pts_h = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
                out = (p[:, :, None] * pts_h[:, :, :, None, :]).sum(-1)
            return out.reshape(B, V, H, W, 3 * d).to(x.dtype)

        x = torch.relu(self.ln1(conv1x1(self.conv1, feat)))
        x = torch.relu(self.ln2(conv1x1(self.conv2, transf(p_inv, x))))
        return self.ln3(conv1x1(self.conv3, transf(p_fwd, x)))


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., i, j) @ (..., j, k) as float32 products and sums (no TF32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


@HEAD.register_module("PETRHead_FTL")
class PETRHeadFTL(PETRHead):
    """The PETR head with FTL-mixed tokens (no frustum embedding) and queries from
    the sine-embedded reference points alone. ``create_petr_model`` builds
    :class:`PETRHead` whatever ``HEAD.TYPE`` says, as the JAX factory does: build
    this head directly."""

    ftl_memory = True


class PETRMultiView(nn.Module):
    """Backbone + PETR head on a padded batch: images (B, V, H, W, 3) with a (B, V)
    view mask, as POEMNet takes them. A ``compute_dtype`` other than the
    parameters' runs the forward under ``torch.autocast`` in that dtype."""

    def __init__(self, backbone: nn.Module, head: PETRHead, template_mesh: np.ndarray,
                 num_joints: int = 21, center_idx: int = 0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.backbone, self.head = backbone, head
        # float32 constant, kept out of the state dict and of dtype casts
        self._template = np.asarray(template_mesh, np.float32)
        self.num_joints, self.center_idx = num_joints, center_idx
        self.compute_dtype = compute_dtype

    def forward(self, images: torch.Tensor, view_mask: torch.Tensor, cam_intr: torch.Tensor,
                cam_extr: torch.Tensor, master_joints_3d: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        dt = self.head.input_proj.weight.dtype
        with maybe_autocast(images.device, self.compute_dtype, dt):
            B, V, H, W, _ = images.shape
            feats = self.backbone(images.reshape(B * V, H, W, 3).to(dt).permute(0, 3, 1, 2))
            lvl = feats["res_layer3"]
            lvl = lvl.permute(0, 2, 3, 1).reshape(B, V, lvl.shape[2], lvl.shape[3], -1)
            template = torch.as_tensor(self._template, device=images.device)
            preds = self.head(lvl, view_mask, cam_intr, cam_extr, template, inp_res=(W, H))
        return with_final_level(preds, self.num_joints, self.center_idx)


def maybe_autocast(device: torch.device, compute_dtype: Optional[torch.dtype],
                   param_dtype: torch.dtype):
    if compute_dtype in (None, param_dtype):
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=compute_dtype)


def with_final_level(preds: Dict[str, torch.Tensor], num_joints: int,
                     center_idx: int) -> Dict[str, torch.Tensor]:
    """``preds`` with the last level's joints and vertices, absolute and root-relative."""
    all_coords = preds["all_coords_preds"]
    joints, verts = all_coords[-1, :, :num_joints], all_coords[-1, :, num_joints:]
    centre = joints[:, center_idx][:, None]
    return dict(preds, pred_joints_3d=joints, pred_verts_3d=verts,
                pred_joints_3d_rel=joints - centre, pred_verts_3d_rel=verts - centre)


def build_baseline(make, name: str, dtype: torch.dtype, device, generator, param_dtype):
    """Shared factory body: check the device, build ``make(compute_dtype)`` on the meta
    device and fill it on the CPU with ``init_parameters`` from ``generator`` (seed 0
    if None); the caller moves it."""
    from .poem import init_parameters

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name} targets a CUDA device and none is available; "
                           'pass device="cpu" to build the model there')
    with torch.device("meta"):
        model = make(compute_dtype=dtype if param_dtype not in (None, dtype) else None)
    model = model.to_empty(device="cpu")
    init_parameters(model, generator or torch.Generator().manual_seed(0))
    return model


def data_preset(cfg: dict) -> Tuple[int, int]:
    """(NUM_JOINTS, CENTER_IDX) of ``DATA_PRESET``, 21 and 0 without one."""
    preset = cfg.get("DATA_PRESET") or {}
    return preset.get("NUM_JOINTS", 21), preset.get("CENTER_IDX", 0)


def petr_head_kwargs(head_cfg: dict, in_channels: int) -> Dict[str, Any]:
    """The PETR head's arguments from a ``HEAD`` config section (either head class)."""
    return dict(
        embed_dims=head_cfg["EMBED_DIMS"], in_channels=in_channels,
        num_query=head_cfg["NUM_QUERY"], num_preds=head_cfg["NUM_PREDS"],
        num_reg_fcs=head_cfg.get("NUM_REG_FCS", 2), depth_num=head_cfg["DEPTH_NUM"],
        depth_start=head_cfg["DEPTH_START"], depth_end=head_cfg["DEPTH_END"],
        lid=head_cfg.get("LID", False), position_range=tuple(head_cfg["POSITION_RANGE"]),
        pe_num_feats=head_cfg["POSITIONAL_ENCODING"]["NUM_FEATS"],
        coord_relative=head_cfg.get("COORD_RELATIVE_TO_REFERENCE", False))


def create_petr_model(cfg: dict, dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cuda",
                      generator: Optional[torch.Generator] = None,
                      param_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[PETRMultiView, Dict[str, Any]]:
    """Build PETRMultiView from the ``MODEL`` section of a reference-schema config
    (``BACKBONE`` a ResNet; ``HEAD`` with ``EMBED_DIMS``, ``NUM_QUERY``,
    ``NUM_PREDS``, ``DEPTH_NUM``, ``DEPTH_START``, ``DEPTH_END``,
    ``POSITION_RANGE``, ``POSITIONAL_ENCODING.NUM_FEATS``). The head is
    :class:`PETRHead` whatever ``HEAD.TYPE`` says, as in the JAX factory; its
    input width is the backbone's res_layer3 (which the flax head infers, and
    ``IN_CHANNELS`` states). ``dtype`` / ``param_dtype`` / ``generator`` /
    ``device`` as ``create_poem_model``'s: the card by default, raising without
    one. Returns (model in eval mode, aux with a root-free MANO layer)."""
    head_cfg = cfg["HEAD"]
    num_joints, center_idx = data_preset(cfg)
    mano = ManoLayer(center_idx=center_idx)
    out = mano(torch.zeros(1, 48), torch.zeros(1, 10))
    template = torch.cat([out.joints, out.verts], dim=1)[0].numpy()

    def make(compute_dtype):
        backbone = ResNet.from_config(cfg["BACKBONE"])
        head = PETRHead(**petr_head_kwargs(head_cfg, backbone.feat_size[1]))
        return PETRMultiView(backbone, head, template, num_joints, center_idx, compute_dtype)

    model = build_baseline(make, "create_petr_model", dtype, device, generator, param_dtype)
    model = model.to(device=device, dtype=param_dtype or dtype).eval()
    return model, {"mano_layer": ManoLayer(center_idx=None)}


MODEL.register_module("PETRMultiView")(create_petr_model)
