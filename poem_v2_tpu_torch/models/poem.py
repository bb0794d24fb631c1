"""POEMNet and create_poem_model (counterpart of ``poem_v2_tpu/models/poem.py``).

images (B, V, H, W, 3) with a (B, V) view mask
  -> HRNet or ResNet-18 / 34 / 50 per view -> feature neck (B*V, h, w, C)
     + heatmap neck
  -> integral 2D joints -> reference joints: eval = masked DLT of the 2D
     joints; train (``module.train()``) = ground truth jittered by draws
     the caller passes (:func:`draw_ref_noise`)
  -> POEM generalized head -> per-block 799-point coordinates (with
     ``PARAMETRIC_OUTPUT`` the last block's are the MANO surface of the
     regressed ``pred_pose`` / ``pred_shape``; with ``HEAD.TRANSFORMER.TYPE:
     PtEmbedTRv3`` the METRO stage's coarse mesh, then each refinement; with
     ``HEAD.PETR_EMBEDDING`` the frustum embedding joins the sine one).
"""

from __future__ import annotations

import contextlib
import math
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..geometry.heatmap import integral_heatmap2d, normalize_heatmap
from ..mano.layer import ManoLayer
from ..ops.points import farthest_point_sampling
from ..ops.triangulate import triangulate_dlt_c2m
from ..utils.profiling import span, sync_point
from .backbones.hrnet import HRNet
from .backbones.resnet import ResNet
from .heads.ptemb_head import POEMGeneralizedHead, generate_bps_basis
from .neck import HRNetFeatNeck, ResNetFeatNeck, UVDecodeNeck

_ASSETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "assets")


RefDraws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def draw_ref_noise(generator: torch.Generator, batch: int, num_joints: int = 21) -> RefDraws:
    """The draws of one train forward's reference jitter, on the generator's
    device: normal (B, J, 3), normal (1,), uniform (1,) (poem.py:86-97)."""
    dev = generator.device
    return (torch.randn((batch, num_joints, 3), generator=generator, device=dev),
            torch.randn((1,), generator=generator, device=dev),
            torch.rand((1,), generator=generator, device=dev))


def jitter_reference_joints(gt: torch.Tensor, draws: RefDraws, ref_noise: float = 0.01,
                            center_idx: int = 0) -> torch.Tensor:
    """Ground-truth joints (B, J, 3) moved by ``ref_noise`` metres of noise and
    scaled by 1 +- 1% about the jittered root, from ``draws``."""
    normal_joints, normal_shift, uniform = draws
    ref = gt.float() + ref_noise * (normal_joints + normal_shift)
    root = ref[:, center_idx][:, None]
    scale = 0.01 * (uniform * 2.0 - 1.0) + 1.0
    return scale * (ref - root) + root


class POEMNet(nn.Module):
    """End-to-end POEM forward; public tensors keep the JAX layout.

    A ``compute_dtype`` (None: the parameters' dtype) other than the
    parameters' dtype runs the forward under ``torch.autocast`` in that dtype
    (float32 parameters, bfloat16 compute, as flax's ``dtype`` does)."""

    def __init__(self, backbone: nn.Module, feat_neck: nn.Module, uv_neck: nn.Module,
                 head: nn.Module, num_joints: int = 21, center_idx: int = 0,
                 ref_noise: float = 0.01, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.backbone, self.feat_neck, self.uv_neck, self.head = backbone, feat_neck, uv_neck, head
        self.num_joints, self.center_idx = num_joints, center_idx
        self.ref_noise = ref_noise
        self.compute_dtype = compute_dtype

    def forward(self, images: torch.Tensor, view_mask: torch.Tensor, cam_intr: torch.Tensor,
                cam_extr: torch.Tensor, master_joints_3d: Optional[torch.Tensor] = None,
                ref_draws: Optional[RefDraws] = None) -> Dict[str, torch.Tensor]:
        """images (B, V, H, W, 3), view_mask (B, V) bool, cam_intr (B, V, 3, 3),
        cam_extr (B, V, 4, 4) camera->master, master_joints_3d (B, 21, 3): in
        eval the reference joints of single-view samples, in training the
        ground truth that ``ref_draws`` (:func:`draw_ref_noise`) jitter."""
        mixed = self.compute_dtype not in (None, self.head.input_proj.weight.dtype)
        with (torch.autocast(images.device.type, dtype=self.compute_dtype) if mixed
              else contextlib.nullcontext()):
            return self._forward(images, view_mask, cam_intr, cam_extr, master_joints_3d,
                                 ref_draws)

    def _forward(self, images, view_mask, cam_intr, cam_extr, master_joints_3d, ref_draws):
        B, V, H, W, _ = images.shape
        dt = self.head.input_proj.weight.dtype
        imgs = images.reshape(B * V, H, W, 3).to(dt).permute(0, 3, 1, 2)
        with span("backbone"):
            feats = self.backbone(imgs)
        pyramid = ([feats[f"res_layer{i}"] for i in range(1, 5)] if isinstance(feats, dict)
                   else feats)
        with span("feat_neck"):
            mlvl = self.feat_neck(pyramid).permute(0, 2, 3, 1)  # (BV, h, w, C)
        with span("uv_neck"):
            uv_hmap = self.uv_neck(pyramid)                      # (BV, 21, 32, 32)

        with span("joints2d"):
            uv_coord = integral_heatmap2d(normalize_heatmap(uv_hmap.float()))
            with sync_point("pixel_scale", images.device):  # a blocking copy
                scale = torch.tensor([W, H], dtype=torch.float32, device=images.device)
            uv_coord_im = (uv_coord * scale).reshape(B, V, self.num_joints, 2)

        if self.training:
            if master_joints_3d is None or ref_draws is None:
                raise ValueError("the train forward needs master_joints_3d and ref_draws")
            ref_joints = jitter_reference_joints(
                master_joints_3d, tuple(d.to(images.device) for d in ref_draws),
                self.ref_noise, self.center_idx)
        elif master_joints_3d is not None:
            with span("triangulate"):
                tri = triangulate_dlt_c2m(uv_coord_im, cam_intr.float(), cam_extr.float(),
                                          view_mask)
            n_views = view_mask.float().sum(1)
            ref_joints = torch.where((n_views <= 1.0)[:, None, None],
                                     master_joints_3d.float(), tri)
        else:
            with span("triangulate"):
                ref_joints = triangulate_dlt_c2m(uv_coord_im, cam_intr.float(),
                                                 cam_extr.float(), view_mask)

        with span("head"):
            preds = dict(self.head(mlvl.reshape(B, V, *mlvl.shape[1:]), view_mask, cam_intr,
                                   cam_extr, ref_joints, inp_res=(W, H)))
        all_coords = preds["all_coords_preds"]
        joints = all_coords[-1, :, :self.num_joints]
        verts = all_coords[-1, :, self.num_joints:]
        centre = joints[:, self.center_idx][:, None]
        preds.update(
            pred_joints_3d=joints, pred_verts_3d=verts,
            pred_joints_3d_rel=joints - centre, pred_verts_3d_rel=verts - centre,
            pred_joints_uv=uv_coord_im, pred_ref_joints_3d=ref_joints,
        )
        return preds


def load_static_assets(head_cfg: dict, nsample: int, radius: float, num_query: int = 799):
    """(bps (nsample, 3) metres, anchor_xyz (32, 3) or None, anchor_idx (32,) or None).

    Reads ``HEAD.BPS_PATH`` / ``ANCHOR_PATH`` / ``ANCHOR_IDX_PATH`` (strict) or
    the repo's ``assets/{bps,anchor,anchor_idx}.npy`` verbatim, skipping a
    repo default whose geometry does not fit (tiny configs) for the
    generated basis and FPS anchors."""

    def resolve(key, fname):
        p = head_cfg.get(key)
        if p:
            return p, True
        default = os.path.join(_ASSETS_DIR, fname)
        return (default if os.path.exists(default) else None), False

    bps_path, bps_strict = resolve("BPS_PATH", "bps.npy")
    anchor_path, a_strict = resolve("ANCHOR_PATH", "anchor.npy")
    anchor_idx_path, ai_strict = resolve("ANCHOR_IDX_PATH", "anchor_idx.npy")

    bps = None
    if bps_path is not None:
        bps = np.load(bps_path).reshape(-1, 3).astype(np.float32)
        if bps.shape[0] != nsample:
            if bps_strict:
                raise ValueError(f"BPS asset {bps_path} has {bps.shape[0]} points, cfg wants {nsample}")
            bps = None
    if bps is None:
        bps = generate_bps_basis(nsample, radius)

    anchor_xyz = anchor_idx = None
    if anchor_path is not None and anchor_idx_path is not None:
        anchor_xyz = np.load(anchor_path).reshape(-1, 3).astype(np.float32)
        anchor_idx = np.load(anchor_idx_path).reshape(-1).astype(np.int32)
        if int(anchor_idx.max()) >= min(num_query, nsample):
            if a_strict or ai_strict:
                raise ValueError(f"anchor_idx from {anchor_idx_path} out of range for "
                                 f"num_query={num_query}, nsample={nsample}")
            anchor_xyz = anchor_idx = None
    return bps, anchor_xyz, anchor_idx


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``: N(0, 0.02) for the BERT attention /
    FFN dense layers (METRO's too), the query embedding and METRO's position
    embeddings, U(0, 1) for the v1 heads' reference embedding, PETR's reference
    points and MVP's query table (the flax initialisers), other
    matrices at half the lecun-normal scale, zero biases, unit norm scales,
    running statistics 0 / 1; buffers outside the state dict are left as built. At the full lecun scale the merge's cubic
    product sends the decoded points metres away from the hand, where
    neighbour distances all but tie; half keeps them within centimetres."""
    bert = re.compile(r"\.(attn|cross_attn|ffn|layer\d+_attn|layer\d+_ffn)\.")
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() == 1:
                ones = leaf in ("weight", "running_var")  # scales; FrozenBatchNorm's variance
                val = torch.ones(p.shape) if ones else torch.zeros(p.shape)
            elif leaf in ("reference_embed", "reference_points", "tgt_pose_embedding"):
                val = torch.rand(p.shape, generator=generator)
            elif leaf in ("query_feat_embedding", "position_embeddings") or bert.search(name):
                val = torch.randn(p.shape, generator=generator) * 0.02
            else:
                # torch layouts are (out, in, ...); raw kernels and MLP params are (in, out)
                raw = leaf == "kernel" or leaf.startswith("fc_")
                fan_in = p.shape[0] if raw else int(np.prod(p.shape[1:]))
                val = torch.randn(p.shape, generator=generator) * (0.5 / math.sqrt(fan_in))
            p.copy_(val.to(p.dtype))
        state = set(model.state_dict(keep_vars=True))
        for name, b in model.named_buffers():
            if name not in state:  # a constant of the module (CMR's spirals), not state
                continue
            if name.endswith("running_var"):
                b.fill_(1.0)
            else:
                b.zero_()


def create_poem_model(cfg: dict, dtype: torch.dtype = torch.float32,
                      device: torch.device | str = "cuda",
                      generator: Optional[torch.Generator] = None,
                      param_dtype: Optional[torch.dtype] = None, use_flash_train: bool = True
                      ) -> Tuple[POEMNet, Dict[str, Any]]:
    """Build the POEMNet (``BACKBONE.TYPE`` HRNet or resnet18 / 34 / 50) from the
    ``MODEL`` section of a config.

    Weights come from ``generator`` (seed 0 if None); load a converted
    ``state_dict`` over them for real weights. ``dtype`` is the compute
    dtype and ``param_dtype`` (default ``dtype``) the parameters' one:
    float32 parameters with bfloat16 compute is the training setting, as
    flax keeps it. ``use_flash_train`` (the JAX factory's flag, default on)
    trains through the dense attention kernel and K6; off, training takes the
    reference's attention-probability dropout and gathered KNN neighbourhoods
    (``--no-flash_train``). ``device`` defaults to the card and there is no silent
    move to the CPU: without a CUDA device this raises; pass ``"cpu"`` to
    run the kernels' plain versions there.
    Returns (model in eval mode on ``device``, aux with the BPS basis, the
    template, the MANO joint regressor and ``parametric_output``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_poem_model targets a CUDA device and none is available; "
                           'pass device="cpu" to build the model there')
    bb_cfg, head_cfg = cfg["BACKBONE"], cfg["HEAD"]
    tr_cfg = head_cfg["TRANSFORMER"]
    bb_type = bb_cfg["TYPE"]
    if not (bb_type == "HRNet" or bb_type.lower().startswith("resnet")):
        raise ValueError(f"Unsupported backbone {bb_type!r} for POEM")
    norm = bb_cfg.get("NORM", "gn")
    nsample, radius = head_cfg["N_SAMPLE"], head_cfg["RADIUS_SAMPLE"]
    center = tr_cfg.get("TRANSFORMER_CENTER_IDX", 9)
    parametric = bool(tr_cfg.get("PARAMETRIC_OUTPUT", False))

    with span("build"):
        with span("assets"):
            bps, anchor_xyz, anchor_idx = load_static_assets(head_cfg, nsample, radius)
            mano_layer = ManoLayer(center_idx=center)
            mano_out = mano_layer(torch.zeros(1, 48), torch.zeros(1, 10))
            template = torch.cat([mano_out.joints, mano_out.verts], 1)[0].numpy()  # (799, 3)
            if anchor_idx is not None:
                q_anchor_idx = pt_anchor_idx = anchor_idx
            else:
                _, pt_anchor_idx = farthest_point_sampling(
                    torch.from_numpy(bps[None] / radius), 32)
                _, q_anchor_idx = farthest_point_sampling(
                    torch.from_numpy(template[None] / radius), 32)
                pt_anchor_idx, q_anchor_idx = pt_anchor_idx[0].numpy(), q_anchor_idx[0].numpy()

        with torch.device("meta"):
            if bb_type == "HRNet":
                backbone = HRNet.from_config(bb_cfg)
                feat_size = backbone.stage4_channels
                feat_neck = HRNetFeatNeck(feat_size, norm=norm)
            else:
                backbone = ResNet(arch=bb_type.lower(), norm=norm)
                feat_size = backbone.feat_size
                feat_neck = ResNetFeatNeck(feat_size, norm=norm)
            model = POEMNet(
                backbone, feat_neck,
                UVDecodeNeck(feat_size, hrnet=bb_type == "HRNet", norm=norm),
                POEMGeneralizedHead(
                    embed_dims=head_cfg["EMBED_DIMS"], pt_feat_dim=head_cfg["POINTS_FEAT_DIM"],
                    # the feature neck's width, which the flax head takes from its input
                    # (the shipped configs set ``IN_CHANNELS`` to the same number)
                    in_channels=feat_size[2], num_query=head_cfg["NUM_QUERY"],
                    nsample=nsample, radius=radius,
                    pe_num_feats=head_cfg["POSITIONAL_ENCODING"]["NUM_FEATS"], center_idx=center,
                    bps_basis=bps, template_mesh=template, query_anchor_idx=q_anchor_idx,
                    pt_anchor_idx=pt_anchor_idx, anchor_xyz=anchor_xyz,
                    n_blocks=tr_cfg["N_BLOCKS"], num_heads=tr_cfg["NUM_ATTENTION_HEADS"],
                    n_neighbor=tr_cfg["N_NEIGHBOR"], n_neighbor_query=tr_cfg["N_NEIGHBOR_QUERY"],
                    dropout=tr_cfg.get("DROPOUT", 0.1), parametric_output=parametric,
                    mano_layer=mano_layer if parametric else None, use_flash_train=use_flash_train,
                    petr_embedding=bool(head_cfg.get("PETR_EMBEDDING", False)),
                    depth_num=head_cfg.get("DEPTH_NUM", 32),
                    depth_start=head_cfg.get("DEPTH_START", 0.0),
                    depth_end=head_cfg.get("DEPTH_END", 1.2), lid=head_cfg.get("LID", False),
                    position_range=tuple(head_cfg.get("POSITION_RANGE",
                                                      (-0.6, -0.6, 0.0, 0.6, 0.6, 1.2))),
                    decoder_type=("PtEmbedTRv3" if tr_cfg.get("TYPE", "PtEmbedTR") == "PtEmbedTRv3"
                                  else "PtEmbedTR")),
                num_joints=cfg.get("DATA_PRESET", {}).get("NUM_JOINTS", 21),
                center_idx=cfg.get("DATA_PRESET", {}).get("CENTER_IDX", 0),
                ref_noise=float(cfg.get("REF_NOISE", 0.01)),
                compute_dtype=dtype if param_dtype not in (None, dtype) else None,
            )
        with span("init"):
            model = model.to_empty(device="cpu")
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            init_parameters(model, generator)
        with span("to_device"):
            model = model.to(device=device, dtype=param_dtype or dtype).eval()
    aux = {"bps_basis": bps, "template_mesh": template, "transformer_center_idx": center,
           "parametric_output": parametric, "j_regressor": mano_layer.j_regressor}
    return model, aux
