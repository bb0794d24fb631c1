"""METRO: the BERT encoder block of PtEmbedTRv3 and the single-view METRO hand
network (counterpart of ``poem_v2_tpu/models/metro.py``).

The network broadcasts a global CNN feature to 216 tokens (21 joints and 195
coarse vertices), concatenates the template mesh's positions, runs three
encoder blocks of falling width (1024 / 256 / 64 hidden; 512 / 128 / 3 out),
each with learned positional embeddings, a linear "cls head" and a residual,
then upsamples the 195 vertices to 778 with a learned linear map; a
weak-perspective camera head regresses (s, tx, ty). The mesh samplers come from
the reference's ``mano_downsampling.npz`` where a path is given, else they are
made from the MANO template (farthest vertices, inverse-distance blends).

The blocks' attention is the port's ``MultiHeadCrossAttention`` with
``use_flash_train=False``: training takes the einsum path with dropout on the
attention probabilities, as the JAX block (built without ``use_flash``) trains;
eval runs kernel K3 on the card, the same function with no dropout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..mano.layer import ManoLayer
from ..utils.registry import MODEL
from .backbones.resnet import ResNet
from .bricks.attention import BertFFN, MultiHeadCrossAttention


def load_mesh_sampler(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's ``mano_downsampling.npz`` (object arrays ``A``, ``U``, ``D``
    of scipy sparse matrices) -> dense float32 (D0 (n_sub, 778), U0 (778, n_sub)),
    the one-level sampler the reference uses."""
    data = np.load(path, allow_pickle=True, encoding="latin1")

    def dense(m):
        return np.asarray(m.todense() if hasattr(m, "todense") else m, dtype=np.float32)

    return dense(data["D"][0]), dense(data["U"][0])


def synthetic_mesh_sampler(v_template: np.ndarray, n_sub: int = 195, k: int = 3
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic (D (n_sub, 778), U (778, n_sub)): farthest-point selection of
    ``n_sub`` vertices, each vertex an inverse-distance blend of its ``k`` nearest
    chosen ones (numpy, the JAX function's arithmetic)."""
    n = v_template.shape[0]
    chosen = [0]
    d = np.linalg.norm(v_template - v_template[0], axis=1)
    for _ in range(n_sub - 1):
        idx = int(np.argmax(d))
        chosen.append(idx)
        d = np.minimum(d, np.linalg.norm(v_template - v_template[idx], axis=1))
    chosen = np.asarray(chosen)
    D = np.zeros((n_sub, n), dtype=np.float32)
    D[np.arange(n_sub), chosen] = 1.0
    U = np.zeros((n, n_sub), dtype=np.float32)
    sub_pos = v_template[chosen]
    for v in range(n):
        dist = np.linalg.norm(sub_pos - v_template[v], axis=1)
        nearest = np.argsort(dist)[:k]
        w = 1.0 / (dist[nearest] + 1e-6)
        U[v, nearest] = w / w.sum()
    return D, U


class METROEncoderBlock(nn.Module):
    """Token embedding + learned positions, ``num_layers`` BERT layers, and the
    cls-head reduction plus a linear residual of the tokens."""

    def __init__(self, in_dim: int, hidden_size: int, output_dim: int, num_layers: int = 4,
                 num_heads: int = 4, dropout: float = 0.1, max_positions: int = 512):
        super().__init__()
        self.num_layers = num_layers
        self.position_embeddings = nn.Parameter(torch.empty(max_positions, hidden_size))
        nn.init.normal_(self.position_embeddings, std=0.02)
        self.img_embedding = nn.Linear(in_dim, hidden_size)
        self.drop = nn.Dropout(dropout)
        for i in range(num_layers):
            self.add_module(f"layer{i}_attn", MultiHeadCrossAttention(
                hidden_size, num_heads, dropout, use_flash_train=False))
            self.add_module(f"layer{i}_ffn", BertFFN(hidden_size, hidden_size * 4, dropout))
        self.cls_head = nn.Linear(hidden_size, output_dim)
        self.residual = nn.Linear(in_dim, output_dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S, in_dim) -> (B, S, output_dim)."""
        S = tokens.shape[1]
        x = self.img_embedding(tokens)
        x = self.drop(x + self.position_embeddings[None, :S].to(x.dtype))
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}_attn")(x, x)
            x = getattr(self, f"layer{i}_ffn")(x)
        return self.cls_head(x) + self.residual(tokens)


class METRONetwork(nn.Module):
    """The single-view METRO hand network; images (B, H, W, 3) channels-last."""

    def __init__(self, backbone: ResNet, template_joints: np.ndarray,
                 template_verts_sub: np.ndarray, input_feat_dims: Sequence[int] = (2051, 512, 128),
                 hidden_feat_dims: Sequence[int] = (1024, 256, 64), num_layers: int = 4,
                 num_heads: int = 4, dropout: float = 0.1):
        super().__init__()
        self.backbone = backbone
        # float32 constant, kept out of the state dict and of dtype casts
        ref = np.concatenate([template_joints, template_verts_sub], 0).astype(np.float32)
        self._template_ref = ref
        gdim = backbone.feat_size[0]
        output_dims = tuple(input_feat_dims[1:]) + (3,)
        in_dims = (3 + gdim,) + output_dims[:-1]
        self.n_blocks = len(hidden_feat_dims)
        for i, (d_in, h, o) in enumerate(zip(in_dims, hidden_feat_dims, output_dims)):
            self.add_module(f"block_{i}", METROEncoderBlock(d_in, h, o, num_layers, num_heads,
                                                            dropout))
        n_sub = template_verts_sub.shape[0]
        self.upsampling = nn.Linear(n_sub, 778)
        self.cam_param_fc = nn.Linear(3, 1)
        self.cam_param_fc2 = nn.Linear(ref.shape[0], 150)
        self.cam_param_fc3 = nn.Linear(150, 3)

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        B = image.shape[0]
        dt = self.cam_param_fc.weight.dtype
        feats = self.backbone(image.to(dt).permute(0, 3, 1, 2))
        global_feat = feats["res_layer4_mean"]
        ref = torch.as_tensor(self._template_ref, device=image.device)
        S = ref.shape[0]
        tokens = torch.cat([ref[None].expand(B, S, 3).to(global_feat.dtype),
                            global_feat[:, None].expand(B, S, global_feat.shape[-1])], dim=-1)
        x = tokens
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        coords = x.float()
        pred_verts_sub = coords[:, 21:]
        pred_verts = self.upsampling(pred_verts_sub.transpose(1, 2).to(dt)).transpose(1, 2)
        cam = self.cam_param_fc(coords.to(dt)).transpose(1, 2)  # (B, 1, 216)
        cam = self.cam_param_fc3(self.cam_param_fc2(cam))[:, 0]
        return {"pred_joints_3d_rel": coords[:, :21], "pred_verts_sub_3d_rel": pred_verts_sub,
                "pred_verts_3d_rel": pred_verts.float(), "pred_cam": cam.float()}


def create_metro_model(cfg: Optional[dict] = None, dtype: torch.dtype = torch.float32,
                       device: torch.device | str = "cuda",
                       generator: Optional[torch.Generator] = None
                       ) -> Tuple[METRONetwork, Dict[str, Any]]:
    """Build the METRO network from a config (``BACKBONE``, ``INPUT_FEAT_DIM``,
    ``HIDDEN_FEAT_DIM``, ``MESH_SAMPLER_PATH``; None: ResNet-50 GN and the default
    widths). Weights come from ``generator`` (seed 0 if None), the upsampling
    matrix's from the sampler's U. ``device`` defaults to the card, as
    ``create_poem_model``'s. Returns (model in eval mode, aux with the MANO layer
    and the sampler's D and U)."""
    from .poem import init_parameters

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_metro_model targets a CUDA device and none is available; "
                           'pass device="cpu" to build the model there')
    cfg = cfg or {}
    bb_cfg = cfg.get("BACKBONE")
    if bb_cfg is not None and bb_cfg["TYPE"].lower().startswith("resnet"):
        backbone = ResNet.from_config(bb_cfg)
    else:
        backbone = ResNet(arch="resnet50", norm="gn")
    mano = ManoLayer(center_idx=0)
    out = mano(torch.zeros(1, 48), torch.zeros(1, 10))
    joints, verts = out.joints[0].numpy(), out.verts[0].numpy()
    sampler_path = cfg.get("MESH_SAMPLER_PATH")
    D, U = load_mesh_sampler(sampler_path) if sampler_path else synthetic_mesh_sampler(verts)
    model = METRONetwork(backbone, joints, D @ verts,
                         input_feat_dims=tuple(cfg.get("INPUT_FEAT_DIM", (2051, 512, 128))),
                         hidden_feat_dims=tuple(cfg.get("HIDDEN_FEAT_DIM", (1024, 256, 64))))
    init_parameters(model, generator or torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.upsampling.weight.copy_(torch.from_numpy(U))
    model = model.to(device=device, dtype=dtype).eval()
    return model, {"mano_layer": mano, "downsample": D, "upsample": U}


MODEL.register_module("METRO")(create_metro_model)
