"""CMR baseline: spiral-convolution mesh regression from one view (counterpart of
``poem_v2_tpu/models/cmr.py``).

The reference's CMR_G graph: a ResNet trunk that also returns its post-stem
feature (``EncodeUV``), a skip-connected UV decoder giving a 21-channel 2D pose
prior, 15 "relation" channel sums of it (one (15, 21) contraction), a second
trunk over [stem feature, prior, relations] with a global latent
(``EncodeMesh``), the latent's self-attention, a coarse-to-fine spiral decoder
over a 5-level vertex hierarchy with a 3-channel head per level, and a second
UV decoder giving refined uv and a silhouette mask.

The hierarchy and the spiral index sequences are host numpy, copied from the
JAX module (array for array the same): synthesised from the MANO template
(farthest-point levels, nearest-neighbour spirals, inverse-distance up
matrices) or read from the reference's ``template/transform.pkl``. A spiral
convolution gathers each vertex's sequence and applies one Linear (flattened
in (sequence, channel) order); the up matrices are dense (at most 778 x 389).

Images come in channels-last (B, H, W, 3); the uv maps go out channels-last, as
in JAX. Submodules carry the flax names (``encode_uv``, ``uv_decoder``,
``deblock_{i}``, ``heads_{i}``, ``attention``, ``de_linear`` ...) so that
``convert.py`` maps the flax variables with no rule of their own.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..mano.layer import ManoLayer
from ..utils.registry import MODEL
from .backbones.resnet import BasicBlock, Bottleneck, conv, make_norm
from .neck import ConvBlock, upsample2x


def _to_dense(m) -> np.ndarray:
    if hasattr(m, "todense"):
        return np.asarray(m.todense(), dtype=np.float32)
    return np.asarray(m, dtype=np.float32)


# tip pairs + finger chains summed into extra evidence channels
# (reference model.py:125-141)
CMR_RELATION = (
    (4, 8), (4, 12), (4, 16), (4, 20),
    (8, 12), (8, 16), (8, 20),
    (12, 16), (12, 20), (16, 20),
    (1, 2, 3, 4), (5, 6, 7, 8), (9, 10, 11, 12), (13, 14, 15, 16),
    (17, 18, 19, 20),
)


def relation_matrix(n_joints: int = 21) -> np.ndarray:
    """(n_relations, n_joints) 0/1 matrix so the reference's per-relation
    ``uv_prior[:, rel].sum(dim=1)`` loop becomes one einsum."""
    m = np.zeros((len(CMR_RELATION), n_joints), np.float32)
    for i, rel in enumerate(CMR_RELATION):
        m[i, list(rel)] = 1.0
    return m


def extract_spirals(faces: np.ndarray, n_verts: int, seq_length: int) -> np.ndarray:
    """Spiral index sequences from mesh topology: ordered 1-ring walk via
    shared triangles, extended ring-by-ring to ``seq_length``.

    Topology-faithful equivalent of the spiralnet++ preprocessing the
    reference runs on its template (external/cmr/utils.py:361-400); start
    vertex choice is the lowest-index neighbour (deterministic; the
    upstream picks by geometry, so orderings can rotate — SpiralConv
    weights are sequence-position-specific, noted for converted ckpts).
    """
    nbrs = [set() for _ in range(n_verts)]
    nxt = [dict() for _ in range(n_verts)]
    for a, b, c in np.asarray(faces, dtype=np.int64):
        for v, x, y in ((a, b, c), (b, c, a), (c, a, b)):
            nbrs[v].update((int(x), int(y)))
            nxt[v][int(x)] = int(y)
    out = np.zeros((n_verts, seq_length), np.int32)
    for v in range(n_verts):
        if not nbrs[v]:
            out[v] = v
            continue
        start = min(nbrs[v])
        ring, cur = [], start
        while True:
            ring.append(cur)
            cur = nxt[v].get(cur)
            if cur is None or cur == start or len(ring) > len(nbrs[v]):
                break
        spiral = [v] + ring
        seen = set(spiral)
        frontier = ring
        while len(spiral) < seq_length and frontier:
            new = []
            for u in frontier:
                for w in sorted(nbrs[u]):
                    if w not in seen:
                        seen.add(w)
                        new.append(w)
                        spiral.append(w)
            frontier = new
        spiral = spiral[:seq_length]
        while len(spiral) < seq_length:
            spiral.append(spiral[-1])
        out[v] = spiral
    return out


def load_spiral_transform(path: str, seq_length=(27, 27, 27, 27), spiral_len: int = None):
    """Load the reference CMR ``template/transform.pkl``.

    Format (external/cmr/utils.py:16-52): pickle with ``vertices`` (list
    of per-level vertex arrays), ``face`` (per-level faces),
    ``up_transform`` (list of scipy-sparse coarse->fine matrices).
    Returns ``(verts_list, spirals_list, up_mats)`` in the same layout as
    :func:`build_mesh_hierarchy` (spirals computed from the loaded faces;
    the reference builds spirals for every level except the coarsest —
    utils.py:38-41).
    """
    import pickle

    with open(path, "rb") as f:
        tmp = pickle.load(f, encoding="latin1")
    verts = [np.asarray(v, np.float32) for v in tmp["vertices"]]
    faces = [np.asarray(fc) for fc in tmp["face"]]
    up_mats = [_to_dense(u) for u in tmp["up_transform"]]
    n_levels = min(len(seq_length), len(faces))
    spirals = [
        extract_spirals(faces[i], verts[i].shape[0], seq_length[i]) for i in range(n_levels)
    ]
    return verts, spirals, up_mats


def build_mesh_hierarchy(
    v_template: np.ndarray, levels=(778, 389, 194, 97, 49), spiral_len: int = 9
):
    """Deterministic vertex hierarchy + per-level spiral indices + up matrices.

    Spirals are nearest-neighbour orderings (a topology-free stand-in for
    the reference's precomputed boundary spirals — identical tensor
    contract: (n_nodes, seq_len) int indices). 5 levels like the
    reference's ds_factors=[2,2,2,2] pipeline (utils.py:16-22).
    """
    verts = [v_template]
    keep_idx = []
    for lv in levels[1:]:
        prev = verts[-1]
        # farthest point downsample
        chosen = [0]
        d = np.linalg.norm(prev - prev[0], axis=1)
        for _ in range(lv - 1):
            i = int(np.argmax(d))
            chosen.append(i)
            d = np.minimum(d, np.linalg.norm(prev - prev[i], axis=1))
        chosen = np.asarray(sorted(chosen))
        keep_idx.append(chosen)
        verts.append(prev[chosen])

    spirals = []
    for v in verts:
        d2 = ((v[:, None] - v[None]) ** 2).sum(-1)
        order = np.argsort(d2, axis=1)[:, :spiral_len]
        spirals.append(order.astype(np.int32))

    up_mats = []  # U_l: (n_{l}, n_{l+1}) maps coarse->fine
    for fine, coarse_idx in zip(verts[:-1], keep_idx):
        coarse = fine[coarse_idx]
        U = np.zeros((fine.shape[0], coarse.shape[0]), dtype=np.float32)
        for i in range(fine.shape[0]):
            dist = np.linalg.norm(coarse - fine[i], axis=1)
            nn3 = np.argsort(dist)[:3]
            w = 1.0 / (dist[nn3] + 1e-6)
            U[i, nn3] = w / w.sum()
        up_mats.append(U)
    return verts, spirals, up_mats


def mesh_pool(x: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Coarse -> fine vertex features, x (B, n_coarse, C), up (n_fine, n_coarse)."""
    return torch.matmul(up.to(x.dtype), x)


class SpiralConv(nn.Module):
    """Each vertex's spiral sequence gathered and flattened in (sequence, channel)
    order, then one Linear (``Dense_0``): (B, N, C) -> (B, N, out)."""

    def __init__(self, cin: int, out_channels: int, indices: np.ndarray):
        super().__init__()
        idx = np.asarray(indices)
        self.register_buffer("indices", torch.as_tensor(idx.reshape(-1), dtype=torch.long),
                             persistent=False)
        self.n, self.s = idx.shape
        self.Dense_0 = nn.Linear(self.s * cin, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gathered = x[:, self.indices].reshape(x.shape[0], self.n, self.s * x.shape[-1])
        return self.Dense_0(gathered)


class ParallelDeblock(nn.Module):
    """Upsample through ``up``, then relu(conv1(x) + [conv(x), conv_2d3(x),
    conv_d3(x)]): spiral convs over the first 1, S, 2S/3 and S/3 of each sequence,
    of widths out, out / 2, out / 4 and out / 4, concatenated in that order."""

    def __init__(self, cin: int, out_channels: int, indices: np.ndarray, up: np.ndarray):
        super().__init__()
        idx = np.asarray(indices)
        s = idx.shape[1]
        self.register_buffer("up", torch.as_tensor(np.asarray(up), dtype=torch.float32),
                             persistent=False)
        self.conv1 = SpiralConv(cin, out_channels, idx[:, :1])
        self.conv_d3 = SpiralConv(cin, out_channels // 4, idx[:, : s // 3])
        self.conv_2d3 = SpiralConv(cin, out_channels // 4, idx[:, : s // 3 * 2])
        self.conv = SpiralConv(cin, out_channels // 2, idx)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = mesh_pool(x, self.up)
        p = torch.cat([self.conv(out), self.conv_2d3(out), self.conv_d3(out)], dim=2)
        return torch.relu(self.conv1(out) + p)


_TRUNKS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2), (1000, 512, 256, 128, 64)),
    "resnet34": (BasicBlock, (3, 4, 6, 3), (1000, 512, 256, 128, 64)),
    "resnet50": (Bottleneck, (3, 4, 6, 3), (1000, 2048, 1024, 512, 256)),
}


def _add_trunk(module: nn.Module, arch: str, norm: str) -> None:
    """The four residual stages, ``layer{i}_block{b}``, on a 64-channel input."""
    block_cls, layers, _ = _TRUNKS[arch]
    expansion = 4 if block_cls is Bottleneck else 1
    module.trunk = []
    cin = 64
    for i, (width, n_blocks) in enumerate(zip((64, 128, 256, 512), layers)):
        names = []
        for b in range(n_blocks):
            name = f"layer{i + 1}_block{b}"
            module.add_module(name, block_cls(cin, width, 2 if (b == 0 and i > 0) else 1, norm))
            cin = width * expansion
            names.append(name)
        module.trunk.append(names)


def _run_trunk(module: nn.Module, x: torch.Tensor):
    feats = []
    for names in module.trunk:
        for name in names:
            x = getattr(module, name)(x)
        feats.append(x)
    return feats


class EncodeUV(nn.Module):
    """ResNet trunk (NCHW) -> (x0, x4, x3, x2, x1); x0 the post-stem feature
    before the max-pool."""

    def __init__(self, arch: str = "resnet18", norm: str = "gn"):
        super().__init__()
        self.stem_conv = conv(3, 64, 7, 2)
        self.stem_norm = make_norm(norm, 64)
        _add_trunk(self, arch, norm)

    def forward(self, image: torch.Tensor):
        x0 = torch.relu(self.stem_norm(self.stem_conv(image)))
        x1, x2, x3, x4 = _run_trunk(self, F.max_pool2d(x0, 3, 2, 1))
        return x0, x4, x3, x2, x1


class EncodeMesh(nn.Module):
    """Three reduce ConvBlocks, a max-pool, the residual stages, and the global
    mean through ``fc``: -> (latent, x4, x3, x2, x1)."""

    def __init__(self, cin: int, arch: str = "resnet18", norm: str = "gn"):
        super().__init__()
        self.reduce_0 = ConvBlock(cin, cin, 3, norm=norm, relu=True)
        self.reduce_1 = ConvBlock(cin, 128, 3, norm=norm, relu=True)
        self.reduce_2 = ConvBlock(128, 64, 1, norm=norm, relu=False)
        _add_trunk(self, arch, norm)
        latent = _TRUNKS[arch][2]
        self.fc = nn.Linear(latent[1], latent[0])

    def forward(self, x: torch.Tensor):
        x = self.reduce_2(self.reduce_1(self.reduce_0(x)))
        x1, x2, x3, x4 = _run_trunk(self, F.max_pool2d(x, 3, 2, 1))
        return self.fc(x4.mean(dim=(2, 3))), x4, x3, x2, x1


class UVDecoder(nn.Module):
    """Four stages of 2x bilinear upsample (+ the next skip) and a ConvBlock, then a
    norm-free head and a sigmoid: (x4, x3, x2, x1) -> (B, head_features, H, W)."""

    def __init__(self, in_channels: Sequence[int], widths: Sequence[int], head_features: int,
                 norm: str = "gn"):
        super().__init__()
        self.n = len(widths)
        cin = in_channels[0]
        for i, w in enumerate(widths):
            skip = in_channels[i + 1] if i < self.n - 1 else 0
            self.add_module(f"ConvBlock_{i}", ConvBlock(cin + skip, w, 3, norm=norm))
            cin = w
        self.head = ConvBlock(cin, head_features, 3, norm="none", relu=False)

    def forward(self, z) -> torch.Tensor:
        x = z[0]
        for i in range(self.n):
            x = upsample2x(x)
            if i < self.n - 1:
                x = torch.cat([x, z[i + 1]], dim=1)
            x = getattr(self, f"ConvBlock_{i}")(x)
        return torch.sigmoid(self.head(x))


class SelfAttention(nn.Module):
    """Self-attention over the latent's features: softmax over j of q_i k_j weights
    v_j; out = gamma * that + x, gamma initialised to zero."""

    def __init__(self, d: int):
        super().__init__()
        self.query_conv = nn.Linear(d, d)
        self.key_conv = nn.Linear(d, d)
        self.value_conv = nn.Linear(d, d)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query_conv(x), self.key_conv(x), self.value_conv(x)
        attn = torch.softmax(q[:, :, None] * k[:, None, :], dim=-1)  # (B, D, D)
        out = torch.matmul(attn, v[:, :, None])[..., 0]
        return self.gamma * out + x


class CMRG(nn.Module):
    """The CMR_G network; images (B, H, W, 3) -> {"pred_verts_3d_rel" (B, 778, 3)
    float32, "mesh_pred" (the four levels, finest first), "uv_pred" (B, H / 2,
    W / 2, 21), "mask_pred" (B, H / 2, W / 2), "uv_prior" (B, H / 2, W / 2, 21)}."""

    def __init__(self, spirals: Sequence[np.ndarray], up_mats: Sequence[np.ndarray],
                 arch: str = "resnet18", norm: str = "gn",
                 out_channels: Sequence[int] = (32, 64, 128, 256), uv_channels: int = 21,
                 att: bool = True, v_std: float = 0.2):
        super().__init__()
        latent = _TRUNKS[arch][2]
        self.uv_channels, self.att, self.v_std = uv_channels, att, v_std
        oc = list(out_channels)
        trunk_ch = latent[1:]
        uv_widths = (latent[2], latent[3], latent[4], latent[4])
        self.encode_uv = EncodeUV(arch, norm)
        self.uv_decoder = UVDecoder(trunk_ch, uv_widths, uv_channels, norm)
        self.register_buffer("relation", torch.from_numpy(relation_matrix(uv_channels)),
                             persistent=False)
        self.encode_mesh = EncodeMesh(64 + uv_channels + len(CMR_RELATION), arch, norm)
        if att:
            self.attention = SelfAttention(latent[0])
        self.n_coarse = np.asarray(up_mats[-1]).shape[1]
        self.de_linear = nn.Linear(latent[0], self.n_coarse * oc[-1])
        self.n_levels = len(oc)
        cin = oc[-1]
        for i in range(self.n_levels):
            level = self.n_levels - 1 - i  # coarsest first
            self.add_module(f"deblock_{i + 1}", ParallelDeblock(
                cin, oc[level], spirals[level], up_mats[level]))
            self.add_module(f"heads_{i}", SpiralConv(oc[level], 3, spirals[level]))
            cin = oc[level] + 3
        self.uv_decoder2 = UVDecoder(trunk_ch, uv_widths, uv_channels + 1, norm)

    def decoder(self, latent: torch.Tensor):
        """Linear, then per level coarse to fine: deblock, a 3-channel head averaged
        with the previous level's upsampled prediction, their concat. Fine first."""
        if self.att:
            latent = self.attention(latent)
        x = self.de_linear(latent).reshape(latent.shape[0], self.n_coarse, -1)
        preds = []
        for i in range(self.n_levels):
            block = getattr(self, f"deblock_{i + 1}")
            x = block(x)
            pred = getattr(self, f"heads_{i}")(x)
            if i > 0:
                pred = (pred + mesh_pool(preds[-1], block.up)) / 2.0
            preds.append(pred)
            x = torch.cat([x, pred], dim=2)
        return preds[::-1]

    def forward(self, image: torch.Tensor) -> Dict[str, Any]:
        dt = self.de_linear.weight.dtype
        z_uv = self.encode_uv(image.to(dt).permute(0, 3, 1, 2))
        uv_prior = self.uv_decoder(z_uv[1:])
        rel_maps = torch.einsum("rc,bchw->brhw", self.relation.to(uv_prior.dtype), uv_prior)
        z_mesh = self.encode_mesh(torch.cat([z_uv[0], uv_prior, rel_maps], dim=1))
        mesh_pred = self.decoder(z_mesh[0])
        uv = self.uv_decoder2(z_mesh[1:]).permute(0, 2, 3, 1)
        return {"pred_verts_3d_rel": mesh_pred[0].float() * self.v_std, "mesh_pred": mesh_pred,
                "uv_pred": uv[..., :self.uv_channels], "mask_pred": uv[..., self.uv_channels],
                "uv_prior": uv_prior.permute(0, 2, 3, 1)}


def cmr_hierarchy(cfg: Optional[dict], mano: ManoLayer
                  ) -> Tuple[Sequence[np.ndarray], Sequence[np.ndarray]]:
    """(spirals, up matrices) of the first four levels: from ``TRANSFORM_PKL`` where
    the config names one, else built from ``verts[0]`` of a zero-pose forward of
    ``mano`` (the port's float32 template differs from the JAX layer's in its last
    bits: the levels and spirals come out the same, the up matrices within 2e-6)."""
    path = (cfg or {}).get("TRANSFORM_PKL")
    if path:
        _, spirals, up_mats = load_spiral_transform(path)
    else:
        verts = mano(torch.zeros(1, 48), torch.zeros(1, 10)).verts[0].numpy()
        _, spirals, up_mats = build_mesh_hierarchy(verts)
    return spirals[:4], up_mats[:4]


def create_cmr_model(cfg: Optional[dict] = None, dtype: torch.dtype = torch.float32,
                     device: torch.device | str = "cuda",
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[CMRG, Dict[str, Any]]:
    """Build CMR_G from a config (``BACKBONE.TYPE`` resnet18 / 34 / 50 and ``NORM``,
    ``FREEZE_BATCHNORM`` for ``frozen_bn``; ``OUT_CHANNELS``, ``ATT``,
    ``TRANSFORM_PKL``; None: ResNet-18 GN, (32, 64, 128, 256), attention on).
    Weights from ``generator`` (seed 0 if None; ``gamma`` zero, as flax
    initialises it), eval mode, on ``device`` (the card by default). Returns
    (model, {"mano_layer": the MANO layer, centred on joint 0})."""
    from .poem import init_parameters

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_cmr_model targets a CUDA device and none is available; "
                           'pass device="cpu" to build the model there')
    cfg = cfg or {}
    bb = cfg.get("BACKBONE")
    arch = bb["TYPE"].lower() if bb is not None else "resnet18"
    norm = ("frozen_bn" if bb is not None and bb.get("FREEZE_BATCHNORM", False)
            else (bb.get("NORM", "gn") if bb is not None else "gn"))
    mano = ManoLayer(center_idx=0)
    spirals, up_mats = cmr_hierarchy(cfg, mano)
    model = CMRG(spirals, up_mats, arch=arch, norm=norm,
                 out_channels=tuple(cfg.get("OUT_CHANNELS", (32, 64, 128, 256))),
                 att=bool(cfg.get("ATT", True)))
    init_parameters(model, generator or torch.Generator().manual_seed(0))
    model = model.to(device=device, dtype=dtype).eval()
    return model, {"mano_layer": mano}


MODEL.register_module("CMR_G")(create_cmr_model)
