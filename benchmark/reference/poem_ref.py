"""The plain float32 reference of POEM's forward, written for the benchmark.

It follows the release configuration's model (HRNet GN backbone, the feature
and heatmap necks, the integral heatmap, the masked DLT, the POEM head with its
BPS sampling, the merge-input scramble and the cross-view merge, the
point-embedded decoder with BERT attention and K-nearest-neighbour vector
attention) in plain PyTorch operations: no kernel, no cache, no batching
trick. It imports nothing of the program. It reads the program's weights by
their names in the model's ``state_dict`` (the checkpoint format), and works
out again what the program derives at set-up: the BPS basis, the anchors and
the template from the repo's raw assets and the hand model.

Products go through :class:`Precision`: float32 (the reference) or a lower
precision whose operands are rounded before each product (the controls).
TF32 must be off while the reference runs (:func:`float32_matmuls`).
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .mano_ref import mano_forward, synthetic_mano

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "assets")


class Precision:
    """Rounding of every product's operands: "float32" (none), "bfloat16", or
    "fp8" (float8 e4m3 with one scale per tensor, amax to 448). The rounding
    passes the gradient straight through."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "bfloat16", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return x
        with torch.no_grad():
            if self.kind == "bfloat16":
                r = x.to(torch.bfloat16).float()
            else:
                scale = 448.0 / x.abs().amax().clamp_min(1e-30)
                r = (x * scale).to(torch.float8_e4m3fn).float() / scale
        return x + (r - x).detach() if x.requires_grad else r

    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).t()
        return y if b is None else y + b

    def conv(self, x, w, b=None, stride=1):
        return F.conv2d(self.q(x), self.q(w), b, stride, padding=w.shape[-1] // 2)


@contextlib.contextmanager
def float32_matmuls():
    """TF32 off for matrix products and convolutions, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def load_constants(model_cfg: dict, device) -> Dict[str, torch.Tensor]:
    """bps (N, 3) metres, anchor_xyz (32, 3), anchor_idx (32,), template (799, 3)
    centred at the transformer centre joint, j_regressor (16, 778)."""
    head = model_cfg["HEAD"]
    bps = np.load(os.path.join(ASSETS, "bps.npy")).reshape(-1, 3).astype(np.float32)
    if bps.shape[0] != head["N_SAMPLE"]:
        raise ValueError(f"assets/bps.npy has {bps.shape[0]} points, the config {head['N_SAMPLE']}")
    anchor_xyz = np.load(os.path.join(ASSETS, "anchor.npy")).reshape(-1, 3).astype(np.float32)
    anchor_idx = np.load(os.path.join(ASSETS, "anchor_idx.npy")).reshape(-1).astype(np.int64)
    mano = synthetic_mano()
    verts, joints = mano_forward(mano, torch.zeros(1, 48), torch.zeros(1, 10))
    centre = head["TRANSFORMER"].get("TRANSFORMER_CENTER_IDX", 9)
    template = torch.cat([joints, verts], 1)[0]
    template = template - template[centre]
    t = lambda a: torch.as_tensor(a, device=device)
    return {"bps": t(bps), "anchor_xyz": t(anchor_xyz), "anchor_idx": t(anchor_idx),
            "template": template.to(device), "j_regressor": t(mano["j_regressor"]),
            "centre_idx": centre}


class Reference:
    """POEM at one configuration over a parameter dict (name -> float32 tensor)."""

    def __init__(self, params: Dict[str, torch.Tensor], model_cfg: dict, consts: dict,
                 precision: Precision):
        self.P, self.cfg, self.c, self.pr = params, model_cfg, consts, precision
        head = model_cfg["HEAD"]
        tr = head["TRANSFORMER"]
        self.D, self.heads = head["EMBED_DIMS"], tr["NUM_ATTENTION_HEADS"]
        self.n_blocks, self.k_self, self.k_cross = tr["N_BLOCKS"], tr["N_NEIGHBOR_QUERY"], tr["N_NEIGHBOR"]
        self.radius, self.num_feats = head["RADIUS_SAMPLE"], head["POSITIONAL_ENCODING"]["NUM_FEATS"]

    # -- building blocks ----------------------------------------------------
    def gn(self, x, name):
        C = x.shape[1]
        groups = 32 if C % 32 == 0 else next(g for g in (8, 4, 2, 1) if C % g == 0)
        return F.group_norm(x, groups, self.P[name + ".weight"], self.P[name + ".bias"], 1e-6)

    def conv(self, x, name, stride=1, bias=False):
        return self.pr.conv(x, self.P[name + ".weight"], self.P[name + ".bias"] if bias else None,
                            stride)

    def lin(self, x, name):
        return self.pr.linear(x, self.P[name + ".weight"], self.P.get(name + ".bias"))

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.P[name + ".weight"], self.P[name + ".bias"], 1e-6)

    # -- backbone -----------------------------------------------------------
    def basic(self, x, n, stride=1):
        y = F.relu(self.gn(self.conv(x, n + ".Conv_0", stride), n + ".norm_0"))
        y = self.gn(self.conv(y, n + ".Conv_1"), n + ".norm_1")
        r = self.gn(self.conv(x, n + ".Conv_2", stride), n + ".norm_2") \
            if n + ".Conv_2.weight" in self.P else x
        return F.relu(y + r)

    def bottleneck(self, x, n):
        y = F.relu(self.gn(self.conv(x, n + ".Conv_0"), n + ".norm_0"))
        y = F.relu(self.gn(self.conv(y, n + ".Conv_1"), n + ".norm_1"))
        y = self.gn(self.conv(y, n + ".Conv_2"), n + ".norm_2")
        r = self.gn(self.conv(x, n + ".Conv_3"), n + ".norm_3") if n + ".Conv_3.weight" in self.P else x
        return F.relu(y + r)

    def hr_module(self, xs, n):
        ys = []
        for i, y in enumerate(xs):
            for b in range(4):
                y = self.basic(y, f"{n}.branch{i}_block{b}")
            ys.append(y)
        if len(xs) == 1:
            return ys
        outs = []
        for i in range(len(ys)):
            acc = 0
            for j in range(len(ys)):
                y = ys[j]
                if j > i:
                    y = self.gn(self.conv(y, f"{n}.fuse.up_{j}_to_{i}_conv"), f"{n}.fuse.up_{j}_to_{i}_norm")
                    y = F.interpolate(y, size=ys[i].shape[2:], mode="nearest")
                elif j < i:
                    for k in range(i - j):
                        y = self.gn(self.conv(y, f"{n}.fuse.down_{j}_to_{i}_conv{k}", 2),
                                    f"{n}.fuse.down_{j}_to_{i}_norm{k}")
                        if k != i - j - 1:
                            y = F.relu(y)
                acc = acc + y
            outs.append(F.relu(acc))
        return outs

    def hrnet(self, x):
        b = "backbone."
        cbr = lambda x, n, s=1: F.relu(self.gn(self.conv(x, b + n, s), b + n + "_norm"))
        x = cbr(cbr(x, "stem1", 2), "stem2", 2)
        for i in range(4):
            x = self.bottleneck(x, f"{b}layer1_block{i}")
        xs = [cbr(x, "t1_b0"), cbr(x, "t1_b1", 2)]
        for m in range(1):
            xs = self.hr_module(xs, f"{b}stage2_m{m}")
        xs = xs + [cbr(xs[-1], "t2_b2", 2)]
        for m in range(4):
            xs = self.hr_module(xs, f"{b}stage3_m{m}")
        xs = xs + [cbr(xs[-1], "t3_b3", 2)]
        for m in range(3):
            xs = self.hr_module(xs, f"{b}stage4_m{m}")
        return xs

    def conv_block(self, x, n, stride=1, norm=True, relu=True):
        x = self.conv(x, n + ".Conv_0", stride, bias=True)
        if norm:
            x = self.gn(x, n + ".norm_0")
        return F.relu(x) if relu else x

    def necks(self, feats):
        up = lambda t: F.interpolate(t, scale_factor=2, mode="bilinear", align_corners=False)
        x = feats[0]
        for i in range(3):
            x = self.conv_block(x, f"feat_neck.ConvBlock_{i}", 2) + feats[i + 1]
        mlvl = self.conv_block(up(x), "feat_neck.feat_in", norm=False, relu=False)
        rev = feats[::-1]
        x = rev[0]
        for i in range(3):
            x = self.conv_block(torch.cat([up(x), rev[i + 1]], 1), f"uv_neck.ConvBlock_{i}")
        hmap = torch.sigmoid(self.conv_block(F.max_pool2d(x, 2), "uv_neck.uv_out", norm=False,
                                             relu=False))
        return mlvl, hmap

    # -- geometry -------------------------------------------------------------
    @staticmethod
    def integral_uv(hmap):
        """(N, J, h, w) maps -> (N, J, 2) in [0, 1), the soft-argmax of the normalised map."""
        h, w = hmap.shape[-2:]
        p = hmap / (hmap.sum((-2, -1), keepdim=True) + 1e-6)
        u = (p.sum(-2) * torch.arange(w, device=p.device) / w).sum(-1)
        v = (p.sum(-1) * torch.arange(h, device=p.device) / h).sum(-1)
        return torch.stack([u, v], -1)

    @staticmethod
    def world_to_cam(cam_extr):
        """camera->master (B, V, 4, 4) -> master->camera."""
        return torch.linalg.inv(cam_extr.double()).float()

    @staticmethod
    def dlt(uv, cam_intr, m2c, view_mask):
        """Masked DLT: (B, V, J, 2) pixels -> (B, J, 3), the right singular vector
        of the smallest singular value, in float64."""
        P = (cam_intr.double() @ m2c.double()[..., :3, :])                  # (B, V, 3, 4)
        u = uv.double()[..., None]                                          # (B, V, J, 2, 1)
        a = u * P[:, :, None, 2:3, :] - P[:, :, None, :2, :]                # (B, V, J, 2, 4)
        a = a * view_mask[:, :, None, None, None].double()
        B, V, J = uv.shape[:3]
        a = a.permute(0, 2, 1, 3, 4).reshape(B, J, 2 * V, 4)
        x = torch.linalg.svd(a).Vh[..., -1, :]
        return (x[..., :3] / x[..., 3:]).float()

    def sine_encoding(self, view_mask, H, W):
        """(B, V, H, W, 3F): the masked 3D sine encoding over (view, y, x), each
        block sines of even then cosines of odd frequencies."""
        Fn = self.num_feats
        vm = view_mask.float()
        eps, scale = 1e-6, 2 * math.pi
        n = torch.cumsum(vm, 1) * vm / (vm.sum(1, keepdim=True) + eps) * scale
        i = torch.arange(Fn, device=vm.device, dtype=torch.float32)
        dim_t = 10000.0 ** (2.0 * torch.floor(i / 2.0) / Fn)

        def enc(v):
            v = v[..., None] / dim_t
            return torch.cat([torch.sin(v[..., 0::2]), torch.cos(v[..., 1::2])], -1)

        # (pos + 1) * mask over (last + 1) * mask + eps: masked views carry zeros
        yv = (torch.arange(H, device=vm.device) + 1.0)[None, None] * vm[..., None]
        xv = (torch.arange(W, device=vm.device) + 1.0)[None, None] * vm[..., None]
        y = yv / (yv[..., -1:] + eps) * scale
        x = xv / (xv[..., -1:] + eps) * scale
        B, V = vm.shape
        full = (B, V, H, W, Fn)
        return torch.cat([enc(n)[:, :, None, None].expand(full), enc(y)[:, :, :, None].expand(full),
                          enc(x)[:, :, None, :].expand(full)], -1)

    # -- head ---------------------------------------------------------------------
    def mlp(self, x, n):
        return self.lin(F.relu(self.lin(x, n + ".Dense_0")), n + ".Dense_1")

    def merge(self, feats, view_mask):
        """feats (B, V, N, C) -> (B, N, C), the master-query merge over valid views."""
        n = "head.merge_feature."
        q = feats.transpose(1, 2)                        # (B, N, V, C)
        qm = self.mlp(q, n + "merge_net_0")
        master, others = qm[:, :, 0], qm[:, :, 1:]
        om = view_mask[:, 1:].float()
        score = (others * master[:, :, None]).sum(-1) * om[:, None]
        agg = (score[..., None] * others * om[:, None, :, None]).sum(2)
        nv = view_mask.float().sum(1)
        mv = q[:, :, 0] + self.mlp(agg, n + "merge_net_1") / nv.clamp_min(1.0)[:, None, None]
        sv = q[:, :, 0] + self.mlp(self.mlp(q[:, :, 0], n + "merge_net_0"), n + "merge_net_1")
        return torch.where((nv <= 1.0)[:, None, None], sv, mv)

    @staticmethod
    def scramble(a, n_val):
        """(B, V, C, NS) -> (B, NS, V, C): row (i, j) of sample b is the C-run at
        (i * n_b + j) * C of the sample's flat (V, C, NS) layout (clamped to the
        last run); the rows j >= n_b are masked by the merge."""
        B, V, C, NS = a.shape
        rows = a.reshape(B, V * NS, C)
        i = torch.arange(NS, device=a.device)[None, :, None]
        j = torch.arange(V, device=a.device)[None, None, :]
        r = (i * n_val[:, None, None] + j).clamp_max(V * NS - 1).reshape(B, NS * V)
        return torch.gather(rows, 1, r[..., None].expand(B, NS * V, C)).reshape(B, NS, V, C)

    def vector_attention(self, q, k, v, delta, n):
        """q (B, M, D), k / v (B, M, K, D), delta (B, M, K, 3) -> (B, M, D)."""
        P, pr = self.P, self.pr
        pos = pr.mm(F.relu(pr.mm(delta, P[n + ".fc_delta_w1"]) + P[n + ".fc_delta_b1"]),
                    P[n + ".fc_delta_w2"]) + P[n + ".fc_delta_b2"]
        x = q[:, :, None] - k + pos
        g = pr.mm(F.relu(pr.mm(x, P[n + ".fc_gamma_w1"]) + P[n + ".fc_gamma_b1"]),
                  P[n + ".fc_gamma_w2"]) + P[n + ".fc_gamma_b2"]
        a = torch.softmax(g / math.sqrt(k.shape[-1]), dim=2)
        return (a * (v + pos)).sum(2)

    @staticmethod
    def knn(query, cloud, k):
        """Exact K nearest cloud points of each query, ascending, ties to the lower index."""
        d2 = ((query[:, :, None, :] - cloud[:, None, :, :]) ** 2).sum(-1)
        return torch.sort(d2, dim=-1, stable=True).indices[..., :k]

    @staticmethod
    def gather(x, idx):
        B, M, K = idx.shape
        return torch.gather(x, 1, idx.reshape(B, M * K, 1).expand(B, M * K, x.shape[-1])
                            ).reshape(B, M, K, -1)

    def attend(self, n, q, query_xyz, cloud_xyz, x_cloud, k, init_block):
        P, pr = self.P, self.pr
        wk, wv = P[n + ".w_ks.kernel"], P[n + ".w_vs.kernel"]
        B, M, D = q.shape
        if init_block:
            idx = self.c["anchor_idx"]
            A = idx.shape[0]
            xa = x_cloud[:, idx]
            ka = pr.mm(xa, wk)[:, None].expand(B, M, A, D)
            va = pr.mm(xa, wv)[:, None].expand(B, M, A, D)
            delta = query_xyz[:, :, None] - self.c["anchor_xyz"][None, None]
            return self.vector_attention(q, ka, va, delta, n)
        with torch.no_grad():
            idx = self.knn(query_xyz.detach(), cloud_xyz.detach(), k)
        # k / v of a neighbour are its cloud point's projections: project once, gather
        delta = query_xyz[:, :, None] - self.gather(cloud_xyz, idx)
        return self.vector_attention(q, self.gather(pr.mm(x_cloud, wk), idx),
                                     self.gather(pr.mm(x_cloud, wv), idx), delta, n)

    def mha(self, hidden, kv, n):
        B, Q, H = hidden.shape
        nh, hd = self.heads, H // self.heads
        q = self.lin(hidden, n + ".query").reshape(B, Q, nh, hd).transpose(1, 2)
        k = self.lin(kv, n + ".key").reshape(B, -1, nh, hd).transpose(1, 2)
        v = self.lin(kv, n + ".value").reshape(B, -1, nh, hd).transpose(1, 2)
        p = torch.softmax(self.pr.mm(q, k.transpose(-1, -2)) / math.sqrt(hd), -1)
        ctx = self.pr.mm(p, v).transpose(1, 2).reshape(B, Q, H)
        return self.ln(self.lin(ctx, n + ".out") + hidden, n + ".ln")

    def block(self, i, query_xyz, query_feats, pt_xyz, pt_feats):
        n = f"head.transformer.block_{i}"
        q_emb = self.lin(query_feats, n + ".embedding")
        k_emb = self.lin(pt_feats, n + ".embedding")
        h = self.mha(self.mha(q_emb, k_emb, n + ".attn"), k_emb, n + ".cross_attn")
        s = n + ".vec_attn.query_self_attn"
        x = self.lin(h, s + ".fc1")
        res = self.attend(s, self.lin(x, s + ".w_qs"), query_xyz, query_xyz, x, self.k_self, i == 0)
        h = self.lin(res, s + ".fc2") + h
        c = n + ".vec_attn.query_cross_attn"
        res = self.attend(c, self.lin(h, c + ".w_qs"), query_xyz, pt_xyz, self.lin(k_emb, c + ".fc1"),
                          self.k_cross, i == 0)
        h = self.lin(res, c + ".fc2") + h
        xyz = query_xyz + self.mlp(h, n + ".vec_attn.reg_branch")
        f = n + ".ffn"
        ff = self.lin(F.gelu(self.lin(h, f + ".intermediate")), f + ".output")
        return self.ln(ff + h, f + ".ln"), xyz

    # -- the whole model ------------------------------------------------------------
    def forward(self, images, view_mask, cam_intr, cam_extr, ref_joints=None):
        """images (B, V, H, W, 3) float in [-0.5, 0.5], view_mask (B, V) bool, cameras
        (B, V, 3, 3) and (B, V, 4, 4) camera->master. The reference joints are
        the DLT of the 2D joints, or ``ref_joints`` where given (the operation
        count, which runs on the meta device). Returns joints_uv (B, V, 21, 2) pixels, coords (blocks, B, 799, 3) metres."""
        B, V, H, W, _ = images.shape
        feats = self.hrnet(images.reshape(B * V, H, W, 3).permute(0, 3, 1, 2))
        mlvl, hmap = self.necks(feats)
        uv = self.integral_uv(hmap).reshape(B, V, -1, 2) * torch.tensor([W, H], device=images.device)
        m2c = self.world_to_cam(cam_extr)
        if ref_joints is None:
            tri = self.dlt(uv, cam_intr, m2c, view_mask)
            ref = torch.where((view_mask.float().sum(1) <= 1.0)[:, None, None],
                              torch.zeros_like(tri), tri)
        else:
            ref = ref_joints
        h, w = mlvl.shape[-2:]
        x = self.pr.conv(mlvl, self.P["head.input_proj.weight"], self.P["head.input_proj.bias"])
        pe = self.sine_encoding(view_mask, h, w).permute(0, 1, 4, 2, 3).reshape(B * V, -1, h, w)
        x = x + self.pr.conv(pe, self.P["head.adapt_pos3d.weight"], self.P["head.adapt_pos3d.bias"])
        centre = ref[:, self.c["centre_idx"]]
        bps = self.c["bps"]
        pts = bps[None] + centre[:, None]                                    # (B, NS, 3)
        cam = (m2c[:, :, None, :3, :3] @ pts[:, None, :, :, None])[..., 0] + m2c[:, :, None, :3, 3]
        proj = (cam_intr[:, :, None] @ cam[..., None])[..., 0]
        z = proj[..., 2:3]
        z = torch.where(z.abs() < 1e-7, torch.full_like(z, 1e-7), z)
        grid = (proj[..., :2] / z) / torch.tensor([W, H], device=images.device) * 2.0 - 1.0
        NS = bps.shape[0]
        samp = F.grid_sample(x, grid.reshape(B * V, NS, 1, 2), mode="bilinear",
                             padding_mode="zeros", align_corners=False)          # (BV, C, NS, 1)
        samp = samp[..., 0].reshape(B, V, self.D, NS)
        merged = self.merge(self.scramble(samp, view_mask.long().sum(1)).transpose(1, 2), view_mask)
        query_feats = self.P["head.query_feat_embedding"][None].expand(B, -1, -1)
        pt_xyz = (bps / self.radius)[None].expand(B, NS, 3)
        query_xyz = (self.c["template"] / self.radius)[None].expand(B, -1, 3)
        coords = []
        for i in range(self.n_blocks):
            query_feats, query_xyz = self.block(i, query_xyz, query_feats, pt_xyz, merged)
            coords.append(query_xyz)
        coords = torch.nan_to_num(torch.stack(coords)) * self.radius + centre[None, :, None]
        return {"joints_uv": uv, "coords": coords, "ref_joints": ref}
