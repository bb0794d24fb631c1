"""The plain float32 reference of POEM with the PtEmbedTRv3 decoder
(``HEAD.TRANSFORMER.TYPE: PtEmbedTRv3``), written for the benchmark.

POEM-v2's METRO-hybrid decoder (``MetroTR`` / ``PtEmbedTRv3`` in
``lib/models/layers/ptEmb_transformer.py:124-300`` of the public POEM-v2 code):

1. the METRO stage: tokens (xyz ‖ feature) of the 799 template points and of the
   N BPS points (their merged features) pass three encoder blocks (METRO's hand
   widths: hidden 1024 / 256 / 64, outputs 512 / 128 / 3, 4 BERT layers of 4
   heads a block; Lin et al., arXiv:2012.09760), each a token embedding plus
   learned positions, full self-attention and a GELU FFN a layer, then a linear
   head plus a linear residual of the block's input; the first 799 tokens of the
   last block are the coarse mesh (normalised units);
2. the coarse mesh, in metres about the reference centre, is projected into every
   view and bilinearly sampled from the positional-encoded feature maps, then
   merged across views by its own master-query merge (``merge_branch``);
3. PtEmbedTRv2 refines it: a K-nearest-neighbour vector self-attention over the
   BPS cloud, then blocks of query self-attention, query cross-attention into the
   cloud and a Δxyz regression.

The backbone, necks, DLT, embedding, BPS sampling, scramble and the first merge
are :class:`~benchmark.reference.poem_ref.Reference`'s; this file adds the rest,
in plain PyTorch operations, and imports nothing of the program. Products go
through :class:`~benchmark.reference.poem_ref.Precision`, so the fp8 control
rounds them too. It returns what ``Reference.forward`` returns: ``coords`` holds
the coarse mesh, then each refinement.

Departures from the published description:

* the attention is computed in blocks of query rows (``query_block``) so that a
  chunk of samples fits; the fp8 control rounds q, k and v whole and each
  block's probabilities by the block's own scale;
* the METRO stage has 4 heads a block, the code's ``MetroTR`` default: no
  release configuration ships this head, and the model's config gives the
  heads of the flagship decoder only;
* exact float32 KNN, ties to the lower index (the program's K1 orders by packed
  keys that tie within 2**-11, so a near-tie may pick another neighbour);
* the sampler's grid stays float32 (the program rounds it to its compute dtype,
  as the JAX decoder casts it);
* the cloud's KNN self-attention uses ``N_NEIGHBOR`` and the queries' own
  ``N_NEIGHBOR_QUERY``, as the head builds PtEmbedTRv2; dropout is off (eval).
"""

from __future__ import annotations

import math
import re
from typing import Dict

import torch
import torch.nn.functional as F

from .poem_ref import Precision, Reference

PREFIX = "head.transformer."


class V3Reference(Reference):
    """POEM with the PtEmbedTRv3 decoder over a parameter dict (name -> float32
    tensor); the METRO stage's depth and widths are read from the parameters."""

    def __init__(self, params: Dict[str, torch.Tensor], model_cfg: dict, consts: dict,
                 precision: Precision, metro_heads: int = 4, query_block: int = 1024):
        super().__init__(params, model_cfg, consts, precision)
        block = re.compile(r"head\.transformer\.metro_block_(\d+)\.layer(\d+)_attn\.query\.weight")
        found = [tuple(map(int, m.groups())) for m in map(block.fullmatch, params) if m]
        self.n_metro = 1 + max(b for b, _ in found)
        self.metro_layers = 1 + max(layer for _, layer in found)
        self.metro_heads, self.query_block = metro_heads, query_block

    # -- the METRO stage --------------------------------------------------------
    def self_attention(self, x, n):
        """BERT self-attention over every token, in blocks of query rows."""
        B, S, H = x.shape
        nh, hd = self.metro_heads, H // self.metro_heads
        heads = lambda t: self.pr.q(t.reshape(B, S, nh, hd).transpose(1, 2))
        q, k, v = (heads(self.lin(x, n + "." + w)) for w in ("query", "key", "value"))
        kt = k.transpose(-1, -2)
        ctx = torch.cat([self.pr.mm(torch.softmax(q[:, :, s:s + self.query_block] @ kt
                                                  / math.sqrt(hd), -1), v)
                         for s in range(0, S, self.query_block)], dim=2)
        ctx = ctx.transpose(1, 2).reshape(B, S, H)
        return self.ln(self.lin(ctx, n + ".out") + x, n + ".ln")

    def ffn(self, x, n):
        return self.ln(self.lin(F.gelu(self.lin(x, n + ".intermediate")), n + ".output") + x,
                       n + ".ln")

    def metro_block(self, tokens, i):
        n = f"{PREFIX}metro_block_{i}"
        x = self.lin(tokens, n + ".img_embedding")
        x = x + self.P[n + ".position_embeddings"][:tokens.shape[1]]
        for layer in range(self.metro_layers):
            x = self.ffn(self.self_attention(x, f"{n}.layer{layer}_attn"), f"{n}.layer{layer}_ffn")
        return self.lin(x, n + ".cls_head") + self.lin(tokens, n + ".residual")

    # -- the coarse mesh's features ------------------------------------------------
    @staticmethod
    def project(pts, m2c, cam_intr, W, H):
        """pts (B, P, 3) master frame -> grid (B, V, P, 2) in [-1, 1]."""
        cam = (m2c[:, :, None, :3, :3] @ pts[:, None, :, :, None])[..., 0] + m2c[:, :, None, :3, 3]
        proj = (cam_intr[:, :, None] @ cam[..., None])[..., 0]
        z = proj[..., 2:3]
        z = torch.where(z.abs() < 1e-7, torch.full_like(z, 1e-7), z)
        return (proj[..., :2] / z) / torch.tensor([W, H], device=pts.device) * 2.0 - 1.0

    def merge(self, feats, view_mask, n="head.merge_feature."):
        """feats (B, V, N, C) -> (B, N, C), the master-query merge over valid views
        (``n``: the merge's parameters)."""
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

    # -- PtEmbedTRv2 -----------------------------------------------------------------
    @staticmethod
    def knn(query, cloud, k, rows: int = 1024):
        """Exact K nearest cloud points of each query, ascending, ties to the lower
        index, in blocks of query rows."""
        return torch.cat([Reference.knn(query[:, s:s + rows], cloud, k)
                          for s in range(0, query.shape[1], rows)], dim=1)

    def vector_block(self, n, q_in, query_xyz, cloud_xyz, x_cloud, k):
        return self.attend(n, self.lin(q_in, n + ".w_qs"), query_xyz, cloud_xyz, x_cloud, k, False)

    def refine(self, pt_xyz, pt_feats, query_xyz, query_feats):
        n = PREFIX + "point_transformer."
        s = n + "feats_self_attn"
        x = self.lin(pt_feats, s + ".fc1")
        res = self.vector_block(s, x, pt_xyz, pt_xyz, x, self.k_cross)
        pt_feats = self.lin(res, s + ".fc2") + pt_feats
        coords = []
        for i in range(self.n_blocks):
            s = f"{n}query_self_attn_{i}"
            x = self.lin(query_feats, s + ".fc1")
            res = self.vector_block(s, x, query_xyz, query_xyz, x, self.k_self)
            query_feats = self.lin(res, s + ".fc2") + query_feats
            c = f"{n}query_cross_attn_{i}"
            res = self.vector_block(c, query_feats, query_xyz, pt_xyz,
                                    self.lin(pt_feats, c + ".fc1"), self.k_cross)
            query_feats = self.lin(res, c + ".fc2") + query_feats
            query_xyz = query_xyz + self.mlp(query_feats, f"{n}reg_branch_{i}")
            coords.append(query_xyz)
        return coords

    # -- the whole model ---------------------------------------------------------------
    def forward(self, images, view_mask, cam_intr, cam_extr, ref_joints=None):
        """As ``Reference.forward``: images (B, V, H, W, 3) float in [-0.5, 0.5],
        view_mask (B, V) bool, cameras (B, V, 3, 3) and (B, V, 4, 4) camera->master,
        ``ref_joints`` in place of the DLT where given. Returns joints_uv (B, V, 21, 2)
        pixels, coords (1 + blocks, B, 799, 3) metres: the coarse mesh, then each
        refinement."""
        B, V, H, W, _ = images.shape
        feats = self.hrnet(images.reshape(B * V, H, W, 3).permute(0, 3, 1, 2))
        mlvl, hmap = self.necks(feats)
        uv = self.integral_uv(hmap).reshape(B, V, -1, 2)
        uv = uv * torch.tensor([W, H], device=images.device)
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
        NS = bps.shape[0]
        sample = lambda pts: F.grid_sample(
            x, self.project(pts, m2c, cam_intr, W, H).reshape(B * V, pts.shape[1], 1, 2),
            mode="bilinear", padding_mode="zeros", align_corners=False
        )[..., 0].reshape(B, V, self.D, pts.shape[1])                        # (B, V, C, P)
        samp = sample(bps[None] + centre[:, None])
        merged = self.merge(self.scramble(samp, view_mask.long().sum(1)).transpose(1, 2), view_mask)
        query_feats = self.P["head.query_feat_embedding"][None].expand(B, -1, -1)
        pt_xyz = (bps / self.radius)[None].expand(B, NS, 3)
        query_xyz = (self.c["template"] / self.radius)[None].expand(B, -1, 3)
        nq = query_xyz.shape[1]

        tokens = torch.cat([torch.cat([query_xyz, query_feats], -1),
                            torch.cat([pt_xyz, merged], -1)], dim=1)
        for i in range(self.n_metro):
            tokens = self.metro_block(tokens, i)
        coarse = tokens[:, :nq]

        feats2 = sample(coarse * self.radius + centre[:, None]).transpose(2, 3)  # (B, V, nq, C)
        query_feats2 = self.merge(feats2, view_mask, PREFIX + "merge_branch.")
        coords = [coarse] + self.refine(pt_xyz, merged, coarse, query_feats2)
        coords = torch.nan_to_num(torch.stack(coords)) * self.radius + centre[None, :, None]
        return {"joints_uv": uv, "coords": coords, "ref_joints": ref}
