"""Differentiable soft silhouette rasterizer (counterpart of
``poem_v2_tpu/fit/soft_raster.py``).

    alpha(p) = 1 - prod_f (1 - sigmoid(d_signed(p, f) / sigma))

``d_signed`` is the squared 2D distance from pixel ``p`` to triangle ``f``,
positive inside (pytorch3d's SoftSilhouetteShader convention). The product is
accumulated in log space over chunks of 128 faces, chunk after chunk as the
JAX scan sums them, which also bounds the (pixels x faces) temporaries. Plain
PyTorch on every device, with its autograd gradients through the distances and
the projection; any leading batch dims.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..geometry.camera import cam_extr_transf, cam_intr_projection, invert_rigid


def _point_segment_sq_dist(p, a, b):
    """Squared distance from pixels p (P, 2) to segments a -> b (..., C, 2): (..., P, C)."""
    ab = (b - a)[..., None, :, :]  # (..., 1, C, 2)
    ap = p[:, None] - a[..., None, :, :]  # (..., P, C, 2)
    denom = (ab * ab).sum(-1).clamp_min(1e-12)
    t = ((ap * ab).sum(-1) / denom).clamp(0.0, 1.0)
    d = p[:, None] - (a[..., None, :, :] + t[..., None] * ab)
    return (d * d).sum(-1)


def _signed_sq_dist(pixels, tris):
    """Signed squared distance, pixels (P, 2) to triangles (..., C, 3, 2) -> (..., P, C):
    positive inside, negative outside."""
    a, b, c = tris[..., 0, :], tris[..., 1, :], tris[..., 2, :]
    d2 = torch.minimum(_point_segment_sq_dist(pixels, a, b),
                       torch.minimum(_point_segment_sq_dist(pixels, b, c),
                                     _point_segment_sq_dist(pixels, c, a)))

    def edge_sign(e0, e1):
        ev = (e1 - e0)[..., None, :, :]
        pv = pixels[:, None] - e0[..., None, :, :]
        return ev[..., 0] * pv[..., 1] - ev[..., 1] * pv[..., 0]

    s0, s1, s2 = edge_sign(a, b), edge_sign(b, c), edge_sign(c, a)
    inside = ((s0 >= 0) & (s1 >= 0) & (s2 >= 0)) | ((s0 <= 0) & (s1 <= 0) & (s2 <= 0))
    return torch.where(inside, d2, -d2)


def soft_silhouette(verts_px: torch.Tensor, faces: torch.Tensor, size: int = 128,
                    sigma: float = 1.0, chunk: int = 128) -> torch.Tensor:
    """Soft silhouettes in [0, 1]: vertices in raster pixels (..., N, 2), faces (F, 3)
    -> (..., size, size)."""
    faces = torch.as_tensor(faces, device=verts_px.device).long()
    F_ = faces.shape[0]
    pad = (-F_) % chunk
    faces_p = torch.cat([faces, faces.new_zeros((pad, 3))])
    valid = torch.cat([torch.ones(F_, device=faces.device), torch.zeros(pad, device=faces.device)])
    ys, xs = torch.meshgrid(torch.arange(size, device=verts_px.device),
                            torch.arange(size, device=verts_px.device), indexing="ij")
    pixels = torch.stack([xs, ys], -1).reshape(-1, 2).to(verts_px.dtype) + 0.5
    tris_all = verts_px[..., faces_p, :]  # (..., F + pad, 3, 2)
    acc = verts_px.new_zeros(verts_px.shape[:-2] + (size * size,))
    for i in range(faces_p.shape[0] // chunk):
        tris = tris_all[..., i * chunk:(i + 1) * chunk, :, :]
        d = _signed_sq_dist(pixels, tris)
        # log(1 - sigmoid(d / sigma)) = log_sigmoid(-d / sigma)
        contrib = F.logsigmoid(-d / sigma) * valid[i * chunk:(i + 1) * chunk].to(d.dtype)
        acc = acc + contrib.sum(-1)
    return (1.0 - torch.exp(acc)).reshape(acc.shape[:-1] + (size, size))


def project_to_raster(verts: torch.Tensor, cam_intr: torch.Tensor, cam_extr: torch.Tensor,
                      img_size: int, silh_size: int) -> torch.Tensor:
    """verts (B, N, 3) in the master frame, cameras (B, V, 3, 3) / (B, V, 4, 4)
    camera -> master -> (B, V, N, 2) pixels of a ``silh_size`` raster."""
    v_cam = cam_extr_transf(invert_rigid(cam_extr), verts[:, None])
    return cam_intr_projection(cam_intr, v_cam) * (silh_size / img_size)


def multiview_silhouette_loss(cam_intr: torch.Tensor, cam_extr: torch.Tensor,
                              verts: torch.Tensor, masks: torch.Tensor, faces: torch.Tensor,
                              view_mask: Optional[torch.Tensor] = None, img_size: int = 256,
                              sigma: float = 1.0) -> torch.Tensor:
    """L1 between rendered and target silhouettes masks (B, V, S, S), averaged over
    the valid views of ``view_mask`` (B, V)."""
    S = masks.shape[-1]
    render = soft_silhouette(project_to_raster(verts, cam_intr, cam_extr, img_size, S), faces,
                             size=S, sigma=sigma)
    diff = (render - masks).abs().mean((-1, -2))
    if view_mask is None:
        return diff.mean()
    m = view_mask.to(diff.dtype)
    return (diff * m).sum() / m.sum().clamp_min(1.0)
