"""Host-side mesh renderer for visualisation (counterpart of
``poem_v2_tpu/viztools/renderer.py``).

A painter's-algorithm rasteriser with Lambertian flat shading: faces sorted
far to near by centroid depth, back faces culled, each face an anti-aliased
convex fill of the raster core, the layer blended over the image. The
geometry stays in float64, as in the JAX package, so that culling and order
agree face for face.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from . import raster


def render_mesh_overlay(
    image: np.ndarray,  # (H, W, 3) uint8
    verts_cam: np.ndarray,  # (N, 3) camera space, z > 0
    faces: np.ndarray,  # (F, 3) int
    cam_intr: np.ndarray,  # (3, 3)
    color: Tuple[int, int, int] = (120, 190, 230),
    alpha: float = 0.65,
    light_dir: Sequence[float] = (0.2, 0.2, -1.0),
) -> np.ndarray:
    """Rasterise a mesh over ``image`` (returns a new array)."""
    H, W = image.shape[:2]
    verts = np.asarray(verts_cam, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    K = np.asarray(cam_intr, dtype=np.float64)

    z = np.clip(verts[:, 2], 1e-6, None)
    uv = (verts @ K.T)[:, :2] / z[:, None]  # (N, 2)

    tri = verts[faces]  # (F, 3, 3)
    # face normal and Lambertian shade
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n_norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.clip(n_norm, 1e-12, None)
    light = np.asarray(light_dir, dtype=np.float64)
    light = light / np.linalg.norm(light)
    shade = np.clip(-(n @ light), 0.15, 1.0)  # (F,)
    # back-face culling: keep faces whose normal points towards the camera (-z)
    centroid = tri.mean(axis=1)
    visible = np.einsum("fi,fi->f", n, centroid) < 0
    depth = centroid[:, 2]

    order = np.argsort(-depth)  # far -> near
    layer = image.copy()
    uv_faces = uv[faces].astype(np.int32)  # (F, 3, 2)
    lo, hi = uv_faces.min(axis=1), uv_faces.max(axis=1)
    on_image = (hi[:, 0] >= 0) & (lo[:, 0] < W) & (hi[:, 1] >= 0) & (lo[:, 1] < H)
    col = np.asarray(color, dtype=np.float64)
    shaded = (col[None] * shade[:, None]).astype(np.int64)  # int(): truncation, as JAX
    for f in order[(visible & on_image)[order]]:
        raster.fill_convex_poly(layer, uv_faces[f], tuple(shaded[f]))
    return raster.add_weighted(layer, alpha, image, 1.0 - alpha, 0.0)


def draw_batch_mesh_images(
    images: np.ndarray,  # (B, V, H, W, 3) uint8
    verts_3d: np.ndarray,  # (B, 778, 3) master space
    cam_intr: np.ndarray,  # (B, V, 3, 3)
    cam_extr: np.ndarray,  # (B, V, 4, 4) camera -> master
    faces: np.ndarray,
    view_mask: Optional[np.ndarray] = None,  # (B, V)
    **kwargs,
) -> np.ndarray:
    """Mesh overlays for every valid view."""
    B, V = images.shape[:2]
    out = images.copy()
    for b in range(B):
        for v in range(V):
            if view_mask is not None and not view_mask[b, v]:
                continue
            inv = np.linalg.inv(np.asarray(cam_extr[b, v], dtype=np.float64))
            v_cam = verts_3d[b] @ inv[:3, :3].T + inv[:3, 3]
            out[b, v] = render_mesh_overlay(images[b, v], v_cam, faces, cam_intr[b, v], **kwargs)
    return out
