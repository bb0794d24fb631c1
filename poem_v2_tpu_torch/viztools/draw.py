"""2D visualisation of joints and vertices over images (counterpart of
``poem_v2_tpu/viztools/draw.py``).

Skeleton wireframes, vertex scatters, prediction-vs-ground-truth panels and
multi-view tiling, drawn on the host with the port's raster core
(:mod:`.raster`, pixel for pixel what OpenCV draws). Visualisation never
touches the device.
"""

from __future__ import annotations

import math

import numpy as np

from . import raster

# OpenPose hand skeleton links
HAND_LINKS = [
    (0, 1), (1, 2), (2, 3), (3, 4),
    (0, 5), (5, 6), (6, 7), (7, 8),
    (0, 9), (9, 10), (10, 11), (11, 12),
    (0, 13), (13, 14), (14, 15), (15, 16),
    (0, 17), (17, 18), (18, 19), (19, 20),
]

_FINGER_COLORS = [
    (255, 80, 80),
    (255, 160, 60),
    (80, 220, 80),
    (80, 150, 255),
    (200, 90, 230),
]


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """float (H, W, 3) in [-0.5, 0.5] -> uint8 RGB."""
    return np.clip((img + 0.5) * 255.0, 0, 255).astype(np.uint8)


def _px(p) -> tuple:
    return tuple(int(v) for v in np.round(p).astype(int))


def draw_joints_2d(image: np.ndarray, joints_2d: np.ndarray, color_override=None,
                   radius: int = 2) -> np.ndarray:
    """A hand skeleton over a copy of ``image``: anti-aliased bones coloured by
    finger, white joint discs; image uint8 (H, W, 3), joints (21, 2) pixels."""
    out = image.copy()
    for li, (a, b) in enumerate(HAND_LINKS):
        color = color_override or _FINGER_COLORS[li // 4]
        raster.line(out, _px(joints_2d[a]), _px(joints_2d[b]), color, aa=True)
    for j in range(joints_2d.shape[0]):
        raster.circle(out, _px(joints_2d[j]), radius, (255, 255, 255), aa=True)
    return out


def draw_verts_2d(image: np.ndarray, verts_2d: np.ndarray, color=(120, 220, 120)) -> np.ndarray:
    """Every second vertex as one pixel, over a copy of ``image``."""
    out = image.copy()
    for v in range(0, verts_2d.shape[0], 2):
        p = _px(verts_2d[v])
        if 0 <= p[0] < out.shape[1] and 0 <= p[1] < out.shape[0]:
            out[p[1], p[0]] = color
    return out


def draw_batch_joint_images(pred_2d: np.ndarray, gt_2d: np.ndarray, images: np.ndarray,
                            step: int = 0) -> np.ndarray:
    """Side-by-side pred | GT skeleton panels, (B, H, 2W, 3) uint8
    (reference viztools/draw.py:84)."""
    panels = []
    for b in range(images.shape[0]):
        img = denormalize_image(np.asarray(images[b]))
        left = draw_joints_2d(img, np.asarray(pred_2d[b]))
        right = draw_joints_2d(img, np.asarray(gt_2d[b]), color_override=(60, 60, 255))
        panels.append(np.concatenate([left, right], axis=1))
    return np.stack(panels)


def draw_batch_verts_images(pred_v2d: np.ndarray, gt_v2d: np.ndarray, images: np.ndarray,
                            step: int = 0) -> np.ndarray:
    """Side-by-side pred | GT vertex scatters (reference viztools/draw.py:49)."""
    panels = []
    for b in range(images.shape[0]):
        img = denormalize_image(np.asarray(images[b]))
        left = draw_verts_2d(img, np.asarray(pred_v2d[b]))
        right = draw_verts_2d(img, np.asarray(gt_v2d[b]), color=(60, 60, 255))
        panels.append(np.concatenate([left, right], axis=1))
    return np.stack(panels)


def draw_3d_skeleton(image_size, joints_xyz: np.ndarray, elev: float = 20.0,
                     azim: float = -70.0) -> np.ndarray:
    """A 3D hand skeleton on a white (H, W, 3) uint8 panel.

    The JAX package plots it with matplotlib (a 3D axes over (x, z, -y), equal
    box aspect, ``view_init(elev=20, azim=-70)``). The port projects the same
    axes orthographically at the same elevation and azimuth, scaled to fill the
    panel, and draws with the raster core: bones coloured by finger, joints as
    black discs. It is not held to matplotlib's pixels (no axes, ticks or
    perspective)."""
    h, w = image_size
    panel = np.full((h, w, 3), 255, np.uint8)
    j = np.asarray(joints_xyz, dtype=np.float64)
    p = np.stack([j[:, 0], j[:, 2], -j[:, 1]], axis=1)
    lo, hi = p.min(0), p.max(0)
    p = (p - (lo + hi) / 2) / max(float((hi - lo).max()), 1e-9)  # the unit box
    az, el = math.radians(azim), math.radians(elev)
    # screen right and up for a camera at (azim, elev) looking at the origin
    right = np.array([-math.sin(az), math.cos(az), 0.0])
    up = np.array([-math.sin(el) * math.cos(az), -math.sin(el) * math.sin(az), math.cos(el)])
    scale = 0.8 * min(h, w) / math.sqrt(3.0)
    uv = np.stack([w / 2 + scale * (p @ right), h / 2 - scale * (p @ up)], axis=1)
    for li, (a, b) in enumerate(HAND_LINKS):
        raster.line(panel, _px(uv[a]), _px(uv[b]), _FINGER_COLORS[li // 4], thickness=2,
                    aa=True)
    for q in uv:
        raster.circle(panel, _px(q), max(1, min(h, w) // 100), (0, 0, 0), aa=True)
    return panel


def save_a_image_with_mesh_joints(
    image: np.ndarray,      # (H, W, 3) uint8 RGB
    cam_param: np.ndarray,  # (3, 3) intrinsics
    mesh_xyz: np.ndarray,   # (778, 3) camera-space vertices
    face: np.ndarray,       # (F, 3)
    pose_uv: np.ndarray,    # (21, 2) pixel joints
    pose_xyz: np.ndarray,   # (21, 3) camera-space joints
    file_name: str = None,
    padding: int = 0,
    ret: bool = False,
    with_skeleton_3d: bool = False,
    renderer=None,
) -> np.ndarray:
    """Per-sample composite [raw | 2D skeleton | shaded mesh overlay] (+ the 3D
    skeleton panel), one row (reference ``save_a_image_with_mesh_joints``,
    lib/viztools/draw.py:501). With ``file_name`` it is written as a PNG, whatever
    the name's extension (the JAX package writes the name's format through OpenCV)."""
    if renderer is None:
        from .renderer import render_mesh_overlay as renderer
    rend = renderer(image, mesh_xyz, face, cam_param)
    skeleton = draw_joints_2d(image, pose_uv)
    img_list = [image, skeleton, rend]
    if with_skeleton_3d:
        img_list.append(draw_3d_skeleton(image.shape[:2], pose_xyz))

    h, w = image.shape[:2]
    grid = np.zeros((h + padding, len(img_list) * (w + padding), 3), np.uint8)
    x = 0
    for panel in img_list:
        grid[:h, x:x + w] = panel[..., :3]
        x += w + padding
    if ret or file_name is None:
        return grid
    raster.write_png(file_name, grid)
    return grid


def tile_views(images: np.ndarray, cols: int = 4) -> np.ndarray:
    """Tile (V, H, W, 3) views into a grid image."""
    v, h, w, c = images.shape
    rows = (v + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w, c), dtype=images.dtype)
    for i in range(v):
        r, cc = divmod(i, cols)
        grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = images[i]
    return grid
