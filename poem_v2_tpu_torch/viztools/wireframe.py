"""Wireframe and multi-view tiling vocabulary (counterpart of
``poem_v2_tpu/viztools/wireframe.py``).

The reference's ``lib/utils/vis_cv2_util.py`` drawing kit: a generic
marker-typed wireframe, the OpenPose hand wireframe (dense 20-edge and
keypoint 10-edge variants) with per-finger colour ramps and per-phalanx
marker shapes, multi-view grid tiling with caption banners and the grid <->
tile coordinate helpers, the body / hand markerset wireframes, the 3D-bbox
edge list and mask blending. Lines, discs and markers come from the port's
raster core (OpenCV's pixels); the caption's text uses the core's own stroke
font (see :func:`caption_combined_view`). All functions take RGB uint8 images
and colours in [0, 1], scaled to 255 at draw time.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import raster


# ------------------------------------------------------------------ tiling

def combine_view(view_list: Sequence[np.ndarray], ncol: Optional[int] = None) -> np.ndarray:
    """Tile equally-sized views into a grid, row-major
    (vis_cv2_util.py:26-40; ncol defaults to floor(sqrt(n)))."""
    if ncol is None:
        ncol = max(int(math.sqrt(len(view_list))), 1)
    rows = [
        np.concatenate(list(view_list[off:off + ncol]), axis=1)
        for off in range(0, len(view_list), ncol)
    ]
    width = rows[0].shape[1]
    rows = [
        r if r.shape[1] == width else np.concatenate(
            [r, np.zeros((r.shape[0], width - r.shape[1]) + r.shape[2:], r.dtype)], axis=1)
        for r in rows
    ]
    return np.concatenate(rows, axis=0)


CAPTION_HEIGHT = 30  # px banner the reference prepends (vis_cv2_util.py:14-23)


def caption_combined_view(combine_image: np.ndarray, caption: str = "") -> np.ndarray:
    """Prepend a white 30 px caption banner (vis_cv2_util.py:14-23). The banner's
    geometry is the JAX package's; its text is drawn in the port's stroke font
    (:func:`put_text`, black, anti-aliased, baseline at (20, 21)), which OpenCV's
    Hershey font tables cannot be carried across to, so the letters are not held
    to OpenCV's pixels."""
    canvas = np.full((CAPTION_HEIGHT, combine_image.shape[1], 3), 255, np.uint8)
    put_text(canvas, caption, (20, 21), height=12, color=(0, 0, 0))
    return np.concatenate([canvas, combine_image], axis=0)


# a 5 x 7 stroke font: each glyph a list of polylines on a grid whose y grows
# downwards, (0, 0) its top left and the baseline at y = 6
_GLYPHS = {
    "A": [[(0, 6), (0, 2), (2, 0), (4, 2), (4, 6)], [(0, 4), (4, 4)]],
    "B": [[(0, 6), (0, 0), (3, 0), (4, 1), (4, 2), (3, 3), (0, 3)],
          [(3, 3), (4, 4), (4, 5), (3, 6), (0, 6)]],
    "C": [[(4, 1), (3, 0), (1, 0), (0, 1), (0, 5), (1, 6), (3, 6), (4, 5)]],
    "D": [[(0, 0), (3, 0), (4, 1), (4, 5), (3, 6), (0, 6), (0, 0)]],
    "E": [[(4, 0), (0, 0), (0, 6), (4, 6)], [(0, 3), (3, 3)]],
    "F": [[(4, 0), (0, 0), (0, 6)], [(0, 3), (3, 3)]],
    "G": [[(4, 1), (3, 0), (1, 0), (0, 1), (0, 5), (1, 6), (3, 6), (4, 5), (4, 3), (2, 3)]],
    "H": [[(0, 0), (0, 6)], [(4, 0), (4, 6)], [(0, 3), (4, 3)]],
    "I": [[(1, 0), (3, 0)], [(2, 0), (2, 6)], [(1, 6), (3, 6)]],
    "J": [[(4, 0), (4, 5), (3, 6), (1, 6), (0, 5)]],
    "K": [[(0, 0), (0, 6)], [(4, 0), (0, 4)], [(1, 3), (4, 6)]],
    "L": [[(0, 0), (0, 6), (4, 6)]],
    "M": [[(0, 6), (0, 0), (2, 3), (4, 0), (4, 6)]],
    "N": [[(0, 6), (0, 0), (4, 6), (4, 0)]],
    "O": [[(1, 0), (3, 0), (4, 1), (4, 5), (3, 6), (1, 6), (0, 5), (0, 1), (1, 0)]],
    "P": [[(0, 6), (0, 0), (3, 0), (4, 1), (4, 2), (3, 3), (0, 3)]],
    "Q": [[(1, 0), (3, 0), (4, 1), (4, 5), (3, 6), (1, 6), (0, 5), (0, 1), (1, 0)],
          [(2, 4), (4, 6)]],
    "R": [[(0, 6), (0, 0), (3, 0), (4, 1), (4, 2), (3, 3), (0, 3)], [(2, 3), (4, 6)]],
    "S": [[(4, 1), (3, 0), (1, 0), (0, 1), (0, 2), (1, 3), (3, 3), (4, 4), (4, 5), (3, 6),
           (1, 6), (0, 5)]],
    "T": [[(0, 0), (4, 0)], [(2, 0), (2, 6)]],
    "U": [[(0, 0), (0, 5), (1, 6), (3, 6), (4, 5), (4, 0)]],
    "V": [[(0, 0), (2, 6), (4, 0)]],
    "W": [[(0, 0), (1, 6), (2, 3), (3, 6), (4, 0)]],
    "X": [[(0, 0), (4, 6)], [(4, 0), (0, 6)]],
    "Y": [[(0, 0), (2, 3), (4, 0)], [(2, 3), (2, 6)]],
    "Z": [[(0, 0), (4, 0), (0, 6), (4, 6)]],
    "0": [[(1, 0), (3, 0), (4, 1), (4, 5), (3, 6), (1, 6), (0, 5), (0, 1), (1, 0)],
          [(0, 5), (4, 1)]],
    "1": [[(1, 1), (2, 0), (2, 6)], [(1, 6), (3, 6)]],
    "2": [[(0, 1), (1, 0), (3, 0), (4, 1), (4, 2), (0, 6), (4, 6)]],
    "3": [[(0, 1), (1, 0), (3, 0), (4, 1), (4, 2), (3, 3), (4, 4), (4, 5), (3, 6), (1, 6),
           (0, 5)], [(1, 3), (3, 3)]],
    "4": [[(3, 6), (3, 0), (0, 4), (4, 4)]],
    "5": [[(4, 0), (0, 0), (0, 3), (3, 3), (4, 4), (4, 5), (3, 6), (0, 6)]],
    "6": [[(3, 0), (1, 0), (0, 1), (0, 5), (1, 6), (3, 6), (4, 5), (4, 4), (3, 3), (0, 3)]],
    "7": [[(0, 0), (4, 0), (1, 6)]],
    "8": [[(1, 0), (3, 0), (4, 1), (4, 2), (3, 3), (1, 3), (0, 4), (0, 5), (1, 6), (3, 6),
           (4, 5), (4, 4), (3, 3)], [(1, 3), (0, 2), (0, 1), (1, 0)]],
    "9": [[(4, 3), (1, 3), (0, 2), (0, 1), (1, 0), (3, 0), (4, 1), (4, 5), (3, 6), (1, 6)]],
    ".": [[(2, 6), (2, 6)]],
    ",": [[(2, 5), (1, 7)]],
    ":": [[(2, 2), (2, 2)], [(2, 5), (2, 5)]],
    "-": [[(1, 3), (3, 3)]],
    "+": [[(0, 3), (4, 3)], [(2, 1), (2, 5)]],
    "_": [[(0, 7), (4, 7)]],
    "/": [[(0, 6), (4, 0)]],
    "=": [[(0, 2), (4, 2)], [(0, 4), (4, 4)]],
    "(": [[(3, 0), (2, 1), (2, 5), (3, 6)]],
    ")": [[(1, 0), (2, 1), (2, 5), (1, 6)]],
    "%": [[(0, 6), (4, 0)], [(0, 0), (1, 0), (1, 1), (0, 1), (0, 0)],
          [(3, 5), (4, 5), (4, 6), (3, 6), (3, 5)]],
}


def put_text(img: np.ndarray, text: str, origin, height: int = 12, color=(0, 0, 0)) -> None:
    """``text`` in the stroke font, in place: ``origin`` is the first glyph's
    bottom-left on the baseline, ``height`` the capital height in pixels.
    Lower-case letters are drawn as capitals; characters without a glyph leave
    a blank."""
    s = height / 6.0
    x0, base = float(origin[0]), float(origin[1])
    for ch in text.upper():
        for stroke in _GLYPHS.get(ch, []):
            pts = [(int(round(x0 + gx * s)), int(round(base + (gy - 6) * s))) for gx, gy in stroke]
            for p, q in zip(pts[:1] + pts[:-1], pts):
                raster.line(img, p, q, color, aa=True)
        x0 += 6 * s


def decaption_pos(position: Tuple[int, int]) -> Tuple[int, int]:
    """Undo the caption banner offset for click positions (vis_cv2_util.py:394-397)."""
    return (position[0], position[1] - CAPTION_HEIGHT)


def get_combined_image_offset(position, img_shape, len_img_list, ncol=None) -> int:
    """Which tile a grid-space click lands in (vis_cv2_util.py:350-362)."""
    if ncol is None:
        ncol = int(math.sqrt(len_img_list))
    col = int(position[0]) // int(img_shape[1])
    row = int(position[1]) // int(img_shape[0])
    return int(ncol * row + col)

def get_combined_image_pos(position, img_shape) -> Tuple[int, int]:
    """Grid-space click -> within-tile coordinates (vis_cv2_util.py:365-372)."""
    return (position[0] % int(img_shape[1]), position[1] % int(img_shape[0]))


def get_combined_image_pos_fix_offset(position, img_shape, offset, len_img_list,
                                      ncol=None) -> Tuple[int, int]:
    """Grid-space click -> coordinates within a KNOWN tile (vis_cv2_util.py:375-391)."""
    if ncol is None:
        ncol = int(math.sqrt(len_img_list))
    base_x = (offset % ncol) * int(img_shape[1])
    base_y = (offset // ncol) * int(img_shape[0])
    return (position[0] - base_x, position[1] - base_y)


def offset_combined_image_pos(position_local, img_shape, offset, len_img_list,
                              ncol=None) -> Tuple[int, int]:
    """Within-tile coordinates -> grid space (vis_cv2_util.py:400-415)."""
    if ncol is None:
        ncol = int(math.sqrt(len_img_list))
    base_x = (offset % ncol) * int(img_shape[1])
    base_y = (offset // ncol) * int(img_shape[0])
    return (position_local[0] + base_x, position_local[1] + base_y)


# -------------------------------------------------------------- wireframes

def _out_of_frame(pos, shape) -> bool:
    h, w = shape
    return pos[0] < 0 or pos[0] >= w or pos[1] < 0 or pos[1] >= h


def draw_wireframe(
    img: np.ndarray,
    vert_list: np.ndarray,
    edge_list: Sequence[Tuple[int, int]],
    vert_color: np.ndarray,
    edge_color: np.ndarray,
    vert_size=3,
    edge_size=1,
    vert_type: Optional[List[str]] = None,
    vert_thickness=1,
    vert_mask: Optional[np.ndarray] = None,
) -> None:
    """Edges then typed vertex markers, in place (vis_cv2_util.py:51-177).

    Matches the reference semantics: per-vert/edge colour and size
    broadcast from scalars; an edge is skipped when either endpoint is
    masked out or BOTH endpoints fall outside the frame; a vertex is
    skipped when masked or out of frame; marker shapes circle/square/
    triangle_up/diamond/star.
    """
    h, w = img.shape[:2]
    vert_list = np.asarray(vert_list, np.float64)
    n_vert, n_edge = len(vert_list), len(edge_list)
    vert_color = np.asarray(vert_color, np.float64)
    edge_color = np.asarray(edge_color, np.float64)
    if edge_color.ndim == 1:
        edge_color = np.tile(edge_color, (n_edge, 1))
    if vert_color.ndim == 1:
        vert_color = np.tile(vert_color, (n_vert, 1))
    if isinstance(edge_size, (int, float)):
        edge_size = [int(edge_size)] * n_edge
    if isinstance(vert_size, (int, float)):
        vert_size = [int(vert_size)] * n_vert
    if isinstance(vert_thickness, (int, float)):
        vert_thickness = [int(vert_thickness)] * n_vert
    if vert_type is None:
        vert_type = ["circle"] * n_vert

    for eid, (a, b) in enumerate(edge_list):
        a, b = int(a), int(b)
        if vert_mask is not None and not (vert_mask[a] and vert_mask[b]):
            continue
        p1, p2 = vert_list[b], vert_list[a]
        if _out_of_frame(p1, (h, w)) and _out_of_frame(p2, (h, w)):
            continue
        raster.line(img, p1.astype(np.int32), p2.astype(np.int32), edge_color[eid] * 255,
                    thickness=edge_size[eid])

    for vid in range(n_vert):
        if vert_mask is not None and not vert_mask[vid]:
            continue
        if _out_of_frame(vert_list[vid], (h, w)):
            continue
        pt = (int(vert_list[vid, 0]), int(vert_list[vid, 1]))
        color = vert_color[vid] * 255
        if vert_type[vid] in raster.MARKERS:
            raster.draw_marker(img, pt, color, vert_type[vid], size=vert_size[vid] * 2,
                               thickness=vert_thickness[vid])
        else:  # "circle" and unknown types fall back to a disc
            raster.circle(img, pt, vert_size[vid], color)


# OpenPose hand: wrist + 4 joints per finger (vis_cv2_util.py:180-279). Marker shape
# encodes the phalanx (mcp circle, pip square, dip triangle, tip diamond),
# colour ramps per finger; tables verbatim from the reference vocabulary.
EDGE_LIST_HAND = [
    (0, 1), (1, 2), (2, 3), (3, 4),
    (0, 5), (5, 6), (6, 7), (7, 8),
    (0, 9), (9, 10), (10, 11), (11, 12),
    (0, 13), (13, 14), (14, 15), (15, 16),
    (0, 17), (17, 18), (18, 19), (19, 20),
]
VERT_COLOR_HAND = np.array(
    [[1.0, 0.0, 0.0]]
    + [[0.0, g, g / 2] for g in (0.4, 0.6, 0.8, 1.0)]
    + [[0.0, 0.0, b] for b in (0.4, 0.6, 0.8, 1.0)]
    + [[0.0, c, c] for c in (0.4, 0.6, 0.8, 1.0)]
    + [[y, y, 0.0] for y in (0.4, 0.6, 0.8, 1.0)]
    + [[0.4, 0.0, 0.4], [0.6, 0.0, 0.6], [0.7, 0.0, 0.8], [1.0, 0.0, 1.0]]
)[:, ::-1]
EDGE_COLOR_HAND = VERT_COLOR_HAND[1:21]
VERT_TYPE_HAND = ["star"] + ["circle", "square", "triangle_up", "diamond"] * 5

# sparse keypoint skeleton: wrist to one mid + tip joint per finger
# (vis_cv2_util.py:309-320)
EDGE_LIST_HAND_KP = [
    (0, 2), (2, 4), (0, 5), (5, 8), (0, 9), (9, 12),
    (0, 13), (13, 16), (0, 17), (17, 20),
]


def draw_wireframe_hand(img, hand_joint_arr, hand_joint_mask=None):
    draw_wireframe(img, hand_joint_arr, EDGE_LIST_HAND, VERT_COLOR_HAND,
                   EDGE_COLOR_HAND, vert_type=VERT_TYPE_HAND,
                   vert_mask=hand_joint_mask)


def draw_wireframe_hand_large(img, hand_joint_arr, hand_joint_mask=None):
    draw_wireframe(img, hand_joint_arr, EDGE_LIST_HAND, VERT_COLOR_HAND,
                   EDGE_COLOR_HAND, vert_type=VERT_TYPE_HAND,
                   vert_mask=hand_joint_mask, vert_size=8, edge_size=2,
                   vert_thickness=3)


def draw_wireframe_hand_kp(img, hand_joint_arr, hand_joint_mask=None):
    draw_wireframe(img, hand_joint_arr, EDGE_LIST_HAND_KP, VERT_COLOR_HAND,
                   EDGE_COLOR_HAND, vert_type=VERT_TYPE_HAND,
                   vert_mask=hand_joint_mask)


def draw_wireframe_hand_kp_large(img, hand_joint_arr, hand_joint_mask=None):
    draw_wireframe(img, hand_joint_arr, EDGE_LIST_HAND_KP, VERT_COLOR_HAND,
                   EDGE_COLOR_HAND, vert_type=VERT_TYPE_HAND,
                   vert_mask=hand_joint_mask, vert_size=6, edge_size=2,
                   vert_thickness=3)


# mocap markerset skeletons (vis_cv2_util.py:418-549)
EDGE_LIST_MARKERSET_BODY = [
    (0, 1), (0, 2), (0, 3), (1, 2), (3, 4), (3, 5), (4, 7), (5, 11),
    (6, 8), (6, 12), (7, 8), (7, 9), (8, 9), (9, 10), (11, 12), (11, 13),
    (12, 13), (13, 14), (15, 16), (15, 17), (16, 17), (16, 18), (17, 18),
]
_MAGENTA = [234 / 255, 128 / 255, 1.0]
_CYAN = [0.0, 235 / 255, 1.0]
_PURPLE = [202 / 255, 0.0, 1.0]
_RED = [1.0, 0.0, 0.0]
_OLIVE = [59 / 255, 102 / 255, 0.0]
VERT_COLOR_MARKERSET_BODY = np.array(
    [_MAGENTA, _MAGENTA, _CYAN, _MAGENTA, _PURPLE, _CYAN, _MAGENTA, _RED,
     _CYAN, _RED, _CYAN, _PURPLE, _OLIVE, _PURPLE, _OLIVE, _PURPLE,
     _PURPLE, _CYAN, _CYAN]
)[:, ::-1]
_EPURPLE = [222 / 255, 0.0, 1.0]
_EGREEN = [127 / 255, 1.0, 0.0]
EDGE_COLOR_MARKERSET_BODY = np.array(
    [_EPURPLE] * 7 + [_EGREEN, _CYAN, _CYAN, _EGREEN] + [_EPURPLE] * 4
    + [_CYAN] * 4 + [_EGREEN] * 4
)[:, ::-1]

EDGE_LIST_MARKERSET_HAND = [
    (0, 1), (0, 2), (1, 3), (1, 4), (2, 3), (2, 8), (2, 9), (3, 6),
    (3, 7), (4, 5),
]
_HCYAN = [75 / 255, 225 / 255, 1.0]
VERT_COLOR_MARKERSET_HAND = np.array(
    [_EPURPLE, _HCYAN, _EPURPLE, _HCYAN, _RED, _RED, _EGREEN, _CYAN,
     _EGREEN, _CYAN]
)[:, ::-1]
EDGE_COLOR_MARKERSET_HAND = np.array(
    [_EPURPLE] * 4 + [_CYAN, _EGREEN, _CYAN, _EGREEN, _CYAN, _CYAN]
)[:, ::-1]


def draw_wireframe_markerset_body(img, marker_arr, marker_mask=None):
    draw_wireframe(img, marker_arr, EDGE_LIST_MARKERSET_BODY,
                   VERT_COLOR_MARKERSET_BODY, EDGE_COLOR_MARKERSET_BODY,
                   vert_mask=marker_mask)


def draw_wireframe_markerset_hand(img, marker_arr, marker_mask=None):
    draw_wireframe(img, marker_arr, EDGE_LIST_MARKERSET_HAND,
                   VERT_COLOR_MARKERSET_HAND, EDGE_COLOR_MARKERSET_HAND,
                   vert_mask=marker_mask)


# 3D bounding-box wireframe edges: bottom face, top face, pillars
# (vis_cv2_util.py:552-567)
EDGE_LIST_BBOX = [
    (0, 1), (1, 3), (3, 2), (2, 0),
    (4, 5), (5, 7), (7, 6), (6, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def blend_mask(image: np.ndarray, mask: np.ndarray, random_color: bool = False,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Alpha-blend a binary mask over an image (vis_cv2_util.py:570-582; default the
    reference's orange at alpha 0.6)."""
    if random_color:
        rng = rng or np.random.default_rng()
        rgba = np.concatenate([rng.random(3), [0.6]])
    else:
        rgba = np.array([1.0, 144 / 255, 30 / 255, 0.6])
    h, w = mask.shape[-2:]
    overlay = mask.reshape(h, w, 1).astype(np.float32) * rgba.reshape(1, 1, -1)
    out = image.astype(np.float32) / 255
    out = out * (1 - overlay[:, :, 3:]) + overlay[:, :, :3] * overlay[:, :, 3:]
    return (out * 255).astype(np.uint8)
