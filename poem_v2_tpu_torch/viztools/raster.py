"""The port's raster core: numpy on the host, no OpenCV.

The drawing primitives the viztools need, written after OpenCV's own
fixed-point algorithms (``modules/imgproc/src/drawing.cpp``: 16 fractional
bits, Bresenham lines, the midpoint circle, the scanline convex fill and the
filtered anti-aliased line), so that a picture drawn here is the picture
OpenCV draws:

- ``line`` (8-connected, any thickness, or anti-aliased), ``circle``
  (filled, plain or anti-aliased), ``fill_convex_poly`` and ``draw_marker``
  change an (H, W, 3) uint8 image in place, as their OpenCV counterparts do;
- ``add_weighted`` blends two images as ``cv2.addWeighted`` rounds;
- ``resize`` is OpenCV's bilinear resize of uint8 images (11-bit weights);
- ``write_png`` writes an RGB or grey uint8 image with ``zlib`` and
  ``struct`` alone; ``rgb_to_bgr`` / ``bgr_to_rgb`` swap channel order.

Colours are tuples of the image's channel values (any order: the core never
interprets them) and are rounded half to even, as OpenCV rounds a colour.
The tests hold every primitive against OpenCV 5.0 pixel for pixel, or within
the anti-aliasing band the test states.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

# the anti-aliased line's filter and slope correction (OpenCV drawing.cpp)
_SLOPE_CORR = (181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196, 198, 201,
               203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238, 242, 246, 250, 254)
_FILTER = (168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252, 254, 254,
           254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202, 194, 185, 177, 168,
           158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75, 68, 62, 56, 50, 45,
           40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8, 7, 5, 5)
_FILTER_NP = np.asarray(_FILTER, np.int64)
_EP_INDEX_S = np.array([0, 3, 6], np.int64)  # 3 x the start's end-point class
# sin of every whole degree 0..450 as OpenCV tabulates it (7 decimals, float32)
_SIN = [float(np.float32(round(math.sin(math.radians(d)), 7))) for d in range(451)]

MARKERS = ("star", "diamond", "square", "triangle_up")  # the wireframes' vertex shapes


def _color(color) -> Tuple[int, ...]:
    """Channel values rounded half to even and saturated to uint8."""
    return tuple(int(min(255, max(0, np.rint(float(c))))) for c in color)


def _tdiv(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _check(img: np.ndarray) -> None:
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {img.dtype} {img.shape}")


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` to [0, w-1] x [0, h-1]: the clipped ends, or None (its
    intersections in doubles, truncated, as its C does)."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return None
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line8(img, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """An 8-connected Bresenham line between integer pixels (OpenCV ``Line``)."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # drawn left to right
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    # the major axis steps every pixel, the minor one where the error is negative
    err = dx - 2 * dy
    major = np.arange(dx + 1, dtype=np.int64)
    minor = np.empty(dx + 1, np.int64)
    b = 0
    for i in range(dx + 1):
        minor[i] = b
        if err < 0:
            err += 2 * dx - 2 * dy
            b += 1
        else:
            err -= 2 * dy
    if vert:
        img[y1 + major * sy, x1 + minor] = color
    else:
        img[y1 + minor * sy, x1 + major] = color


def _line2(img, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """An 8-connected line between fixed-point ends (OpenCV ``Line2``)."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    j = -1 if dx < 0 else 0
    ax = (dx ^ j) - j
    i = -1 if dy < 0 else 0
    ay = (dy ^ i) - i
    if ax > ay:
        dy = (dy ^ j) - j
        if j:
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        dx = (dx ^ i) - i
        if i:
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    pts = [((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)]
    if ax > ay:
        x1 >>= XY_SHIFT
        for k in range(ecount + 1):
            pts.append((x1 + k, (y1 + k * y_step) >> XY_SHIFT))
    else:
        y1 >>= XY_SHIFT
        for k in range(ecount + 1):
            pts.append(((x1 + k * x_step) >> XY_SHIFT, y1 + k))
    p = np.asarray(pts, np.int64)
    keep = (p[:, 0] >= 0) & (p[:, 0] < w) & (p[:, 1] >= 0) & (p[:, 1] < h)
    img[p[keep, 1], p[keep, 0]] = color


def _blend_aa(img, xs, ys, alpha, color) -> None:
    """OpenCV's anti-aliased put: each channel moves toward the colour by
    ``alpha / 256`` twice, rounding each step."""
    if xs.size == 0:
        return
    c = np.asarray(color, np.int64)[None]
    a = alpha.astype(np.int64)[:, None]
    t = img[ys, xs].astype(np.int64)
    t += ((c - t) * a + 127) >> 8
    t += ((c - t) * a + 127) >> 8
    img[ys, xs] = t.astype(np.uint8)


def _line_aa(img, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """The filtered anti-aliased line between fixed-point ends (OpenCV ``LineAA``)."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    j = -1 if dx < 0 else 0
    ax = (dx ^ j) - j
    i = -1 if dy < 0 else 0
    ay = (dy ^ i) - i
    if ax > ay:
        dy = (dy ^ j) - j
        if j:
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        x2 += XY_ONE
        ecount = (x2 >> XY_SHIFT) - (x1 >> XY_SHIFT)
        j = -(x1 & (XY_ONE - 1))
        y1 += ((y_step * j) >> XY_SHIFT) + (XY_ONE >> 1)
        slope = (y_step >> (XY_SHIFT - 5)) & 0x3f
        slope ^= 0x3f if y_step < 0 else 0
        i = (x1 >> (XY_SHIFT - 7)) & 0x78
        j = (x2 >> (XY_SHIFT - 7)) & 0x78
    else:
        dx = (dx ^ i) - i
        if i:
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        y2 += XY_ONE
        ecount = (y2 >> XY_SHIFT) - (y1 >> XY_SHIFT)
        j = -(y1 & (XY_ONE - 1))
        x1 += ((x_step * j) >> XY_SHIFT) + (XY_ONE >> 1)
        slope = (x_step >> (XY_SHIFT - 5)) & 0x3f
        slope ^= 0x3f if x_step < 0 else 0
        i = (y1 >> (XY_SHIFT - 7)) & 0x78
        j = (y2 >> (XY_SHIFT - 7)) & 0x78
    slope = 0x100 if slope & 0x20 else _SLOPE_CORR[slope]
    # end-point corrections
    t0 = slope << 7
    t1 = ((0x78 - i) | 4) * slope
    t2 = (j | 4) * slope
    ep = [0] * 9
    ep[8] = slope
    ep[1] = ep[3] = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1ff
    ep[2] = (t1 >> 8) & 0x1ff
    ep[4] = ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1ff
    ep[5] = ((t1 + t0) >> 8) & 0x1ff
    ep[6] = (t2 >> 8) & 0x1ff
    ep[7] = ((t2 + t0) >> 8) & 0x1ff
    k = np.arange(ecount + 1, dtype=np.int64)
    corr = _EP_INDEX_S[np.minimum(k, 2)] + np.minimum(ecount - k, 2)
    corr = np.asarray(ep, np.int64)[corr]
    if ax > ay:
        major, minor_fx, lim_major, lim_minor = (x1 >> XY_SHIFT) + k, y1 + k * y_step, w, h
    else:
        major, minor_fx, lim_major, lim_minor = (y1 >> XY_SHIFT) + k, x1 + k * x_step, h, w
    ok = (major >= 0) & (major < lim_major)
    major, minor_fx, corr = major[ok], minor_fx[ok], corr[ok]
    # three pixels across the line at each step (none repeats within one line),
    # weighted by the filter at the line's sub-pixel distance
    dist = (minor_fx >> (XY_SHIFT - 5)) & 31
    minor = ((minor_fx >> XY_SHIFT) - 1)[:, None] + np.arange(3)
    taps = np.stack([dist + 32, dist, 63 - dist], axis=1)
    alpha = (corr[:, None] * _FILTER_NP[taps] >> 8) & 0xff
    inside = (minor >= 0) & (minor < lim_minor)
    major = np.broadcast_to(major[:, None], minor.shape)[inside]
    minor, alpha = minor[inside], alpha[inside]
    if ax > ay:
        _blend_aa(img, major, minor, alpha, color)
    else:
        _blend_aa(img, minor, major, alpha, color)


def _hline(img, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def _fill_convex(img, v: Sequence[Tuple[int, int]], color, aa: bool, shift: int) -> None:
    """OpenCV's ``FillConvexPoly`` over ends in ``shift`` fractional bits: the
    outline (anti-aliased, or 8-connected) and the scanline fill."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = (1 << shift) >> 1
    delta1, delta2 = (XY_ONE - 1, 0) if aa else (XY_ONE >> 1, XY_ONE >> 1)
    up = XY_SHIFT - shift
    p0 = (v[-1][0] << up, v[-1][1] << up)
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << up, py << up)
        if aa:
            _line_aa(img, p0[0], p0[1], p[0], p[1], color)
        elif shift == 0:
            _line8(img, p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT, p[0] >> XY_SHIFT,
                   p[1] >> XY_SHIFT, color)
        else:
            _line2(img, p0[0], p0[1], p[0], p[1], color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # the two edges walked down from the top vertex: vertex index, direction, x,
    # x step a row and the row where the edge ends
    e_idx, e_di, e_x, e_dx, e_ye = [imin, imin], [1, npts - 1], [-XY_ONE] * 2, [0, 0], [ymin] * 2
    y, edges = ymin, npts
    while True:
        if not aa or y < ymax or y == ymin:
            for s in (0, 1):
                if y >= e_ye[s]:
                    idx0, di = e_idx[s], e_di[s]
                    idx = idx0 + di
                    if idx >= npts:
                        idx -= npts
                    while True:  # for (; edges-- > 0; )
                        go = edges > 0
                        edges -= 1
                        if not go:
                            break
                        ty = (v[idx][1] + delta) >> shift
                        if ty > y:
                            xs, xe = v[idx0][0] << up, v[idx][0] << up
                            e_ye[s] = ty
                            e_dx[s] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                            e_x[s] = xs
                            e_idx[s] = idx
                            break
                        idx0 = idx
                        idx += di
                        if idx >= npts:
                            idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if e_x[0] > e_x[1] else (0, 1)
            xx1 = (e_x[left] + delta1) >> XY_SHIFT
            xx2 = (e_x[right] + delta2) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        e_x[0] += e_dx[0]
        e_x[1] += e_dx[1]
        y += 1
        if y > ymax:
            break


def _circle_spans(cx: int, cy: int, r: int):
    """The rows of OpenCV's midpoint ``Circle``: (y, x_left, x_right) spans."""
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    spans = []
    while dx >= dy:
        spans += [(cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                  (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)]
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return spans


def _circle_plain(img, cx: int, cy: int, r: int, color) -> None:
    h, w = img.shape[:2]
    for y, xl, xr in _circle_spans(cx, cy, r):
        if 0 <= y < h and xl < w and xr >= 0:
            _hline(img, y, max(xl, 0), min(xr, w - 1), color)


def _ellipse_poly(cx: float, cy: float, ax: float, ay: float, delta: int):
    """OpenCV's ``ellipse2Poly`` of a whole, unrotated ellipse, in doubles."""
    alpha, beta = _SIN[450], _SIN[0]  # cos 0, sin 0
    pts = []
    for ang in range(0, 360 + delta, delta):
        a = min(ang, 360)
        x = ax * _SIN[450 - a]
        y = ay * _SIN[a]
        pts.append((cx + x * alpha - y * beta, cy + x * beta + y * alpha))
    if len(pts) == 1:
        pts = [(cx, cy)] * 2
    return pts


def _cv_round(x: float) -> int:
    return int(np.rint(x))


def _fill_ellipse_aa(img, cx: int, cy: int, r: int, color) -> None:
    """A filled circle of fixed-point centre and radius (OpenCV ``EllipseEx``, filled)."""
    d = (r + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if d < 3 else 30 if d < 10 else 18 if d < 15 else 5
    v, prev = [], None
    for x, y in _ellipse_poly(float(cx), float(cy), float(r), float(r), delta):
        px = _cv_round(x / XY_ONE) << XY_SHIFT
        py = _cv_round(y / XY_ONE) << XY_SHIFT
        pt = (px + _cv_round(x - px), py + _cv_round(y - py))
        if pt != prev:
            v.append(pt)
            prev = pt
    if len(v) == 1:
        v = [(cx, cy)] * 2
    _fill_convex(img, v, color, True, XY_SHIFT)


def line(img: np.ndarray, p1, p2, color, thickness: int = 1, aa: bool = False) -> None:
    """``cv2.line(img, p1, p2, color, thickness, LINE_AA if aa else LINE_8)`` on
    integer ends, in place."""
    _check(img)
    if not 0 < thickness <= 32767:
        raise ValueError(f"thickness {thickness} outside 1..32767")
    color = _color(color)
    x1, y1, x2, y2 = int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1])
    if thickness <= 1:
        if aa:
            _line_aa(img, x1 << XY_SHIFT, y1 << XY_SHIFT, x2 << XY_SHIFT, y2 << XY_SHIFT, color)
        else:
            _line8(img, x1, y1, x2, y2, color)
        return
    # a thick line: its ends clipped to the image grown by the thickness on every
    # side, the quad of its sides, then a round cap at each end
    h, w = img.shape[:2]
    t = thickness
    clipped = _clip_line(w + 2 * t, h + 2 * t, x1 + t, y1 + t, x2 + t, y2 + t)
    if clipped is None:
        return
    X1, Y1, X2, Y2 = ((c - t) << XY_SHIFT for c in clipped)
    ddx, ddy = (X1 - X2) / XY_ONE, (Y2 - Y1) / XY_ONE
    r = ddx * ddx + ddy * ddy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (t + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _cv_round(ddy * r), _cv_round(ddx * r)
        quad = [(X1 + dpx, Y1 + dpy), (X1 - dpx, Y1 - dpy), (X2 - dpx, Y2 - dpy),
                (X2 + dpx, Y2 + dpy)]
        _fill_convex(img, quad, color, aa, XY_SHIFT)
    for X, Y in ((X1, Y1), (X2, Y2)):
        if aa:
            _fill_ellipse_aa(img, X, Y, t, color)
        else:
            _circle_plain(img, (X + (XY_ONE >> 1)) >> XY_SHIFT, (Y + (XY_ONE >> 1)) >> XY_SHIFT,
                          (t + (XY_ONE >> 1)) >> XY_SHIFT, color)


def circle(img: np.ndarray, center, radius: int, color, aa: bool = False) -> None:
    """``cv2.circle(img, center, radius, color, -1, LINE_AA if aa else LINE_8)``:
    a filled disc, in place."""
    _check(img)
    if radius < 0:
        raise ValueError(f"radius {radius} < 0")
    color = _color(color)
    cx, cy, r = int(center[0]), int(center[1]), int(radius)
    if aa:
        _fill_ellipse_aa(img, cx << XY_SHIFT, cy << XY_SHIFT, r << XY_SHIFT, color)
    else:
        _circle_plain(img, cx, cy, r, color)


def fill_convex_poly(img: np.ndarray, pts, color, aa: bool = True) -> None:
    """``cv2.fillConvexPoly(img, pts, color, LINE_AA if aa else LINE_8)`` on integer
    vertices (N, 2), in place."""
    _check(img)
    pts = np.asarray(pts).reshape(-1, 2)
    if len(pts) == 0:
        return
    _fill_convex(img, [(int(x), int(y)) for x, y in pts], _color(color), aa, 0)


def draw_marker(img: np.ndarray, position, color, marker: str = "cross", size: int = 20,
                thickness: int = 1) -> None:
    """``cv2.drawMarker`` (8-connected lines): one of :data:`MARKERS`, in place."""
    x, y = int(position[0]), int(position[1])
    s = int(size) // 2
    segs = {
        "star": [((x - s, y), (x + s, y)), ((x, y - s), (x, y + s)),
                 ((x - s, y - s), (x + s, y + s)), ((x + s, y - s), (x - s, y + s))],
        "diamond": [((x, y - s), (x + s, y)), ((x + s, y), (x, y + s)),
                    ((x, y + s), (x - s, y)), ((x - s, y), (x, y - s))],
        "square": [((x - s, y - s), (x + s, y - s)), ((x + s, y - s), (x + s, y + s)),
                   ((x + s, y + s), (x - s, y + s)), ((x - s, y + s), (x - s, y - s))],
        "triangle_up": [((x - s, y + s), (x + s, y + s)), ((x + s, y + s), (x, y - s)),
                        ((x, y - s), (x - s, y + s))],
    }
    if marker not in segs:
        raise ValueError(f"marker {marker!r}: one of {MARKERS}")
    for p1, p2 in segs[marker]:
        line(img, p1, p2, color, thickness)


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float,
                 gamma: float = 0.0) -> np.ndarray:
    """``cv2.addWeighted`` of two uint8 images: saturate(round_half_even(a * alpha
    + (b * beta + gamma))) in float32, each product-and-add fused as OpenCV's
    vector path fuses it."""
    if a.shape != b.shape or a.dtype != np.uint8 or b.dtype != np.uint8:
        raise ValueError(f"expected two uint8 images of one shape, got {a.dtype} {a.shape} "
                         f"and {b.dtype} {b.shape}")
    al, be, ga = (float(np.float32(s)) for s in (alpha, beta, gamma))
    inner = (b.astype(np.float64) * be + ga).astype(np.float32)
    t = (a.astype(np.float64) * al + inner.astype(np.float64)).astype(np.float32)
    return np.clip(np.rint(t), 0, 255).astype(np.uint8)


_RESIZE_BITS = 11
_RESIZE_ONE = 1 << _RESIZE_BITS


def _resize_taps(dst: int, src: int, clamp: bool):
    """First source index and 11-bit weights of each output column or row (OpenCV's
    ``INTER_LINEAR`` coefficients). Columns past an edge take the edge pixel at full
    weight (``clamp``); rows keep their weights and read the edge row twice."""
    scale = 1.0 / (dst / src)
    idx = np.empty(dst, np.int64)
    w = np.empty((dst, 2), np.int64)
    for d in range(dst):
        f = float(np.float32((d + 0.5) * scale - 0.5))
        s = math.floor(f)
        f = float(np.float32(f - s))
        if clamp and s < 0:
            f, s = 0.0, 0
        if clamp and s >= src - 1:
            f, s = 0.0, src - 1
        idx[d] = s
        w[d] = (int(np.rint(np.float32(1.0 - f) * _RESIZE_ONE)),
                int(np.rint(np.float32(f) * _RESIZE_ONE)))
    return idx, w


def resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` of an (H, W[, C]) uint8 image, bilinear:
    an integer pass along rows, then OpenCV's uint8 column pass, which rounds each
    tap's product down to 16 bits before the sum."""
    if img.dtype != np.uint8:
        raise ValueError(f"expected a uint8 image, got {img.dtype}")
    dw, dh = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    if (dw, dh) == (sw, sh):
        return img.copy()
    src = img.astype(np.int64)
    if img.ndim == 2:
        src = src[..., None]
    if dw * 2 == sw and dh * 2 == sh:  # OpenCV takes the 2x2 area mean here
        s = src[0::2, 0::2] + src[1::2, 0::2] + src[0::2, 1::2] + src[1::2, 1::2]
        out = ((s + 2) >> 2).astype(np.uint8)
        return out[..., 0] if img.ndim == 2 else out
    xi, xw = _resize_taps(dw, sw, clamp=True)
    yi, yw = _resize_taps(dh, sh, clamp=False)
    x1 = np.minimum(xi + 1, sw - 1)
    rows = (src[:, xi] * xw[None, :, 0, None] + src[:, x1] * xw[None, :, 1, None]) >> 4
    r0 = rows[np.clip(yi, 0, sh - 1)]
    r1 = rows[np.clip(yi + 1, 0, sh - 1)]
    out = (((yw[:, 0, None, None] * r0) >> 16) + ((yw[:, 1, None, None] * r1) >> 16) + 2) >> 2
    out = out.clip(0, 255).astype(np.uint8)
    return out[..., 0] if img.ndim == 2 else out


def rgb_to_bgr(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[..., ::-1])


bgr_to_rgb = rgb_to_bgr


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of an (H, W, 3) RGB or (H, W) grey uint8 image (no row filter)."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected an (H, W, 3) or (H, W) uint8 image, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    ctype = 2 if img.ndim == 3 else 0
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw, level)) + _png_chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an RGB (H, W, 3) or grey (H, W) uint8 image as a PNG file."""
    data = encode_png(img)  # raises before the file is opened
    with open(path, "wb") as f:
        f.write(data)
