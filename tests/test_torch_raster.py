"""The port's raster core (``poem_v2_tpu_torch/viztools/raster.py``) against OpenCV,
on random inputs from a seed: every primitive pixel for pixel.

The anti-aliased primitives (lines, discs, convex fills) follow OpenCV's own
fixed-point algorithm, and measured on these inputs they differ from OpenCV
in no pixel: the limits below (the share of pixels that may differ within
2 px of the primitive's outline, and the largest difference there) are 0.
Every pixel farther than 2 px (Chebyshev) from the outline must be identical
in any case.
"""

import numpy as np
import pytest

from poem_v2_tpu_torch.data.codec import decode_png
from poem_v2_tpu_torch.viztools import raster as R

cv2 = pytest.importorskip("cv2")

CASES = 120
# measured against OpenCV 5.0 on these inputs (PERF.md): no differing pixel
AA_BAND_SHARE = 0.0
AA_BAND_MAX_ABS = 0


def _inputs(seed):
    """Random images of 5-59 px a side, ends and centres partly outside them."""
    rs = np.random.RandomState(seed)
    for _ in range(CASES):
        h, w = rs.randint(5, 60, 2)
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        p1 = tuple(int(v) for v in rs.randint(-20, 80, 2))
        p2 = tuple(int(v) for v in rs.randint(-20, 80, 2))
        color = tuple(int(v) for v in rs.randint(0, 256, 3))
        yield rs, img, p1, p2, color


def _same(got, want, what):
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert (d == 0).all(), f"{what}: {(d > 0).sum()} pixels differ, max |d| {d.max()}"


def _within_band(got, want, outline_mask, what):
    """Identical outside 2 px of the outline; inside, within the measured limits."""
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    kernel = np.ones((5, 5), np.uint8)
    band = cv2.dilate(outline_mask.astype(np.uint8), kernel) > 0
    assert (d[~band] == 0).all(), f"{what}: pixels differ outside the anti-aliasing band"
    share = (d[band] > 0).sum() / max(int(band.sum()), 1)
    assert share <= AA_BAND_SHARE and d.max() <= AA_BAND_MAX_ABS, what


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_line_8_connected_equals_opencv(thickness):
    for _, img, p1, p2, color in _inputs(thickness):
        want, got = img.copy(), img.copy()
        cv2.line(want, p1, p2, color, thickness, cv2.LINE_8)
        R.line(got, p1, p2, color, thickness)
        _same(got, want, f"line {p1} {p2} t{thickness}")


@pytest.mark.parametrize("thickness", [1, 2])
def test_line_anti_aliased_equals_opencv(thickness):
    for _, img, p1, p2, color in _inputs(10 + thickness):
        want, got = img.copy(), img.copy()
        cv2.line(want, p1, p2, color, thickness, cv2.LINE_AA)
        R.line(got, p1, p2, color, thickness, aa=True)
        outline = np.zeros(img.shape[:2], np.uint8)
        cv2.line(outline, p1, p2, 1, thickness, cv2.LINE_8)
        _within_band(got, want, outline, f"AA line {p1} {p2} t{thickness}")


@pytest.mark.parametrize("aa", [False, True])
def test_filled_circle_equals_opencv(aa):
    for rs, img, p1, _, color in _inputs(20 + aa):
        r = int(rs.randint(0, 12))
        want, got = img.copy(), img.copy()
        cv2.circle(want, p1, r, color, -1, cv2.LINE_AA if aa else cv2.LINE_8)
        R.circle(got, p1, r, color, aa=aa)
        if aa:
            outline = np.zeros(img.shape[:2], np.uint8)
            cv2.circle(outline, p1, r, 1, 1)
            _within_band(got, want, outline, f"AA disc {p1} r{r}")
        else:
            _same(got, want, f"disc {p1} r{r}")


@pytest.mark.parametrize("aa", [False, True])
def test_fill_convex_poly_equals_opencv(aa):
    for rs, img, _, _, color in _inputs(30 + aa):
        pts = rs.randint(-5, 60, (int(rs.randint(3, 6)), 2)).astype(np.int32)
        pts = cv2.convexHull(pts).reshape(-1, 2) if len(pts) > 3 else pts
        want, got = img.copy(), img.copy()
        cv2.fillConvexPoly(want, pts, color, cv2.LINE_AA if aa else cv2.LINE_8)
        R.fill_convex_poly(got, pts, color, aa=aa)
        if aa:
            outline = np.zeros(img.shape[:2], np.uint8)
            cv2.polylines(outline, [pts], True, 1)
            _within_band(got, want, outline, f"AA polygon {pts.tolist()}")
        else:
            _same(got, want, f"polygon {pts.tolist()}")


@pytest.mark.parametrize("marker", ["star", "square", "diamond", "triangle_up"])
def test_draw_marker_equals_opencv(marker):
    code = {"star": cv2.MARKER_STAR, "square": cv2.MARKER_SQUARE,
            "diamond": cv2.MARKER_DIAMOND, "triangle_up": cv2.MARKER_TRIANGLE_UP}[marker]
    for rs, img, p1, _, color in _inputs(40):
        size, th = int(rs.randint(1, 20)), int(rs.randint(1, 4))
        want, got = img.copy(), img.copy()
        cv2.drawMarker(want, p1, color, code, size, th)
        R.draw_marker(got, p1, color, marker, size, th)
        _same(got, want, f"{marker} {p1} size {size} t{th}")


@pytest.mark.parametrize("scale", [10 ** 3, 10 ** 5, 10 ** 7])
def test_far_ends_clip_as_opencv(scale):
    """Ends far outside the image (a random model's projections): the clipping's
    intersections round as OpenCV's doubles do."""
    rs = np.random.RandomState(scale % 97)
    for _ in range(CASES):
        h, w = rs.randint(5, 130, 2)
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        p1, p2 = (tuple(int(v) for v in rs.randint(-scale, scale, 2)) for _ in range(2))
        for thickness, aa in ((1, False), (1, True), (3, False), (2, True)):
            want, got = img.copy(), img.copy()
            cv2.line(want, p1, p2, (9, 200, 30), thickness, cv2.LINE_AA if aa else cv2.LINE_8)
            R.line(got, p1, p2, (9, 200, 30), thickness, aa=aa)
            _same(got, want, f"line {p1} {p2} t{thickness} aa {aa}")


def test_float_colours_round_as_opencv():
    """A colour of floats (the wireframes' [0, 1] x 255) rounds half to even."""
    img = np.zeros((9, 9, 3), np.uint8)
    want, got = img.copy(), img.copy()
    color = np.array([0.4, 0.6, 1.0 / 510]) * 255  # 102.0, 153.0, 0.5
    cv2.line(want, (0, 4), (8, 4), color)
    R.line(got, (0, 4), (8, 4), color)
    _same(got, want, "float colour")


def test_add_weighted_equals_opencv():
    rs = np.random.RandomState(50)
    for _ in range(CASES):
        h, w = rs.randint(1, 70, 2)
        a = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        b = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        alpha, gamma = float(rs.rand()), float(rs.choice([0.0, 0.5, 3.25]))
        for al, be in ((alpha, 1 - alpha), (0.65, 0.35), (alpha, 1.3)):
            _same(R.add_weighted(a, al, b, be, gamma), cv2.addWeighted(a, al, b, be, gamma),
                  f"addWeighted {al} {be} {gamma}")


def test_resize_equals_opencv():
    rs = np.random.RandomState(60)
    for _ in range(CASES):
        h, w = rs.randint(2, 120, 2)
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        dw, dh = (int(v) for v in rs.randint(1, 150, 2))
        for size in ((dw, dh), (max(w // 2, 1), max(h // 2, 1)), (w, h)):
            np.testing.assert_array_equal(R.resize(img, size), cv2.resize(img, size))
        np.testing.assert_array_equal(R.resize(img[..., 0], (dw, dh)),
                                      cv2.resize(img[..., 0], (dw, dh)))


def test_channel_swap():
    img = np.random.RandomState(70).randint(0, 256, (5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(R.rgb_to_bgr(img), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    np.testing.assert_array_equal(R.bgr_to_rgb(R.rgb_to_bgr(img)), img)


@pytest.mark.parametrize("shape", [(1, 1, 3), (37, 53, 3), (16, 9)])
def test_write_png_round_trips(tmp_path, shape):
    """An RGB or grey PNG written by the core reads back equal through OpenCV and
    through the port's own decoder."""
    img = np.random.RandomState(80).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    R.write_png(path, img)
    if img.ndim == 3:
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1], img)
        np.testing.assert_array_equal(decode_png(open(path, "rb").read()), img)
    else:
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE), img)


def test_bad_arguments_raise(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError):
        R.line(img.astype(np.float32), (0, 0), (1, 1), (1, 1, 1))
    with pytest.raises(ValueError):
        R.line(img, (0, 0), (1, 1), (1, 1, 1), thickness=0)
    with pytest.raises(ValueError):
        R.circle(img, (0, 0), -1, (1, 1, 1))
    with pytest.raises(ValueError):
        R.draw_marker(img, (0, 0), (1, 1, 1), "hexagon")
    with pytest.raises(ValueError):
        R.add_weighted(img, 0.5, img[:2], 0.5)
    with pytest.raises(ValueError):
        R.write_png(str(tmp_path / "x.png"), img[..., :2])
    assert not (tmp_path / "x.png").exists()
