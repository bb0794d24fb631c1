"""Write the codec fixtures of the port's tests and of ``chip_smoke.py``.

    python scripts/torch_make_codec_fixture.py [--out tests/torch_fixtures/codec]

Needs OpenCV; deterministic from ``--seed`` (0). Writes:

- ``source.png``: a 640x480 RGB image (smooth colour fields, hard-edged shapes
  with chroma edges, a patch of noise), lossless;
- ``q95_640x480.jpg`` and ``q95_224x224.jpg`` (its centre crop): JPEG at quality
  95, encoded with the JAX package's dumper call (``poem_v2_tpu/data/dumper.py``:
  ``cv2.imencode`` of the BGR image, ``IMWRITE_JPEG_QUALITY``);
- ``decodes.npz`` (compressed): ``source`` (the RGB image), and OpenCV's RGB
  decodes ``q95_640x480`` and ``q95_224x224`` of the two JPEGs (``imdecode`` +
  ``cvtColor``, the JAX data layer's call). OpenCV's decode of ``source.png`` is
  ``source``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

QUALITY = 95


def make_source(seed: int = 0, height: int = 480, width: int = 640) -> np.ndarray:
    """(H, W, 3) uint8 RGB: colour gradients and ripples, filled discs and
    rectangles of saturated colours (chroma edges), and one patch of +-12
    levels of noise."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    img = np.empty((height, width, 3))
    for c in range(3):
        fx, fy, ph = rs.uniform(0.005, 0.03), rs.uniform(0.005, 0.03), rs.uniform(0, 2 * np.pi)
        img[..., c] = 128 + 60 * np.sin(fx * x + fy * y + ph) + 40 * (x / width - 0.5) * (c - 1)
    for _ in range(12):
        colour = rs.randint(0, 256, 3)
        cx, cy, r = rs.uniform(0, width), rs.uniform(0, height), rs.uniform(15, 70)
        if rs.rand() < 0.5:
            img[(x - cx) ** 2 + (y - cy) ** 2 < r * r] = colour
        else:
            img[(abs(x - cx) < r) & (abs(y - cy) < 0.6 * r)] = colour
    patch = (slice(360, 456), slice(32, 160))  # a textured patch; noise elsewhere would
    img[patch] += rs.randint(-12, 13, img[patch].shape)  # outgrow the fixture's budget
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def main(argv=None):
    import cv2

    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "torch_fixtures", "codec"))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    src = make_source(args.seed)
    crop = np.ascontiguousarray(src[128:352, 208:432])
    ok, png = cv2.imencode(".png", cv2.cvtColor(src, cv2.COLOR_RGB2BGR))
    assert ok
    with open(os.path.join(args.out, "source.png"), "wb") as f:
        f.write(png.tobytes())
    decodes = {"source": src}
    for name, img in (("q95_640x480", src), ("q95_224x224", crop)):
        ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                               [cv2.IMWRITE_JPEG_QUALITY, QUALITY])
        assert ok
        with open(os.path.join(args.out, f"{name}.jpg"), "wb") as f:
            f.write(buf.tobytes())
        decodes[name] = cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.savez_compressed(os.path.join(args.out, "decodes.npz"), **decodes)
    for f in sorted(os.listdir(args.out)):
        print(f, os.path.getsize(os.path.join(args.out, f)))


if __name__ == "__main__":
    main()
