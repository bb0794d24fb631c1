"""The data layer's image codecs (``poem_v2_tpu_torch/data/codec.py``) on the CPU:
the committed fixtures against OpenCV, the PNG decoder bit-exact against
``cv2.imdecode`` (gray, RGB, RGBA, odd sizes, every filter type), the
request_flip warp against ``cv2.warpAffine``, JPEG on the CPU without OpenCV,
and the C signatures of the nvJPEG shim and of the PNG unfilter against their
ctypes declarations. The shim
itself runs only on the card (the ``cuda`` test at the end; ``chip_smoke.py``
phase 7)."""

import ctypes
import os
import re
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

cv2 = pytest.importorskip("cv2")

from poem_v2_tpu_torch.data import codec  # noqa: E402
from poem_v2_tpu_torch.data.wds import flip_image  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures", "codec")


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _cv2_rgb(buf):
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


def test_committed_decodes_equal_opencv():
    """tests/torch_fixtures/codec: OpenCV's decodes of the committed files are the
    committed arrays, and the source is the generator's image from seed 0."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        from torch_make_codec_fixture import make_source
    finally:
        sys.path.pop(0)
    ref = np.load(os.path.join(FIXTURES, "decodes.npz"))
    np.testing.assert_array_equal(ref["source"], make_source(0))
    np.testing.assert_array_equal(_cv2_rgb(_read("source.png")), ref["source"])
    for name, shape in (("q95_640x480", (480, 640, 3)), ("q95_224x224", (224, 224, 3))):
        assert ref[name].shape == shape
        np.testing.assert_array_equal(_cv2_rgb(_read(f"{name}.jpg")), ref[name])
        # the CPU path of the port is OpenCV's call
        np.testing.assert_array_equal(codec.decode_image(_read(f"{name}.jpg")), ref[name])
    assert sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES)) < 1.5e6


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 23), w=st.integers(1, 37), channels=st.sampled_from([1, 3, 4]),
       seed=st.integers(0, 2 ** 31 - 1), smooth=st.booleans())
def test_png_decoder_matches_opencv(h, w, channels, seed, smooth):
    rs = np.random.RandomState(seed)
    if smooth:  # gradients make libpng pick Sub / Up / Average / Paeth rows
        img = (np.add.outer(np.arange(h) * 7, np.arange(w) * 3)[..., None]
               + rs.randint(0, 4, (h, w, channels))) % 256
    else:
        img = rs.randint(0, 256, (h, w, channels))
    img = img.astype(np.uint8)
    ok, buf = cv2.imencode(".png", img if channels > 1 else img[..., 0])
    assert ok
    np.testing.assert_array_equal(codec.decode_png(buf.tobytes()), _cv2_rgb(buf.tobytes()))


def _png(img, filters):
    """An 8-bit PNG of ``img`` ((h, w) gray, (h, w, 3) RGB or (h, w, 4) RGBA) whose
    row r is stored with filter type ``filters[r % len(filters)]``."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch).astype(np.int32)
    raw = bytearray()
    prev = np.zeros(w * ch, np.int32)
    for r in range(h):
        kind = filters[r % len(filters)]
        cur = rows[r]
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    colour = {1: 0, 3: 2, 4: 6}[ch]
    return (codec.PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)])
def test_png_decoder_undoes_every_filter(channels, filters):
    rs = np.random.RandomState(len(filters) * 10 + channels)
    shape = (13, 21) if channels == 1 else (13, 21, channels)
    img = rs.randint(0, 256, shape).astype(np.uint8)
    buf = _png(img, filters)
    want = np.repeat(img[..., None], 3, 2) if channels == 1 else img[..., :3]
    got = codec.decode_png(buf)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _cv2_rgb(buf))  # OpenCV reads the file the same way


def test_png_decoder_refuses_what_it_does_not_decode():
    img = np.zeros((4, 5, 3), np.uint8)
    ok, buf = cv2.imencode(".png", img.astype(np.uint16))  # 16-bit
    with pytest.raises(ValueError, match="bit depth 16"):
        codec.decode_png(buf.tobytes())
    with pytest.raises(ValueError, match="not a JPEG or PNG"):
        codec.decode_image(b"GIF89a....")
    with pytest.raises(ValueError, match="filter type 5 in row 1"):
        codec.decode_png(_png(img, (0, 5)))


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 9), w=st.integers(1, 90), dw=st.integers(-4, 4), dh=st.integers(-2, 2),
       shift_1000=st.integers(-20_000, 120_000), seed=st.integers(0, 2 ** 31 - 1))
def test_flip_warp_matches_opencv(h, w, dw, dh, shift_1000, seed):
    """The request_flip warp (x -> shift - x), output sizes other than the input's
    and principal points off the pixel grid or outside the image included. (The
    shift is drawn as an integer: hypothesis refuses float strategies once a
    library built with -ffast-math, as native/warp.cc's is, has turned on
    flush-to-zero in the process.)"""
    shift = shift_1000 / 1000
    img = np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)
    size = (max(1, w + dw), max(1, h + dh))
    m = np.array([[-1, 0, shift], [0, 1, 0]], np.float32)
    want = cv2.warpAffine(img, m, size)
    np.testing.assert_array_equal(flip_image(img, m[0, 2], size), want.reshape(size[1], size[0], 3))


def test_jpeg_on_the_cpu_without_opencv_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    with pytest.raises(RuntimeError, match="OpenCV"):
        codec.decode_image(_read("q95_224x224.jpg"), "cpu")
    with pytest.raises(RuntimeError, match="OpenCV"):
        codec.encode_jpeg(np.zeros((8, 8, 3), np.uint8), 95, "cpu")
    # PNG needs no OpenCV
    assert codec.decode_image(_read("source.png")).shape == (480, 640, 3)


def test_encode_on_the_cpu_is_the_jax_dumpers_call():
    img = np.load(os.path.join(FIXTURES, "decodes.npz"))["q95_224x224"]
    ok, want = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                            [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert codec.encode_jpeg(img, 90) == want.tobytes()


def test_read_image(tmp_path):
    np.testing.assert_array_equal(codec.read_image(os.path.join(FIXTURES, "source.png")),
                                  np.load(os.path.join(FIXTURES, "decodes.npz"))["source"])
    with pytest.raises(FileNotFoundError):
        codec.read_image(str(tmp_path / "missing.jpg"))


def test_shim_signatures_match_the_c_entry_points():
    """Every ctypes signature of the nvJPEG shim has its C entry point's arguments,
    pointers where the C side takes pointers and ``size_t`` where it takes one."""
    from poem_v2_tpu_torch.ops import _lib

    src = open(os.path.join(_lib.CSRC, "jpeg.cpp")).read()
    decls = {m.group(1): [a.strip() for a in m.group(2).split(",")]
             for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert set(decls) == set(_lib._JPEG_SIGNATURES)
    for fn, args in decls.items():
        types = _lib._JPEG_SIGNATURES[fn]
        assert len(types) == len(args), fn
        for a, t in zip(args, types):
            assert ("*" in a) == (t is _lib._P), (fn, a)
            assert a.startswith("size_t ") == (t is _lib._S), (fn, a)


def test_png_unfilter_signature_matches_its_c_entry_point():
    """The ctypes argument list of the PNG unfilter has ``csrc/png.cc``'s arguments,
    pointers where the C side takes pointers."""
    from poem_v2_tpu_torch.ops import _lib

    src = open(os.path.join(_lib.CSRC, "png.cc")).read()
    (args,) = re.findall(r'extern "C" int poem_png_unfilter\(([^)]*)\)', src)
    args = [a.strip() for a in args.split(",")]
    assert len(args) == len(codec.PNG_ARGTYPES)
    for a, t in zip(args, codec.PNG_ARGTYPES):
        assert ("*" in a) == (t is ctypes.c_void_p), a


def test_card_decode_never_falls_back_without_a_card():
    """On a CUDA device the decode is nvJPEG's or it raises: without a card or a
    toolkit here it raises, and OpenCV is never asked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: phase 7 and the cuda test hold nvJPEG")
    with pytest.raises((RuntimeError, AssertionError)):
        codec.decode_image(_read("q95_224x224.jpg"), "cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        codec.encode_jpeg(np.zeros((8, 8, 3), np.uint8), 95, "cuda")


@pytest.mark.cuda
def test_nvjpeg_within_the_stated_limits():
    """On the card: nvJPEG against OpenCV's decodes of the fixtures within each
    fixture's ``chip_smoke.NVJPEG_LIMITS``, PNG bit-exact, the q95 round trip
    over its floor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke

    out = chip_smoke.phase_codec({}, device="cuda", iters=1)
    for name, limits in chip_smoke.NVJPEG_LIMITS.items():
        for k, limit in limits.items():
            assert out[name][k] <= limit, (name, k)
