"""Image decode and encode of the data layer, on the card without OpenCV.

The JAX data layer decodes shard images with ``cv2.imdecode`` and encodes them
with ``cv2.imencode`` (``poem_v2_tpu/data/wds.py``, ``data/dumper.py``). The
card's machine has no OpenCV and no PIL, so:

- JPEG on a CUDA device goes through nvJPEG (``csrc/jpeg.cpp``, a shared library
  of its own built at first use by ``ops/_lib.py:jpeg``): decoded on the card to
  interleaved RGB and copied to a host array. nvJPEG's IDCT and chroma
  upsampling are not libjpeg's, so its pixels differ from OpenCV's by a few
  levels (``chip_smoke.py`` phase 7 holds them to stated limits). A shim that
  does not build or launch raises; nothing falls back to another decoder.
- JPEG on the CPU is OpenCV's own call, as in the JAX package (exactly its
  pixels); without OpenCV it raises.
- PNG on either device is decoded here: zlib inflates it and ``csrc/png.cc``,
  built with g++ at first use like ``native/warp.cc``, undoes the row filters
  (8-bit gray, RGB and RGBA, every filter type): lossless, so exactly OpenCV's
  pixels.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Union

import numpy as np
import torch

JPEG_MAGIC = b"\xff\xd8\xff"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels (8-bit gray, RGB, RGBA)
_JPEG_BUFFER_TOO_SMALL = 2000  # csrc/jpeg.cpp's return code

Device = Union[str, torch.device]


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"{what} on the CPU is OpenCV's, which is not installed; on a CUDA "
                           "device nvJPEG does it (device='cuda')") from e
    return cv2


def _on_card(device: Device) -> bool:
    return torch.device(device).type == "cuda"


def _device_index(device: Device) -> int:
    d = torch.device(device)
    return d.index if d.index is not None else torch.cuda.current_device()


def decode_image(buf: bytes, device: Device = "cpu") -> np.ndarray:
    """(H, W, 3) uint8 RGB of an encoded JPEG or PNG image (see the module
    docstring for which decoder runs where)."""
    head = bytes(buf[:8])
    if head.startswith(PNG_MAGIC):
        return decode_png(buf)
    if head.startswith(JPEG_MAGIC):
        if _on_card(device):
            return nvjpeg_decode(buf, device)
        cv2 = _cv2("JPEG decode")
        img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    raise ValueError(f"not a JPEG or PNG stream (first bytes {head!r})")


def read_image(path: str, device: Device = "cpu") -> np.ndarray:
    """(H, W, 3) uint8 RGB of an image file (the adapters' raw frames)."""
    with open(path, "rb") as f:
        return decode_image(f.read(), device)


class _Counter:
    """A count that threads add to (the decodes a run made through nvJPEG)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.launches = 0

    def add(self) -> None:
        with self._lock:
            self.launches += 1


nvjpeg_decodes = _Counter()


def nvjpeg_decode(buf: bytes, device: Device = "cuda") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG stream, decoded by nvJPEG on ``device``."""
    from ..ops import _lib

    lib = _lib.jpeg()
    data = np.frombuffer(buf, np.uint8)
    ptr = data.ctypes.data_as(ctypes.c_void_p)
    w, h = ctypes.c_int(), ctypes.c_int()
    lib.call("poem_jpeg_info", ptr, data.size, ctypes.byref(w), ctypes.byref(h))
    out = np.empty((h.value, w.value, 3), np.uint8)
    lib.call("poem_jpeg_decode", ptr, data.size, w.value, h.value, _device_index(device),
             out.ctypes.data_as(ctypes.c_void_p))
    nvjpeg_decodes.add()
    return out


def encode_jpeg(img: np.ndarray, quality: int = 95, device: Device = "cpu") -> bytes:
    """A baseline JPEG of ``img`` ((H, W, 3) uint8 RGB) at ``quality``: on a CUDA
    device by nvJPEG with 4:2:0 chroma (OpenCV's default sampling), on the CPU by
    OpenCV with the JAX dumper's call."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) RGB, got {img.shape}")
    if not _on_card(device):
        cv2 = _cv2("JPEG encode")
        ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise RuntimeError("cv2.imencode failed")
        return buf.tobytes()
    from ..ops import _lib

    lib = _lib.jpeg()
    h, w = img.shape[:2]
    src = img.ctypes.data_as(ctypes.c_void_p)
    length = ctypes.c_size_t()
    capacity = img.size + 4096
    while True:
        out = np.empty(capacity, np.uint8)
        code = lib.status("poem_jpeg_encode", src, w, h, int(quality), _device_index(device),
                          out.ctypes.data_as(ctypes.c_void_p), capacity, ctypes.byref(length))
        if code != _JPEG_BUFFER_TOO_SMALL:
            break
        capacity = length.value
    if code != 0:
        raise RuntimeError(f"poem_jpeg_encode failed with error {code}")
    return out[:length.value].tobytes()


# -- PNG --------------------------------------------------------------------

def _png_chunks(buf: bytes):
    pos = len(PNG_MAGIC)
    while pos + 8 <= len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        yield kind, buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("truncated PNG stream")


_PNG_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
                        "png.cc")
PNG_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_PNG_LOCK = threading.Lock()
_PNG_LIB = None


def _png_lib() -> ctypes.CDLL:
    """The PNG unfilter (``csrc/png.cc``), built with g++ on first use; raises if
    the build fails."""
    global _PNG_LIB
    with _PNG_LOCK:
        if _PNG_LIB is None:
            from . import native_ops

            lib = ctypes.CDLL(native_ops.build(_PNG_SRC, "poem_png"))
            lib.poem_png_unfilter.argtypes = PNG_ARGTYPES
            lib.poem_png_unfilter.restype = ctypes.c_int
            _PNG_LIB = lib
    return _PNG_LIB


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth); (height, stride)."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError("PNG image data does not match its header")
    out = np.empty((height, stride), np.uint8)
    bad = _png_lib().poem_png_unfilter(rows.ctypes.data, height, stride, bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"PNG filter type {rows[(bad - 1) * (stride + 1)]} in row {bad - 1}")
    return out


def decode_png(buf: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an 8-bit, non-interlaced gray, RGB or RGBA PNG, as
    ``cv2.imdecode(IMREAD_COLOR)`` gives it (gray repeated, alpha dropped)."""
    buf = bytes(buf)
    if not buf.startswith(PNG_MAGIC):
        raise ValueError("not a PNG stream")
    header, idat = None, []
    for kind, data in _png_chunks(buf):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError("PNG stream without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {colour}, interlace {interlace}: "
                         "only 8-bit non-interlaced gray, RGB and RGBA are decoded")
    ch = _PNG_CHANNELS[colour]
    img = _unfilter(zlib.decompress(b"".join(idat)), height, width * ch, ch)
    img = img.reshape(height, width, ch)
    if ch == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])
