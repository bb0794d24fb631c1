"""The fused crop warp of the transforms (counterpart of ``poem_v2_tpu/data/native_ops.py``).

``native/warp.cc`` (bilinear ``warpAffine`` with a constant border, colour
jitter and the mean .5 / std 1 normalisation in one pass over the crop) is
compiled from its place in the repository, with the JAX package's flags, into
``poem_v2_tpu_torch/_build/`` at first use and loaded with ``ctypes``. The same
source and flags on the same machine give the JAX data layer's crops bit for
bit. Unlike the JAX module, a failed build raises: there is no OpenCV path to
fall back to on the card's machine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC = os.path.join(_ROOT, "native", "warp.cc")
BUILD_DIR = os.path.join(_ROOT, "poem_v2_tpu_torch", "_build")
# the JAX package's flags (poem_v2_tpu/data/native_ops.py:28-37)
FLAGS = ["-O3", "-march=native", "-ffast-math", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_F = ctypes.POINTER(ctypes.c_float)
_ARGTYPES = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, _F, _F, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_float, _F, ctypes.c_int]


def build(src: str = SRC, name: str = "poemwarp") -> str:
    """Compile the host source ``src`` (``native/warp.cc``, or the PNG unfilter of
    ``csrc/png.cc``) into ``_build/lib<name>_<hash>.so`` if absent."""
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(FLAGS).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run(["g++", *FLAGS, src, "-o", tmp], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """The warp library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.warp_affine_normalize.argtypes = _ARGTYPES
            lib.warp_affine_normalize.restype = None
            _LIB = lib
    return _LIB


def warp_affine_normalize(image: np.ndarray, affine2x3: np.ndarray, out_hw,
                          scale: float = 1.0 / 255.0, shift: float = -0.5,
                          color_jitter: Optional[np.ndarray] = None,
                          n_threads: int = 1) -> np.ndarray:
    """The (H, W, 3) float32 crop of ``image`` ((h, w, 3) uint8) under ``affine2x3``
    (source -> crop), each channel times its jitter, then ``* scale + shift``."""
    lib = get_lib()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"warp_affine_normalize takes (h, w, 3) uint8, got {image.shape}")
    aff = np.ascontiguousarray(affine2x3, dtype=np.float32).reshape(6)
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out = np.empty((oh, ow, 3), dtype=np.float32)
    cj = (np.ascontiguousarray(color_jitter, dtype=np.float32).reshape(3)
          if color_jitter is not None else None)
    lib.warp_affine_normalize(
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), image.shape[0], image.shape[1],
        aff.ctypes.data_as(_F), out.ctypes.data_as(_F), oh, ow, ctypes.c_float(scale),
        ctypes.c_float(shift), cj.ctypes.data_as(_F) if cj is not None else None, n_threads)
    return out
