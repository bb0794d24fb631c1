"""Build and load the port's CUDA kernels (``poem_v2_tpu_torch/csrc``).

The kernels have a plain C interface and are compiled with ``nvcc`` (one
process per source, side by side) into one shared library, loaded with
``ctypes``; the nvJPEG shim of the data layer (``csrc/jpeg.cpp``) is a library
of its own (:func:`jpeg`), so that the kernels do not depend on libnvjpeg. The
build runs at first use,
from the sources in the checkout, into ``poem_v2_tpu_torch/_build/``
(git-ignored); the library's file name carries a hash of the sources, so
an edited source is rebuilt and a stale library is never loaded.

Nothing here runs at import time: CPU-only environments import the ops
modules freely and only a call with a CUDA tensor reaches :func:`lib`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = [*_ARCH, "-shared"]

DTYPE_F32, DTYPE_BF16 = 0, 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_S = ctypes.c_size_t
_JPEG_SIGNATURES = {
    "poem_jpeg_info": [_P, _S, _P, _P],
    "poem_jpeg_decode": [_P, _S, _I, _I, _I, _P],
    "poem_jpeg_encode": [_P, _I, _I, _I, _I, _P, _S, _P],
}
_SIGNATURES = {
    "poem_knn_select": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "poem_knn_select_bucketed": [_P] * 8 + [_I] * 8 + [_P],
    "poem_vector_attention": [_I, _I] + [_P] * 22 + [_I] * 5 + [ctypes.c_float, _P],
    "poem_knn_attention_bwd": [_I] + [_P] * 31 + [_I] * 5 + [ctypes.c_float, _P],
    "poem_kth_key_rows": [_I, _P, _P, _I, _I, _I, _P],
    "poem_kth_key_onehot": [_I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "poem_scramble_rows": [_P, _P, _P, _I, _I, _I, _I, _P],
    "poem_dense_cross_attention": [_I] + [_P] * 5 + [_I] * 5 + [ctypes.c_float, _P],
    "poem_dense_cross_attention_bwd": [_I] + [_P] * 10 + [_I] * 5 + [ctypes.c_float, _P],
    "poem_scatter_add_rows": [_I] + [_P] * 6 + [_I] * 4 + [_P],
    "poem_grid_sample_points": [_I, _P, _P, _P] + [_I] * 10 + [_P],
    "poem_triangulate_dlt": [_P] * 5 + [_I] * 3 + [_P],
}


class KernelLibrary:
    """The loaded shared library plus the compiler's report of its build."""

    def __init__(self, path: str, ptxas_log: str, signatures=None):
        self.path = path
        self.ptxas_log = ptxas_log
        self._dll = ctypes.CDLL(path)
        for name, argtypes in (signatures or _SIGNATURES).items():
            fn = getattr(self._dll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        """Run one C entry point; raise if it reports a CUDA error."""
        err = getattr(self._dll, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed with CUDA error {err}")

    def status(self, name: str, *args) -> int:
        """Run one C entry point; its return code (0 on success)."""
        return getattr(self._dll, name)(*args)


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return path


def build() -> KernelLibrary:
    """Compile ``csrc/*.cu`` into ``_build/libpoem_kernels_<hash>.so`` if absent:
    one ``nvcc -c`` per source, all started together, then one link."""
    srcs = _sources()
    h = hashlib.sha256()
    for p in srcs:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libpoem_kernels_{digest}.so")
    log_path = so + ".log"
    if not os.path.exists(so):
        nvcc = _nvcc()
        cu = [p for p in srcs if p.endswith(".cu")]
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, os.path.basename(p)[:-3] + ".o") for p in cu]
            # each compiler writes to its own file: a full pipe would stall it
            procs = []
            for p, o in zip(cu, objs):
                with open(o + ".log", "w") as f:
                    procs.append(subprocess.Popen(
                        [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", o, p],
                        stdout=f, stderr=subprocess.STDOUT))
            codes = [proc.wait() for proc in procs]
            logs = []
            for o in objs:
                with open(o + ".log") as f:
                    logs.append(f.read())
            failed = [f"{p}:\n{log}" for p, code, log in zip(cu, codes, logs) if code]
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
            out = os.path.join(tmp, "lib.so")
            link = subprocess.run([nvcc, *LINK_FLAGS, "-o", out, *objs],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
            with open(log_path, "w") as f:
                f.write("".join(logs))
            os.replace(out, so)
    log = open(log_path).read() if os.path.exists(log_path) else ""
    return KernelLibrary(so, log)


def cuda_home() -> str:
    """The CUDA toolkit's root: ``$CUDA_HOME``, else the directory above nvcc's."""
    return os.environ.get("CUDA_HOME") or os.path.dirname(os.path.dirname(
        os.path.realpath(_nvcc())))


def build_jpeg() -> KernelLibrary:
    """Compile ``csrc/jpeg.cpp`` into ``_build/libpoem_jpeg_<hash>.so`` if absent,
    linked against the toolkit's libnvjpeg (found again at run time through the
    library's rpath). Raises, naming what is missing, where the toolkit has no
    nvJPEG."""
    src = os.path.join(CSRC, "jpeg.cpp")
    home = cuda_home()
    inc, libdir = os.path.join(home, "include"), os.path.join(home, "lib64")
    missing = [p for p in (os.path.join(inc, "nvjpeg.h"), os.path.join(libdir, "libnvjpeg.so"))
               if not os.path.exists(p)]
    if missing:
        raise RuntimeError(f"JPEG on the card needs nvJPEG from the CUDA toolkit; {home} lacks "
                           + ", ".join(missing))
    flags = ["-std=c++17", "-O2", "-Xcompiler", "-fPIC", "-shared", "-I", inc, "-L", libdir,
             "-lnvjpeg", "-Xlinker", f"-rpath,{libdir}"]
    h = hashlib.sha256(open(src, "rb").read())
    h.update(" ".join(flags).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libpoem_jpeg_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = os.path.join(tmp, "lib.so")
            proc = subprocess.run([_nvcc(), *flags, "-o", out, src], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
            os.replace(out, so)
    return KernelLibrary(so, "", _JPEG_SIGNATURES)


_LIB: Optional[KernelLibrary] = None
_JPEG: Optional[KernelLibrary] = None
_JPEG_LOCK = threading.Lock()  # decode threads reach their first call together


def lib() -> KernelLibrary:
    """The process's kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        _LIB = build()
    return _LIB


def jpeg() -> KernelLibrary:
    """The process's nvJPEG shim, built on first use."""
    global _JPEG
    with _JPEG_LOCK:
        if _JPEG is None:
            _JPEG = build_jpeg()
    return _JPEG


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t) -> int:
    import torch

    if t.dtype == torch.float32:
        return DTYPE_F32
    if t.dtype == torch.bfloat16:
        return DTYPE_BF16
    raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")


def no_grad_guard(name: str, *ts) -> None:
    """Raise where autograd would need a backward that the kernel ``name`` lacks:
    its output is a fresh tensor, so handing it back would silently cut the graph."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(f"{name} has no backward: call it under torch.no_grad(), "
                           "or through its autograd Function")
