"""The masked DLT of the reference joints in one launch (the model's entry point).

Counterpart of ``poem_v2_tpu/geometry/triangulation.py:triangulate_dlt`` (a jnp
chain there, no Pallas kernel), fed with the camera->master extrinsics.

CPU tensors take the plain chain, :func:`~..geometry.triangulation.triangulate_dlt`
on :func:`~..geometry.camera.rigid_inverse_rows`; CUDA tensors take the kernel in
``csrc/triangulate.cu``; there is no fallback from one to the other.
``triangulate_dlt_c2m.launches`` counts kernel launches. Eval only: it has no
backward and raises on the card when autograd would need one (the train forward
does not triangulate).

The kernel keeps the plain chain's arithmetic: float32 throughout, the same 6
sweeps of 6 Jacobi rotations with the same formula and eps
(:data:`~..geometry.triangulation.DLT_EPS`), IEEE square roots and divisions, and
no fused multiply-add. It takes float32 points and cameras and a bool mask.
"""

from __future__ import annotations

import torch

from ..geometry.camera import rigid_inverse_rows
from ..geometry.triangulation import triangulate_dlt
from . import _lib


def triangulate_dlt_c2m(
    kp2d: torch.Tensor,          # (B, V, J, 2) pixels
    cam_intr: torch.Tensor,      # (B, V, 3, 3)
    cam_extr_c2m: torch.Tensor,  # (B, V, 4, 4) camera->master
    view_mask: torch.Tensor,     # (B, V) bool
) -> torch.Tensor:
    """(B, J, 3) points: :func:`triangulate_dlt` of the inverted extrinsics; masked
    views drop out."""
    B, V, J, _ = kp2d.shape
    if kp2d.device.type == "cpu":
        return triangulate_dlt(kp2d, cam_intr, rigid_inverse_rows(cam_extr_c2m), view_mask)
    ts = (kp2d, cam_intr, cam_extr_c2m, view_mask)
    if kp2d.device.type != "cuda" or any(t.device != kp2d.device for t in ts):
        raise ValueError("kp2d, cam_intr, cam_extr_c2m and view_mask must be on one CUDA "
                         f"device, got {[str(t.device) for t in ts]}")
    if (kp2d.shape[-1] != 2 or cam_intr.shape != (B, V, 3, 3)
            or cam_extr_c2m.shape != (B, V, 4, 4) or view_mask.shape != (B, V)):
        raise ValueError(f"shapes {[tuple(t.shape) for t in ts]} are not (B, V, J, 2), "
                         "(B, V, 3, 3), (B, V, 4, 4), (B, V)")
    if [t.dtype for t in ts] != [torch.float32] * 3 + [torch.bool]:
        raise ValueError(f"the kernel takes float32 points and cameras and a bool mask, got "
                         f"{[t.dtype for t in ts]}")
    _lib.no_grad_guard("triangulate_dlt_c2m", *ts[:3])
    out = torch.empty((B, J, 3), dtype=torch.float32, device=kp2d.device)
    if B * J == 0:
        return out
    kp, intr, extr, mask = (t.contiguous() for t in ts)
    _lib.lib().call("poem_triangulate_dlt", kp.data_ptr(), intr.data_ptr(), extr.data_ptr(),
                    mask.data_ptr(), out.data_ptr(), B, V, J, _lib.stream_ptr(kp2d))
    triangulate_dlt_c2m.launches += 1
    return out


triangulate_dlt_c2m.launches = 0
