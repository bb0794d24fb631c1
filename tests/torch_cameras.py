"""Camera rigs for the port's tests, free of JAX so that tests run on the card
(``--noconftest``) can import them too."""

from __future__ import annotations

import numpy as np


def look_at_cameras(rs: np.random.RandomState, B: int, V: int, image_size: int,
                    dist: float = 0.5):
    """Cameras on a sphere around a hand-sized target at the origin of view 0's
    frame: (intr (B, V, 3, 3), extr camera->master (B, V, 4, 4)), float32."""
    target = np.array([0.0, 0.0, dist])
    intr = np.zeros((B, V, 3, 3), np.float32)
    extr = np.zeros((B, V, 4, 4), np.float32)
    for b in range(B):
        for v in range(V):
            if v == 0:
                centre = np.zeros(3)
            else:
                d = rs.randn(3)
                d[2] = -abs(d[2])
                centre = target + dist * d / np.linalg.norm(d)
            z = target - centre
            z /= np.linalg.norm(z)
            x = np.cross([0.0, 1.0, 0.0], z)
            x /= np.linalg.norm(x)
            y = np.cross(z, x)
            extr[b, v, :3, :3] = np.stack([x, y, z], axis=1)
            extr[b, v, :3, 3] = centre
            extr[b, v, 3, 3] = 1.0
            f = image_size * (1.2 + 0.1 * rs.rand())
            intr[b, v] = [[f, 0, image_size / 2], [0, f, image_size / 2], [0, 0, 1]]
    return intr, extr
