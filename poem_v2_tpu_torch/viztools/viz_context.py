"""Interactive 3D scene context (counterpart of ``poem_v2_tpu/viztools/viz_context.py``;
reference lib/viztools/viz_o3d_utils.py).

The reference's ``VizContext`` wraps an Open3D window. This one keeps the same
surface (``update_by_mesh`` / ``update_by_pc`` / ``step`` / ``run`` /
``condition`` / key callbacks) and picks a backend when it is made:

- ``"open3d"``: the interactive window, where open3d imports and a display is
  reachable (a workstation);
- ``"headless"``: a scene of numpy records and the software renderer:
  ``step()`` renders a turntable frame with the painter rasteriser
  (viztools/renderer.py) into ``self.frames`` and, with ``save_dir``, a PNG.

The open3d objects are made only inside the open3d backend.
"""

from __future__ import annotations

import importlib
import os
from typing import Callable, Dict, Optional

import numpy as np

from . import raster
from .renderer import render_mesh_overlay


# named colours as matplotlib resolves them: its one-letter base colours and
# the CSS names below
_NAMED = {
    "b": (0.0, 0.0, 1.0), "g": (0.0, 0.5, 0.0), "r": (1.0, 0.0, 0.0), "c": (0.0, 0.75, 0.75),
    "m": (0.75, 0.0, 0.75), "y": (0.75, 0.75, 0.0), "k": (0.0, 0.0, 0.0), "w": (1.0, 1.0, 1.0),
    "red": "#FF0000", "green": "#008000", "blue": "#0000FF", "black": "#000000",
    "white": "#FFFFFF", "gray": "#808080", "grey": "#808080", "yellow": "#FFFF00",
    "cyan": "#00FFFF", "magenta": "#FF00FF", "orange": "#FFA500", "purple": "#800080",
    "pink": "#FFC0CB", "brown": "#A52A2A", "lime": "#00FF00", "navy": "#000080",
    "olive": "#808000", "teal": "#008080", "silver": "#C0C0C0", "gold": "#FFD700",
}


def _named_rgb(name: str) -> np.ndarray:
    """RGB in [0, 1] of a colour name of :data:`_NAMED` or a '#rrggbb' string."""
    spec = _NAMED.get(name.lower(), name)
    if isinstance(spec, tuple):
        return np.asarray(spec)
    if isinstance(spec, str) and len(spec) == 7 and spec[0] == "#":
        try:
            return np.asarray([int(spec[i:i + 2], 16) / 255.0 for i in (1, 3, 5)])
        except ValueError:
            pass
    raise ValueError(f"unknown colour {name!r}: one of {sorted(_NAMED)} or '#rrggbb'")


def _resolve_colors(pts: np.ndarray, colors) -> np.ndarray:
    """Per-point RGB in [0, 1] from the reference's accepted colour forms
    (viz_o3d_utils.py paint_color_on: None / str / 3-seq / (N, 3) array)."""
    if colors is None:
        return np.ones_like(pts) * 0.9
    if isinstance(colors, str):
        return np.ones_like(pts) * _named_rgb(colors)
    arr = np.asarray(colors, dtype=np.float64)
    if arr.ndim == 1 and arr.shape[0] == 3:
        arr = np.ones_like(pts) * arr.reshape(1, 3)
    elif not (arr.ndim == 2 and arr.shape == pts.shape):
        raise ValueError(f"unsupported color spec shape {arr.shape}")
    if arr.max() > 1.0:
        arr = arr / 255.0
    return arr


class VizContext:
    """Scene context with the reference VizContext surface.

    Headless additions: ``frames`` (list of rendered (H, W, 3) uint8
    turntable frames, most recent last), ``snapshot()``, ``trigger_key()``
    (drives key callbacks programmatically, replacing window key events).
    """

    def __init__(
        self,
        non_block: bool = False,
        backend: Optional[str] = None,
        image_size: int = 512,
        save_dir: Optional[str] = None,
        max_frames: int = 64,
    ):
        if backend is None:
            backend = "headless"
            if os.environ.get("DISPLAY"):
                try:
                    importlib.import_module("open3d")
                    backend = "open3d"
                except ImportError:
                    pass
        self.backend = backend
        self.non_block = non_block
        self.running = True
        self.geometry_to_viz: Dict[str, dict] = {}
        self._key_callbacks: Dict[str, Callable] = {}
        # headless state
        self.frames: list = []
        self._max_frames = max_frames
        self._step_count = 0
        self.image_size = image_size
        self.save_dir = save_dir
        if backend == "open3d":
            o3d = importlib.import_module("open3d")
            self._vis = o3d.visualization.VisualizerWithKeyCallback()
            self._vis.register_key_callback(ord("Q"), self._shutdown)
        else:
            self._vis = None
        self.register_key_callback("Q", self._shutdown)

    # -- lifecycle ----------------------------------------------------
    def _shutdown(self, *_):
        self.running = False

    def init(self, point_size: float = 10.0):
        self.point_size = point_size
        if self._vis is not None:
            self._vis.create_window()
            self._vis.get_render_option().point_size = point_size
            self._vis.get_render_option().background_color = np.ones(3)

    def deinit(self):
        if self._vis is not None:
            self._vis.destroy_window()

    def reset(self):
        self.remove_all_geometry()
        self.running = True

    def condition(self) -> bool:
        return self.running and (not self.non_block)

    # -- key events ---------------------------------------------------
    def register_key_callback(self, key: str, callback: Callable):
        self._key_callbacks[key.upper()] = callback
        if self._vis is not None:
            self._vis.register_key_callback(ord(key.upper()), callback)

    def trigger_key(self, key: str):
        """Headless stand-in for a window key event."""
        cb = self._key_callbacks.get(key.upper())
        if cb is not None:
            cb(self)

    # -- geometry -----------------------------------------------------
    def paint_color_on(self, pts, colors=None) -> np.ndarray:
        return _resolve_colors(np.asarray(pts, dtype=np.float64), colors)

    def update_by_mesh(self, geo_key, verts, faces, normals=None,
                       vcolors=None, update=True):
        if self.geometry_to_viz.get(geo_key) is not None and not update:
            return
        verts = np.asarray(verts, dtype=np.float64)
        faces = np.asarray(faces, dtype=np.int64)
        assert verts.ndim == 2 and verts.shape[1] == 3, verts.shape
        assert faces.ndim == 2 and faces.shape[1] == 3, faces.shape
        rec = {
            "type": "mesh",
            "verts": verts,
            "faces": faces,
            "colors": self.paint_color_on(verts, vcolors),
        }
        self._upsert(geo_key, rec)

    def update_by_pc(self, geo_key, pcs, normals=None, pcolors=None,
                     update=True):
        if self.geometry_to_viz.get(geo_key) is not None and not update:
            return
        pcs = np.asarray(pcs, dtype=np.float64)
        assert pcs.ndim == 2 and pcs.shape[1] == 3, pcs.shape
        rec = {
            "type": "pc",
            "verts": pcs,
            "colors": self.paint_color_on(pcs, pcolors),
        }
        self._upsert(geo_key, rec)

    def _upsert(self, geo_key, rec):
        exists = geo_key in self.geometry_to_viz
        self.geometry_to_viz[geo_key] = rec
        if self._vis is not None:
            o3d_geo = self._to_open3d(rec)
            rec["o3d"] = o3d_geo
            if exists:
                self._vis.update_geometry(o3d_geo)
            else:
                self._vis.add_geometry(o3d_geo)

    def _to_open3d(self, rec):
        o3d = importlib.import_module("open3d")
        if rec["type"] == "mesh":
            g = o3d.geometry.TriangleMesh()
            g.vertices = o3d.utility.Vector3dVector(rec["verts"])
            g.triangles = o3d.utility.Vector3iVector(rec["faces"])
            g.vertex_colors = o3d.utility.Vector3dVector(rec["colors"])
            g.compute_vertex_normals()
        else:
            g = o3d.geometry.PointCloud()
            g.points = o3d.utility.Vector3dVector(rec["verts"])
            g.colors = o3d.utility.Vector3dVector(rec["colors"])
        return g

    def remove_all_geometry(self):
        if self._vis is not None:
            for rec in self.geometry_to_viz.values():
                if "o3d" in rec:
                    self._vis.remove_geometry(rec["o3d"], reset_bounding_box=False)
        self.geometry_to_viz = {}

    # raw-geometry passthroughs (reference add_geometry/_list surface);
    # headless accepts records shaped like _upsert's
    def add_geometry(self, geo, key=None):
        if self._vis is not None:
            self._vis.add_geometry(geo)
        elif isinstance(geo, dict):
            self.geometry_to_viz[key or f"geo_{len(self.geometry_to_viz)}"] = geo

    def add_geometry_list(self, geo_list):
        for geo in geo_list:
            self.add_geometry(geo)

    def remove_geometry(self, geo):
        if self._vis is not None:
            self._vis.remove_geometry(geo)

    def remove_geometry_list(self, geo_list):
        for geo in geo_list:
            self.remove_geometry(geo)

    def update_geometry(self, geo):
        if self._vis is not None:
            self._vis.update_geometry(geo)

    def update_geometry_list(self, geo_list):
        for geo in geo_list:
            self.update_geometry(geo)

    # -- rendering ----------------------------------------------------
    def step(self):
        """One frame: window poll (open3d) or turntable render (headless)."""
        if self._vis is not None:
            self._vis.poll_events()
            self._vis.update_renderer()
            return
        azim = 15.0 * self._step_count
        frame = self.snapshot(azim_deg=azim)
        self._step_count += 1
        self.frames.append(frame)
        if len(self.frames) > self._max_frames:
            self.frames.pop(0)
        if self.save_dir:
            os.makedirs(self.save_dir, exist_ok=True)
            name = f"frame_{self._step_count:04d}.png"
            raster.write_png(os.path.join(self.save_dir, name), frame)

    def run(self, n_steps: int = 24):
        """Open3D: block in the window loop. Headless: render a full
        turntable (n_steps frames)."""
        if self._vis is not None:
            self._vis.run()
            return
        for _ in range(n_steps):
            if not self.running:
                break
            self.step()

    def snapshot(self, azim_deg: float = 30.0, elev_deg: float = 20.0) -> np.ndarray:
        """Render the scene from an orbit camera to (S, S, 3) uint8."""
        S = self.image_size
        canvas = np.full((S, S, 3), 255, np.uint8)
        all_pts = [r["verts"] for r in self.geometry_to_viz.values()]
        if not all_pts:
            return canvas
        pts = np.concatenate(all_pts, 0)
        center = pts.mean(0)
        radius = float(np.linalg.norm(pts - center, axis=1).max()) + 1e-6

        az, el = np.deg2rad(azim_deg), np.deg2rad(elev_deg)
        eye = center + 2.8 * radius * np.array(
            [np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)]
        )
        # look-at: camera +z towards the scene center
        z = center - eye
        z /= np.linalg.norm(z)
        up = np.array([0.0, 1.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_w2c = np.stack([x, y, z], 0)
        f = 1.2 * S
        K = np.array([[f, 0, S / 2.0], [0, f, S / 2.0], [0, 0, 1.0]])

        for rec in self.geometry_to_viz.values():
            v_cam = (rec["verts"] - eye) @ R_w2c.T
            if rec["type"] == "mesh":
                color = tuple(int(c * 255) for c in rec["colors"].mean(0))
                canvas = render_mesh_overlay(
                    canvas, v_cam, rec["faces"], K, color=color, alpha=1.0
                )
            else:
                z_ = np.clip(v_cam[:, 2], 1e-6, None)
                uv = (v_cam @ K.T)[:, :2] / z_[:, None]
                rad = max(1, int(getattr(self, "point_size", 4) * 0.4))
                for (u, v), c in zip(uv.astype(int), rec["colors"]):
                    if 0 <= u < S and 0 <= v < S:
                        raster.circle(canvas, (u, v), rad, tuple(int(ci * 255) for ci in c))
        return canvas
