"""The port's viztools (``poem_v2_tpu_torch/viztools``, ``training/draw_callback.py``)
against the JAX package's, which draw through OpenCV: the same inputs from a seed
give the same pixels, everywhere but where stated (the 3D skeleton panel, which
JAX plots with matplotlib, and the caption's letters, in another font)."""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from poem_v2_tpu.viztools import draw as JD, renderer as JR, wireframe as JW  # noqa: E402
from poem_v2_tpu.viztools import VizContext as JVizContext  # noqa: E402
from poem_v2_tpu_torch.viztools import draw as TD, renderer as TR, wireframe as TW  # noqa: E402
from poem_v2_tpu_torch.viztools import VizContext as TVizContext  # noqa: E402

INTR = np.array([[200.0, 0, 24], [0, 200.0, 24], [0, 0, 1]])


def _img(rs, h=48, w=56):
    return (rs.rand(h, w, 3) * 255).astype(np.uint8)


def _hand(rs, n=21, spread=0.02):
    return rs.randn(n, 3) * spread + [0, 0, 0.5]


def _uv(xyz):
    return (xyz @ INTR.T)[:, :2] / xyz[:, 2:3]


def test_joint_and_vertex_drawings_equal_jax():
    rs = np.random.RandomState(0)
    for _ in range(10):
        img = _img(rs)
        j2d = rs.rand(21, 2) * [70, 60] - 8
        for kw in ({}, {"color_override": (60, 60, 255), "radius": 1}, {"radius": 4}):
            np.testing.assert_array_equal(TD.draw_joints_2d(img, j2d, **kw),
                                          JD.draw_joints_2d(img, j2d, **kw))
        v2d = rs.rand(778, 2) * [70, 60] - 8
        np.testing.assert_array_equal(TD.draw_verts_2d(img, v2d), JD.draw_verts_2d(img, v2d))
    images = rs.rand(3, 32, 40, 3).astype(np.float32) - 0.5
    pred, gt = rs.rand(3, 21, 2) * 40, rs.rand(3, 21, 2) * 40
    np.testing.assert_array_equal(TD.denormalize_image(images), JD.denormalize_image(images))
    np.testing.assert_array_equal(TD.draw_batch_joint_images(pred, gt, images),
                                  JD.draw_batch_joint_images(pred, gt, images))
    pv, gv = rs.rand(3, 778, 2) * 40, rs.rand(3, 778, 2) * 40
    np.testing.assert_array_equal(TD.draw_batch_verts_images(pv, gv, images),
                                  JD.draw_batch_verts_images(pv, gv, images))
    views = (rs.rand(5, 8, 6, 3) * 255).astype(np.uint8)
    for cols in (1, 2, 4):
        np.testing.assert_array_equal(TD.tile_views(views, cols), JD.tile_views(views, cols))


def test_mesh_overlay_equals_jax():
    """The painter renderer face for face (tests/test_callbacks.py's tetrahedron and a
    random hand-sized mesh), alone and per view of a batch."""
    rs = np.random.RandomState(1)
    tetra = np.array([[0, 0, 0.5], [0.05, 0, 0.5], [0, 0.05, 0.55], [0.02, 0.02, 0.45]])
    tetra_f = np.array([[0, 1, 2], [0, 1, 3], [1, 2, 3], [0, 2, 3]])
    img = np.zeros((48, 48, 3), np.uint8)
    got = TR.render_mesh_overlay(img, tetra, tetra_f, INTR)
    np.testing.assert_array_equal(got, JR.render_mesh_overlay(img, tetra, tetra_f, INTR))
    assert got.sum() > 0
    verts = _hand(rs, 778)
    faces = rs.randint(0, 778, (1538, 3))
    for kw in ({}, {"color": (200, 40, 90), "alpha": 1.0}, {"light_dir": (0.0, -1.0, -0.5)}):
        img = _img(rs)
        np.testing.assert_array_equal(TR.render_mesh_overlay(img, verts, faces, INTR, **kw),
                                      JR.render_mesh_overlay(img, verts, faces, INTR, **kw))
    images = (rs.rand(2, 3, 48, 48, 3) * 255).astype(np.uint8)
    extr = np.tile(np.eye(4), (2, 3, 1, 1))
    extr[:, 1, :3, 3] = [0.02, 0.0, -0.05]
    mask = np.array([[True, True, False], [True, False, False]])
    vb = np.stack([verts, verts + 0.01])
    intrs = np.tile(INTR, (2, 3, 1, 1))
    np.testing.assert_array_equal(
        TR.draw_batch_mesh_images(images, vb, intrs, extr, faces, view_mask=mask),
        JR.draw_batch_mesh_images(images, vb, intrs, extr, faces, view_mask=mask))


def test_composite_equals_jax(tmp_path):
    """``save_a_image_with_mesh_joints``: [raw | skeleton | mesh] as JAX draws it, the
    file a PNG of the same pixels; the 3D skeleton panel is the port's own."""
    rs = np.random.RandomState(2)
    img = _img(rs, 48, 48)
    verts, joints = _hand(rs, 778), _hand(rs)
    faces = np.stack([np.arange(776), np.arange(1, 777), np.arange(2, 778)], 1)
    path = str(tmp_path / "comp.png")
    got = TD.save_a_image_with_mesh_joints(img, INTR, verts, faces, _uv(joints), joints, path)
    want = JD.save_a_image_with_mesh_joints(img, INTR, verts, faces, _uv(joints), joints,
                                            ret=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], got)
    g4 = TD.save_a_image_with_mesh_joints(img, INTR, verts, faces, _uv(joints), joints, ret=True,
                                          with_skeleton_3d=True)
    assert g4.shape == (48, 4 * 48, 3)
    np.testing.assert_array_equal(g4[:, :3 * 48], want)
    panel = g4[:, 3 * 48:]
    assert (panel < 250).any() and (panel == 255).all(-1).mean() > 0.5  # strokes on white


def test_3d_skeleton_panel_projects_at_the_view():
    """Not held to matplotlib's pixels: a white panel with the bones in their finger
    colours, and a different panel from another azimuth."""
    rs = np.random.RandomState(3)
    joints = _hand(rs, spread=0.05)
    a = TD.draw_3d_skeleton((96, 128), joints)
    assert a.shape == (96, 128, 3) and a.dtype == np.uint8
    colours = {tuple(c) for c in a.reshape(-1, 3)}
    assert sum(tuple(c) in colours for c in TD._FINGER_COLORS) >= 3
    assert (a != TD.draw_3d_skeleton((96, 128), joints, azim=30.0)).any()


@pytest.mark.parametrize("fn", ["draw_wireframe_hand", "draw_wireframe_hand_large",
                                "draw_wireframe_hand_kp", "draw_wireframe_hand_kp_large"])
def test_hand_wireframes_equal_jax(fn):
    rs = np.random.RandomState(4)
    for _ in range(6):
        img = _img(rs, 64, 80)
        joints = rs.rand(21, 2) * [100, 84] - 10
        mask = rs.rand(21) > 0.15
        for m in (None, mask):
            got, want = img.copy(), img.copy()
            getattr(TW, fn)(got, joints, m)
            getattr(JW, fn)(want, joints, m)
            np.testing.assert_array_equal(got, want)


def test_markerset_wireframes_and_generic_wireframe_equal_jax():
    rs = np.random.RandomState(5)
    for _ in range(6):
        img = _img(rs, 64, 80)
        for fn, n in (("draw_wireframe_markerset_body", 19),
                      ("draw_wireframe_markerset_hand", 10)):
            pts = rs.rand(n, 2) * [100, 84] - 10
            got, want = img.copy(), img.copy()
            getattr(TW, fn)(got, pts)
            getattr(JW, fn)(want, pts)
            np.testing.assert_array_equal(got, want)
        pts = rs.rand(8, 2) * [90, 74] - 5
        kw = dict(vert_color=rs.rand(8, 3), edge_color=rs.rand(3), vert_size=[2, 3] * 4,
                  edge_size=3, vert_type=["star", "square", "circle", "diamond", "triangle_up",
                                          "blob", "star", "square"],
                  vert_thickness=2, vert_mask=rs.rand(8) > 0.2)
        got, want = img.copy(), img.copy()
        TW.draw_wireframe(got, pts, TW.EDGE_LIST_BBOX, **kw)
        JW.draw_wireframe(want, pts, JW.EDGE_LIST_BBOX, **kw)
        np.testing.assert_array_equal(got, want)


def test_tiling_helpers_and_blend_equal_jax():
    rs = np.random.RandomState(6)
    views = [(rs.rand(10, 12, 3) * 255).astype(np.uint8) for _ in range(7)]
    for ncol in (None, 2, 3):
        np.testing.assert_array_equal(TW.combine_view(views, ncol), JW.combine_view(views, ncol))
    for pos in ((5, 7), (30, 25), (13, 41)):
        assert TW.decaption_pos(pos) == JW.decaption_pos(pos)
        assert TW.get_combined_image_offset(pos, (10, 12), 7) == \
            JW.get_combined_image_offset(pos, (10, 12), 7)
        assert TW.get_combined_image_pos(pos, (10, 12)) == JW.get_combined_image_pos(pos, (10, 12))
        for off in (0, 3, 5):
            assert TW.get_combined_image_pos_fix_offset(pos, (10, 12), off, 7) == \
                JW.get_combined_image_pos_fix_offset(pos, (10, 12), off, 7)
            assert TW.offset_combined_image_pos(pos, (10, 12), off, 7, ncol=3) == \
                JW.offset_combined_image_pos(pos, (10, 12), off, 7, ncol=3)
    img = _img(rs, 20, 24)
    mask = rs.rand(20, 24) > 0.5
    np.testing.assert_array_equal(TW.blend_mask(img, mask), JW.blend_mask(img, mask))
    got = TW.blend_mask(img, mask, True, np.random.default_rng(1))
    np.testing.assert_array_equal(got, JW.blend_mask(img, mask, True, np.random.default_rng(1)))
    for name in ("EDGE_LIST_HAND", "VERT_COLOR_HAND", "EDGE_COLOR_HAND", "VERT_TYPE_HAND",
                 "EDGE_LIST_HAND_KP", "EDGE_LIST_MARKERSET_BODY", "VERT_COLOR_MARKERSET_BODY",
                 "EDGE_COLOR_MARKERSET_BODY", "EDGE_LIST_MARKERSET_HAND",
                 "VERT_COLOR_MARKERSET_HAND", "EDGE_COLOR_MARKERSET_HAND", "EDGE_LIST_BBOX",
                 "CAPTION_HEIGHT"):
        np.testing.assert_array_equal(np.asarray(getattr(TW, name)), np.asarray(getattr(JW, name)))


def test_caption_banner_geometry_equals_jax():
    """The banner's size, place and white ground are JAX's; the letters are the
    port's stroke font (not held to OpenCV's Hershey pixels), dark, and start near
    JAX's text origin (20, 21)."""
    img = _img(np.random.RandomState(7), 40, 200)
    for caption in ("", "view 3 / pred 12.5mm"):
        got, want = TW.caption_combined_view(img, caption), JW.caption_combined_view(img, caption)
        assert got.shape == want.shape == (70, 200, 3)
        np.testing.assert_array_equal(got[30:], want[30:])
        ink = (got[:30] < 128).all(-1)
        if caption:
            ys, xs = np.nonzero(ink)
            assert 18 <= xs.min() <= 22 and ys.max() <= 23 and ys.min() >= 6
        else:
            assert (got[:30] == 255).all() and (want[:30] == 255).all()


TETRA_V = np.array([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.0, 0.1, 0.0], [0.0, 0.0, 0.1]])
TETRA_F = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]])


def _scene(ctx_cls, **kw):
    ctx = ctx_cls(backend="headless", image_size=128, **kw)
    ctx.init(point_size=6.0)
    ctx.update_by_mesh("hand", TETRA_V, TETRA_F, vcolors="red")
    rng = np.random.RandomState(0)
    ctx.update_by_pc("bps", rng.uniform(-0.05, 0.15, (64, 3)), pcolors=(0, 255, 0))
    return ctx


def test_viz_context_frames_equal_jax(tmp_path):
    """tests/test_viz_context.py's scene: the turntable frames pixel for pixel, and
    the saved frames as PNGs of the same pixels."""
    got = _scene(TVizContext, save_dir=str(tmp_path))
    want = _scene(JVizContext)
    got.run(n_steps=3)
    want.run(n_steps=3)
    assert len(got.frames) == 3
    for g, w in zip(got.frames, want.frames):
        np.testing.assert_array_equal(g, w)
        assert (g < 250).any()
    assert (got.frames[0] != got.frames[1]).any()  # a turntable
    saved = sorted(os.listdir(tmp_path))
    assert saved == ["frame_0001.png", "frame_0002.png", "frame_0003.png"]
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / saved[0]))[..., ::-1], got.frames[0])
    for az in (0.0, 75.0):
        np.testing.assert_array_equal(got.snapshot(az), want.snapshot(az))


def test_viz_context_surface_matches_jax():
    """Colour forms (named colours as matplotlib resolves them), update and remove,
    key callbacks and the loop condition."""
    import matplotlib.colors as mcolors

    from poem_v2_tpu_torch.viztools.viz_context import _NAMED

    ctx = TVizContext(backend="headless", image_size=64)
    jctx = JVizContext(backend="headless", image_size=64)
    pts = np.zeros((5, 3))
    for spec in (None, "blue", (255, 0, 0), np.linspace(0, 1, 15).reshape(5, 3), "#3366cc"):
        np.testing.assert_allclose(ctx.paint_color_on(pts, spec), jctx.paint_color_on(pts, spec))
    for name in _NAMED:
        np.testing.assert_allclose(ctx.paint_color_on(pts, name)[0], mcolors.to_rgb(name),
                                   err_msg=name)
    with pytest.raises(ValueError):
        ctx.paint_color_on(pts, np.zeros((7, 3)))
    with pytest.raises(ValueError):
        ctx.paint_color_on(pts, "not-a-colour")
    ctx.update_by_mesh("m", TETRA_V, TETRA_F)
    ctx.update_by_mesh("m", TETRA_V + 1.0, TETRA_F)
    ctx.update_by_mesh("m", TETRA_V, TETRA_F, update=False)  # a no-op on an existing key
    assert np.allclose(ctx.geometry_to_viz["m"]["verts"], TETRA_V + 1.0)
    ctx.remove_all_geometry()
    assert not ctx.geometry_to_viz and (ctx.snapshot() == 255).all()
    hits = []
    ctx.register_key_callback("A", lambda v: hits.append(1))
    ctx.trigger_key("a")
    ctx.trigger_key("Q")
    assert hits == [1] and not ctx.condition()
    ctx.reset()
    assert ctx.condition() and not TVizContext(backend="headless", non_block=True).condition()


def fake_preds_batch(B=2, V=2):
    """tests/test_callbacks.py's predictions and batch, the hand 0.5 m in front."""
    rs = np.random.RandomState(0)
    preds = {"pred_joints_3d": rs.randn(B, 21, 3) * 0.01,
             "pred_verts_3d": rs.randn(B, 778, 3) * 0.01,
             "pred_joints_3d_rel": rs.randn(B, 21, 3) * 0.01,
             "pred_verts_3d_rel": rs.randn(B, 778, 3) * 0.01}
    batch = {"image": rs.rand(B, V, 32, 32, 3).astype(np.float32) - 0.5,
             "view_mask": np.ones((B, V), bool),
             "cam_intr": np.tile(np.eye(3, dtype=np.float32) * 100, (B, V, 1, 1)),
             "cam_extr": np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1)),
             "master_joints_3d": preds["pred_joints_3d"] + 0.001,
             "master_verts_3d": preds["pred_verts_3d"] + 0.001}
    for k in ("pred_joints_3d", "pred_verts_3d"):
        preds[k][..., 2] += 0.5
    for k in ("master_joints_3d", "master_verts_3d"):
        batch[k][..., 2] += 0.5
    batch["cam_intr"][..., 0, 2] = batch["cam_intr"][..., 1, 2] = 16.0
    batch["cam_intr"][..., 2, 2] = 1.0
    return preds, batch


@pytest.mark.parametrize("render_mesh,composites", [(False, True), (True, False)])
def test_drawing_callback_equals_jax(tmp_path, monkeypatch, render_mesh, composites):
    """The port's callback, fed the batch as tensors (as the Evaluator feeds it),
    writes the JAX callback's artifact set with the same pixels: a tiled grid per
    sample and, with composites, a predicted and a ground-truth composite per
    valid view (PNGs here, JPEGs there: JAX's are captured before encoding)."""
    import poem_v2_tpu.viztools.draw as jdraw
    from poem_v2_tpu.training.draw_callback import DrawingHandCallback as JCallback
    from poem_v2_tpu_torch.training.draw_callback import DrawingHandCallback as TCallback

    composites_seen = {}
    real = jdraw.save_a_image_with_mesh_joints

    def capture(*a, **kw):
        grid = real(*a, **{**kw, "ret": True})
        composites_seen[os.path.basename(a[6])] = grid
        return grid

    monkeypatch.setattr(jdraw, "save_a_image_with_mesh_joints", capture)
    preds, batch = fake_preds_batch()
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    kw = dict(max_samples=2, render_mesh=render_mesh, composites=composites)
    jcb, tcb = JCallback(exp_dir=str(jdir), **kw), TCallback(exp_dir=str(tdir), **kw)
    np.testing.assert_array_equal(tcb.faces, np.asarray(jcb.faces))
    jcb(preds, batch, 0)
    tcb(preds, {k: torch.as_tensor(v) for k, v in batch.items()}, 0)
    got = sorted(os.listdir(tdir / "draws"))
    grids = [f for f in got if f.startswith("step00000_s")]
    assert grids == ["step00000_s0.png", "step00000_s1.png"]
    for f in grids:
        np.testing.assert_array_equal(cv2.imread(str(tdir / "draws" / f)),
                                      cv2.imread(str(jdir / "draws" / f)), err_msg=f)
    comps = [f for f in got if f not in grids]
    assert len(comps) == (8 if composites else 0)
    assert sorted(f[:-4] for f in comps) == sorted(f[:-4] for f in composites_seen)
    assert sum(f.endswith("_GT.png") for f in comps) == (4 if composites else 0)
    for f in comps:
        np.testing.assert_array_equal(cv2.imread(str(tdir / "draws" / f))[..., ::-1],
                                      composites_seen[f[:-4] + ".jpg"], err_msg=f)
    tcb(preds, {k: torch.as_tensor(v) for k, v in batch.items()}, 1)  # max_samples reached
    assert sorted(os.listdir(tdir / "draws")) == got
