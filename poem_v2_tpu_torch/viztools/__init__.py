"""Visualisation on the host (counterpart of ``poem_v2_tpu/viztools``): skeleton and
mesh overlays, wireframes and the headless scene context, drawn by the port's
raster core (:mod:`.raster`) without OpenCV."""

from .draw import (HAND_LINKS, denormalize_image, draw_batch_joint_images, draw_batch_verts_images,
                   draw_joints_2d, draw_verts_2d, tile_views)
from .renderer import draw_batch_mesh_images, render_mesh_overlay
from .viz_context import VizContext
from .wireframe import (blend_mask, caption_combined_view, combine_view, draw_wireframe,
                        draw_wireframe_hand, draw_wireframe_hand_kp, draw_wireframe_hand_kp_large,
                        draw_wireframe_hand_large, draw_wireframe_markerset_body,
                        draw_wireframe_markerset_hand)
