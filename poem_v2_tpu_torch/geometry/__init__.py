"""Camera, heatmap and triangulation math in float32 (no TF32 anywhere)."""
