"""Preprocessing of the port: `compute_bbox`, a scene AABB from COLMAP."""
