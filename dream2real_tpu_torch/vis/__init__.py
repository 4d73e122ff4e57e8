"""Visualisation exports (port of dream2real_tpu/vis): images and a
self-contained HTML viewer written to disk, with no imaging package."""
