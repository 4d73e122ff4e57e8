"""Point-cloud visual models and their splat renderer (port of
dream2real_tpu/pcd, the ``pcd.json`` ablation path)."""
