"""Tiny copies of the cells for the CPU tests: the same files with the
sizes cut so that the port's plain versions and the reference run in
seconds on the CPU. Widths are cut here only; the cells never cut them."""

from __future__ import annotations

import copy

import torch

from benchmark import harness

TINY_CLIP = {"image_size": 56, "patch_size": 14, "vision_width": 128, "vision_layers": 2,
             "vision_heads": 2, "text_width": 64, "text_layers": 1, "text_heads": 1,
             "projection_dim": 32}


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    if tr["driver"] == "scoring_grid":
        cfg["clip"].update(TINY_CLIP)
        cfg["engine"].update(render_res=56, fg_crop=28, clip_batch=4)
        tr["grid"]["sample_res"] = [4, 4, 2, 1, 1, 1]
        tr.update(block_poses=8, warm_poses=4)
        tr["trace"].update(blocks=1, split_groups=1)
        tr["check"]["poses"] = 8
    elif tr["driver"] == "field_training":
        cfg["scan"].update(views=4, scale=0.05)
        cfg["train"].update(batch_rays=256, poll_steps=2)
        tr["trace"]["chunks"] = 1
    return harness.Cell(cell.name, cell.entry, cfg, tr, cell.end_to_end, cell.per_layer)


def tiny_ctx(name: str, seed: int = 7, trace: bool = False, seconds: float = 0.0):
    return harness.RunContext(cell=tiny_cell(name), seed=seed, seconds=seconds, trace=trace,
                              device=torch.device("cpu"), t_start=harness.now(),
                              log=lambda m: None)
