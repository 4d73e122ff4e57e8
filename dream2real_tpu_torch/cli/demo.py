"""The demo entry point of the port, with demo.py's argv:

    python -m dream2real_tpu_torch.cli.demo DATA_DIR OUT_DIR CFG INSTR \\
        [--goal_caption CAPTION] [--norm_captions CAPTION ...] [--device cuda|cpu]

DATA_DIR (read only) needs depth/, images/ and poses.txt (and optionally
seg_images/, masks/, transforms.json); it is copied into OUT_DIR, where
every artifact goes, unless OUT_DIR already holds images/. The cache flags
are checked for consistency, the three engine calls run, the stage timings
are printed and result.txt is written to the working directory.
"""

from __future__ import annotations

import argparse
import os
import shutil

from dream2real_tpu_torch.cfg import Config, validate_cache_flags
from dream2real_tpu_torch.engine import ImaginationEngine


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("data_dir", type=str, help="Raw scan data directory (read-only).")
    parser.add_argument("out_dir", type=str, help="Output/intermediate artifact directory.")
    parser.add_argument("cfg_path", type=str, help="Config JSON (variants/ablations).")
    parser.add_argument("user_instr", type=str, help="User instruction")
    parser.add_argument("--goal_caption", type=str, default=None)
    parser.add_argument("--norm_captions", type=str, nargs="+", default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda; cpu runs the plain versions)")
    return parser.parse_args(argv)


def prepare(args) -> Config:
    """Config of the run (artifacts under out_dir), the cache-flag asserts,
    and the copy of the scan into out_dir."""
    # out_dir, not data_dir: the raw scan is never written to.
    cfg = Config(args.cfg_path, args.out_dir)
    validate_cache_flags(cfg)
    if not os.path.isdir(args.data_dir):
        raise ValueError("data_dir does not exist.")
    os.makedirs(args.out_dir, exist_ok=True)
    if not os.path.isdir(os.path.join(args.out_dir, "images")):
        for name in os.listdir(args.data_dir):
            src = os.path.join(args.data_dir, name)
            dst = os.path.join(args.out_dir, name)
            if os.path.isdir(src):
                shutil.copytree(src, dst, dirs_exist_ok=True)
            else:
                shutil.copy2(src, dst)
    return cfg


def run(args, cfg: Config, **engine_kwargs):
    """The three engine calls -> (engine, task model, goal pose (4, 4))."""
    print(f"Running with config: {args.cfg_path}")
    imagination = ImaginationEngine(cfg, device=args.device, **engine_kwargs)
    imagination.build_scene_model()
    task_model = imagination.interpret_user_instr(
        args.user_instr, goal_caption=args.goal_caption, norm_captions=args.norm_captions
    )
    movable_best_pose = imagination.dream_best_pose(task_model)
    return imagination, task_model, movable_best_pose


def write_result(path: str, args, task_model, movable_best_pose) -> None:
    with open(path, "w") as f:
        f.write(f"user_instr: {args.user_instr}\n")
        f.write(f"goal_caption: {task_model.goal_caption}\n")
        f.write(f"norm_captions: {task_model.norm_captions}\n")
        f.write("goal_pose:\n")
        f.write(f"{movable_best_pose}\n")


def main(argv=None, **engine_kwargs):
    """Run the demo; ``engine_kwargs`` go to ImaginationEngine (backends,
    clip_loader, ngp_overrides). -> (engine, task model, goal pose (4, 4))."""
    args = parse_args(argv)
    cfg = prepare(args)
    imagination, task_model, movable_best_pose = run(args, cfg, **engine_kwargs)
    print("Predicted pose for movable object:")
    print(movable_best_pose)
    print("--- stage timings ---")
    print(imagination.stage_timer.report())
    write_result("result.txt", args, task_model, movable_best_pose)
    return imagination, task_model, movable_best_pose


if __name__ == "__main__":
    main()
