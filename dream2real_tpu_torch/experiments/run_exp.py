"""Experiment / ablation runner (port of experiments/run_exp.py): the demo's
argv and flow, without result.txt, for the per-scene ablation configs
(configs/{shopping,pool,X,shelf}/*.json: physics_only, no_smooth, no_norm,
pcd, distract, vis_prior, dream2real_first).

    python -m dream2real_tpu_torch.experiments.run_exp DATA_DIR OUT_DIR CFG INSTR \\
        [--goal_caption CAPTION] [--norm_captions CAPTION ...] [--device cuda|cpu]
"""

from __future__ import annotations

from dream2real_tpu_torch.cli.demo import parse_args, prepare, run


def main(argv=None, **engine_kwargs):
    args = parse_args(argv)
    cfg = prepare(args)
    _, _, movable_best_pose = run(args, cfg, **engine_kwargs)
    print("Predicted pose for movable object:")
    print(movable_best_pose)
    return movable_best_pose


if __name__ == "__main__":
    main()
