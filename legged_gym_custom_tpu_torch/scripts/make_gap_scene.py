"""Generate the round-5 acceptance MuJoCo scene: a plain-gap parkour course
(port of legged_gym_custom_tpu/scripts/make_gap_scene.py through the port's
task registry and deploy/scene_gen.py; the scene, its .hfield.npy and its
.meta.json are the JAX tool's).

The VERDICT r4 "Done" bar is "deterministic policy crosses >=3 gaps of
>=0.25 m with flight phases, in-engine AND in the MuJoCo oracle".  This tool
builds the same plain-gap course scripts/eval_parkour.py evaluates in-engine
(N gaps of a given width at x = 5, 8.5, ...), exports it as a MuJoCo
heightfield scene via deploy/scene_gen.py, and writes a sibling
`<name>.meta.json` with the gap far edges in MuJoCo world coordinates so the
oracle test (tests/test_parkour_deploy.py) can count crossings without
hard-coding the layout.

Run: python -m legged_gym_custom_tpu_torch.scripts.make_gap_scene \
        --out trained/go2_parkour_tpu_r5/gap_scene.xml \
        [--gap_width 0.3] [--n_gaps 6]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--task", default="go2_parkour_commit")
    ap.add_argument("--gap_width", type=float, default=0.3)
    ap.add_argument("--n_gaps", type=int, default=6)
    args = ap.parse_args(argv)

    from legged_gym_custom_tpu_torch.deploy import scene_gen
    from legged_gym_custom_tpu_torch.envs import task_registry

    env_cfg, _ = task_registry.get_cfgs(args.task)
    xs = [5.0 + 3.5 * k for k in range(args.n_gaps)]
    env_cfg.terrain.parkour_kwargs = dict(
        env_cfg.terrain.parkour_kwargs,
        x_positions=xs,
        y_positions=[0.0] * args.n_gaps,
        obstacle_heights=[-2.0] * args.n_gaps,
        obstacle_lengths=[args.gap_width] * args.n_gaps,
    )
    terrain, origin = scene_gen.build_parkour_play_terrain(env_cfg)
    # the robot spawns at MuJoCo (0,0) = course origin + the task's
    # init_state x offset (2 m onto the start platform)
    spawn = (origin[0] + env_cfg.init_state.pos[0], origin[1])
    scene_gen.write_heightfield_scene(
        terrain.height_field_raw,
        env_cfg.terrain.horizontal_scale,
        env_cfg.terrain.vertical_scale,
        spawn_xy=(float(spawn[0]), float(spawn[1])),
        out_path=args.out,
        name="lgc_r5_gap_course",
        border_size=env_cfg.terrain.border_size,
    )
    dx0 = env_cfg.init_state.pos[0]
    meta = {
        "course": "gaps",
        "gap_width": args.gap_width,
        "n_gaps": args.n_gaps,
        # MuJoCo world x of each gap's near and far edge (robot starts at 0),
        # by the JAX tool's formula x and x + w; the generator centres each
        # gap on x (terrain/primitives.py), so its cells span x -+ w / 2
        "gap_near_edges_mj": [round(x - dx0, 3) for x in xs],
        "gap_far_edges_mj": [round(x + args.gap_width - dx0, 3) for x in xs],
    }
    base = args.out[:-4] if args.out.endswith(".xml") else args.out
    with open(base + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
