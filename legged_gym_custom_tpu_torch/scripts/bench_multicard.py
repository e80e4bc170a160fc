"""The worker over nccl across the cards of one machine, one rank a card,
against one process on cuda:0.

Four runs of `scripts/multihost_worker.py` on go2, in this order:
world 1 at `--num_envs` global envs; world `--cards` at the same count
(strong scaling); world `--cards` at `--cards` x `--num_envs` (weak scaling,
the same envs a card as world 1); world 1 again, so that the first and the
last run bracket the drift of the card's clock.  Each rank runs with
`--device cuda`, so rank i takes cuda:i and the backend rule gives nccl.
Every run is checked: the backend, K1 (`fused_control_step`) launched
exactly 1 + T x (warmup + iterations) times a rank and nothing else, finite
losses, the checkpoint's iteration restored, the parameters bit-equal across
ranks.  Prints each card's name and power limit, one JSON line a run and a
summary line of global env-steps/s against world 1's; exits 1 on a failed
check.

    python -m legged_gym_custom_tpu_torch.scripts.bench_multicard --cards 4 \\
        --num_envs 4096 --iterations 2 --warmup 1 [--out logs/multicard.json]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile

TASK = "go2"
RUN_TIMEOUT_S = 600.0

def card_lines() -> list:
    """`name, power.limit` of every card, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()


def run_world(world: int, num_envs: int, args, ckpt_root: str) -> dict:
    """One run of `world` ranks, one a card; its result line and the checks."""
    from legged_gym_custom_tpu_torch.envs import task_registry
    from legged_gym_custom_tpu_torch.scripts.multihost_worker import launch

    steps = task_registry.get_cfgs(TASK)[1].runner.num_steps_per_env
    ckpt_dir = os.path.join(ckpt_root, f"world{world}_{num_envs}")
    os.makedirs(ckpt_dir, exist_ok=True)
    r, _ = launch(world, ["--task", TASK, "--num_envs", str(num_envs),
                          "--iterations", str(args.iterations), "--warmup", str(args.warmup),
                          "--ckpt_dir", ckpt_dir, "--device", "cuda"], timeout=RUN_TIMEOUT_S)
    expected = {"fused_control_step": 1 + steps * (args.iterations + args.warmup)}
    checks = {
        "backend_nccl": r["backend"] == "nccl",
        "one_card_a_rank":
            [k["device"] for k in r["ranks"]] == [f"cuda:{i}" for i in range(world)],
        "k1_launches_exact": all(k["launches"] == expected for k in r["ranks"]),
        "losses_finite": all(k["losses_finite"] for k in r["ranks"])
        and math.isfinite(r["value_loss"]),
        "restored": r["restored_iteration"] == args.iterations + args.warmup,
        "params_bit_equal": r["params_bit_equal"],
    }
    return {"world": world, "num_envs": num_envs, "fps": r["fps"],
            "collection_s": r["collection_s"], "learning_s": r["learning_s"],
            "backend": r["backend"], "launches": [k["launches"] for k in r["ranks"]],
            "update_collectives": r["collectives"]["update"], "checks": checks,
            "ok": all(checks.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=None, help="ranks of the N-card runs "
                    "(default: every card of the machine)")
    ap.add_argument("--num_envs", type=int, default=4096, help="global envs of world 1")
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--out", default=None, help="write the runs as JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_multicard: no CUDA device", file=sys.stderr)
        return 2
    cards = args.cards or torch.cuda.device_count()
    if cards < 2 or cards > torch.cuda.device_count():
        print(f"bench_multicard: needs 2 to {torch.cuda.device_count()} cards, asked {cards}",
              file=sys.stderr)
        return 2
    for line in card_lines():
        print(f"card: {line}", flush=True)
    runs = []
    with tempfile.TemporaryDirectory(prefix="lgc_multicard_") as ckpt_root:
        for world, num_envs in ((1, args.num_envs), (cards, args.num_envs),
                                (cards, cards * args.num_envs), (1, args.num_envs)):
            runs.append(run_world(world, num_envs, args, ckpt_root))
            print(json.dumps(runs[-1]), flush=True)
    base = [r["fps"] for r in runs if r["world"] == 1]
    summary = {"cards": cards, "task": TASK, "world1_fps": base,
               "strong_scaling_x": [runs[1]["fps"] / b for b in base],
               "weak_scaling_efficiency": [runs[2]["fps"] / (cards * b) for b in base],
               "ok": all(r["ok"] for r in runs)}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"cards_nvidia_smi": card_lines(), "runs": runs, "summary": summary}, f,
                      indent=1)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
