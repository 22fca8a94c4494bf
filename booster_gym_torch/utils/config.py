"""Config loading and CLI overrides (port of
booster_gym_tpu/utils/config.py plus --device and --asset_file; without
--no_data_parallel: the port trains on one device).

The port reads its own copy of envs/configs/<task>.yaml, and follows its
algorithm.update_backend (T1.yaml: fused) as the JAX package does.
"""

import argparse
import os

import yaml

_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "envs", "configs")


def load_task_cfg(task):
    path = os.path.join(_CONFIG_DIR, f"{task}.yaml")
    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--task", required=True, type=str, help="Name of the task to run.")
    parser.add_argument("--checkpoint", type=str, help="Checkpoint path (-1 for newest).")
    parser.add_argument("--num_envs", type=int, help="Number of environments.")
    parser.add_argument("--headless", type=bool, help="Run without visualization.")
    parser.add_argument("--seed", type=int, help="Random seed.")
    parser.add_argument("--max_iterations", type=int, help="Training iterations.")
    parser.add_argument("--terrain", type=str, help="Override terrain type (plane or trimesh).")
    parser.add_argument("--profile", nargs="?", const=True, default=None,
                        help="Capture a torch.profiler trace (optional dir).")
    parser.add_argument("--asset_file", type=str, help="Robot URDF (absolute path, or "
                        "relative to the working directory or the repository).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu.")
    return parser.parse_args(argv)


def build_cfg(args):
    cfg = load_task_cfg(args.task)
    if getattr(args, "profile", None) is not None:
        cfg["basic"]["profile"] = args.profile
    for key in ("checkpoint", "headless", "seed", "max_iterations"):
        val = getattr(args, key, None)
        if val is not None:
            cfg["basic"][key] = val
    if getattr(args, "num_envs", None) is not None:
        cfg["env"]["num_envs"] = args.num_envs
    if getattr(args, "terrain", None) is not None:
        cfg["terrain"]["type"] = args.terrain
    if getattr(args, "asset_file", None) is not None:
        cfg["asset"]["file"] = args.asset_file
    cfg["basic"]["task"] = args.task
    return cfg
