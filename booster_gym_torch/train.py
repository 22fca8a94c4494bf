"""Train a policy on the port:

    python -m booster_gym_torch.train --task=T1 [--terrain=plane] \
        [--num_envs N --max_iterations K --asset_file URDF] [--device cuda|cpu] \
        [--no_data_parallel]
    torchrun --nproc_per_node=N -m booster_gym_torch.train --task=T1 ...

Without --terrain the task file's terrain is used (T1.yaml: trimesh).

Runs on cuda unless --device cpu; without a GPU and without --device cpu
it raises.

Data parallelism over every GPU, as the JAX package's `python train.py`
uses the whole slice: on a machine with several cards this process starts
n ranks and waits for them, n the largest count of at most the cards that
divides num_envs, each rank on a card of its own over NCCL with num_envs /
n envs.  Under torchrun this process is one rank of its group.  With one
card, --device cpu, --no_data_parallel or basic.data_parallel: false it
trains in this process.
"""

import torch

from booster_gym_torch.parallel import configured, largest_world, launch
from booster_gym_torch.runner import Runner
from booster_gym_torch.utils.config import build_cfg, parse_args


def world_size(cfg, n_devices):
    """The launcher's rank count, with the JAX runner's messages
    (Runner._build_mesh): 1 under basic.data_parallel: false, else the
    largest count of at most n_devices that divides num_envs."""
    if cfg["basic"].get("data_parallel", True) is False:
        return 1
    B = cfg["env"]["num_envs"]
    n = largest_world(n_devices, B)
    if n > 1:
        if n < n_devices:
            print(f"data-parallel: num_envs={B} not divisible by {n_devices} devices; using {n}")
        else:
            print(f"data-parallel: {n} devices x {B // n} envs/device")
    return n


def train(cfg, device):
    """One process's training run: a rank of the group the environment
    configures, or the whole run."""
    Runner(cfg, device=device).train()


def main(argv=None):
    args = parse_args(argv)
    cfg = build_cfg(args)
    n = 1
    if (torch.device(args.device).type == "cuda" and torch.cuda.is_available()
            and not configured()):
        n = world_size(cfg, torch.cuda.device_count())
    if n == 1:
        train(cfg, args.device)
    else:
        launch(train, n, (cfg, args.device))


if __name__ == "__main__":
    main()
