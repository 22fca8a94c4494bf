"""Train a policy on the port:

    python -m booster_gym_torch.train --task=T1 [--terrain=plane] \
        [--num_envs N --max_iterations K --asset_file URDF] [--device cuda|cpu]

Without --terrain the task file's terrain is used (T1.yaml: trimesh).

Runs on cuda unless --device cpu; without a GPU and without --device cpu
it raises.
"""

from booster_gym_torch.runner import Runner
from booster_gym_torch.utils.config import build_cfg, parse_args


def main(argv=None):
    args = parse_args(argv)
    Runner(build_cfg(args), device=args.device).train()


if __name__ == "__main__":
    main()
