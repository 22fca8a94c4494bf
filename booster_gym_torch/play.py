"""Play a trained policy in the training sim (port of play.py):

    python -m booster_gym_torch.play --task=T1 --checkpoint=PATH|-1 \
        [--terrain=plane] [--num_envs N --asset_file URDF] [--device cuda|cpu]

PATH is the port's model_<it>.pt or the JAX package's model_<it>.ckpt.
Steps 10 s of control steps with the actor's mean and prints the mean
reward per step, then the steps' rate (CUDA events on a GPU, the host
clock on the CPU).  Runs on cuda unless --device cpu.  Under
viewer.record_video (T1.yaml: true) env viewer.record_env_idx's states
are rendered offline to videos/<time>.mp4 by eval/render.py (MuJoCo's
offscreen renderer on the asset's MJCF); without mujoco or a GL backend
it prints why there is no video.
"""

import numpy as np

from booster_gym_torch.runner import Runner, _Timer
from booster_gym_torch.utils.config import build_cfg, parse_args


def main(argv=None):
    args = parse_args(argv)
    cfg = build_cfg(args)
    cfg["basic"]["data_parallel"] = False     # play runs in this one process
    runner = Runner(cfg, device=args.device)
    timer = _Timer(runner.device)
    traj = runner.play(timer=timer)
    rews = np.stack([t["rew"] for t in traj])
    print(f"played {len(traj)} steps, mean reward/step: {rews.mean():.4f}")
    ms = timer.ms("steps", "end")
    print(f"{len(traj) / (ms / 1e3):,.1f} steps/s ({rews.size / (ms / 1e3):,.0f} env-steps/s) "
          f"on {runner.device}")
    if cfg["viewer"].get("record_video", False):
        try:
            from booster_gym_torch.eval.render import render_trajectory

            path = render_trajectory(cfg, traj, env_idx=cfg["viewer"].get("record_env_idx", 0))
            print(f"video written to {path}")
        except Exception as e:
            print(f"video rendering unavailable: {e}")
    return traj


if __name__ == "__main__":
    main()
