"""Cross-sim evaluation of a trained policy in MuJoCo (port of the root
play_mujoco.py), through booster_gym_torch.eval.mujoco_eval:

    python -m booster_gym_torch.play_mujoco --task=T1 --checkpoint=PATH|-1 \
        [--seconds 10 --vx 0.4] [--video out.mp4] [--device cuda|cpu]
    python -m booster_gym_torch.play_mujoco --task=T1 --policy_pt=models/T1_walk.pt

--checkpoint is the port's model_<it>.pt or the JAX package's
model_<it>.ckpt (-1: the newest under ./logs); the actor's mean runs on
--device (cuda unless --device cpu) while MuJoCo steps on the CPU.
--policy_pt, a TorchScript actor, runs on the CPU and overrides
--checkpoint.  --mujoco_file replaces the config's MJCF (the same lookup
as the training CLI's).  Headless by default: scripted commands, the
height and displacement printed, and optionally a video of the run (needs
a GL backend).  --interactive opens MuJoCo's passive viewer with joystick
or keyboard commands (needs a display).
"""

import argparse

import numpy as np


def build_policy(args, cfg):
    """The policy callable of --policy_pt, else of --checkpoint."""
    from booster_gym_torch.eval.mujoco_eval import torch_policy, torchscript_policy

    if args.policy_pt:
        return torchscript_policy(args.policy_pt)
    from booster_gym_torch.algo.networks import ActorCritic
    from booster_gym_torch.algo.ppo import flat_params
    from booster_gym_torch.convert import train_state_from_jax_checkpoint
    from booster_gym_torch.runner import resolve_device
    from booster_gym_torch.utils.recorder import load_checkpoint, resolve_checkpoint

    env = cfg["env"]
    network = ActorCritic(env["num_actions"], env["num_observations"], env["num_privileged_obs"],
                          compute_dtype=cfg["algorithm"].get("compute_dtype", "bf16"))
    saved = load_checkpoint(resolve_checkpoint(args.checkpoint))
    if "opt_state" in saved:   # the JAX package's checkpoint
        saved = train_state_from_jax_checkpoint(network, saved)
    network.load_state_dict(saved["params"])
    return torch_policy(network, flat_params(network), resolve_device(args.device))


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--task", default="T1")
    parser.add_argument("--checkpoint", default="-1")
    parser.add_argument("--policy_pt", default=None,
                        help="TorchScript actor (.pt); overrides --checkpoint")
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--vx", type=float, default=0.4)
    parser.add_argument("--vy", type=float, default=0.0)
    parser.add_argument("--vyaw", type=float, default=0.0)
    parser.add_argument("--gait_frequency", type=float, default=1.5)
    parser.add_argument("--video", default=None, help="output mp4 path")
    parser.add_argument("--interactive", action="store_true")
    parser.add_argument("--no_joystick", action="store_true",
                        help="Force keyboard input in interactive mode.")
    parser.add_argument("--mujoco_file", type=str, default=None,
                        help="Robot MJCF in place of the config's (absolute, or relative to "
                             "the working directory or the repository).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device of the checkpoint's actor (cuda or cpu).")
    return parser.parse_args(argv)


def _render(ev, cfg, qpos, path):
    from booster_gym_torch.envs.t1 import _resolve_asset
    from booster_gym_torch.eval.render import render_states_to_video

    dt = ev.model.opt.timestep
    out = render_states_to_video(_resolve_asset(cfg["asset"]["mujoco_file"]),
                                 qpos[::max(1, int(1 / (50 * dt)))], path, fps=50)
    print(f"video written to {out}")


def interactive(ev, cfg, args):
    """The passive viewer: joystick if one is plugged in, else the keyboard
    map; v (or the X button) toggles state recording, rendered to --video
    on exit."""
    import mujoco.viewer

    from booster_gym_torch.eval.input_devices import CommandState, make_command_source

    state = CommandState(args.vx, args.vy, args.vyaw, args.gait_frequency)
    source, on_key_cmd = make_command_source(state, prefer_joystick=not args.no_joystick)
    saved, recording = None, {"on": False, "qpos": []}

    def on_key(keycode):
        if on_key_cmd is not None:
            on_key_cmd(keycode)

    with mujoco.viewer.launch_passive(ev.model, ev.data, key_callback=on_key) as viewer:
        while viewer.is_running():
            source.poll()
            if state.pop_flag("save_state"):
                saved = ev.save_state()
            if state.pop_flag("load_state") and saved is not None:
                ev.restore_state(saved)
            if state.pop_flag("reset"):
                ev.reset()
            if state.pop_flag("toggle_recording"):
                recording["on"] = not recording["on"]
                print("recording" if recording["on"]
                      else f"stopped ({len(recording['qpos'])} states)")
            ev.gait_frequency = state.gait_frequency
            ev.substep(state.cmd)
            if recording["on"]:
                recording["qpos"].append(ev.data.qpos.copy())
            viewer.cam.lookat[:] = ev.data.qpos[:3]
            viewer.sync()
    if recording["qpos"] and args.video:
        _render(ev, cfg, np.stack(recording["qpos"]), args.video)


def main(argv=None):
    args = parse_args(argv)
    from booster_gym_torch.eval.mujoco_eval import MujocoEval
    from booster_gym_torch.utils.config import load_task_cfg

    cfg = load_task_cfg(args.task)
    if args.mujoco_file:
        cfg["asset"]["mujoco_file"] = args.mujoco_file
    ev = MujocoEval(cfg, build_policy(args, cfg))
    if args.interactive:
        interactive(ev, cfg, args)
        return None

    traj = ev.run(args.seconds, commands=(args.vx, args.vy, args.vyaw),
                  gait_frequency=args.gait_frequency)
    qpos = traj["qpos"]
    h = qpos[:, 2]
    disp = qpos[-1, :2] - qpos[0, :2]
    print(f"ran {args.seconds:.1f}s  height min/mean: {h.min():.3f}/{h.mean():.3f}")
    print(f"displacement: {np.linalg.norm(disp):.2f} m "
          f"(commanded vx={args.vx} -> ideal {abs(args.vx) * args.seconds:.2f} m)")
    print("FELL" if h.min() < 0.4 else "stayed upright")
    if args.video:
        _render(ev, cfg, qpos, args.video)
    return traj


if __name__ == "__main__":
    main()
