"""Live viewer for the port's engine (port of tools/view.py).

The reference's interactive viewer is PhysX-side (reference:
envs/base_task.py:81-94); here the port's env steps on --device and its
state is mirrored into a passive MuJoCo viewer each control step: the
picture is MuJoCo's, the physics the port's.

    python -m booster_gym_torch.tools.view --task=T1 [--checkpoint=PATH | --policy_pt=PATH]
        [--vx 0.4] [--vy 0] [--vyaw 0] [--device cuda|cpu]
        [--asset_file URDF --mujoco_file MJCF]

The window needs a display (MuJoCo is a lazy import: the card's machine
has no mujoco); mirror_state() is the part without one.  A checkpoint is
the port's model_<it>.pt or the JAX package's model_<it>.ckpt.  The robot
is --asset_file and --mujoco_file, else the task's stand-in (T1: the
T1-shaped robot and its MJCF; the serial tasks: the serial stand-in).
Runs on cuda unless --device cpu; without a card it exits non-zero.
"""

import argparse
import tempfile

from booster_gym_torch.tools import device_or_exit


def mirror_state(mujoco, model, data, state, i):
    """Env i's root pose and joint angles into MjData, then mj_forward."""
    data.qpos[0:3] = state.sim.root_pos[i].cpu().numpy()
    data.qpos[3:7] = state.sim.root_quat[i].cpu().numpy()   # wxyz, as MuJoCo's
    data.qpos[7:] = state.sim.q[i].cpu().numpy()
    mujoco.mj_forward(model, data)


def robot_files(task, asset_file, mujoco_file):
    """(urdf, mjcf): the given files, else the task's stand-ins written to a
    temporary directory."""
    if asset_file and mujoco_file:
        return asset_file, mujoco_file
    from booster_gym_torch import testing

    d = tempfile.mkdtemp(prefix="view_standin_")
    if task == "T1":
        return testing.write_t1_shaped_urdf(d), testing.write_t1_shaped_mjcf(d)
    return testing.write_t1_serial_urdf(d), testing.write_t1_serial_mjcf(d)


def start(cfg, device, command, checkpoint=None, policy_pt=None):
    """(env, env_params, state, obs, policy, gen): one env on the plane
    with the command held (no resampling), and the policy: a TorchScript
    actor on the CPU, a checkpoint's actor mean, or zero actions."""
    import torch

    from booster_gym_torch.envs import make_task

    env = make_task(cfg, device)
    gen = torch.Generator(device=device)
    params = env.init_params(gen.manual_seed(0))
    state, obs, _ = env.reset_all(params, gen.manual_seed(1))
    state = state.replace(
        commands=torch.tensor([command], dtype=torch.float32, device=device),
        gait_frequency=torch.full_like(state.gait_frequency, 1.5),
        cmd_resample_time=torch.full_like(state.cmd_resample_time, 10 ** 9))
    if policy_pt:
        from booster_gym_torch.eval.mujoco_eval import torchscript_policy

        pol = torchscript_policy(policy_pt)
        policy = lambda o: torch.as_tensor(pol(o[0].cpu().numpy())[None], device=device)
    elif checkpoint:
        from booster_gym_torch.algo.ppo import PPO
        from booster_gym_torch.tools import load_params
        from booster_gym_torch.utils.recorder import resolve_checkpoint

        ppo = PPO(env, cfg, device)
        load_params(ppo.network, resolve_checkpoint(checkpoint))
        policy = lambda o: ppo.network.act(o)[0]
    else:
        policy = lambda o: torch.zeros(1, env.num_actions, device=device)
    return env, params, state, obs, policy, gen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="T1")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--policy_pt", default=None)
    ap.add_argument("--vx", type=float, default=0.4)
    ap.add_argument("--vy", type=float, default=0.0)
    ap.add_argument("--vyaw", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--asset_file", default=None)
    ap.add_argument("--mujoco_file", default=None)
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)

    import mujoco
    import mujoco.viewer
    import torch

    from booster_gym_torch.utils.config import load_task_cfg

    cfg = load_task_cfg(args.task)
    cfg["env"]["num_envs"] = 1
    cfg["terrain"]["type"] = "plane"
    cfg["asset"]["file"], cfg["asset"]["mujoco_file"] = robot_files(
        args.task, args.asset_file, args.mujoco_file)
    env, params, state, obs, policy, gen = start(
        cfg, device, (args.vx, args.vy, args.vyaw), args.checkpoint, args.policy_pt)
    model = mujoco.MjModel.from_xml_path(cfg["asset"]["mujoco_file"])
    data = mujoco.MjData(model)
    with mujoco.viewer.launch_passive(model, data) as viewer, torch.no_grad():
        while viewer.is_running():
            state, obs, _, _, _ = env.step(params, state, policy(obs), gen)
            mirror_state(mujoco, model, data, state, 0)
            viewer.cam.lookat[:] = data.qpos[:3]
            viewer.sync()


if __name__ == "__main__":
    main()
