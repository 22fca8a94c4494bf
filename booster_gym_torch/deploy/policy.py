"""On-robot policy runtime wrappers.

WalkPolicy mirrors the reference's deploy-side actor wrapper
(reference: deploy/utils/policy.py): TorchScript actor inference with
command smoothing rate-clamped by the policy interval, a wall/sim-time gait
clock, the 47-dim obs layout identical to training, and action -> dof-target
mapping for the 12 leg joints of the 23-joint robot.

StandupPolicy mirrors deploy/utils/standup_policy.py: 50-frame stacked obs
over a 12-joint subset, with left/right mirror-symmetry averaging at
inference: act = 1/2 (pi(o) + M_act^-1 pi(M_obs o)).

Both load their TorchScript module with map_location="cpu" and run it on
the CPU, as the JAX package's wrappers do: this is the robot's runtime, one
observation per 20 ms, not a training entry point, so it takes no device
flag.
"""

import numpy as np

LEG_JOINT_START = 11  # first leg joint in SDK serial order (after head/arms/waist)


class WalkPolicy:
    def __init__(self, cfg, policy_path=None):
        import torch

        self.cfg = cfg
        path = policy_path or cfg["policy"]["policy_path"]
        self.module = torch.jit.load(path, map_location="cpu")
        self.module.eval()
        self._torch = torch

        pcfg = cfg["policy"]
        self.default_dof_pos = np.asarray(cfg["common"]["default_qpos"], np.float32)
        self.num_obs = pcfg["num_observations"]
        self.num_actions = pcfg["num_actions"]
        self.base_gait_frequency = pcfg["gait_frequency"]
        self.gait_frequency = self.base_gait_frequency
        self.gait_process = 0.0
        self.policy_interval = cfg["common"]["dt"] * pcfg["control"]["decimation"]
        self.commands = np.zeros(3, np.float32)
        self.smoothed_commands = np.zeros(3, np.float32)
        self.actions = np.zeros(self.num_actions, np.float32)
        self.dof_targets = self.default_dof_pos.copy()

    def inference(self, time_now, dof_pos, dof_vel, base_ang_vel, projected_gravity,
                  vx, vy, vyaw):
        n = self.cfg["policy"]["normalization"]
        self.gait_process = np.fmod(time_now * self.gait_frequency, 1.0)
        self.commands[:] = (vx, vy, vyaw)
        # rate-limit command changes to one policy interval per step
        # (deploy/utils/policy.py:39-40)
        clip = self.policy_interval
        self.smoothed_commands += np.clip(
            self.commands - self.smoothed_commands, -clip, clip)
        self.gait_frequency = (
            0.0 if np.linalg.norm(self.smoothed_commands) < 1e-5
            else self.base_gait_frequency)

        gait_on = float(self.gait_frequency > 1.0e-8)
        obs = np.zeros(self.num_obs, np.float32)
        obs[0:3] = projected_gravity * n["gravity"]
        obs[3:6] = base_ang_vel * n["ang_vel"]
        obs[6] = self.smoothed_commands[0] * n["lin_vel"] * gait_on
        obs[7] = self.smoothed_commands[1] * n["lin_vel"] * gait_on
        obs[8] = self.smoothed_commands[2] * n["ang_vel"] * gait_on
        obs[9] = np.cos(2 * np.pi * self.gait_process) * gait_on
        obs[10] = np.sin(2 * np.pi * self.gait_process) * gait_on
        legs = slice(LEG_JOINT_START, None)
        obs[11:23] = (dof_pos - self.default_dof_pos)[legs] * n["dof_pos"]
        obs[23:35] = dof_vel[legs] * n["dof_vel"]
        obs[35:47] = self.actions

        with self._torch.no_grad():
            out = self.module(self._torch.from_numpy(obs).unsqueeze(0))
        self.actions[:] = np.clip(
            out.squeeze(0).numpy(), -n["clip_actions"], n["clip_actions"])
        self.dof_targets[:] = self.default_dof_pos
        self.dof_targets[legs] += (
            self.cfg["policy"]["control"]["action_scale"] * self.actions)
        return self.dof_targets


def mirror_obs_matrix():
    """42x42 left/right mirror operator on the standup obs layout
    [grav(3), ang_vel(3), rel_pos(12), vel(12), prev_act(12)]
    (reference: deploy/utils/standup_policy.py:196-245)."""
    n = 42
    mat = np.zeros((n, n), np.float32)
    mat[0:6, 0:6] = np.eye(6)
    for base in (6, 18, 30):  # pos, vel, prev-action blocks
        mat[base:base + 2, base + 2:base + 4] = np.eye(2)
        mat[base + 2:base + 4, base:base + 2] = np.eye(2)
        mat[base + 4:base + 8, base + 8:base + 12] = np.eye(4)
        mat[base + 8:base + 12, base + 4:base + 8] = np.eye(4)
    flip = np.ones(n, np.float32)
    flip[[1, 3, 5, 7, 9, 11, 15, 19, 21, 23, 27, 31, 33, 35, 39]] = -1
    return mat @ np.diag(flip)


def mirror_act_matrix():
    """12x12 mirror operator on standup actions
    (reference: deploy/utils/standup_policy.py:247-270)."""
    n = 12
    mat = np.zeros((n, n), np.float32)
    mat[0:2, 2:4] = np.eye(2)
    mat[2:4, 0:2] = np.eye(2)
    mat[4:8, 8:12] = np.eye(4)
    mat[8:12, 4:8] = np.eye(4)
    flip = np.ones(n, np.float32)
    flip[[1, 3, 5, 9]] = -1
    return mat @ np.diag(flip)


class StandupPolicy:
    def __init__(self, cfg, policy_path=None):
        import torch

        self.cfg = cfg
        pcfg = cfg["policy"]
        path = policy_path or pcfg["standup_policy_path"]
        self.module = torch.jit.load(path, map_location="cpu")
        self.module.eval()
        self._torch = torch

        self.num_obs = pcfg["standup_num_observations"]
        self.num_actions = pcfg["standup_num_actions"]
        self.num_stack = pcfg["num_stack"]
        self.joint_indices = np.asarray(pcfg["standup_joint_indices"], int)
        self.full_default = np.asarray(cfg["common"]["default_qpos"], np.float32)
        self.default_subset = self.full_default[self.joint_indices]
        self.policy_interval = cfg["common"]["dt"] * pcfg["control"]["decimation"]
        self.actions = np.zeros(self.num_actions, np.float32)
        self.stacked_obs = np.zeros((self.num_stack, self.num_obs), np.float32)
        self.dof_targets = self.full_default.copy()
        self.first_inference = True
        self._mirror_obs = mirror_obs_matrix()
        self._mirror_act = mirror_act_matrix()
        # Reference interface mirror-averages the two lateral reflections
        # (deploy/utils/standup_policy.py:152-170) — correct ONLY for a
        # mirror-equivariant policy, where it is a variance reducer.  Our
        # shipped artifact learned an ASYMMETRIC get-up (a lateral roll);
        # averaging cancels the antisymmetric action components and parks
        # the robot in a symmetric tuck (in-engine wrapper probe: 25%
        # stand with averaging vs 100% without — tools/
        # standup_wrapper_probe.py).  The artifact's deploy config
        # therefore ships standup_mirror_average: false.
        self.mirror_average = bool(pcfg.get("standup_mirror_average", True))

    def inference(self, time_now, dof_pos, dof_vel, base_ang_vel, projected_gravity,
                  vx=0.0, vy=0.0, vyaw=0.0):
        n = self.cfg["policy"]["normalization"]
        na = self.num_actions
        obs = np.zeros(self.num_obs, np.float32)
        obs[0:3] = projected_gravity * n["gravity"]
        obs[3:6] = base_ang_vel * n["ang_vel"]
        obs[6:6 + na] = (dof_pos[self.joint_indices] - self.default_subset) * n["dof_pos"]
        obs[6 + na:6 + 2 * na] = dof_vel[self.joint_indices] * n["dof_vel"]
        obs[6 + 2 * na:6 + 3 * na] = self.actions

        if self.first_inference:
            self.stacked_obs[:] = obs[None, :]
            self.first_inference = False
        else:
            self.stacked_obs = np.roll(self.stacked_obs, shift=1, axis=0)
            self.stacked_obs[0] = obs

        torch = self._torch
        with torch.no_grad():
            a1 = self.module(
                torch.from_numpy(obs[None]),
                torch.from_numpy(self.stacked_obs[None]),
            ).squeeze(0).numpy()
            if self.mirror_average:
                m_obs = obs @ self._mirror_obs.T
                m_stack = self.stacked_obs @ self._mirror_obs.T
                a2_raw = self.module(
                    torch.from_numpy(m_obs[None].astype(np.float32)),
                    torch.from_numpy(m_stack[None].astype(np.float32)),
                ).squeeze(0).numpy()
        if self.mirror_average:
            a2 = a2_raw @ self._mirror_act.T
            final = 0.5 * (a1 + a2)
        else:
            final = a1
        self.actions[:] = np.clip(
            final, -n["standup_clip_actions"], n["standup_clip_actions"])

        scale = self.cfg["policy"]["control"]["action_scale"]
        self.dof_targets[:] = self.full_default
        self.dof_targets[self.joint_indices] += np.clip(
            scale * self.actions,
            -n["post_action_scale_clip_actions"], n["post_action_scale_clip_actions"])
        return self.dof_targets
