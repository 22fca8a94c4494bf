"""T1 fall recovery (standup) on the 23-DoF serial robot, in plain PyTorch:
the benchmark's reference of booster_gym_torch/envs/standup.py.

The reference T1 (t1.py) with:
  * the robot's contact points from its MJCF's collision geoms
    (model/mjcf_points.py) on a tree of more DoF than actions;
  * 12 actions on the deploy stack's joint subset, at scale 1 around the
    default pose and clipped at +-clip_actions; every other joint holds
    its default;
  * the 42-dim deploy frame, stacked newest first in the state
    (obs_stack); a reset env's stack is its first frame throughout;
  * resets from the bank of settled fallen states with joint noise, a yaw
    turn and 2 cm of lift over the env's origin;
  * termination on timeout, velocity blow-up or a non-finite state, and
    non-finite frames, privileged observations and reward terms zeroed.

It runs in float32; the check turns TF32 off for it (check_train's
Reference.precision).

Departures from the program's standup.py:
  * No bank is built.  The settle (60 control steps of drops onto the
    plane) is chaotic, so the params, bank included, come from the
    program (Params' init_bank, converted by check_train.ref_params), and
    the bank is checked only through the steps that start from it.  There
    is no init_params of its own; _draw_fallen, _fallen_seed_states,
    _settle and the ladder are left out.
  * No data-parallel group: the batch is one process's, so the bank is
    not gathered.
  * _load_model loads the URDF and the MJCF's points once; the program
    loads the URDF twice (once for the DoF count).
  * The check's hooks (obs_sigmas, noise_free_obs, reset_terms) are the
    reference's own, for the 420 + 14 columns of this task.
"""

import dataclasses
import math

import torch

from gymbench.reference.envs.state import EnvParams, EnvState
from gymbench.reference.envs.t1 import T1, _resolve_asset
from gymbench.reference.math.quat import quat_from_euler_xyz, quat_mul
from gymbench.reference.model import load_urdf
from gymbench.reference.model.mjcf_points import with_mjcf_collision
from gymbench.reference.physics.types import SimState


@dataclasses.dataclass
class StandupParams(EnvParams):
    """EnvParams and the bank of settled fallen initial states."""

    init_bank: SimState = None      # fields [K, ...]


@dataclasses.dataclass
class StandupState(EnvState):
    """EnvState and the observation-frame stack, newest first."""

    obs_stack: torch.Tensor = None  # [B, train_stack, frame_obs]


def _nan_to_zero(x):
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


class T1Standup(T1):
    State = StandupState
    Params = StandupParams
    # the stack is left out: its newest frame carries the program's own
    # noise draws (noise_free_obs holds it to the noise's size); the
    # actions show the clip
    STATE_FIELDS = T1.STATE_FIELDS + ("actions",)

    def __init__(self, cfg, device, group=None):
        scfg = cfg["standup"]
        self.frame_obs = int(scfg["frame_obs"])
        self.train_stack = int(scfg["train_stack"])
        self.target_height = float(scfg["target_height"])
        self.action_clip = float(scfg.get("clip_actions", 5.0))
        super().__init__(cfg, device, group)
        if self.num_obs != self.frame_obs * self.train_stack:
            raise ValueError(f"num_observations must be frame_obs * train_stack = "
                             f"{self.frame_obs * self.train_stack}")
        if len(scfg["joint_indices"]) != self.num_actions:
            raise ValueError(f"{len(scfg['joint_indices'])} joint_indices, config asks for "
                             f"{self.num_actions} actions")
        self.action_indices = torch.as_tensor(scfg["joint_indices"], dtype=torch.int64,
                                              device=self.device)
        self.default_subset = self.default_dof_pos[self.action_indices]

    def _load_model(self, cfg):
        """The URDF's bodies and joints with the MJCF's collision geoms as
        contact points; more DoF than actions."""
        asset = cfg["asset"]
        if asset.get("collision_source") != "mjcf":
            raise ValueError("the reference T1Standup takes its contact points from the MJCF")
        model = load_urdf(_resolve_asset(asset["file"]),
                          cylinder_rim_points=int(asset.get("cylinder_rim_points", 6)))
        model = with_mjcf_collision(model, _resolve_asset(asset["mujoco_file"]))
        if model.num_dofs < self.num_actions:
            raise ValueError(f"asset has {model.num_dofs} dofs, fewer than the config's "
                             f"{self.num_actions} actions")
        return model

    # -- actions: the subset -> full-width PD targets ------------------------
    def _apply_actions(self, actions):
        actions = torch.clamp(actions, -self.action_clip, self.action_clip)
        targets = self.default_dof_pos.expand(actions.shape[0], self.model.num_dofs).clone()
        targets[:, self.action_indices] += self.cfg["control"]["action_scale"] * actions
        return actions, targets

    # -- resets from the bank ------------------------------------------------
    def _reset_envs(self, params, state, mask, gen):
        B, nd = self.num_envs, self.model.num_dofs
        bank = params.init_bank
        idx = self._randint(gen, 0, bank.q.shape[0], B)
        q_noise = -0.05 + 0.1 * self._rand(gen, B, nd)
        dyaw = self._rand(gen, B) * 2 * math.pi
        delay = self._randint(gen, 0, self.decimation, B)

        m1 = mask[:, None]
        q = torch.clamp(bank.q[idx] + q_noise, self.dof_lower, self.dof_upper)
        zero = torch.zeros(B, device=self.device)
        quat = quat_mul(quat_from_euler_xyz(zero, zero, dyaw), bank.root_quat[idx])
        pos = torch.cat([self.env_origins[:, :2] + self.base_init_pos[:2],
                         bank.root_pos[idx][:, 2:3] + 0.02], dim=-1)
        sim = SimState(
            root_pos=torch.where(m1, pos, state.sim.root_pos),
            root_quat=torch.where(m1, quat, state.sim.root_quat),
            root_lin_vel=torch.where(m1, 0.0, state.sim.root_lin_vel),
            root_ang_vel=torch.where(m1, 0.0, state.sim.root_ang_vel),
            q=torch.where(m1, q, state.sim.q),
            qd=torch.where(m1, 0.0, state.sim.qd))
        zero_i = torch.zeros_like(state.episode_length)
        return state.replace(
            sim=sim,
            actions=torch.where(m1, 0.0, state.actions),
            last_actions=torch.where(m1, 0.0, state.last_actions),
            last_dof_targets=torch.where(m1, q, state.last_dof_targets),
            last_root_vel=torch.where(m1, 0.0, state.last_root_vel),
            episode_length=torch.where(mask, zero_i, state.episode_length),
            filtered_lin_vel=torch.where(m1, 0.0, state.filtered_lin_vel),
            filtered_ang_vel=torch.where(m1, 0.0, state.filtered_ang_vel),
            cmd_resample_time=torch.where(mask, zero_i, state.cmd_resample_time),
            delay_steps=torch.where(mask, delay, state.delay_steps))

    # -- termination: timeout, velocity blow-up, a non-finite state ------------
    def _check_termination(self, state):
        root_vel6 = torch.cat([state.sim.root_lin_vel, state.sim.root_ang_vel], -1)
        reset = torch.sum(root_vel6 ** 2, dim=-1) > self.cfg["rewards"]["terminate_vel"]
        bad = ~(torch.isfinite(torch.sum(root_vel6, dim=-1))
                & torch.isfinite(torch.sum(state.sim.q, dim=-1))
                & torch.isfinite(state.sim.root_pos[:, 2]))
        time_out = state.episode_length > self.max_episode_length
        return state.replace(reset_buf=reset | bad | time_out, time_out_buf=time_out)

    # -- observations: the 42-dim deploy frame, stacked -------------------------
    def _zero_state(self):
        base = super()._zero_state()
        fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
        return StandupState(**fields, obs_stack=self._zeros(self.num_envs, self.train_stack,
                                                            self.frame_obs))

    def _frame(self, params, state, gen):
        """gravity, angular velocity, the subset's joint offsets and
        velocities, the actions; non-finite values zeroed."""
        ncfg, noise = self.cfg["normalization"], self.cfg["noise"]
        idx = self.action_indices
        return _nan_to_zero(torch.cat([
            self._randomize(gen, state.projected_gravity, noise.get("gravity"))
            * ncfg["gravity"],
            self._randomize(gen, state.base_ang_vel, noise.get("ang_vel")) * ncfg["ang_vel"],
            self._randomize(gen, state.sim.q[:, idx] - self.default_subset,
                            noise.get("dof_pos")) * ncfg["dof_pos"],
            self._randomize(gen, state.sim.qd[:, idx], noise.get("dof_vel")) * ncfg["dof_vel"],
            state.actions,
        ], dim=-1))

    def _observe(self, params, state, gen):
        frame = self._frame(params, state, gen)
        rolled = torch.cat([frame[:, None, :], state.obs_stack[:, :-1]], dim=1)
        stack = torch.where(state.reset_buf[:, None, None], frame[:, None, :], rolled)
        state = state.replace(obs_stack=stack)
        return state, stack.reshape(self.num_envs, self.num_obs), self._compute_privileged(
            params, state, gen)

    def _compute_privileged(self, params, state, gen):
        ncfg, noise = self.cfg["normalization"], self.cfg["noise"]
        height = state.sim.root_pos[:, 2] - state.terrain_height_root
        return _nan_to_zero(torch.cat([
            params.base_mass_scaled,
            self._randomize(gen, state.base_lin_vel, noise.get("lin_vel")) * ncfg["lin_vel"],
            self._randomize(gen, height, noise.get("height"))[:, None],
            state.push_force * ncfg["push_force"],
            state.push_torque * ncfg["push_torque"],
        ], dim=-1))

    # -- the check's hooks ---------------------------------------------------------
    def obs_sigmas(self):
        """Noise only on the newest frame's gravity, angular velocity and
        joint columns (the older frames come from the state); T1's
        privileged columns."""
        n, s = self.cfg["noise"], self.cfg["normalization"]
        na = self.num_actions
        sig = lambda key, scale, k: [n[key]["range"][1] * s[scale] if key in n else 0.0] * k
        newest = (sig("gravity", "gravity", 3) + sig("ang_vel", "ang_vel", 3)
                  + sig("dof_pos", "dof_pos", na) + sig("dof_vel", "dof_vel", na) + [0.0] * na)
        obs = newest + [0.0] * (self.num_obs - len(newest))
        height = [n["height"]["range"][1] if "height" in n else 0.0]
        priv = [0.0] * 4 + sig("lin_vel", "lin_vel", 3) + height + [0.0] * 6
        return obs, priv

    def noise_free_obs(self, params, state):
        """The newest frame of `state` without noise over the older frames
        of its stack, and the privileged observation without noise."""
        cfg = self.cfg
        self.cfg = {**cfg, "noise": {}}
        try:
            frame = self._frame(params, state, None)
            priv = self._compute_privileged(params, state, None)
        finally:
            self.cfg = cfg
        stack = torch.cat([frame[:, None, :], state.obs_stack[:, 1:]], dim=1)
        return stack.reshape(self.num_envs, self.num_obs), priv

    @staticmethod
    def reset_terms(s, r):
        """What a bank reset fixes whatever its draws, in an env that reset
        to `s` where the reference's reset to `r`: per env how far off zero
        the root and joint velocities, the episode length and the actions
        are and how far the stack's frames are from its first, and the root's
        x and y, at the env's origin in both.  Every term is finite even
        where the bank entry drawn is not: a reset sets them whatever the
        entry holds."""
        frames = s.obs_stack
        off = (s.sim.qd.abs().amax(1) + s.sim.root_lin_vel.abs().amax(1)
               + s.sim.root_ang_vel.abs().amax(1) + (s.episode_length != 0).float()
               + s.actions.abs().amax(1)
               + (frames - frames[:, :1]).abs().flatten(1).amax(1))
        return off, [(s.sim.root_pos[:, :2], r.sim.root_pos[:, :2])]

    # -- rewards: T1's terms, each non-finite value zeroed --------------------------
    def _compute_reward(self, params, state):
        _, terms = super()._compute_reward(params, state)
        terms = {k: _nan_to_zero(v) for k, v in terms.items()}
        total = sum(terms.values())
        if self.cfg["rewards"].get("only_positive_rewards", False):
            total = torch.clamp(total, min=0.0)
        return total, terms

    def _height_ratio(self, state):
        h = state.sim.root_pos[:, 2] - state.terrain_height_root
        return torch.clamp(h / self.target_height, 0.0, 1.0)

    def _reward_standup_height(self, params, state):
        return torch.square(self._height_ratio(state))

    def _reward_standup_upright(self, params, state):
        return (torch.square(0.5 * (1.0 - state.projected_gravity[:, 2]))
                * self._height_ratio(state))

    def _reward_standup_posture(self, params, state):
        err = torch.sum(torch.square(state.sim.q - self.default_dof_pos), dim=-1)
        return torch.exp(-err) * torch.clamp(-state.projected_gravity[:, 2], 0.0, 1.0)

    def _reward_standup_feet_load(self, params, state):
        fz = torch.sum(state.contact_forces[:, self.feet_indices, 2], dim=-1)
        weight = 9.81 * torch.sum(params.dyn.body_mass, dim=-1)
        return torch.clamp(fz / weight, 0.0, 1.0)

    def _reward_standup_success(self, params, state):
        h = state.sim.root_pos[:, 2] - state.terrain_height_root
        up = state.projected_gravity[:, 2] < -0.9
        tall = h > 0.9 * self.target_height
        slow = torch.sum(torch.square(state.sim.qd), dim=-1) < 5.0
        return (up & tall & slow).float()


TASKS = {"T1Standup": T1Standup}
