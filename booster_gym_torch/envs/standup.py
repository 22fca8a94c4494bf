"""T1 fall-recovery (standup) task on the 23-DoF serial model (port of
booster_gym_tpu/envs/standup.py).

The same task scaffolding as T1 (physics, PD and delay, resets, rewards)
on the serial robot, with:
  * 12 actions on the deploy stack's joint subset, applied at scale 1
    around the default pose and clipped at +-clip_actions; every other
    joint holds its default;
  * the deploy wrapper's 42-dim observation frame, stacked newest first;
    the actor sees the newest train_stack frames, and a reset env's stack
    is filled with its first frame;
  * episodes that start from a bank of settled fallen states, built once
    in init_params: random drops settled for settle_rounds control steps
    (one control-step launch each on the kernel path), a quarter of the
    bank replaced by a standing-to-squat ladder; resets draw from the bank
    with fresh pose noise and yaw;
  * five standup rewards beside T1's smoothness penalties, and termination
    on timeout, velocity blow-up or a non-finite state only.

Random draws come from the env's torch.Generator.  Each random step is a
draw (_draw_fallen, _draw_reset: a dict of the values drawn) and a
function of the draws (_fallen_seed_states, _reset_from_bank), so that the
tests can hand both packages the same values.

Under a data-parallel Group the draws are the global batch's, sliced, as
in T1; the tucked drops and the ladder follow the global env index, each
rank settles its slice of the bank with its own launches, and the slices
are gathered into the whole bank on every rank, from which any env resets
(the JAX package's bank is one [B, ...] leaf that its resets gather from).
"""

import copy
import dataclasses
import math
import types

import torch

from booster_gym_torch.envs.state import EnvParams, EnvState
from booster_gym_torch.envs.t1 import T1, _resolve_asset
from booster_gym_torch.math.quat import quat_from_euler_xyz, quat_mul
from booster_gym_torch.model import load_urdf
from booster_gym_torch.physics import SimState
from booster_gym_torch.utils.spans import span

# the squat of the bank's ladder and of the tucked drops: radians added to
# these joints at full depth
_BEND = {"Hip_Pitch": -1.4, "Knee_Pitch": 2.2, "Ankle_Pitch": -0.8}


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
    def __init__(self, cfg, device, group=None):
        scfg = cfg["standup"]
        self.frame_obs = int(scfg["frame_obs"])
        self.train_stack = int(scfg["train_stack"])
        self.deploy_stack = int(scfg["deploy_stack"])
        self.target_height = float(scfg["target_height"])
        self.settle_rounds = int(scfg.get("settle_rounds", 50))
        self.action_clip = float(scfg.get("clip_actions", 5.0))
        # the base env is built full width (actions = dofs); the subset
        # applies on top
        base_cfg = copy.deepcopy(cfg)
        base_cfg["env"]["num_actions"] = load_urdf(_resolve_asset(cfg["asset"]["file"])).num_dofs
        super().__init__(base_cfg, device, group)
        if self.num_obs != self.frame_obs * self.train_stack:
            raise ValueError(f"num_observations must be frame_obs * train_stack = "
                             f"{self.frame_obs * self.train_stack}")
        self.action_indices = torch.as_tensor(scfg["joint_indices"], dtype=torch.int64,
                                              device=self.device)
        self.num_actions = len(scfg["joint_indices"])
        if self.num_actions != int(cfg["env"]["num_actions"]):
            raise ValueError(f"{self.num_actions} joint_indices, config asks for "
                             f"{cfg['env']['num_actions']} actions")
        self.default_subset = self.default_dof_pos[self.action_indices]
        # on the device, as T1's contact indices: the step copies no host data
        self.feet_index = torch.as_tensor(self.feet_indices, dtype=torch.int64,
                                          device=self.device)

    # -- actions: the subset -> full-width PD targets ------------------------
    def _apply_actions(self, actions):
        actions = torch.clamp(actions, -self.action_clip, self.action_clip)
        targets = self.default_dof_pos.expand(actions.shape[0], self.model.num_dofs).clone()
        targets[:, self.action_indices] += self.cfg["control"]["action_scale"] * actions
        return actions, targets

    # -- the fallen-state bank -------------------------------------------------
    def init_params(self, gen):
        params = super().init_params(gen)
        with span("env.bank"):
            bank = self._build_fallen_bank(params, gen)
        fields = {f.name: getattr(params, f.name) for f in dataclasses.fields(params)}
        return StandupParams(**fields, init_bank=bank)

    def _draw_fallen(self, gen):
        """The drops' random values: tilt angle (radians, 5-120 deg) and its
        sign, roll or pitch, yaw, joint noise, and the tucked drops' tip
        (10-50 deg) and squat depth."""
        B, nd = self.num_envs, self.model.num_dofs
        u = lambda lo, hi, *shape: lo + (hi - lo) * self._rand(gen, *shape)
        return {"angle": u(math.radians(5.0), math.radians(120.0), B),
                "flip": self._rand(gen, B) < 0.5,
                "use_pitch": self._rand(gen, B) < 0.5,
                "yaw": self._rand(gen, B) * 2 * math.pi,
                "q_noise": u(-0.3, 0.3, B, nd),
                "tip": u(math.radians(10.0), math.radians(50.0), B),
                "depth": u(0.6, 1.0, B, 1)}

    def _squat(self, q, depth):
        """q with _BEND's joints bent by depth [B] times their amount."""
        q = q.clone()
        for j, name in enumerate(self.model.dof_names):
            for key, amount in _BEND.items():
                if key in name:
                    q[:, j] += depth * amount
        return q

    def _fallen_seed_states(self, draws):
        """Near-horizontal drop poses from _draw_fallen's values: tilted
        about roll or pitch with noisy joints, every fourth env a squat
        tipped forward, 0.5 m up over its origin."""
        B, nd = self.num_envs, self.model.num_dofs
        angle = draws["angle"] * torch.where(draws["flip"], 1.0, -1.0)
        roll = torch.where(draws["use_pitch"], 0.0, angle)
        pitch = torch.where(draws["use_pitch"], angle, 0.0)
        q = self.default_dof_pos.expand(B, nd) + draws["q_noise"]
        tucked = self._env_index() % 4 == 3
        pitch = torch.where(tucked, draws["tip"], pitch)
        roll = torch.where(tucked, 0.0, roll)
        q_squat = self._squat(self.default_dof_pos.expand(B, nd), draws["depth"][:, 0])
        q = torch.where(tucked[:, None], q_squat, q)
        q = torch.clamp(q, self.dof_lower, self.dof_upper)
        pos = torch.cat([self.env_origins[:, :2] + self.base_init_pos[:2],
                         torch.full((B, 1), 0.5, device=self.device)], dim=-1)
        zeros = self._zeros(B, 3)
        return SimState(root_pos=pos, root_quat=quat_from_euler_xyz(roll, pitch, draws["yaw"]),
                        root_lin_vel=zeros, root_ang_vel=zeros.clone(), q=q,
                        qd=self._zeros(B, nd))

    def _settle(self, params, sim):
        """settle_rounds control steps holding the default pose by PD (the
        targets latched from substep 0, no push): one control-step launch
        each on the kernel path, the decimation loop on the eager engine.
        The kernel path takes the plane under every point, as the JAX
        package's kernel path does."""
        B, npt = self.num_envs, self.model.num_points
        targets = self.default_dof_pos.expand(B, self.model.num_dofs).contiguous()
        zeros3 = self._zeros(B, 3)
        normals = self._zeros(B, npt, 3)
        normals[..., 2] = 1.0
        inner = (self._physics_inner_loop if self.kernel_backend
                 else self._physics_inner_loop_engine)
        for _ in range(self.settle_rounds):
            held = types.SimpleNamespace(
                sim=sim, last_dof_targets=targets, torques=self._zeros(B, self.model.num_dofs),
                delay_steps=torch.zeros(B, dtype=torch.int64, device=self.device),
                point_heights=self._zeros(B, npt), point_normals=normals)
            sim = inner(params, held, targets, zeros3, zeros3)[0]
        return sim

    def _build_fallen_bank(self, params, gen):
        """Drop and settle, then a quarter of the bank (at least one entry)
        replaced by a standing-to-squat ladder: depth 0 the default stance,
        deeper entries bent toward a full squat with the root lowered to
        match."""
        settled = self._settle(params, self._fallen_seed_states(self._draw_fallen(gen)))
        bank = self._standing_ladder(settled)
        return dataclasses.replace(bank, **{f.name: self.group.all_gather(getattr(bank, f.name))
                                            for f in dataclasses.fields(bank)})

    def _env_index(self):
        """The global index of this rank's envs."""
        return torch.arange(self.group.lo, self.group.hi, device=self.device)

    def _standing_ladder(self, settled):
        n_stand = max(1, self.global_envs // 4)
        index = self._env_index()
        standing = index < n_stand
        depth = torch.clamp(index.float() / max(n_stand - 1, 1), 0.0, 1.0)
        q_def = self._squat(self.default_dof_pos.expand_as(settled.q), depth)
        q_def = torch.clamp(q_def, self.dof_lower, self.dof_upper)
        pos_def = settled.root_pos.clone()
        pos_def[:, 2] = float(self.base_init_pos[2]) - 0.36 * depth
        quat_def = torch.tensor([1.0, 0.0, 0.0, 0.0], device=self.device).expand_as(
            settled.root_quat)
        m1 = standing[:, None]
        return SimState(
            root_pos=torch.where(m1, pos_def, settled.root_pos),
            root_quat=torch.where(m1, quat_def, settled.root_quat),
            root_lin_vel=torch.where(m1, 0.0, settled.root_lin_vel),
            root_ang_vel=torch.where(m1, 0.0, settled.root_ang_vel),
            q=torch.where(m1, q_def, settled.q),
            qd=torch.where(m1, 0.0, settled.qd))

    # -- resets from the bank ----------------------------------------------------
    def _draw_reset(self, gen, bank_size):
        """A reset's random values: the bank entry, joint noise, the yaw
        turn and the action delay."""
        B, nd = self.num_envs, self.model.num_dofs
        return {"idx": self._randint(gen, 0, bank_size, B),
                "q_noise": -0.05 + 0.1 * self._rand(gen, B, nd),
                "dyaw": self._rand(gen, B) * 2 * math.pi,
                "delay": self._randint(gen, 0, self.decimation, B)}

    def _reset_envs(self, params, state, mask, gen):
        draws = self._draw_reset(gen, params.init_bank.q.shape[0])
        return self._reset_from_bank(params, state, mask, draws)

    def _reset_from_bank(self, params, state, mask, draws):
        """Masked re-init from the bank entries `draws` picks: its joints
        plus noise, its pose turned by the drawn yaw, 2 cm above its settled
        height over this env's origin."""
        B = self.num_envs
        m1 = mask[:, None]
        bank, idx = params.init_bank, draws["idx"]
        q = torch.clamp(bank.q[idx] + draws["q_noise"], self.dof_lower, self.dof_upper)
        zero = torch.zeros(B, device=self.device)
        quat = quat_mul(quat_from_euler_xyz(zero, zero, draws["dyaw"]), bank.root_quat[idx])
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
            delay_steps=torch.where(mask, draws["delay"], state.delay_steps))

    # -- termination: timeout, velocity blow-up, a non-finite state -----------------
    def _check_termination(self, state):
        root_vel6 = torch.cat([state.sim.root_lin_vel, state.sim.root_ang_vel], -1)
        reset = torch.sum(root_vel6 ** 2, dim=-1) > self.cfg["rewards"]["terminate_vel"]
        # a solver blow-up within one control step leaves a non-finite state,
        # which fails every comparison: reset it
        bad = ~(torch.isfinite(torch.sum(root_vel6, dim=-1))
                & torch.isfinite(torch.sum(state.sim.q, dim=-1))
                & torch.isfinite(state.sim.root_pos[:, 2]))
        time_out = state.episode_length > self.max_episode_length
        return state.replace(reset_buf=reset | bad | time_out, time_out_buf=time_out)

    # -- observations: the 42-dim deploy frame, stacked ---------------------------------
    def _zero_state(self):
        base = super()._zero_state()
        fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
        return StandupState(**fields, obs_stack=self._zeros(self.num_envs, self.train_stack,
                                                            self.frame_obs))

    def _frame(self, params, state, gen):
        """One 42-dim frame in the deploy wrapper's layout and scales:
        gravity, angular velocity, the subset's joint offsets and
        velocities, the last actions."""
        ncfg, noise = self.cfg["normalization"], self.cfg["noise"]
        idx = self.action_indices
        return torch.cat([
            self._randomize(gen, state.projected_gravity, noise.get("gravity"))
            * ncfg["gravity"],
            self._randomize(gen, state.base_ang_vel, noise.get("ang_vel")) * ncfg["ang_vel"],
            self._randomize(gen, state.sim.q[:, idx] - self.default_subset,
                                noise.get("dof_pos")) * ncfg["dof_pos"],
            self._randomize(gen, state.sim.qd[:, idx], noise.get("dof_vel"))
            * ncfg["dof_vel"],
            state.actions,
        ], dim=-1)

    def _observe(self, params, state, gen):
        # a faulted env's last step before its reset gives zeros, not NaN:
        # one NaN in the buffers would poison the batch's advantage statistics
        frame = _nan_to_zero(self._frame(params, state, gen))
        rolled = torch.cat([frame[:, None, :], state.obs_stack[:, :-1]], dim=1)
        stack = torch.where(state.reset_buf[:, None, None], frame[:, None, :], rolled)
        state = state.replace(obs_stack=stack)
        return state, stack.reshape(self.num_envs, self.num_obs), self._compute_privileged(
            params, state, gen)

    def _compute_privileged(self, params, state, gen):
        """T1's 14-dim privileged observation, non-finite values zeroed."""
        ncfg, noise = self.cfg["normalization"], self.cfg["noise"]
        height = state.sim.root_pos[:, 2] - state.terrain_height_root
        return _nan_to_zero(torch.cat([
            params.base_mass_scaled,
            self._randomize(gen, state.base_lin_vel, noise.get("lin_vel")) * ncfg["lin_vel"],
            self._randomize(gen, height, noise.get("height"))[:, None],
            state.push_force * ncfg["push_force"],
            state.push_torque * ncfg["push_torque"],
        ], dim=-1))

    def _compute_reward(self, params, state):
        """T1's terms, each non-finite value zeroed, re-summed and clamped
        as T1 clamps."""
        _, terms = super()._compute_reward(params, state)
        terms = {k: _nan_to_zero(v) for k, v in terms.items()}
        total = sum(terms.values())
        if self.cfg["rewards"].get("only_positive_rewards", False):
            total = torch.clamp(total, min=0.0)
        return total, terms

    # -- standup reward terms -------------------------------------------------------
    def _height_ratio(self, state):
        h = state.sim.root_pos[:, 2] - state.terrain_height_root
        return torch.clamp(h / self.target_height, 0.0, 1.0)

    def _reward_standup_height(self, params, state):
        # quadratic: a linear ramp makes the all-fours prop a strong optimum
        return torch.square(self._height_ratio(state))

    def _reward_standup_upright(self, params, state):
        # projected gravity z: -1 upright, 0 lying; gated by the trunk height
        return (torch.square(0.5 * (1.0 - state.projected_gravity[:, 2]))
                * self._height_ratio(state))

    def _reward_standup_posture(self, params, state):
        # gated by uprightness, so the sprawl phase moves freely
        err = torch.sum(torch.square(state.sim.q - self.default_dof_pos), dim=-1)
        return torch.exp(-err) * torch.clamp(-state.projected_gravity[:, 2], 0.0, 1.0)

    def _reward_standup_feet_load(self, params, state):
        # the share of the body's weight on the feet (vertical contact force)
        fz = torch.sum(state.contact_forces[:, self.feet_index, 2], dim=-1)
        weight = 9.81 * torch.sum(params.dyn.body_mass, dim=-1)
        return torch.clamp(fz / weight, 0.0, 1.0)

    def _reward_standup_success(self, params, state):
        h = state.sim.root_pos[:, 2] - state.terrain_height_root
        up = state.projected_gravity[:, 2] < -0.9
        tall = h > 0.9 * self.target_height
        slow = torch.sum(torch.square(state.sim.qd), dim=-1) < 5.0
        return (up & tall & slow).float()

