"""T1 humanoid locomotion task on plane or heightfield (trimesh) terrain,
batch-leading PyTorch (port of booster_gym_tpu/envs/t1.py).

step(params, state, actions, gen) -> (state', obs, rew, reset_mask, info)
is the JAX package's pure step with the PRNG key replaced by an explicit
torch.Generator on the env's device.  Per-env resets and resamples are
masked batched updates.  Same semantics and the same documented
divergences from the upstream task as the JAX package (its module
docstring): timeouts reflect the current step, the curriculum maps flat
index -> (lin, ang) unless `curriculum_transpose_quirk`, still commands are
per-env Bernoulli unless `still_mode: exact_fraction`, and pushes act on
the first substep of a control step.

A frozen copy of booster_gym_torch/envs/t1.py for the benchmark's
reference.  The control step is reference/control.py's plain decimation
loop around the plain substep, whose epilogue gives the foot edge points
and, on trimesh, the terrain under the step's queries; sim.backend: xla
runs the eager engine, which queries the terrain inside every substep.
The batch is one process's (reference/group.py).
"""

import dataclasses
import math
import os

import numpy as np
import torch

from gymbench.reference.envs.randomize import apply_randomization
from gymbench.reference.envs.state import EnvParams, EnvState
from gymbench.reference.math.quat import (
    euler_xyz_from_quat,
    quat_from_euler_xyz,
    quat_rotate,
    quat_rotate_inverse,
)
from gymbench.reference.model import load_urdf
from gymbench.reference.group import Group
from gymbench.reference.physics import DynParams, SimConfig, SimState
from gymbench.reference.physics.engine import ModelConsts, make_fk, make_substep
from gymbench.reference.physics.kinematics import point_world_positions
from gymbench.reference.control import PlainControl, feet_edge_world
from gymbench.reference.terrain import Terrain

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _resolve_asset(path):
    """Absolute paths as given; relative ones against the working
    directory, then the repository root."""
    if os.path.isabs(path):
        if os.path.exists(path):
            return path
        raise FileNotFoundError(path)
    for root in (os.getcwd(), _REPO_ROOT):
        cand = os.path.join(root, path)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(path)


class T1:
    """Static task definition + step/reset functions; all evolving state is
    in EnvParams / EnvState."""

    # the check's hooks (gymbench/reference/envs/__init__.py): the
    # dataclasses the program's state and params convert into, and the
    # state's fields that a step compares besides sim's
    State = EnvState
    Params = EnvParams
    STATE_FIELDS = ("torques", "last_dof_targets", "contact_forces", "base_lin_vel",
                    "base_ang_vel", "projected_gravity", "feet_pos", "feet_contact",
                    "terrain_height_root", "point_heights", "point_normals",
                    "filtered_lin_vel", "filtered_ang_vel")

    def __init__(self, cfg, device, group=None):
        self.cfg = cfg
        self.device = torch.device(device)
        dev = self.device
        self.group = Group(cfg["env"]["num_envs"], dev) if group is None else group
        if self.group.num_envs != cfg["env"]["num_envs"]:
            raise ValueError(f"the group cuts {self.group.num_envs} envs, the config has "
                             f"{cfg['env']['num_envs']}")
        self.global_envs = self.group.num_envs
        self.num_envs = self.group.local_envs
        self.num_obs = cfg["env"]["num_observations"]
        self.num_privileged_obs = cfg["env"]["num_privileged_obs"]
        self.num_actions = cfg["env"]["num_actions"]
        self.decimation = cfg["control"]["decimation"]
        self.sim_dt = cfg["sim"]["dt"]
        self.dt = self.decimation * self.sim_dt

        self.model = self._load_model(cfg)
        nd = self.model.num_dofs

        solver = cfg["sim"].get("solver", {})
        self.sim_cfg = SimConfig(
            dt=self.sim_dt,
            gravity=tuple(cfg["sim"]["gravity"]),
            solver_iterations=int(solver.get("iterations", 4)),
            baumgarte=float(solver.get("baumgarte", 0.2)),
            contact_slop=float(solver.get("contact_slop", 0.001)),
            max_pushout_vel=float(solver.get("max_pushout_vel", 1.0)),
            bounce_threshold=float(solver.get("bounce_threshold", 0.2)),
            relaxation=float(solver.get("relaxation", 1.0)),
            terrain_friction=float(cfg["terrain"]["static_friction"]),
            terrain_restitution=float(cfg["terrain"]["restitution"]),
        )
        self.terrain = Terrain(cfg["terrain"], seed=cfg["basic"].get("seed", 0) or 0,
                               device=dev)
        self.fk = make_fk(self.model, dev)
        self.consts = ModelConsts.build(self.model, dev)

        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        # PD gains by joint-name substring
        stiff, damp = np.zeros(nd), np.zeros(nd)
        for i, name in enumerate(self.model.dof_names):
            found = False
            for key in cfg["control"]["stiffness"]:
                if key in name:
                    stiff[i] = cfg["control"]["stiffness"][key]
                    damp[i] = cfg["control"]["damping"][key]
                    found = True
            if not found:
                raise ValueError(f"PD gain of joint {name} were not defined")
        self.base_stiffness = f32(stiff)
        self.base_damping = f32(damp)
        self.torque_limits = f32(self.model.dof_effort)
        self.dof_vel_limits = f32(self.model.dof_vel_limit)
        self.dof_lower = f32(self.model.dof_lower)
        self.dof_upper = f32(self.model.dof_upper)

        # default joint angles by substring with a "default" fallback
        defaults = np.zeros(nd)
        angle_cfg = cfg["init_state"]["default_joint_angles"]
        for i, name in enumerate(self.model.dof_names):
            found = False
            for key in angle_cfg:
                if key != "default" and key in name:
                    defaults[i] = angle_cfg[key]
                    found = True
            if not found:
                defaults[i] = angle_cfg["default"]
        self.default_dof_pos = f32(defaults)

        names = self.model.body_names
        self.penalized_contact_indices = [
            i for i, n in enumerate(names)
            if any(s in n for s in cfg["rewards"]["penalize_contacts_on"])]
        self.termination_contact_indices = [
            i for i, n in enumerate(names)
            if any(s in n for s in cfg["rewards"]["terminate_contacts_on"])]
        self.base_index = names.index(cfg["asset"]["base_name"])
        self.feet_indices = [names.index(n) for n in cfg["asset"]["foot_names"]]
        self.foot_shape_indices = [
            s for f in self.feet_indices for s in self.model.shape_indices_of_body(f)]
        self.feet_edge_pos = np.asarray(cfg["asset"]["feet_edge_pos"], np.float32)

        rot = cfg["init_state"]["rot"]   # xyzw in the config
        self.base_init_pos = f32(cfg["init_state"]["pos"])
        self.base_init_quat = f32([rot[3], rot[0], rot[1], rot[2]])
        self.base_init_lin_vel = f32(cfg["init_state"]["lin_vel"])
        self.base_init_ang_vel = f32(cfg["init_state"]["ang_vel"])
        self.env_origins = f32(self._compute_env_origins())

        # reward registry: non-zero scales only, pre-multiplied by dt
        self.reward_scales = {
            k: v * self.dt for k, v in cfg["rewards"]["scales"].items() if v != 0}
        self._reward_fns = {k: getattr(self, f"_reward_{k}") for k in self.reward_scales}

        self.max_episode_length = int(np.ceil(cfg["rewards"]["episode_length_s"] / self.dt))
        self.kick_interval = int(np.ceil(cfg["randomization"]["kick_interval_s"] / self.dt))
        self.push_interval = int(np.ceil(cfg["randomization"]["push_interval_s"] / self.dt))
        self.push_duration = int(np.ceil(cfg["randomization"]["push_duration_s"] / self.dt))
        cc = cfg["commands"]
        self.curriculum_shape = (1 + 2 * cc["lin_vel_levels"], 1 + 2 * cc["ang_vel_levels"])

        # the kernel path (the substep kernel's control step, whose epilogue
        # samples the terrain on trimesh; terrain_sampler is the standalone
        # sampler of the same queries), or the eager engine with the terrain
        # queried inside the substep
        plane = self.terrain.type == "plane"
        self.kernel_backend = cfg["sim"].get("backend", "auto") != "xla"
        self.substep = self.engine_substep = self.terrain_sampler = None
        if self.kernel_backend:
            self.substep = PlainControl(self.model, self.sim_cfg, self.feet_indices, dev,
                                         plane=plane, feet_edge_pos=self.feet_edge_pos,
                                         terrain=None if plane else self.terrain)
        else:
            self.engine_substep = make_substep(self.model, self.sim_cfg, self.feet_indices, dev,
                                               terrain=self.terrain)

    def _load_model(self, cfg):
        """The robot: the URDF's bodies, joints and contact points, one DoF
        per action."""
        model = load_urdf(
            _resolve_asset(cfg["asset"]["file"]),
            cylinder_rim_points=int(cfg["asset"].get("cylinder_rim_points", 6)))
        if cfg["asset"].get("collision_source") == "mjcf":
            raise ValueError("the reference T1 takes its contact points from the URDF only")
        if model.num_dofs != self.num_actions:
            raise ValueError(f"asset has {model.num_dofs} dofs, config asks for "
                             f"{self.num_actions} actions")
        return model

    # ------------------------------------------------------------------
    def _compute_env_origins(self):
        """Grid env origins: env_spacing apart on the plane, spread over the
        tiles (with the terrain height as z) on trimesh; the global batch's
        grid, this rank's rows."""
        B = self.global_envs
        origins = np.zeros((B, 3), np.float32)
        if self.terrain.type == "plane":
            num_cols = np.floor(np.sqrt(B))
            num_rows = np.ceil(B / num_cols)
            xx, yy = np.meshgrid(np.arange(num_rows), np.arange(num_cols), indexing="ij")
            spacing = self.cfg["env"]["env_spacing"]
            origins[:, 0] = spacing * xx.flatten()[:B]
            origins[:, 1] = spacing * yy.flatten()[:B]
        else:
            t = self.terrain
            num_cols = max(1.0, np.floor(np.sqrt(B * t.env_length / t.env_width)))
            num_rows = np.ceil(B / num_cols)
            xx, yy = np.meshgrid(np.arange(num_rows), np.arange(num_cols), indexing="ij")
            origins[:, 0] = t.env_width / (num_rows + 1) * (xx.flatten()[:B] + 1)
            origins[:, 1] = t.env_length / (num_cols + 1) * (yy.flatten()[:B] + 1)
            xy = torch.as_tensor(origins[:, :2], device=self.device)
            origins[:, 2] = t.heights(xy).cpu().numpy()
        return self.group.rows(origins)

    def _zeros(self, *shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    # the random draws: at the global batch, this rank's rows (Group.draw)
    def _randomize(self, gen, tensor, spec, return_noise=False):
        return apply_randomization(gen, tensor, spec, return_noise, group=self.group)

    def _rand(self, gen, *shape):
        return self.group.draw(torch.rand, gen, shape, device=self.device)

    def _randint(self, gen, lo, hi, n):
        return self.group.draw(torch.randint, gen, (n,), lo, hi, device=self.device)

    # ------------------------------------------------------------------
    def init_params(self, gen):
        """Per-env creation-time domain randomization."""
        B, nb, nd = self.num_envs, self.model.num_bodies, self.model.num_dofs
        ns = len(self.model.shape_body)
        rcfg = self.cfg["randomization"]
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        stiffness = self._randomize(
            gen, self.base_stiffness.expand(B, nd).clone(), rcfg.get("dof_stiffness"))
        damping = self._randomize(
            gen, self.base_damping.expand(B, nd).clone(), rcfg.get("dof_damping"))
        friction = self._randomize(gen, self._zeros(B, nd), rcfg.get("dof_friction"))

        mass = f32(self.model.body_mass).expand(B, nb).clone()
        com = f32(self.model.body_com).expand(B, nb, 3).clone()
        inertia = f32(self.model.body_inertia).expand(B, nb, 3, 3).clone()

        bi = self.base_index
        base_com, com_noise = self._randomize(
            gen, com[:, bi], rcfg.get("base_com"), return_noise=True)
        base_mass, mass_noise = self._randomize(
            gen, mass[:, bi], rcfg.get("base_mass"), return_noise=True)
        com[:, bi] = base_com
        mass[:, bi] = base_mass
        base_mass_scaled = torch.cat([com_noise, mass_noise[:, None]], dim=-1)

        other = torch.arange(nb, device=self.device) != bi
        other_com = self._randomize(gen, com, rcfg.get("other_com"))
        other_mass = self._randomize(gen, mass, rcfg.get("other_mass"))
        com = torch.where(other[None, :, None], other_com, com)
        mass = torch.where(other[None, :], other_mass, mass)
        # like upstream, masses are scaled but rotational inertia is not

        if rcfg.get("randomize_all_shapes", False):
            shape_friction = self._randomize(gen, self._zeros(B, ns), rcfg.get("friction"))
            shape_restitution = self._randomize(
                gen, self._zeros(B, ns), rcfg.get("restitution"))
        else:
            nfs = len(self.foot_shape_indices)
            shape_friction = torch.ones((B, ns), device=self.device)
            shape_restitution = self._zeros(B, ns)
            shape_friction[:, self.foot_shape_indices] = self._randomize(
                gen, self._zeros(B, nfs), rcfg.get("friction"))
            shape_restitution[:, self.foot_shape_indices] = self._randomize(
                gen, self._zeros(B, nfs), rcfg.get("restitution"))

        dyn = DynParams(body_mass=mass, body_com=com, body_inertia=inertia,
                        shape_friction=shape_friction, shape_restitution=shape_restitution)
        hf = self.terrain.height_field
        return EnvParams(dyn=dyn, dof_stiffness=stiffness, dof_damping=damping,
                         dof_friction=friction, base_mass_scaled=base_mass_scaled,
                         env_origins=self.env_origins,
                         height_field=self._zeros(1, 1) if hf is None else hf)

    # ------------------------------------------------------------------
    def _zero_state(self):
        B, nb, nd, na = (self.num_envs, self.model.num_bodies, self.model.num_dofs,
                         self.num_actions)
        npt = self.model.num_points
        z, i64 = self._zeros, torch.int64
        q0 = self.default_dof_pos.expand(B, nd).clone()
        sim = SimState(
            root_pos=self.base_init_pos.expand(B, 3).clone(),
            root_quat=self.base_init_quat.expand(B, 4).clone(),
            root_lin_vel=z(B, 3), root_ang_vel=z(B, 3), q=q0, qd=z(B, nd))
        cc = self.cfg["commands"]
        prob = z(*self.curriculum_shape)
        prob[cc["lin_vel_levels"], cc["ang_vel_levels"]] = 1.0
        gravity = torch.tensor([0.0, 0.0, -1.0], device=self.device).expand(B, 3).clone()
        up = torch.tensor([0.0, 0.0, 1.0], device=self.device).expand(B, npt, 3).clone()
        return EnvState(
            sim=sim, actions=z(B, na), last_actions=z(B, na),
            last_dof_targets=q0.clone(), delay_steps=z(B, dtype=i64),
            torques=z(B, nd), last_dof_vel=z(B, nd), last_root_vel=z(B, 6),
            episode_length=z(B, dtype=i64), common_step_counter=z(dtype=i64),
            reset_buf=torch.ones(B, dtype=torch.bool, device=self.device),
            time_out_buf=z(B, dtype=torch.bool),
            commands=z(B, 3), cmd_resample_time=z(B, dtype=i64),
            gait_frequency=z(B), gait_process=z(B),
            filtered_lin_vel=z(B, 3), filtered_ang_vel=z(B, 3),
            curriculum_prob=prob, env_curriculum_level=z(B, 2, dtype=i64),
            push_force=z(B, 3), push_torque=z(B, 3),
            last_feet_pos=z(B, 2, 3), feet_pos=z(B, 2, 3),
            feet_roll=z(B, 2), feet_yaw=z(B, 2), feet_contact=z(B, 2, dtype=torch.bool),
            contact_forces=z(B, nb, 3), base_lin_vel=z(B, 3), base_ang_vel=z(B, 3),
            projected_gravity=gravity, terrain_height_root=z(B),
            point_heights=z(B, npt), point_normals=up)

    def reset_all(self, params, gen):
        """Full reset: (state, obs, info)."""
        state = self._zero_state()
        mask = torch.ones(self.num_envs, dtype=torch.bool, device=self.device)
        state = self._reset_envs(params, state, mask, gen)
        state = state.replace(terrain_height_root=self.terrain.heights(
            state.sim.root_pos[:, :2], params.height_field))
        state = self._refresh_point_terrain(state)
        state = self._refresh_post_physics(params, state)
        state = state.replace(filtered_lin_vel=torch.zeros_like(state.filtered_lin_vel),
                              filtered_ang_vel=torch.zeros_like(state.filtered_ang_vel))
        state = self._resample_commands(state, gen)
        state, obs, privileged = self._observe(params, state, gen)
        info = {"privileged_obs": privileged, "time_outs": state.time_out_buf,
                "rew_terms": {k: self._zeros(self.num_envs) for k in self.reward_scales}}
        return state, obs, info

    # ------------------------------------------------------------------
    def _refresh_point_terrain(self, state):
        """The carried per-point terrain heights and normals from the
        current pose (reset_all only: while stepping, the control step's
        epilogue samples them once per control step)."""
        body_R, body_pos = self.fk(state.sim)
        xy = point_world_positions(self.consts, body_R, body_pos)[..., :2]
        h, n = self.terrain.heights_and_normals(xy)
        return state.replace(point_heights=h, point_normals=n)

    # ------------------------------------------------------------------
    def _physics_inner_loop_engine(self, params, state, dof_targets, push_f_w, push_t_w):
        """sim.backend xla: the batch-leading decimation loop around the
        eager engine.  Same outputs as _physics_inner_loop; the edge points
        come from feet_edge_world, and no terrain comes back (the engine
        queries the terrain itself)."""
        sim, last, tsum = state.sim, state.last_dof_targets, torch.zeros_like(state.torques)
        zeros3 = torch.zeros_like(push_f_w)
        for i in range(self.decimation):
            last = torch.where((state.delay_steps == i)[:, None], dof_targets, last)
            pd = params.dof_stiffness * (last - sim.q) - params.dof_damping * sim.qd
            fric = torch.minimum(torch.abs(pd), params.dof_friction) * torch.sign(pd)
            tau = torch.minimum(torch.maximum(pd - fric, -self.torque_limits), self.torque_limits)
            sim, forces, feet_pos, feet_R = self.engine_substep(
                sim, params.dyn, tau, push_f_w if i == 0 else zeros3,
                push_t_w if i == 0 else zeros3)
            tsum = tsum + tau
        return (sim, last, tsum / self.decimation, forces, feet_pos, feet_R,
                self._feet_edge_world(feet_pos, feet_R), None, None)

    def _physics_inner_loop(self, params, state, dof_targets, push_f_w, push_t_w):
        """Decimation loop: delay latch, PD, Coulomb joint friction, torque
        clip, push on substep 0, torque mean.  On a GPU it is one launch of
        the substep kernel's control step, with the state on chip; on the
        CPU its plain version, the same loop around the plain substep.  On
        trimesh the carried point heights and normals go to every substep
        unchanged.  Besides the physics, the step's epilogue: the foot edge
        points (x, y, z), each [B, nf, ne], and on trimesh the terrain
        heights [B, NQ] and normals [B, NQ, 3] under the new contact points,
        the root and the edge points (None on the plane)."""
        sub = self.substep
        B = self.num_envs
        if sub.plane:
            ph = pn = hf = None
        else:
            # read in place, at their strides
            ph = state.point_heights.T
            pn = state.point_normals.reshape(B, -1).T
            hf = params.height_field
        out = sub.control_step(
            sub.pack_sim(state.sim), sub.pack_dyn(params.dyn), dof_targets.contiguous(),
            state.last_dof_targets.contiguous(), state.delay_steps.contiguous(),
            params.dof_stiffness.contiguous(), params.dof_damping.contiguous(),
            params.dof_friction.contiguous(), self.torque_limits,
            torch.cat([push_f_w, push_t_w], dim=-1), ph, pn, hf, decimation=self.decimation)
        nb, nf, ne = self.model.num_bodies, len(self.feet_indices), sub.ne
        feet = out.feet.T.reshape(B, nf, 12)
        edge_xyz = tuple(out.edges.view(B, 3, nf, ne).unbind(1))
        return (sub.unpack_sim(out.state), out.last, out.tsum / self.decimation,
                out.forces.T.reshape(B, nb, 3), feet[..., 0:3],
                feet[..., 3:12].reshape(B, nf, 3, 3), edge_xyz, out.heights, out.normals)

    # ------------------------------------------------------------------
    def _reset_envs(self, params, state, mask, gen):
        """Masked re-init of terminated envs."""
        B, nd = self.num_envs, self.model.num_dofs
        rcfg = self.cfg["randomization"]
        m1 = mask[:, None]
        curriculum_prob = self._update_curriculum(state, mask)

        dof_pos = self._randomize(
            gen, self.default_dof_pos.expand(B, nd).clone(), rcfg.get("init_dof_pos"))
        q = torch.where(m1, dof_pos, state.sim.q)
        qd = torch.where(m1, torch.zeros_like(state.sim.qd), state.sim.qd)

        pos_xy = params.env_origins[:, :2] + self.base_init_pos[:2]
        pos_xy = self._randomize(gen, pos_xy, rcfg.get("init_base_pos_xy"))
        pos_z = self.base_init_pos[2] + self.terrain.heights(pos_xy, params.height_field)
        yaw = self._rand(gen, B) * 2 * math.pi
        quat = quat_from_euler_xyz(torch.zeros_like(yaw), torch.zeros_like(yaw), yaw)
        lin_xy = self._randomize(gen, self._zeros(B, 2), rcfg.get("init_base_lin_vel_xy"))
        lin_vel = torch.cat([lin_xy, self._zeros(B, 1)], dim=-1) + self.base_init_lin_vel
        ang_vel = self.base_init_ang_vel.expand(B, 3)

        sim = SimState(
            root_pos=torch.where(m1, torch.cat([pos_xy, pos_z[:, None]], -1), state.sim.root_pos),
            root_quat=torch.where(m1, quat, state.sim.root_quat),
            root_lin_vel=torch.where(m1, lin_vel, state.sim.root_lin_vel),
            root_ang_vel=torch.where(m1, ang_vel, state.sim.root_ang_vel),
            q=q, qd=qd)
        delay = self._randint(gen, 0, self.decimation, B)
        zero = torch.zeros_like(state.episode_length)
        return state.replace(
            sim=sim, curriculum_prob=curriculum_prob,
            last_dof_targets=torch.where(m1, q, state.last_dof_targets),
            last_root_vel=torch.where(m1, torch.cat([lin_vel, ang_vel], -1), state.last_root_vel),
            episode_length=torch.where(mask, zero, state.episode_length),
            filtered_lin_vel=torch.where(m1, 0.0, state.filtered_lin_vel),
            filtered_ang_vel=torch.where(m1, 0.0, state.filtered_ang_vel),
            cmd_resample_time=torch.where(mask, zero, state.cmd_resample_time),
            delay_steps=torch.where(mask, delay, state.delay_steps))

    # ------------------------------------------------------------------
    def _update_curriculum(self, state, mask):
        """Success diffusion on the command grid, as an order-free
        scatter-add clamped once at the end.  Over several ranks each
        scatters its envs into a zero grid; the grids' sum over the ranks is
        added to the grid, then clamped: the JAX package's scatter-add on
        the whole batch, up to the order of the additions."""
        cc = self.cfg["commands"]
        if not cc["curriculum"]:
            return state.curriculum_prob
        success = state.episode_length > np.ceil(
            self.cfg["rewards"]["episode_length_s"] / self.dt) * (1 - cc["episode_length_toler"])
        cmd, flin, fang = state.commands, state.filtered_lin_vel, state.filtered_ang_vel
        success &= torch.abs(flin[:, 0] - cmd[:, 0]) < cc["lin_vel_x_toler"]
        success &= torch.abs(flin[:, 1] - cmd[:, 1]) < cc["lin_vel_y_toler"]
        success &= torch.abs(fang[:, 2] - cmd[:, 2]) < cc["ang_vel_yaw_toler"]
        success &= mask

        x = state.env_curriculum_level[:, 0] + cc["lin_vel_levels"]
        y = state.env_curriculum_level[:, 1] + cc["ang_vel_levels"]
        w = torch.where(success, cc["update_rate"], 0.0)
        H, W = self.curriculum_shape
        several = self.group.world > 1
        flat = state.curriculum_prob.reshape(-1)
        flat = torch.zeros_like(flat) if several else flat.clone()
        idx = x * W + y
        zero = torch.zeros_like(w)
        flat.index_add_(0, idx, w)
        for ok, nidx in ((x > 0, (x - 1) * W + y), (x < H - 1, (x + 1) * W + y),
                         (y > 0, x * W + y - 1), (y < W - 1, x * W + y + 1)):
            flat.index_add_(0, torch.where(ok, nidx, idx), torch.where(ok, w, zero))
        if several:
            flat = state.curriculum_prob.reshape(-1) + self.group.all_reduce(flat)
        return torch.clamp(flat.reshape(H, W), max=1.0)

    # ------------------------------------------------------------------
    def _uniform(self, gen, lo, hi, n):
        n = n if isinstance(n, tuple) else (n,)
        return lo + (hi - lo) * self._rand(gen, *n)

    def _resample_commands(self, state, gen):
        """Command and gait resampling at per-env resample times."""
        cc = self.cfg["commands"]
        B = self.num_envs
        mask = state.episode_length == state.cmd_resample_time
        if cc["curriculum"]:
            commands, levels = self._sample_curriculum_commands(state, gen)
        else:
            levels = state.env_curriculum_level
            commands = torch.stack([self._uniform(gen, *cc["lin_vel_x"], B),
                                    self._uniform(gen, *cc["lin_vel_y"], B),
                                    self._uniform(gen, *cc["ang_vel_yaw"], B)], dim=-1)
        gait_freq = self._uniform(gen, *cc["gait_frequency"], B)
        if cc.get("still_mode", "bernoulli") == "exact_fraction":
            # of the k envs resampling this step, exactly floor(p k)
            # uniformly random ones go still: k and the ranks over the
            # global batch (its mask gathered from every rank)
            Bg, g_mask = self.global_envs, self.group.all_gather(mask)
            score = torch.where(g_mask, torch.rand(Bg, generator=gen, device=self.device),
                                torch.full((Bg,), math.inf, device=self.device))
            rank = torch.empty(Bg, dtype=torch.int64, device=self.device)
            rank[torch.argsort(score)] = torch.arange(Bg, device=self.device)
            k_still = torch.floor(cc["still_proportion"] * g_mask.sum()).to(torch.int64)
            still = self.group.rows(g_mask & (rank < k_still))
        else:
            still = self._rand(gen, B) < cc["still_proportion"]
        commands = torch.where(still[:, None], 0.0, commands)
        gait_freq = torch.where(still, 0.0, gait_freq)

        lo, hi = (int(t / self.dt) for t in cc["resampling_time_s"])
        # jax.random.randint's bounds: an empty range gives its lower bound
        # (T1Standup.yaml's 1000 s to 1000 s)
        step = (self._randint(gen, lo, hi, B) if hi > lo
                else torch.full((B,), lo, dtype=torch.int64, device=self.device))
        next_time = state.cmd_resample_time + step
        return state.replace(
            commands=torch.where(mask[:, None], commands, state.commands),
            gait_frequency=torch.where(mask, gait_freq, state.gait_frequency),
            cmd_resample_time=torch.where(mask, next_time, state.cmd_resample_time),
            env_curriculum_level=torch.where(mask[:, None], levels, state.env_curriculum_level))

    def _sample_curriculum_commands(self, state, gen):
        """Grid-categorical command sampling."""
        cc = self.cfg["commands"]
        B = self.num_envs
        H, W = self.curriculum_shape
        weights = torch.clamp(state.curriculum_prob.reshape(-1), min=1e-20)
        grid_idx = self.group.rows(torch.multinomial(weights, self.global_envs,
                                                     replacement=True, generator=gen))
        if cc.get("curriculum_transpose_quirk", False):
            # upstream's axis swap: consistent only for square grids
            if H != W:
                raise ValueError("curriculum_transpose_quirk needs a square grid")
            lin_level = grid_idx % W - cc["lin_vel_levels"]
            ang_level = grid_idx // W - cc["ang_vel_levels"]
        else:
            lin_level = grid_idx // W - cc["lin_vel_levels"]
            ang_level = grid_idx % W - cc["ang_vel_levels"]
        jitter = self._uniform(gen, -1.0, 1.0, (B, 3))
        commands = torch.stack([
            (lin_level + 0.5 * jitter[:, 0]) * cc["lin_vel_x_resolution"],
            torch.abs(lin_level) * jitter[:, 1] * cc["lin_vel_y_resolution"],
            (ang_level + 0.5 * jitter[:, 2]) * cc["ang_vel_resolution"]], dim=-1)
        return commands, torch.stack([lin_level, ang_level], dim=-1)

    # ------------------------------------------------------------------
    def _apply_actions(self, actions):
        clip = self.cfg["normalization"]["clip_actions"]
        actions = torch.clamp(actions, -clip, clip)
        return actions, self.default_dof_pos + self.cfg["control"]["action_scale"] * actions

    def step(self, params, state, actions, gen):
        """One control step: (state', obs, rew, reset_mask, info)."""
        actions, dof_targets = self._apply_actions(actions)
        state = state.replace(actions=actions)

        push_f_w = quat_rotate(state.sim.root_quat, state.push_force)
        push_t_w = quat_rotate(state.sim.root_quat, state.push_torque)
        inner = (self._physics_inner_loop if self.kernel_backend
                 else self._physics_inner_loop_engine)
        (sim, last_targets, torques, forces, feet_pos, feet_R, edge_xyz, h_all,
         n_all) = inner(params, state, dof_targets, push_f_w, push_t_w)
        state = state.replace(sim=sim, last_dof_targets=last_targets, torques=torques,
                              contact_forces=forces)

        edge_h = None
        B, npt = self.num_envs, self.model.num_points
        if h_all is not None:
            # the control step sampled every terrain query of the step: the
            # contact points, the root and the foot edge points
            root_h = h_all[:, npt]
            edge_h = h_all[:, npt + 1:].reshape(edge_xyz[2].shape)
        else:
            root_h = self.terrain.heights(sim.root_pos[:, :2], params.height_field)
        state = state.replace(terrain_height_root=root_h)
        state = self._refresh_post_physics(params, state, feet_pos=feet_pos, feet_R=feet_R,
                                           edge_xyz=edge_xyz, edge_heights=edge_h)
        state = state.replace(
            episode_length=state.episode_length + 1,
            common_step_counter=state.common_step_counter + 1,
            gait_process=torch.remainder(
                state.gait_process + self.dt * state.gait_frequency, 1.0))

        state = self._kick_robots(state, gen)
        state = self._push_robots(state, gen)
        state = self._check_termination(state)
        rew, rew_terms = self._compute_reward(params, state)

        reset_mask = state.reset_buf
        state = self._reset_envs(params, state, reset_mask, gen)
        state, moved_mask = self._teleport_robots(state)
        if self.terrain.type != "plane":
            # reset or teleported envs stand somewhere else now: they take
            # the terrain under their new root, for the root height and, on
            # the kernel path, for every contact point until their next
            # control step samples again (the other envs carry the sampled
            # values)
            fix = reset_mask | moved_mask
            h_root, n_root = self.terrain.heights_and_normals(
                state.sim.root_pos[:, :2], params.height_field)
            state = state.replace(terrain_height_root=torch.where(
                fix, h_root, state.terrain_height_root))
            if h_all is not None:
                state = state.replace(
                    point_heights=torch.where(fix[:, None], h_root[:, None], h_all[:, :npt]),
                    point_normals=torch.where(fix[:, None, None], n_root[:, None, :],
                                              n_all[:, :npt]))
        state = self._resample_commands(state, gen)
        # refresh derived quantities for the envs that were reset
        state = self._refresh_post_physics(params, state, reset_mask=reset_mask)
        state, obs, privileged = self._observe(params, state, gen)

        state = state.replace(
            last_actions=state.actions, last_dof_vel=state.sim.qd,
            last_root_vel=torch.cat([state.sim.root_lin_vel, state.sim.root_ang_vel], dim=-1),
            last_feet_pos=state.feet_pos)
        info = {"privileged_obs": privileged, "time_outs": state.time_out_buf,
                "rew_terms": rew_terms}
        return state, obs, rew, reset_mask, info

    # ------------------------------------------------------------------
    def _feet_edge_world(self, feet_pos, feet_R):
        """Foot edge points in the world frame as (x, y, z), each [B, nf, ne]."""
        return feet_edge_world(feet_pos, feet_R, self.feet_edge_pos.tolist())

    def _refresh_post_physics(self, params, state, feet_pos=None, feet_R=None,
                              reset_mask=None, edge_xyz=None, edge_heights=None):
        """Base-frame velocities, EMA filters, feet state.  With reset_mask
        (the post-reset refresh) only the base-frame quantities change; the
        feet buffers keep their pre-reset values, as upstream."""
        sim = state.sim
        gravity = torch.tensor([0.0, 0.0, -1.0], device=self.device).expand_as(sim.root_lin_vel)
        base_lin_vel = quat_rotate_inverse(sim.root_quat, sim.root_lin_vel)
        base_ang_vel = quat_rotate_inverse(sim.root_quat, sim.root_ang_vel)
        projected_gravity = quat_rotate_inverse(sim.root_quat, gravity)
        w = self.cfg["normalization"]["filter_weight"]
        if reset_mask is not None:
            return state.replace(
                base_lin_vel=base_lin_vel, base_ang_vel=base_ang_vel,
                projected_gravity=projected_gravity,
                filtered_lin_vel=torch.where(reset_mask[:, None], 0.0, state.filtered_lin_vel),
                filtered_ang_vel=torch.where(reset_mask[:, None], 0.0, state.filtered_ang_vel))
        filtered_lin = base_lin_vel * w + state.filtered_lin_vel * (1 - w)
        filtered_ang = base_ang_vel * w + state.filtered_ang_vel * (1 - w)

        if feet_pos is None:
            body_R, body_pos = self.fk(sim)
            feet_R = body_R[:, self.feet_indices]
            feet_pos = body_pos[:, self.feet_indices]
        roll = torch.atan2(feet_R[..., 2, 1], feet_R[..., 2, 2])
        yaw = torch.atan2(feet_R[..., 1, 0], feet_R[..., 0, 0])
        if edge_xyz is None:
            edge_xyz = self._feet_edge_world(feet_pos, feet_R)
        edge_x, edge_y, edge_z = edge_xyz
        if edge_heights is None:
            edge_heights = self.terrain.heights(torch.stack([edge_x, edge_y], dim=-1),
                                                params.height_field)
        feet_contact = torch.any(edge_z - edge_heights < 0.01, dim=-1)
        return state.replace(
            base_lin_vel=base_lin_vel, base_ang_vel=base_ang_vel,
            projected_gravity=projected_gravity,
            filtered_lin_vel=filtered_lin, filtered_ang_vel=filtered_ang,
            feet_pos=feet_pos, feet_roll=roll, feet_yaw=yaw, feet_contact=feet_contact)

    # ------------------------------------------------------------------
    def _kick_robots(self, state, gen):
        """Velocity kicks every kick_interval steps."""
        rcfg = self.cfg["randomization"]
        do = state.common_step_counter % self.kick_interval == 0
        lin = self._randomize(gen, state.sim.root_lin_vel, rcfg.get("kick_lin_vel"))
        ang = self._randomize(gen, state.sim.root_ang_vel, rcfg.get("kick_ang_vel"))
        sim = SimState(
            root_pos=state.sim.root_pos, root_quat=state.sim.root_quat,
            root_lin_vel=torch.where(do, lin, state.sim.root_lin_vel),
            root_ang_vel=torch.where(do, ang, state.sim.root_ang_vel),
            q=state.sim.q, qd=state.sim.qd)
        return state.replace(sim=sim)

    def _push_robots(self, state, gen):
        """Force/torque pushes every push_interval, push_duration long."""
        rcfg = self.cfg["randomization"]
        phase = state.common_step_counter % self.push_interval
        start, stop = phase == 0, phase == self.push_duration
        new_f = self._randomize(gen, torch.zeros_like(state.push_force), rcfg.get("push_force"))
        new_t = self._randomize(gen, torch.zeros_like(state.push_torque),
                                    rcfg.get("push_torque"))
        force = torch.where(start, new_f, torch.where(stop, 0.0, state.push_force))
        torque = torch.where(start, new_t, torch.where(stop, 0.0, state.push_torque))
        return state.replace(push_force=force, push_torque=torque)

    def _teleport_robots(self, state):
        """Wrap robots that walked off the terrain onto its other side.
        Returns (state, moved_mask)."""
        if self.terrain.type == "plane":
            return state, torch.zeros(self.num_envs, dtype=torch.bool, device=self.device)
        t = self.terrain
        pos = state.sim.root_pos
        shift_x = (t.env_width + t.border_size) * (
            (pos[:, 0] < -0.75 * t.border_size).float()
            - (pos[:, 0] > t.env_width + 0.75 * t.border_size).float())
        shift_y = (t.env_length + t.border_size) * (
            (pos[:, 1] < -0.75 * t.border_size).float()
            - (pos[:, 1] > t.env_length + 0.75 * t.border_size).float())
        new_pos = pos + torch.stack([shift_x, shift_y, torch.zeros_like(shift_x)], dim=-1)
        state = state.replace(sim=dataclasses.replace(state.sim, root_pos=new_pos))
        return state, (shift_x != 0) | (shift_y != 0)

    # ------------------------------------------------------------------
    def _check_termination(self, state):
        """Reset and timeout flags."""
        rcfg = self.cfg["rewards"]
        if self.termination_contact_indices:
            term = state.contact_forces[:, self.termination_contact_indices]
            reset = torch.any(torch.linalg.norm(term, dim=-1) > 1.0, dim=-1)
        else:
            reset = torch.zeros(self.num_envs, dtype=torch.bool, device=self.device)
        root_vel6 = torch.cat([state.sim.root_lin_vel, state.sim.root_ang_vel], -1)
        reset |= torch.sum(root_vel6 ** 2, dim=-1) > rcfg["terminate_vel"]
        reset |= state.sim.root_pos[:, 2] - state.terrain_height_root < rcfg["terminate_height"]
        time_out = state.episode_length > self.max_episode_length
        reset |= time_out
        time_out = time_out | (state.episode_length == state.cmd_resample_time)
        return state.replace(reset_buf=reset, time_out_buf=time_out)

    # ------------------------------------------------------------------
    def _observe(self, params, state, gen):
        """(state, obs, privileged): the hook of tasks whose observation
        carries state across steps (the standup frame stack)."""
        obs, privileged = self._compute_observations(params, state, gen)
        return state, obs, privileged

    def _compute_observations(self, params, state, gen):
        """47-dim actor obs and 14-dim privileged obs."""
        ncfg = self.cfg["normalization"]
        noise = self.cfg["noise"]
        commands_scale = torch.tensor([ncfg["lin_vel"], ncfg["lin_vel"], ncfg["ang_vel"]],
                                      device=self.device)
        gait_on = (state.gait_frequency > 1.0e-8).float()
        phase = 2 * math.pi * state.gait_process
        obs = torch.cat([
            self._randomize(gen, state.projected_gravity, noise.get("gravity")) * ncfg["gravity"],
            self._randomize(gen, state.base_ang_vel, noise.get("ang_vel")) * ncfg["ang_vel"],
            state.commands[:, :3] * commands_scale,
            (torch.cos(phase) * gait_on)[:, None],
            (torch.sin(phase) * gait_on)[:, None],
            self._randomize(gen, state.sim.q - self.default_dof_pos,
                                noise.get("dof_pos")) * ncfg["dof_pos"],
            self._randomize(gen, state.sim.qd, noise.get("dof_vel")) * ncfg["dof_vel"],
            state.actions,
        ], dim=-1)
        height = state.sim.root_pos[:, 2] - state.terrain_height_root
        privileged = torch.cat([
            params.base_mass_scaled,
            self._randomize(gen, state.base_lin_vel, noise.get("lin_vel")) * ncfg["lin_vel"],
            self._randomize(gen, height, noise.get("height"))[:, None],
            state.push_force * ncfg["push_force"],
            state.push_torque * ncfg["push_torque"],
        ], dim=-1)
        return obs, privileged

    # -- the check's hooks -----------------------------------------------
    def obs_sigmas(self):
        """The observation noise's sigma per column of (obs, privileged
        obs): 0 where a column is noise-free (_compute_observations'
        layout)."""
        n, s = self.cfg["noise"], self.cfg["normalization"]
        nd, na = self.model.num_dofs, self.num_actions
        sig = lambda key, scale, k: [n[key]["range"][1] * s[scale] if key in n else 0.0] * k
        obs = (sig("gravity", "gravity", 3) + sig("ang_vel", "ang_vel", 3) + [0.0] * 5
               + sig("dof_pos", "dof_pos", nd) + sig("dof_vel", "dof_vel", nd) + [0.0] * na)
        height = [n["height"]["range"][1] if "height" in n else 0.0]   # not normalized
        priv = [0.0] * 4 + sig("lin_vel", "lin_vel", 3) + height + [0.0] * 6
        return obs, priv

    def noise_free_obs(self, params, state):
        """(obs, privileged obs) of a state with the noise left out."""
        cfg = self.cfg
        self.cfg = {**cfg, "noise": {}}
        try:
            return self._compute_observations(params, state, None)
        finally:
            self.cfg = cfg

    @staticmethod
    def reset_terms(s, r):
        """What a reset fixes whatever its random draws, in an env that
        reset to `s` where the reference's reset to `r`: per env how far off
        zero the joint velocity and the episode length are, and the pairs
        (s's, r's) that are set alike: the start's angular velocity, an
        upright trunk (the projected gravity) and the trunk's height over
        the terrain."""
        off = s.sim.qd.abs().amax(1) + (s.episode_length != 0).float()
        height = lambda x: x.sim.root_pos[:, 2] - x.terrain_height_root
        return off, [(s.sim.root_ang_vel, r.sim.root_ang_vel),
                     (s.projected_gravity, r.projected_gravity), (height(s), height(r))]

    def own_params(self):
        """The params made from the configuration and the seed, not taken
        from the program: the env origins and the height field ([1, 1]
        zeros on the plane)."""
        hf = self.terrain.height_field
        return {"env_origins": self.env_origins,
                "height_field": torch.zeros((1, 1), device=self.device) if hf is None else hf}

    # ------------------------------------------------------------------
    def _compute_reward(self, params, state):
        """Registered reward terms, each scaled by scale * dt; the total is
        clipped at 0 when only_positive_rewards."""
        terms = {name: self._reward_fns[name](params, state) * scale
                 for name, scale in self.reward_scales.items()}
        total = sum(terms.values())
        if self.cfg["rewards"]["only_positive_rewards"]:
            total = torch.clamp(total, min=0.0)
        return total, terms

    # --- individual reward terms ----------------------------------------
    def _reward_survival(self, params, state):
        return torch.ones(self.num_envs, device=self.device)

    def _tracking(self, err):
        return torch.exp(-torch.square(err) / self.cfg["rewards"]["tracking_sigma"])

    def _reward_tracking_lin_vel_x(self, params, state):
        return self._tracking(state.commands[:, 0] - state.filtered_lin_vel[:, 0])

    def _reward_tracking_lin_vel_y(self, params, state):
        return self._tracking(state.commands[:, 1] - state.filtered_lin_vel[:, 1])

    def _reward_tracking_ang_vel(self, params, state):
        return self._tracking(state.commands[:, 2] - state.filtered_ang_vel[:, 2])

    def _reward_base_height(self, params, state):
        height = state.sim.root_pos[:, 2] - state.terrain_height_root
        return torch.square(height - self.cfg["rewards"]["base_height_target"])

    def _reward_collision(self, params, state):
        f = state.contact_forces[:, self.penalized_contact_indices]
        return torch.sum(torch.linalg.norm(f, dim=-1) > 1.0, dim=-1).float()

    def _reward_lin_vel_z(self, params, state):
        return torch.square(state.filtered_lin_vel[:, 2])

    def _reward_ang_vel_xy(self, params, state):
        return torch.sum(torch.square(state.base_ang_vel[:, :2]), dim=-1)

    def _reward_orientation(self, params, state):
        return torch.sum(torch.square(state.projected_gravity[:, :2]), dim=-1)

    def _reward_torques(self, params, state):
        return torch.sum(torch.square(state.torques), dim=-1)

    def _reward_dof_vel(self, params, state):
        return torch.sum(torch.square(state.sim.qd), dim=-1)

    def _reward_dof_acc(self, params, state):
        return torch.sum(torch.square((state.last_dof_vel - state.sim.qd) / self.dt), dim=-1)

    def _reward_root_acc(self, params, state):
        root_vel = torch.cat([state.sim.root_lin_vel, state.sim.root_ang_vel], -1)
        return torch.sum(torch.square((state.last_root_vel - root_vel) / self.dt), dim=-1)

    def _reward_action_rate(self, params, state):
        return torch.sum(torch.square(state.last_actions - state.actions), dim=-1)

    def _reward_dof_pos_limits(self, params, state):
        soft = self.cfg["rewards"]["soft_dof_pos_limit"]
        span = self.dof_upper - self.dof_lower
        lower = self.dof_lower + 0.5 * (1 - soft) * span
        upper = self.dof_upper - 0.5 * (1 - soft) * span
        # the solver clamps q exactly onto the limit: saturation counts
        eps = 1e-6
        out = (state.sim.q < lower + eps) | (state.sim.q > upper - eps)
        return torch.sum(out.float(), dim=-1)

    def _reward_dof_vel_limits(self, params, state):
        soft = self.cfg["rewards"]["soft_dof_vel_limit"]
        return torch.sum(torch.clamp(torch.abs(state.sim.qd) - self.dof_vel_limits * soft,
                                     0.0, 1.0), dim=-1)

    def _reward_torque_limits(self, params, state):
        soft = self.cfg["rewards"]["soft_torque_limit"]
        return torch.sum(torch.clamp(torch.abs(state.torques) - self.torque_limits * soft,
                                     min=0.0), dim=-1)

    def _reward_torque_tiredness(self, params, state):
        return torch.sum(torch.clamp(torch.square(state.torques / self.torque_limits), max=1.0),
                         dim=-1)

    def _reward_power(self, params, state):
        return torch.sum(torch.clamp(state.torques * state.sim.qd, min=0.0), dim=-1)

    def _reward_feet_slip(self, params, state):
        vel2 = torch.sum(torch.square((state.last_feet_pos - state.feet_pos) / self.dt), dim=-1)
        slip = torch.sum(vel2 * state.feet_contact.float(), dim=-1)
        return slip * (state.episode_length > 1).float()

    def _reward_feet_vel_z(self, params, state):
        vz = ((state.last_feet_pos - state.feet_pos) / self.dt)[:, :, 2]
        return torch.sum(torch.square(vz), dim=-1)

    def _reward_feet_roll(self, params, state):
        return torch.sum(torch.square(state.feet_roll), dim=-1)

    def _reward_feet_yaw_diff(self, params, state):
        d = torch.remainder(state.feet_yaw[:, 1] - state.feet_yaw[:, 0] + math.pi,
                            2 * math.pi) - math.pi
        return torch.square(d)

    def _reward_feet_yaw_mean(self, params, state):
        fy = state.feet_yaw
        mean = torch.mean(fy, dim=-1) + math.pi * (torch.abs(fy[:, 1] - fy[:, 0]) > math.pi)
        base_yaw = euler_xyz_from_quat(state.sim.root_quat)[2]
        return torch.square(torch.remainder(base_yaw - mean + math.pi, 2 * math.pi) - math.pi)

    def _reward_feet_distance(self, params, state):
        base_yaw = euler_xyz_from_quat(state.sim.root_quat)[2]
        fp = state.feet_pos
        d = torch.abs(torch.cos(base_yaw) * (fp[:, 1, 1] - fp[:, 0, 1])
                      - torch.sin(base_yaw) * (fp[:, 1, 0] - fp[:, 0, 0]))
        return torch.clamp(self.cfg["rewards"]["feet_distance_ref"] - d, 0.0, 0.1)

    def _reward_feet_swing(self, params, state):
        sp = self.cfg["rewards"]["swing_period"]
        on = state.gait_frequency > 1.0e-8
        left = (torch.abs(state.gait_process - 0.25) < 0.5 * sp) & on
        right = (torch.abs(state.gait_process - 0.75) < 0.5 * sp) & on
        return ((left & ~state.feet_contact[:, 0]).float()
                + (right & ~state.feet_contact[:, 1]).float())


TASKS = {"T1": T1, "T1Serial": T1}
