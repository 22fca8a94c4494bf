"""One physics substep as batch-leading PyTorch ops (port of
booster_gym_tpu/physics/engine.py).

This is the plain version of the CUDA substep kernels (physics/
substep_kernel.py, csrc/substep.cu): `step` on plane terrain for K1, and
`step.terrain_form`, which takes a terrain height and a unit normal per
contact point, for K5.  The CPU tests hold it against the JAX package,
chip_smoke.py holds the kernels against it on the card.  With a heightfield
`terrain` it is also the xla engine of the trimesh path (sim.backend: xla),
which queries the terrain inside every substep.  The default training path
runs none of it when the state lives on a GPU.
"""

import dataclasses

import numpy as np
import torch

from gymbench.reference.math.quat import quat_integrate
from gymbench.reference.physics import contact as contact_mod
from gymbench.reference.physics import dynamics, kinematics
from gymbench.reference.physics.linalg import spd_inverse
from gymbench.reference.physics.types import SimState


def ancestor_dof_mask(model):
    """[nb, nd] 0/1 mask: dof j moves body b."""
    nb, nd = model.num_bodies, model.num_dofs
    mask = np.zeros((nb, nd), dtype=np.float32)
    for b in range(1, nb):
        a = b
        while a > 0:
            mask[b, a - 1] = 1.0
            a = int(model.parent[a])
    return mask


@dataclasses.dataclass(frozen=True)
class ModelConsts:
    """RobotModel tables as f32 tensors on one device."""

    nb: int
    nd: int
    npt: int
    parent: tuple
    parent_t: torch.Tensor
    joint_pos: torch.Tensor
    joint_rot: torch.Tensor
    joint_axis: torch.Tensor
    dof_lower: torch.Tensor
    dof_upper: torch.Tensor
    point_body: torch.Tensor
    point_pos: torch.Tensor
    point_radius: torch.Tensor
    point_shape: torch.Tensor
    anc_mask: torch.Tensor
    onehot: torch.Tensor
    base_cols: torch.Tensor

    @classmethod
    def build(cls, model, device):
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
        idx = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
        onehot = np.zeros((model.num_points, model.num_bodies), np.float32)
        onehot[np.arange(model.num_points), model.point_body] = 1.0
        base_cols = np.zeros((6, 6), np.float32)
        base_cols[3:, 0:3] = np.eye(3)   # v0 -> linear part
        base_cols[0:3, 3:6] = np.eye(3)  # w0 -> angular part
        return cls(
            nb=model.num_bodies, nd=model.num_dofs, npt=model.num_points,
            parent=tuple(int(p) for p in model.parent),
            parent_t=idx(np.maximum(model.parent, 0)),
            joint_pos=f32(model.joint_pos), joint_rot=f32(model.joint_rot),
            joint_axis=f32(model.joint_axis),
            dof_lower=f32(model.dof_lower), dof_upper=f32(model.dof_upper),
            point_body=idx(model.point_body), point_pos=f32(model.point_pos),
            point_radius=f32(model.point_radius), point_shape=idx(model.point_shape),
            anc_mask=f32(ancestor_dof_mask(model)), onehot=f32(onehot),
            base_cols=f32(base_cols))


def make_substep(model, cfg, feet_indices, device, terrain=None):
    """Build the substep

        step(state: SimState, dyn: DynParams, tau [B, nd], ext_force [B, 3],
             ext_torque [B, 3]) ->
            (SimState, contact_forces [B, nb, 3], feet_pos [B, nf, 3],
             feet_R [B, nf, 3, 3])

    on the z = 0 plane, or on `terrain` when one with a heightfield is
    given.  contact_forces are world-frame net contact forces per body; the
    feet poses come from the start-of-substep FK.

        step.terrain_form(state, dyn, tau, ext_force, ext_torque,
                          point_heights [B, npt], point_normals [B, npt, 3])

    takes the terrain under each contact point from the caller and also
    returns the points' world xy [B, npt, 2] (start-of-substep FK)."""
    consts = ModelConsts.build(model, device)
    gravity = torch.as_tensor(cfg.gravity_arr, device=device)
    feet = torch.as_tensor(np.asarray(feet_indices, np.int64), device=device)
    eye = torch.eye(6 + model.num_dofs, device=device)
    on_field = terrain is not None and terrain.height_field is not None

    def run(state, dyn, tau, ext_force, ext_torque, detect):
        v0, w0 = state.root_lin_vel, state.root_ang_vel
        u = torch.cat([v0, w0, state.qd], dim=-1)
        body_R, body_pos = kinematics.forward_kinematics(
            consts, state.root_pos, state.root_quat, state.q)
        phi = dynamics.phi_columns(consts, body_R, body_pos, state.root_pos)
        J = dynamics.jacobians(consts, phi)
        I_sp = dynamics.spatial_inertias(
            dyn.body_mass, dyn.body_com, dyn.body_inertia, body_R, body_pos,
            state.root_pos)
        M = dynamics.mass_matrix(J, I_sp) + cfg.mass_matrix_reg * eye
        C = dynamics.bias_forces(consts, phi, I_sp, u, gravity)
        tau_gen = torch.cat([ext_force, ext_torque, tau], dim=-1)

        M_inv = spd_inverse(M)
        u_free = u + cfg.dt * dynamics.matvec(M_inv, tau_gen - C)

        pts_w = kinematics.point_world_positions(consts, body_R, body_pos)
        depth, normal = detect(pts_w)
        u_new, _, body_forces = contact_mod.solve(
            cfg, consts, dyn.shape_friction, dyn.shape_restitution, M_inv, J, phi,
            u_free, pts_w, depth, normal, state.root_pos)

        # classical base velocity from the spatial solution
        v0_new = u_new[:, 0:3] + cfg.dt * torch.linalg.cross(w0, v0)
        w0_new = u_new[:, 3:6]
        qd_new = u_new[:, 6:]
        # joint limits: position-level projection
        q_int = state.q + cfg.dt * qd_new
        at_lower = q_int < consts.dof_lower
        at_upper = q_int > consts.dof_upper
        q_new = torch.minimum(torch.maximum(q_int, consts.dof_lower), consts.dof_upper)
        qd_new = torch.where(at_lower, torch.clamp(qd_new, min=0.0), qd_new)
        qd_new = torch.where(at_upper, torch.clamp(qd_new, max=0.0), qd_new)

        new_state = SimState(
            root_pos=state.root_pos + cfg.dt * v0_new,
            root_quat=quat_integrate(state.root_quat, w0_new, cfg.dt),
            root_lin_vel=v0_new, root_ang_vel=w0_new, q=q_new, qd=qd_new)
        return new_state, body_forces, body_pos[:, feet], body_R[:, feet], pts_w[..., :2]

    def step(state: SimState, dyn, tau, ext_force, ext_torque):
        if on_field:
            detect = lambda pts: contact_mod.detect(consts, terrain, pts)
        else:
            detect = lambda pts: contact_mod.detect_plane(consts, pts)
        return run(state, dyn, tau, ext_force, ext_torque, detect)[:4]

    def terrain_form(state: SimState, dyn, tau, ext_force, ext_torque, point_heights,
                     point_normals):
        return run(state, dyn, tau, ext_force, ext_torque,
                   lambda pts: contact_mod.detect_carried(consts, pts, point_heights,
                                                          point_normals))

    step.terrain_form = terrain_form
    return step


def make_fk(model, device):
    """Batched FK: (state) -> (body_R [B, nb, 3, 3], body_pos [B, nb, 3])."""
    consts = ModelConsts.build(model, device)

    def fk(state: SimState):
        return kinematics.forward_kinematics(
            consts, state.root_pos, state.root_quat, state.q)

    return fk
