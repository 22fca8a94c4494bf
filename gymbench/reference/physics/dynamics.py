"""Batched rigid-body dynamics: Jacobians, mass matrix, bias forces
(port of booster_gym_tpu/physics/dynamics.py).

World-axis spatial algebra with every spatial vector expressed at the
base origin.  Generalized velocity u = [v0(3), w0(3), qd(nd)] where
[w0; v0] is the base spatial velocity; spatial vectors are [omega; v].
The solved u_dot's linear part is a spatial acceleration a_o; the classical
base acceleration is v0_dot = a_o + w0 x v0 (see engine.py).
"""

import torch

from gymbench.reference.math.spatial import spatial_inertia_at_origin

cross = torch.linalg.cross


def phi_columns(consts, body_R, body_pos, root_pos):
    """Joint motion columns phi_j = [a; c_j x a] at the base origin
    [B, nd, 6]."""
    parent_R = body_R[:, consts.parent_t[1:]]
    joint_R = torch.einsum("bnij,njk->bnik", parent_R, consts.joint_rot[1:])
    axis_w = torch.einsum("bnij,nj->bni", joint_R, consts.joint_axis[1:])
    joint_origin = body_pos[:, 1:] - root_pos[:, None, :]
    return torch.cat([axis_w, cross(joint_origin, axis_w)], dim=-1)


def jacobians(consts, phi):
    """Body spatial Jacobians [B, nb, 6, 6 + nd]."""
    B = phi.shape[0]
    dof_cols = phi.transpose(1, 2)[:, None, :, :] * consts.anc_mask[None, :, None, :]
    base = consts.base_cols.expand(B, consts.nb, 6, 6)
    return torch.cat([base, dof_cols], dim=-1)


def apply_J(consts, phi, u):
    """Body spatial velocities [B, nb, 6] = J u via the tree recursion."""
    vs = [torch.cat([u[:, 3:6], u[:, 0:3]], dim=-1)]
    for b in range(1, consts.nb):
        vs.append(vs[consts.parent[b]] + phi[:, b - 1] * u[:, 6 + b - 1, None])
    return torch.stack(vs, dim=1)


def apply_JT(consts, phi, w_bodies):
    """Generalized forces [B, nv] = J^T w via reverse subtree sums."""
    acc = [w_bodies[:, b] for b in range(consts.nb)]
    for b in range(consts.nb - 1, 0, -1):
        p = consts.parent[b]
        acc[p] = acc[p] + acc[b]
    base = torch.cat([acc[0][:, 3:6], acc[0][:, 0:3]], dim=-1)
    joints = torch.stack(
        [torch.sum(phi[:, j] * acc[j + 1], dim=-1) for j in range(consts.nd)], dim=-1)
    return torch.cat([base, joints], dim=-1)


def matvec(A, x):
    """[B, n, n] @ [B, n] as multiply-reduce."""
    return torch.sum(A * x[:, None, :], dim=-1)


def spatial_inertias(mass, com, inertia, body_R, body_pos, root_pos):
    """Per-body 6x6 spatial inertias at the base origin [B, nb, 6, 6]."""
    com_w = (body_pos - root_pos[:, None, :]
             + torch.einsum("bnij,bnj->bni", body_R, com))
    I_w = body_R @ inertia @ body_R.transpose(-1, -2)
    return spatial_inertia_at_origin(mass, com_w, I_w)


def mass_matrix(J, I_sp):
    """M = sum_b J_b^T I_b J_b  [B, nv, nv]."""
    B, nb, _, nv = J.shape
    IJ = I_sp @ J
    return torch.einsum("brk,brl->bkl", J.reshape(B, nb * 6, nv),
                        IJ.reshape(B, nb * 6, nv))


def _crm_apply(v, m):
    """crm(v) @ m with v = [w; vo], m = [mw; mv]."""
    w, vo = v[..., :3], v[..., 3:]
    mw, mv = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, mw), cross(vo, mw) + cross(w, mv)], dim=-1)


def _crf_apply(v, F):
    """crf(v) @ F with F = [n; f]: [w x n + vo x f; w x f]."""
    w, vo = v[..., :3], v[..., 3:]
    n, f = F[..., :3], F[..., 3:]
    return torch.cat([cross(w, n) + cross(vo, f), cross(w, f)], dim=-1)


def bias_forces(consts, phi, I_sp, u, gravity):
    """Generalized bias C(q, u) including gravity: velocity-product RNEA
    with qdd = 0 and the base spatial acceleration set to -g."""
    B = u.shape[0]
    v_list = [torch.cat([u[:, 3:6], u[:, 0:3]], dim=-1)]
    for b in range(1, consts.nb):
        v_list.append(v_list[consts.parent[b]] + phi[:, b - 1] * u[:, 6 + b - 1, None])
    a0 = torch.cat([torch.zeros_like(gravity), -gravity]).expand(B, 6)
    a_list = [a0]
    for b in range(1, consts.nb):
        a_list.append(a_list[consts.parent[b]]
                      + _crm_apply(v_list[b], phi[:, b - 1] * u[:, 6 + b - 1, None]))
    f_list = []
    for b in range(consts.nb):
        Iv = matvec(I_sp[:, b], v_list[b])
        f_list.append(matvec(I_sp[:, b], a_list[b]) + _crf_apply(v_list[b], Iv))
    return apply_JT(consts, phi, torch.stack(f_list, dim=1))
