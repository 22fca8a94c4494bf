"""Forward kinematics over the static topology, batch-leading
(port of booster_gym_tpu/physics/kinematics.py)."""

import torch

from gymbench.reference.math.quat import quat_to_matrix
from gymbench.reference.math.spatial import skew


def _axis_angle_matrix(axis, angle):
    """Rodrigues rotation about a constant unit axis; angle [B] -> [B,3,3]."""
    K = skew(axis)
    K2 = K @ K
    eye = torch.eye(3, dtype=angle.dtype, device=angle.device)
    return (eye + torch.sin(angle)[:, None, None] * K
            + (1.0 - torch.cos(angle))[:, None, None] * K2)


def forward_kinematics(consts, root_pos, root_quat, q):
    """World pose of every body: root_pos [B,3], root_quat [B,4], q [B,nd]
    -> (body_R [B, nb, 3, 3], body_pos [B, nb, 3]).  `consts` is the
    ModelConsts of physics/engine.py."""
    R0 = quat_to_matrix(root_quat)
    body_R = [R0]
    body_pos = [root_pos]
    for i in range(1, consts.nb):
        p = consts.parent[i]
        Rp, pp = body_R[p], body_pos[p]
        joint_R = Rp @ consts.joint_rot[i]
        pos = pp + Rp @ consts.joint_pos[i]
        body_R.append(joint_R @ _axis_angle_matrix(consts.joint_axis[i], q[:, i - 1]))
        body_pos.append(pos)
    return torch.stack(body_R, dim=1), torch.stack(body_pos, dim=1)


def point_world_positions(consts, body_R, body_pos):
    """World positions of the collision sample points [B, npt, 3]."""
    R = body_R[:, consts.point_body]
    p = body_pos[:, consts.point_body]
    return p + torch.einsum("bnij,nj->bni", R, consts.point_pos)
