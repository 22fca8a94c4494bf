"""Quaternion / SO(3) math on batch-leading torch tensors.

Port of booster_gym_tpu/math/quat.py.  Quaternions are wxyz (scalar
first); every function broadcasts over leading dimensions and keeps the
quaternion axis last.
"""

import math

import torch


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_rotate(q, v):
    """Rotate v by q (body -> world for a body-attitude q)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def quat_rotate_inverse(q, v):
    """Rotate v by the inverse of q (world -> body)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = torch.linalg.cross(u, v)
    return v - 2.0 * (w * uv - torch.linalg.cross(u, uv))


def quat_to_matrix(q):
    """Rotation matrix R with R @ v_body = v_world; shape (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def quat_from_euler_xyz(roll, pitch, yaw):
    """Quaternion (wxyz) from intrinsic XYZ (roll, pitch, yaw) angles."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def euler_xyz_from_quat(q):
    """(roll, pitch, yaw) in [-pi, pi] from a wxyz quaternion."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def quat_from_axis_angle(axis, angle):
    half = angle * 0.5
    return torch.cat([torch.cos(half)[..., None], axis * torch.sin(half)[..., None]],
                     dim=-1)


def quat_integrate(q, omega_world, dt):
    """Integrate orientation by a world-frame angular velocity over dt with
    the exponential map, q' = exp(w dt / 2) * q.  Safe at omega = 0."""
    angle = torch.linalg.norm(omega_world, dim=-1, keepdim=True)
    half = 0.5 * dt * angle
    k = 0.5 * dt * torch.sinc(half / math.pi)   # = sin(half) / angle
    dq = torch.cat([torch.cos(half), omega_world * k], dim=-1)
    return quat_normalize(quat_mul(dq, q))


def wrap_to_pi(x):
    """Wrap angles into [-pi, pi)."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi
