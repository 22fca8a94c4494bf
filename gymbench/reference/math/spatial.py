"""Spatial (6D) rigid-body algebra on batch-leading torch tensors.

Port of booster_gym_tpu/math/spatial.py.  Spatial motion vectors are
[omega(3); v(3)] in world axes at one common origin; spatial forces are
[n(3); f(3)].
"""

import torch


def skew(v):
    """Skew-symmetric matrices of 3-vectors: skew(v) @ u = v x u."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def rotate_inertia(R, I):
    """I_world = R I_body R^T."""
    return R @ I @ R.transpose(-1, -2)


def spatial_inertia_at_origin(mass, com_world, inertia_world):
    """6x6 spatial inertia about the origin:
    [[I_c - m cx cx, m cx], [-m cx, m 1]], with cx cx expanded as
    c c^T - |c|^2 I so the construction stays elementwise."""
    cx = skew(com_world)
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=com_world.dtype, device=com_world.device).expand(cx.shape)
    outer = com_world[..., :, None] * com_world[..., None, :]
    norm2 = torch.sum(com_world * com_world, dim=-1)[..., None, None]
    top = torch.cat([inertia_world + m * (norm2 * eye - outer), m * cx], dim=-1)
    bottom = torch.cat([-m * cx, m * eye], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def crm(v):
    """Motion cross-product operator: crm(v) @ m = v x m."""
    wx = skew(v[..., :3])
    vox = skew(v[..., 3:])
    top = torch.cat([wx, torch.zeros_like(wx)], dim=-1)
    bottom = torch.cat([vox, wx], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def crf(v):
    """Force cross-product operator: crf(v) = -crm(v)^T."""
    return -crm(v).transpose(-1, -2)
