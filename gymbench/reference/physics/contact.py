"""Velocity-level contact solver, batch-leading (port of
booster_gym_tpu/physics/contact.py).

Static contact candidates (the robot's collision sample points) are tested
against the terrain every substep.  Per-body 6x6 Delassus operators
Lambda_b = J_b M^-1 J_b^T give per-point 3x3 effective masses
D_p = P_p Lambda_b P_p^T with P_p = [-skew(r) | I]; the impulses come from a
fixed number of Jacobi sweeps with mass splitting, a closed-form 3x3
inverse and a friction-cone projection; Baumgarte pushout is capped and
restitution is gated by the bounce threshold.
"""

import torch

from gymbench.reference.physics.dynamics import apply_J, apply_JT, matvec

cross = torch.linalg.cross


def _inv3x3(A):
    """Closed-form (adjugate) batched 3x3 inverse."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = c * h - b * i
    co_c = b * f - c * e
    det = a * co_a + d * co_b + g * co_c
    adj = torch.stack(
        [co_a, co_b, co_c,
         f * g - d * i, a * i - c * g, c * d - a * f,
         d * h - e * g, b * g - a * h, a * e - b * d], dim=-1).reshape(A.shape)
    return adj * (1.0 / det)[..., None, None]


def _mul_skew_left(r, A):
    """skew(r) @ A."""
    rx, ry, rz = r[..., 0, None], r[..., 1, None], r[..., 2, None]
    return torch.stack([ry * A[..., 2, :] - rz * A[..., 1, :],
                        rz * A[..., 0, :] - rx * A[..., 2, :],
                        rx * A[..., 1, :] - ry * A[..., 0, :]], dim=-2)


def _mul_skew_right(A, r):
    """A @ skew(r)."""
    rx, ry, rz = r[..., 0, None], r[..., 1, None], r[..., 2, None]
    return torch.stack([A[..., :, 1] * rz - A[..., :, 2] * ry,
                        A[..., :, 2] * rx - A[..., :, 0] * rz,
                        A[..., :, 0] * ry - A[..., :, 1] * rx], dim=-1)


def detect_plane(consts, point_pos_w):
    """Penetration depth and normal per point on the z = 0 plane."""
    depth = consts.point_radius - point_pos_w[..., 2]
    normal = torch.zeros_like(point_pos_w)
    normal[..., 2] = 1.0
    return depth, normal


def detect(consts, terrain, point_pos_w):
    """Penetration depth and surface normal per point on `terrain`, queried
    at the points' own xy."""
    h, n = terrain.heights_and_normals(point_pos_w[..., :2])
    return h + consts.point_radius - point_pos_w[..., 2], n


def detect_carried(consts, point_pos_w, heights, normals):
    """Depth and normal from terrain heights [B, npt] and unit normals
    [B, npt, 3] that the caller sampled (the substep kernels' inputs)."""
    return heights + consts.point_radius - point_pos_w[..., 2], normals


def solve(cfg, consts, shape_friction, shape_restitution, M_inv, J, phi, u_free,
          point_pos_w, depth, normal, root_pos):
    """Projected per-point impulse solve in body-level form.  Returns
    (u_new, lam [B, npt, 3], body_forces [B, nb, 3])."""
    pb = consts.point_body
    B, nb = u_free.shape[0], consts.nb
    nv = M_inv.shape[-1]
    active = (depth > -cfg.contact_margin).to(u_free.dtype)
    onehot = consts.onehot
    r = point_pos_w - root_pos[:, None, :]

    X2 = J.reshape(B, nb * 6, nv) @ M_inv
    Lam = X2.reshape(B, nb, 6, nv) @ J.transpose(-1, -2)
    Lp = Lam[:, pb]
    Lww, Lwv = Lp[..., :3, :3], Lp[..., :3, 3:]
    Lvw, Lvv = Lp[..., 3:, :3], Lp[..., 3:, 3:]
    D = (Lvv - _mul_skew_right(_mul_skew_left(r, Lww), r)
         - _mul_skew_left(r, Lwv) + _mul_skew_right(Lvw, r))

    counts = (active @ onehot) @ onehot.T
    split = torch.clamp(counts, min=1.0)
    eye = torch.eye(3, dtype=D.dtype, device=D.device)
    D_inv = _inv3x3(D * split[..., None, None] + 1e-8 * eye)

    mu = 0.5 * (shape_friction[:, consts.point_shape] + cfg.terrain_friction)
    e = 0.5 * (shape_restitution[:, consts.point_shape] + cfg.terrain_restitution)

    def point_velocities(v_bodies):
        vb = v_bodies[:, pb]
        return vb[..., 3:] + cross(vb[..., :3], r)

    v_bodies_free = apply_J(consts, phi, u_free)
    v_pre_n = torch.sum(point_velocities(v_bodies_free) * normal, dim=-1)
    pushout = torch.clamp(
        cfg.baumgarte * torch.clamp(depth - cfg.contact_slop, min=0.0) / cfg.dt,
        max=cfg.max_pushout_vel)
    bounce = torch.where(v_pre_n < -cfg.bounce_threshold, -e * v_pre_n,
                         torch.zeros_like(v_pre_n))
    v_target = normal * torch.maximum(pushout, bounce)[..., None]

    def wrench(lam):
        torque = cross(r, lam)
        return torch.cat([torch.einsum("pn,bpi->bni", onehot, torque),
                          torch.einsum("pn,bpi->bni", onehot, lam)], dim=-1)

    def project(lam_new):
        ldn = torch.sum(lam_new * normal, dim=-1)
        ln = torch.clamp(ldn, min=0.0)
        lt = lam_new - ldn[..., None] * normal
        lt_norm = torch.linalg.norm(lt, dim=-1)
        scale = torch.clamp(mu * ln / torch.clamp(lt_norm, min=1e-9), max=1.0)
        return (normal * ln[..., None] + lt * scale[..., None]) * active[..., None]

    lam = torch.zeros_like(point_pos_w)
    for _ in range(cfg.solver_iterations):
        du = matvec(M_inv, apply_JT(consts, phi, wrench(lam)))
        v = point_velocities(v_bodies_free + apply_J(consts, phi, du))
        dlam = torch.sum(D_inv * (v_target - v)[..., None, :], dim=-1)
        lam = project(lam + cfg.relaxation * dlam)

    w = wrench(lam)
    u_new = u_free + matvec(M_inv, apply_JT(consts, phi, w))
    return u_new, lam, w[..., 3:] / cfg.dt
