"""booster_gym_torch.math against booster_gym_tpu.math on random batches
(f32 on both sides; tolerance 1e-5 absolute, a few f32 ulps of O(1)
values)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import booster_gym_tpu.math as jm
from booster_gym_tpu.math import spatial as jsp
import booster_gym_torch.math as tm

TOL = 1e-5


def quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def vecs(n, seed, d=3):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def close(t_out, j_out, tol=TOL):
    if isinstance(t_out, tuple):
        for a, b in zip(t_out, j_out):
            close(a, b, tol)
        return
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["quat_normalize", "quat_conj", "quat_to_matrix",
                                  "euler_xyz_from_quat"])
def test_unary_quat_functions(name):
    q = quats(64, 0) * 1.7
    close(getattr(tm, name)(torch.as_tensor(q)), getattr(jm, name)(jnp.asarray(q)))


@pytest.mark.parametrize("name", ["quat_rotate", "quat_rotate_inverse"])
def test_rotations(name):
    q, v = quats(64, 1), vecs(64, 2)
    close(getattr(tm, name)(torch.as_tensor(q), torch.as_tensor(v)),
          getattr(jm, name)(jnp.asarray(q), jnp.asarray(v)))


def test_quat_mul():
    a, b = quats(64, 3), quats(64, 4)
    close(tm.quat_mul(torch.as_tensor(a), torch.as_tensor(b)),
          jm.quat_mul(jnp.asarray(a), jnp.asarray(b)))


def test_euler_and_axis_angle():
    rng = np.random.default_rng(5)
    r, p, y = (rng.uniform(-3, 3, 64).astype(np.float32) for _ in range(3))
    close(tm.quat_from_euler_xyz(*map(torch.as_tensor, (r, p, y))),
          jm.quat_from_euler_xyz(*map(jnp.asarray, (r, p, y))))
    axis = vecs(64, 6)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    close(tm.quat_from_axis_angle(torch.as_tensor(axis), torch.as_tensor(r)),
          jm.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(r)))


def test_integrate_and_wrap():
    q, w = quats(64, 7), vecs(64, 8) * 3
    w[:4] = 0.0   # the sinc path at rest
    close(tm.quat_integrate(torch.as_tensor(q), torch.as_tensor(w), 0.002),
          jm.quat_integrate(jnp.asarray(q), jnp.asarray(w), 0.002))
    x = np.random.default_rng(9).uniform(-20, 20, 256).astype(np.float32)
    close(tm.wrap_to_pi(torch.as_tensor(x)), jm.wrap_to_pi(jnp.asarray(x)), tol=1e-5)


def test_spatial():
    v = vecs(32, 10)
    close(tm.skew(torch.as_tensor(v)), jsp.skew(jnp.asarray(v)))
    m = np.random.default_rng(11).uniform(0.5, 3, 32).astype(np.float32)
    A = vecs(32, 12, 9).reshape(32, 3, 3)
    I = (A @ A.transpose(0, 2, 1)).astype(np.float32)
    close(tm.spatial_inertia_at_origin(*map(torch.as_tensor, (m, v, I))),
          jsp.spatial_inertia_at_origin(*map(jnp.asarray, (m, v, I))), tol=1e-4)
    R = tm.quat_to_matrix(torch.as_tensor(quats(32, 13))).numpy()
    close(tm.rotate_inertia(*map(torch.as_tensor, (R, I))),
          jsp.rotate_inertia(*map(jnp.asarray, (R, I))), tol=1e-4)
    s6 = vecs(32, 14, 6)
    close(tm.crm(torch.as_tensor(s6)), jsp.crm(jnp.asarray(s6)))
    close(tm.crf(torch.as_tensor(s6)), jsp.crf(jnp.asarray(s6)))
