"""Contact sample points from an MJCF's collision geoms (port of
booster_gym_tpu/model/mjcf_points.py).

The standup task samples its contact points from the MJCF collision geoms
that the MuJoCo oracle collides, in place of the URDF primitives: a
capsule is a swept sphere, so stations along its axis with the capsule's
radius reproduce its surface for the sphere-vs-terrain contact test.  The
JAX package compiles the MJCF with mujoco; the port reads it with
eval/mujoco_eval.py's load_mjcf_geoms and places every point the same way,
including the JAX function's frame convention: a geom whose body the URDF
merged into an ancestor keeps its pos and quat in its own body's frame and
is attached to that ancestor unchanged.
"""

import dataclasses

import numpy as np

from booster_gym_torch.eval.mujoco_eval import load_mjcf_geoms


def _quat_to_mat(q_wxyz):
    w, x, y, z = q_wxyz
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _geom_points(kind, size, spacing):
    """Sample points (geom frame) and radii of one MJCF geom."""
    if kind == "sphere":
        return np.zeros((1, 3)), np.array([size[0]])
    if kind == "capsule":
        r, hl = float(size[0]), float(size[1])
        k = max(2, int(np.ceil(2 * hl / spacing)) + 1)
        s = np.linspace(-hl, hl, k)
        return np.stack([np.zeros(k), np.zeros(k), s], axis=-1), np.full(k, r)
    if kind == "box":
        hx, hy, hz = size[:3]
        corners = np.array([[hx * a, hy * b, hz * c]
                            for a in (-1, 1) for b in (-1, 1) for c in (-1, 1)])
        return corners, np.zeros(8)
    if kind == "cylinder":
        r, hl = float(size[0]), float(size[1])
        angles = 2 * np.pi * np.arange(6) / 6
        ring = np.stack([r * np.cos(angles), r * np.sin(angles), np.zeros(6)], axis=-1)
        return np.concatenate([ring + [0, 0, hl], ring + [0, 0, -hl]]), np.zeros(12)
    raise NotImplementedError(f"MJCF geom type {kind}")


def with_mjcf_collision(model, mjcf_path, spacing=0.03):
    """RobotModel with its contact point set rebuilt from the MJCF's
    collision geoms (contype or conaffinity non-zero; planes are the
    ground).  Each geom goes to the nearest body of its MJCF ancestry that
    is one of the model's bodies."""
    point_body, point_pos, point_radius, point_shape, shape_body = [], [], [], [], []
    for g in load_mjcf_geoms(mjcf_path):
        if g["contype"] == 0 and g["conaffinity"] == 0:
            continue
        if g["type"] == "plane":
            continue   # the ground
        name = next((n for n in g["chain"] if n in model.body_names), None)
        if name is None:
            raise ValueError(f"MJCF geom on body {g['body']} has no movable ancestor among "
                             f"{model.body_names}")
        body_idx = model.body_index(name)
        pts, radii = _geom_points(g["type"], g["size"], spacing)
        pts = g["pos"] + pts @ _quat_to_mat(g["quat"]).T
        sid = len(shape_body)
        shape_body.append(body_idx)
        point_body.extend([body_idx] * len(pts))
        point_pos.append(pts)
        point_radius.append(radii)
        point_shape.extend([sid] * len(pts))
    if not shape_body:
        raise ValueError(f"no collision geoms found in {mjcf_path}")
    return dataclasses.replace(
        model,
        point_body=np.array(point_body, dtype=np.int32),
        point_pos=np.concatenate(point_pos).astype(np.float64),
        point_radius=np.concatenate(point_radius).astype(np.float64),
        point_shape=np.array(point_shape, dtype=np.int32),
        shape_body=np.array(shape_body, dtype=np.int32),
    )
