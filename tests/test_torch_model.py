"""The port's URDF parser, robot stand-ins and config copy against the JAX
package: every RobotModel field must be equal (exact for integers,
rtol 1e-12 for floats: both parsers run the same float64 NumPy code)."""

import dataclasses

import numpy as np
import pytest

from booster_gym_tpu.model import load_urdf as jax_load_urdf
from booster_gym_tpu.model.urdf import RobotModel as JaxRobotModel
from booster_gym_tpu.utils.config import load_task_cfg as jax_load_task_cfg

from booster_gym_torch.model import RobotModel, load_urdf
from booster_gym_torch.testing import toy_model, write_t1_shaped_urdf
from booster_gym_torch.utils.config import load_task_cfg


def _jax_toy_model():
    """The toy robot of tests/test_pallas_small.py:27-54 (copied)."""
    eye = np.eye(3)
    return JaxRobotModel(
        body_names=("base", "thigh", "foot"),
        dof_names=("hip", "knee"),
        parent=np.array([-1, 0, 1]),
        joint_pos=np.array([[0.0, 0, 0], [0, 0.05, -0.2], [0, 0, -0.25]]),
        joint_rot=np.stack([eye, eye, eye]),
        joint_axis=np.array([[0.0, 0, 1], [0, 1, 0], [1, 0, 0]]),
        body_mass=np.array([3.0, 1.0, 0.4]),
        body_com=np.array([[0.0, 0, 0], [0, 0, -0.1], [0.02, 0, -0.02]]),
        body_inertia=np.stack([0.05 * eye, 0.01 * eye, 0.002 * eye]),
        dof_lower=np.array([-1.5, -2.0]),
        dof_upper=np.array([1.5, 2.0]),
        dof_vel_limit=np.array([20.0, 20.0]),
        dof_effort=np.array([30.0, 30.0]),
        point_body=np.array([0, 0, 0, 0, 1, 1, 2, 2]),
        point_pos=np.array([
            [0.1, 0.1, -0.1], [0.1, -0.1, -0.1], [-0.1, 0.1, -0.1],
            [-0.1, -0.1, -0.1], [0, 0, -0.1], [0, 0, -0.2],
            [0.05, 0, -0.05], [-0.05, 0, -0.05],
        ]),
        point_radius=np.full(8, 0.02),
        point_shape=np.array([0, 0, 0, 0, 1, 1, 2, 2]),
        shape_body=np.array([0, 1, 2]),
    )


def assert_models_equal(ours, ref):
    assert [f.name for f in dataclasses.fields(RobotModel)] == \
        [f.name for f in dataclasses.fields(JaxRobotModel)]
    for f in dataclasses.fields(RobotModel):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, tuple):
            assert a == b, f.name
        elif np.asarray(b).dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15, err_msg=f.name)


def test_toy_model_equals_jax_test_robot():
    assert_models_equal(toy_model(), _jax_toy_model())


@pytest.mark.parametrize("rim", [4, 6])
def test_t1_shaped_urdf_parses_like_jax(tmp_path, rim):
    path = write_t1_shaped_urdf(tmp_path)
    ours = load_urdf(path, cylinder_rim_points=rim)
    assert_models_equal(ours, jax_load_urdf(path, cylinder_rim_points=rim))
    assert ours.num_bodies == 13 and ours.num_dofs == 12
    assert ours.num_points == {4: 56, 6: 72}[rim]


def test_t1_shaped_has_t1_names_and_collapses_fixed_links(tmp_path):
    m = load_urdf(write_t1_shaped_urdf(tmp_path), cylinder_rim_points=4)
    assert m.body_names[0] == "Trunk"
    assert m.dof_names[0] == "Left_Hip_Pitch" and m.dof_names[6] == "Right_Hip_Pitch"
    for key in ("Hip_Pitch", "Hip_Roll", "Hip_Yaw", "Knee_Pitch", "Ankle_Pitch", "Ankle_Roll"):
        assert sum(key in n for n in m.dof_names) == 2, key
    for fixed in ("H1", "H2", "AL", "AR", "Waist"):
        assert fixed not in m.body_names
    # the trunk absorbs head, arms and waist: 8 + 0.5 + 1.5 + 2 + 2 + 2.5
    assert m.body_mass[0] == pytest.approx(16.5)
    assert m.body_mass.sum() == pytest.approx(30.5)
    chain, b = [], m.body_index("left_foot_link")
    while b != -1:
        chain.append(m.body_names[b])
        b = int(m.parent[b])
    assert chain == ["left_foot_link", "Ankle_Cross_Left", "Shank_Left", "Hip_Yaw_Left",
                     "Hip_Roll_Left", "Hip_Pitch_Left", "Trunk"]
    # the foot box's bottom corners are T1.yaml's feet_edge_pos
    foot = m.body_index("left_foot_link")
    pts = m.point_pos[m.point_body == foot]
    bottom = pts[pts[:, 2] < -0.02]
    expect = np.array(load_task_cfg("T1")["asset"]["feet_edge_pos"])
    key = lambda a: a[np.lexsort((a[:, 1], a[:, 0]))]
    np.testing.assert_allclose(key(bottom), key(expect), atol=1e-9)


def test_task_config_copy_equals_jax():
    assert load_task_cfg("T1") == jax_load_task_cfg("T1")
