"""The port's MJCF reader (booster_gym_torch/eval/mujoco_eval.py) and
with_mjcf_collision (booster_gym_torch/model/mjcf_points.py) against the
JAX package's with_mjcf_collision, which compiles the MJCF with mujoco.

Robots: the 23-DoF serial stand-in of booster_gym_torch.testing (two trunk
capsules, one by fromto and one by quat, shank capsules whose type and
size come from a nested default class, foot boxes under a childclass, and
a palm body that the URDF merges into its hand), and small MJCFs written
here for fromto cylinders and capsules in every direction, quats on boxes
and cylinders, class inheritance and a merged body.  Tolerance: points and
radii within 1e-6 (both sides place each point with the same float64
arithmetic; mujoco normalises quats and turns fromto into a quat itself).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

from booster_gym_tpu.model import load_urdf as jax_load_urdf  # noqa: E402
from booster_gym_tpu.model.mjcf_points import with_mjcf_collision as jax_with_mjcf  # noqa: E402

from booster_gym_torch.eval.mujoco_eval import load_mjcf_geoms, quat_z_to_vec  # noqa: E402
from booster_gym_torch.model import load_urdf  # noqa: E402
from booster_gym_torch.model.mjcf_points import with_mjcf_collision  # noqa: E402
from booster_gym_torch.testing import write_t1_serial_mjcf, write_t1_serial_urdf  # noqa: E402

TOL = 1e-6
FIELDS = ("point_body", "point_pos", "point_radius", "point_shape", "shape_body")

# a three-link arm: base (free), upper and fore on hinges, a tip merged into
# the fore link by a fixed joint
ARM_URDF = """<?xml version="1.0"?>
<robot name="arm">
  <link name="base"><inertial><mass value="2"/><inertia ixx="0.1" iyy="0.1" izz="0.1"/>
  </inertial><collision><geometry><box size="0.2 0.2 0.2"/></geometry></collision></link>
  <link name="upper"><inertial><mass value="1"/><inertia ixx="0.01" iyy="0.01" izz="0.01"/>
  </inertial></link>
  <link name="fore"><inertial><mass value="1"/><inertia ixx="0.01" iyy="0.01" izz="0.01"/>
  </inertial></link>
  <link name="tip"><inertial><mass value="0.1"/><inertia ixx="0.001" iyy="0.001" izz="0.001"/>
  </inertial></link>
  <joint name="shoulder" type="revolute"><parent link="base"/><child link="upper"/>
    <origin xyz="0 0.1 0.2"/><axis xyz="0 1 0"/><limit lower="-1" upper="1" effort="5"
    velocity="5"/></joint>
  <joint name="elbow" type="revolute"><parent link="upper"/><child link="fore"/>
    <origin xyz="0 0 -0.3"/><axis xyz="1 0 0"/><limit lower="-1" upper="1" effort="5"
    velocity="5"/></joint>
  <joint name="tip_fixed" type="fixed"><parent link="fore"/><child link="tip"/>
    <origin xyz="0.05 0 -0.25"/></joint>
</robot>
"""


def arm_mjcf(base_geoms, upper_geoms, fore_geoms, tip_geoms, defaults=""):
    return textwrap.dedent(f"""\
        <mujoco model="arm">
          <compiler angle="radian"/>
          <default>{defaults}</default>
          <worldbody>
            <geom name="floor" type="plane" size="0 0 1"/>
            <body name="base" pos="0 0 1"><freejoint/>
              <inertial pos="0 0 0" mass="2" diaginertia="0.1 0.1 0.1"/>{base_geoms}
              <body name="upper" pos="0 0.1 0.2">
                <inertial pos="0 0 0" mass="1" diaginertia="0.01 0.01 0.01"/>
                <joint name="shoulder" axis="0 1 0" range="-1 1"/>{upper_geoms}
                <body name="fore" pos="0 0 -0.3" childclass="limb">
                  <inertial pos="0 0 0" mass="1" diaginertia="0.01 0.01 0.01"/>
                  <joint name="elbow" axis="1 0 0" range="-1 1"/>{fore_geoms}
                  <body name="tip" pos="0.05 0 -0.25">
                    <inertial pos="0 0 0" mass="0.1" diaginertia="0.001 0.001 0.001"/>
                    {tip_geoms}
                  </body>
                </body>
              </body>
            </body>
          </worldbody>
        </mujoco>
        """)


LIMB = ('<default class="limb"><geom type="capsule" size="0.03 0.1"/>'
        '<default class="thin"><geom size="0.01"/></default></default>'
        '<default class="ghost"><geom contype="0" conaffinity="0"/></default>')

ARMS = {
    # fromto capsules and cylinders along +-z, along an axis, and oblique
    "fromto": arm_mjcf(
        '<geom type="capsule" size="0.05" fromto="0 0 -0.1 0 0 0.2"/>'
        '<geom type="cylinder" size="0.04" fromto="0.1 0 0 0.1 0 -0.15"/>',
        '<geom type="capsule" size="0.03" fromto="0 0 0 0.02 -0.05 -0.3"/>'
        '<geom type="cylinder" size="0.02" fromto="0 0 0 0.2 0 0"/>',
        '<geom class="ghost" type="box" size="0.1 0.1 0.1"/>',
        '<geom type="sphere" size="0.02"/>', LIMB),
    # quats (normalised by the compiler) on boxes, cylinders and capsules
    "quat": arm_mjcf(
        '<geom type="box" size="0.1 0.05 0.02" pos="0 0 0.1" quat="0.9 0.1 0.3 -0.2"/>',
        '<geom type="cylinder" size="0.03 0.1" pos="0 0 -0.15" quat="1 0.5 0 0"/>',
        '<geom size="0.03 0.12" pos="0 0 -0.1" quat="0.7 0 0.7 0"/>',
        '<geom type="box" size="0.02 0.02 0.02" quat="0.5 0.5 0.5 0.5"/>', LIMB),
    # defaults: the fore link's childclass, a nested class that overrides
    # only the radius, a class that turns collisions off, and the tip (a
    # body the URDF merges into fore) in its own frame
    "classes": arm_mjcf(
        '<geom type="sphere" size="0.1"/>',
        '<geom class="limb" pos="0 0 -0.15"/>',
        '<geom pos="0 0 -0.12"/><geom class="thin" pos="0.02 0 -0.12"/>'
        '<geom class="ghost" size="0.2"/>',
        '<geom type="sphere" size="0.015" pos="0.01 0 -0.02"/>', LIMB),
}


def compare(port_model, jax_model, mjcf):
    ours = with_mjcf_collision(port_model, mjcf)
    theirs = jax_with_mjcf(jax_model, mjcf)
    for f in FIELDS:
        a, b = np.asarray(getattr(ours, f)), np.asarray(getattr(theirs, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=f)
    return ours


@pytest.fixture(scope="module")
def serial(tmp_path_factory):
    d = tmp_path_factory.mktemp("serial")
    return write_t1_serial_urdf(d), write_t1_serial_mjcf(d)


def test_serial_standin_points_match_jax(serial):
    urdf, mjcf = serial
    model = compare(load_urdf(urdf), jax_load_urdf(urdf), mjcf)
    assert model.num_bodies == 24 and model.num_dofs == 23
    # 2 trunk capsules, head, 2 forearms, 2 palms, 2 thighs, 2 shanks, 2 feet
    assert len(model.shape_body) == 13 and model.num_points == 85
    # the palms' spheres sit on their hands in the palm frame (the JAX
    # function's convention): at the hand link's origin, not 0.22 m out
    for side in ("left", "right"):
        hand = model.body_index(f"{side}_hand_link")
        radius = model.point_radius[model.point_body == hand]
        pos = model.point_pos[model.point_body == hand]
        assert np.any(radius == 0.04)
        np.testing.assert_array_equal(pos[radius == 0.04], [[0.0, 0.0, 0.0]])


@pytest.mark.parametrize("case", sorted(ARMS))
def test_small_mjcfs_match_jax(case, tmp_path):
    urdf, mjcf = tmp_path / "arm.urdf", tmp_path / f"{case}.xml"
    urdf.write_text(ARM_URDF)
    mjcf.write_text(ARMS[case])
    model = compare(load_urdf(str(urdf)), jax_load_urdf(str(urdf)), str(mjcf))
    assert model.num_bodies == 3


def test_geoms_match_mujocos_compiled_model(serial):
    """Every geom the reader returns against mujoco's compiled model: body,
    type, size, pos and quat (up to the sign of a quat)."""
    _, mjcf = serial
    m = mujoco.MjModel.from_xml_path(mjcf)
    geoms = load_mjcf_geoms(mjcf)
    assert len(geoms) == m.ngeom
    names = {int(t): n for n, t in (("plane", mujoco.mjtGeom.mjGEOM_PLANE),
                                    ("sphere", mujoco.mjtGeom.mjGEOM_SPHERE),
                                    ("capsule", mujoco.mjtGeom.mjGEOM_CAPSULE),
                                    ("box", mujoco.mjtGeom.mjGEOM_BOX),
                                    ("cylinder", mujoco.mjtGeom.mjGEOM_CYLINDER))}
    for gid, g in enumerate(geoms):
        body = mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_BODY, int(m.geom_bodyid[gid]))
        assert g["body"] == body and g["type"] == names[int(m.geom_type[gid])]
        np.testing.assert_allclose(g["pos"], m.geom_pos[gid], atol=TOL)
        q = m.geom_quat[gid] * np.sign(np.dot(m.geom_quat[gid], g["quat"]))
        np.testing.assert_allclose(g["quat"], q, atol=TOL)
        if g["type"] != "plane":
            n = {"sphere": 1, "capsule": 2, "cylinder": 2, "box": 3}[g["type"]]
            np.testing.assert_allclose(g["size"][:n], m.geom_size[gid][:n], atol=TOL)
        assert (g["contype"], g["conaffinity"]) == (m.geom_contype[gid], m.geom_conaffinity[gid])


def test_quat_z_to_vec_turns_z_onto_the_vector():
    rng = np.random.default_rng(0)
    for v in [*rng.normal(size=(20, 3)), np.array([0.0, 0, 1]), np.array([0.0, 0, -2])]:
        q = quat_z_to_vec(v)
        res = np.zeros(3)
        mujoco.mju_rotVecQuat(res, np.array([0.0, 0, 1]), q)
        np.testing.assert_allclose(res, v / np.linalg.norm(v), atol=1e-12)
        mq = np.zeros(4)
        mujoco.mju_quatZ2Vec(mq, np.asarray(v, np.float64))
        np.testing.assert_allclose(q, mq, atol=1e-12)


@pytest.mark.parametrize("where", ["geom", "body", "default"])
def test_unread_orientations_raise(where, tmp_path):
    geom = '<geom type="box" size="0.1 0.1 0.1"{}/>'
    xml = {
        "geom": arm_mjcf(geom.format(' euler="0 0 0.3"'), "", "", "", LIMB),
        "body": arm_mjcf("", "", "", "", LIMB).replace(
            '<body name="tip" pos="0.05 0 -0.25">', '<body name="tip" pos="0.05 0 -0.25" '
            'axisangle="0 0 1 0.3">'),
        "default": arm_mjcf("", "", "", "", LIMB + '<default class="tilt"><geom '
                            'xyaxes="1 0 0 0 1 0"/></default>'),
    }[where]
    path = tmp_path / "bad.xml"
    path.write_text(xml)
    with pytest.raises(NotImplementedError, match="euler|axisangle|xyaxes"):
        load_mjcf_geoms(str(path))


def test_a_collision_geom_off_the_robot_raises(tmp_path):
    urdf, mjcf = tmp_path / "arm.urdf", tmp_path / "world.xml"
    urdf.write_text(ARM_URDF)
    mjcf.write_text(arm_mjcf("", "", "", "", LIMB).replace(
        '<geom name="floor" type="plane" size="0 0 1"/>',
        '<geom name="floor" type="plane" size="0 0 1"/><geom type="box" size="1 1 0.1"/>'))
    with pytest.raises(ValueError, match="no movable ancestor"):
        with_mjcf_collision(load_urdf(str(urdf)), str(mjcf))
    with pytest.raises(ValueError, match="no movable ancestor"):
        jax_with_mjcf(jax_load_urdf(str(urdf)), str(mjcf))


def test_reader_imports_neither_mujoco_nor_jax(serial):
    """The port places the points with mujoco unimportable, and imports no
    JAX on the way."""
    urdf, mjcf = serial
    code = textwrap.dedent(f"""
        import sys
        sys.modules["mujoco"] = None
        from booster_gym_torch.model import load_urdf
        from booster_gym_torch.model.mjcf_points import with_mjcf_collision
        m = with_mjcf_collision(load_urdf({urdf!r}), {mjcf!r})
        assert m.num_points == 85
        bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "booster_gym_tpu")]
        assert not bad, bad
        print("ok")
        """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": root})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_sources_import_neither_jax_nor_the_jax_package():
    """No module of booster_gym_torch, and not chip_smoke.py, has an import
    line that names jax or booster_gym_tpu (the package's name stands only
    in docstrings and comments)."""
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|booster_gym_tpu)\b")
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root, "booster_gym_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [f"{path}:{i}" for path in files
           for i, line in enumerate(open(path, encoding="utf-8"), 1) if pattern.match(line)]
    assert len(files) > 30 and not bad, bad
