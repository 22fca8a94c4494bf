"""Robots built in code, update inputs made from a seed and the main path's
configuration, and the H100's peaks and a CUDA-event timer, for the tests,
chip_smoke.py, profile_iteration.py and prof_update.py only.

The training path never imports this module.  The vendor T1 assets
(resources/T1/T1_locomotion.urdf, T1_serial.urdf and T1_serial.xml) are
not in the repository, so the port's tests and its smoke run use stand-ins
written here: the 23-DoF serial robot's (t1_serial_urdf_text and
t1_serial_mjcf_text), and a T1-shaped one with the T1's names and exactly
the T1's widths: after fixed-joint collapsing it has 13 bodies,
12 DoF and, at cylinder_rim_points 4, 56 contact points (8 trunk-box
corners, 4 cylinders x 8 rim points, 2 foot boxes x 8 corners).  Masses and
lengths are those of a ~30 kg humanoid whose feet touch the ground when the
trunk stands at init_state.pos z = 0.72 with the T1.yaml default angles,
and its link inertias keep every joint stable under the T1.yaml PD gains
at the 2 ms substep.
"""

import math
import os
import subprocess

import numpy as np

from booster_gym_torch.model.urdf import RobotModel
from booster_gym_torch.utils.config import load_task_cfg

H100_BYTES_PER_S = 3.35e12      # HBM3, SXM
H100_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
H100_BF16_OPS_PER_S = 989e12    # bf16 tensor cores, dense


def _box_inertia(m, sx, sy, sz):
    return (m * (sy * sy + sz * sz) / 12, m * (sx * sx + sz * sz) / 12,
            m * (sx * sx + sy * sy) / 12)


def _cyl_inertia(m, r, length):
    side = m * (3 * r * r + length * length) / 12
    return side, side, 0.5 * m * r * r


def _inertial(m, com, diag):
    return (f'<inertial><origin xyz="{com[0]} {com[1]} {com[2]}" rpy="0 0 0"/>'
            f'<mass value="{m}"/><inertia ixx="{diag[0]:.6g}" ixy="0" ixz="0" '
            f'iyy="{diag[1]:.6g}" iyz="0" izz="{diag[2]:.6g}"/></inertial>')


def _link(name, m, com, diag, collision=""):
    return f'<link name="{name}">{_inertial(m, com, diag)}{collision}</link>'


def _box(xyz, size):
    return (f'<collision><origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}" rpy="0 0 0"/>'
            f'<geometry><box size="{size[0]} {size[1]} {size[2]}"/></geometry>'
            f'</collision>')


def _cylinder(xyz, r, length):
    return (f'<collision><origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}" rpy="0 0 0"/>'
            f'<geometry><cylinder radius="{r}" length="{length}"/></geometry>'
            f'</collision>')


def _joint(name, kind, parent, child, xyz, axis=None, limit=None):
    out = (f'<joint name="{name}" type="{kind}"><parent link="{parent}"/>'
           f'<child link="{child}"/><origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}" '
           f'rpy="0 0 0"/>')
    if axis is not None:
        out += f'<axis xyz="{axis[0]} {axis[1]} {axis[2]}"/>'
    if limit is not None:
        lo, hi, effort, vel = limit
        out += (f'<limit lower="{lo}" upper="{hi}" effort="{effort}" '
                f'velocity="{vel}"/>')
    return out + "</joint>"


def t1_shaped_urdf_text():
    """URDF text of the T1-shaped stand-in robot."""
    links = [
        _link("Trunk", 8.0, (0.0, 0.0, 0.1), _box_inertia(8.0, 0.15, 0.2, 0.3),
              _box((0.0, 0.0, 0.15), (0.15, 0.2, 0.3))),
        _link("H1", 0.5, (0.0, 0.0, 0.03), _cyl_inertia(0.5, 0.03, 0.06)),
        _link("H2", 1.5, (0.0, 0.0, 0.08), _box_inertia(1.5, 0.15, 0.15, 0.16)),
        _link("AL", 2.0, (0.0, 0.0, -0.2), _cyl_inertia(2.0, 0.04, 0.45)),
        _link("AR", 2.0, (0.0, 0.0, -0.2), _cyl_inertia(2.0, 0.04, 0.45)),
        _link("Waist", 2.5, (0.0, 0.0, -0.03), _box_inertia(2.5, 0.15, 0.22, 0.08)),
    ]
    joints = [
        _joint("Head_Neck", "fixed", "Trunk", "H1", (0.0, 0.0, 0.3)),
        _joint("Head_Top", "fixed", "H1", "H2", (0.0, 0.0, 0.06)),
        _joint("Left_Shoulder", "fixed", "Trunk", "AL", (0.0, 0.15, 0.25)),
        _joint("Right_Shoulder", "fixed", "Trunk", "AR", (0.0, -0.15, 0.25)),
        _joint("Waist_Fixed", "fixed", "Trunk", "Waist", (0.0, 0.0, -0.05)),
    ]
    for side, sign in (("Left", 1.0), ("Right", -1.0)):
        s = side
        links += [
            _link(f"Hip_Pitch_{s}", 1.0, (0.0, 0.0, -0.01), _box_inertia(1.0, 0.06, 0.06, 0.04)),
            _link(f"Hip_Roll_{s}", 1.0, (0.0, 0.0, -0.04), _box_inertia(1.0, 0.06, 0.06, 0.08)),
            _link(f"Hip_Yaw_{s}", 2.5, (0.0, 0.0, -0.1), _cyl_inertia(2.5, 0.05, 0.2),
                  _cylinder((0.0, 0.0, -0.1), 0.05, 0.2)),
            _link(f"Shank_{s}", 1.8, (0.0, 0.0, -0.14), _cyl_inertia(1.8, 0.04, 0.24),
                  _cylinder((0.0, 0.0, -0.14), 0.04, 0.24)),
            _link(f"Ankle_Cross_{s}", 0.1, (0.0, 0.0, 0.0), _box_inertia(0.1, 0.03, 0.03, 0.03)),
            # the foot's roll inertia must exceed dt * kd / 2 = 1e-3 kg m^2
            # (ankle damping 1.0 N m s/rad, dt 2 ms), or the explicit joint
            # damping over-corrects every substep and the ankle roll chatters
            _link(f"{s.lower()}_foot_link", 0.6, (0.01, 0.0, -0.015), (0.003, 0.005, 0.006),
                  _box((0.01, 0.0, -0.01), (0.223, 0.1, 0.04))),
        ]
        roll = (-0.2, 1.57) if sign > 0 else (-1.57, 0.2)
        joints += [
            _joint(f"{s}_Hip_Pitch", "revolute", "Trunk", f"Hip_Pitch_{s}",
                   (0.0, sign * 0.106, -0.12), (0, 1, 0), (-1.8, 1.57, 45.0, 12.5)),
            _joint(f"{s}_Hip_Roll", "revolute", f"Hip_Pitch_{s}", f"Hip_Roll_{s}",
                   (0.0, 0.0, -0.02), (1, 0, 0), (*roll, 30.0, 10.9)),
            _joint(f"{s}_Hip_Yaw", "revolute", f"Hip_Roll_{s}", f"Hip_Yaw_{s}",
                   (0.0, 0.0, -0.08), (0, 0, 1), (-1.0, 1.0, 30.0, 10.9)),
            _joint(f"{s}_Knee_Pitch", "revolute", f"Hip_Yaw_{s}", f"Shank_{s}",
                   (0.0, 0.0, -0.2), (0, 1, 0), (0.0, 2.34, 60.0, 11.7)),
            _joint(f"{s}_Ankle_Pitch", "revolute", f"Shank_{s}", f"Ankle_Cross_{s}",
                   (0.0, 0.0, -0.28), (0, 1, 0), (-0.87, 0.35, 24.0, 18.8)),
            _joint(f"{s}_Ankle_Roll", "revolute", f"Ankle_Cross_{s}",
                   f"{s.lower()}_foot_link", (0.0, 0.0, 0.0), (1, 0, 0),
                   (-0.44, 0.44, 15.0, 12.4)),
        ]
    return ('<?xml version="1.0"?>\n<robot name="T1_shaped">\n'
            + "\n".join(links + joints) + "\n</robot>\n")


def write_t1_shaped_urdf(directory):
    """Write the stand-in URDF into `directory`; returns its absolute path."""
    path = os.path.abspath(os.path.join(directory, "T1_shaped.urdf"))
    with open(path, "w", encoding="utf-8") as f:
        f.write(t1_shaped_urdf_text())
    return path


def t1_shaped_mjcf_text(base_height=0.72):
    """MJCF text of the T1-shaped stand-in, read from its URDF: each link a
    body at its joint's origin with the link's inertial and collision boxes
    and cylinders, each revolute joint a hinge with the URDF's range and a
    motor of the joint's name with ctrlrange +-effort (the 12 actuators in
    joint order, named as T1.yaml's gain and angle keys match them), the
    trunk on a free joint at `base_height`, and the IMU the MuJoCo
    evaluation reads: an `orientation` framequat and an `angular-velocity`
    gyro on a site at the trunk's origin.  The robot's geoms collide with
    the ground plane only."""
    import xml.etree.ElementTree as ET

    root = ET.fromstring(t1_shaped_urdf_text())
    vec = lambda text: " ".join(f"{float(v):.6g}" for v in text.split())
    links = {link.get("name"): link for link in root.findall("link")}
    children = {}
    for j in root.findall("joint"):
        children.setdefault(j.find("parent").get("link"), []).append(j)
    motors = []

    def link_xml(name):
        link = links[name]
        inertial = link.find("inertial")
        i = inertial.find("inertia")
        parts = [f'<inertial pos="{vec(inertial.find("origin").get("xyz"))}" '
                 f'mass="{inertial.find("mass").get("value")}" diaginertia="{i.get("ixx")} '
                 f'{i.get("iyy")} {i.get("izz")}"/>']
        for c in link.findall("collision"):
            pos, geom = vec(c.find("origin").get("xyz")), c.find("geometry")
            if geom.find("box") is not None:
                half = " ".join(f"{float(v) / 2:.6g}" for v in geom.find("box").get("size").split())
                parts.append(f'<geom type="box" size="{half}" pos="{pos}"/>')
            else:
                cyl = geom.find("cylinder")
                parts.append(f'<geom type="cylinder" size="{cyl.get("radius")} '
                             f'{float(cyl.get("length")) / 2:.6g}" pos="{pos}"/>')
        for j in children.get(name, []):
            child = j.find("child").get("link")
            head = f'<body name="{child}" pos="{vec(j.find("origin").get("xyz"))}">'
            hinge = ""
            if j.get("type") == "revolute":
                lim = j.find("limit")
                hinge = (f'<joint name="{j.get("name")}" type="hinge" '
                         f'axis="{vec(j.find("axis").get("xyz"))}" range="{lim.get("lower")} '
                         f'{lim.get("upper")}"/>')
                motors.append((j.get("name"), float(lim.get("effort"))))
            parts.append(head + hinge + link_xml(child) + "</body>")
        return "".join(parts)

    trunk = (f'<body name="Trunk" pos="0 0 {base_height}"><freejoint/>'
             '<site name="imu" pos="0 0 0"/>' + link_xml("Trunk") + "</body>")
    actuators = "".join(f'<motor name="{n}" joint="{n}" ctrllimited="true" '
                        f'ctrlrange="{-e:g} {e:g}"/>' for n, e in motors)
    return ('<mujoco model="T1_shaped">\n<compiler angle="radian"/>\n'
            '<default><geom contype="1" conaffinity="0"/></default>\n<worldbody>\n'
            '<geom name="ground" type="plane" size="0 0 1" contype="0" conaffinity="1"/>\n'
            + trunk + "\n</worldbody>\n<actuator>" + actuators + "</actuator>\n<sensor>"
            '<framequat name="orientation" objtype="site" objname="imu"/>'
            '<gyro name="angular-velocity" site="imu"/></sensor>\n</mujoco>\n')


def write_t1_shaped_mjcf(directory):
    """Write the stand-in MJCF into `directory`; returns its absolute
    path."""
    path = os.path.abspath(os.path.join(directory, "T1_shaped.xml"))
    with open(path, "w", encoding="utf-8") as f:
        f.write(t1_shaped_mjcf_text())
    return path


# The 23-DoF serial stand-in: the bodies and joints of the SDK's serial
# order (head x 2, left arm x 4, right arm x 4, waist, left leg x 6, right
# leg x 6), each (joint, joint type, parent, child, joint origin, axis,
# (lower, upper, effort, velocity)), then each link's (mass, com, diagonal
# inertia).  The legs hang from the waist where the T1-shaped robot hangs
# them from the trunk, at the same points at q = 0; the arms point sideways
# at q = 0 (+y left, -y right), so that T1Serial.yaml's shoulder rolls of
# -+1.35 rad lower them.  Each palm is a link on a fixed joint: the URDF
# loader merges it into its hand.
def _serial_joints():
    joints = [
        ("AAHead_yaw", "revolute", "Trunk", "H1", (0.0, 0.0, 0.3), (0, 0, 1),
         (-1.57, 1.57, 7.0, 12.0)),
        ("Head_pitch", "revolute", "H1", "H2", (0.0, 0.0, 0.06), (0, 1, 0),
         (-0.35, 1.22, 7.0, 12.0)),
    ]
    for side, sign, arm in (("Left", 1.0, "AL"), ("Right", -1.0, "AR")):
        hand = f"{side.lower()}_hand_link"
        roll = (-1.74, 1.57) if sign > 0 else (-1.57, 1.74)
        yaw = (-2.5, 0.3) if sign > 0 else (-0.3, 2.5)
        joints += [
            (f"{side}_Shoulder_Pitch", "revolute", "Trunk", f"{arm}1", (0.0, sign * 0.12, 0.25),
             (0, 1, 0), (-3.3, 1.2, 18.0, 7.3)),
            (f"{side}_Shoulder_Roll", "revolute", f"{arm}1", f"{arm}2", (0.0, sign * 0.05, 0.0),
             (1, 0, 0), (*roll, 18.0, 7.3)),
            (f"{side}_Elbow_Pitch", "revolute", f"{arm}2", f"{arm}3", (0.0, sign * 0.2, 0.0),
             (0, 1, 0), (-2.27, 2.27, 18.0, 7.3)),
            (f"{side}_Elbow_Yaw", "revolute", f"{arm}3", hand, (0.0, sign * 0.05, 0.0),
             (0, 0, 1), (*yaw, 18.0, 7.3)),
        ]
    joints.append(("Waist", "revolute", "Trunk", "Waist", (0.0, 0.0, -0.05), (0, 0, 1),
                   (-1.57, 1.57, 30.0, 10.9)))
    for side, sign in (("Left", 1.0), ("Right", -1.0)):
        s = side
        roll = (-0.2, 1.57) if sign > 0 else (-1.57, 0.2)
        joints += [
            (f"{s}_Hip_Pitch", "revolute", "Waist", f"Hip_Pitch_{s}", (0.0, sign * 0.106, -0.07),
             (0, 1, 0), (-1.8, 1.57, 45.0, 12.5)),
            (f"{s}_Hip_Roll", "revolute", f"Hip_Pitch_{s}", f"Hip_Roll_{s}", (0.0, 0.0, -0.02),
             (1, 0, 0), (*roll, 30.0, 10.9)),
            (f"{s}_Hip_Yaw", "revolute", f"Hip_Roll_{s}", f"Hip_Yaw_{s}", (0.0, 0.0, -0.08),
             (0, 0, 1), (-1.0, 1.0, 30.0, 10.9)),
            (f"{s}_Knee_Pitch", "revolute", f"Hip_Yaw_{s}", f"Shank_{s}", (0.0, 0.0, -0.2),
             (0, 1, 0), (0.0, 2.34, 60.0, 11.7)),
            (f"{s}_Ankle_Pitch", "revolute", f"Shank_{s}", f"Ankle_Cross_{s}", (0.0, 0.0, -0.28),
             (0, 1, 0), (-0.87, 0.35, 24.0, 18.8)),
            (f"{s}_Ankle_Roll", "revolute", f"Ankle_Cross_{s}", f"{s.lower()}_foot_link",
             (0.0, 0.0, 0.0), (1, 0, 0), (-0.44, 0.44, 15.0, 12.4)),
        ]
    for side, sign in (("left", 1.0), ("right", -1.0)):
        joints.append((f"{side}_palm_fixed", "fixed", f"{side}_hand_link", f"{side}_palm",
                       (0.0, sign * 0.22, 0.0), None, None))
    return joints


def _serial_links():
    links = {
        "Trunk": (8.0, (0.0, 0.0, 0.1), _box_inertia(8.0, 0.15, 0.2, 0.3)),
        "H1": (0.5, (0.0, 0.0, 0.03), _cyl_inertia(0.5, 0.03, 0.06)),
        "H2": (1.5, (0.0, 0.0, 0.08), _box_inertia(1.5, 0.15, 0.15, 0.16)),
        "Waist": (2.5, (0.0, 0.0, -0.03), _box_inertia(2.5, 0.15, 0.22, 0.08)),
    }
    for arm, sign, side in (("AL", 1.0, "left"), ("AR", -1.0, "right")):
        links[f"{arm}1"] = (0.3, (0.0, sign * 0.02, 0.0), _box_inertia(0.3, 0.05, 0.05, 0.05))
        links[f"{arm}2"] = (0.7, (0.0, sign * 0.1, 0.0), _cyl_inertia(0.7, 0.035, 0.2))
        links[f"{arm}3"] = (0.3, (0.0, sign * 0.02, 0.0), _box_inertia(0.3, 0.05, 0.05, 0.05))
        links[f"{side}_hand_link"] = (0.5, (0.0, sign * 0.1, 0.0), _cyl_inertia(0.5, 0.03, 0.2))
        links[f"{side}_palm"] = (0.1, (0.0, 0.0, 0.0), _box_inertia(0.1, 0.06, 0.06, 0.06))
    for s in ("Left", "Right"):
        links.update({
            f"Hip_Pitch_{s}": (1.0, (0.0, 0.0, -0.01), _box_inertia(1.0, 0.06, 0.06, 0.04)),
            f"Hip_Roll_{s}": (1.0, (0.0, 0.0, -0.04), _box_inertia(1.0, 0.06, 0.06, 0.08)),
            f"Hip_Yaw_{s}": (2.5, (0.0, 0.0, -0.1), _cyl_inertia(2.5, 0.05, 0.2)),
            f"Shank_{s}": (1.8, (0.0, 0.0, -0.14), _cyl_inertia(1.8, 0.04, 0.24)),
            f"Ankle_Cross_{s}": (0.1, (0.0, 0.0, 0.0), _box_inertia(0.1, 0.03, 0.03, 0.03)),
            f"{s.lower()}_foot_link": (0.6, (0.01, 0.0, -0.015), (0.003, 0.005, 0.006)),
        })
    return links


def _rotated_cylinder(xyz, rpy, r, length):
    return (f'<collision><origin xyz="{xyz[0]} {xyz[1]} {xyz[2]}" '
            f'rpy="{rpy[0]} {rpy[1]} {rpy[2]}"/><geometry><cylinder radius="{r}" '
            f'length="{length}"/></geometry></collision>')


def t1_serial_urdf_text():
    """URDF text of the 23-DoF serial stand-in: 24 bodies after the palms
    merge into the hands, and 121 contact points at the default 6 rim
    points (8 trunk-box corners, a head sphere, 8 cylinders x 12 rim
    points on the upper arms, forearms, thighs and shanks, 2 foot boxes x 8
    corners)."""
    collisions = {
        "Trunk": _box((0.0, 0.0, 0.15), (0.15, 0.2, 0.3)),
        "H2": ('<collision><origin xyz="0 0 0.08" rpy="0 0 0"/><geometry>'
               '<sphere radius="0.08"/></geometry></collision>'),
    }
    for arm, sign, side in (("AL", 1.0, "left"), ("AR", -1.0, "right")):
        rpy = (-sign * 1.5707963267948966, 0.0, 0.0)   # the cylinder's z along +-y
        collisions[f"{arm}2"] = _rotated_cylinder((0.0, sign * 0.1, 0.0), rpy, 0.035, 0.2)
        collisions[f"{side}_hand_link"] = _rotated_cylinder((0.0, sign * 0.1, 0.0), rpy,
                                                            0.03, 0.2)
    for s in ("Left", "Right"):
        collisions[f"Hip_Yaw_{s}"] = _cylinder((0.0, 0.0, -0.1), 0.05, 0.2)
        collisions[f"Shank_{s}"] = _cylinder((0.0, 0.0, -0.14), 0.04, 0.24)
        collisions[f"{s.lower()}_foot_link"] = _box((0.01, 0.0, -0.01), (0.223, 0.1, 0.04))
    links = [_link(name, m, com, diag, collisions.get(name, ""))
             for name, (m, com, diag) in _serial_links().items()]
    joints = [_joint(name, kind, parent, child, xyz, axis, limit)
              for name, kind, parent, child, xyz, axis, limit in _serial_joints()]
    return ('<?xml version="1.0"?>\n<robot name="T1_serial_standin">\n'
            + "\n".join(links + joints) + "\n</robot>\n")


def write_t1_serial_urdf(directory):
    """Write the serial stand-in URDF into `directory`; returns its absolute
    path."""
    path = os.path.abspath(os.path.join(directory, "T1_serial_standin.urdf"))
    with open(path, "w", encoding="utf-8") as f:
        f.write(t1_serial_urdf_text())
    return path


# The serial stand-in's MJCF collision geoms, by body: (class, attributes).
# Two trunk capsules (one placed by fromto, one by quat), a head sphere,
# thigh capsules on the hip-roll bodies that reach the knee, shank capsules
# whose type and size come from their class, forearm capsules turned onto
# the arm, foot boxes, and a sphere on each palm, a body that the URDF
# merges into its hand (so its geom keeps the palm's frame; see
# model/mjcf_points.py).  A visual box on the trunk and the ground plane
# are no contact sources.
_SERIAL_GEOMS = {
    "Trunk": [("collision", 'type="capsule" size="0.07" fromto="0 -0.06 0.05 0 -0.06 0.27"'),
              ("collision", 'type="capsule" size="0.07 0.11" pos="0 0.06 0.16" '
                            'quat="0.9962 0.0872 0 0"'),
              ("visual", 'size="0.075 0.1 0.15" pos="0 0 0.15"')],
    "H2": [("collision", 'type="sphere" size="0.08" pos="0 0 0.08"')],
}
for _s, _sign in (("left", 1.0), ("right", -1.0)):
    _SERIAL_GEOMS[f"{_s}_hand_link"] = [
        ("collision", f'type="capsule" size="0.03 0.1" pos="0 {_sign * 0.1} 0" '
                      f'quat="0.70710678 {-_sign * 0.70710678} 0 0"')]
    _SERIAL_GEOMS[f"{_s}_palm"] = [("collision", 'type="sphere" size="0.04"')]
for _s in ("Left", "Right"):
    _SERIAL_GEOMS[f"Hip_Roll_{_s}"] = [("collision", 'type="capsule" size="0.05 0.08" '
                                                     'pos="0 0 -0.16"')]
    _SERIAL_GEOMS[f"Shank_{_s}"] = [("shank", 'pos="0 0 -0.14"')]
    _SERIAL_GEOMS[f"{_s.lower()}_foot_link"] = [
        (None, 'type="box" size="0.1115 0.05 0.02" pos="0.01 0 -0.01"')]


def t1_serial_mjcf_text(base_height=0.72):
    """MJCF text of the serial stand-in: the URDF's bodies, joints (hinges
    with the URDF's limits) and inertials, the trunk on a free joint at
    `base_height`, and _SERIAL_GEOMS.  The legs' bodies take the
    collision class as their childclass, so the foot boxes name none."""
    joints = _serial_joints()
    links = _serial_links()
    children = {}
    for name, kind, parent, child, xyz, axis, limit in joints:
        children.setdefault(parent, []).append((name, kind, child, xyz, axis, limit))

    def inertial(name):
        m, com, diag = links[name]
        return (f'<inertial pos="{com[0]} {com[1]} {com[2]}" mass="{m}" '
                f'diaginertia="{diag[0]:.6g} {diag[1]:.6g} {diag[2]:.6g}"/>')

    def geoms(name):
        out = []
        for cls, attrs in _SERIAL_GEOMS.get(name, []):
            out.append(f'<geom {"" if cls is None else f"class={chr(34)}{cls}{chr(34)} "}'
                       f'{attrs}/>')
        return "".join(out)

    def body(name, xyz, joint, childclass):
        head = f'<body name="{name}" pos="{xyz[0]} {xyz[1]} {xyz[2]}"'
        if childclass:
            head += f' childclass="{childclass}"'
        parts = [head + ">", inertial(name)]
        if joint is not None:
            jname, axis, (lo, hi, _, _) = joint
            parts.append(f'<joint name="{jname}" type="hinge" axis="{axis[0]} {axis[1]} '
                         f'{axis[2]}" range="{lo} {hi}"/>')
        parts.append(geoms(name))
        for jname, kind, child, cxyz, axis, limit in children.get(name, []):
            leg = "Hip" in child or "Shank" in child or "Ankle" in child or "foot" in child
            parts.append(body(child, cxyz, None if kind == "fixed" else (jname, axis, limit),
                              "collision" if leg and not childclass else None))
        return "".join(parts) + "</body>"

    trunk = body("Trunk", (0.0, 0.0, base_height), None, None).replace(
        ">", "><freejoint/>", 1)
    return ('<mujoco model="T1_serial_standin">\n<compiler angle="radian"/>\n'
            '<default><geom contype="1" conaffinity="1"/>'
            '<default class="visual"><geom type="box" contype="0" conaffinity="0" group="1"/>'
            '</default><default class="collision"><geom group="3"/>'
            '<default class="shank"><geom type="capsule" size="0.04 0.12"/></default>'
            '</default></default>\n<worldbody>\n'
            '<geom name="ground" type="plane" size="0 0 1"/>\n'
            + trunk + "\n</worldbody>\n</mujoco>\n")


def write_t1_serial_mjcf(directory):
    """Write the serial stand-in MJCF into `directory`; returns its absolute
    path."""
    path = os.path.abspath(os.path.join(directory, "T1_serial_standin.xml"))
    with open(path, "w", encoding="utf-8") as f:
        f.write(t1_serial_mjcf_text())
    return path


def toy_model():
    """Floating base + 2-link chain ending in a 'foot' body, 8 contact
    points across 3 shapes (the toy robot of the JAX package's small
    substep-kernel tests)."""
    eye = np.eye(3)
    return RobotModel(
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


def main_path_cfg(urdf):
    """The T1 task config of the port's main path on the stand-in robot at
    `urdf`: flat terrain, 4096 envs, seed 0, 3 iterations; horizon 24, 20
    mini-epochs and update_backend fused as T1.yaml has them."""
    cfg = load_task_cfg("T1")
    cfg["env"]["num_envs"] = 4096
    cfg["terrain"]["type"] = "plane"
    cfg["asset"]["file"] = urdf
    cfg["basic"]["max_iterations"] = 3
    cfg["basic"]["seed"] = 0
    return cfg


def rough_path_cfg(urdf):
    """main_path_cfg on T1.yaml's own terrain block (trimesh: 8 tiles of
    10 m x 10 m, a 900 x 200 field)."""
    cfg = main_path_cfg(urdf)
    cfg["terrain"]["type"] = load_task_cfg("T1")["terrain"]["type"]
    return cfg


def serial_path_cfg(urdf):
    """T1Serial.yaml on the serial stand-in at `urdf`: 4096 envs, seed 0, 1
    iteration (its own plane terrain, horizon 24, 20 mini-epochs, the
    fused update)."""
    cfg = load_task_cfg("T1Serial")
    cfg["env"]["num_envs"] = 4096
    cfg["asset"]["file"] = urdf
    cfg["basic"]["max_iterations"] = 1
    cfg["basic"]["seed"] = 0
    return cfg


def standup_path_cfg(urdf, mjcf, task="T1Standup"):
    """T1Standup.yaml (or T1StandupFT.yaml) on the serial stand-in (`urdf`,
    and `mjcf` for its contact points): 4096 envs, seed 0, 2 iterations;
    the bank settles for the config's 60 control steps."""
    cfg = load_task_cfg(task)
    cfg["env"]["num_envs"] = 4096
    cfg["asset"]["file"] = urdf
    cfg["asset"]["mujoco_file"] = mjcf
    cfg["basic"]["max_iterations"] = 2
    cfg["basic"]["seed"] = 0
    return cfg


def mpc_path_cfg(urdf, terrain="plane"):
    """T1.yaml with one env, on the T1-shaped stand-in at `urdf`: the
    sampling MPC's setting (its K samples are the rollout's batch), seed
    0; on the plane, or with terrain="trimesh" on T1.yaml's own terrain
    block (a 900 x 200 field)."""
    cfg = load_task_cfg("T1")
    cfg["env"]["num_envs"] = 1
    cfg["terrain"]["type"] = terrain
    cfg["asset"]["file"] = urdf
    cfg["basic"]["seed"] = 0
    return cfg


def mpc_start(urdf, device, seed=0):
    """(env, state1, dyn1): mpc_path_cfg's env on `device`, and a start
    drawn on the CPU from `seed` (init_params, then reset_all), so that
    every device starts from the same state."""
    import torch

    from booster_gym_torch.envs.t1 import T1

    cfg = mpc_path_cfg(urdf)
    cpu = T1(cfg, "cpu")
    gen = torch.Generator().manual_seed(seed)
    params = cpu.init_params(gen)
    sim = cpu.reset_all(params, gen)[0].sim
    env = cpu if torch.device(device).type == "cpu" else T1(cfg, device)
    to = lambda obj: type(obj)(**{k: v.to(device) for k, v in vars(obj).items()})
    return env, to(sim), to(params.dyn)


def hold_mpc_rollout(mpc, state1, dyn1, noise, tol=2e-3, samples=16, seed=7):
    """The MPC's rollout for one plan (from mpc._mean and `noise`), one
    control step at a time, each step from the kernel's own state: the
    env's control_step (K1 on the card) against control_step_plain on the
    same inputs, state and cost held to `tol` (atol + rtol |b|), by the
    exclusion rules of chip_smoke.py's phases 3b and 8.  A sample whose
    plain state moves past `tol` under a one-ulp nudge of the input state
    is chaotic and left out.  A sample past `tol` otherwise (a resting
    contact's decision that falls the other way) passes only if the plain
    step reaches the kernel's outcome within `tol` from one of `samples`
    copies of its input state perturbed by rounding (each component times
    1 + eps N(0, 1), eps 1e-7 and 1e-6; N from a generator seeded with
    `seed`); it is counted as flipped and left out of the error.  Returns
    a dict: deltas [H, K, nd]; costs [H, K] of the kernel's states and
    plain_costs of the plain states; state_err [H], the largest state
    difference over the samples held; chaotic and flipped [H, K]; over
    [H], whether a sample past `tol` was not reached; finite_same, whether
    every step's state is finite exactly where the plain one is."""
    import torch

    from booster_gym_torch.mpc import tile

    sub, K = mpc.env.substep, mpc.num_samples
    deltas, targets = mpc.sample(mpc._mean, noise)
    state_k, dyn_k = tile(state1, dyn1, K)
    psim, pdyn = sub.pack_sim(state_k), sub.pack_dyn(dyn_k)
    fixed = mpc.rollout_inputs(K)
    gen = torch.Generator(device=psim.device).manual_seed(seed)
    ratio = lambda a, b: ((a - b).abs() / (tol + tol * b.abs()))
    plain = lambda ps, pd, t, fx: sub.control_step_plain(ps, pd, t, t, *fx,
                                                         decimation=mpc.decimation).state
    cost = lambda ps: mpc.cost_fn(sub.unpack_sim(ps))
    out = {k: [] for k in ("costs", "plain_costs", "state_err", "over", "chaotic", "flipped")}
    finite_same = True
    for t in targets:
        t = t.contiguous()
        kern = sub.control_step(psim, pdyn, t, t, *fixed, decimation=mpc.decimation).state
        ref = plain(psim, pdyn, t, fixed)
        nudged = torch.nextafter(psim, torch.full_like(psim, float("inf")))
        chaotic = (ratio(plain(nudged, pdyn, t, fixed), ref) > 1).any(0)
        finite = torch.isfinite(ref)
        finite_same &= torch.equal(torch.isfinite(kern), finite)
        cost_k, cost_p = cost(kern), cost(ref)
        off = ((ratio(kern, ref) > 1) & finite).any(0) | (ratio(cost_k, cost_p) > 1)
        off &= ~chaotic
        idx = off.nonzero()[:, 0]
        reached = torch.zeros_like(off)
        if len(idx):
            rep = lambda x: x[..., idx].repeat_interleave(samples, -1)
            x, d, o = rep(psim), rep(pdyn), rep(kern)
            tt = t[idx].repeat_interleave(samples, 0)
            fx = mpc.rollout_inputs(len(idx) * samples)   # the same for every sample
            best = None
            for eps in (1e-7, 1e-6):
                y = plain(x * (1 + eps * torch.randn(x.shape, generator=gen, device=x.device)),
                          d, tt, fx)
                r = torch.maximum(ratio(y, o).amax(0), ratio(cost(y), cost(o)))
                r = r.view(len(idx), samples).amin(1)
                best = r if best is None else torch.minimum(best, r)
            reached[idx] = best <= 1
        held = ~chaotic & ~off
        err = torch.where(finite, (kern - ref).abs(), 0.0)
        out["costs"].append(cost_k)
        out["plain_costs"].append(cost_p)
        out["state_err"].append(float(err[:, held].max()) if bool(held.any()) else 0.0)
        out["over"].append(bool((off & ~reached).any()))
        out["chaotic"].append(chaotic)
        out["flipped"].append(off & reached)
        psim = kern
    for k in ("costs", "plain_costs", "chaotic", "flipped"):
        out[k] = torch.stack(out[k])
    out.update(deltas=deltas, finite_same=finite_same)
    return out


def point_terrain_inputs(npt, B, seed):
    """Inputs of the general-terrain substep, as numpy: point heights
    [B, npt] in +-0.05 m and unit normals [B, npt, 3] tilted up to ~0.3 rad
    from +z."""
    rng = np.random.default_rng(seed)
    h = rng.uniform(-0.05, 0.05, (B, npt)).astype(np.float32)
    tilt, az = rng.uniform(0, 0.3, (B, npt)), rng.uniform(0, 2 * np.pi, (B, npt))
    n = np.stack([np.sin(tilt) * np.cos(az), np.sin(tilt) * np.sin(az), np.cos(tilt)], -1)
    return h, n.astype(np.float32)


def off_grid_lines(xy, terrain, margin=1e-3):
    """World xy (numpy) with every grid coordinate that lies within `margin`
    cells of a grid line moved to `margin` past it: across a line the
    terrain's slopes jump, and one rounding could change the cell."""
    g = xy / terrain.horizontal_scale
    frac = g - np.floor(g)
    g = np.where(frac < margin, np.floor(g) + margin, g)
    g = np.where(frac > 1 - margin, np.floor(g) + 1 + margin, g)
    return (g * terrain.horizontal_scale).astype(np.float32)


def sampler_inputs(terrain, B, N, reach, edge_roots, seed):
    """Inputs of the terrain sampler, as numpy: roots [B, 2] over the tiles
    (with edge_roots most of them within 1 m of the field's edges and
    corners) and queries [B, N, 2] up to `reach` metres from their root,
    off the grid lines."""
    rng = np.random.default_rng(seed)
    lo = -terrain.border_size
    hi = np.array([terrain.env_width, terrain.env_length]) + terrain.border_size
    if edge_roots:
        root = np.where(rng.random((B, 2)) < 0.5, lo + rng.uniform(0, 1, (B, 2)),
                        hi - rng.uniform(0, 1, (B, 2)))
        inner = rng.random((B, 2)) < 0.3     # some on an edge, not in a corner
        root = np.where(inner, rng.uniform(lo, hi, (B, 2)), root)
    else:
        root = rng.uniform(0.5, hi - terrain.border_size - 0.5, (B, 2))
    pts = root[:, None, :] + rng.uniform(-reach, reach, (B, N, 2))
    return root.astype(np.float32), off_grid_lines(pts, terrain)


def default_angles(model, task="T1"):
    """The default joint angles of `task`'s config for the model's dofs, by
    the env's rule: every key that is a substring of the dof's name sets
    it, in the config's order, and "default" where none is."""
    table = load_task_cfg(task)["init_state"]["default_joint_angles"]
    out = []
    for name in model.dof_names:
        hits = [v for k, v in table.items() if k != "default" and k in name]
        out.append(hits[-1] if hits else table["default"])
    return np.array(out)


def task_gains(model, task="T1"):
    """(kp, kd) [nd] of `task`'s config by the env's substring rule (the
    last matching key wins)."""
    ctl = load_task_cfg(task)["control"]
    pick = lambda table: np.array([[v for k, v in table.items() if k in name][-1]
                                   for name in model.dof_names])
    return pick(ctl["stiffness"]), pick(ctl["damping"])


def rand_inputs(model, B, device, seed, standing=False, task="T1"):
    """Random states (the JAX package's _rand_inputs, plus random contact
    materials); `standing` puts the T1-shaped robot (or, with task
    T1Serial, the serial stand-in) on its feet at its task's default
    angles."""
    import numpy as np
    import torch

    from booster_gym_torch.physics import DynParams, SimState

    rng = np.random.default_rng(seed)
    nd, ns = model.num_dofs, len(model.shape_body)
    quat = rng.normal(size=(B, 4))
    quat[: B // 2] = [1, 0, 0, 0]
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    pos = np.zeros((B, 3))
    pos[:, 2] = rng.uniform(0.2, 0.8, B)
    q = rng.uniform(-1, 1, (B, nd))
    qd = rng.uniform(-2, 2, (B, nd))
    if standing:
        pos[:, 2] = 0.72
        quat[:] = [1, 0, 0, 0]
        q = default_angles(model, task) + rng.normal(0, 0.05, (B, nd))
        qd = rng.normal(0, 0.2, (B, nd))
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    state = SimState(root_pos=t(pos), root_quat=t(quat),
                     root_lin_vel=t(rng.uniform(-1, 1, (B, 3))),
                     root_ang_vel=t(rng.uniform(-1, 1, (B, 3))), q=t(q), qd=t(qd))
    dyn = DynParams(body_mass=t(np.tile(model.body_mass, (B, 1))),
                    body_com=t(np.tile(model.body_com, (B, 1, 1))),
                    body_inertia=t(np.tile(model.body_inertia, (B, 1, 1, 1))),
                    shape_friction=t(rng.uniform(0.5, 1.5, (B, ns))),
                    shape_restitution=t(rng.uniform(0.0, 0.5, (B, ns))))
    tau = t(rng.uniform(-5, 5, (B, nd)))
    ef = t(rng.uniform(-2, 2, (B, 3)))
    et = t(rng.uniform(-0.5, 0.5, (B, 3)))
    return state, dyn, tau, ef, et


def control_inputs(kernel, model, B, device, seed, upright=True, terrain=None, task="T1"):
    """control_step's inputs on `device`: rand_inputs' dyn and push with
    states an env step starts from (`upright`: the T1-shaped robot standing,
    the toy's base upright at 0.5 m with slow velocities; else rand_inputs'
    random states, half of them tumbling), PD targets near q, the robot's
    torque limits, delays spread over 0..9, and gains and joint friction as
    the env draws them: T1.yaml's stiffness and damping scaled by U(0.95,
    1.05) and friction U(0, 2) on the T1-shaped robot; on the toy, whose
    0.4 kg foot has ~2e-3 kg m^2 about the knee, gains for which explicit
    damping stays stable (kd dt / I < 0.2): kp U(5, 20), kd U(0.05, 0.2),
    friction U(0, 0.2).  K5 also the terrain under the points, as the env
    carries it (see below).  `task` names the config whose default angles
    and gains a robot other than the toy takes (T1Serial for the serial
    stand-in)."""
    import dataclasses

    import numpy as np
    import torch

    from booster_gym_torch.physics.engine import ModelConsts, make_fk
    from booster_gym_torch.physics.kinematics import point_world_positions

    t1 = model.num_bodies > 3
    state, dyn, _, ef, et = rand_inputs(model, B, device, seed, standing=upright and t1,
                                        task=task)
    rng = np.random.default_rng(seed + 1)
    nd = model.num_dofs
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    if upright and not t1:
        quat = np.tile([1.0, 0, 0, 0], (B, 1)) + rng.normal(0, 0.05, (B, 4))
        state = dataclasses.replace(
            state, root_pos=t(np.tile([0.0, 0.0, 0.5], (B, 1))),
            root_quat=t(quat / np.linalg.norm(quat, axis=-1, keepdims=True)),
            root_lin_vel=0.3 * state.root_lin_vel, root_ang_vel=0.3 * state.root_ang_vel,
            qd=0.3 * state.qd)
    ph = pn = None
    if not kernel.plane:
        # as the env carries them: the robot over a random spot of the
        # tiles, raised by the terrain's height there, and the height and
        # normal of the field at each point's own xy
        root_xy = t(rng.uniform(0.5, [terrain.env_width - 0.5, terrain.env_length - 0.5],
                                (B, 2)))
        pos = state.root_pos.clone()
        pos[:, :2] = root_xy
        pos[:, 2] += terrain.heights(root_xy)
        state = dataclasses.replace(state, root_pos=pos)
        xy = point_world_positions(ModelConsts.build(model, device),
                                   *make_fk(model, device)(state))[..., :2]
        h, n = terrain.heights_and_normals(xy.contiguous())
        ph, pn = h.T.contiguous(), n.reshape(B, -1).T.contiguous()
    q = state.q.cpu().numpy()
    if t1:
        kp0, kd0 = task_gains(model, task)
        scale = lambda: rng.uniform(0.95, 1.05, (B, nd))
        kp, kd = kp0 * scale(), kd0 * scale()
        fric = rng.uniform(0, 2, (B, nd))
    else:
        kp, kd = rng.uniform(5, 20, (B, nd)), rng.uniform(0.05, 0.2, (B, nd))
        fric = rng.uniform(0, 0.2, (B, nd))
    args = [kernel.pack_sim(state), kernel.pack_dyn(dyn), t(q + rng.normal(0, 0.1, (B, nd))),
            t(q + rng.normal(0, 0.05, (B, nd))), torch.arange(B, device=device) % 10,
            t(kp), t(kd), t(fric), t(model.dof_effort),
            torch.cat([ef, et], dim=-1).contiguous(), ph, pn]
    return args


def update_inputs(network, T, B, device, seed):
    """A rollout's buffers for the PPO update, made with numpy from a seed
    and moved to `device`: buf = (obs, priv, act, mu, std, rew, done,
    timeout) at [T, B, ...] with actions drawn around the network's policy,
    the observation after the rollout, and raw advantages and returns for
    a gradient pass taken on its own."""
    import torch

    rng = np.random.default_rng(seed)
    f32 = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32), device=device)
    no = network.actor.layers[0].in_features
    npriv = network.critic.layers[0].in_features - no
    na = network.actor.layers[-1].out_features
    obs, priv = f32(T, B, no), f32(T, B, npriv)
    with torch.no_grad():
        mu, std = network.act(obs)
    act = mu + std * f32(T, B, na)
    done = torch.as_tensor(rng.random((T, B)) < 0.05, device=device)
    timeout = torch.as_tensor(rng.random((T, B)) < 0.05, device=device)
    buf = (obs, priv, act, mu, std.contiguous(), f32(T, B), done, timeout)
    return {"buf": buf, "obs_last": f32(B, no), "priv_last": f32(B, npriv),
            "adv": 0.3 + 2.0 * f32(T, B), "ret": f32(T, B)}


T1_DIMS = (12, 47, 14)   # (actions, observations, privileged observations)


def task_dims(task):
    """(actions, observations, privileged observations) of a task's config:
    T1 (12, 47, 14), T1Serial (23, 80, 14), T1Standup (12, 420, 14)."""
    env = load_task_cfg(task)["env"]
    return env["num_actions"], env["num_observations"], env["num_privileged_obs"]


def seeded_network(compute_dtype, device, seed, dims=T1_DIMS):
    """An ActorCritic of `dims` (T1's by default) drawn from a seed, logstd
    moved off its constant start, on `device`."""
    import torch

    from booster_gym_torch.algo.networks import ActorCritic

    gen = torch.Generator().manual_seed(seed)
    net = ActorCritic(*dims, compute_dtype=compute_dtype)
    net.reset_parameters(gen)
    with torch.no_grad():
        net.logstd.add_(0.1 * torch.randn(net.logstd.shape, generator=gen))
    return net.to(device)


def _ratio_bands(rng, n):
    """Importance ratios spread over [0.6, 0.75], [0.85, 1.15] and
    [1.25, 1.4], as float32."""
    band = rng.integers(0, 3, n)
    return (np.array([0.6, 0.85, 1.25])[band]
            + np.array([0.15, 0.3, 0.15])[band] * rng.random(n)).astype(np.float32)


def update_case(compute_dtype, T, B, device, seed=0, dims=T1_DIMS):
    """One gradient-pass case for K2-K4 against their plain versions:
    (FusedUpdate, flat params p, staged, prep, inputs of update_inputs).

    The network (of `dims`, T1's by default) is drawn from the seed.  The old policy sits a little off
    the current one, with the importance ratios spread over [0.6, 0.75],
    [0.85, 1.15] and [1.25, 1.4]: below, inside and above the clip range,
    and at least 0.05 from its bounds, where the clip's gradient jumps and
    one sample's rounding would move a visible share of the gradient."""
    import torch

    from booster_gym_torch.algo.ppo import flat_params
    from booster_gym_torch.algo.update_kernel import FusedUpdate

    net = seeded_network(compute_dtype, device, seed, dims)
    fused = FusedUpdate(net, clip_ratio=0.2, bound_coef=10.0)
    p = flat_params(net)
    staged = fused.stage(p)
    d = update_inputs(net, T, B, device, seed=seed + 1)
    obs, priv, act, mu, std = d["buf"][:5]
    prep = fused.prepare(obs, priv, act, mu + 0.02, torch.zeros((T, B), device=device),
                         d["obs_last"], d["priv_last"])
    zero = torch.zeros((), device=device)
    logp = fused.grads_stats_plain(staged, p, prep, d["adv"], d["ret"], zero, zero + 1.0,
                                   True)[3]
    ratio = _ratio_bands(np.random.default_rng(seed + 2), T * B)
    prep["old_logp"] = (logp - torch.log(torch.as_tensor(ratio, device=device))).view(T, B)
    return fused, p, staged, prep, d


def anchor_case(network, T, B, device, seed=0, ties=False):
    """Inputs of values, grads and policy_old_logp (K8-K10) made with numpy
    from a seed, for `network` on `device`: (FusedUpdate, flat params p, d)
    with d's obs, priv [T, B, dim], act [T, B, num_act] drawn around the
    policy, advantages adv and returns ret from N(0, 1) (as the reference's
    tests and tools/prof_update.py draw them), and old_logp [T, B], all
    f32.

    old_logp puts the importance ratios of the plain forward in
    update_case's bands, at least 0.05 from the clip bounds, for the
    comparisons on the card.  With `ties` the ratio of sample i aims at
    0.8, 1.0 and 1.2 for i % 3 = 0, 1, 2 and sits exactly on it wherever an
    f32 old_logp gives exp(logp - old_logp) == bound; the CPU tests take
    the subgradients there."""
    import torch

    from booster_gym_torch.algo.ppo import flat_params
    from booster_gym_torch.algo.update_kernel import FusedUpdate

    fused = FusedUpdate(network, clip_ratio=0.2, bound_coef=10.0)
    p = flat_params(network)
    rng = np.random.default_rng(seed)
    f32 = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32), device=device)
    no, npriv, na = fused.num_obs, fused.num_crit - fused.num_obs, fused.num_act
    d = {"obs": f32(T, B, no), "priv": f32(T, B, npriv)}
    with torch.no_grad():
        mu, std = network.act(d["obs"])
    d["act"] = mu + std * f32(T, B, na)
    d["adv"], d["ret"] = f32(T, B), f32(T, B)
    prep = fused.prepare(d["obs"], d["priv"], d["act"], mu, torch.zeros((T, B), device=device))
    logp = fused.policy_old_logp_plain(p, prep)[1]
    if ties:
        target = torch.tensor([0.8, 1.0, 1.2], device=device)[torch.arange(T * B) % 3]
        # log(target)'s float32 neighbours, nearest first
        cands, lo, hi = [torch.log(target)], torch.log(target), torch.log(target)
        for _ in range(4):
            lo, hi = torch.nextafter(lo, lo - 1.0), torch.nextafter(hi, hi + 1.0)
            cands += [hi, lo]
        old, found = logp - cands[0], torch.zeros_like(logp, dtype=torch.bool)
        for x in cands:
            o = logp - x
            hit = ~found & (torch.exp(logp - o) == target)
            old, found = torch.where(hit, o, old), found | hit
    else:
        ratio = _ratio_bands(np.random.default_rng(seed + 1), T * B)
        old = logp - torch.log(torch.as_tensor(ratio, device=device))
    d["old_logp"] = old.view(T, B)
    return fused, p, d


def card_line():
    """The first card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def bound(nbytes, nops, ops_per_s=H100_F32_OPS_PER_S):
    """(ms, "bytes" or "operations"): the least time an H100 takes to move
    `nbytes` through its memory and do `nops` operations at `ops_per_s`."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_cuda(fn, iters, warmup=3):
    """(ms per call of `fn` on the card, the last call's outputs): `warmup`
    calls, then `iters` calls between two CUDA events."""
    import torch

    for _ in range(warmup):
        out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, out


# the kernel of _device_events' sentinel (an int8 fill), left out of its
# counts
_SENTINEL = "FillFunctor<signed char>"


def _device_events(fn, calls, attempts=3):
    """torch.profiler's averages by name over `calls` calls of fn.  A first
    call runs in the profiler's warm-up step, which records nothing; the
    traced step opens and closes with a sentinel kernel (an int8 fill),
    left out of the averages.  A trace that holds no device event at all
    (seen once, a process's first trace) is taken again, up to `attempts`
    times.  A trace can still drop a kernel's record (per_call)."""
    import torch

    sentinel = torch.empty(1, dtype=torch.int8, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        warm = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                    schedule=warm) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            sentinel.fill_(0)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            sentinel.fill_(0)
            torch.cuda.synchronize()
            prof.step()
        events = prof.key_averages()
        if any(ev.device_type == torch.autograd.DeviceType.CUDA for ev in events):
            break
    return [ev for ev in events if _SENTINEL not in ev.key]


def per_call(count):
    """The launches per call that a profiler's count per call stands for.
    A trace drops kernel records now and then (1 or 2 of 10 calls' records
    of one kernel, in about every other chip_smoke run, with sentinels
    before and after the calls) and never adds one, so a count in
    (n - 1, n] stands for n launches per call: the next whole number."""
    return math.ceil(count - 1e-9)


def _device_time(ev):
    t = getattr(ev, "device_time_total", None)
    return ev.cuda_time_total if t is None else t


def device_ms(fn, names, calls=10):
    """({name: device ms per call}, {name: launches per call as counted})
    of the kernels whose names contain each of `names`, from torch.profiler
    over `calls` calls of fn.  The time per call is the mean recorded
    launch's times per_call's launches, so a dropped record does not lower
    it."""
    ms, count = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    for ev in _device_events(fn, calls):
        for k in names:
            if k in ev.key:
                ms[k] += _device_time(ev) / 1e3
                count[k] += ev.count
    ms = {k: t / max(count[k], 1) * per_call(count[k] / calls) for k, t in ms.items()}
    return ms, {k: n / calls for k, n in count.items()}


def device_kernels(fn, calls=10):
    """{kernel name: (launches per call as counted, device ms per launch)}
    of every device kernel (and copy or fill) that `calls` calls of fn ran,
    from torch.profiler: the events on the device, not the runtime calls
    that launched them."""
    import torch

    return {ev.key: (ev.count / calls, _device_time(ev) / 1e3 / ev.count)
            for ev in _device_events(fn, calls)
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count}


# ---------------------------------------------------------------------------
# Data parallelism: the ranks' work of tests/test_torch_parallel.py and of
# chip_smoke.py's phase 10 (each rank a process of launch(), or the whole
# run at world size 1 in the calling process)

def dp_cfg(urdf, num_envs=16, horizon=4, mini_epochs=2, iterations=1, compute_dtype="f32",
           terrain="plane", curriculum=True, seed=0):
    """main_path_cfg cut to a data-parallel check, with the command
    curriculum on (T1.yaml has it off) so that its draws and its
    all-reduce run; trimesh is a small field of 2 tiles of 4 m x 4 m."""
    cfg = main_path_cfg(urdf)
    cfg["env"]["num_envs"] = num_envs
    cfg["terrain"]["type"] = terrain
    if terrain == "trimesh":
        cfg["terrain"].update(num_terrains=2, terrain_width=4.0, terrain_length=4.0,
                              border_size=2.0)
    cfg["runner"].update(horizon_length=horizon, mini_epochs=mini_epochs, save_interval=1)
    cfg["algorithm"]["compute_dtype"] = compute_dtype
    cfg["commands"]["curriculum"] = curriculum
    cfg["basic"].update(max_iterations=iterations, seed=seed)
    return cfg


def restored_pieces(runner, ts, saved):
    """{piece: restored bitwise} for every piece of a port checkpoint that
    runner._init_state() gave back as (runner, ts)."""
    import torch

    sd = runner.ppo.network.state_dict()
    same = lambda a, b: torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu())
    return {
        "params": sorted(sd) == sorted(saved["params"])
        and all(same(sd[k], v) for k, v in saved["params"].items()),
        "m": same(ts.opt.m, saved["adam_m"]), "v": same(ts.opt.v, saved["adam_v"]),
        "count": ts.opt.count == saved["adam_count"],
        "lr": same(ts.lr, torch.tensor(saved["lr"], dtype=torch.float32)),
        "iteration": ts.iteration == saved["iteration"],
        "curriculum": same(ts.env_state.curriculum_prob, saved["curriculum"]),
        "generator": same(runner.gen.get_state(), saved["gen_state"])}


def _timed_group(group):
    """`group` whose all_reduce calls are logged as (numel, op, start, end):
    CUDA events on a card, host clock readings on the CPU."""
    import dataclasses
    import time

    import torch

    from booster_gym_torch.parallel import Group

    @dataclasses.dataclass(frozen=True)
    class TimedGroup(Group):
        log: list = dataclasses.field(default_factory=list)

        def all_reduce(self, x, op="sum"):
            cuda = self.device.type == "cuda"
            mark = (lambda: torch.cuda.Event(enable_timing=True)) if cuda else time.perf_counter
            start = mark()
            if cuda:
                start.record()
            out = super().all_reduce(x, op)
            end = mark()
            if cuda:
                end.record()
            self.log.append((x.numel(), op, start, end))
            return out

    return TimedGroup(**{f.name: getattr(group, f.name) for f in dataclasses.fields(group)})


def _log_ms(log):
    import torch

    out = []
    for numel, op, start, end in log:
        if isinstance(start, torch.cuda.Event):
            end.synchronize()
            out.append((numel, op, start.elapsed_time(end)))
        else:
            out.append((numel, op, 1e3 * (end - start)))
    return out


def _rank_group(cfg, device):
    """The rank's Group, as the runner builds it; on the CPU the rank runs
    one thread (the checks' batches are small, and the ranks share the host
    with whatever else runs there)."""
    import torch

    from booster_gym_torch.runner import build_group, resolve_device

    group = build_group(cfg, resolve_device(device))
    if group.device.type == "cpu":
        torch.set_num_threads(1)
    return group


def curriculum_check(env):
    """The curriculum grid after one _update_curriculum on a made-up state:
    every third env of the global batch resets after a success at a level
    that follows its global index, on a grid that starts below the clamp."""
    import torch

    g, dev = env.group, env.device
    B = env.global_envs
    i = torch.arange(B, device=dev)
    levels = torch.stack([i % 3 - 1, (i // 3) % 3 - 1], dim=-1)
    state = env._zero_state()
    state = state.replace(episode_length=torch.full_like(state.episode_length, 10_000),
                          env_curriculum_level=g.rows(levels),
                          curriculum_prob=torch.full_like(state.curriculum_prob, 0.25))
    mask = g.rows(i % 3 == 0)
    return env._update_curriculum(state, mask).cpu()


def probe_collectives(group):
    """{collective: "ok", or the error it raised, or what it got wrong} for
    each of Group's collectives on a tensor of the group's device: sum and
    max all-reduce, all-gather, broadcast, barrier."""
    import torch

    r = group.rank + 1.0
    x = lambda: torch.tensor([r, -r], device=group.device)
    ranks = torch.arange(1.0, group.world + 1.0)
    checks = {
        "all_reduce sum": (lambda: group.all_reduce(x()),
                           lambda y: y.tolist() == [ranks.sum().item(), -ranks.sum().item()]),
        "all_reduce max": (lambda: group.all_reduce(x(), op="max"),
                           lambda y: y.tolist() == [float(group.world), -1.0]),
        "all_gather": (lambda: group.all_gather(x()),
                       lambda y: y.tolist() == [v for k in ranks.tolist() for v in (k, -k)]),
        "broadcast": (lambda: group.broadcast(x()), lambda y: y.tolist() == [1.0, -1.0]),
        "barrier": (lambda: group.barrier(), lambda y: True)}
    out = {}
    for name, (run, ok) in checks.items():
        try:
            y = run()
            out[name] = "ok" if ok(None if y is None else y.cpu()) else f"wrong: {y.tolist()}"
        except Exception as e:      # reported by the caller, which fails on it
            out[name] = f"{type(e).__name__}: {e}"[:300]
    return out


def dp_train(spec, out_dir):
    """One rank's training run of a data-parallel check: Runner(spec["cfg"],
    spec["device"]) trains in out_dir (rank 0 writes logs/ there), then the
    rank's results go to out_dir/rank<r>.pt: the records; after each
    iteration the parameters, Adam m, v and count, and lr; the first
    iteration's rollout buffers (obs, priv, act, mu, std, rew, done,
    time_outs) on the CPU; the curriculum_check grid; the all-reduce calls
    of each iteration as (numel, op, ms); under spec["probe"] the
    probe_collectives of the group before training; and under
    spec["resume"] (a checkpoint path) restored_pieces of a second Runner
    resumed from it on the same group."""
    import copy

    import torch

    from booster_gym_torch.algo.ppo import flat_params
    from booster_gym_torch.runner import Runner
    from booster_gym_torch.utils.recorder import load_checkpoint

    os.chdir(out_dir)
    cfg = copy.deepcopy(spec["cfg"])
    group = _timed_group(_rank_group(cfg, spec["device"]))
    runner = Runner(cfg, device=spec["device"], group=group)
    ppo, net = runner.ppo, runner.ppo.network
    res = {"rank": group.rank, "world": group.world, "snaps": [], "reduce": [], "buffers": None}
    rollout, iteration = ppo.rollout, runner._iteration

    def first_rollout(*args):
        carry, buf = rollout(*args)
        if res["buffers"] is None:
            res["buffers"] = [b.cpu() for b in buf]
        return carry, buf

    def each_iteration(*args):
        group.log.clear()
        ts, rec = iteration(*args)
        res["snaps"].append({"p": flat_params(net).cpu(), "m": ts.opt.m.cpu(),
                             "v": ts.opt.v.cpu(), "count": ts.opt.count, "lr": ts.lr.cpu()})
        res["reduce"].append(_log_ms(group.log))
        return ts, rec

    if spec.get("probe"):
        res["collectives"] = probe_collectives(group)
    ppo.rollout, runner._iteration = first_rollout, each_iteration
    res["records"] = runner.train()
    res["curriculum"] = curriculum_check(runner.env) if cfg["commands"]["curriculum"] else None
    res["n_params"] = ppo.fused.n_params
    if spec.get("resume"):
        rcfg = copy.deepcopy(cfg)
        rcfg["basic"]["checkpoint"] = spec["resume"]
        resumed = Runner(rcfg, device=spec["device"], group=group)
        _, ts = resumed._init_state()
        res["restored"] = restored_pieces(resumed, ts, load_checkpoint(spec["resume"]))
    torch.save(res, os.path.join(out_dir, f"rank{group.rank}.pt"))


def dp_play(spec, out_dir):
    """One rank's play of a data-parallel check: Runner(spec["cfg"],
    spec["device"]) on the rank's group plays spec["steps"] steps
    (deterministic, and with spec["noisy"] a second play with noise),
    saved as out_dir/rank<r>.pt: the rank and world; "plays", one entry
    per play of {key: [steps, global envs, ...] numpy} on rank 0 and None
    on the others; the substep kernel's launches and fused samplings in
    the first play; and its ms by this rank's timer."""
    import copy

    import torch

    from booster_gym_torch.runner import Runner, _Timer

    os.chdir(out_dir)
    cfg = copy.deepcopy(spec["cfg"])
    group = _rank_group(cfg, spec["device"])
    runner = Runner(cfg, device=spec["device"], group=group)
    sub = runner.env.substep
    counts = lambda: (0, 0) if sub is None else (sub.launches, sub.fused_sampler_launches)
    res = {"rank": group.rank, "world": group.world, "plays": []}
    for deterministic in (True, False)[:1 + bool(spec.get("noisy"))]:
        n0 = counts()
        timer = _Timer(runner.device)
        traj = runner.play(num_steps=spec["steps"], deterministic=deterministic, timer=timer)
        if deterministic:
            res["ms"] = timer.ms("steps", "end")
            res["launches"], res["fused"] = (a - b for a, b in zip(counts(), n0))
        res["plays"].append(None if traj is None else
                            {k: np.stack([t[k] for t in traj]) for k in traj[0]})
    torch.save(res, os.path.join(out_dir, f"rank{group.rank}.pt"))


def dp_bank(spec, out_dir):
    """One rank's fallen-state bank of the standup task (spec["cfg"] on
    spec["device"], the generator seeded with the config's seed), saved as
    out_dir/rank<r>.pt: {field: [global batch, ...] on the CPU}."""
    import copy
    import dataclasses

    import torch

    from booster_gym_torch.envs import make_task

    cfg = copy.deepcopy(spec["cfg"])
    group = _rank_group(cfg, spec["device"])
    env = make_task(cfg, group.device, group)
    gen = torch.Generator(device=group.device).manual_seed(cfg["basic"]["seed"])
    bank = env.init_params(gen).init_bank
    torch.save({f.name: getattr(bank, f.name).cpu() for f in dataclasses.fields(bank)},
               os.path.join(out_dir, f"rank{group.rank}.pt"))


def dp_update(spec, out_dir):
    """One rank's PPO.update on its rows of fixed rollout buffers:
    spec["inputs"] is a pickle of host trees (flax params, Adam m0 and v0
    trees, lr0, count0, and the buffers (obs, priv, act, mu, std, rew, done,
    time_outs) [T, B, ...] with obs_last, priv_last [B, ...]), spec["cfg"]
    the task config (its update_backend and mini_epochs).  Saved as
    out_dir/rank<r>.pt: the flat parameters, Adam m, v and count, lr and the
    per-epoch stats after the update."""
    import copy
    import pickle
    import types

    import torch

    from booster_gym_torch.algo.ppo import PPO, OptState, flat_params
    from booster_gym_torch.convert import flat_from_flax, params_from_flax

    with open(spec["inputs"], "rb") as f:
        d = pickle.load(f)
    cfg = copy.deepcopy(spec["cfg"])
    buf = [torch.as_tensor(x) for x in d["buf"]]
    T, B = buf[0].shape[:2]
    cfg["env"]["num_envs"] = B
    group = _rank_group(cfg, spec["device"])
    rows = slice(group.lo, group.hi)
    env = types.SimpleNamespace(num_actions=buf[2].shape[-1], num_obs=buf[0].shape[-1],
                                num_privileged_obs=buf[1].shape[-1], group=group)
    ppo = PPO(env, cfg, group.device)
    net = ppo.network
    net.load_state_dict(params_from_flax(d["params"]))
    ts = types.SimpleNamespace(opt=OptState(m=flat_from_flax(net, d["m0"]),
                                            v=flat_from_flax(net, d["v0"]), count=d["count0"]),
                               lr=torch.tensor(d["lr0"]))
    last = [torch.as_tensor(d[k])[rows] for k in ("obs_last", "priv_last")]
    opt, lr, stats = ppo.update(ts, (None, *last), tuple(x[:, rows] for x in buf))
    torch.save({"p": flat_params(net), "m": opt.m, "v": opt.v, "count": opt.count, "lr": lr,
                "stats": stats}, os.path.join(out_dir, f"rank{group.rank}.pt"))


# Learning: the JAX package's tests/test_learning.py on the port, for
# tests/test_torch_learning.py and chip_smoke.py's phase 12

LEARNING_EARLY = slice(20, 60)   # first episodes finish ~iteration 17 (8 s / 0.02 / 24)
LEARNING_LATE = slice(-40, None)


def learning_cfg(urdf, num_envs=64):
    """tests/test_learning.py's config on the robot at `urdf`: T1.yaml on
    flat terrain, horizon 24, 5 mini-epochs, lr 3e-4, 8 s episodes, and a
    clean learning signal (no observation noise, no kicks or pushes, no
    randomized initial joints or base velocity, gentle commands)."""
    cfg = load_task_cfg("T1")
    cfg["env"]["num_envs"] = num_envs
    cfg["terrain"]["type"] = "plane"
    cfg["asset"]["file"] = urdf
    cfg["runner"]["horizon_length"] = 24
    cfg["runner"]["mini_epochs"] = 5
    cfg["rewards"]["episode_length_s"] = 8.0
    cfg["algorithm"]["learning_rate"] = 3.e-4
    cfg["noise"] = {}
    r = cfg["randomization"]
    r["kick_interval_s"] = 1000.0
    r["push_interval_s"] = 1000.0
    r.pop("init_dof_pos", None)
    r.pop("init_base_lin_vel_xy", None)
    cfg["commands"]["lin_vel_x"] = [-0.3, 0.5]
    cfg["commands"]["lin_vel_y"] = [-0.2, 0.2]
    cfg["commands"]["ang_vel_yaw"] = [-0.3, 0.3]
    cfg["commands"]["still_proportion"] = 0.2
    return cfg


def learning_rule(rewards, steps):
    """tests/test_learning.py's rule on per-iteration reward and episode
    steps: the LATE window's mean reward above max(1.5 x EARLY's, EARLY's
    + 0.1), and its mean steps above 0.85 x EARLY's.  Returns (ok, early
    reward, late reward, early steps, late steps)."""
    rewards, steps = np.asarray(rewards, np.float64), np.asarray(steps, np.float64)
    early_r, late_r = rewards[LEARNING_EARLY].mean(), rewards[LEARNING_LATE].mean()
    early_s, late_s = steps[LEARNING_EARLY].mean(), steps[LEARNING_LATE].mean()
    ok = bool(np.all(np.isfinite(rewards)) and late_r > max(1.5 * early_r, early_r + 0.1)
              and late_s > 0.85 * early_s)
    return ok, float(early_r), float(late_r), float(early_s), float(late_s)


def learning_check(cfg, iterations, seed, device, every=0, log=print):
    """Train `cfg` for `iterations` train iterations from PPO.init on a
    generator seeded with `seed` (the JAX test's PRNGKey(seed)), as
    tests/test_learning.py does.  Returns (rewards, steps, counts): numpy
    arrays of the per-iteration metrics, and the env's and update's kernel
    launches in the run.  With `every`, logs the reward each `every`
    iterations."""
    import torch

    from booster_gym_torch.algo.ppo import PPO
    from booster_gym_torch.envs import make_task

    env = make_task(cfg, device)
    ppo = PPO(env, cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    env_params, ts = ppo.init(gen)
    launches = lambda: (0 if env.substep is None else env.substep.launches,
                        ppo.fused.gae_launches, ppo.fused.grads_stats_launches,
                        ppo.fused.opt_stage_launches)
    start = launches()
    rewards, steps = [], []
    for i in range(iterations):
        ts, m = ppo.train_iteration(env_params, ts, gen)
        rewards.append(m["reward"])
        steps.append(m["steps"])
        if every and (i + 1) % every == 0:
            log(f"  iteration {i + 1}: reward {float(m['reward']):.4f} "
                f"steps {float(m['steps']):.1f}")
    counts = dict(zip(("substep", "gae", "grads_stats", "opt_stage"),
                      (b - a for a, b in zip(start, launches()))))
    return (torch.stack(rewards).double().cpu().numpy(),
            torch.stack(steps).double().cpu().numpy(), counts)
