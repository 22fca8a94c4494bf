"""Cross-sim evaluation in MuJoCo, and the MJCF reader training needs (port
of booster_gym_tpu/eval/mujoco_eval.py).

MujocoEval runs a trained policy in a physics engine it never trained in,
the de-facto integration test: the 47-dim observation from the
`orientation` and `angular-velocity` sensors, the PD law clipped to each
actuator's ctrlrange, and the gait clock, as the JAX package's harness
has them (the reference's play_mujoco.py runtime core).  MuJoCo stays the
independent CPU oracle; the policy is a plain callable obs[47] ->
action[12]: torchscript_policy for a TorchScript actor, torch_policy for
the port's actor mean on any device.

load_mjcf_geoms reads an MJCF's geoms as MuJoCo's compiler places them in
their bodies' frames, with xml.etree and numpy: the machine that trains on
the card has no mujoco package, so this module imports mujoco only inside
the functions that need it.
"""

import os
import re
import xml.etree.ElementTree as ET

import numpy as np

# mujoco binds its GL backend by MUJOCO_GL at import time; on a headless
# host the default (glfw/X11) aborts at the first offscreen render, so pick
# EGL (Mesa's software EGL works without a display) before any `import
# mujoco` can run.  Interactive use on a real display is untouched.
if "MUJOCO_GL" not in os.environ and not os.environ.get("DISPLAY"):
    os.environ["MUJOCO_GL"] = "egl"

# MuJoCo's built-in geom defaults for the attributes read here (size: the
# classes' own, all zeros at the root)
_GEOM_DEFAULTS = {"type": "sphere", "contype": "1", "conaffinity": "1", "pos": "0 0 0",
                  "quat": "1 0 0 0"}
_READ = ("type", "size", "contype", "conaffinity", "pos", "quat", "fromto")
_ORIENTATIONS = ("euler", "axisangle", "xyaxes", "zaxis")


def _floats(text):
    return np.array([float(v) for v in text.split()], np.float64)


def _unit_quat(q):
    return q / np.linalg.norm(q)


def quat_z_to_vec(vec):
    """MuJoCo's mju_quatZ2Vec: the unit quaternion (w, x, y, z) that turns
    +z onto `vec` about the axis z x vec."""
    v = np.asarray(vec, np.float64)
    n = np.linalg.norm(v)
    if n < 1e-15:
        return np.array([1.0, 0.0, 0.0, 0.0])
    v = v / n
    axis = np.cross([0.0, 0.0, 1.0], v)
    s = np.linalg.norm(axis)
    if s < 1e-15:
        return np.array([1.0, 0.0, 0.0, 0.0]) if v[2] > 0 else np.array([0.0, 1.0, 0.0, 0.0])
    axis = axis / s
    ang = np.arctan2(s, v[2])
    return np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * axis])


def _merge_size(base, text):
    """A size attribute's values over the first components of `base`: the
    compiler keeps the components an attribute leaves out."""
    size = np.array(base, np.float64)
    given = _floats(text)
    size[:len(given)] = given
    return size


def _default_classes(root):
    """{class name: {attribute: value}} of the geom defaults, each class
    holding its ancestors' values under its own (a size component by
    component); the top <default> is "main"."""
    classes = {}

    def walk(elem, inherited):
        attrs = dict(inherited)
        geom = elem.find("geom")
        if geom is not None:
            for key in _ORIENTATIONS:
                if key in geom.attrib:
                    raise NotImplementedError(
                        f"geom default class {elem.get('class', 'main')!r} sets '{key}'; only "
                        f"'quat' and 'fromto' orientations are read")
            attrs.update({k: v for k, v in geom.attrib.items() if k in _READ and k != "size"})
            if "size" in geom.attrib:
                attrs["size"] = _merge_size(attrs["size"], geom.get("size"))
        classes[elem.get("class", "main")] = attrs
        for child in elem.findall("default"):
            walk(child, attrs)

    for top in root.findall("default"):
        walk(top, {"size": np.zeros(3)})
    classes.setdefault("main", {"size": np.zeros(3)})
    return classes


def _check_orientation(elem, what):
    for key in _ORIENTATIONS:
        if key in elem.attrib:
            raise NotImplementedError(
                f"{what} {elem.get('name', '(unnamed)')!r} is oriented by '{key}'; only 'quat' "
                f"(and 'fromto' on capsules and cylinders) is read")


def load_mjcf_geoms(path):
    """Every geom of the MJCF at `path`, in MuJoCo's geom order (bodies
    depth first in document order, each body's geoms in document order), as
    dicts: "body" (its body's name, "world" for the worldbody), "chain"
    (that body's name and its ancestors' up to the worldbody's child),
    "type", "size" [3], "pos" [3] and "quat" [4] (w, x, y, z) in its own
    body's frame, "contype", "conaffinity".

    Class defaults (`class`, a body's `childclass`) give the attributes a
    geom leaves out.  A `fromto` capsule or cylinder is placed as MuJoCo's
    compiler places it: pos at the midpoint, half-length |b - a| / 2 in
    size[1], and quat turning +z onto a - b (mju_quatZ2Vec of from - to, as
    the compiler calls it).  Orientations
    by euler, axisangle, xyaxes or zaxis raise NotImplementedError: their
    conventions hang on <compiler> settings this reader does not follow."""
    root = ET.parse(path).getroot()
    classes = _default_classes(root)
    world = root.find("worldbody")
    if world is None:
        raise ValueError(f"{path} has no <worldbody>")
    geoms = []

    def attr(elem, cls, key):
        if key in elem.attrib:
            return elem.get(key)
        if cls not in classes:
            raise ValueError(f"{path}: unknown default class {cls!r}")
        return classes[cls].get(key, _GEOM_DEFAULTS.get(key))

    def walk(body, name, chain, childclass):
        if body.find("frame") is not None:
            raise NotImplementedError(f"{path}: <frame> elements are not read")
        for g in body.findall("geom"):
            _check_orientation(g, "geom")
            cls = g.get("class", childclass)
            kind = attr(g, cls, "type")
            size = _merge_size(classes[cls]["size"], g.get("size", ""))
            fromto = attr(g, cls, "fromto")
            if fromto is not None:
                if kind not in ("capsule", "cylinder"):
                    raise NotImplementedError(f"{path}: fromto on a {kind} geom")
                a, b = _floats(fromto)[:3], _floats(fromto)[3:6]
                pos, quat = 0.5 * (a + b), quat_z_to_vec(a - b)
                size[1] = 0.5 * np.linalg.norm(b - a)
            else:
                pos, quat = _floats(attr(g, cls, "pos")), _unit_quat(_floats(attr(g, cls, "quat")))
            geoms.append(dict(body=name, chain=chain, type=kind, size=size, pos=pos, quat=quat,
                              contype=int(attr(g, cls, "contype")),
                              conaffinity=int(attr(g, cls, "conaffinity"))))
        for child in body.findall("body"):
            _check_orientation(child, "body")
            cname = child.get("name")
            walk(child, cname, (cname, *chain), child.get("childclass", childclass))

    walk(world, "world", (), "main")
    return geoms


# ---------------------------------------------------------------------------
# MuJoCo evaluation
def load_mjcf(path):
    """mujoco.MjModel from an MJCF path, tolerating scene-less files.

    The reference's T1_serial.xml names a `ground` plane geom in its
    <contact> pairs but defines none: it expects to be composed into a
    scene file.  When the direct load fails on that, the XML is patched in
    memory: meshdir made absolute (a string load resolves relative paths
    against the working directory) and a ground plane inserted as
    T1_locomotion.xml has it (plane, condim 1)."""
    import mujoco

    try:
        return mujoco.MjModel.from_xml_path(path)
    except ValueError:
        with open(path) as f:
            xml = f.read()
        base = os.path.dirname(os.path.abspath(path))
        xml = re.sub(r'meshdir="([^"]+)"',
                     lambda m: f'meshdir="{os.path.join(base, m.group(1))}"', xml)
        xml = xml.replace(
            "<worldbody>",
            '<worldbody>\n    <geom name="ground" type="plane" '
            'pos="0 0 0" size="0 0 1" condim="1"/>', 1)
        return mujoco.MjModel.from_xml_string(xml)


def quat_rotate_inverse_np(q_xyzw, v):
    """numpy world -> body rotation with an xyzw quaternion (the deploy
    stack's convention)."""
    x, y, z, w = q_xyzw
    u = np.array([x, y, z])
    uv = np.cross(u, v)
    return v - 2.0 * (w * uv - np.cross(u, uv))


def torch_policy(network, flat_params, device="cuda"):
    """The port's actor mean as a policy obs[47] -> action: `network` (an
    ActorCritic, in its compute type) with the flat parameter vector
    `flat_params` (algo.ppo.flat_params' order) on `device`.  The
    observation goes to the device and the action comes back as numpy."""
    import torch

    from booster_gym_torch.algo.ppo import set_flat_params

    device = torch.device(device)
    network = network.to(device)
    set_flat_params(network, torch.as_tensor(flat_params).to(device))

    def policy(obs):
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(obs, np.float32)[None], device=device)
            return network.act(x)[0][0].cpu().numpy()

    return policy


def torchscript_policy(path):
    """A TorchScript actor (the deploy stack's .pt) as a policy, on the
    CPU."""
    import torch

    module = torch.jit.load(path, map_location="cpu")
    module.eval()

    def policy(obs):
        with torch.no_grad():
            out = module(torch.from_numpy(obs.astype(np.float32)).unsqueeze(0))
        return out.squeeze(0).numpy()

    return policy


class MujocoEval:
    """The policy in closed loop in MuJoCo at the config's sim dt: every
    `decimation` substeps a new action from the observation, every substep
    the PD torque kp (targets - q) - kd qd clipped to the actuators'
    ctrlrange.  Actuators are matched to the config's default angles and
    gains by name substring, as the env matches joints."""

    def __init__(self, cfg, policy):
        import mujoco

        from booster_gym_torch.envs.t1 import _resolve_asset

        self.mujoco = mujoco
        self.cfg = cfg
        self.policy = policy
        self.model = mujoco.MjModel.from_xml_path(_resolve_asset(cfg["asset"]["mujoco_file"]))
        self.model.opt.timestep = cfg["sim"]["dt"]
        self.data = mujoco.MjData(self.model)
        self.decimation = cfg["control"]["decimation"]

        names = [mujoco.mj_id2name(self.model, mujoco.mjtObj.mjOBJ_ACTUATOR, i)
                 for i in range(self.model.nu)]
        nd = len(names)
        self.default_dof_pos = np.zeros(nd, np.float32)
        self.kp = np.zeros(nd, np.float32)
        self.kd = np.zeros(nd, np.float32)
        angle_cfg = cfg["init_state"]["default_joint_angles"]
        for i, n in enumerate(names):
            found = False
            for key, val in angle_cfg.items():
                if key != "default" and key in n:
                    self.default_dof_pos[i] = val
                    found = True
            if not found:
                self.default_dof_pos[i] = angle_cfg["default"]
            for key in cfg["control"]["stiffness"]:
                if key in n:
                    self.kp[i] = cfg["control"]["stiffness"][key]
                    self.kd[i] = cfg["control"]["damping"][key]
        self.reset()

    def reset(self):
        cfg = self.cfg
        self.data.qpos[:3] = cfg["init_state"]["pos"]
        rot = cfg["init_state"]["rot"]  # xyzw in the config
        self.data.qpos[3:7] = [rot[3], rot[0], rot[1], rot[2]]  # -> wxyz
        self.data.qpos[7:] = self.default_dof_pos
        self.data.qvel[:] = 0
        self.mujoco.mj_forward(self.model, self.data)
        self.actions = np.zeros(self.model.nu, np.float32)
        self.dof_targets = self.default_dof_pos.copy()
        self.gait_frequency = 1.5
        self.gait_process = 0.0
        self.iteration = 0

    def build_obs(self, commands):
        """The 47-dim observation from MuJoCo's state and IMU sensors."""
        n = self.cfg["normalization"]
        dof_pos = self.data.qpos.astype(np.float32)[7:]
        dof_vel = self.data.qvel.astype(np.float32)[6:]
        quat_xyzw = self.data.sensor("orientation").data[[1, 2, 3, 0]].astype(np.float32)
        base_ang_vel = self.data.sensor("angular-velocity").data.astype(np.float32)
        projected_gravity = quat_rotate_inverse_np(quat_xyzw, np.array([0.0, 0.0, -1.0]))
        obs = np.zeros(self.cfg["env"]["num_observations"], np.float32)
        obs[0:3] = projected_gravity * n["gravity"]
        obs[3:6] = base_ang_vel * n["ang_vel"]
        obs[6] = commands[0] * n["lin_vel"]
        obs[7] = commands[1] * n["lin_vel"]
        obs[8] = commands[2] * n["ang_vel"]
        obs[9] = np.cos(2 * np.pi * self.gait_process) * (self.gait_frequency > 1.0e-8)
        obs[10] = np.sin(2 * np.pi * self.gait_process) * (self.gait_frequency > 1.0e-8)
        obs[11:23] = (dof_pos - self.default_dof_pos) * n["dof_pos"]
        obs[23:35] = dof_vel * n["dof_vel"]
        obs[35:47] = self.actions
        return obs

    def substep(self, commands):
        """One physics substep; the policy runs every `decimation`
        substeps.  Returns the applied torques."""
        n = self.cfg["normalization"]
        dof_pos = self.data.qpos.astype(np.float32)[7:]
        dof_vel = self.data.qvel.astype(np.float32)[6:]
        if self.iteration % self.decimation == 0:
            obs = self.build_obs(commands)
            self.actions[:] = np.clip(self.policy(obs), -n["clip_actions"], n["clip_actions"])
            self.dof_targets[:] = (self.default_dof_pos
                                   + self.cfg["control"]["action_scale"] * self.actions)
        ctrl = np.clip(self.kp * (self.dof_targets - dof_pos) - self.kd * dof_vel,
                       self.model.actuator_ctrlrange[:, 0], self.model.actuator_ctrlrange[:, 1])
        self.data.ctrl[:] = ctrl
        self.mujoco.mj_step(self.model, self.data)
        self.gait_process = np.fmod(
            self.gait_process + self.model.opt.timestep * self.gait_frequency, 1.0)
        self.iteration += 1
        return ctrl

    def save_state(self):
        """A snapshot of the whole simulation: the harness's state and a
        copy of all of MuJoCo's data (beside qpos and qvel, the solver's
        warm start and the sensor values of the last step, which the next
        observation reads), so that a restore replays bitwise."""
        import copy

        return {"data": copy.copy(self.data), "actions": self.actions.copy(),
                "dof_targets": self.dof_targets.copy(), "gait_frequency": self.gait_frequency,
                "gait_process": self.gait_process, "iteration": self.iteration}

    def restore_state(self, snap):
        self.mujoco.mj_copyData(self.data, self.model, snap["data"])
        self.actions[:] = snap["actions"]
        self.dof_targets[:] = snap["dof_targets"]
        self.gait_frequency = snap["gait_frequency"]
        self.gait_process = snap["gait_process"]
        self.iteration = snap["iteration"]

    def run(self, seconds, commands=(0.0, 0.0, 0.0), gait_frequency=1.5):
        """Run closed-loop; returns a trajectory dict of stacked arrays
        (qpos, qvel, torques, actions), one row per substep."""
        self.gait_frequency = gait_frequency
        n_sub = int(seconds / self.model.opt.timestep)
        qpos, qvel, torques, actions = [], [], [], []
        for _ in range(n_sub):
            ctrl = self.substep(np.asarray(commands, np.float32))
            qpos.append(self.data.qpos.copy())
            qvel.append(self.data.qvel.copy())
            torques.append(ctrl.copy())
            actions.append(self.actions.copy())
        return {"qpos": np.asarray(qpos), "qvel": np.asarray(qvel),
                "torques": np.asarray(torques), "actions": np.asarray(actions)}
