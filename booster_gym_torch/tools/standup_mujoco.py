"""Cross-sim check of a standup policy in MuJoCo (port of
tools/standup_mujoco.py).

Drops the 23-DoF serial robot into fallen poses in MuJoCo (the independent
CPU oracle, as eval/mujoco_eval.py is for walking), lets it settle under
PD-hold, then drives the deploy wrapper itself, booster_gym_torch/deploy's
StandupPolicy with its 50-frame stack and mirror-averaged inference, on the
exported artifact, and reports whether the robot gets up.

    python -m booster_gym_torch.tools.standup_mujoco [--model models/T1_standup.pt]
        [--seconds 8] [--drops 4] [--out FILE] [--no-mirror] [--device cuda|cpu]
        [--mujoco_file MJCF]

MuJoCo runs on the CPU (a lazy import: the card's machine has no mujoco);
the policy's forward passes run on --device (cuda unless --device cpu;
without a card it exits non-zero).  The robot is --mujoco_file, else the
serial stand-in's MJCF, given a motor per hinge where it has no actuator;
the summary names it.  --out defaults to
booster_gym_torch/records/standup_mujoco.json.
"""

import argparse
import json
import os
import re
import tempfile

import numpy as np
import yaml

from booster_gym_torch.eval.mujoco_eval import quat_rotate_inverse_np
from booster_gym_torch.tools import SERIAL_STANDIN, device_or_exit, open_out
from booster_gym_torch.tools.standup_wrapper_probe import DEPLOY_CFG, rearm
from booster_gym_torch.utils.config import load_task_cfg

CATEGORIES = ("prone", "supine", "side")


def run_drop(mujoco, model, data, pol, tcfg, pitch, yaw, seconds, roll=0.0, category=""):
    """One fallen-settle-standup episode; returns its outcome record."""
    dt = tcfg["sim"]["dt"]
    decimation = tcfg["control"]["decimation"]
    nd = model.nu
    default = np.zeros(nd, np.float32)
    kp = np.zeros(nd, np.float32)
    kd = np.zeros(nd, np.float32)
    names = [mujoco.mj_id2name(model, mujoco.mjtObj.mjOBJ_ACTUATOR, i) for i in range(nd)]
    angle_cfg = tcfg["init_state"]["default_joint_angles"]
    for i, n in enumerate(names):
        found = False
        for key, val in angle_cfg.items():
            if key != "default" and key in n:
                default[i] = val
                found = True
        if not found:
            default[i] = angle_cfg["default"]
        for key in tcfg["control"]["stiffness"]:
            if key in n:
                kp[i] = tcfg["control"]["stiffness"][key]
                kd[i] = tcfg["control"]["damping"][key]

    # fallen init: near-horizontal drop, then settle under PD-hold
    data.qpos[:] = 0.0
    data.qvel[:] = 0.0
    # wxyz quaternion: yaw about z after pitch about y after roll about x
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    data.qpos[3:7] = [cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
                      cy * sp * cr + sy * cp * sr, sy * cp * cr - cy * sp * sr]
    data.qpos[2] = 0.5
    data.qpos[7:] = default
    mujoco.mj_forward(model, data)

    def pd_step(targets):
        q = data.qpos.astype(np.float32)[7:]
        qd = data.qvel.astype(np.float32)[6:]
        data.ctrl[:] = kp * (targets - q) - kd * qd
        mujoco.mj_step(model, data)

    for _ in range(int(1.0 / dt)):           # 1 s settle
        pd_step(default)

    pol.reset()
    heights, upz = [], []
    targets = default.copy()
    down = np.array([0.0, 0.0, -1.0])
    for i in range(int(seconds / dt)):
        if i % decimation == 0:
            q = data.qpos.astype(np.float32)[7:]
            qd = data.qvel.astype(np.float32)[6:]
            quat_xyzw = data.qpos[3:7][[1, 2, 3, 0]].astype(np.float32)
            gyro = data.qvel[3:6].astype(np.float32)
            targets = pol.inference(i * dt, q, qd, gyro, quat_rotate_inverse_np(quat_xyzw, down))
        pd_step(targets)
        heights.append(float(data.qpos[2]))
        upz.append(float(quat_rotate_inverse_np(
            data.qpos[3:7][[1, 2, 3, 0]].astype(np.float32), down)[2]))

    h, u = np.asarray(heights), np.asarray(upz)
    # success: trunk near standing height and upright, sustained 1 s
    win = int(1.0 / dt)
    ok = any((h[s:s + win] > 0.55).all() and (u[s:s + win] < -0.9).all()
             for s in range(0, len(h) - win))
    return {"category": category, "pitch_deg": round(np.degrees(pitch), 1),
            "roll_deg": round(np.degrees(roll), 1), "yaw_deg": round(np.degrees(yaw), 1),
            "start_height": round(float(h[0]), 3), "end_height": round(float(h[-1]), 3),
            "max_height": round(float(h.max()), 3), "end_upright": round(float(-u[-1]), 3),
            "success": bool(ok)}


def drops(n, seed=0):
    """(category, pitch, roll, yaw) of n drops: prone, supine and side in
    turn, 85 +- 10 degrees, yaw uniform, from one numpy generator."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        cat = CATEGORIES[k % len(CATEGORIES)]
        ang = np.deg2rad(85.0 + float(rng.uniform(-10.0, 10.0)))
        yaw = float(rng.uniform(0, 2 * np.pi))
        pitch = {"prone": ang, "supine": -ang}.get(cat, 0.0)
        roll = ang * (1 if k % 2 == 0 else -1) if cat == "side" else 0.0
        out.append((cat, pitch, roll, yaw))
    return out


def prepare_xml(xml, base):
    """The MJCF for the check: meshdir made absolute against `base`; a
    ground plane where the contact pairs name one the world lacks; the
    ground pairs of the calves and forearms added to a <contact> section
    (the reference serial MJCF's pairs were authored for walking, and a
    kneeling get-up falls through the floor without them); and where the
    model has no actuator, an unlimited motor on each hinge in joint
    order."""
    xml = re.sub(r'meshdir="([^"]+)"',
                 lambda m: f'meshdir="{os.path.join(base, m.group(1))}"', xml)
    if '"ground"' in xml and '<geom name="ground"' not in xml:
        xml = xml.replace("<worldbody>", '<worldbody>\n    <geom name="ground" type="plane" '
                          'pos="0 0 0" size="0 0 1" condim="3"/>', 1)
    xml = xml.replace(
        "</contact>",
        '  <pair geom1="left_calf" geom2="ground" />\n'
        '    <pair geom1="right_calf" geom2="ground" />\n'
        '    <pair geom1="left_forearm" geom2="ground" />\n'
        '    <pair geom1="right_forearm" geom2="ground" />\n'
        '  </contact>')
    if "<actuator>" not in xml:
        hinges = re.findall(r'<joint name="([^"]+)" type="hinge"', xml)
        motors = "".join(f'<motor name="{j}" joint="{j}"/>' for j in hinges)
        xml = xml.replace("</mujoco>", f"<actuator>{motors}</actuator>\n</mujoco>", 1)
    return xml


class _OnDevice:
    """The wrapper's TorchScript module with its forward on `device`: numpy
    in and out as StandupPolicy expects, the products on the card."""

    def __init__(self, module, device):
        self.module = module.to(device)
        self.device = device

    def __call__(self, *xs):
        return self.module(*(x.to(self.device) for x in xs)).cpu()


def run(model_path, mjcf, robot, device, seconds=8.0, n_drops=4, mirror=True, log=print):
    import mujoco

    from booster_gym_torch.deploy.policy import StandupPolicy

    tcfg = load_task_cfg("T1Standup")
    with open(DEPLOY_CFG) as f:
        dcfg = yaml.safe_load(f)
    with open(mjcf) as f:
        xml = prepare_xml(f.read(), os.path.dirname(os.path.abspath(mjcf)))
    model = mujoco.MjModel.from_xml_string(xml)
    model.opt.timestep = tcfg["sim"]["dt"]
    data = mujoco.MjData(model)
    pol = StandupPolicy(dcfg, policy_path=model_path)
    pol.module = _OnDevice(pol.module, device)
    pol.mirror_average = mirror
    pol.reset = lambda: rearm(pol)
    results = []
    for cat, pitch, roll, yaw in drops(n_drops):
        rec = run_drop(mujoco, model, data, pol, tcfg, pitch, yaw, seconds, roll=roll,
                       category=cat)
        log(json.dumps(rec))
        results.append(rec)
    per_cat = {c: {"n": sum(r["category"] == c for r in results),
                   "success": sum(r["success"] for r in results if r["category"] == c)}
               for c in CATEGORIES}
    return {"model": model_path, "robot": robot, "mirror_average": bool(pol.mirror_average),
            "drops": results, "per_category": per_cat,
            "n_success": sum(r["success"] for r in results), "n_drops": len(results)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="models/T1_standup.pt")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--drops", type=int, default=4)
    ap.add_argument("--out", default=os.path.join("booster_gym_torch", "records",
                                                  "standup_mujoco.json"))
    ap.add_argument("--no-mirror", action="store_true",
                    help="bypass the wrapper's mirror averaging (diagnose asymmetric "
                         "get-up strategies)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mujoco_file", default=None)
    args = ap.parse_args(argv)
    device = device_or_exit(args.device)
    if args.mujoco_file:
        mjcf, robot = args.mujoco_file, args.mujoco_file
    else:
        from booster_gym_torch.testing import write_t1_serial_mjcf

        mjcf = write_t1_serial_mjcf(tempfile.mkdtemp(prefix="t1_serial_standin_"))
        robot = SERIAL_STANDIN
    summary = run(args.model, mjcf, robot, device, args.seconds, args.drops,
                  not args.no_mirror)
    with open(open_out(args.out), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {args.out}: {summary['n_success']}/{summary['n_drops']} successful get-ups; "
          f"per-category {json.dumps(summary['per_category'])}", flush=True)
    return summary


if __name__ == "__main__":
    main()
