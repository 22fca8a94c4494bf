"""The port's tools (booster_gym_torch/tools) at tiny sizes on the CPU,
against the JAX tools' functions where they have them (tools/*.py, loaded
from their files): the A/B row from the same rewards, the standup probe's
categories from the same quaternions, a MuJoCo drop episode from the same
model and policy (bitwise), then each tool's own path.  Without a card
every tool refuses to run unless given --device cpu."""

import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch
import yaml

from booster_gym_torch.physics.engine import make_fk
from booster_gym_torch.testing import (
    write_t1_serial_mjcf,
    write_t1_serial_urdf,
    write_t1_shaped_urdf,
)
from booster_gym_torch.tools import (
    SERIAL_STANDIN,
    ab_divergence,
    standup_mujoco,
    standup_probe,
    standup_wrapper_probe,
    train_curve,
    view,
)
from booster_gym_torch.utils.config import load_task_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CKPT = os.path.join(REPO, "logs", "2026-08-17-04-03-56", "nn", "model_1100.ckpt")
STANDUP_PT = os.path.join(REPO, "models", "T1_standup.pt")


def jax_tool(name):
    """tools/<name>.py of the JAX package's repository, as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def serial(tmp_path_factory):
    d = tmp_path_factory.mktemp("serial")
    return write_t1_serial_urdf(d), write_t1_serial_mjcf(d)


# -- every tool needs a card unless told --device cpu ---------------------------------

@pytest.mark.parametrize("tool,argv", [
    (train_curve, ["3"]), (ab_divergence, ["--iters", "1"]), (standup_probe, []),
    (standup_wrapper_probe, []), (standup_mujoco, []), (view, [])])
def test_tools_refuse_without_a_card(tool, argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        tool.main(argv)
    assert e.value.code == 2
    assert "CUDA is not available; pass --device cpu" in capsys.readouterr().err


# -- ab_divergence ---------------------------------------------------------------

def test_ab_divergence_row_matches_the_jax_tool(monkeypatch):
    """The JAX tool's run_arm on rewards fed through a stand-in trainer (its
    jit, env and PPO replaced) gives the port's arm_row on the same rewards,
    wall time aside."""
    jtool = jax_tool("ab_divergence")
    rewards = np.random.default_rng(0).normal(size=130).astype(np.float32)
    feed = iter(rewards)

    class FakePPO:
        def __init__(self, env, cfg):
            pass

        def init(self, key):
            return None, None

        def train_iteration(self, params, ts):
            return ts, {"reward": np.float32(next(feed))}

    fake_jax = types.SimpleNamespace(jit=lambda f, donate_argnums=(): f,
                                     random=types.SimpleNamespace(PRNGKey=lambda s: s),
                                     device_get=lambda x: x)
    monkeypatch.setattr(jtool, "jax", fake_jax)
    monkeypatch.setattr(jtool, "make_task", lambda cfg: None)
    monkeypatch.setattr(jtool, "PPO", FakePPO)
    ref = jtool.run_arm("still_exact", {}, 130, 7)
    row = ab_divergence.arm_row("still_exact", 7, 130, rewards, 1.0)
    ref.pop("wall_s"), row.pop("wall_s")
    assert row == ref


def test_ab_divergence_arms():
    base = load_task_cfg("T1")
    arms = ab_divergence.arms(base)
    assert list(arms) == ["base", "still_exact", "curriculum_base", "curriculum_quirk"]
    assert arms["base"] is base
    assert arms["still_exact"]["commands"]["still_mode"] == "exact_fraction"
    assert arms["curriculum_base"]["commands"]["curriculum"] is True
    assert "curriculum_transpose_quirk" not in arms["curriculum_base"]["commands"]
    assert arms["curriculum_quirk"]["commands"]["curriculum_transpose_quirk"] is True
    assert arms["curriculum_quirk"]["commands"]["curriculum"] is True
    assert ab_divergence.summary([{"arm": "a", "reward_mean_last10pct": v} for v in (1, 3)],
                                 ["a"]) == {"a": (2.0, 1.0)}


def test_ab_divergence_cli_on_cpu(tmp_path, monkeypatch, capsys):
    """All four arms, one iteration each, at 8 envs and a cut horizon; rows
    with the JAX tool's keys, the robot and the card, appended to --out."""
    from booster_gym_torch.utils import config

    def cut(task):
        cfg = load_task_cfg(task)
        cfg["runner"].update(horizon_length=2, mini_epochs=1)
        return cfg

    monkeypatch.setattr(config, "load_task_cfg", cut)
    out = tmp_path / "ab.jsonl"
    urdf = write_t1_shaped_urdf(tmp_path)
    ab_divergence.main(["--iters", "1", "--num_envs", "8", "--seeds", "0", "--device", "cpu",
                        "--out", str(out), "--asset_file", urdf])
    rows = [json.loads(line) for line in open(out)]
    assert [r["arm"] for r in rows] == ["base", "still_exact", "curriculum_base",
                                        "curriculum_quirk"]
    for r in rows:
        assert list(r) == ["arm", "seed", "iters", "reward_mean_last10pct",
                           "reward_curve_every50", "wall_s", "robot", "card"]
        assert r["robot"] == urdf and r["card"] == "cpu" and r["iters"] == 1
        assert np.isfinite(r["reward_mean_last10pct"]) and len(r["reward_curve_every50"]) == 1
    assert "summary (reward mean over last 10% of iters):" in capsys.readouterr().out


# -- standup_probe and standup_wrapper_probe -----------------------------------------

def test_standup_categories_match_the_jax_tool():
    """Both tools' categories of the same base orientations: random ones,
    and one of each kind."""
    jtool = jax_tool("standup_probe")
    rng = np.random.default_rng(0)
    q = rng.normal(size=(200, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = np.sin(np.deg2rad(45.0))
    kinds = np.asarray([[1, 0, 0, 0], [np.cos(0.7), 0, np.sin(0.7), 0],
                        [np.cos(0.7), 0, -np.sin(0.7), 0], [s, s, 0, 0]], np.float32)
    q = np.concatenate([q, kinds])
    port = standup_probe.categorize(q)
    assert list(port) == list(jtool._categorize(q))
    assert list(port[-4:]) == ["upright", "supine", "prone", "side"]


def test_standup_probe_summaries():
    h = np.asarray([0.2, 0.6, 0.7, 0.56])
    u = np.asarray([0.99, 0.95, 0.5, 0.91])
    assert list(standup_probe.standing(h, u)) == [False, True, False, True]
    e = standup_probe.envelope(h, u)
    assert e["max"] == 0.7 and e["med"] == pytest.approx(0.58)
    assert e["up_med"] == pytest.approx(0.93)
    assert standup_probe.envelope_line(1.0, e).startswith("t= 1.0s  h: p25=")
    cats = np.asarray(["prone", "side", "prone", "upright"], object)
    assert standup_probe.per_category(cats, standup_probe.standing(h, u)) == {
        "prone": {"n": 2, "success": 0}, "side": {"n": 1, "success": 1},
        "upright": {"n": 1, "success": 1}}


def _tiny_standup_cfg(serial, envs):
    cfg = standup_probe.probe_cfg(*serial, envs)
    cfg["standup"]["settle_rounds"] = 1       # the bank's settle cut to 1 control step
    return cfg


def test_standup_probe_on_cpu(serial, tmp_path):
    """Two checkpoints probed in one process (a port checkpoint of the
    network's init, twice) give the same summary, over the 4 envs' starting
    categories."""
    from booster_gym_torch.algo.ppo import PPO
    from booster_gym_torch.envs import make_task

    cfg = _tiny_standup_cfg(serial, 4)
    net = PPO(make_task(cfg, "cpu"), cfg, "cpu").network
    net.reset_parameters(torch.Generator().manual_seed(5))
    path = str(tmp_path / "model_0.pt")
    torch.save({"params": net.state_dict()}, path)
    lines = []
    sums = standup_probe.probe(cfg, [path, path], torch.device("cpu"), seconds=0.02,
                               robot=SERIAL_STANDIN, log=lines.append)
    assert len(sums) == 2 and sums[0] == sums[1]
    assert sum(v["n"] for v in sums[0]["per_category"].values()) == 4
    assert sums[0]["robot"] == SERIAL_STANDIN
    assert lines[0] == f"loading {path}" and "standing at t=0.02s" in lines[1]


def test_standup_wrapper_probe_on_cpu(serial):
    """The wrapper's actions invert the env's action map: through
    T1Standup._apply_actions they give back each wrapper's PD targets on the
    action joints; then a short run of the probe."""
    from booster_gym_torch.deploy.policy import StandupPolicy

    cfg = _tiny_standup_cfg(serial, 2)
    env, _, _, state, _, _ = standup_probe.start(cfg, "cpu")
    with open(standup_wrapper_probe.DEPLOY_CFG) as f:
        dcfg = yaml.safe_load(f)
    pols = [StandupPolicy(dcfg, policy_path=STANDUP_PT) for _ in range(2)]
    twins = [StandupPolicy(dcfg, policy_path=STANDUP_PT) for _ in range(2)]
    acts = standup_wrapper_probe.wrapper_actions(env, pols, 0.0, state)
    _, targets = env._apply_actions(torch.as_tensor(acts))
    idx = env.action_indices
    for e, twin in enumerate(twins):
        want = twin.inference(0.0, state.sim.q[e].numpy(), state.sim.qd[e].numpy(),
                              state.base_ang_vel[e].numpy(), state.projected_gravity[e].numpy())
        np.testing.assert_allclose(targets[e, idx].numpy(), want[idx.numpy()], atol=1e-6)
    share = standup_wrapper_probe.run(cfg, STANDUP_PT, "cpu", seconds=0.02, log=lambda s: None)
    assert 0.0 <= share <= 1.0


# -- standup_mujoco --------------------------------------------------------------

@pytest.fixture(scope="module")
def mj_standin(serial):
    mujoco = pytest.importorskip("mujoco")
    with open(serial[1]) as f:
        xml = standup_mujoco.prepare_xml(f.read(), os.path.dirname(serial[1]))
    model = mujoco.MjModel.from_xml_string(xml)
    model.opt.timestep = load_task_cfg("T1Standup")["sim"]["dt"]
    return mujoco, model


def test_standup_mujoco_xml_gets_a_motor_per_hinge(mj_standin):
    mujoco, model = mj_standin
    assert model.nu == 23
    names = [mujoco.mj_id2name(model, mujoco.mjtObj.mjOBJ_ACTUATOR, i) for i in range(23)]
    joints = [mujoco.mj_id2name(model, mujoco.mjtObj.mjOBJ_JOINT, i) for i in range(1, 24)]
    assert names == joints


def test_standup_mujoco_drop_matches_the_jax_tool(mj_standin):
    """One drop of 0.2 s after the 1 s settle, driven by each package's own
    StandupPolicy on the same artifact and model: the records are equal."""
    from booster_gym_tpu.deploy.policy import StandupPolicy as JaxStandupPolicy

    from booster_gym_torch.deploy.policy import StandupPolicy

    mujoco, model = mj_standin
    jtool = jax_tool("standup_mujoco")
    with open(standup_wrapper_probe.DEPLOY_CFG) as f:
        dcfg = yaml.safe_load(f)
    tcfg = load_task_cfg("T1Standup")
    (cat, pitch, roll, yaw), = standup_mujoco.drops(1)
    recs = []
    for run_drop, cls in ((jtool.run_drop, JaxStandupPolicy), (standup_mujoco.run_drop,
                                                               StandupPolicy)):
        pol = cls(dcfg, policy_path=STANDUP_PT)
        pol.reset = lambda pol=pol: standup_wrapper_probe.rearm(pol)
        recs.append(run_drop(mujoco, model, mujoco.MjData(model), pol, tcfg, pitch, yaw, 0.2,
                             roll=roll, category=cat))
    assert recs[0] == recs[1] and recs[1]["category"] == "prone"


def test_standup_mujoco_cli_on_cpu(tmp_path, serial, capsys):
    pytest.importorskip("mujoco")
    out = tmp_path / "standup.json"
    summary = standup_mujoco.main(["--seconds", "0.1", "--drops", "2", "--device", "cpu",
                                   "--out", str(out), "--mujoco_file", serial[1],
                                   "--model", STANDUP_PT])
    assert json.load(open(out)) == summary
    assert [d["category"] for d in summary["drops"]] == ["prone", "supine"]
    assert summary["robot"] == serial[1] and summary["n_drops"] == 2
    assert "successful get-ups" in capsys.readouterr().out


# -- view ----------------------------------------------------------------------

def test_view_mirrors_the_state_into_mujoco(tmp_path):
    """The JAX run's checkpoint steps the port's one-env T1 on the CPU;
    mirror_state puts its root and joints into MjData: MuJoCo's trunk sits
    at the port's root, and each foot where the port's forward kinematics
    puts it (the port's FK)."""
    mujoco = pytest.importorskip("mujoco")
    cfg = load_task_cfg("T1")
    cfg["env"]["num_envs"] = 1
    cfg["terrain"]["type"] = "plane"
    cfg["asset"]["file"], cfg["asset"]["mujoco_file"] = view.robot_files("T1", None, None)
    env, params, state, obs, policy, gen = view.start(cfg, "cpu", (0.4, 0.0, 0.0),
                                                      checkpoint=JAX_CKPT)
    assert torch.equal(state.commands, torch.tensor([[0.4, 0.0, 0.0]]))
    with torch.no_grad():
        for _ in range(3):
            state, obs, _, _, _ = env.step(params, state, policy(obs), gen)
    model = mujoco.MjModel.from_xml_path(cfg["asset"]["mujoco_file"])
    data = mujoco.MjData(model)
    view.mirror_state(mujoco, model, data, state, 0)
    np.testing.assert_array_equal(data.qpos[7:], state.sim.q[0].numpy())
    trunk = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_BODY, "Trunk")
    np.testing.assert_allclose(data.xpos[trunk], state.sim.root_pos[0].numpy(), atol=1e-6)
    _, body_pos = make_fk(env.model, "cpu")(state.sim)
    for name in ("left_foot_link", "right_foot_link"):
        body = mujoco.mj_name2id(model, mujoco.mjtObj.mjOBJ_BODY, name)
        np.testing.assert_allclose(data.xpos[body],
                                   body_pos[0, env.model.body_names.index(name)].numpy(),
                                   atol=1e-5)


def test_view_robot_files():
    assert view.robot_files("T1", "a.urdf", "a.xml") == ("a.urdf", "a.xml")
    urdf, mjcf = view.robot_files("T1", None, None)
    assert urdf.endswith("T1_shaped.urdf") and mjcf.endswith("T1_shaped.xml")
    urdf, mjcf = view.robot_files("T1Standup", None, None)
    assert urdf.endswith("T1_serial_standin.urdf") and mjcf.endswith("T1_serial_standin.xml")
