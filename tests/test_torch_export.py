"""The port's TorchScript export (booster_gym_torch/export.py) against the
JAX package's export_model.py, the deploy stack's artifact in the port's
actor, and the port's artifact driving the deploy Controller.

Tolerances: the export of a JAX checkpoint against actor_params_to_torch
of the JAX-unpickled params, state_dict and outputs bitwise; the port's
f32 actor (torch.matmul, then the bias) against the TorchScript Sequential
(nn.Linear's fused addmm) at rtol 1e-5 / atol 1e-6.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from booster_gym_tpu.utils.recorder import load_checkpoint as jax_load_checkpoint
from export_model import actor_params_to_torch

from booster_gym_torch import export as port_export
from booster_gym_torch.algo.networks import ActorCritic
from booster_gym_torch.utils.recorder import resolve_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CKPT = os.path.join(REPO, "logs", "2026-08-17-04-03-56", "nn", "model_1100.ckpt")
WALK = os.path.join(REPO, "models", "T1_walk.pt")
NA, NO, NP = 12, 47, 14


def obs(n, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(n, NO)).astype(np.float32))


def test_export_of_the_jax_checkpoint_equals_the_jax_export(tmp_path):
    path = port_export.main(["--task=T1", f"--checkpoint={JAX_CKPT}",
                             "--output", str(tmp_path / "actor.pt")])
    assert path == str(tmp_path / "actor.pt")
    ours = torch.jit.load(path)
    ref = actor_params_to_torch(jax_load_checkpoint(JAX_CKPT)["params"])
    sd, want = ours.state_dict(), ref.state_dict()
    assert list(sd) == list(want) == ["0.weight", "0.bias", "2.weight", "2.bias", "4.weight",
                                      "4.bias", "6.weight", "6.bias"]
    for k in want:
        assert sd[k].dtype == torch.float32 and torch.equal(sd[k], want[k]), k
    x = obs(64, 3)
    with torch.no_grad():
        assert torch.equal(ours(x), ref(x))
        assert torch.equal(ours(x), torch.jit.script(ref)(x))


def test_t1_walk_artifact_in_the_ports_actor():
    """models/T1_walk.pt's weights in the port's f32 actor give the
    TorchScript module's actions; actor_sequential gives the module back."""
    module = torch.jit.load(WALK)
    sd = module.state_dict()
    net = ActorCritic(NA, NO, NP, compute_dtype="f32")
    params = {k: v.clone() for k, v in net.state_dict().items()}
    for i in range(4):
        for kind in ("weight", "bias"):
            params[f"actor.layers.{i}.{kind}"] = sd[f"{2 * i}.{kind}"]
    net.load_state_dict(params)
    x = obs(128, 4)
    with torch.no_grad():
        mu, _ = net.act(x)
        want = module(x)
        np.testing.assert_allclose(mu.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
        seq = port_export.actor_sequential(params)
        assert all(torch.equal(a, b) for a, b in zip(seq.state_dict().values(), sd.values()))
        assert torch.equal(seq(x), want)


def test_export_of_a_port_checkpoint_by_default_name(tmp_path):
    """-1 picks the port's newest model_<it>.pt; the artifact lands beside
    it as model_<it>_policy.pt, which -1 then does not pick; onnx is gated
    on the onnx package."""
    net = ActorCritic(NA, NO, NP)
    ckpt = tmp_path / "logs" / "run" / "nn" / "model_5.pt"
    ckpt.parent.mkdir(parents=True)
    torch.save({"params": net.state_dict()}, ckpt)
    root = str(tmp_path / "logs")
    out = port_export.export(-1, root=root)
    assert out == str(tmp_path / "logs" / "run" / "nn" / "model_5_policy.pt")
    assert resolve_checkpoint(-1, root=root) == str(ckpt)
    module = torch.jit.load(out)
    x = obs(16, 5)
    with torch.no_grad():
        assert torch.equal(module(x), port_export.actor_sequential(net.state_dict())(x))
    try:
        import onnx  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="onnx"):
            port_export.export(str(ckpt), output=str(tmp_path / "a.onnx"), fmt="onnx")
    else:
        assert os.path.exists(port_export.export(str(ckpt), output=str(tmp_path / "a.onnx"),
                                                 fmt="onnx"))


def test_port_export_drives_the_deploy_controller(tmp_path):
    """The port's export of model_1100.ckpt runs booster_gym_tpu.deploy's
    Controller against the MockRobot (tests/test_our_artifacts.py's run)."""
    from booster_gym_tpu.deploy.controller import Controller
    from booster_gym_tpu.deploy.remote_control import ScriptedRemote
    from booster_gym_tpu.deploy.sdk import MockRobot

    path = port_export.export(JAX_CKPT, output=str(tmp_path / "policy.pt"))
    with open(os.path.join(REPO, "booster_gym_tpu", "deploy", "configs", "T1.yaml")) as f:
        deploy_cfg = yaml.safe_load(f)
    robot = MockRobot(dt=deploy_cfg["common"]["dt"])
    remote = ScriptedRemote(vx=0.3, auto_start=True)
    ctrl = Controller(deploy_cfg, robot, remote, policy_path=path, sim_time=True)
    ctrl.start_custom_mode(wait=False)
    ctrl.start_rl_gait(wait=False, threaded_publisher=False)
    targets = []
    for _ in range(50):
        robot.tick()
        ctrl.run_inference_step()
        ctrl.publish_step()
        targets.append(ctrl.dof_target.copy())
    assert np.all(np.isfinite(robot.published[-1]))
    assert np.stack(targets)[:, :12].std(axis=0).max() > 1e-3, "leg targets frozen"
    ctrl.cleanup()
