"""The port's training entry point on the CPU, its refusals, and the rule
that the port imports nothing of JAX."""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from booster_gym_torch.convert import env_params_from_jax, env_state_from_jax
from booster_gym_torch.envs.t1 import T1
from booster_gym_torch.physics.engine import make_fk, make_substep
from booster_gym_torch.physics.substep_kernel import SubstepKernel
from booster_gym_torch.runner import Runner
from booster_gym_torch.testing import main_path_cfg, rough_path_cfg, write_t1_shaped_urdf
from booster_gym_torch.utils.config import build_cfg, load_task_cfg, parse_args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_train_cli_on_cpu(tmp_path):
    urdf = write_t1_shaped_urdf(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "booster_gym_torch.train", "--task=T1", "--terrain=plane",
         "--device", "cpu", "--num_envs", "16", "--max_iterations", "2",
         "--asset_file", urdf],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "epoch: 2/2" in out.stdout
    (run,) = os.listdir(tmp_path / "logs")
    rows = [json.loads(line) for line in open(tmp_path / "logs" / run / "scalars.jsonl")]
    assert [r["it"] for r in rows] == [0, 1]
    for r in rows:
        assert all(np.isfinite(v) for v in r.values()), r
        assert r["iter_ms"] > 0 and r["env_steps_per_sec"] > 0
        assert r["substep_kernel_launches"] == 0   # the CPU runs the plain versions
        assert r["gae_launches"] == r["grads_stats_launches"] == r["opt_stage_launches"] == 0
    ckpt = torch.load(tmp_path / "logs" / run / "nn" / "model_2.pt")
    assert ckpt["iteration"] == 2 and ckpt["adam_count"] == 2 * 20
    assert ckpt["params"]["actor.layers.0.weight"].shape == (256, 47)


def test_train_cli_on_cpu_with_the_task_files_terrain(tmp_path):
    """No --terrain flag: T1.yaml's own trimesh block, a 900 x 200 field."""
    urdf = write_t1_shaped_urdf(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "booster_gym_torch.train", "--task=T1", "--device", "cpu",
         "--num_envs", "16", "--max_iterations", "2", "--asset_file", urdf],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "epoch: 2/2" in out.stdout
    (run,) = os.listdir(tmp_path / "logs")
    rows = [json.loads(line) for line in open(tmp_path / "logs" / run / "scalars.jsonl")]
    assert [r["it"] for r in rows] == [0, 1]
    for r in rows:
        assert all(np.isfinite(v) for v in r.values()), r
        assert r["substep_kernel_launches"] == r["terrain_sampler_launches"] == 0
    cfg = yaml.safe_load(open(tmp_path / "logs" / run / "config.yaml"))
    assert cfg["terrain"]["type"] == "trimesh" and cfg["terrain"]["num_terrains"] == 8


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, loads neither
    jax nor booster_gym_tpu (checked in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import booster_gym_torch\n"
        "for m in pkgutil.walk_packages(booster_gym_torch.__path__, 'booster_gym_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'booster_gym_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('booster_gym_torch')]), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20 and bad == "[]", out.stdout


def _cfg(tmp_path, *extra):
    return build_cfg(parse_args(["--task=T1", "--terrain=plane", "--num_envs", "4",
                                 "--asset_file", write_t1_shaped_urdf(tmp_path), *extra]))


def test_cli_forces_the_xla_update_and_defaults_to_cuda(tmp_path):
    """The name is from when build_cfg overrode the task file.  Now the CLI
    follows T1.yaml's update_backend (fused), and still defaults to cuda."""
    cfg = _cfg(tmp_path)
    assert cfg["algorithm"]["update_backend"] == "fused"
    assert parse_args(["--task=T1"]).device == "cuda"


@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_runner_on_cpu_with_either_update(tmp_path, monkeypatch, backend):
    """Two tiny iterations through Runner: finite metrics, the network
    moves, and on the CPU no kernel is launched."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(tmp_path, "--num_envs", "8", "--max_iterations", "2")
    cfg["algorithm"]["update_backend"] = backend
    cfg["runner"]["mini_epochs"] = 3
    runner = Runner(cfg, device="cpu")
    assert runner.ppo.update_backend == backend
    before = torch.cat([p.detach().reshape(-1).clone() for p in runner.ppo.network.parameters()])
    records = runner.train()
    after = torch.cat([p.detach().reshape(-1) for p in runner.ppo.network.parameters()])
    assert len(records) == 2 and float((after - before).abs().max()) > 0
    for rec in records:
        assert all(np.isfinite(v) for v in rec.values()), rec
        assert [rec[k] for k in ("substep_kernel_launches", "gae_launches",
                                 "grads_stats_launches", "opt_stage_launches")] == [0] * 4
    assert runner.train_state.opt.count == 2 * 3


@pytest.mark.parametrize("fn", [T1, SubstepKernel, make_substep, make_fk,
                                env_params_from_jax, env_state_from_jax])
def test_device_is_a_required_argument(fn):
    """Below the runner nothing picks a device for the caller: a caller that
    leaves it out gets a TypeError, never the plain physics on the host."""
    assert inspect.signature(fn).parameters["device"].default is inspect.Parameter.empty
    assert inspect.signature(Runner).parameters["device"].default == "cuda"


def test_main_path_cfg():
    cfg = main_path_cfg("/nonexistent/T1_shaped.urdf")
    assert cfg["env"]["num_envs"] == 4096 and cfg["terrain"]["type"] == "plane"
    assert (cfg["runner"]["horizon_length"], cfg["runner"]["mini_epochs"]) == (24, 20)
    assert cfg["algorithm"]["update_backend"] == "fused"
    assert cfg["asset"]["file"] == "/nonexistent/T1_shaped.urdf"


def test_rough_path_cfg_and_cli_keep_the_task_files_terrain(tmp_path):
    """Without --terrain, build_cfg keeps T1.yaml's terrain block unchanged;
    rough_path_cfg is main_path_cfg on that block."""
    task = load_task_cfg("T1")["terrain"]
    assert task["type"] == "trimesh"
    cli = build_cfg(parse_args(["--task=T1", "--num_envs", "4"]))
    assert cli["terrain"] == task
    rough, flat = rough_path_cfg("/nonexistent/T1_shaped.urdf"), main_path_cfg("/x.urdf")
    assert rough["terrain"] == task
    assert rough["env"]["num_envs"] == 4096 and rough["basic"]["max_iterations"] == 3
    assert {k: v for k, v in flat["terrain"].items() if k != "type"} == \
        {k: v for k, v in task.items() if k != "type"}
    assert "sim" in rough and "backend" not in rough["sim"]      # the kernel path


@pytest.mark.parametrize("backend", ["fused", "xla"])
def test_runner_on_cpu_on_a_small_field(tmp_path, monkeypatch, backend):
    """Two tiny iterations of the trimesh path (the kernels' plain versions)
    through Runner with either update: finite metrics, no launches."""
    monkeypatch.chdir(tmp_path)
    cfg = build_cfg(parse_args(["--task=T1", "--num_envs", "8", "--max_iterations", "2",
                                "--asset_file", write_t1_shaped_urdf(tmp_path)]))
    cfg["terrain"].update(num_terrains=2, terrain_width=4.0, terrain_length=4.0,
                          border_size=2.0)
    cfg["algorithm"]["update_backend"] = backend
    cfg["runner"]["mini_epochs"] = 3
    runner = Runner(cfg, device="cpu")
    assert tuple(runner.env.terrain.height_field.shape) == (120, 80)
    assert runner.env.terrain_sampler is not None and not runner.env.substep.plane
    records = runner.train()
    assert len(records) == 2
    for rec in records:
        assert all(np.isfinite(v) for v in rec.values()), rec
        assert rec["substep_kernel_launches"] == rec["terrain_sampler_launches"] == 0
        assert rec["fused_sampler_launches"] == 0
    state = runner.train_state.env_state
    assert float(state.point_heights.abs().max()) > 0
    assert bool(torch.isfinite(state.point_normals).all())


def test_cuda_default_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        Runner(_cfg(tmp_path), device="cuda")


def test_unported_paths_raise(tmp_path):
    cfg = _cfg(tmp_path)
    cfg["terrain"]["type"] = "heightmap"     # trimesh is ported; other names are invalid
    with pytest.raises(ValueError, match="terrain type"):
        Runner(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        Runner(_cfg(tmp_path, "--checkpoint", "-1"), device="cpu")
    cfg = _cfg(tmp_path)
    cfg["asset"]["file"] = "resources/T1/T1_locomotion.urdf"
    if not os.path.exists(os.path.join(REPO, cfg["asset"]["file"])):
        with pytest.raises(FileNotFoundError):
            Runner(cfg, device="cpu")
