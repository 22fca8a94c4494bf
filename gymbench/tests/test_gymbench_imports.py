"""No module of JAX or of the JAX package loads in a run: a cell's modules
import with those blocked, and the check compares top-level names whole
(the port's name begins with the JAX package's)."""

import os
import subprocess
import sys

from gymbench import run

from .conftest import ROOT

BLOCK = r'''
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "booster_gym_tpu"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import gymbench.run, gymbench.cells, gymbench.calibrate
import booster_gym_torch.runner, booster_gym_torch.envs.t1
from gymbench import spec
for m in spec.benchmark()["per_layer"]:
    spec.metric_reader(m["name"])
print("loaded", gymbench.run.forbidden_modules())
'''


def test_cell_modules_load_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", BLOCK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded []"


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    fake = type(sys)("x")
    for name in ("booster_gym_torch_extra", "jaxlike", "jax.numpy", "booster_gym_tpu.envs",
                 "flax"):
        monkeypatch.setitem(sys.modules, name, fake)
    found = run.forbidden_modules()
    assert {"jax.numpy", "booster_gym_tpu.envs", "flax"} <= set(found)
    assert "jaxlike" not in found and "booster_gym_torch_extra" not in found
    assert not any(n.split(".")[0] == "booster_gym_torch" for n in found)
