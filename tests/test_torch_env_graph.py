"""T1.step as CUDA graphs (booster_gym_torch/envs/step_graph.py).

On the card (`cuda`-marked): from one state and one seed, 48 steps of
T1.step, which replays its five parts as CUDA graphs once it has captured
them, against 48 op-by-op steps (T1._step_eager), on the plane (with the
command curriculum), on trimesh (with the exact still fraction) and for
T1Standup, across resets, kicks, pushes and command resampling: every
returned tensor and its layout bitwise equal; what a step returned is left
untouched by the next; a new generator or params object captures anew;
the counters of calls and launches; and no host sync in either step.

Here, on the CPU: the step builds no tensor from host data, runs op by op
off the card, under the eager engine and over several ranks, the
constants made once equal those the step used to build, and Layout's
copies keep shared storages, strides and alignment.  This file imports nothing of
JAX, so the marked tests run on the card with
`pytest --noconftest -m cuda tests/test_torch_env_graph.py`.
"""

import contextlib
import dataclasses

import pytest
import torch

from booster_gym_torch.envs.standup import T1Standup
from booster_gym_torch.envs.step_graph import Layout, rebuild, tensors
from booster_gym_torch.envs.t1 import T1
from booster_gym_torch.parallel import Group
from booster_gym_torch.testing import (
    write_t1_serial_mjcf,
    write_t1_serial_urdf,
    write_t1_shaped_urdf,
)
from booster_gym_torch.utils.config import load_task_cfg

STEPS = 48


def busy_cfg(directory, task, num_envs):
    """A config in which 48 steps see what a step can do: episodes of 15
    steps (time-outs and resets), kicks every 5 steps, pushes every 10 for
    5, commands resampled every 5-15 steps; on the plane the command
    curriculum, on trimesh the exact still fraction (T1.yaml's field);
    T1Standup on the serial stand-in with a bank settled for 2 rounds."""
    if task == "standup":
        cfg = load_task_cfg("T1Standup")
        cfg["asset"]["file"] = write_t1_serial_urdf(directory)
        cfg["asset"]["mujoco_file"] = write_t1_serial_mjcf(directory)
        cfg["standup"]["settle_rounds"] = 2
    else:
        cfg = load_task_cfg("T1")
        cfg["asset"]["file"] = write_t1_shaped_urdf(directory)
        cfg["terrain"]["type"] = task
        cfg["commands"]["resampling_time_s"] = [0.1, 0.3]
        if task == "plane":
            cfg["commands"]["curriculum"] = True
        else:
            cfg["commands"]["still_mode"] = "exact_fraction"
    cfg["env"]["num_envs"] = num_envs
    cfg["rewards"]["episode_length_s"] = 0.3
    rand = cfg["randomization"]
    rand.update(kick_interval_s=0.1, push_interval_s=0.2, push_duration_s=0.1)
    return cfg


def make_env(task, directory, device, num_envs=64, group=None):
    cfg = busy_cfg(directory, task, num_envs)
    return (T1Standup if task == "standup" else T1)(cfg, device, group)


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_bitwise(a, b, label):
    ta, tb = tensors(a), tensors(b)
    assert len(ta) == len(tb), label
    for i, (x, y) in enumerate(zip(ta, tb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (label, i)
        assert torch.equal(bits(x), bits(y)), (label, i)


# ---------------------------------------------------------------------------
# on the card
@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs replay the card's kernels")
    return torch.device("cuda")


@contextlib.contextmanager
def no_host_sync():
    """torch raises at any op that waits for the device or copies host data
    to it."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["plane", "trimesh", "standup"])
def test_graphed_steps_are_the_op_by_op_steps_bitwise(gpu, task, tmp_path):
    env = make_env(task, tmp_path, gpu)
    seeded = lambda s: torch.Generator(device=gpu).manual_seed(s)
    params = env.init_params(seeded(0))
    start, _, _ = env.reset_all(params, seeded(1))
    acts = 0.5 * torch.randn((STEPS + 6, env.num_envs, env.num_actions), generator=seeded(2),
                             device=gpu)
    gen_g, gen_e = seeded(3), seeded(3)
    sub = env.substep
    sampled = 0 if sub.plane else 1
    s_g = s_e = start
    held = None
    resets = 0
    # the first call builds the control-step kernel: outside the sync check
    for k in range(STEPS + 6):
        if k == STEPS:       # a new generator object in the same state
            gen_g = torch.Generator(device=gpu)
            gen_g.set_state(gen_e.get_state())
        if k == STEPS + 3:   # a new params object over the same tensors
            params = dataclasses.replace(params)
        graphs = env._graphs
        n, n_fused = sub.launches, sub.fused_sampler_launches
        with no_host_sync() if k else contextlib.nullcontext():
            out_g = env.step(params, s_g, acts[k], gen_g)
        assert (sub.launches, sub.fused_sampler_launches) == (n + 1, n_fused + sampled), k
        with no_host_sync() if k else contextlib.nullcontext():
            out_e = env._step_eager(params, s_e, acts[k], gen_e)
        assert_bitwise(out_g, out_e, k)
        assert [t.stride() for t in tensors(out_g)] == [t.stride() for t in tensors(out_e)], k
        if held is not None:   # the last step's outputs, left as they were returned
            assert_bitwise(held[0], held[1], ("held", k))
        held = (out_g, rebuild(out_g, iter([t.clone() for t in tensors(out_g)])))
        if k in (STEPS, STEPS + 3):
            assert env._graphs is graphs, "the first call with a new object runs op by op"
        if k in (STEPS + 1, STEPS + 4):
            assert env._graphs is not graphs, "the second captures anew"
            assert env._graphs.gen is gen_g and env._graphs.params is params
        resets += int(out_e[3].sum())
        s_g, s_e = out_g[0], out_e[0]
    assert_bitwise(s_g, s_e, "final state")
    assert resets > 0
    # two op-by-op calls after reset_all (its layout, then the step's), then
    # one after each new object
    assert (env.eager_steps, env.graph_replays) == (4, STEPS + 2)


# ---------------------------------------------------------------------------
# on the CPU
@pytest.mark.parametrize("task", ["plane", "trimesh", "standup"])
def test_step_builds_no_tensor_from_host_data(task, tmp_path, monkeypatch):
    env = make_env(task, tmp_path, "cpu", num_envs=4)
    gen = torch.Generator().manual_seed(0)
    params = env.init_params(gen)
    state, _, _ = env.reset_all(params, gen)

    def refuse(*args, **kw):
        raise AssertionError("the step built a tensor from host data")

    with monkeypatch.context() as m:
        m.setattr(torch, "tensor", refuse)
        m.setattr(torch, "as_tensor", refuse)
        for k in range(3):
            state = env.step(params, state, torch.zeros(4, env.num_actions), gen)[0]
    assert (env.eager_steps, env.graph_replays) == (3, 0)


def test_step_runs_op_by_op_off_one_card(tmp_path, monkeypatch):
    """The graphs serve one card, the kernel backend and one rank: on the
    CPU, under sim.backend xla or at world size 2 (here with the device
    type made cuda, and the step's bodies stubbed), step runs op by op."""
    graphed, eager = [], []
    monkeypatch.setattr(T1, "_step_graphed", lambda self, *a: graphed.append(self))
    monkeypatch.setattr(T1, "_step_eager", lambda self, *a: eager.append(self))
    cfg = busy_cfg(tmp_path, "plane", 4)
    xla = busy_cfg(tmp_path, "plane", 4)
    xla["sim"]["backend"] = "xla"
    envs = {"cpu": T1(cfg, "cpu"), "xla": T1(xla, "cpu"),
            "world 2": T1(busy_cfg(tmp_path, "plane", 8), "cpu",
                          Group(8, torch.device("cpu"), world=2, rank=1, backend="gloo")),
            "one card": T1(cfg, "cpu")}
    for name, env in envs.items():
        if name != "cpu":
            env.device = torch.device("cuda")
        env.step(None, None, None, None)
    assert graphed == [envs["one card"]]   # stubbed: it returned None, so op by op too
    assert eager == list(envs.values())
    assert [e.eager_steps for e in envs.values()] == [1, 1, 1, 1]


def test_hoisted_constants_are_the_former_ones(tmp_path):
    """The constants the step made at each call, made once at construction
    as device tensors."""
    env = make_env("plane", tmp_path, "cpu", num_envs=4)
    ncfg = env.cfg["normalization"]
    assert torch.equal(env.gravity_dir, torch.tensor([0.0, 0.0, -1.0]))
    assert torch.equal(env.commands_scale,
                       torch.tensor([ncfg["lin_vel"], ncfg["lin_vel"], ncfg["ang_vel"]]))
    for index, listed in ((env.penalized_contact_index, env.penalized_contact_indices),
                          (env.termination_contact_index, env.termination_contact_indices)):
        assert index.dtype == torch.int64 and index.tolist() == listed
        forces = torch.randn(4, env.model.num_bodies, 3)
        assert torch.equal(forces[:, index], forces[:, listed])
    assert env.penalized_contact_indices
    standup = make_env("standup", tmp_path, "cpu", num_envs=4)
    assert standup.feet_index.tolist() == standup.feet_indices


def test_layout_copies_keep_storages_strides_and_alignment():
    base = torch.randn(7, 5)
    a, b = base.T[:, 1:4], base.T[:, 4:7]                  # two strided views of one storage
    c = torch.arange(6).reshape(2, 3).T                    # a transposed int64 tensor
    d = torch.tensor([True, False, True])
    tree = {"x": (a, b), "y": [c, d], "z": None}
    layout = Layout(tensors(tree))
    assert len(layout.storages) == 3
    copy = rebuild(tree, iter(layout.clone()))
    for x, y in zip(tensors(tree), tensors(copy)):
        assert torch.equal(x, y) and x.dtype == y.dtype
        assert x.stride() == y.stride()
        align = lambda t: (t.untyped_storage().data_ptr() + t.storage_offset() * t.itemsize) % 16
        assert align(x) == align(y)
        assert x.untyped_storage().data_ptr() != y.untyped_storage().data_ptr()
    assert copy["z"] is None
    assert (copy["x"][0].untyped_storage().data_ptr()
            == copy["x"][1].untyped_storage().data_ptr())   # still one storage
    assert Layout(tensors(copy)).key == layout.key
    base.zero_()                                           # the copy holds its own bytes
    assert not torch.equal(copy["x"][0], a)
    moved = dict(tree, y=[c.contiguous(), d])
    assert Layout(tensors(moved)).key != layout.key
    # a step's actions cut from a sequence: the copy covers the step's rows,
    # laid out alike at every step
    seq = torch.randn(5, 4, 12)
    assert Layout([seq[1]]).key == Layout([seq[3]]).key
    assert Layout([seq[1]]).regions == [(4 * 12 * 4, 2 * 4 * 12 * 4)]
    assert torch.equal(Layout([seq[3]]).clone()[0], seq[3])
