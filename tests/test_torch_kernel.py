"""The kernels' wrappers: K1 and K5 (booster_gym_torch/physics/
substep_kernel.py), the terrain sampler K6 + K7 (booster_gym_torch/terrain/
sample_kernel.py) and K2-K4 and K8-K10 (booster_gym_torch/algo/
update_kernel.py).

The CUDA kernels run only on a card: the tests marked `cuda` hold each
against its plain version there and skip without one (chip_smoke.py runs
the same checks); K1 and K5 both through one substep and through
control_step, the decimation loop in one launch.  This file imports nothing of JAX, so the marked tests
run on the card with `pytest --noconftest -m cuda`.  The rest run here: the component-major layout, the
model table against the offsets csrc/substep.cu declares, and the CPU
path, which must be the plain version exactly and count no launch.
"""

import re

import numpy as np
import pytest
import torch

from booster_gym_torch import kernel_build
from booster_gym_torch.model import load_urdf
from booster_gym_torch.physics import DynParams, SimConfig, SimState
from booster_gym_torch.physics import substep_kernel as sk
from booster_gym_torch.physics.engine import ModelConsts, make_fk, make_substep
from booster_gym_torch.physics.kinematics import point_world_positions
from booster_gym_torch.algo import update_kernel
from booster_gym_torch.terrain import Terrain
from booster_gym_torch.terrain import sample_kernel
from booster_gym_torch.testing import (
    anchor_case,
    device_kernels,
    per_call,
    point_terrain_inputs,
    sampler_inputs,
    seeded_network,
    toy_model,
    update_case,
    write_t1_shaped_urdf,
)
from booster_gym_torch.utils.config import load_task_cfg


EDGES = np.asarray(load_task_cfg("T1")["asset"]["feet_edge_pos"], np.float32)


@pytest.fixture(scope="module", params=["toy", "t1"])
def robot(request, tmp_path_factory):
    if request.param == "toy":
        model = toy_model()
    else:
        model = load_urdf(write_t1_shaped_urdf(tmp_path_factory.mktemp("u")),
                          cylinder_rim_points=4)
    feet = [i for i, n in enumerate(model.body_names) if "foot" in n]
    return model, feet


def inputs(model, B, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.rand(s, generator=g) * 2 - 1
    nd, nb, ns = model.num_dofs, model.num_bodies, len(model.shape_body)
    quat = torch.nn.functional.normalize(r(B, 4), dim=-1)
    state = SimState(root_pos=r(B, 3) * 0.1 + torch.tensor([0, 0, 0.6]), root_quat=quat,
                     root_lin_vel=r(B, 3), root_ang_vel=r(B, 3), q=r(B, nd), qd=r(B, nd))
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    dyn = DynParams(body_mass=f32(model.body_mass).expand(B, nb).clone(),
                    body_com=f32(model.body_com).expand(B, nb, 3).clone(),
                    body_inertia=f32(model.body_inertia).expand(B, nb, 3, 3).clone(),
                    shape_friction=1 + 0.5 * r(B, ns), shape_restitution=0.2 + 0.1 * r(B, ns))
    to = lambda x: x.to(device)
    state = SimState(**{k: to(getattr(state, k)) for k in SimState.FIELDS})
    dyn = DynParams(**{k: to(v) for k, v in vars(dyn).items()})
    return state, dyn, to(5 * r(B, nd)), to(2 * r(B, 3)), to(0.5 * r(B, 3))


def test_layout_round_trip(robot):
    model, feet = robot
    k = sk.SubstepKernel(model, SimConfig(), feet, "cpu")
    state, dyn, *_ = inputs(model, 7)
    ps, pd = k.pack_sim(state), k.pack_dyn(dyn)
    assert ps.shape == (13 + 2 * model.num_dofs, 7) and ps.is_contiguous()
    assert pd.shape == (10 * model.num_bodies + 2 * len(model.shape_body), 7)
    back = k.unpack_sim(ps)
    for f in SimState.FIELDS:
        assert torch.equal(getattr(back, f), getattr(state, f)), f
    dback = k.unpack_dyn(pd)
    for f in vars(dyn):
        assert torch.equal(getattr(dback, f), getattr(dyn, f)), f


def test_model_table_matches_kernel_offsets(robot):
    """The table's length is the kernel's OFF_CFG + 14, with OFF_* parsed
    from csrc/substep.cu, and each block sits where the kernel reads it."""
    model, feet = robot
    cfg = SimConfig()
    table = sk.model_tables(model, cfg, feet)
    sizes = sk.kernel_sizes(model, feet)
    src = open(sk.CSRC).read()
    offs = {"OFF_PARENT": 0}
    assert "#define OFF_PARENT 0" in src
    for name, expr in re.findall(r"#define (OFF_\w+) \((.*)\)", src):
        offs[name] = eval(expr, {}, {**sizes, **offs})
    assert len(table) == offs["OFF_CFG"] + 14
    np.testing.assert_array_equal(table[offs["OFF_PARENT"]:][:model.num_bodies], model.parent)
    np.testing.assert_allclose(table[offs["OFF_PPOS"]:][:3 * model.num_points],
                               np.asarray(model.point_pos, np.float32).reshape(-1))
    np.testing.assert_array_equal(table[offs["OFF_FEET"]:][:len(feet)], feet)
    assert table[offs["OFF_CFG"]] == np.float32(cfg.dt)
    assert table[offs["OFF_CFG"] + 4] == cfg.solver_iterations
    assert table[-1] == np.float32(cfg.mass_matrix_reg)


@pytest.mark.parametrize("B", [5, 33])
def test_cpu_path_is_the_plain_version(robot, B):
    model, feet = robot
    cfg = SimConfig()
    k = sk.SubstepKernel(model, cfg, feet, "cpu")
    plain = make_substep(model, cfg, feet, "cpu")
    args = inputs(model, B, seed=B)
    out_k, out_p = k.step(*args), plain(*args)
    for f in SimState.FIELDS:
        assert torch.equal(getattr(out_k[0], f), getattr(out_p[0], f)), f
    for a, b in zip(out_k[1:], out_p[1:]):
        assert torch.equal(a, b)
    assert k.launches == 0


def test_library_path_hashes_the_headers_a_source_includes(tmp_path, monkeypatch):
    """A source's library name changes when a header it includes (through
    another header too) changes, and not when an unrelated file does."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("#define X 1\n")
    (tmp_path / "other.cuh").write_text("#define Y 1\n")
    monkeypatch.setattr(kernel_build, "CSRC_DIR", str(tmp_path))
    assert kernel_build.local_headers("k.cu") == ["a.cuh", "b.cuh"]
    path = kernel_build.library_path("k.cu", {"N": 1})
    (tmp_path / "other.cuh").write_text("#define Y 2\n")
    assert kernel_build.library_path("k.cu", {"N": 1}) == path
    (tmp_path / "b.cuh").write_text("#define X 2\n")
    changed = kernel_build.library_path("k.cu", {"N": 1})
    assert changed != path and changed.startswith(path.rsplit("_", 1)[0])
    # the port's sources: the substep kernel and the sampler share the header
    monkeypatch.undo()
    for src in ("substep.cu", "terrain_sample.cu"):
        assert kernel_build.local_headers(src) == ["terrain_sample.cuh"]
    assert kernel_build.local_headers("update.cu") == []


@pytest.mark.parametrize("count,expect", [
    (1.0, 1), (0.9, 1), (0.8, 1), (2.0, 2), (1.9, 2),   # whole, or records short
    (1.1, 2), (0.0, 0),                                # a second launch, or none
])
def test_per_call_reads_one_dropped_record(count, expect):
    """Dropped records lower a count, never raise it: a count in (n - 1, n]
    is n launches per call."""
    assert per_call(count) == expect


def test_compare_trees_gae_diff(tmp_path, capsys):
    """compare_trees' gae-diff: bitwise equality of two saved K2 outputs."""
    from booster_gym_torch import compare_trees

    out = [torch.arange(4.0), torch.ones(2), torch.tensor(1.0), torch.tensor(2.0)]
    torch.save({"bf16_8": out}, tmp_path / "a.pt")
    torch.save({"bf16_8": [out[0], out[1] + 1e-7, out[2], out[3]]}, tmp_path / "b.pt")
    compare_trees.main(["gae-diff", str(tmp_path / "a.pt"), str(tmp_path / "b.pt")])
    assert "[True, False, True, True]" in capsys.readouterr().out


def test_library_name_carries_sizes_and_source_hash(robot):
    model, feet = robot
    path = kernel_build.library_path(sk.SOURCE, sk.kernel_sizes(model, feet))
    assert f"nb{model.num_bodies}_nd{model.num_dofs}_npt{model.num_points}" in path
    assert path.endswith(".so") and "build" in path


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4096, 1000])
def test_kernel_matches_plain_on_card(gpu, robot, B):
    model, feet = robot
    cfg = SimConfig()
    k = sk.SubstepKernel(model, cfg, feet, gpu)
    plain = make_substep(model, cfg, feet, gpu)
    args = inputs(model, B, gpu, seed=B)
    out_k, out_p = k.step(*args), plain(*args)
    torch.cuda.synchronize()
    assert k.launches == 1
    for f in SimState.FIELDS:
        torch.testing.assert_close(getattr(out_k[0], f), getattr(out_p[0], f),
                                   rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(out_k[1], out_p[1], rtol=5e-2, atol=1.0)
    with pytest.raises(ValueError):
        k.packed_call(k.pack_sim(args[0]).double(), k.pack_dyn(args[1]),
                      args[2].T.contiguous(), torch.zeros(6, B, device=gpu))


# ---------------------------------------------------------------------------
# control_step: the decimation loop in one launch
def control_args(k, model, B, device, seed):
    """control_step's inputs: a state from inputs(), PD targets near q,
    gains and joint friction for which explicit damping is stable on the
    robot (T1.yaml's on the T1-shaped robot; on the toy, whose foot has
    ~2e-3 kg m^2 about the knee, kd <= 0.2), the torque limits, delays
    spread over 0..9 and a push; K5 also the terrain under the points as
    the env carries it: the root over a random spot of T1.yaml's field,
    raised by its height there, and the field's height and normal at each
    point's xy."""
    state, dyn, tau, ef, et = inputs(model, B, device, seed)
    g = torch.Generator().manual_seed(seed + 1)
    r = lambda lo, hi, *s: (lo + (hi - lo) * torch.rand(s, generator=g)).to(device)
    nd = model.num_dofs
    if model.num_bodies > 3:
        ctl = load_task_cfg("T1")["control"]
        gain = lambda table: torch.tensor([next(v for k, v in table.items() if k in n)
                                           for n in model.dof_names], device=device)
        kp = gain(ctl["stiffness"]) * r(0.95, 1.05, B, nd)
        kd = gain(ctl["damping"]) * r(0.95, 1.05, B, nd)
        fric = r(0, 2, B, nd)
    else:
        kp, kd, fric = r(5, 20, B, nd), r(0.05, 0.2, B, nd), r(0, 0.2, B, nd)
    c = dict(targets=state.q + r(-0.1, 0.1, B, nd), last=state.q + r(-0.05, 0.05, B, nd),
             delay=(torch.arange(B) % 10).to(device), kp=kp, kd=kd, fric=fric,
             lim=torch.as_tensor(np.asarray(model.dof_effort, np.float32), device=device),
             ext=torch.cat([ef, et], dim=-1).contiguous())
    ph = pn = None
    if not k.plane:   # T1.yaml's field under each point's own xy, as the env carries it
        terrain = Terrain(load_task_cfg("T1")["terrain"], seed=0, device=device)
        root_xy = r(0.5, 9.5, B, 2)
        pos = state.root_pos.clone()
        pos[:, :2] = root_xy
        pos[:, 2] += terrain.heights(root_xy)
        state = SimState(**{**vars(state), "root_pos": pos})
        body_R, body_pos = make_fk(model, device)(state)
        xy = point_world_positions(ModelConsts.build(model, device), body_R, body_pos)[..., :2]
        h, n = terrain.heights_and_normals(xy.contiguous())
        ph, pn = h.T.contiguous(), n.reshape(B, -1).T.contiguous()
    return (k.pack_sim(state), k.pack_dyn(dyn), c["targets"].contiguous(),
            c["last"].contiguous(), c["delay"], c["kp"], c["kd"], c["fric"], c["lim"], c["ext"],
            ph, pn)


def test_cpu_control_step_is_the_plain_version(robot):
    model, feet = robot
    for plane in (True, False):
        k = sk.SubstepKernel(model, SimConfig(), feet, "cpu", plane=plane)
        args = control_args(k, model, 6, "cpu", seed=3)
        out, ref = k.control_step(*args), k.control_step_plain(*args)
        assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(out, ref))
        assert k.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4096, 1000])
@pytest.mark.parametrize("plane", [True, False], ids=["K1", "K5"])
def test_control_step_matches_plain_on_card(gpu, robot, B, plane):
    """One launch against the plain decimation loop: the env step's 2e-3 on
    the state, the latched targets, the torque mean and the feet; forces
    rtol 5e-2 / atol 1 N; K5's point xy atol 1e-5; on every env but the
    chaotic ones (at most 1%), where the plain loop cannot reproduce its own
    new state to 2e-3 under a one-ulp nudge of the state.  A second launch
    repeats the first bitwise."""
    model, feet = robot
    k = sk.SubstepKernel(model, SimConfig(), feet, gpu, plane=plane)
    args = control_args(k, model, B, gpu, seed=B)
    out, out2 = k.control_step(*args), k.control_step(*args)
    ref = k.control_step_plain(*args)
    nudged = (torch.nextafter(args[0], torch.full_like(args[0], float("inf"))), *args[1:])
    ref_nudged = k.control_step_plain(*nudged)
    torch.cuda.synchronize()
    assert k.launches == 2
    for a, a2 in zip(out, out2):
        assert (a is None and a2 is None) or torch.equal(a, a2)
    # (index, rtol, atol, env axis); the torque sum as the env's mean
    checks = [(0, 2e-3, 2e-3, 1), (1, 2e-3, 2e-3, 0), (2, 2e-3, 2e-3, 0),
              (3, 5e-2, 1.0, 1), (4, 2e-3, 2e-3, 1)] + ([] if plane else [(5, 0.0, 1e-5, 1)])
    scale = lambda i, x: x / 10 if i == 2 else x
    over = lambda x, y, rtol, atol, ax: ((x - y).abs() > atol + rtol * y.abs()).transpose(0, ax).any(1)
    # envs where the plain loop's own state moves past the tolerance under a
    # one-ulp nudge of the state are chaotic over ten substeps: left out
    chaotic = over(ref_nudged[0], ref[0], 2e-3, 2e-3, 1)
    assert int(chaotic.sum()) <= B // 100
    keep = ~chaotic
    for i, rt, at, ax in checks:
        bad = over(scale(i, out[i]), scale(i, ref[i]), rt, at, ax)
        assert not bool(bad[keep].any()), i
    with pytest.raises(ValueError):
        k.control_step(*args[:4], args[4].int(), *args[5:])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4096, 1000])
def test_control_step_general_on_plane_inputs_equals_plane_kernel(gpu, robot, B):
    """K5 on h = 0, n = +z against K1 through control_step: difference 0,
    the epilogue's foot edge points included."""
    model, feet = robot
    k1 = sk.SubstepKernel(model, SimConfig(), feet, gpu, feet_edge_pos=EDGES)
    k5 = sk.SubstepKernel(model, SimConfig(), feet, gpu, plane=False, feet_edge_pos=EDGES)
    args = control_args(k1, model, B, gpu, seed=B + 5)
    ph = torch.zeros((model.num_points, B), device=gpu)
    pn = torch.zeros((3 * model.num_points, B), device=gpu)
    pn[2::3] = 1.0
    out1, out5 = k1.control_step(*args), k5.control_step(*args[:10], ph, pn)
    torch.cuda.synchronize()
    assert (k1.launches, k5.launches) == (1, 1)
    assert out1.edges.shape == (B, 3, len(feet) * len(EDGES))
    for a, b in zip(out1[:5] + (out1.edges,), out5[:5] + (out5.edges,)):
        assert float((a - b).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4096, 1000])
def test_fused_sampling_equals_sampler_kernel_on_card(gpu, robot, B):
    """K5's control step with T1.yaml's field: the epilogue's edge points
    equal the torch ops on its own feet poses bitwise, and its heights and
    normals equal the standalone sampler kernel's on its own queries (the
    contact points' xy, the root, the edge points) bitwise and the plain
    sampler's to 2e-5."""
    model, feet = robot
    terrain = Terrain(load_task_cfg("T1")["terrain"], seed=0, device=gpu)
    k = sk.SubstepKernel(model, SimConfig(), feet, gpu, plane=False, feet_edge_pos=EDGES,
                         terrain=terrain)
    args = control_args(k, model, B, gpu, seed=B + 3)
    out = k.control_step(*args, terrain.height_field)
    out2 = k.control_step(*args, terrain.height_field)
    torch.cuda.synchronize()
    assert (k.launches, k.fused_sampler_launches, k.sampler.launches) == (2, 2, 0)
    assert all(torch.equal(a, b) for a, b in zip(out, out2))
    nf, ne, npt = len(feet), len(EDGES), model.num_points
    fe = out.feet.T.reshape(B, nf, 12)
    edge_xyz = sk.feet_edge_world(fe[..., 0:3], fe[..., 3:12].reshape(B, nf, 3, 3),
                                  EDGES.tolist())
    edges = out.edges.view(B, 3, nf, ne).unbind(1)
    for a, b in zip(edges, edge_xyz):
        assert torch.equal(a, b)
    root_xy = out.state[0:2].T.contiguous()
    queries = torch.cat([out.ptxy.T.reshape(B, npt, 2), root_xy[:, None, :],
                         torch.stack([edge_xyz[0].reshape(B, -1), edge_xyz[1].reshape(B, -1)],
                                     -1)], dim=1).contiguous()
    h, n = k.sampler(terrain.height_field, root_xy, queries)
    h_p, n_p = k.sampler.plain(terrain.height_field, root_xy, queries)
    torch.cuda.synchronize()
    assert k.sampler.launches == 1
    fh, fn = out.heights, out.normals
    assert torch.equal(fh, h) and torch.equal(fn, n)
    torch.testing.assert_close(fh, h_p, rtol=0, atol=2e-5)
    torch.testing.assert_close(fn, n_p, rtol=0, atol=2e-5)
    assert float(fh.abs().max()) > 0
    with pytest.raises(ValueError):
        k.control_step(*args, terrain.height_field.double())


@pytest.mark.cuda
@pytest.mark.parametrize("plane", [True, False], ids=["K1", "K5"])
def test_substep_launches_repeat_bitwise(gpu, robot, plane):
    model, feet = robot
    B = 1000
    k = sk.SubstepKernel(model, SimConfig(), feet, gpu, plane=plane)
    state, dyn, tau, ef, et = inputs(model, B, gpu, seed=9)
    ps, pd = k.pack_sim(state), k.pack_dyn(dyn)
    terr = control_args(k, model, B, gpu, seed=9)[10:] if not plane else ()
    call = lambda: k.packed_call(ps, pd, tau.T.contiguous(),
                                 torch.cat([ef, et], dim=-1).T.contiguous(), *terr)
    out, out2 = call(), call()
    torch.cuda.synchronize()
    for a, b in zip(out, out2):
        assert (a is None and b is None) or torch.equal(a, b)
    info = k.info()
    # both robots' working sets fit 8 envs a block and 4 blocks an SM
    # (csrc/substep.cu picks the launch shape)
    assert (info["envs_per_block"], info["min_blocks_per_sm"]) == (8, 4)
    assert info["blocks_per_sm_control"] >= 1


# ---------------------------------------------------------------------------
# K5 and the terrain sampler
def test_general_build_has_its_own_library_and_entry_point(robot):
    model, feet = robot
    plane = kernel_build.library_path(sk.SOURCE, sk.kernel_sizes(model, feet))
    general = kernel_build.library_path(sk.SOURCE, sk.kernel_sizes(model, feet, plane=False))
    assert "_plane1_" in plane and "_plane0_" in general
    assert plane.replace("_plane1_", "_plane0_") == general
    src = open(sk.CSRC).read()
    (decl,) = re.findall(r"int bg_substep_terrain\(([^)]*)\)", src)
    assert len(decl.split(",")) == 13      # 11 pointers, B, the stream
    (decl,) = re.findall(r"int bg_substep\(([^)]*)\)", src)
    assert len(decl.split(",")) == 10


def test_sampler_entry_point_and_cpu_path():
    src = open(kernel_build.source_path(sample_kernel.SOURCE)).read()
    (decl,) = re.findall(r"int bg_terrain_sample\(([^)]*)\)", src)
    assert len(decl.split(",")) == 12
    assert '#include "terrain_sample.cuh"' in src
    header = open(kernel_build.source_path("terrain_sample.cuh")).read()
    assert f"#define PX {sample_kernel.PX}" in header
    terrain = Terrain(load_task_cfg("T1")["terrain"], seed=0)
    sampler = sample_kernel.make_terrain_sampler(terrain, 65, "cpu")
    root, pts = (torch.as_tensor(x) for x in sampler_inputs(terrain, 7, 65, 0.5, False, 0))
    h, n = sampler(terrain.height_field, root, pts)
    h_p, n_p = sampler.plain(terrain.height_field, root, pts)
    assert torch.equal(h, h_p) and torch.equal(n, n_p) and sampler.launches == 0
    torch.testing.assert_close(n.norm(dim=-1), torch.ones(7, 65))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4096, 1000])
def test_general_kernel_matches_plain_on_card(gpu, robot, B):
    """K5 against its plain version with tilted normals: K1's tolerances,
    and the contact-point xy to atol 1e-5."""
    model, feet = robot
    cfg = SimConfig()
    k = sk.SubstepKernel(model, cfg, feet, gpu, plane=False)
    plain = make_substep(model, cfg, feet, gpu)
    args = inputs(model, B, gpu, seed=B)
    h, n = (torch.as_tensor(x, device=gpu) for x in point_terrain_inputs(model.num_points, B, B))
    out_k, out_p = k.terrain_form(*args, h, n), plain.terrain_form(*args, h, n)
    torch.cuda.synchronize()
    assert k.launches == 1
    for f in SimState.FIELDS:
        torch.testing.assert_close(getattr(out_k[0], f), getattr(out_p[0], f),
                                   rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(out_k[1], out_p[1], rtol=5e-2, atol=1.0)
    torch.testing.assert_close(out_k[2], out_p[2], rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(out_k[4], out_p[4], rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        k.terrain_form(*args, h[:, :-1], n)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4096, 1000])
def test_general_kernel_on_plane_inputs_equals_plane_kernel(gpu, robot, B):
    """h = 0, n = +z: every general formula reduces to the plane kernel's by
    exact multiplications by 0 and 1, so the two builds differ by 0."""
    model, feet = robot
    cfg = SimConfig()
    k1 = sk.SubstepKernel(model, cfg, feet, gpu)
    k5 = sk.SubstepKernel(model, cfg, feet, gpu, plane=False)
    args = inputs(model, B, gpu, seed=B + 1)
    out1, out5 = k1.step(*args), k5.step(*args)
    torch.cuda.synchronize()
    assert (k1.launches, k5.launches) == (1, 1)
    for f in SimState.FIELDS:
        assert float((getattr(out1[0], f) - getattr(out5[0], f)).abs().max()) == 0.0, f
    for a, b in zip(out1[1:], out5[1:]):
        assert float((a - b).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4096, 1000])
@pytest.mark.parametrize("clamped", [False, True])
def test_sampler_kernel_matches_plain_on_card(gpu, B, clamped):
    """atol 2e-5 on heights and normals, the JAX package's own tolerance for
    its sampler; `clamped` puts roots at the field's edge and queries up to
    2 m from their root."""
    terrain = Terrain(load_task_cfg("T1")["terrain"], seed=0, device=gpu)
    sampler = sample_kernel.make_terrain_sampler(terrain, 65, gpu)
    root, pts = (torch.as_tensor(x, device=gpu) for x in sampler_inputs(
        terrain, B, 65, 2.0 if clamped else 0.55, clamped, seed=B))
    h, n = sampler(terrain.height_field, root, pts)
    h_p, n_p = sampler.plain(terrain.height_field, root, pts)
    torch.cuda.synchronize()
    assert sampler.launches == 1
    torch.testing.assert_close(h, h_p, rtol=0, atol=2e-5)
    torch.testing.assert_close(n, n_p, rtol=0, atol=2e-5)
    with pytest.raises(ValueError):
        sampler(terrain.height_field, root, pts[:, :-1].contiguous())


# ---------------------------------------------------------------------------
# K2-K4
def test_update_wrappers_run_the_plain_versions_on_the_cpu():
    fused, p, staged, prep, d = update_case("bf16", 3, 16, "cpu")
    *_, rew, done, timeout = d["buf"]
    nonterm, tf = 1.0 - (done | timeout).float(), timeout.float()
    out = fused.gae(staged, prep["obsc"], rew, nonterm, tf, 0.995, 0.95)
    ref = fused.gae_plain(staged, prep["obsc"], rew, nonterm, tf, 0.995, 0.95)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    args = (staged, p, prep, d["adv"], d["ret"], torch.tensor(0.3), torch.tensor(0.5), False)
    g, st, mu, logp = fused.grads_stats(*args)
    g_ref, st_ref, mu_ref, logp_ref = fused.grads_stats_plain(*args)
    assert torch.equal(g, g_ref) and torch.equal(logp, logp_ref)
    assert g.shape == (fused.n_params,) and mu.shape == (48, 12) and st["klsq"].shape == (12,)
    kw = dict(entropy_coef=-0.01, b1=0.9, b2=0.999, eps=1e-8, max_norm=1.0)
    out = fused.opt_stage(g, p, torch.zeros_like(p), torch.zeros_like(p), 0, torch.tensor(1e-3),
                          **kw)
    assert out[3].dtype == torch.bfloat16 and torch.equal(out[3], out[0].bfloat16())
    assert (fused.gae_launches, fused.grads_stats_launches, fused.opt_stage_launches) == (0, 0, 0)


def test_update_library_name_carries_the_network_sizes():
    fused = update_case("f32", 2, 4, "cpu")[0]
    assert fused.sizes == dict(NOBS=47, NPRIV=14, NACT=12, AH1=256, AH2=128, AH3=128,
                               CH1=256, CH2=256, CH3=128)
    path = kernel_build.library_path("update.cu", fused.sizes)
    assert "update_nobs47_npriv14_nact12" in path and path.endswith(".so")
    src = open(kernel_build.source_path("update.cu")).read()
    for name, argtypes in update_kernel._FUNCTIONS.items():
        (decl,) = re.findall(rf"int {name}\(([^)]*)\)", src)
        assert len(decl.split(",")) == len(argtypes), name


@pytest.mark.parametrize("rows,tile,cluster,clusters,expect", [
    (4096, 64, 2, 66, (64, 128)),      # 64 groups of 64 envs, one per cluster
    (4097, 64, 2, 66, (65, 130)),      # a last group of one env
    (1000, 64, 2, 66, (16, 32)),       # 15 full groups and one of 40
    (98328, 64, 2, 66, (1537, 132)),   # K8's rows: more tiles than clusters
    (4096, 32, 4, 30, (128, 120)),     # the f32 geometry
    (1, 64, 2, 66, (1, 2)),
])
def test_critic_grid(rows, tile, cluster, clusters, expect):
    """K2's and K8's launch size: one unit (group of envs, or tile of rows)
    per cluster at a time, never more clusters than units, whole clusters."""
    units, blocks = update_kernel.critic_grid(rows, tile, cluster, clusters)
    assert (units, blocks) == expect
    assert blocks % cluster == 0 and units * tile >= rows > (units - 1) * tile


@pytest.mark.parametrize("planes,most,expect", [
    (25, 235, (25, 0)),       # the main path's horizon: all in shared memory
    (235, 235, (235, 0)),     # the most shared memory holds
    (236, 235, (235, 1)),     # one plane past it spills
    (470, 235, (235, 235)),
    (2, 1210, (2, 0)),
])
def test_k2_planes_cover_every_plane_once(planes, most, expect):
    """K2's planes of values: those in shared memory first, the rest in the
    spill, each plane in exactly one of the two."""
    kept, spilled = update_kernel.k2_planes(planes, most)
    assert (kept, spilled) == expect
    assert kept + spilled == planes and kept <= most and spilled >= 0


def rel_err(a, b):
    return float((a - b).norm() / b.norm())


# bf16: the kernel and the plain version round to bf16 at the same places and
# sum f32 in another order, which lands some values one bf16 ulp apart
TOL = {"f32": dict(val=2e-4, grad=1e-4, stat=1e-4), "bf16": dict(val=2.0 ** -7, grad=2.5 * 2.0 ** -8,
                                                                 stat=1e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("B", [256, 1000])      # 1000: ragged last tiles
def test_gae_kernel_matches_plain_on_card(gpu, dtype, B):
    T = 24
    fused, p, staged, prep, d = update_case(dtype, T, B, gpu)
    *_, rew, done, timeout = d["buf"]
    nonterm, tf = 1.0 - (done | timeout).float(), timeout.float()
    adv, ret, sa, sa2 = fused.gae(staged, prep["obsc"], rew, nonterm, tf, 0.995, 0.95)
    adv_p, ret_p, sa_p, sa2_p = fused.gae_plain(staged, prep["obsc"], rew, nonterm, tf, 0.995, 0.95)
    torch.cuda.synchronize()
    assert fused.gae_launches == 1
    tol = TOL[dtype]["val"]
    assert rel_err(adv, adv_p) <= tol and rel_err(ret, ret_p) <= tol
    torch.testing.assert_close(sa, adv.sum(), rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(sa2, (adv * adv).sum(), rtol=1e-4, atol=1e-2)
    with pytest.raises(ValueError):
        fused.gae(staged, prep["obsc"], rew.double(), nonterm, tf, 0.995, 0.95)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("B", [1000, 4097])      # ragged last groups of envs
def test_gae_kernel_repeats_bitwise_on_card(gpu, dtype, B):
    """The blocks' partial sums are added in block order, not by float
    atomics: two launches on the same data agree bitwise.  The partials are
    poisoned with NaN between the launches, so a partial that the summing
    block reads before its writer has stored it cannot repeat the first
    launch's value."""
    T = 24
    fused, p, staged, prep, d = update_case(dtype, T, B, gpu)
    *_, rew, done, timeout = d["buf"]
    nonterm, tf = 1.0 - (done | timeout).float(), timeout.float()
    out = fused.gae(staged, prep["obsc"], rew, nonterm, tf, 0.995, 0.95)
    fused.k2_scratch(staged.device, 0)["part"].fill_(float("nan"))
    out2 = fused.gae(staged, prep["obsc"], rew, nonterm, tf, 0.995, 0.95)
    ref = fused.gae_plain(staged, prep["obsc"], rew, nonterm, tf, 0.995, 0.95)
    torch.cuda.synchronize()
    assert fused.gae_launches == 2
    assert all(torch.equal(a, b) for a, b in zip(out, out2))
    assert max(rel_err(out2[k], ref[k]) for k in (2, 3)) <= TOL[dtype]["stat"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("planes", ["most", "most+1", "2most"])
def test_gae_kernel_takes_its_most_planes_on_card(gpu, dtype, planes):
    """K2 keeps the values of k2_max_planes planes in shared memory and
    spills the planes past them to a global scratch: at T + 1 = the most
    planes, one past them and twice them it matches the plain version
    (TOL's val on adv and returns, stat on the sums) and a second launch
    repeats the first bitwise; T < 1 raises."""
    B = 100
    fused = update_case(dtype, 1, B, gpu)[0]
    most = fused.info(gpu)["k2_max_planes"]
    T = {"most": most, "most+1": most + 1, "2most": 2 * most}[planes] - 1
    fused, p, staged, prep, d = update_case(dtype, T, B, gpu)
    *_, rew, done, timeout = d["buf"]
    nonterm, tf = 1.0 - (done | timeout).float(), timeout.float()
    out = fused.gae(staged, prep["obsc"], rew, nonterm, tf, 0.995, 0.95)
    fused.k2_scratch(staged.device, 0)["spill"].fill_(float("nan"))
    out2 = fused.gae(staged, prep["obsc"], rew, nonterm, tf, 0.995, 0.95)
    ref = fused.gae_plain(staged, prep["obsc"], rew, nonterm, tf, 0.995, 0.95)
    torch.cuda.synchronize()
    assert fused.gae_launches == 2
    assert all(torch.equal(a, b) for a, b in zip(out, out2))
    tol = TOL[dtype]
    assert rel_err(out[0], ref[0]) <= tol["val"] and rel_err(out[1], ref[1]) <= tol["val"]
    assert max(rel_err(out[k], ref[k]) for k in (2, 3)) <= tol["stat"]
    assert fused.critic_info(gpu, most)["smem"] > fused.critic_info(gpu, 0)["smem"]
    spill = fused.k2_scratch(staged.device, 0)["spill"]
    assert (spill.numel() > 0) == (T + 1 > most)
    with pytest.raises(ValueError):
        fused.gae(staged, prep["obsc"][:1], rew[:0], nonterm[:0], tf[:0], 0.995, 0.95)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("T,B", [(24, 256), (7, 1000)])   # 7000: a ragged last tile
@pytest.mark.parametrize("self_old", [False, True])
def test_grads_stats_kernel_matches_plain_on_card(gpu, dtype, T, B, self_old):
    fused, p, staged, prep, d = update_case(dtype, T, B, gpu)
    mean, rstd = d["adv"].mean(), 1.0 / (d["adv"].std() + 1e-8)
    args = (staged, p, prep, d["adv"], d["ret"], mean, rstd, self_old)
    g, st, mu, logp = fused.grads_stats(*args)
    g2 = fused.grads_stats(*args)[0]
    g_p, st_p, mu_p, logp_p = fused.grads_stats_plain(*args)
    torch.cuda.synchronize()
    assert fused.grads_stats_launches == 2
    assert torch.equal(g, g2)                  # fixed summation order: repeatable
    tol = TOL[dtype]
    assert rel_err(mu, mu_p) <= tol["val"] and rel_err(logp, logp_p) <= 10 * tol["val"]
    for net in ("actor", "critic"):
        for w, b, o, i in fused.layers[net]:
            assert rel_err(g[w:w + o * i], g_p[w:w + o * i]) <= tol["grad"], (net, o, i)
            assert rel_err(g[b:b + o], g_p[b:b + o]) <= tol["grad"], (net, o, "bias")
    assert rel_err(g[fused.logstd_slice], g_p[fused.logstd_slice]) <= 10 * tol["grad"]
    for k in ("vl", "bhi", "blo"):
        torch.testing.assert_close(st[k], st_p[k], rtol=tol["stat"], atol=1e-6)
    # the actor-loss sum cancels: held to a share of sum |terms|
    torch.testing.assert_close(st["al"], st_p["al"], rtol=tol["stat"],
                               atol=1e-2 * tol["stat"] * T * B)
    if self_old:
        assert float(st["klsq"].abs().max()) == 0.0
    else:
        torch.testing.assert_close(st["klsq"], st_p["klsq"], rtol=10 * tol["stat"], atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_opt_stage_kernel_matches_plain_on_card(gpu, dtype):
    fused, p, staged, prep, d = update_case(dtype, 2, 8, gpu)
    gen = torch.Generator(device=gpu).manual_seed(5)
    rand = lambda scale: scale * torch.randn(p.shape, generator=gen, device=gpu)
    g, m, v = rand(0.3), rand(1e-2), rand(1e-3).abs()
    lr = torch.tensor(1e-3, device=gpu)
    kw = dict(entropy_coef=-0.01, b1=0.9, b2=0.999, eps=1e-8, max_norm=1.0)
    out = fused.opt_stage(g, p, m, v, 7, lr, **kw)
    out2 = fused.opt_stage(g, p, m, v, 7, lr, **kw)
    ref = fused.opt_stage_plain(g, p, m, v, 7, lr, **kw)
    torch.cuda.synchronize()
    assert fused.opt_stage_launches == 2
    for a, a2, b in zip(out[:3], out2[:3], ref[:3]):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert torch.equal(out[3], out[0].to(fused.dtype))   # staged: the cast, bitwise
    # one device kernel per call, and nothing else on the stream
    kernels = device_kernels(lambda: fused.opt_stage(g, p, m, v, 7, lr, **kw))
    assert len(kernels) == 1 and "k4_opt" in next(iter(kernels))
    assert per_call(next(iter(kernels.values()))[0]) == 1
    with pytest.raises(ValueError):
        fused.opt_stage(g[:-1], p, m, v, 7, lr, **kw)
    with pytest.raises(ValueError):   # K4 loads 16 bytes at a time
        fused.opt_stage(torch.empty(fused.n_params + 1, device=gpu)[1:], p, m, v, 7, lr, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_opt_stage_kernel_runs_in_a_cuda_graph(gpu, dtype):
    """K4 launches on the caller's stream with no host sync: captured in a
    CUDA graph and replayed, it gives the eager call's outputs bitwise."""
    fused, p, staged, prep, d = update_case(dtype, 2, 8, gpu)
    gen = torch.Generator(device=gpu).manual_seed(6)
    rand = lambda scale: scale * torch.randn(p.shape, generator=gen, device=gpu)
    g, m, v = rand(0.3), rand(1e-2), rand(1e-3).abs()
    lr = torch.tensor(1e-3, device=gpu)
    kw = dict(entropy_coef=-0.01, b1=0.9, b2=0.999, eps=1e-8, max_norm=1.0)
    eager = fused.opt_stage(g, p, m, v, 3, lr, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused.opt_stage(g, p, m, v, 3, lr, **kw)   # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused.opt_stage(g, p, m, v, 3, lr, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))


# ---------------------------------------------------------------------------
# K8-K10
def test_anchor_wrappers_run_the_plain_versions_on_the_cpu():
    T, B = 3, 16
    fused, p, d = anchor_case(seeded_network("bf16", "cpu", 0), T, B, "cpu")
    obs, priv = d["obs"], d["priv"]
    v = fused.values(p, obs, priv)
    assert v.shape == (T, B) and torch.equal(v, fused.values_plain(p, obs, priv))
    assert torch.equal(fused.values(p, obs[1], priv[1]), v[1])     # a [B, dim] input
    args = (p, obs, priv, d["act"], d["adv"], d["ret"], d["old_logp"])
    out, ref = fused.grads(*args), fused.grads_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    g, mu, val = out
    assert g.shape == (fused.n_params,) and mu.shape == (T, B, 12) and val.shape == (T, B)
    # mu and the values come back rounded to the compute type
    assert torch.equal(mu, mu.bfloat16().float()) and torch.equal(val, v)
    prep = fused.prepare(obs, priv, d["act"], mu, d["old_logp"])    # no obs_last
    assert prep["obsc"].shape == (T, B, 61)
    out, ref = fused.policy_old_logp(p, prep), fused.policy_old_logp_plain(p, prep)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert out[0].shape == (T * B, 12) and out[1].shape == (T * B,)
    assert (fused.values_launches, fused.grads_launches, fused.policy_logp_launches) == (0, 0, 0)


def anchor(dtype, T, B, device):
    return anchor_case(seeded_network(dtype, device, B), T, B, device, seed=B)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("B", [256, 1000])
def test_values_kernel_matches_plain_on_card(gpu, dtype, B):
    fused, p, d = anchor(dtype, 24, B, gpu)
    v = fused.values(p, d["obs"], d["priv"])
    v_row = fused.values(p, d["obs"][3], d["priv"][3])
    v_p = fused.values_plain(p, d["obs"], d["priv"])
    torch.cuda.synchronize()
    assert fused.values_launches == 2
    assert rel_err(v, v_p) <= TOL[dtype]["val"]
    assert torch.equal(v_row, v[3])             # rows are computed independently
    with pytest.raises(ValueError):
        fused.values(p.double(), d["obs"], d["priv"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("T,B", [(24, 256), (7, 1000)])   # 7000: a ragged last tile
def test_grads_kernel_matches_plain_on_card(gpu, dtype, T, B):
    fused, p, d = anchor(dtype, T, B, gpu)
    args = (p, d["obs"], d["priv"], d["act"], d["adv"], d["ret"], d["old_logp"])
    g, mu, val = fused.grads(*args)
    g2, mu2, val2 = fused.grads(*args)
    g3 = fused.grads(*args, n_total=3 * T * B)[0]
    g_p, mu_p, val_p = fused.grads_plain(*args)
    g3_p = fused.grads_plain(*args, n_total=3 * T * B)[0]
    torch.cuda.synchronize()
    assert fused.grads_launches == 3
    assert torch.equal(g, g2) and torch.equal(mu, mu2) and torch.equal(val, val2)
    tol = TOL[dtype]
    assert rel_err(mu, mu_p) <= tol["val"] and rel_err(val, val_p) <= tol["val"]
    for net in ("actor", "critic"):
        for w, b, o, i in fused.layers[net]:
            assert rel_err(g[w:w + o * i], g_p[w:w + o * i]) <= tol["grad"], (net, o, i)
            assert rel_err(g[b:b + o], g_p[b:b + o]) <= tol["grad"], (net, o, "bias")
    assert rel_err(g[fused.logstd_slice], g_p[fused.logstd_slice]) <= 10 * tol["grad"]
    # n_total divides every loss mean: a third of the gradient, to rounding
    assert rel_err(g3, g3_p) <= tol["grad"] and rel_err(3 * g3, g) <= tol["grad"]
    with pytest.raises(ValueError):
        fused.grads(p, d["obs"], d["priv"], d["act"], d["adv"][:-1], d["ret"], d["old_logp"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("B", [256, 1000])
def test_policy_logp_kernel_matches_plain_on_card(gpu, dtype, B):
    fused, p, d = anchor(dtype, 24, B, gpu)
    prep = fused.prepare(d["obs"], d["priv"], d["act"], torch.zeros_like(d["act"]),
                         d["old_logp"])
    mu, logp = fused.policy_old_logp(p, prep)
    mu_p, logp_p = fused.policy_old_logp_plain(p, prep)
    torch.cuda.synchronize()
    assert fused.policy_logp_launches == 1
    tol = TOL[dtype]["val"]
    assert rel_err(mu, mu_p) <= tol and rel_err(logp, logp_p) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_values_kernel_equals_k2_and_k9_values_on_card(gpu, dtype):
    """K8 on rows that fill no whole tile (24 x 4097) against K2's value pass
    (its advantage at zero reward, nonterm and timeout is -value) and K9's
    values: one device code, so bitwise."""
    T, B = 24, 4097
    fused, p, d = anchor(dtype, T, B, gpu)
    assert (T * B) % fused.info(gpu)["k2_tile"] != 0
    gen = torch.Generator(device=gpu).manual_seed(4)
    obs_last, priv_last = torch.randn(B, 47, generator=gen, device=gpu), torch.randn(
        B, 14, generator=gen, device=gpu)
    prep = fused.prepare(d["obs"], d["priv"], d["act"], torch.zeros_like(d["act"]),
                         d["old_logp"], obs_last, priv_last)
    v8 = fused.values(p, d["obs"], d["priv"])
    v8_last = fused.values(p, obs_last, priv_last)
    zeros = torch.zeros(T, B, device=gpu)
    adv2 = fused.gae(fused.stage(p), prep["obsc"], zeros, zeros, zeros, 0.995, 0.95)[0]
    val9 = fused.grads(p, d["obs"], d["priv"], d["act"], d["adv"], d["ret"], d["old_logp"])[2]
    torch.cuda.synchronize()
    assert torch.equal(-adv2, v8) and torch.equal(val9, v8)
    assert torch.isfinite(v8_last).all() and v8_last.shape == (B,)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_anchor_kernels_agree_with_k2_and_k3_on_card(gpu, dtype):
    """Independently launched kernels on the same data: K9 on normalised
    advantages against K3, K8 against K2's value pass (read off its advantage
    at zero reward and nonterm) and K9's values, K10
    against K3's self_old forward, each bitwise (one device code)."""
    T, B = 24, 1000
    fused, p, d = anchor(dtype, T, B, gpu)
    gen = torch.Generator(device=gpu).manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=gen, device=gpu)
    prep = fused.prepare(d["obs"], d["priv"], d["act"], torch.zeros_like(d["act"]),
                         d["old_logp"], rnd(B, 47), rnd(B, 14))
    staged = fused.stage(p)
    mean, rstd = d["adv"].mean(), 1.0 / (d["adv"].std() + 1e-8)
    g9, mu9, val9 = fused.grads(p, d["obs"], d["priv"], d["act"], (d["adv"] - mean) * rstd,
                                d["ret"], d["old_logp"])
    g3, _, mu3, _ = fused.grads_stats(staged, p, prep, d["adv"], d["ret"], mean, rstd, False)
    v8 = fused.values(p, d["obs"], d["priv"])
    # with no reward, no continuation and no timeout K2's advantage is -value
    zeros = torch.zeros(T, B, device=gpu)
    adv2 = fused.gae(staged, prep["obsc"], zeros, zeros, zeros, 0.995, 0.95)[0]
    _, _, mu_self, logp_self = fused.grads_stats(staged, p, prep, d["adv"], d["ret"], mean,
                                                 rstd, True)
    mu10, logp10 = fused.policy_old_logp(p, prep)
    torch.cuda.synchronize()
    assert torch.equal(g9, g3)
    assert torch.equal(mu9.view(-1, 12), mu3.to(fused.dtype).float())
    assert torch.equal(val9, v8) and torch.equal(-adv2, v8)
    assert torch.equal(mu10, mu_self) and torch.equal(logp10, logp_self)
