"""K1's wrapper (booster_gym_torch/physics/substep_kernel.py).

The CUDA kernel itself runs only on a card: the tests marked `cuda` hold
it against its plain version there and skip without one (chip_smoke.py
runs the same check).  The rest run here: the component-major layout, the
model table against the offsets csrc/substep.cu declares, and the CPU
path, which must be the plain version exactly and count no launch.
"""

import re

import numpy as np
import pytest
import torch

from booster_gym_torch.model import load_urdf
from booster_gym_torch.physics import DynParams, SimConfig, SimState
from booster_gym_torch.physics import substep_kernel as sk
from booster_gym_torch.physics.engine import make_substep
from booster_gym_torch.testing import toy_model, write_t1_shaped_urdf


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


def test_library_name_carries_sizes_and_source_hash(robot):
    model, feet = robot
    path = sk.library_path(sk.kernel_sizes(model, feet))
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
