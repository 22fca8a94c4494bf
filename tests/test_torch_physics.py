"""The port's plain substep (booster_gym_torch/physics/engine.py) against
the JAX package.

Toy robot: against the JAX Pallas substep kernel run in interpret mode
through jit_nofusion, as tests/test_pallas_small.py builds it.  T1-shaped
robot: against the JAX XLA-op engine (the Pallas kernel at T1 scale is
never compiled on the CPU).  Tolerances are those of the JAX package's own
kernel-vs-engine tests: rtol = atol = 2e-3 on the state, rtol 5e-2 /
atol 1.0 N on the per-body contact forces.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from booster_gym_tpu.model import load_urdf as jax_load_urdf
from booster_gym_tpu.physics import DynParams as JDyn, SimConfig as JCfg, SimState as JState
from booster_gym_tpu.physics.engine import make_substep as jax_make_substep
from booster_gym_tpu.physics.pallas_engine import make_substep_pallas
from booster_gym_tpu.terrain import Terrain as JTerrain
from booster_gym_tpu.utils.compile import jit_nofusion

from booster_gym_torch.physics import DynParams, SimConfig, SimState
from booster_gym_torch.physics.engine import make_substep
from booster_gym_torch.physics.linalg import spd_inverse
from booster_gym_torch.testing import point_terrain_inputs, toy_model, write_t1_shaped_urdf

STATE_TOL = 2e-3
FIELDS = SimState.FIELDS


def rand_inputs(model, B, seed=0):
    """Random states as the JAX package's _rand_inputs makes them, as numpy."""
    rng = np.random.default_rng(seed)
    nd, ns = model.num_dofs, len(model.shape_body)
    quat = rng.normal(size=(B, 4)).astype(np.float32)
    quat[: B // 2] = np.array([1, 0, 0, 0], np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    pos = np.zeros((B, 3), np.float32)
    pos[:, 2] = rng.uniform(0.2, 0.8, B)
    f32 = lambda x: np.asarray(x, np.float32)
    state = dict(root_pos=pos, root_quat=quat,
                 root_lin_vel=f32(rng.uniform(-1, 1, (B, 3))),
                 root_ang_vel=f32(rng.uniform(-1, 1, (B, 3))),
                 q=f32(rng.uniform(-1, 1, (B, nd))),
                 qd=f32(rng.uniform(-2, 2, (B, nd))))
    dyn = dict(body_mass=f32(np.tile(model.body_mass, (B, 1))),
               body_com=f32(np.tile(model.body_com, (B, 1, 1))),
               body_inertia=f32(np.tile(model.body_inertia, (B, 1, 1, 1))),
               shape_friction=f32(rng.uniform(0.5, 1.5, (B, ns))),
               shape_restitution=f32(rng.uniform(0.0, 0.5, (B, ns))))
    tau = f32(rng.uniform(-5, 5, (B, nd)))
    ef = f32(rng.uniform(-2, 2, (B, 3)))
    et = f32(rng.uniform(-0.5, 0.5, (B, 3)))
    return state, dyn, tau, ef, et


def to_jax(state, dyn, tau, ef, et):
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    return (JState(**j(state)), JDyn(**j(dyn)), jnp.asarray(tau), jnp.asarray(ef),
            jnp.asarray(et))


def to_torch(state, dyn, tau, ef, et):
    t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
    return (SimState(**t(state)), DynParams(**t(dyn)), torch.as_tensor(tau),
            torch.as_tensor(ef), torch.as_tensor(et))


def assert_step_close(out_t, out_j, tol=STATE_TOL, forces=True):
    s_t, f_t, fp_t, fR_t = out_t
    s_j, f_j, fp_j, fR_j = out_j
    for name in FIELDS:
        np.testing.assert_allclose(getattr(s_t, name).numpy(),
                                   np.asarray(getattr(s_j, name)),
                                   rtol=tol, atol=tol, err_msg=name)
    if forces:
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=5e-2, atol=1.0)
    np.testing.assert_allclose(fp_t.numpy(), np.asarray(fp_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(fR_t.numpy(), np.asarray(fR_j), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def toy():
    model = toy_model()
    feet = [i for i, n in enumerate(model.body_names) if "foot" in n]
    pallas = jit_nofusion(make_substep_pallas(model, JCfg(), feet_indices=feet,
                                              interpret=True, plane=True))
    return model, pallas, make_substep(model, SimConfig(), feet, "cpu")


@pytest.fixture(scope="module")
def t1(tmp_path_factory):
    path = write_t1_shaped_urdf(tmp_path_factory.mktemp("urdf"))
    model = jax_load_urdf(path, cylinder_rim_points=4)
    feet = [model.body_names.index("left_foot_link"),
            model.body_names.index("right_foot_link")]
    terrain = JTerrain({"type": "plane", "static_friction": 1.0, "restitution": 0.0})
    xla = jax.jit(jax_make_substep(model, JCfg(), terrain, feet_indices=feet))
    return model, xla, make_substep(model, SimConfig(), feet, "cpu")


@pytest.mark.parametrize("B", [100, 1024])
def test_toy_matches_pallas_interpret(toy, B):
    model, pallas, step = toy
    inputs = rand_inputs(model, B, seed=B)
    assert_step_close(step(*to_torch(*inputs)), pallas(*to_jax(*inputs)))


def test_toy_consecutive_substeps(toy):
    """Ten substeps fed back into themselves on both sides: drift stays
    inside the single-step tolerance."""
    model, pallas, step = toy
    state, dyn, tau, ef, et = rand_inputs(model, 64, seed=7)
    j_in, t_in = to_jax(state, dyn, tau, ef, et), to_torch(state, dyn, tau, ef, et)
    sj, st = j_in[0], t_in[0]
    for _ in range(10):
        out_j = pallas(sj, *j_in[1:])
        out_t = step(st, *t_in[1:])
        sj, st = out_j[0], out_t[0]
    assert_step_close(out_t, out_j, forces=False)


def test_t1_shaped_matches_xla_engine(t1):
    model, xla, step = t1
    inputs = rand_inputs(model, 64, seed=3)
    assert_step_close(step(*to_torch(*inputs)), xla(*to_jax(*inputs)))


def test_t1_shaped_consecutive_substeps(t1):
    """Standing T1-shaped robots (feet on the ground, the bodies the
    contact solve works hardest on) over ten substeps."""
    model, xla, step = t1
    B = 64
    state, dyn, tau, ef, et = rand_inputs(model, B, seed=11)
    rng = np.random.default_rng(12)
    state["root_pos"][:, 2] = 0.72
    state["root_quat"][:] = np.array([1, 0, 0, 0], np.float32)
    q0 = np.array([-0.2, 0, 0, 0.4, -0.25, 0] * 2, np.float32)
    state["q"] = (q0 + rng.normal(0, 0.05, (B, 12))).astype(np.float32)
    state["qd"] = rng.normal(0, 0.2, (B, 12)).astype(np.float32)
    state["root_lin_vel"] *= 0.2
    state["root_ang_vel"] *= 0.2
    j_in, t_in = to_jax(state, dyn, tau, ef, et), to_torch(state, dyn, tau, ef, et)
    sj, st = j_in[0], t_in[0]
    for _ in range(10):
        out_j = xla(sj, *j_in[1:])
        out_t = step(st, *t_in[1:])
        sj, st = out_j[0], out_t[0]
    assert float(out_t[1][:, [6, 12], 2].abs().max()) > 1.0   # feet in contact
    assert_step_close(out_t, out_j)


def test_spd_inverse():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(8, 18, 18))
    M = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(18)
    got = spd_inverse(torch.as_tensor(M, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(got, np.linalg.inv(M), rtol=1e-8, atol=1e-8)


# ---------------------------------------------------------------------------
# K5's plain version: the substep with a terrain height and a unit normal per
# contact point as inputs
def terrain_inputs(model, B, seed):
    return point_terrain_inputs(model.num_points, B, seed)


@pytest.fixture(scope="module")
def toy_general():
    model = toy_model()
    feet = [i for i, n in enumerate(model.body_names) if "foot" in n]
    raw = make_substep_pallas(model, JCfg(), feet_indices=feet, interpret=True, plane=False)
    return model, jit_nofusion(raw.terrain_form), make_substep(model, SimConfig(), feet, "cpu")


@pytest.mark.parametrize("B", [100, 1024])
def test_toy_terrain_form_matches_pallas_interpret(toy_general, B):
    """State rtol = atol = 2e-3, forces rtol 5e-2 / atol 1 N (the plane
    test's tolerances), contact-point xy atol 1e-5 (FK in f32 on both
    sides)."""
    model, pallas_terrain, step = toy_general
    inputs = rand_inputs(model, B, seed=B + 1)
    h, n = terrain_inputs(model, B, seed=B + 2)
    out_j = pallas_terrain(*to_jax(*inputs), jnp.asarray(h), jnp.asarray(n))
    out_t = step.terrain_form(*to_torch(*inputs), torch.as_tensor(h), torch.as_tensor(n))
    assert_step_close(out_t[:4], out_j[:4])
    assert out_t[4].shape == (B, model.num_points, 2)
    np.testing.assert_allclose(out_t[4].numpy(), np.asarray(out_j[4]), atol=1e-5)
    # the tilt matters: the same state on the plane moves differently
    flat = step(*to_torch(*inputs))
    assert float((flat[0].qd - out_t[0].qd).abs().max()) > 1e-2


def test_terrain_form_on_plane_inputs_is_the_plane_form_bitwise(toy_general):
    model, _, step = toy_general
    B = 64
    args = to_torch(*rand_inputs(model, B, seed=4))
    h = torch.zeros(B, model.num_points)
    n = torch.zeros(B, model.num_points, 3)
    n[..., 2] = 1.0
    out_g, out_p = step.terrain_form(*args, h, n), step(*args)
    for name in FIELDS:
        assert torch.equal(getattr(out_g[0], name), getattr(out_p[0], name)), name
    for a, b in zip(out_g[1:4], out_p[1:]):
        assert torch.equal(a, b)


def test_terrain_form_on_a_plane_build_raises(toy_general):
    from booster_gym_torch.physics.substep_kernel import SubstepKernel

    model = toy_general[0]
    feet = [2]
    args = to_torch(*rand_inputs(model, 4, seed=5))
    h, n = (torch.as_tensor(x) for x in terrain_inputs(model, 4, seed=6))
    plane = SubstepKernel(model, SimConfig(), feet, "cpu", plane=True)
    assert plane.plane
    with pytest.raises(ValueError, match="plane"):
        plane.terrain_form(*args, h, n)
    with pytest.raises(ValueError, match="plane"):
        plane.packed_call(plane.pack_sim(args[0]), plane.pack_dyn(args[1]), args[2].T,
                          torch.zeros(6, 4), h.T, n.reshape(4, -1).T)
    general = SubstepKernel(model, SimConfig(), feet, "cpu", plane=False)
    assert not general.plane
    with pytest.raises(ValueError, match="plane"):
        general.packed_call(general.pack_sim(args[0]), general.pack_dyn(args[1]), args[2].T,
                            torch.zeros(6, 4))
    # on the CPU the general wrapper is the plain terrain form exactly
    out_k = general.terrain_form(*args, h, n)
    out_p = make_substep(model, SimConfig(), feet, "cpu").terrain_form(*args, h, n)
    for name in FIELDS:
        assert torch.equal(getattr(out_k[0], name), getattr(out_p[0], name)), name
    for a, b in zip(out_k[1:], out_p[1:]):
        assert torch.equal(a, b)
    assert general.launches == 0


def test_t1_shaped_on_trimesh_matches_xla_engine(tmp_path):
    """The eager engine that queries the terrain inside the substep, on the
    T1-shaped robot standing on a small heightfield, against the JAX xla
    engine on the same field: state 2e-3, forces 5e-2 / 1 N."""
    from booster_gym_torch.model import load_urdf
    from booster_gym_torch.terrain import Terrain

    path = write_t1_shaped_urdf(tmp_path)
    block = {"type": "trimesh", "static_friction": 1.0, "restitution": 0.0,
             "terrain_length": 4.0, "terrain_width": 4.0, "border_size": 2.0, "num_terrains": 2,
             "terrain_proportions": [0.0, 0.0, 0.5, 0.5], "slope": 0.1, "random_height": 0.1,
             "discrete_height": 0.02, "horizontal_scale": 0.1, "vertical_scale": 0.005}
    jmodel = jax_load_urdf(path, cylinder_rim_points=4)
    feet = [jmodel.body_names.index("left_foot_link"), jmodel.body_names.index("right_foot_link")]
    xla = jax.jit(jax_make_substep(jmodel, JCfg(), JTerrain(block, seed=1), feet_indices=feet))
    step = make_substep(load_urdf(path, cylinder_rim_points=4), SimConfig(), feet, "cpu",
                        terrain=Terrain(block, seed=1))
    B = 64
    state, dyn, tau, ef, et = rand_inputs(jmodel, B, seed=21)
    rng = np.random.default_rng(22)
    state["root_pos"][:, :2] = rng.uniform(0.5, 3.5, (B, 2))      # on the random tile
    state["root_pos"][:, 2] = 0.72
    state["root_quat"][:] = np.array([1, 0, 0, 0], np.float32)
    state["q"] = (np.array([-0.2, 0, 0, 0.4, -0.25, 0] * 2) + rng.normal(0, 0.05, (B, 12))
                  ).astype(np.float32)
    state["qd"] = rng.normal(0, 0.2, (B, 12)).astype(np.float32)
    inputs = (state, dyn, tau, ef, et)
    out_t, out_j = step(*to_torch(*inputs)), xla(*to_jax(*inputs))
    assert float(out_t[1][:, [6, 12], 2].abs().max()) > 1.0   # feet in contact
    assert_step_close(out_t, out_j)
