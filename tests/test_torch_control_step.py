"""SubstepKernel.control_step, the env's decimation loop in one call
(booster_gym_torch/physics/substep_kernel.py): on the GPU one launch of K1
or K5, here on the CPU its plain version.

The plain version must be the loop the env ran before the loop moved into
the kernel, bitwise (copied below as `env_loop`), and must match the JAX
package's decimation loop: on the toy robot the JAX env's own packed loop
(`_packed_inner`) around its Pallas kernel in interpret mode, on the
T1-shaped robot the JAX env's engine loop around the XLA engine (the
T1-scale Pallas kernel is never compiled on the CPU).  Tolerances are
tests/test_torch_physics.py's for several substeps: rtol = atol = 2e-3 on
the state, the feet and the torques, rtol 5e-2 / atol 1 N on the contact
forces.  The kernel itself is checked on the card by the `cuda` tests of
tests/test_torch_kernel.py and by chip_smoke.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from booster_gym_tpu.envs.t1 import T1 as JaxT1
from booster_gym_tpu.model import load_urdf as jax_load_urdf
from booster_gym_tpu.physics import DynParams as JDyn, SimConfig as JCfg, SimState as JState
from booster_gym_tpu.physics.engine import make_substep as jax_make_substep
from booster_gym_tpu.physics.pallas_engine import make_substep_pallas
from booster_gym_tpu.terrain import Terrain as JTerrain
from booster_gym_tpu.terrain.sample_kernel import build_shift_table
from booster_gym_tpu.terrain.sample_kernel import make_terrain_sampler as jax_make_sampler
from booster_gym_tpu.utils.compile import jit_nofusion

from booster_gym_torch import kernel_build
from booster_gym_torch.model import load_urdf
from booster_gym_torch.physics import DynParams, SimConfig, SimState
from booster_gym_torch.physics import substep_kernel as sk
from booster_gym_torch.terrain import Terrain
from booster_gym_torch.terrain.sample_kernel import TerrainSampler
from booster_gym_torch.testing import point_terrain_inputs, toy_model, write_t1_shaped_urdf
from booster_gym_torch.utils.config import load_task_cfg

TOL = 2e-3
DECIMATION = 10


@pytest.fixture(scope="module", params=["toy", "t1"])
def robot(request, tmp_path_factory):
    if request.param == "toy":
        return "toy", toy_model(), None
    path = write_t1_shaped_urdf(tmp_path_factory.mktemp("u"))
    return "t1", load_urdf(path, cylinder_rim_points=4), path


def feet_of(model):
    return [i for i, n in enumerate(model.body_names) if "foot" in n]


def control_inputs(model, B, seed, delay="spread"):
    """One control step's inputs as numpy: a state (the T1-shaped robot
    standing), dyn, PD targets and latched targets near q, gains, joint
    friction, torque limits, delays (spread over 0..9, or all one value) and
    a push."""
    rng = np.random.default_rng(seed)
    nd, nb, ns = model.num_dofs, model.num_bodies, len(model.shape_body)
    f32 = lambda x: np.asarray(x, np.float32)
    quat = np.tile([1.0, 0, 0, 0], (B, 1)) + rng.normal(0, 0.05, (B, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    if nb > 3:
        pos = np.tile([0.0, 0.0, 0.72], (B, 1))
        q = np.array([-0.2, 0, 0, 0.4, -0.25, 0] * 2) + rng.normal(0, 0.05, (B, nd))
    else:
        pos = np.tile([0.0, 0.0, 0.5], (B, 1))
        q = rng.uniform(-1, 1, (B, nd))
    state = dict(root_pos=f32(pos), root_quat=f32(quat),
                 root_lin_vel=f32(rng.uniform(-0.3, 0.3, (B, 3))),
                 root_ang_vel=f32(rng.uniform(-0.3, 0.3, (B, 3))),
                 q=f32(q), qd=f32(rng.normal(0, 0.3, (B, nd))))
    dyn = dict(body_mass=f32(np.tile(model.body_mass, (B, 1))),
               body_com=f32(np.tile(model.body_com, (B, 1, 1))),
               body_inertia=f32(np.tile(model.body_inertia, (B, 1, 1, 1))),
               shape_friction=f32(rng.uniform(0.5, 1.5, (B, ns))),
               shape_restitution=f32(rng.uniform(0.0, 0.5, (B, ns))))
    delays = np.arange(B) % DECIMATION if delay == "spread" else np.full(B, delay)
    ctrl = dict(targets=f32(q + rng.normal(0, 0.1, (B, nd))),
                last=f32(q + rng.normal(0, 0.05, (B, nd))),
                delay=delays.astype(np.int64),
                kp=f32(rng.uniform(20, 80, (B, nd))), kd=f32(rng.uniform(0.5, 3, (B, nd))),
                fric=f32(rng.uniform(0, 1, (B, nd))), lim=f32(model.dof_effort),
                push_f=f32(rng.uniform(-20, 20, (B, 3))), push_t=f32(rng.uniform(-2, 2, (B, 3))))
    return state, dyn, ctrl


def to_torch(state, dyn, ctrl):
    t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
    return SimState(**t(state)), DynParams(**t(dyn)), t(ctrl)


def terrain(model, B, plane, seed):
    if plane:
        return None, None
    h, n = point_terrain_inputs(model.num_points, B, seed)
    return h, n


def env_loop(sub, psim, pdyn, dof_targets, last_dof_targets, delay_steps, kp, kd, fric_lim,
             torque_limits, push_f_w, push_t_w, ph, pn, decimation):
    """The env's decimation loop as it stood before it moved into the
    kernel (envs/t1.py::_physics_inner_loop), around packed_call."""
    nd = sub.nd
    p_targets = dof_targets.T
    p_last = last_dof_targets.T
    kp, kd, fric_lim = kp.T, kd.T, fric_lim.T
    p_ext = torch.cat([push_f_w, push_t_w], dim=-1).T.contiguous()
    p_ext0 = torch.zeros_like(p_ext)
    lim = torque_limits[:, None]
    p_tsum = torch.zeros_like(p_targets)
    for i in range(decimation):
        latch = (delay_steps == i)[None, :]
        p_last = torch.where(latch, p_targets, p_last)
        pd = kp * (p_last - psim[13:13 + nd]) - kd * psim[13 + nd:13 + 2 * nd]
        fric = torch.minimum(torch.abs(pd), fric_lim) * torch.sign(pd)
        p_tau = torch.minimum(torch.maximum(pd - fric, -lim), lim).contiguous()
        psim, pforces, pfeet, pptxy = sub.packed_call(
            psim, pdyn, p_tau, p_ext if i == 0 else p_ext0, ph, pn)
        p_tsum = p_tsum + p_tau
    return psim, p_last.T, p_tsum.T, pforces, pfeet, pptxy


def run_control_step(sub, state, dyn, c, ph, pn):
    B = state.q.shape[0]
    ph_p = None if ph is None else torch.as_tensor(ph).T.contiguous()
    pn_p = None if pn is None else torch.as_tensor(pn).reshape(B, -1).T.contiguous()
    return sub.control_step(
        sub.pack_sim(state), sub.pack_dyn(dyn), c["targets"], c["last"], c["delay"], c["kp"],
        c["kd"], c["fric"], c["lim"], torch.cat([c["push_f"], c["push_t"]], dim=-1), ph_p, pn_p,
        decimation=DECIMATION), ph_p, pn_p


@pytest.mark.parametrize("plane", [True, False], ids=["plane", "trimesh"])
@pytest.mark.parametrize("delay", ["spread", 0, 9])
def test_plain_control_step_is_the_env_loop_bitwise(robot, plane, delay):
    name, model, _ = robot
    B = 20
    sub = sk.SubstepKernel(model, SimConfig(), feet_of(model), "cpu", plane=plane)
    state, dyn, c = to_torch(*control_inputs(model, B, seed=B, delay=delay))
    h, n = terrain(model, B, plane, seed=3)
    out, ph, pn = run_control_step(sub, state, dyn, c, h, n)
    ref = env_loop(sub, sub.pack_sim(state), sub.pack_dyn(dyn), c["targets"], c["last"],
                   c["delay"], c["kp"], c["kd"], c["fric"], c["lim"], c["push_f"],
                   c["push_t"], ph, pn, DECIMATION)
    for a, b in zip(out, ref):
        if b is None:
            assert a is None and plane
        else:
            assert torch.equal(a, b)
    assert sub.launches == 0
    assert out[1].shape == (B, model.num_dofs) and out[2].shape == (B, model.num_dofs)
    # the delay latch: from substep `delay` on, the new targets act
    if delay != "spread":
        assert torch.equal(out[1], c["targets"])


def jax_toy_loop(model, plane, state, dyn, c, h, n):
    """The JAX env's packed decimation loop (booster_gym_tpu/envs/t1.py::
    _packed_inner) around the toy robot's Pallas kernel in interpret mode."""
    feet = feet_of(model)
    sub = make_substep_pallas(model, JCfg(), feet_indices=feet, interpret=True, plane=plane)
    env = types.SimpleNamespace(substep=sub, model=model, decimation=DECIMATION,
                                feet_indices=feet, torque_limits=jnp.asarray(c["lim"]))
    fn = jit_nofusion(lambda *a: JaxT1._packed_inner(env, *a))
    B = state["q"].shape[0]
    ph = np.zeros((B, model.num_points), np.float32) if h is None else h
    pn = np.zeros((B, model.num_points, 3), np.float32) if n is None else n
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    return fn(JState(**j(state)), JDyn(**j(dyn)), c["kp"], c["kd"], c["fric"],
              jnp.asarray(c["delay"].astype(np.int32)), c["targets"], c["last"],
              c["push_f"], c["push_t"], ph, pn)


def jax_engine_loop(model, state, dyn, c):
    """The JAX env's decimation loop on its XLA engine (the non-Pallas
    branch of booster_gym_tpu/envs/t1.py::step), plane terrain."""
    flat = JTerrain({"type": "plane", "static_friction": 1.0, "restitution": 0.0})
    step = jax.jit(jax_make_substep(model, JCfg(), flat, feet_indices=feet_of(model)))
    sim = JState(**{k: jnp.asarray(v) for k, v in state.items()})
    jdyn = JDyn(**{k: jnp.asarray(v) for k, v in dyn.items()})
    last, tsum = jnp.asarray(c["last"]), jnp.zeros_like(jnp.asarray(c["last"]))
    zeros3 = jnp.zeros_like(jnp.asarray(c["push_f"]))
    for i in range(DECIMATION):
        last = jnp.where((jnp.asarray(c["delay"]) == i)[:, None], c["targets"], last)
        pd = c["kp"] * (last - sim.q) - c["kd"] * sim.qd
        fric = jnp.minimum(jnp.abs(pd), c["fric"]) * jnp.sign(pd)
        tau = jnp.clip(pd - fric, -c["lim"], c["lim"])
        sim, forces, feet_pos, feet_R = step(sim, jdyn, tau, c["push_f"] if i == 0 else zeros3,
                                             c["push_t"] if i == 0 else zeros3)
        tsum = tsum + tau
    return sim, last, tsum / DECIMATION, forces, feet_pos, feet_R


@pytest.mark.parametrize("name,plane", [("toy", True), ("toy", False), ("t1", True)],
                         ids=["toy-plane", "toy-trimesh", "t1-plane"])
def test_plain_control_step_matches_jax_loop(name, plane, tmp_path):
    """The toy robot on both terrain forms against the JAX Pallas kernel;
    the T1-shaped robot on the plane against the JAX engine (which queries
    the terrain itself, so the carried-terrain form is held to JAX on the
    toy robot)."""
    path = None
    if name == "toy":
        model = toy_model()
    else:
        path = write_t1_shaped_urdf(tmp_path)
        model = load_urdf(path, cylinder_rim_points=4)
    B = 16
    np_state, np_dyn, c = control_inputs(model, B, seed=5)
    h, n = terrain(model, B, plane, seed=6)
    sub = sk.SubstepKernel(model, SimConfig(), feet_of(model), "cpu", plane=plane)
    state, dyn, tc = to_torch(np_state, np_dyn, c)
    (psim, last, tsum, pforces, pfeet, pptxy, *_), _, _ = run_control_step(sub, state, dyn, tc,
                                                                           h, n)
    nb, nf = model.num_bodies, len(feet_of(model))
    sim = sub.unpack_sim(psim)
    feet = pfeet.T.reshape(B, nf, 12)
    ours = (sim, last, tsum / DECIMATION, pforces.T.reshape(B, nb, 3), feet[..., 0:3],
            feet[..., 3:12].reshape(B, nf, 3, 3))
    if name == "toy":
        ref = jax_toy_loop(model, plane, np_state, np_dyn, c, h, n)
    else:
        ref = jax_engine_loop(jax_load_urdf(path, cylinder_rim_points=4), np_state, np_dyn, c)
    for f in SimState.FIELDS:
        np.testing.assert_allclose(getattr(ours[0], f).numpy(), np.asarray(getattr(ref[0], f)),
                                   rtol=TOL, atol=TOL, err_msg=f)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(ref[2]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ours[3].numpy(), np.asarray(ref[3]), rtol=5e-2, atol=1.0)
    for a, b in zip(ours[4:], ref[4:6]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)
    if not plane:
        np.testing.assert_allclose(pptxy.T.reshape(B, -1, 2).numpy(), np.asarray(ref[6]),
                                   atol=1e-5)


def test_library_name_carries_the_envs_per_block_and_source_hash(robot):
    import hashlib

    _, model, _ = robot
    feet = feet_of(model)
    sizes = sk.kernel_sizes(model, feet)
    # the source picks the envs per block from the robot's sizes; a variant
    # build that sets them carries them in its name
    assert "EPB" not in sizes and "MINB" not in sizes
    path = kernel_build.library_path(sk.SOURCE, sizes)
    # the source's bytes, then those of the sampler's header it includes
    header = kernel_build.source_path("terrain_sample.cuh")
    digest = hashlib.sha256(open(sk.CSRC, "rb").read()
                            + open(header, "rb").read()).hexdigest()[:10]
    assert path.endswith(f"_plane1_{digest}.so")
    variant = kernel_build.library_path(sk.SOURCE, dict(sizes, EPB=4, MINB=6))
    assert variant.endswith(f"_plane1_epb4_minb6_{digest}.so")
    # the entry points the wrapper binds, with their argument counts
    src = open(sk.CSRC).read()
    import re

    for name, n in (("bg_control", 21), ("bg_control_terrain", 35), ("bg_substep_info", 1)):
        (decl,) = re.findall(rf"int {name}\(([^)]*)\)", src)
        assert len(decl.split(",")) == n, name


def test_tree_tables_walk_orders(robot):
    """Bodies by depth with level starts; points grouped by body, in index
    order within a body, and each point's slot in that grouping."""
    _, model, _ = robot
    order, lstart, pstart, plist, pslot = sk.tree_tables(model)
    nb = model.num_bodies
    depth = np.zeros(nb, int)
    for b in range(1, nb):
        depth[b] = depth[model.parent[b]] + 1
    assert sorted(order) == list(range(nb)) and order[0] == 0
    assert len(lstart) == nb + 1 and lstart[depth.max() + 1] == nb
    for L in range(depth.max() + 1):
        assert all(depth[b] == L for b in order[lstart[L]:lstart[L + 1]])
    for b in range(nb):
        pts = plist[pstart[b]:pstart[b + 1]]
        assert list(pts) == sorted(pts) and all(model.point_body[p] == b for p in pts)
    assert pstart[-1] == model.num_points
    np.testing.assert_array_equal(plist[pslot], np.arange(model.num_points))


def test_control_step_checks_its_terrain_inputs(robot):
    _, model, _ = robot
    B = 4
    sub = sk.SubstepKernel(model, SimConfig(), feet_of(model), "cpu", plane=True)
    state, dyn, c = to_torch(*control_inputs(model, B, seed=1))
    h, n = terrain(model, B, False, seed=2)
    with pytest.raises(ValueError, match="plane"):
        run_control_step(sub, state, dyn, c, h, n)


def test_prof_substep_needs_a_card():
    """The substep kernel's profile is taken on the card only: without
    CUDA it raises rather than time the plain version."""
    from booster_gym_torch import prof_substep

    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal is what is tested")
    with pytest.raises(RuntimeError, match="CUDA"):
        prof_substep.main([])


# ---------------------------------------------------------------------------
# the control step's epilogue: foot edge points and the terrain under the
# step's queries
EDGES = np.asarray(load_task_cfg("T1")["asset"]["feet_edge_pos"], np.float32)
SMALL_FIELD = dict(num_terrains=2, terrain_width=4.0, terrain_length=4.0, border_size=2.0)


def small_terrain():
    return Terrain({**load_task_cfg("T1")["terrain"], **SMALL_FIELD}, seed=0)


def epilogue_case(model, B, plane, seed):
    """A control step's inputs with every root over the small field's tiles
    and the terrain the env would carry under the points; returns (sub,
    out, terrain)."""
    terr = None if plane else small_terrain()
    sub = sk.SubstepKernel(model, SimConfig(), feet_of(model), "cpu", plane=plane,
                           feet_edge_pos=EDGES, terrain=terr)
    np_state, np_dyn, c = control_inputs(model, B, seed=seed)
    rng = np.random.default_rng(seed)
    np_state["root_pos"][:, :2] += rng.uniform(0.5, 7.5, (B, 2)).astype(np.float32)
    state, dyn, tc = to_torch(np_state, np_dyn, c)
    h = n = hf = None
    if not plane:
        hf = terr.height_field
        h, n = terr.heights_and_normals(state.root_pos[:, None, :2].expand(B, model.num_points, 2)
                                        .contiguous())
    ph = None if h is None else h.T.contiguous()
    pn = None if n is None else n.reshape(B, -1).T.contiguous()
    out = sub.control_step(
        sub.pack_sim(state), sub.pack_dyn(dyn), tc["targets"], tc["last"], tc["delay"], tc["kp"],
        tc["kd"], tc["fric"], tc["lim"], torch.cat([tc["push_f"], tc["push_t"]], dim=-1), ph, pn,
        hf, decimation=DECIMATION)
    return sub, out, terr


def former_feet_edge_world(feet_pos, feet_R, edge_pos):
    """The env's foot edge points as they were computed after the physics
    (envs/t1.py::_feet_edge_world before the epilogue)."""
    px, py, pz = feet_pos.unbind(-1)
    xs, ys, zs = [], [], []
    for lx, ly, lz in edge_pos.tolist():
        xs.append(px + feet_R[..., 0, 0] * lx + feet_R[..., 0, 1] * ly + feet_R[..., 0, 2] * lz)
        ys.append(py + feet_R[..., 1, 0] * lx + feet_R[..., 1, 1] * ly + feet_R[..., 1, 2] * lz)
        zs.append(pz + feet_R[..., 2, 0] * lx + feet_R[..., 2, 1] * ly + feet_R[..., 2, 2] * lz)
    return torch.stack(xs, -1), torch.stack(ys, -1), torch.stack(zs, -1)


def epilogue_views(sub, out, B):
    """The epilogue's outputs: edge points (x, y, z), each [B, nf, ne],
    heights [B, NQ], normals [B, NQ, 3] (None on the plane)."""
    nf, ne = sub.nf, sub.ne
    edges = out.edges.view(B, 3, nf, ne).unbind(1)
    return edges, out.heights, out.normals


@pytest.mark.parametrize("plane", [True, False], ids=["plane", "trimesh"])
def test_plain_epilogue_is_the_former_post_physics_ops_bitwise(robot, plane):
    """The plain control step's edge points, heights and normals equal,
    bitwise, what the env computed after the physics before the epilogue:
    the edge points from the last substep's feet poses, then one sampler
    call on the contact points' xy, the root and the edge points."""
    _, model, _ = robot
    B = 24
    sub, out, terr = epilogue_case(model, B, plane, seed=7)
    edges, h, n = epilogue_views(sub, out, B)
    nf = sub.nf
    feet = out.feet.T.reshape(B, nf, 12)
    feet_pos, feet_R = feet[..., 0:3], feet[..., 3:12].reshape(B, nf, 3, 3)
    ref = former_feet_edge_world(feet_pos, feet_R, EDGES)
    for a, b in zip(edges, ref):
        assert torch.equal(a, b)
    assert out.ptxy is None if plane else out.ptxy.shape == (2 * model.num_points, B)
    if plane:
        assert h is None and out.normals is None
        return
    sim = sub.unpack_sim(out.state)
    edge_xy = torch.stack([ref[0].reshape(B, -1), ref[1].reshape(B, -1)], -1)
    root_xy = sim.root_pos[:, :2].contiguous()
    queries = torch.cat([out.ptxy.T.reshape(B, model.num_points, 2), root_xy[:, None, :],
                         edge_xy], dim=1)
    former = TerrainSampler(terr, model.num_points + 1 + nf * len(EDGES), "cpu")
    h_ref, n_ref = former(terr.height_field, root_xy, queries)
    assert torch.equal(h, h_ref) and torch.equal(n, n_ref)
    assert float(h.abs().max()) > 0 and sub.fused_sampler_launches == 0


@pytest.mark.parametrize("plane", [True, False], ids=["plane", "trimesh"])
def test_plain_epilogue_matches_jax(robot, plane):
    """The same outputs against the JAX env's _feet_edge_world on the same
    feet poses and the JAX sampler in interpret mode on the same queries:
    atol 2e-5, the JAX package's tolerance for its sampler."""
    _, model, _ = robot
    B = 16
    sub, out, terr = epilogue_case(model, B, plane, seed=8)
    edges, h, n = epilogue_views(sub, out, B)
    nf = sub.nf
    feet = out.feet.T.reshape(B, nf, 12).numpy()
    jenv = types.SimpleNamespace(feet_edge_pos=EDGES)
    jedges = JaxT1._feet_edge_world(jenv, jnp.asarray(feet[..., 0:3]),
                                    jnp.asarray(feet[..., 3:12].reshape(B, nf, 3, 3)))
    for a, b in zip(edges, jedges):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5)
    if plane:
        return
    jt = JTerrain({**load_task_cfg("T1")["terrain"], **SMALL_FIELD}, seed=0)
    np.testing.assert_array_equal(jt.height_field, terr.height_field.numpy())
    root_xy = out.state[0:2].T.numpy()
    jx, jy = np.asarray(jedges[0]).reshape(B, -1), np.asarray(jedges[1]).reshape(B, -1)
    queries = np.concatenate([out.ptxy.T.reshape(B, model.num_points, 2).numpy(),
                              root_xy[:, None, :], np.stack([jx, jy], -1)], axis=1)
    jsample = jit_nofusion(jax_make_sampler(jt, sub.nq, interpret=True))
    jh, jn = jsample(build_shift_table(jt.height_field), jnp.asarray(root_xy),
                     jnp.asarray(queries))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=2e-5)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), rtol=0, atol=2e-5)


def test_control_step_checks_its_field(robot):
    """A field goes to the general-terrain kernel built with its terrain
    only; the edge table sets the build's NE."""
    _, model, _ = robot
    feet = feet_of(model)
    plane = sk.SubstepKernel(model, SimConfig(), feet, "cpu", feet_edge_pos=EDGES)
    assert plane.sizes["NE"] == len(EDGES)
    assert plane.nq == model.num_points + 1 + len(EDGES) * len(feet)
    with pytest.raises(ValueError, match="plane"):
        sk.SubstepKernel(model, SimConfig(), feet, "cpu", terrain=small_terrain())
    general = sk.SubstepKernel(model, SimConfig(), feet, "cpu", plane=False)
    assert general.sampler is None and general.sizes["NE"] == 0
    B = 4
    state, dyn, c = to_torch(*control_inputs(model, B, seed=1))
    h, n = terrain(model, B, False, seed=2)
    with pytest.raises(ValueError, match="height field"):
        general.control_step(
            general.pack_sim(state), general.pack_dyn(dyn), c["targets"], c["last"], c["delay"],
            c["kp"], c["kd"], c["fric"], c["lim"], torch.cat([c["push_f"], c["push_t"]], dim=-1),
            torch.as_tensor(h).T.contiguous(), torch.as_tensor(n).reshape(B, -1).T.contiguous(),
            small_terrain().height_field, decimation=DECIMATION)
