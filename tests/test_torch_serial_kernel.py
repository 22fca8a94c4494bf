"""The kernels at the serial robot's sizes against their plain versions, on
the card only (marker cuda; every test skips without one): K1's control
step on the 23-DoF serial stand-in of booster_gym_torch.testing (its 121
URDF and its 85 MJCF contact points), and K2-K4 at T1Serial's 23 actions
and T1Standup's 434-wide critic input.  No JAX import, so that the card's
machine runs it: python -m pytest --noconftest -m cuda
tests/test_torch_serial_kernel.py.
"""

import pytest
import torch

from booster_gym_torch.model import load_urdf
from booster_gym_torch.model.mjcf_points import with_mjcf_collision
from booster_gym_torch.physics import SimConfig
from booster_gym_torch.physics import substep_kernel as sk
from booster_gym_torch.testing import task_dims, write_t1_serial_mjcf, write_t1_serial_urdf

STATE_TOL = 2e-3
GAMMA, LAM = 0.995, 0.95
WIDTHS = {task: task_dims(task) for task in ("T1Serial", "T1Standup")}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("serial")
    return write_t1_serial_urdf(d), write_t1_serial_mjcf(d)


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1000, 4096])
@pytest.mark.parametrize("points", ["urdf", "mjcf"])
def test_k1_control_step_on_the_serial_robot(gpu, assets, points, B):
    """One launch per control step against the plain loop from env-like
    inputs, at chip_smoke's tolerances and exclusion rule (envs whose plain
    state moves past 2e-3 under a one-ulp nudge, at most 1%), at a ragged
    batch and at the training paths' 4096 envs; and the launch shape the
    source picks for the robot (7 envs a block with the 121 URDF points, 8
    with the 85 MJCF points, 2 blocks an SM)."""
    from booster_gym_torch.testing import control_inputs

    urdf, mjcf = assets
    model = load_urdf(urdf)
    if points == "mjcf":
        model = with_mjcf_collision(model, mjcf)
    feet = [model.body_names.index("left_foot_link"), model.body_names.index("right_foot_link")]
    k = sk.SubstepKernel(model, SimConfig(), feet, gpu)
    args = control_inputs(k, model, B, gpu, seed=3, task="T1Serial")
    out, ref = k.control_step(*args), k.control_step_plain(*args)
    nudged = list(args)
    nudged[0] = torch.nextafter(args[0], torch.full_like(args[0], float("inf")))
    chaotic = ((k.control_step_plain(*nudged).state - ref.state).abs()
               > STATE_TOL + STATE_TOL * ref.state.abs()).any(0)
    assert int(chaotic.sum()) <= B // 100
    keep = ~chaotic
    err = (out.state - ref.state).abs()[:, keep]
    assert bool((err <= STATE_TOL + STATE_TOL * ref.state.abs()[:, keep]).all())
    assert k.launches == 1
    info = k.info()
    assert (info["envs_per_block"], info["min_blocks_per_sm"]) == {"urdf": (7, 2),
                                                                   "mjcf": (8, 2)}[points]
    assert info["blocks_per_sm_control"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("task", sorted(WIDTHS))
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_update_kernels_at_new_widths(gpu, task, dtype):
    """K2, K3 and K4 against their plain versions at N = 24 x 1000 (ragged
    tiles), chip_smoke's tolerances (relative errors of the norm: f32 2e-4
    values, 1e-4 gradients; bf16 2^-7 and 2.5 * 2^-8)."""
    from booster_gym_torch.testing import update_case

    val, grad = {"f32": (2e-4, 1e-4), "bf16": (2.0 ** -7, 2.5 * 2.0 ** -8)}[dtype]
    rel = lambda a, b: float((a - b).norm() / b.norm())
    fused, p, staged, prep, d = update_case(dtype, 24, 1000, gpu, seed=4, dims=WIDTHS[task])
    rew, done, timeout = d["buf"][5:]
    args = (staged, prep["obsc"], rew, 1.0 - (done | timeout).float(), timeout.float(), GAMMA,
            LAM)
    for a, b in zip(fused.gae(*args)[:2], fused.gae_plain(*args)[:2]):
        assert rel(a, b) <= val
    mean, rstd = d["adv"].mean(), 1.0 / (d["adv"].std() + 1e-8)
    k3 = (staged, p, prep, d["adv"], d["ret"], mean, rstd, False)
    assert rel(fused.grads_stats(*k3)[0], fused.grads_stats_plain(*k3)[0]) <= grad
    g = 0.3 * torch.randn(p.shape, device=gpu)
    k4 = (g, p, torch.zeros_like(p), torch.zeros_like(p), 7, torch.tensor(1e-3, device=gpu))
    kw = dict(entropy_coef=-0.01, b1=0.9, b2=0.999, eps=1e-8, max_norm=1.0)
    for a, b in zip(fused.opt_stage(*k4, **kw)[:3], fused.opt_stage_plain(*k4, **kw)[:3]):
        assert bool(((a - b).abs() <= 1e-7 + 1e-5 * b.abs()).all())
