"""The port's values, grads and policy_old_logp (K8, K9 and K10 of
booster_gym_torch/algo/update_kernel.py) against the JAX package's row-major
anchor kernels run in interpret mode, against autograd, and against K3's
plain version; and the slice's entry point, booster_gym_torch.prof_update.

On the CPU the port's wrappers run their plain versions, which the CUDA
kernels are held against on the card.  Parameters come from a flax
ActorCritic through convert.py; inputs are made with numpy from a seed
(booster_gym_torch.testing.anchor_case).  Tolerances are those of
tests/test_update_kernel.py; bf16 comparisons compile the reference with
excess precision off, so that XLA:CPU rounds where the kernel says it does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from booster_gym_tpu.algo.networks import ActorCritic as JaxActorCritic
from booster_gym_tpu.algo.update_kernel import FusedUpdate as JaxFusedUpdate

from booster_gym_torch import prof_update
from booster_gym_torch.algo.networks import ActorCritic, normal_log_prob
from booster_gym_torch.algo.ppo import flat_params, jax_clip
from booster_gym_torch.algo.update_kernel import FusedUpdate, param_layout
from booster_gym_torch.convert import flat_from_flax, params_from_flax
from booster_gym_torch.testing import anchor_case

NA, NO, NP = 12, 47, 14
T, B = 3, 96          # N = 288: three of the JAX kernel's 128-row tiles, the last ragged
EXACT = {"xla_allow_excess_precision": False}


def host(tree):
    return jax.tree.map(np.asarray, tree)


def make(dtype, seed=0, ties=False):
    """(JAX anchor kernels, flax params, the port's network loaded from
    them, its FusedUpdate, flat p, d)."""
    jnet = JaxActorCritic(NA, NO, NP, compute_dtype=dtype)
    params = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, NO)), jnp.zeros((1, NP)))
    # biases and logstd off their zero / constant init, so every leaf counts
    rng = np.random.default_rng(seed + 100)
    params = jax.tree.map(
        lambda p: p + jnp.asarray(0.05 * rng.normal(size=p.shape), jnp.float32)
        if p.ndim == 1 or p.shape[0] == 1 else p, params)
    jfused = JaxFusedUpdate(NO, NP, NA, clip_ratio=0.2, bound_coef=10.0, compute_dtype=dtype,
                            tile=128, interpret=True)
    net = ActorCritic(NA, NO, NP, compute_dtype=dtype)
    net.load_state_dict(params_from_flax(host(params)))
    fused, p, d = anchor_case(net, T, B, "cpu", seed=seed + 1, ties=ties)
    assert torch.equal(p, flat_from_flax(net, host(params)))
    return jfused, params, net, fused, p, d


def jx(d, *keys):
    return [jnp.asarray(d[k].numpy()) for k in keys]


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lead", ["TB", "B"])
def test_values_plain_matches_jax_kernel(dtype, lead):
    """f32 to the JAX test's rtol 1e-5 / atol 1e-7; bf16 bitwise."""
    jfused, params, _, fused, p, d = make(dtype)
    obs, priv = (d["obs"], d["priv"]) if lead == "TB" else (d["obs"][1], d["priv"][1])
    v_j = jax.jit(jfused.values, compiler_options=EXACT)(
        params, jnp.asarray(obs.numpy()), jnp.asarray(priv.numpy()))
    v = fused.values(p, obs, priv)
    assert v.shape == obs.shape[:-1] == v_j.shape
    if dtype == "f32":
        np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_j))
    assert fused.values_launches == 0


@pytest.mark.parametrize("dtype,n_total_factor", [("f32", 1), ("f32", 3), ("bf16", 1),
                                                  ("bf16", 3)])
def test_grads_plain_matches_jax_kernel(dtype, n_total_factor):
    """Every gradient leaf, mu and the values.  f32: rtol 2e-4 / atol 1e-7
    on each, as tests/test_update_kernel.py holds the kernel against
    jax.grad.  bf16: each leaf within 2.5 bf16 ulps (2.5 * 2^-8) of its
    norm, as for K3; mu and the values bitwise but for at most 0.1% of
    them one bf16 ulp apart: a product whose f32 sum lies within rounding
    of a bf16 midpoint rounds by its summation order (ROADMAP.md section
    3).  n_total = 3 N divides the loss means, not the mask."""
    jfused, params, net, fused, p, d = make(dtype)
    n_total = n_total_factor * T * B
    fn = jax.jit(functools.partial(jfused.grads, n_total=n_total), compiler_options=EXACT)
    g_j, mu_j, val_j = fn(params, *jx(d, "obs", "priv", "act", "adv", "ret", "old_logp"))
    g, mu, val = fused.grads(p, d["obs"], d["priv"], d["act"], d["adv"], d["ret"],
                             d["old_logp"], n_total=None if n_total_factor == 1 else n_total)
    g_ref = flat_from_flax(net, host(g_j))
    assert mu.shape == (T, B, NA) and val.shape == (T, B)
    for name, (off, shape) in param_layout(net).items():
        k = int(np.prod(shape))
        a, b = g[off:off + k], g_ref[off:off + k]
        if dtype == "f32":
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-7, err_msg=name)
        else:
            assert float((a - b).norm() / b.norm()) <= 2.5 * 2.0 ** -8, name
    if dtype == "f32":
        np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), rtol=2e-4, atol=1e-7)
        np.testing.assert_allclose(val.numpy(), np.asarray(val_j), rtol=2e-4, atol=1e-7)
    else:
        for a, b in ((mu, mu_j), (val, val_j)):
            b = torch.as_tensor(np.array(b))
            apart = a != b
            assert int(apart.sum()) <= 1e-3 * a.numel()
            # one bf16 ulp: 2^-7 of the value's binade, at most 2^-7 |b|
            assert bool(((a - b).abs()[apart] <= 2.0 ** -7 * b.abs()[apart]).all())
    assert fused.grads_launches == 0


def xla_loss_grad(p, d):
    """torch.autograd of the loss that the xla update differentiates
    (booster_gym_torch/algo/ppo.py), entropy term left out, on the port's
    f32 ActorCritic at the flat parameters p."""
    net = ActorCritic(NA, NO, NP, compute_dtype="f32")
    torch.nn.utils.vector_to_parameters(p, net.parameters())
    mu, std = net.act(d["obs"])
    values = net.est_value(d["obs"], d["priv"])
    ratio = torch.exp(normal_log_prob(mu, std, d["act"]) - d["old_logp"])
    adv = d["adv"]
    loss = (torch.mean(torch.square(values - d["ret"]))
            + torch.mean(torch.maximum(-adv * ratio, -adv * jax_clip(ratio, 0.8, 1.2)))
            + 10.0 * (torch.mean(torch.square(torch.clamp(mu - 1.0, min=0.0)))
                      + torch.mean(torch.square(torch.clamp(mu + 1.0, max=0.0)))))
    grads = torch.autograd.grad(loss, list(net.parameters()))
    return torch.cat([x.reshape(-1) for x in grads])


@pytest.mark.parametrize("ties", [False, True])
def test_grads_plain_matches_autograd_of_the_xla_loss(ties):
    """The anchor's role: grads_plain against autograd of the xla update's
    loss, f32, rtol 2e-4 / atol 1e-7.  With ties, ratios sit exactly on 0.8
    and 1.2 (and 1.0): the clip passes half its gradient on a bound and the
    max half on a tie.  The autograd loss then runs through the plain
    version's own forward (bitwise the same logp, so the ties are ties
    there too); with torch.clamp, which passes the whole gradient on a
    bound, the gradient differs.  (Without ties, the two f32 computations
    put 0 to 3 of the 177,945 values past atol 1e-7 by up to 2.3e-7,
    depending on the seed; ROADMAP.md section 3.)"""
    _, _, _, fused, p, d = make("f32", seed=4 if ties else 0, ties=ties)
    args = (d["obs"], d["priv"], d["act"], d["adv"], d["ret"], d["old_logp"])
    g = fused.grads(p, *args)[0]
    if not ties:
        g_ref = xla_loss_grad(p, d)
        np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=2e-4, atol=1e-7)
        return
    n = T * B
    prep = fused.prepare(d["obs"], d["priv"], d["act"], torch.zeros_like(d["act"]),
                         d["old_logp"])
    _, logp0 = fused.policy_old_logp(p, prep)
    old = d["old_logp"].reshape(n)
    ratio = torch.exp(logp0 - old)
    on_bound = int(((ratio == np.float32(0.8)) | (ratio == np.float32(1.2))).sum())
    assert on_bound >= 40, on_bound

    def autograd(clip):
        flat = p.clone().requires_grad_()
        staged = fused.stage(flat)
        x = fused._obsc_rows(d["obs"], d["priv"])
        _, _, mu, logstd, var, diff, logp = fused._policy(staged, flat, x,
                                                          d["act"].reshape(n, NA))
        val = fused._mlp_fwd(x, *fused._mlp(staged, "critic"))[1][-1][:, 0]
        assert torch.equal(logp.detach(), logp0)
        ratio = torch.exp(logp - old)
        adv = d["adv"].reshape(n)
        loss = (torch.mean(torch.square(val - d["ret"].reshape(n)))
                + torch.mean(torch.maximum(-adv * ratio, -adv * clip(ratio, 0.8, 1.2)))
                + 10.0 * (torch.mean(torch.square(torch.clamp(mu - 1.0, min=0.0)))
                          + torch.mean(torch.square(torch.clamp(mu + 1.0, max=0.0)))))
        return torch.autograd.grad(loss, flat)[0]

    g_ref = autograd(jax_clip)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=2e-4, atol=1e-7)
    g_clamp = autograd(torch.clamp)
    assert float((g_clamp - g_ref).norm() / g_ref.norm()) > 1e-2
    assert float((g - g_ref).norm() / g_ref.norm()) < 1e-5


def test_grads_plain_on_normalised_advantages_matches_grads_stats_plain():
    """grads (K9) on (adv - mean) * rstd against grads_stats (K3) on the
    raw advantages, f32, rtol 2e-4 / atol 5e-7 as tests/test_update_kernel.py
    holds grads_stats against grads; mu as K3 returns it."""
    _, _, _, fused, p, d = make("f32", seed=2)
    mean, rstd = d["adv"].mean(), 1.0 / (d["adv"].std() + 1e-8)
    g, mu, _ = fused.grads(p, d["obs"], d["priv"], d["act"], (d["adv"] - mean) * rstd, d["ret"],
                           d["old_logp"])
    prep = fused.prepare(d["obs"], d["priv"], d["act"], torch.zeros_like(d["act"]),
                         d["old_logp"])
    g3, _, mu3, _ = fused.grads_stats(fused.stage(p), p, prep, d["adv"], d["ret"], mean, rstd,
                                      False)
    np.testing.assert_allclose(g.numpy(), g3.numpy(), rtol=2e-4, atol=5e-7)
    np.testing.assert_array_equal(mu.reshape(-1, NA).numpy(), mu3.numpy())


def test_policy_old_logp_plain_matches_jax_kernel():
    """mu at rtol 2e-4 / atol 1e-6 and logp at 2e-4 / 1e-5, as
    tests/test_update_kernel.py holds the kernel against flax; the prep is
    built without the post-rollout observation."""
    jfused, params, _, fused, p, d = make("f32", seed=3)
    mu_buf = torch.zeros_like(d["act"])
    prep_j = jfused.prepare(*jx(d | {"mu": mu_buf}, "obs", "priv", "act", "mu", "old_logp"))
    muT_j, logp_j = jax.jit(jfused.policy_old_logp)(params, prep_j)
    prep = fused.prepare(d["obs"], d["priv"], d["act"], mu_buf, d["old_logp"])
    assert prep["obsc"].shape == (T, B, NO + NP)
    mu, logp = fused.policy_old_logp(p, prep)
    np.testing.assert_allclose(mu.numpy(), np.moveaxis(np.asarray(muT_j), 0, -1).reshape(-1, NA),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j).reshape(-1), rtol=2e-4,
                               atol=1e-5)
    assert fused.policy_logp_launches == 0


# ---------------------------------------------------------------------------
def test_prof_update_runs_on_the_cpu(capsys, tmp_path):
    records = prof_update.main(["--device", "cpu", "--T", "3", "--B", "96", "--iters", "1",
                                "--trace", str(tmp_path)])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == len(records) == 6
    assert [r["kernel"] for r in records] == ["K8", "K9", "K10", "K2", "K3", "K4"]
    for r in records:
        assert r["device"] == "cpu" and "ms" not in r and r["host_ms"] > 0
        assert r["launches"] == 0 and r["calls"] == 4 and r["bound_ms"] > 0
    assert (tmp_path / "grads_trace.json").exists()


def test_prof_update_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prof_update.main(["--T", "2", "--B", "8", "--iters", "1"])


def test_prof_update_bounds_at_the_training_shape():
    """The bounds of K8-K10 at T = 24, B = 4096 in bf16: the critic's
    114,048 and the actor's 62,720 multiply-adds per row, K9's work that
    of K3, all bound by operations at 989 TFLOP/s."""
    net = ActorCritic(NA, NO, NP, compute_dtype="bf16")
    fused = FusedUpdate(net, 0.2, 10.0)
    work = prof_update.update_work(fused, 24, 4096)
    n = 24 * 4096
    assert work["values"][1] == n * 2 * 114048
    assert work["policy_old_logp"][1] == n * 2 * 62720
    assert work["grads"][1] == work["grads_stats"][1]
    for method, us in (("values", 22.7), ("grads", 99.9), ("policy_old_logp", 12.5)):
        ms, by = prof_update.bound(fused, method, *work[method])
        assert by == "operations" and abs(ms * 1e3 - us) < 0.1, (method, ms)
    assert flat_params(net).numel() == fused.n_params
