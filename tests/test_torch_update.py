"""The port's fused PPO update (booster_gym_torch/algo/update_kernel.py)
against the JAX package's Pallas kernels run in interpret mode.

On the CPU the port's wrappers run their plain versions, which the CUDA
kernels are held against on the card, so these tests pin the arithmetic of
K2, K3 and K4.  Inputs are made with numpy from a seed and handed to both
sides.  Tolerances are those of tests/test_update_kernel.py: both sides do
the same f32 products in another summation order.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from booster_gym_tpu.algo.networks import ActorCritic as JaxActorCritic
from booster_gym_tpu.algo.ppo import PPO as JaxPPO
from booster_gym_tpu.algo.update_kernel import FusedUpdate as JaxFusedUpdate
from booster_gym_tpu.utils.config import load_task_cfg as jax_load_task_cfg

from booster_gym_torch.algo.networks import ActorCritic
from booster_gym_torch.algo.ppo import PPO, OptState, flat_params, jax_clip
from booster_gym_torch.algo.update_kernel import FusedUpdate, param_layout
from booster_gym_torch.convert import (
    flat_from_flax,
    flat_from_leaves,
    leaves_from_flat,
    params_from_flax,
)

NA, NO, NP = 12, 47, 14
ENV = types.SimpleNamespace(num_actions=NA, num_obs=NO, num_privileged_obs=NP)
GAMMA, LAM = 0.995, 0.95


def host(tree):
    return jax.tree.map(np.asarray, tree)


def tt(x):
    return torch.as_tensor(np.array(x))


def make(dtype, seed=0):
    """(JAX kernels, flax params, port's kernels, port's network, flat p)."""
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
    fused = FusedUpdate(net, clip_ratio=0.2, bound_coef=10.0)
    return jfused, jnet, params, fused, net, flat_params(net)


def batch(jnet, params, rng, T, B):
    """Update inputs: obs, priv, act near the policy, raw advantages,
    returns, an old logp that puts ratios on both sides of the clip range,
    the policy's mu, and the last observation."""
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    obs, priv = f32(T, B, NO), f32(T, B, NP)
    mu, std = jnet.apply(params, jnp.asarray(obs), method=JaxActorCritic.act)
    mu, std = np.asarray(mu), np.asarray(std)
    act = (mu + std * f32(T, B, NA)).astype(np.float32)
    logp = np.sum(-0.5 * ((act - mu) / std) ** 2 - np.log(std) - 0.5 * np.log(2 * np.pi), -1)
    old_logp = (logp + 0.3 * f32(T, B)).astype(np.float32)
    mu_old = (mu + 0.02 * f32(T, B, NA)).astype(np.float32)
    return dict(obs=obs, priv=priv, act=act, adv=(0.3 + 2.0 * f32(T, B)), ret=f32(T, B),
                old_logp=old_logp, mu_old=mu_old, obs_last=f32(B, NO), priv_last=f32(B, NP))


def prepare(fused, d):
    return fused.prepare(*(tt(d[k]) for k in ("obs", "priv", "act", "mu_old", "old_logp",
                                              "obs_last", "priv_last")))


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B", [128, 96])   # 96: the JAX kernel pads its lanes
def test_gae_plain_matches_jax_kernel(B):
    gae_matches_jax(5, B)


def test_gae_plain_matches_jax_kernel_over_a_long_horizon():
    """The JAX kernel walks one plane per grid step and takes any horizon;
    so does the port's plain version, past the 235 planes (T = 234) that
    the bf16 card kernel keeps in shared memory."""
    gae_matches_jax(240, 8)


def gae_matches_jax(T, B):
    jfused, jnet, params, fused, net, p = make("f32")
    rng = np.random.default_rng(B)
    d = batch(jnet, params, rng, T, B)
    rew = rng.normal(size=(T, B)).astype(np.float32)
    done = rng.random((T, B)) < 0.2
    timeout = rng.random((T, B)) < 0.1
    nonterm = 1.0 - (done | timeout).astype(np.float32)
    tf = timeout.astype(np.float32)
    adv_j, ret_j, sa_j, sa2_j = jax.jit(functools.partial(jfused.gae, gamma=GAMMA, lam=LAM))(
        params, *(jnp.asarray(x) for x in (d["obs"], d["priv"], d["obs_last"], d["priv_last"],
                                           rew, nonterm, tf)))
    prep = prepare(fused, d)
    assert prep["obsc"].shape == (T + 1, B, NO + NP)
    adv, ret, sa, sa2 = fused.gae(fused.stage(p), prep["obsc"], tt(rew), tt(nonterm), tt(tf),
                                  GAMMA, LAM)
    np.testing.assert_allclose(adv.numpy(), np.asarray(adv_j), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), np.asarray(ret_j), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(float(sa), float(sa_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(sa2), float(sa2_j), rtol=1e-4, atol=1e-4)
    assert fused.gae_launches == 0     # the CPU runs the plain version


def jax_grads_stats(jfused, params, d, mean, rstd, self_old):
    prep = jfused.prepare(*(jnp.asarray(d[k]) for k in ("obs", "priv", "act", "mu_old",
                                                        "old_logp")))
    # XLA:CPU by default drops f32 -> bf16 -> f32 round trips ("excess
    # precision"), which un-rounds the bf16 kernel's products before the bias
    # add; switched off, interpret mode rounds where the kernel says it does
    fn = jax.jit(functools.partial(jfused.grads_stats_prepared, self_old=self_old),
                 compiler_options={"xla_allow_excess_precision": False})
    return fn(params, prep, jnp.asarray(d["adv"]), jnp.asarray(d["ret"]), jnp.float32(mean),
              jnp.float32(rstd))


def port_grads_stats(fused, p, d, mean, rstd, self_old):
    return fused.grads_stats(fused.stage(p), p, prepare(fused, d), tt(d["adv"]), tt(d["ret"]),
                             torch.tensor(mean), torch.tensor(rstd), self_old)


def adv_norm(d):
    return float(d["adv"].mean()), float(1.0 / (d["adv"].std(ddof=1) + 1e-8))


@pytest.mark.parametrize("self_old", [False, True])
def test_grads_stats_plain_matches_jax_kernel_f32(self_old):
    """N = 288 over three of the JAX kernel's 128-column tiles, the last
    one ragged: every gradient leaf, the five metric sums, mu and logp."""
    jfused, jnet, params, fused, net, p = make("f32")
    d = batch(jnet, params, np.random.default_rng(1), 3, 96)
    mean, rstd = adv_norm(d)
    g_j, st_j, mu_j, logp_j = jax_grads_stats(jfused, params, d, mean, rstd, float(self_old))
    g, st, mu, logp = port_grads_stats(fused, p, d, mean, rstd, self_old)

    g_ref = flat_from_flax(net, host(g_j))
    for name, (off, shape) in param_layout(net).items():
        n = int(np.prod(shape))
        np.testing.assert_allclose(g[off:off + n].numpy(), g_ref[off:off + n].numpy(),
                                   rtol=2e-4, atol=5e-7, err_msg=name)
    assert float(g_ref[fused.logstd_slice].abs().min()) > 0
    # al sums normalised advantages, which cancel: atol 1e-6 on its mean, as
    # tests/test_update_kernel.py has it
    for k in ("vl", "al", "bhi", "blo", "klsq"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(st_j[k]), rtol=1e-4,
                                   atol=1e-6 * 288 if k == "al" else 1e-9, err_msg=k)
    np.testing.assert_allclose(mu.numpy(), np.moveaxis(np.asarray(mu_j), 0, -1).reshape(-1, NA),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(logp.numpy(), np.asarray(logp_j).reshape(-1), rtol=2e-4, atol=1e-5)
    if self_old:
        # the old policy is the forward itself: sum (mu - mu_old)^2 is exactly 0
        assert float(st["klsq"].abs().max()) == 0.0
        # and the returned logp is the old logp used: feeding it back as
        # old_logp (with mu as mu_old) gives the same gradient bitwise
        d2 = {**d, "old_logp": logp.numpy().reshape(3, 96), "mu_old": mu.numpy().reshape(3, 96, NA)}
        g2, st2, _, _ = port_grads_stats(fused, p, d2, mean, rstd, False)
        assert torch.equal(g2, g) and float(st2["klsq"].abs().max()) == 0.0
    else:
        assert float(st["klsq"].min()) > 0
    assert fused.grads_stats_launches == 0


def test_grads_stats_tie_rules():
    """Ratios exactly on 0.8, 1.0 and 1.2: the clip passes half its gradient
    on a bound and the max half on a tie.  The plain version is held
    against autograd of the same loss written with jax_clip and
    torch.maximum (whose tie rules tests/test_torch_ppo.py holds against
    JAX); the same loss with torch.clamp, which passes the whole gradient on
    a bound, gives another gradient."""
    _, jnet, params, fused, net, p = make("f32")
    T, B = 2, 48
    n = T * B
    d = batch(jnet, params, np.random.default_rng(5), T, B)
    mean, rstd = adv_norm(d)
    _, _, _, logp0 = port_grads_stats(fused, p, d, mean, rstd, True)
    # x with exp(x) exactly on the bound, searched among log(bound)'s neighbours
    old = logp0.clone()
    on_bound = 0
    for k, target in enumerate((0.8, 1.0, 1.2)):
        x = torch.tensor(np.log(target), dtype=torch.float32)
        cands = [x]
        for _ in range(4):
            cands += [torch.nextafter(cands[-1], torch.tensor(9.0)),
                      torch.nextafter(cands[0], torch.tensor(-9.0))]
            cands.sort(key=float)
        for i in range(k, n, 3):
            for x in cands:
                o = logp0[i] - x
                if float(torch.exp(logp0[i] - o)) == float(np.float32(target)):
                    old[i] = o
                    on_bound += target != 1.0
                    break
    # logp - old_logp moves in steps of ulp(logp), coarser than the few 1e-8
    # of x that exp maps onto a bound, so only some samples can sit exactly on
    # it (32 of 64 here); the others stay within rounding of it, where
    # both clips agree
    assert on_bound >= 8
    d = {**d, "old_logp": old.numpy().reshape(T, B)}
    g, _, _, _ = port_grads_stats(fused, p, d, mean, rstd, False)

    def autograd(clip):
        """Autograd through the plain version's own forward (bitwise the
        same logp, so the ties are ties here too) and the loss as the xla
        update writes it."""
        flat = p.clone().requires_grad_()
        x = prepare(fused, d)["obsc"].reshape(-1, NO + NP)[:n]
        mu = fused._mlp_fwd(x[:, :NO], *fused._mlp(flat, "actor"))[1][-1]
        val = fused._mlp_fwd(x, *fused._mlp(flat, "critic"))[1][-1][:, 0]
        logstd = flat[fused.logstd_slice]
        diff = tt(d["act"]).reshape(n, NA) - mu
        logp = torch.sum(-0.5 * diff * diff / torch.exp(2.0 * logstd) - logstd
                         - 0.5 * np.log(2 * np.pi), dim=1)
        assert torch.equal(logp.detach(), logp0)
        ratio = torch.exp(logp - old)
        adv = (tt(d["adv"]).reshape(n) - mean) * rstd
        loss = (torch.mean(torch.square(val - tt(d["ret"]).reshape(n)))
                + torch.mean(torch.maximum(-adv * ratio, -adv * clip(ratio, 0.8, 1.2)))
                + 10.0 * (torch.mean(torch.square(torch.clamp(mu - 1.0, min=0.0)))
                          + torch.mean(torch.square(torch.clamp(mu + 1.0, max=0.0)))))
        return torch.autograd.grad(loss, flat)[0]

    g_ref = autograd(jax_clip)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=2e-4, atol=5e-7)
    g_clamp = autograd(torch.clamp)
    assert float((g_clamp - g_ref).norm() / g_ref.norm()) > 1e-2
    assert float((g - g_ref).norm() / g_ref.norm()) < 1e-5


def test_grads_stats_plain_bf16_matches_jax_kernel_bf16():
    """The main path's compute type.  Both sides round to bf16 at the same
    places and sum f32 in another order, which lands some values one bf16
    ulp apart: they agree to 2.5 bf16 ulps (2.5 * 2^-8) of the gradient's
    norm.  The f32 plain version lies outside that bound, so the check sees
    the roundings."""
    tol = 2.5 * 2.0 ** -8
    jfused, jnet, params, fused, net, p = make("bf16")
    d = batch(jnet, params, np.random.default_rng(2), 3, 96)
    mean, rstd = adv_norm(d)
    g_j, st_j, mu_j, _ = jax_grads_stats(jfused, params, d, mean, rstd, 0.0)
    g_ref = flat_from_flax(net, host(g_j))
    g, st, mu, _ = port_grads_stats(fused, p, d, mean, rstd, False)
    assert fused.stage(p).dtype == torch.bfloat16
    err = float((g - g_ref).norm() / g_ref.norm())
    assert err <= tol, err
    np.testing.assert_allclose(mu.numpy(), np.moveaxis(np.asarray(mu_j), 0, -1).reshape(-1, NA),
                               rtol=2.0 ** -7, atol=2.0 ** -9)
    np.testing.assert_allclose(float(st["vl"]), float(st_j["vl"]), rtol=1e-2)

    *_, fused32, net32, p32 = make("f32")
    g32, *_ = port_grads_stats(fused32, p32, d, mean, rstd, False)
    assert float((g32 - g_ref).norm() / g_ref.norm()) > tol


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_opt_stage_plain_matches_jax_kernel(dtype):
    """From a non-trivial Adam state at count 7; the gradient's norm is far
    above the clip, so the scale is at work."""
    jfused, jnet, params, fused, net, p = make(dtype)
    rng = np.random.default_rng(3)
    rand = lambda scale, f=lambda x: x: jax.tree.map(
        lambda q: jnp.asarray(f(rng.normal(size=q.shape)) * scale, jnp.float32), params)
    grads, mu, nu = rand(0.3), rand(1e-2), rand(1e-3, np.abs)
    kw = dict(entropy_coef=-0.01, b1=0.9, b2=0.999, eps=1e-8, max_norm=1.0)
    p_j, m_j, v_j, staged_j = jax.jit(functools.partial(jfused.opt_stage, **kw))(
        *(jfused.param_leaves(t) for t in (grads, params, mu, nu)), jnp.int32(7),
        jnp.float32(1e-3))
    flat = lambda t: flat_from_flax(net, host(t))
    p2, m2, v2, staged = fused.opt_stage(flat(grads), p, flat(mu), flat(nu), 7,
                                         torch.tensor(1e-3), **kw)
    for ours, theirs in ((p2, p_j), (m2, m_j), (v2, v_j)):
        np.testing.assert_allclose(ours.numpy(), flat_from_leaves(net, host(theirs)).numpy(),
                                   rtol=1e-5, atol=1e-7)
    assert float((p2 - p).abs().max()) > 1e-4
    # the staged weights are the cast of the new parameters, bitwise
    assert staged.dtype == fused.dtype and torch.equal(staged, p2.to(fused.dtype))
    assert fused.opt_stage_launches == 0


def test_leaf_conversion_round_trips_and_matches_param_leaves():
    jfused, jnet, params, fused, net, p = make("f32")
    leaves = [np.asarray(x) for x in jfused.param_leaves(params)]
    flat = flat_from_leaves(net, leaves)
    assert torch.equal(flat, p) and torch.equal(flat, flat_from_flax(net, host(params)))
    back = leaves_from_flat(net, flat)
    assert len(back) == len(leaves) == 17
    for a, b in zip(back, leaves):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert back[0].shape == (NO, 256) and back[4].shape == (256, 1) and back[-1].shape == (NA, 1)
    with pytest.raises(ValueError):
        flat_from_leaves(net, leaves[:-1])


# ---------------------------------------------------------------------------
def ppo_pair(backend_j, backend_t, mini_epochs=3, **algo):
    cfg = jax_load_task_cfg("T1")
    cfg["algorithm"].update(compute_dtype="f32", **algo)
    cfg["runner"]["mini_epochs"] = mini_epochs
    cfg_j = {**cfg, "algorithm": {**cfg["algorithm"], "update_backend": backend_j}}
    cfg_t = {**cfg, "algorithm": {**cfg["algorithm"], "update_backend": backend_t}}
    return JaxPPO(ENV, cfg_j), PPO(ENV, cfg_t, "cpu")


def rollout_buffers(jnet, params, rng, T=6, B=16):
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    obs, priv = f32(T, B, NO), f32(T, B, NP)
    mu, std = jnet.apply(params, jnp.asarray(obs), method=JaxActorCritic.act)
    mu, std = np.asarray(mu), np.asarray(std)
    act = (mu + std * f32(T, B, NA)).astype(np.float32)
    done = rng.random((T, B)) < 0.1
    timeout = rng.random((T, B)) < 0.1
    return (obs, priv, act, mu, std, f32(T, B), done, timeout), f32(B, NO), f32(B, NP)


def port_update(tppo, params, buf, obs_last, priv_last, m0, v0, lr0):
    net = tppo.network
    net.load_state_dict(params_from_flax(host(params)))
    ts = types.SimpleNamespace(
        opt=OptState(m=flat_from_flax(net, host(m0)), v=flat_from_flax(net, host(v0)), count=7),
        lr=torch.tensor(lr0))
    opt, lr, stats = tppo.update(ts, (None, tt(obs_last), tt(priv_last)),
                                 tuple(tt(x) for x in buf))
    return flat_params(net), opt, lr, stats


STAT_NAMES = ("value_loss", "actor_loss", "bound_loss", "entropy", "kl_mean")


@pytest.mark.parametrize("min_logstd", [None, -1.9])
def test_fused_update_matches_jax_fused_update(min_logstd):
    """Three mini-epochs of the whole fused update from the same
    parameters, Adam state (count 7) and rollout buffers."""
    extra = {} if min_logstd is None else {"min_logstd": min_logstd}
    jppo, tppo = ppo_pair("fused", "fused", **extra)
    assert tppo.update_backend == "fused"
    jnet = jppo.network
    params = jnet.init(jax.random.PRNGKey(2), jnp.zeros((1, NO)), jnp.zeros((1, NP)))
    rng = np.random.default_rng(4)
    buf, obs_last, priv_last = rollout_buffers(jnet, params, rng)
    rand_tree = lambda scale: jax.tree.map(
        lambda q: jnp.asarray(np.abs(rng.normal(size=q.shape)) * scale, jnp.float32), params)
    m0, v0 = rand_tree(1e-3), rand_tree(1e-5)
    clip_state, inj = jppo.tx.init(params)
    adam, rest = inj.inner_state
    opt_state = (clip_state, inj._replace(count=jnp.int32(7), inner_state=(
        adam._replace(count=jnp.int32(7), mu=m0, nu=v0), rest)))
    lr0 = 1e-3
    jts = types.SimpleNamespace(params=params, opt_state=opt_state, lr=jnp.float32(lr0))
    carry = (None, jnp.asarray(obs_last), jnp.asarray(priv_last)) + (None,) * 6
    (p_j, opt_j, lr_j), stats_j = jppo.update(jts, carry, tuple(map(jnp.asarray, buf)))

    p_t, opt_t, lr_t, stats_t = port_update(tppo, params, buf, obs_last, priv_last, m0, v0, lr0)
    net = tppo.network
    np.testing.assert_allclose(p_t.numpy(), flat_from_flax(net, host(p_j)).numpy(),
                               rtol=1e-4, atol=1e-6)
    adam_j = opt_j[1].inner_state[0]
    np.testing.assert_allclose(opt_t.m.numpy(), flat_from_flax(net, host(adam_j.mu)).numpy(),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(opt_t.v.numpy(), flat_from_flax(net, host(adam_j.nu)).numpy(),
                               rtol=1e-4, atol=1e-9)
    for i, name in enumerate(STAT_NAMES):
        np.testing.assert_allclose(stats_t[:, i].numpy(), np.asarray(stats_j[i]),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    assert float(stats_t[0, 4]) == 0.0          # epoch 0: the old policy is the forward itself
    np.testing.assert_allclose(float(lr_t), float(lr_j), rtol=1e-6)
    assert float(lr_t) != lr0                   # the KL rule moved it
    assert opt_t.count == 7 + 3 == int(adam_j.count)
    if min_logstd is not None:
        assert float(net.logstd.detach().min()) >= min_logstd
        assert float(net.logstd.detach().min()) == np.float32(min_logstd)   # the clamp was at work


def test_fused_update_matches_xla_update():
    """The port's two backends from the same state: near-identical numerics
    (the tolerances of the JAX package's fused-against-xla test)."""
    jppo, fused_ppo = ppo_pair("xla", "fused", mini_epochs=2)
    _, xla_ppo = ppo_pair("xla", "xla", mini_epochs=2)
    jnet = jppo.network
    params = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, NO)), jnp.zeros((1, NP)))
    rng = np.random.default_rng(6)
    buf, obs_last, priv_last = rollout_buffers(jnet, params, rng, T=8, B=8)
    # a warm Adam state: from zero moments the first steps are g / |g|, which
    # turns rounding noise on near-zero gradients into whole steps
    rand_tree = lambda scale: jax.tree.map(
        lambda q: jnp.asarray(np.abs(rng.normal(size=q.shape)) * scale, jnp.float32), params)
    m0, v0 = rand_tree(1e-3), rand_tree(1e-5)
    out = {}
    for name, ppo in (("fused", fused_ppo), ("xla", xla_ppo)):
        out[name] = port_update(ppo, params, buf, obs_last, priv_last, m0, v0, 1e-3)
    np.testing.assert_allclose(out["fused"][0].numpy(), out["xla"][0].numpy(),
                               rtol=1e-4, atol=1e-6)
    # epoch 0's KL: exactly 0 on the fused path, rounding noise on the other
    np.testing.assert_allclose(out["fused"][3].numpy(), out["xla"][3].numpy(),
                               rtol=1e-4, atol=1e-6)
    assert float(out["fused"][2]) == float(out["xla"][2])
    assert fused_ppo.fused.grads_stats_launches == 0
