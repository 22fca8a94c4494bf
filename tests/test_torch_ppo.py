"""The port's actor-critic and xla-path PPO update against the JAX package
(the fused update is in tests/test_torch_update.py).

Tolerances: f32 forward 1e-5 (same products, other summation order);
bf16 forward one bf16 ulp, 8e-3 relative (both round each layer's product
to bf16, and a different f32 summation order can land one ulp apart); the
update compares parameters to rtol 1e-4 / atol 1e-6 and the loss
statistics to rtol 1e-4, f32 compute; the bf16 gradient of the update's
first mini-epoch agrees to 2.5 bf16 ulps (2.5 * 2^-8) of its norm.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from booster_gym_tpu.algo.networks import ActorCritic as JaxActorCritic
from booster_gym_tpu.algo.ppo import PPO as JaxPPO, discount_values as jax_discount_values
from booster_gym_tpu.utils.config import load_task_cfg as jax_load_task_cfg

from booster_gym_torch.algo.networks import ActorCritic
from booster_gym_torch.algo.ppo import (
    PPO,
    OptState,
    discount_values,
    flat_params,
    jax_clip,
)
from booster_gym_torch.convert import flat_from_flax, params_from_flax

NA, NO, NP = 12, 47, 14
ENV = types.SimpleNamespace(num_actions=NA, num_obs=NO, num_privileged_obs=NP)


def host(tree):
    return jax.tree.map(np.asarray, tree)


def flat_like_torch(net, tree):
    return flat_from_flax(net, host(tree))


def nets(dtype):
    jnet = JaxActorCritic(NA, NO, NP, compute_dtype=dtype)
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, NO)), jnp.zeros((1, NP)))
    tnet = ActorCritic(NA, NO, NP, compute_dtype=dtype)
    tnet.load_state_dict(params_from_flax(host(params)))
    return jnet, params, tnet


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 8e-3)])
def test_actor_critic_forward_matches_flax(dtype, tol):
    jnet, params, tnet = nets(dtype)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(64, NO)).astype(np.float32)
    priv = rng.normal(size=(64, NP)).astype(np.float32)
    mu_j, std_j = jnet.apply(params, jnp.asarray(obs), method=JaxActorCritic.act)
    v_j = jnet.apply(params, jnp.asarray(obs), jnp.asarray(priv),
                     method=JaxActorCritic.est_value)
    with torch.no_grad():
        mu_t, std_t = tnet.act(torch.as_tensor(obs))
        v_t = tnet.est_value(torch.as_tensor(obs), torch.as_tensor(priv))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=tol, atol=tol)
    np.testing.assert_allclose(std_t.numpy(), np.asarray(std_j), rtol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=tol, atol=tol)
    assert mu_t.dtype == torch.float32 and v_t.shape == (64,)


def test_init_distribution_and_logstd():
    net = ActorCritic(NA, NO, NP)
    net.reset_parameters(torch.Generator().manual_seed(0))
    w = net.critic.layers[1].weight.detach()
    bound = 1 / np.sqrt(256)
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.95 * bound
    np.testing.assert_allclose(net.logstd.detach().numpy(), -2.0)


def test_discount_values_matches_jax():
    rng = np.random.default_rng(1)
    T, B = 24, 16
    rew = rng.normal(size=(T, B)).astype(np.float32)
    done = rng.random((T, B)) < 0.1
    val = rng.normal(size=(T, B)).astype(np.float32)
    last = rng.normal(size=B).astype(np.float32)
    ours = discount_values(*map(torch.as_tensor, (rew, done, val, last)), 0.995, 0.95)
    ref = jax_discount_values(*map(jnp.asarray, (rew, done, val, last)), 0.995, 0.95)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_tie_rule_matches_jax():
    """JAX gives each side half the gradient at exact ties of maximum, and
    jnp.clip (maximum then minimum) half at its bounds.  torch.maximum
    splits ties the same way; torch.clamp does not, hence jax_clip."""
    x = np.array([0.8, 1.0, 1.2, 0.5, 1.5], np.float32)
    g_clip = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.8, 1.2)))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    jax_clip(t, 0.8, 1.2).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(g_clip))
    assert float(t.grad[0]) == 0.5
    t2 = torch.tensor(x, requires_grad=True)
    torch.clamp(t2, 0.8, 1.2).sum().backward()
    assert float(t2.grad[0]) == 1.0   # why the port writes the clip out

    # the clipped surrogate at ratio == 1, where surr == surr_clipped exactly
    rng = np.random.default_rng(2)
    adv = rng.normal(size=32).astype(np.float32)
    logp = rng.normal(size=32).astype(np.float32)

    def jloss(lp):
        ratio = jnp.exp(lp - jnp.asarray(logp))
        surr = -jnp.asarray(adv) * ratio
        return jnp.mean(jnp.maximum(surr, -jnp.asarray(adv) * jnp.clip(ratio, 0.8, 1.2)))

    g_j = jax.grad(jloss)(jnp.asarray(logp))
    lp = torch.tensor(logp, requires_grad=True)
    ratio = torch.exp(lp - torch.as_tensor(logp))
    assert bool((ratio == 1.0).all())
    a = torch.as_tensor(adv)
    torch.mean(torch.maximum(-a * ratio, -a * jax_clip(ratio, 0.8, 1.2))).backward()
    np.testing.assert_allclose(lp.grad.numpy(), np.asarray(g_j), rtol=1e-6, atol=1e-9)


def jax_ppo(mini_epochs=3, compute_dtype="f32", **algo):
    cfg = jax_load_task_cfg("T1")
    cfg["algorithm"].update(update_backend="xla", compute_dtype=compute_dtype, **algo)
    cfg["runner"]["mini_epochs"] = mini_epochs
    return cfg, JaxPPO(ENV, cfg)


def rollout_buffers(jnet, params, rng, T=6, B=16):
    """A rollout's buffers (obs, priv, act, mu, std, rew, done, timeout)
    with actions drawn from the JAX policy, and the last obs/priv."""
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    obs, priv = f32(T, B, NO), f32(T, B, NP)
    obs_last, priv_last = f32(B, NO), f32(B, NP)
    mu, std = jnet.apply(params, jnp.asarray(obs), method=JaxActorCritic.act)
    mu, std = np.asarray(mu), np.asarray(std)
    act = (mu + std * f32(T, B, NA)).astype(np.float32)
    rew = f32(T, B)
    done = rng.random((T, B)) < 0.1
    timeout = rng.random((T, B)) < 0.1
    return (obs, priv, act, mu, std, rew, done, timeout), obs_last, priv_last


def first_epoch_gradient(compute_dtype, jax_dtype="bf16"):
    """The flat gradient of one xla-path mini-epoch on each side, from the
    same params and buffers: (port's, JAX's).  Both read it back from
    Adam's first moment: with m0 = 0 and the clip out of reach
    (grad_norm_clip 1e30), m1 = (1 - b1) g."""
    cfg, jppo = jax_ppo(mini_epochs=1, compute_dtype=jax_dtype, grad_norm_clip=1e30)
    tcfg, _ = jax_ppo(mini_epochs=1, compute_dtype=compute_dtype, grad_norm_clip=1e30)
    tppo = PPO(ENV, tcfg, "cpu")
    jnet = jppo.network
    params = jnet.init(jax.random.PRNGKey(2), jnp.zeros((1, NO)), jnp.zeros((1, NP)))
    buf, obs_last, priv_last = rollout_buffers(jnet, params, np.random.default_rng(4))
    jts = types.SimpleNamespace(params=params, opt_state=jppo.tx.init(params),
                                lr=jnp.float32(1e-3))
    carry = (None, jnp.asarray(obs_last), jnp.asarray(priv_last)) + (None,) * 6
    (_, opt_j, _), _ = jppo.update(jts, carry, tuple(map(jnp.asarray, buf)))

    net = tppo.network
    net.load_state_dict(params_from_flax(host(params)))
    n = flat_params(net).numel()
    tts = types.SimpleNamespace(opt=OptState(m=torch.zeros(n), v=torch.zeros(n), count=0),
                                lr=torch.tensor(1e-3))
    opt_t, _, _ = tppo.update(
        tts, (None, torch.as_tensor(obs_last), torch.as_tensor(priv_last)),
        tuple(torch.as_tensor(np.array(x)) for x in buf))
    b1 = tppo.adam_b1
    return opt_t.m / (1 - b1), flat_like_torch(net, opt_j[1].inner_state[0].mu) / (1 - b1)


def test_bf16_gradient_matches_jax_xla_loss():
    """The main path trains at bf16 (T1.yaml sets no compute_dtype).  The
    first mini-epoch's gradient, before clip and Adam, against jax.grad of
    the JAX xla loss at bf16.  Each side rounds to bf16 at the same places,
    and a different f32 summation order lands some products one ulp apart,
    so they agree to 2.5 bf16 ulps of the gradient norm.  The f32 network's
    gradient lies outside that bound, so the check sees the bf16 rounding."""
    tol = 2.5 * 2.0 ** -8
    g_t, g_j = first_epoch_gradient("bf16")
    err = float((g_t - g_j).norm() / g_j.norm())
    assert err <= tol, err
    g_f32, _ = first_epoch_gradient("f32")
    assert float((g_f32 - g_j).norm() / g_j.norm()) > tol


def test_flat_adam_matches_optax():
    cfg, jppo = jax_ppo()
    tppo = PPO(ENV, cfg, "cpu")
    params = jppo.network.init(jax.random.PRNGKey(1), jnp.zeros((1, NO)), jnp.zeros((1, NP)))
    rng = np.random.default_rng(3)
    rand = lambda scale: jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape) * scale, jnp.float32), params)
    grads, mu = rand(0.3), rand(1e-2)
    nu = jax.tree.map(jnp.abs, rand(1e-3))
    clip_state, inj = jppo.tx.init(params)
    adam, rest = inj.inner_state
    state = (clip_state, inj._replace(count=jnp.int32(4), inner_state=(
        adam._replace(count=jnp.int32(4), mu=mu, nu=nu), rest)))
    updates, _ = jppo.tx.update(grads, state, params)
    ref = jax.tree.map(lambda p, u: p + u, params, updates)

    net = tppo.network
    net.load_state_dict(params_from_flax(host(params)))
    p2, *_ = tppo.flat_adam(flat_like_torch(net, grads), flat_params(net),
                            flat_like_torch(net, mu), flat_like_torch(net, nu), 4,
                            torch.tensor(cfg["algorithm"]["learning_rate"]))
    np.testing.assert_allclose(p2.numpy(), flat_like_torch(net, ref).numpy(),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("min_logstd", [None, -1.9])
def test_update_matches_jax_xla_update(min_logstd):
    """Three mini-epochs from the same params, Adam state and rollout
    buffers: parameters, per-epoch loss statistics, KL and learning rate."""
    extra = {} if min_logstd is None else {"min_logstd": min_logstd}
    cfg, jppo = jax_ppo(**extra)
    tppo = PPO(ENV, cfg, "cpu")
    jnet = jppo.network
    params = jnet.init(jax.random.PRNGKey(2), jnp.zeros((1, NO)), jnp.zeros((1, NP)))
    rng = np.random.default_rng(4)
    buf, obs_last, priv_last = rollout_buffers(jnet, params, rng)
    rand_tree = lambda scale: jax.tree.map(
        lambda p: jnp.asarray(np.abs(rng.normal(size=p.shape)) * scale, jnp.float32), params)
    m0, v0 = rand_tree(1e-3), rand_tree(1e-5)
    clip_state, inj = jppo.tx.init(params)
    adam, rest = inj.inner_state
    opt_state = (clip_state, inj._replace(count=jnp.int32(7), inner_state=(
        adam._replace(count=jnp.int32(7), mu=m0, nu=v0), rest)))
    lr0 = 1e-3
    jts = types.SimpleNamespace(params=params, opt_state=opt_state, lr=jnp.float32(lr0))
    carry = (None, jnp.asarray(obs_last), jnp.asarray(priv_last)) + (None,) * 6
    (p_j, _, lr_j), stats_j = jppo.update(jts, carry, tuple(map(jnp.asarray, buf)))

    net = tppo.network
    net.load_state_dict(params_from_flax(host(params)))
    tts = types.SimpleNamespace(
        opt=OptState(m=flat_like_torch(net, m0), v=flat_like_torch(net, v0), count=7),
        lr=torch.tensor(lr0))
    opt_t, lr_t, stats_t = tppo.update(
        tts, (None, torch.as_tensor(obs_last), torch.as_tensor(priv_last)),
        tuple(torch.as_tensor(np.array(x)) for x in buf))

    np.testing.assert_allclose(flat_params(net).numpy(), flat_like_torch(net, p_j).numpy(),
                               rtol=1e-4, atol=1e-6)
    names = ("value_loss", "actor_loss", "bound_loss", "entropy", "kl_mean")
    for i, name in enumerate(names):
        np.testing.assert_allclose(stats_t[:, i].numpy(), np.asarray(stats_j[i]),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(float(lr_t), float(lr_j), rtol=1e-6)
    assert float(lr_t) != lr0     # the KL rule moved it
    assert opt_t.count == 7 + 3
    if min_logstd is not None:
        assert float(net.logstd.detach().min()) >= min_logstd


def test_update_backend_is_read_from_the_config():
    cfg = jax_load_task_cfg("T1")
    assert cfg["algorithm"]["update_backend"] == "fused"
    assert PPO(ENV, cfg, "cpu").update_backend == "fused"
    cfg["algorithm"]["update_backend"] = "pallas"
    with pytest.raises(ValueError, match="update_backend"):
        PPO(ENV, cfg, "cpu")
