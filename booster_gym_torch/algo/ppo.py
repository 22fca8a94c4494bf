"""PPO trainer (port of booster_gym_tpu/algo/ppo.py).

One train iteration is a 24-step rollout with on-device episode sums,
then the mini-epochs on the whole batch.  algorithm.update_backend picks
how a mini-epoch is computed: "fused" (the default) through the three CUDA
kernels of algo/update_kernel.py, "xla" by autograd of the loss.  Both
compute:
  * timeout rewards bootstrapped with the current value estimate;
  * GAE under no-grad by discount_values;
  * advantages normalized with the Bessel-corrected std;
  * clipped surrogate (clip 0.2), bound loss on the action mean at +-1,
    entropy bonus through entropy_coef;
  * global-norm clip and Adam with optax's exact formulas on one flat
    vector (the JAX package's _flat_adam), then the optional min_logstd
    clamp;
  * analytic-KL adaptive learning rate x/÷1.5 within [1e-5, 1e-2].
algorithm.init_logstd, min_logstd and bound_coef are read as the JAX
package reads them (the standup configs set -1, -2 and 0.2).
algorithm.update_tile, the JAX update kernel's VMEM row tile, may stand
in a config and is ignored: the CUDA kernels pick their tiles from the
widths.

Subgradients at exact ties follow JAX: jnp.maximum and jnp.minimum give
each side half the gradient, and jnp.clip is maximum-then-minimum, so a
ratio sitting exactly on a clip bound passes half its gradient.
torch.maximum splits ties the same way; torch.clamp passes the whole
gradient at its bounds, so the surrogate's clip is written out as
jax_clip().  The fused kernels carry the same rules in their own backward.

Data parallelism (booster_gym_torch/parallel): the env's Group says which
rows of the global batch this rank holds.  The rollout noise is the global
batch's draw, sliced.  The ranks meet where the JAX package reduces over
its "dp" axis, and nowhere else: per fused mini-epoch K2's two advantage
sums (one all-reduce), then K3's gradient and metric sums packed into one
flat all-reduce, after which K4 and the KL rule run on the same values on
every rank; per xla mini-epoch the advantages' sum and squared deviation,
then the gradient with the loss terms' partial means; per iteration the
episode sums and the curriculum levels' sum (one all-reduce) and max (one).
Every mean divides by the global count.  At world size 1 there is no
collective and every operation is the single-process one.
"""

import dataclasses
import math

import torch

from booster_gym_torch.algo.networks import (
    ActorCritic,
    normal_entropy,
    normal_kl,
    normal_log_prob,
)
from booster_gym_torch.algo.update_kernel import STAT_NAMES, FusedUpdate
from booster_gym_torch.parallel import Group


def jax_clip(x, lo, hi):
    """jnp.clip's value and subgradients: min(max(x, lo), hi)."""
    lo = torch.full_like(x, lo)
    hi = torch.full_like(x, hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def discount_values(rewards, dones, values, last_values, gamma, lam):
    """GAE advantages by a reverse loop over the horizon: [T, B] -> [T, B]."""
    T = rewards.shape[0]
    advantages = torch.empty_like(rewards)
    last_adv = torch.zeros_like(last_values)
    for t in reversed(range(T)):
        next_val = last_values if t == T - 1 else values[t + 1]
        nonterminal = 1.0 - dones[t].to(rewards.dtype)
        delta = rewards[t] + gamma * nonterminal * next_val - values[t]
        last_adv = delta + gamma * lam * nonterminal * last_adv
        advantages[t] = last_adv
    return advantages


@dataclasses.dataclass
class OptState:
    """Adam moments on the flat parameter vector (ActorCritic parameter
    order) and optax's step count."""

    m: torch.Tensor
    v: torch.Tensor
    count: int


@dataclasses.dataclass
class TrainState:
    opt: OptState
    lr: torch.Tensor              # 0-dim, on device (changed on device by the KL rule)
    env_state: object
    obs: torch.Tensor
    privileged_obs: torch.Tensor
    episode_sums: dict
    episode_steps: torch.Tensor
    iteration: int


def flat_params(network):
    return torch.cat([p.detach().reshape(-1) for p in network.parameters()])


def set_flat_params(network, flat):
    i = 0
    with torch.no_grad():
        for p in network.parameters():
            n = p.numel()
            p.copy_(flat[i:i + n].view_as(p))
            i += n


class PPO:
    def __init__(self, env, cfg, device):
        self.env = env
        self.cfg = cfg
        self.device = torch.device(device)
        # the env's data-parallel group; a stand-in env without one is a
        # whole batch in this one process
        self.group = getattr(env, "group", None) or Group(getattr(env, "num_envs", 1),
                                                         self.device)
        acfg = cfg["algorithm"]
        self.update_backend = acfg.get("update_backend", "fused")
        if self.update_backend not in ("fused", "xla"):
            raise ValueError(f"unknown update_backend {self.update_backend!r}")
        self.gamma = acfg["gamma"]
        self.lam = acfg["lam"]
        self.clip_ratio = acfg.get("clip_ratio", 0.2)
        self.bound_coef = acfg["bound_coef"]
        self.entropy_coef = acfg["entropy_coef"]
        self.desired_kl = acfg["desired_kl"]
        self.base_lr = acfg["learning_rate"]
        self.horizon = cfg["runner"]["horizon_length"]
        self.mini_epochs = cfg["runner"]["mini_epochs"]
        self.min_logstd = acfg.get("min_logstd")
        self.grad_norm_clip = acfg.get("grad_norm_clip", 1.0)
        self.adam_b1, self.adam_b2, self.adam_eps = 0.9, 0.999, 1e-8
        self.network = ActorCritic(
            env.num_actions, env.num_obs, env.num_privileged_obs,
            compute_dtype=acfg.get("compute_dtype", "bf16"),
            init_logstd=acfg.get("init_logstd", -2.0)).to(self.device)
        self.fused = FusedUpdate(self.network, clip_ratio=self.clip_ratio,
                                 bound_coef=self.bound_coef)
        self._logstd_slice = self.fused.logstd_slice

    # -- optimizer --------------------------------------------------------
    def flat_adam(self, g, p, m, v, cnt, lr):
        """clip_by_global_norm + Adam on flat vectors, optax's formulas:
        returns (p', m', v', cnt')."""
        b1, b2, eps = self.adam_b1, self.adam_b2, self.adam_eps
        g_norm = torch.sqrt(torch.sum(torch.square(g)))
        g = torch.where(g_norm < self.grad_norm_clip, g, (g / g_norm) * self.grad_norm_clip)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * torch.square(g)
        cnt = cnt + 1
        m_hat = m / (1.0 - b1 ** cnt)
        v_hat = v / (1.0 - b2 ** cnt)
        return p + (-lr) * (m_hat / (torch.sqrt(v_hat) + eps)), m, v, cnt

    def _adapt_lr(self, lr, kl_mean):
        return torch.where(
            kl_mean > self.desired_kl * 2.0, torch.clamp(lr / 1.5, min=1e-5),
            torch.where(kl_mean < self.desired_kl / 2.0, torch.clamp(lr * 1.5, max=1e-2), lr))

    # -- init -------------------------------------------------------------
    def init(self, gen):
        """(env_params, TrainState) with the network initialized from gen."""
        env_params = self.env.init_params(gen)
        env_state, obs, info = self.env.reset_all(env_params, gen)
        self.network.reset_parameters(gen)
        n = flat_params(self.network).numel()
        B = self.env.num_envs
        zeros = lambda: torch.zeros(B, device=self.device)
        episode_sums = {"reward": zeros(), **{k: zeros() for k in self.env.reward_scales}}
        ts = TrainState(
            opt=OptState(m=torch.zeros(n, device=self.device),
                         v=torch.zeros(n, device=self.device), count=0),
            lr=torch.tensor(self.base_lr, dtype=torch.float32, device=self.device),
            env_state=env_state, obs=obs, privileged_obs=info["privileged_obs"],
            episode_sums=episode_sums,
            episode_steps=torch.zeros(B, dtype=torch.int64, device=self.device),
            iteration=0)
        return env_params, ts

    # -- rollout ----------------------------------------------------------
    @torch.no_grad()
    def rollout(self, env_params, ts, gen):
        """Horizon loop with on-device episode statistics.  Returns (carry,
        buffers), the JAX package's rollout scan outputs."""
        env_state, obs, priv = ts.env_state, ts.obs, ts.privileged_obs
        ep_sums, ep_steps = dict(ts.episode_sums), ts.episode_steps
        fin_sums = {k: torch.zeros((), device=self.device) for k in ep_sums}
        fin_cnt = torch.zeros((), device=self.device)
        fin_steps = torch.zeros((), device=self.device)
        bufs = [[] for _ in range(8)]
        for _ in range(self.horizon):
            mu, std = self.network.act(obs)
            act = mu + std * self.group.draw(torch.randn, gen, mu.shape, device=self.device)
            env_state, obs2, rew, done, info = self.env.step(env_params, env_state, act, gen)
            d = done.float()
            ep_steps = ep_steps + 1
            for name, val in {"reward": rew, **info["rew_terms"]}.items():
                s = ep_sums[name] + val
                fin_sums[name] = fin_sums[name] + torch.sum(s * d)
                # where(), not s * (1 - d): a non-finite sum must not survive a reset
                ep_sums[name] = torch.where(done, 0.0, s)
            fin_cnt = fin_cnt + torch.sum(d)
            fin_steps = fin_steps + torch.sum(ep_steps * done)
            ep_steps = ep_steps * (~done)
            for b, x in zip(bufs, (obs, priv, act, mu, std, rew, done, info["time_outs"])):
                b.append(x)
            obs, priv = obs2, info["privileged_obs"]
        carry = (env_state, obs, priv, ep_sums, ep_steps, fin_sums, fin_cnt, fin_steps)
        return carry, tuple(torch.stack(b) for b in bufs)

    # -- update -----------------------------------------------------------
    def update(self, ts, carry, buf):
        """The mini-epochs on a rollout's buffers.  Updates the network in
        place; returns (OptState, lr, per-epoch stats [mini_epochs] each of
        value_loss, actor_loss, bound_loss, entropy, kl_mean)."""
        if self.update_backend == "fused":
            return self._update_fused(ts, carry, buf)
        obs_last, priv_last = carry[1], carry[2]
        obs_buf, priv_buf, act_buf, mu_buf, std_buf, rew_buf, done_buf, timeout_buf = buf
        net = self.network
        params = list(net.parameters())
        old_logp = normal_log_prob(mu_buf, std_buf, act_buf)
        dones = done_buf | timeout_buf
        p = flat_params(net)
        m, v, cnt, lr = ts.opt.m, ts.opt.v, ts.opt.count, ts.lr
        mean = self._mean
        stats = []
        for _ in range(self.mini_epochs):
            mu, std = net.act(obs_buf)
            values = net.est_value(obs_buf, priv_buf)
            with torch.no_grad():
                vd = values.detach()
                lvd = net.est_value(obs_last, priv_last)
                rwd = torch.where(timeout_buf, vd, rew_buf)
                adv = discount_values(rwd, dones, vd, lvd, self.gamma, self.lam)
                returns = vd + adv
                adv = self._normalize(adv)

            value_loss = mean(torch.square(values - returns))
            ratio = torch.exp(normal_log_prob(mu, std, act_buf) - old_logp)
            surr = -adv * ratio
            surr_clipped = -adv * jax_clip(ratio, 1.0 - self.clip_ratio, 1.0 + self.clip_ratio)
            actor_loss = mean(torch.maximum(surr, surr_clipped))
            bound_loss = (mean(torch.square(torch.clamp(mu - 1.0, min=0.0)))
                          + mean(torch.square(torch.clamp(mu + 1.0, max=0.0))))
            entropy = mean(normal_entropy(std))
            loss = (value_loss + actor_loss + self.bound_coef * bound_loss
                    + self.entropy_coef * entropy)
            grads = torch.autograd.grad(loss, params)
            g = torch.cat([x.reshape(-1) for x in grads])
            with torch.no_grad():
                kl_mean = mean(normal_kl(mu_buf, std_buf, mu, std))
                st = torch.stack([value_loss, actor_loss, bound_loss, entropy, kl_mean]).detach()
            if self.group.world > 1:
                # the ranks' gradients and partial means, summed in one
                flat = self.group.all_reduce(torch.cat([g, st]))
                g, st = flat[:-5], flat[-5:]
                kl_mean = st[4]
            p, m, v, cnt = self.flat_adam(g, p, m, v, cnt, lr)
            if self.min_logstd is not None:
                p = p.clone()
                p[self._logstd_slice] = torch.clamp(p[self._logstd_slice], min=self.min_logstd)
            set_flat_params(net, p)

            with torch.no_grad():
                lr = self._adapt_lr(lr, kl_mean)
                stats.append(st)
        return OptState(m=m, v=v, count=cnt), lr, torch.stack(stats)

    def _mean(self, x):
        """torch.mean at world size 1; over several ranks this rank's part
        of the global mean (its sum over the global count), which the
        all-reduce of the update completes."""
        if self.group.world == 1:
            return torch.mean(x)
        return torch.sum(x) / (x.numel() * self.group.world)

    def _normalize(self, adv):
        """Advantages less their mean over the global batch, over their
        Bessel-corrected std plus 1e-8 (two passes, as torch.std)."""
        if self.group.world == 1:
            return (adv - adv.mean()) / (torch.std(adv) + 1e-8)
        n = adv.numel() * self.group.world
        mu = self.group.all_reduce(adv.sum().reshape(1)) / n
        var = self.group.all_reduce(torch.square(adv - mu).sum().reshape(1)) / (n - 1)
        return (adv - mu) / (torch.sqrt(var) + 1e-8)

    @torch.no_grad()
    def _update_fused(self, ts, carry, buf):
        """update() through the fused kernels.  Per mini-epoch: K2 (values,
        GAE, advantage sums), the mean and rstd of the advantages, K3
        (gradients and metric sums), the loss statistics from the sums, K4
        (clip, Adam, staged weights), the logstd clamp, the KL rule.
        Nothing in the loop reads a device value on the host."""
        obs_last, priv_last = carry[1], carry[2]
        obs_buf, priv_buf, act_buf, mu_buf, std_buf, rew_buf, done_buf, timeout_buf = buf
        fused, net = self.fused, self.network
        T, B = rew_buf.shape
        N, na = T * B * self.group.world, fused.num_act     # the global row count
        # epoch-invariant inputs, built once
        nonterm = 1.0 - (done_buf | timeout_buf).float()
        timeout_f = timeout_buf.float()
        prep = fused.prepare(obs_buf, priv_buf, act_buf, mu_buf,
                             normal_log_prob(mu_buf, std_buf, act_buf), obs_last, priv_last)
        std_old = std_buf[0, 0]                          # state-independent
        p = flat_params(net)
        m, v, cnt, lr = ts.opt.m, ts.opt.v, ts.opt.count, ts.lr
        staged = fused.stage(p)
        stats = []
        for epoch in range(self.mini_epochs):
            adv_raw, returns, s_a, s_a2 = fused.gae(
                staged, prep["obsc"], rew_buf, nonterm, timeout_f, self.gamma, self.lam)
            if self.group.world > 1:
                s_a, s_a2 = self.group.all_reduce(torch.stack([s_a, s_a2])).unbind()
            # Bessel-corrected std from the one-pass sums; K3 normalizes
            mean = s_a / N
            var = (s_a2 - N * mean * mean) / (N - 1)
            rstd = 1.0 / (torch.sqrt(torch.clamp(var, min=0.0)) + 1e-8)
            # epoch 0: K3's own forward is the old policy, kept for the rest
            g, st, mu_out, logp_out = fused.grads_stats(
                staged, p, prep, adv_raw, returns, mean, rstd, self_old=epoch == 0, n_total=N)
            if self.group.world > 1:
                # the gradient and the metric sums over the ranks, in one;
                # K4 and the KL rule then run on the same bits on every rank
                flat = self.group.all_reduce(torch.cat(
                    [g, torch.stack([st[k] for k in STAT_NAMES]), st["klsq"]]))
                g, sums = flat[:fused.n_params], flat[fused.n_params:]
                st = {**dict(zip(STAT_NAMES, sums.unbind())), "klsq": sums[len(STAT_NAMES):]}
            if epoch == 0:
                prep = {**prep, "mu_old": mu_out, "old_logp": logp_out}

            logstd = p[self._logstd_slice]
            std = torch.exp(logstd)
            value_loss = st["vl"] / N
            actor_loss = st["al"] / N
            bound_loss = st["bhi"] / (N * na) + st["blo"] / (N * na)
            entropy = torch.sum(0.5 + 0.5 * math.log(2.0 * math.pi) + logstd)
            # analytic KL against the rollout policy: per-dim constants plus
            # K3's sums of (mu_new - mu_old)^2
            kl_mean = (torch.sum(torch.log(std / std_old)
                                 + 0.5 * torch.square(std_old) / torch.square(std) - 0.5)
                       + 0.5 * torch.sum(st["klsq"] / (N * torch.square(std))))
            stats.append(torch.stack([value_loss, actor_loss, bound_loss, entropy, kl_mean]))

            p, m, v, staged = fused.opt_stage(
                g, p, m, v, cnt, lr, entropy_coef=self.entropy_coef, b1=self.adam_b1,
                b2=self.adam_b2, eps=self.adam_eps, max_norm=self.grad_norm_clip)
            if self.min_logstd is not None:
                # K3 reads logstd from p, so the clamped value is what the
                # next mini-epoch sees
                p[self._logstd_slice].clamp_(min=self.min_logstd)
            cnt = min(cnt + 1, 2 ** 31 - 1)
            lr = self._adapt_lr(lr, kl_mean)
        set_flat_params(net, p)
        return OptState(m=m, v=v, count=cnt), lr, torch.stack(stats)

    # -- one iteration ----------------------------------------------------
    def train_iteration(self, env_params, ts, gen, timer=None):
        """Rollout + update.  Returns (TrainState, metrics of 0-dim
        tensors).  `timer`, when given, is called as timer("rollout") before
        the rollout, timer("update") between the phases and timer("end")
        after the update."""
        if timer:
            timer("rollout")
        carry, buf = self.rollout(env_params, ts, gen)
        if timer:
            timer("update")
        env_state, obs_last, priv_last, ep_sums, ep_steps, fin_sums, fin_cnt, fin_steps = carry
        opt, lr, stats = self.update(ts, carry, buf)
        if timer:
            timer("end")
        value_loss, actor_loss, bound_loss, entropy, kl_mean = stats.unbind(1)
        fin_sums, fin_cnt, fin_steps, level_mean, level_max = self._episode_stats(
            fin_sums, fin_cnt, fin_steps, env_state.env_curriculum_level.abs().float())
        n_ep = torch.clamp(fin_cnt, min=1.0)
        metrics = {
            "reward": fin_sums["reward"] / n_ep,
            "steps": fin_steps / n_ep,
            "episodes": fin_cnt,
            "value_loss": value_loss.mean(),
            "actor_loss": actor_loss.mean(),
            "bound_loss": bound_loss.mean(),
            "entropy": entropy.mean(),
            "kl_mean": kl_mean[-1],
            "lr": lr,
            "curriculum/mean_lin_vel_level": level_mean[0],
            "curriculum/mean_ang_vel_level": level_mean[1],
            "curriculum/max_lin_vel_level": level_max[0],
            "curriculum/max_ang_vel_level": level_max[1],
        }
        for name in self.env.reward_scales:
            metrics[f"episode/{name}"] = fin_sums[name] / n_ep
        ts = TrainState(opt=opt, lr=lr, env_state=env_state, obs=obs_last,
                        privileged_obs=priv_last, episode_sums=ep_sums, episode_steps=ep_steps,
                        iteration=ts.iteration + 1)
        return ts, metrics

    def _episode_stats(self, fin_sums, fin_cnt, fin_steps, levels):
        """The rollout's finished-episode sums and count and the curriculum
        levels' (lin, ang) mean and max over the global batch: over several
        ranks the sums and the levels' sums in one all-reduce, the maxima
        in one more."""
        if self.group.world == 1:
            return (fin_sums, fin_cnt, fin_steps, (levels[:, 0].mean(), levels[:, 1].mean()),
                    (levels[:, 0].max(), levels[:, 1].max()))
        names = list(fin_sums)
        sums = self.group.all_reduce(torch.stack(
            [fin_cnt, fin_steps, *(fin_sums[k] for k in names), *levels.sum(0)]))
        level_max = self.group.all_reduce(levels.max(0).values.contiguous(), op="max")
        return (dict(zip(names, sums[2:-2].unbind())), sums[0], sums[1],
                (sums[-2:] / self.group.num_envs).unbind(), level_max.unbind())
