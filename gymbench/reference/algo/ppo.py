"""The PPO update in plain PyTorch: a frozen copy of the autograd ("xla")
update of booster_gym_torch/algo/ppo.py at world size 1.  Per mini-epoch:
the actor and critic on the whole batch, GAE under no-grad (timeouts
bootstrapped with the value estimate), advantages normalized with the
Bessel-corrected std, the clipped surrogate (jnp.clip's ties), the bound
loss, the entropy bonus, the gradient by autograd, the global-norm clip and
Adam with optax's formulas on one flat vector, then the min_logstd clamp.

The learning rate of each Adam step is given (lrs): the KL rule that sets
it is a threshold, which rounding can tip either way, so the reference
takes the rate that the program's rule chose and recomputes the rest."""

import torch

from gymbench.reference.algo.networks import normal_entropy, normal_kl, normal_log_prob


def jax_clip(x, lo, hi):
    lo = torch.full_like(x, lo)
    hi = torch.full_like(x, hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def discount_values(rewards, dones, values, last_values, gamma, lam):
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


def flat_params(network):
    return torch.cat([p.detach().reshape(-1) for p in network.parameters()])


def set_flat_params(network, flat):
    i = 0
    with torch.no_grad():
        for p in network.parameters():
            n = p.numel()
            p.copy_(flat[i:i + n].view_as(p))
            i += n


class Update:
    def __init__(self, network, cfg):
        acfg = cfg["algorithm"]
        self.network = network
        self.gamma, self.lam = acfg["gamma"], acfg["lam"]
        self.clip_ratio = acfg.get("clip_ratio", 0.2)
        self.bound_coef = acfg["bound_coef"]
        self.entropy_coef = acfg["entropy_coef"]
        self.mini_epochs = cfg["runner"]["mini_epochs"]
        self.min_logstd = acfg.get("min_logstd")
        self.grad_norm_clip = acfg.get("grad_norm_clip", 1.0)
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        off = 0
        for name, p in network.named_parameters():
            if name == "logstd":
                self.logstd_slice = slice(off, off + p.numel())
            off += p.numel()

    def flat_adam(self, g, p, m, v, cnt, lr):
        """(p', m', v', cnt', the clipped gradient)."""
        g_norm = torch.sqrt(torch.sum(torch.square(g)))
        g = torch.where(g_norm < self.grad_norm_clip, g, (g / g_norm) * self.grad_norm_clip)
        m = self.b1 * m + (1.0 - self.b1) * g
        v = self.b2 * v + (1.0 - self.b2) * torch.square(g)
        cnt = cnt + 1
        m_hat = m / (1.0 - self.b1 ** cnt)
        v_hat = v / (1.0 - self.b2 ** cnt)
        return p + (-lr) * (m_hat / (torch.sqrt(v_hat) + self.eps)), m, v, cnt, g

    def run(self, buf, obs_last, priv_last, p, m, v, cnt, lrs):
        """The first len(lrs) mini-epochs on a rollout's buffers (obs, priv,
        act, mu, std, rew, done, timeout), from the flat parameters p and
        Adam's m, v and count, the Adam steps at the rates lrs.  Returns
        (p, m, v, cnt, stats [len(lrs), 5] of value, actor and bound loss,
        entropy and KL, the first step's clipped gradient)."""
        obs_buf, priv_buf, act_buf, mu_buf, std_buf, rew_buf, done_buf, timeout_buf = buf
        net = self.network
        set_flat_params(net, p)
        params = list(net.parameters())
        old_logp = normal_log_prob(mu_buf, std_buf, act_buf)
        dones = done_buf | timeout_buf
        stats, first = [], None
        for epoch in range(len(lrs)):
            mu, std = net.act(obs_buf)
            values = net.est_value(obs_buf, priv_buf)
            with torch.no_grad():
                vd = values.detach()
                lvd = net.est_value(obs_last, priv_last)
                rwd = torch.where(timeout_buf, vd, rew_buf)
                adv = discount_values(rwd, dones, vd, lvd, self.gamma, self.lam)
                returns = vd + adv
                adv = (adv - adv.mean()) / (torch.std(adv) + 1e-8)
            value_loss = torch.mean(torch.square(values - returns))
            ratio = torch.exp(normal_log_prob(mu, std, act_buf) - old_logp)
            surr = -adv * ratio
            surr_clipped = -adv * jax_clip(ratio, 1.0 - self.clip_ratio, 1.0 + self.clip_ratio)
            actor_loss = torch.mean(torch.maximum(surr, surr_clipped))
            bound_loss = (torch.mean(torch.square(torch.clamp(mu - 1.0, min=0.0)))
                          + torch.mean(torch.square(torch.clamp(mu + 1.0, max=0.0))))
            entropy = torch.mean(normal_entropy(std))
            loss = (value_loss + actor_loss + self.bound_coef * bound_loss
                    + self.entropy_coef * entropy)
            grads = torch.autograd.grad(loss, params)
            g = torch.cat([x.reshape(-1) for x in grads])
            with torch.no_grad():
                kl_mean = torch.mean(normal_kl(mu_buf, std_buf, mu, std))
                stats.append(torch.stack([value_loss, actor_loss, bound_loss, entropy,
                                          kl_mean]).detach())
                p, m, v, cnt, g = self.flat_adam(g, p, m, v, cnt, lrs[epoch])
                if first is None:
                    first = g
                if self.min_logstd is not None:
                    p = p.clone()
                    p[self.logstd_slice] = torch.clamp(p[self.logstd_slice],
                                                       min=self.min_logstd)
                set_flat_params(net, p)
        return p, m, v, cnt, torch.stack(stats), first
