"""Operations and bytes of the fused PPO update's kernels (K2 values and
GAE, K3 gradients and statistics, K4 clip, Adam and staging) for one call
at a horizon T and batch B, from booster_gym_torch/prof_update.py's
update_work as it stood when the benchmark was written: each input read
once, each output written once, a multiply-add 2 operations."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class Nets:
    """The actor-critic's widths: actor [obs, h1, h2, h3, act], critic
    [obs + priv, h1, h2, h3, 1]; bf16 products or f32."""
    actor: tuple
    critic: tuple
    bf16: bool

    @property
    def n_params(self):
        mlp = lambda d: sum(a * b + b for a, b in zip(d[:-1], d[1:]))
        return mlp(self.actor) + mlp(self.critic) + self.actor[-1]


def nets(cfg):
    """Nets of a task config (algo/networks.py's widths)."""
    e = cfg["env"]
    no, npriv, na = e["num_observations"], e["num_privileged_obs"], e["num_actions"]
    bf16 = cfg["algorithm"].get("compute_dtype", "bf16") == "bf16"
    return Nets((no, 256, 128, 128, na), (no + npriv, 256, 256, 128, 1), bf16)


def work(nets, T, B):
    """{"gae" | "grads_stats" | "opt_stage": (bytes, operations)} of one call."""
    n, rows = T * B, (T + 1) * B
    ct = 2 if nets.bf16 else 4
    macs = {k: [i * o for i, o in zip(d[:-1], d[1:])]
            for k, d in (("actor", nets.actor), ("critic", nets.critic))}
    n_net = {k: sum(m) + sum(d[1:]) for k, m, d in (("actor", macs["actor"], nets.actor),
                                                    ("critic", macs["critic"], nets.critic))}
    na, nc = nets.actor[-1], nets.critic[0]
    P = nets.n_params
    grad_ops = n * 2 * sum(3 * sum(m) - m[0] for m in macs.values())
    grad_in = n * nc * ct + n * na * 4 + P * ct + na * 4
    return {
        "gae": (rows * nc * ct + 3 * n * 4 + n_net["critic"] * ct + 2 * n * 4 + 8,
                rows * 2 * sum(macs["critic"])),
        "grads_stats": (grad_in + 3 * n * 4 + n * na * 4 + 8 + P * 4 + (4 + na) * 4
                        + n * na * 4 + n * 4, grad_ops),
        "opt_stage": (P * (4 * 4 + 3 * 4 + ct) + 4, P * 20),
    }
