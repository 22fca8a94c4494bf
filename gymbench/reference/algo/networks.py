"""Actor-critic networks (a frozen copy of booster_gym_torch/algo/networks.py).

Actor MLP 256-128-128 -> num_act with ELU and a state-independent logstd
(init -2.0); asymmetric critic 256-256-128 -> 1 on [obs || privileged].
Weights and biases start U(-1/sqrt(fan_in), 1/sqrt(fan_in)).

compute_dtype "bf16" follows flax Dense(dtype=bf16, param_dtype=f32):
inputs and weights cast to bf16, the product accumulated in f32 and
rounded to bf16, then the bf16 bias added, ELU in bf16, the output cast
to f32.  Parameters stay f32.

MLP.quant, when set to an 8-bit float type, quantizes each product's
inputs (per tensor, scaled to the type's largest value) and passes the
gradient straight through: the same network computed in fp8, the
comparison's control.
"""

import math

import torch
from torch import nn


class MLP(nn.Module):
    def __init__(self, in_dim, features, out_dim, compute_dtype="bf16"):
        super().__init__()
        dims = [in_dim, *features, out_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.dtype = torch.bfloat16 if compute_dtype == "bf16" else torch.float32
        self.quant = None

    def _q(self, t):
        if self.quant is None:
            return t
        scale = t.detach().abs().amax().clamp(min=1e-30) / torch.finfo(self.quant).max
        q = (t.detach() / scale).to(self.quant).to(t.dtype) * scale
        return t + (q - t).detach()

    def forward(self, x):
        x = x.to(self.dtype)
        for i, layer in enumerate(self.layers):
            # product rounded to the compute dtype before the bias add
            x = (torch.matmul(self._q(x), self._q(layer.weight.to(self.dtype)).T)
                 + layer.bias.to(self.dtype))
            if i + 1 < len(self.layers):
                x = nn.functional.elu(x)
        return x.float()


class ActorCritic(nn.Module):
    def __init__(self, num_act, num_obs, num_privileged_obs, compute_dtype="bf16",
                 init_logstd=-2.0):
        super().__init__()
        self.actor = MLP(num_obs, (256, 128, 128), num_act, compute_dtype)
        self.critic = MLP(num_obs + num_privileged_obs, (256, 256, 128), 1, compute_dtype)
        self.logstd = nn.Parameter(torch.full((1, num_act), float(init_logstd)))

    @torch.no_grad()
    def reset_parameters(self, gen):
        """torch.nn.Linear's init distribution, drawn from `gen`."""
        for mlp in (self.actor, self.critic):
            for layer in mlp.layers:
                bound = 1.0 / math.sqrt(layer.in_features)
                nn.init.uniform_(layer.weight, -bound, bound, generator=gen)
                nn.init.uniform_(layer.bias, -bound, bound, generator=gen)

    def act(self, obs):
        """Action distribution (mu, std)."""
        mu = self.actor(obs)
        return mu, torch.exp(self.logstd).expand_as(mu)

    def est_value(self, obs, privileged_obs):
        return self.critic(torch.cat([obs, privileged_obs], dim=-1))[..., 0]


def normal_log_prob(mu, std, x):
    """Diagonal-normal log density summed over the action dims."""
    lp = -0.5 * torch.square(x - mu) / (std * std) - torch.log(std) - 0.5 * math.log(2.0 * math.pi)
    return torch.sum(lp, dim=-1)


def normal_entropy(std):
    return torch.sum(0.5 + 0.5 * math.log(2.0 * math.pi) + torch.log(std), dim=-1)


def normal_kl(mu_old, std_old, mu_new, std_new):
    """Analytic KL(old || new) summed over the action dims."""
    return torch.sum(
        torch.log(std_new / std_old)
        + 0.5 * (torch.square(std_old) + torch.square(mu_new - mu_old)) / torch.square(std_new)
        - 0.5, dim=-1)
