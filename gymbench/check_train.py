"""Whether a training cell's timed path computes what the plain reference
computes.

Set-up builds the runner once, drives it from the seed through its first
ITERATIONS training iterations by the window's own call
(PPO.train_iteration), and hands that same object to the window.  While
it does, Capture records what the reference needs, by wrapping three of
the runner's attributes for those iterations only: the parameters and
Adam state before the first, the first update's rollout buffers and its
losses per mini-epoch (PPO.update's stats), the rate of the first STEPS
Adam steps, the moment after the first and the parameters after the
last of them, and the inputs and outputs of a few env steps drawn from
the seed.

The physics and the env step are chaotic: contact amplifies rounding, so
the reference follows the program stage by stage from the program's own
state (reference/ in plain PyTorch, built from the configuration and the
seed, sharing no code or table with the program):

  field_gap   the height field the program generated against the
              reference's from the same seed; exact, limit 0.
  step_gap    each sampled env step (the control step, K1 or K5 with its
              epilogue, then observations, rewards, terminations and
              resets) from the program's state and action: per env the
              worst relative gap |a - b| / (1 + |b|) over the state the
              step leaves, the reward and the observations' noise-free
              columns; a termination that differs, or an observation
              noise past 8 sigma, reads OFF (1e9).  Envs that reset in both
              compare what the task's reset fixes whatever its random draws
              (the reference env's reset_terms).  The 0.9 quantile over the
              envs, then the worst sampled step.  Step 0 also holds the
              start's observations to the start's state.
  step_share  the share of envs whose gap of the step_gap measure is over
              STEP_TOL or reads OFF, at the worst sampled step: the tail
              that the quantile leaves out (a fault confined to some blocks
              of the kernel, some terrain tiles or the resets).
  done_share  the share of envs whose termination differs from the
              reference's, at the worst sampled step.
  reset_gap   the worst gap of what a reset fixes, over the envs that reset
              in both at any sampled step.
  loss_gap    the loss (value + actor + bound_coef bound + entropy_coef
              entropy) of each of the first STEPS optimizer steps (the
              first update's mini-epochs) from the program's rollout
              buffers: the worst relative gap.
  grad_gap    the first gradient as the optimizer took it (the program's
              Adam moment after one step over 1 - b1): the worst leaf's gap
              of norms over the larger of its reference norm and the
              median leaf's.
  change_gap  the parameters' change over the first STEPS optimizer
              steps, measured as grad_gap, leaving out the leaves whose
              first reference gradient is under a thousandth of the median
              leaf's (they move by Adam's round-off alone).

The rates of the Adam steps are the program's (reference/algo/ppo.py says
why).  Random draws are the program's own: the reference compares no
column that depends on them except through the noise's size.

The reference env is the config's task's (reference/envs/__init__.py's
env_class), and what is the task's own comes from it: its state and params
dataclasses, the compared state fields, the observations' noise, what a
reset fixes and the params it makes itself.  This module names no task.
"""

import dataclasses
import typing

import numpy as np
import torch

from gymbench.reference.algo.networks import ActorCritic as RefNet
from gymbench.reference.algo.ppo import Update as RefUpdate
from gymbench.reference.envs import env_class
from gymbench.reference.physics.types import SimState as RefSim

ITERATIONS = 3
STEPS = 3
STEP_QUANTILE = 0.9
STEP_TOL = 0.03
NOISE_SIGMAS = 8.0
LEAF_FLOOR = 1e-3
# what an env reads where its step cannot be compared (a termination that
# differs, an observation noise past NOISE_SIGMAS): finite, so that the
# result line stays JSON
OFF = 1e9


def clone(x):
    """A deep copy of tensors in dataclasses, dicts, lists and tuples."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: clone(getattr(x, f.name))
                                         for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(clone(v) for v in x)
    return x


def _as(cls, obj, own=None):
    """The program's dataclass `obj` as the reference's `cls`, field by
    field by name: a field whose type is a dataclass converts in turn, and
    `own` gives the fields the reference makes itself."""
    own = own or {}
    hints = typing.get_type_hints(cls)

    def field(name):
        if name in own:
            return own[name]
        value, kind = getattr(obj, name), hints.get(name)
        if value is not None and isinstance(kind, type) and dataclasses.is_dataclass(kind):
            return _as(kind, value)
        return value

    return cls(**{f.name: field(f.name) for f in dataclasses.fields(cls) if f.init})


def ref_state(ref_env, state):
    """The program's env state as the reference env's State."""
    return _as(ref_env.State, state)


def ref_params(ref_env, params):
    """The program's per-env draws (gains, friction, masses, a task's
    own such as a bank of starts) as the reference env's Params, with the
    params the reference makes itself (own_params: the terrain and the env
    origins)."""
    return _as(ref_env.Params, params, ref_env.own_params())


def flat(network):
    return torch.cat([p.detach().reshape(-1) for p in network.parameters()])


class Capture:
    """Records the first ITERATIONS iterations of a runner (see the module
    docstring).  `steps`: the indices of the env steps to keep, counted over
    those iterations' rollouts."""

    def __init__(self, runner, steps):
        self.runner, self.steps = runner, set(steps)
        self.calls = 0
        self.env_steps = {}
        self.p0 = self.opt0 = self.buf = self.last = self.stats = None
        self.lrs, self.m1, self.p_steps = [], None, None
        self.start = None

    def install(self, ts):
        ppo, env = self.runner.ppo, self.runner.env
        self.start = clone((ts.env_state, ts.obs, ts.privileged_obs))
        step, update, opt_stage = env.step, ppo.update, ppo.fused.opt_stage

        def env_step(params, state, act, gen):
            keep = self.calls in self.steps
            inputs = clone((state, act)) if keep else None
            out = step(params, state, act, gen)
            if keep:
                self.env_steps[self.calls] = (*inputs, clone(out))
            self.calls += 1
            return out

        def update_(ts, carry, buf):
            first = self.buf is None
            if first:
                self.buf, self.last = clone(buf), clone((carry[1], carry[2]))
            out = update(ts, carry, buf)
            if first:
                self.stats = clone(out[2])
            return out

        def opt_stage_(*args, **kw):
            out = opt_stage(*args, **kw)
            n = len(self.lrs)
            if n < STEPS:
                self.lrs.append(clone(args[5]))
                if n == 0:
                    self.m1 = clone(out[1])
                if n == STEPS - 1:
                    self.p_steps = clone(out[0])
            return out

        env.step, ppo.update, ppo.fused.opt_stage = env_step, update_, opt_stage_

    def before(self, ts):
        """Before the first iteration: the parameters and Adam state."""
        if self.p0 is None:
            self.p0 = flat(self.runner.ppo.network)
            self.opt0 = (clone(ts.opt.m), clone(ts.opt.v), ts.opt.count)

    def remove(self):
        """Unwrap, and let go of the runner."""
        ppo, env = self.runner.ppo, self.runner.env
        for obj, name in ((env, "step"), (ppo, "update"), (ppo.fused, "opt_stage")):
            delattr(obj, name)
        self.runner = None


def sample_steps(seed, horizon, count):
    """Env-step indices over the ITERATIONS rollouts: step 0 (the start)
    and `count - 1` more drawn from the seed."""
    rng = np.random.default_rng(seed)
    rest = rng.choice(np.arange(1, ITERATIONS * horizon), size=count - 1, replace=False)
    return sorted({0, *map(int, rest)})


# -- the env step -----------------------------------------------------------

def _rel(a, b, B):
    return ((a.float() - b.float()).abs() / (1.0 + b.float().abs())).reshape(B, -1).amax(1)


def obs_gap(ref_env, params, state, obs, priv, sigmas):
    """Per env: the noise-free columns' relative gap to the reference's
    observations of `state`, or OFF where a noise passes 8 sigma."""
    B = obs.shape[0]
    gap = torch.zeros(B, device=obs.device)
    wants = ref_env.noise_free_obs(params, ref_state(ref_env, state))
    for got, want, sig in zip((obs, priv), wants, sigmas):
        sig = torch.as_tensor(sig, device=obs.device)
        det = sig == 0
        gap = torch.maximum(gap, _rel(got[:, det], want[:, det], B))
        z = ((got[:, ~det] - want[:, ~det]).abs() / sig[~det]).amax(1)
        gap = torch.where(z > NOISE_SIGMAS, OFF, gap)
    return gap


def env_gap(ref_env, out, ref):
    """Per env: the worst relative gap between two env steps' outputs
    (state, obs, rew, done, info) from one input over sim's fields and
    `ref_env`'s STATE_FIELDS, and the gap of what a reset fixes
    (`ref_env`'s reset_terms) in the envs that reset in both, 0 elsewhere.
    An env that resets in one only reads OFF."""
    (s, _, rew, done, _), (r, _, rew_r, done_r, _) = out, ref
    B = rew.shape[0]
    keep = ~done & ~done_r
    gap = torch.zeros(B, device=rew.device)
    for name in RefSim.FIELDS:
        gap = torch.maximum(gap, _rel(getattr(s.sim, name), getattr(r.sim, name), B))
    for name in ref_env.STATE_FIELDS:
        gap = torch.maximum(gap, _rel(getattr(s, name), getattr(r, name), B))
    gap = torch.where(keep, gap, 0.0)
    both = done & done_r
    reset, pairs = ref_env.reset_terms(s, r)
    for got, want in pairs:
        reset = torch.maximum(reset, _rel(got, want, B))
    reset = torch.where(both, reset, 0.0)
    gap = torch.maximum(torch.maximum(gap, reset), _rel(rew, rew_r, B))
    return torch.where(done != done_r, OFF, gap), reset


def quantile(gap):
    return float(gap.sort().values[int(STEP_QUANTILE * (gap.numel() - 1))])


def step_numbers(steps):
    """step_gap, step_share, done_share and reset_gap of the sampled steps,
    each a (per-env gap, termination differs, reset gap) triple."""
    return {"step_gap": max(quantile(g) for g, _, _ in steps),
            "step_share": max(float((g > STEP_TOL).float().mean()) for g, _, _ in steps),
            "done_share": max(float(d.float().mean()) for _, d, _ in steps),
            "reset_gap": max(float(r.max()) for _, _, r in steps)}


# the faults a calibration plants in the program's env step, in every
# FAULT_STRIDE-th env (1 %) or in the envs that reset
FAULT_STRIDE = 100


def _where(mask, a, b):
    """`a` in the envs of `mask`, `b` elsewhere, through dataclasses."""
    if isinstance(a, torch.Tensor):
        if a.dim() == 0 or a.shape[0] != mask.shape[0]:
            return b
        return torch.where(mask.reshape(-1, *[1] * (a.dim() - 1)), a, b)
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(b, **{f.name: _where(mask, getattr(a, f.name),
                                                        getattr(b, f.name))
                                         for f in dataclasses.fields(a) if f.init})
    return b


def plant(fault, state, out):
    """The env step's output `out` from input `state` with `fault`:
    "unchanged" returns the input state, "part_unchanged" does so in 1 % of
    the envs, "done_flipped" flips 1 % of the envs' termination,
    "reset_moving" keeps the joint velocities of the envs that reset."""
    new, obs, rew, done, info = out
    B = done.shape[0]
    part = torch.arange(B, device=done.device) % FAULT_STRIDE == 0
    if fault == "unchanged":
        new = state
    elif fault == "part_unchanged":
        new = _where(part, state, new)
    elif fault == "done_flipped":
        done = done ^ part
    elif fault == "reset_moving":
        qd = torch.where(done[:, None], state.sim.qd, new.sim.qd)
        new = dataclasses.replace(new, sim=dataclasses.replace(new.sim, qd=qd))
    return new, obs, rew, done, info


# -- the update -------------------------------------------------------------

def leaf_sizes(network):
    return [p.numel() for p in network.parameters()]


def leaf_norms(x, sizes):
    return torch.stack([c.norm() for c in torch.split(x.float(), sizes)])


def norm_gap(got, want, keep=None):
    """The worst leaf's |norm(got) - norm(want)| over the larger of its
    reference norm and the median leaf's reference norm."""
    floor = want.median()
    gap = (got - want).abs() / torch.maximum(want, floor)
    if keep is not None:
        gap = gap[keep]
    return float(gap.max())


def total_loss(cfg, value, actor, bound, entropy):
    a = cfg["algorithm"]
    return value + actor + a["bound_coef"] * bound + a["entropy_coef"] * entropy


class Reference:
    """The reference's side of a training cell's check, on `device`."""

    def __init__(self, cfg, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.env = env_class(cfg)(cfg, self.device)
        e, a = cfg["env"], cfg["algorithm"]
        self.net = RefNet(e["num_actions"], e["num_observations"], e["num_privileged_obs"],
                          compute_dtype=a.get("compute_dtype", "bf16"),
                          init_logstd=a.get("init_logstd", -2.0)).to(self.device)
        self.update = RefUpdate(self.net, cfg)
        self.sigmas = self.env.obs_sigmas()
        self.sizes = leaf_sizes(self.net)

    def precision(self, control):
        """The network's products in fp8 and the physics' in TF32 for the
        control; bf16 (as configured) and f32 with TF32 off otherwise."""
        self.net.actor.quant = self.net.critic.quant = (torch.float8_e4m3fn if control
                                                        else None)
        torch.backends.cuda.matmul.allow_tf32 = bool(control)
        torch.backends.cudnn.allow_tf32 = bool(control)

    def field_gap(self, params):
        hf, ref = params.height_field, self.env.own_params()["height_field"]
        if hf.shape != ref.shape:
            return OFF
        return float((hf.float() - ref.float()).abs().max())

    def env_step(self, params, state, act):
        gen = torch.Generator(device=self.device).manual_seed(0)
        return self.env.step(params, ref_state(self.env, state), act, gen)

    def env_steps(self, cap, params, control=False, fault=None):
        """Per captured env step: (per-env gap, termination differs, reset
        gap).  With
        `control` the reference's own step in TF32 stands in the program's
        place; `fault` is planted in the program's step (plant())."""
        rp = ref_params(self.env, params)
        steps = []
        for i, (state, act, out) in sorted(cap.env_steps.items()):
            self.precision(False)
            ref = self.env_step(rp, state, act)
            if control:
                self.precision(True)
                out = self.env_step(rp, state, act)
                self.precision(False)
            if fault is not None:
                out = plant(fault, state, out)
            gap, reset = env_gap(self.env, out, ref)
            gap = torch.maximum(gap, obs_gap(self.env, rp, out[0], out[1],
                                             out[4]["privileged_obs"], self.sigmas))
            if i == 0:
                state0, obs0, priv0 = cap.start
                gap = torch.maximum(gap, obs_gap(self.env, rp, state0, obs0, priv0,
                                                 self.sigmas))
            steps.append((gap, out[3] != ref[3], reset))
        return steps

    def updates(self, cap, control=False, half=False):
        """The reference's first STEPS optimizer steps from the program's
        parameters, Adam state and first rollout: (losses, first clipped
        gradient, parameter change).  `control`: the network's products in
        fp8; `half`: the first half of the envs only."""
        self.precision(control)
        buf, (obs_last, priv_last) = cap.buf, cap.last
        if half:
            B = buf[0].shape[1] // 2
            buf = tuple(x[:, :B] for x in buf)
            obs_last, priv_last = obs_last[:B], priv_last[:B]
        p, _, _, _, stats, g = self.update.run(buf, obs_last, priv_last, cap.p0, *cap.opt0,
                                               cap.lrs)
        self.precision(False)
        return [float(total_loss(self.cfg, *row[:4])) for row in stats], g, p - cap.p0

    def compare_updates(self, got, want):
        """(loss_gap, grad_gap, change_gap) of `got` (losses, first
        gradient, parameter change) against `want`."""
        (lg, gg, dg), (lw, gw, dw) = got, want
        loss = max(abs(a - b) / abs(b) for a, b in zip(lg, lw, strict=True))
        gn_w = leaf_norms(gw, self.sizes)
        grad = norm_gap(leaf_norms(gg, self.sizes), gn_w)
        keep = gn_w >= LEAF_FLOOR * gn_w.median()
        change = norm_gap(leaf_norms(dg, self.sizes), leaf_norms(dw, self.sizes), keep)
        return loss, grad, change

    def program_updates(self, cap):
        """The program's (losses, first gradient, parameter change) of its
        first STEPS optimizer steps."""
        losses = [float(total_loss(self.cfg, *row[:4])) for row in cap.stats[:STEPS]]
        return losses, cap.m1 / (1.0 - self.update.b1), cap.p_steps - cap.p0

    def numbers(self, cap, params):
        """The compared numbers of a run."""
        out = {"field_gap": self.field_gap(params),
               **step_numbers(self.env_steps(cap, params))}
        loss, grad, change = self.compare_updates(self.program_updates(cap),
                                                  self.updates(cap))
        out.update(loss_gap=loss, grad_gap=grad, change_gap=change)
        return out
