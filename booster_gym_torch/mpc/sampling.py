"""Sampling-based whole-body MPC over the port's physics (port of
booster_gym_tpu/mpc/sampling.py).

An MPPI planner: it rolls K perturbed PD-target sequences out through the
batched physics the trainer uses, scores them with a task cost, and takes
the exponentially weighted mean.  The K samples are K envs of one batch.

On the env's kernel backend each control step of the rollout is one call
of physics/substep_kernel.py's control_step: one launch of K1 (K5 on a
trimesh env) on the card for all K samples, its plain version (the
decimation loop around the plain substep) on the CPU.  The call has no
delay (the new targets act from substep 0), no joint friction and no push,
and the env's base gains, so it computes clip(kp (targets - q) - kd qd,
+-torque_limits) per substep, as the JAX planner's rollout does.  The state stays in the
kernel's packed [nstate, K] layout across the horizon; the cost reads it
through views.  Under sim.backend: xla the rollout is the decimation loop
around the eager engine, as the env's own loop is there.

On a trimesh env the kernel is K5, and the rollout plans as the JAX
planner does on its Pallas backend: there env.substep is the plane=False
kernel's plane-signature step, which passes h = 0 and n = +z at every
contact point, every substep (flat_ground).  So the kernel backend plans a
trimesh env on flat ground at z = 0 and never samples the field; on the
card that plan is the plane env's K1 plan, bitwise.  Under sim.backend:
xla the engine queries the field in every substep, as the JAX XLA engine
does.
"""

import functools

import torch

from booster_gym_torch.math.quat import quat_rotate_inverse
from booster_gym_torch.physics.types import SimState


def tile(state1, dyn1, K):
    """A single-env SimState and DynParams (leading dim 1) repeated over K
    rollout samples."""
    rep = lambda obj: type(obj)(**{k: v.expand(K, *v.shape[1:]).contiguous()
                                   for k, v in vars(obj).items()})
    return rep(state1), rep(dyn1)


def flat_ground(npt, K, device):
    """K5's terrain inputs for K samples on flat ground at z = 0: heights
    ph [npt, K] all 0 and normals pn [3 npt, K] +z at every point (row
    3 p + 2 is 1), the JAX plane=False kernel's plane-signature step."""
    pn = torch.zeros((npt, 3, K), device=device)
    pn[:, 2] = 1.0
    return torch.zeros((npt, K), device=device), pn.reshape(3 * npt, K)


def standup_cost(state: SimState, default_dof_pos, target_height=0.68):
    """Stage cost for standup / push-recovery: get high, get upright, move
    toward the default pose, stay calm."""
    down = torch.tensor([0.0, 0.0, -1.0], dtype=state.root_pos.dtype,
                        device=state.root_pos.device).expand(state.root_pos.shape)
    up = quat_rotate_inverse(state.root_quat, down)
    height_err = torch.square(state.root_pos[:, 2] - target_height)
    tilt = torch.sum(torch.square(up[:, :2]), dim=-1)
    posture = torch.sum(torch.square(state.q - default_dof_pos), dim=-1)
    effort = 0.01 * torch.sum(torch.square(state.qd), dim=-1)
    return 20.0 * height_err + 5.0 * tilt + 0.5 * posture + effort


class SamplingMPC:
    """MPPI over PD-target deltas.

    plan(state1, dyn1, noise=None, gen=None) -> (dof_targets [nd], info):
    one planning step from a single-env SimState and DynParams (leading
    dim 1).  `noise` [H, K, nd] is the perturbation already scaled by
    sigma; without it plan draws sigma * N(0, 1) from the torch.Generator
    `gen` on the env's device.  info holds best_cost, mean_cost and ess as
    0-d tensors."""

    def __init__(self, env, cost_fn=None, horizon=16, num_samples=256, sigma=0.15,
                 temperature=0.05, decimation=None):
        self.env = env
        self.model = env.model
        self.device = env.device
        self.horizon = horizon
        self.num_samples = num_samples
        self.sigma = sigma
        self.temperature = temperature
        self.decimation = decimation or env.decimation
        self.cost_fn = cost_fn or functools.partial(
            standup_cost, default_dof_pos=env.default_dof_pos)
        nd = self.model.num_dofs
        self._mean = torch.zeros((horizon, nd), device=self.device)
        self._ground = {}

    # -- rollout -----------------------------------------------------------
    def rollout_inputs(self, K):
        """The control step's inputs that the rollout holds fixed, in
        control_step's order after the targets and latched targets: no
        delay, the base gains for every sample, no joint friction, the
        torque limits, no push; on K5 then flat_ground's heights and
        normals, made once per K."""
        env, nd = self.env, self.model.num_dofs
        fixed = (torch.zeros(K, dtype=torch.int64, device=self.device),
                 env.base_stiffness.expand(K, nd).contiguous(),
                 env.base_damping.expand(K, nd).contiguous(),
                 torch.zeros((K, nd), device=self.device), env.torque_limits,
                 torch.zeros((K, 6), device=self.device))
        if env.substep is None or env.substep.plane:
            return fixed
        if K not in self._ground:
            self._ground[K] = flat_ground(self.model.num_points, K, self.device)
        return fixed + self._ground[K]

    def _rollout(self, dyn_k, state_k, target_seq):
        """Roll the K samples through the physics for the horizon.
        target_seq: [H, K, nd] absolute PD targets.  Returns the final
        SimState and the cost after each control step, [H, K]."""
        sub = self.env.substep
        if sub is None:
            return self._rollout_engine(dyn_k, state_k, target_seq)
        fixed = self.rollout_inputs(target_seq.shape[1])
        psim, pdyn = sub.pack_sim(state_k), sub.pack_dyn(dyn_k)
        costs = []
        for targets in target_seq:
            targets = targets.contiguous()
            psim = sub.control_step(psim, pdyn, targets, targets, *fixed,
                                    decimation=self.decimation).state
            costs.append(self.cost_fn(sub.unpack_sim(psim)))
        return sub.unpack_sim(psim), torch.stack(costs)

    def _rollout_engine(self, dyn_k, sim, target_seq):
        """sim.backend xla: the decimation loop around the eager engine."""
        env = self.env
        kp, kd, lim = env.base_stiffness, env.base_damping, env.torque_limits
        zeros3 = torch.zeros((target_seq.shape[1], 3), device=target_seq.device)
        costs = []
        for targets in target_seq:
            for _ in range(self.decimation):
                tau = torch.clamp(kp * (targets - sim.q) - kd * sim.qd, -lim, lim)
                sim = env.engine_substep(sim, dyn_k, tau, zeros3, zeros3)[0]
            costs.append(self.cost_fn(sim))
        return sim, torch.stack(costs)

    # -- planning ------------------------------------------------------------
    def sample(self, mean, noise):
        """The perturbed deltas [H, K, nd], sample 0 carrying the
        unperturbed mean (CEM-style elitism guard), and their absolute PD
        targets clipped to the joint limits."""
        deltas = mean[:, None, :] + noise
        deltas[:, 0, :] = mean
        targets = torch.clamp(self.env.default_dof_pos + deltas, self.env.dof_lower,
                              self.env.dof_upper)
        return deltas, targets

    def weigh(self, deltas, costs):
        """MPPI exponential weighting of the costs [H, K] summed over the
        horizon: (the first action's targets, the new mean shifted by one
        step, info)."""
        total = torch.sum(costs, dim=0)
        w = torch.softmax(-(total - total.min()) / self.temperature, dim=0)
        new_mean = torch.einsum("k,hkj->hj", w, deltas)
        info = {"best_cost": total.min(), "mean_cost": total.mean(),
                "ess": 1.0 / torch.sum(w * w)}
        # receding horizon: emit the first action, shift the mean
        action_targets = self.env.default_dof_pos + new_mean[0]
        shifted = torch.cat([new_mean[1:], new_mean[-1:]], dim=0)
        return action_targets, shifted, info

    @torch.no_grad()
    def _plan_impl(self, state1, dyn1, mean, noise):
        deltas, targets = self.sample(mean, noise)
        state_k, dyn_k = tile(state1, dyn1, self.num_samples)
        _, costs = self._rollout(dyn_k, state_k, targets)
        return self.weigh(deltas, costs)

    def draw(self, gen):
        """sigma * N(0, 1) of shape [H, K, nd] from `gen`."""
        shape = (self.horizon, self.num_samples, self.model.num_dofs)
        return self.sigma * torch.randn(shape, generator=gen, device=self.device)

    def plan(self, state1, dyn1, noise=None, gen=None):
        if noise is None:
            if gen is None:
                raise ValueError("plan needs the noise or a generator to draw it from")
            noise = self.draw(gen)
        targets, self._mean, info = self._plan_impl(state1, dyn1, self._mean, noise)
        return targets, info

    def reset(self):
        self._mean = torch.zeros_like(self._mean)
