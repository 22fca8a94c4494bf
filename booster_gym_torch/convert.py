"""Carry weights, optimizer state and env state across from the JAX package.

Inputs are the JAX package's objects with their leaves already turned
into numpy arrays (for example `jax.tree.map(np.asarray, x)`); this module
reads them by attribute or key and never imports JAX.
"""

import numpy as np
import torch

from booster_gym_torch.physics.types import DynParams, SimState


def _t(x, device, dtype=None):
    arr = np.array(x)
    if dtype is None:
        dtype = {np.dtype(bool): torch.bool}.get(
            arr.dtype, torch.int64 if arr.dtype.kind in "iu" else torch.float32)
    return torch.as_tensor(arr, device=device).to(dtype).clone()


def params_from_flax(tree, num_layers=(4, 4)):
    """Flax ActorCritic params ({"params": {"actor": {"Dense_i": {kernel,
    bias}}, "critic": ..., "logstd"}}) -> the port's ActorCritic state_dict.
    Flax Dense kernels are [in, out]; nn.Linear weights are [out, in]."""
    p = tree["params"] if "params" in tree else tree
    out = {}
    for net, n in zip(("actor", "critic"), num_layers):
        for i in range(n):
            layer = p[net][f"Dense_{i}"]
            out[f"{net}.layers.{i}.weight"] = torch.as_tensor(
                np.asarray(layer["kernel"], np.float32).T.copy())
            out[f"{net}.layers.{i}.bias"] = torch.as_tensor(
                np.asarray(layer["bias"], np.float32).copy())
    out["logstd"] = torch.as_tensor(np.asarray(p["logstd"], np.float32).copy())
    return out


def flat_from_flax(network, tree):
    """A flax-shaped tree (params, gradients or an Adam moment) as one f32
    vector in the order of network.parameters()."""
    sd = params_from_flax(tree)
    return torch.cat([sd[name].reshape(-1) for name, _ in network.named_parameters()])


def _leaf_names(network):
    """The parameter name of each leaf of the JAX fused update's canonical
    list: aW0.., ab0.., cW0.., cb0.., logstd."""
    names = []
    for net in ("actor", "critic"):
        n = len(getattr(network, net).layers)
        names += [f"{net}.layers.{i}.weight" for i in range(n)]
        names += [f"{net}.layers.{i}.bias" for i in range(n)]
    return names + ["logstd"]


def flat_from_leaves(network, leaves):
    """The JAX fused update's canonical leaf list (FusedUpdate.param_leaves:
    weights [in, out], biases [out, 1], logstd [num_act, 1]; params,
    gradients or an Adam moment, as numpy arrays) -> one f32 vector in the
    order of network.parameters()."""
    by_name = {}
    for name, leaf in zip(_leaf_names(network), leaves, strict=True):
        leaf = np.asarray(leaf, np.float32)
        by_name[name] = leaf.T if name.endswith("weight") else leaf.reshape(-1)
    return torch.cat([torch.as_tensor(by_name[name].copy()).reshape(-1)
                      for name, _ in network.named_parameters()])


def leaves_from_flat(network, flat):
    """Inverse of flat_from_leaves: the canonical leaf list as numpy arrays."""
    by_name, offset = {}, 0
    for name, prm in network.named_parameters():
        by_name[name] = flat[offset:offset + prm.numel()].detach().cpu().numpy().reshape(prm.shape)
        offset += prm.numel()
    return [by_name[name].T.copy() if name.endswith("weight") else by_name[name].reshape(-1, 1)
            for name in _leaf_names(network)]


def sim_state_from_jax(sim, device):
    return SimState(**{k: _t(getattr(sim, k), device) for k in SimState.FIELDS})


def dyn_params_from_jax(dyn, device):
    return DynParams(
        body_mass=_t(dyn.body_mass, device), body_com=_t(dyn.body_com, device),
        body_inertia=_t(dyn.body_inertia, device),
        shape_friction=_t(dyn.shape_friction, device),
        shape_restitution=_t(dyn.shape_restitution, device))


def env_params_from_jax(params, device):
    """JAX EnvParams -> the port's EnvParams (the TPU sampler's pre-sheared
    table has no counterpart)."""
    from booster_gym_torch.envs.state import EnvParams

    return EnvParams(
        dyn=dyn_params_from_jax(params.dyn, device),
        dof_stiffness=_t(params.dof_stiffness, device),
        dof_damping=_t(params.dof_damping, device),
        dof_friction=_t(params.dof_friction, device),
        base_mass_scaled=_t(params.base_mass_scaled, device),
        env_origins=_t(params.env_origins, device),
        height_field=_t(params.height_field, device))


def env_state_from_jax(state, device):
    """JAX EnvState -> the port's EnvState.  The PRNG key has no
    counterpart (the port passes a torch.Generator)."""
    import dataclasses

    from booster_gym_torch.envs.state import EnvState

    kw = {}
    for f in dataclasses.fields(EnvState):
        if f.name == "sim":
            kw["sim"] = sim_state_from_jax(state.sim, device)
        else:
            kw[f.name] = _t(getattr(state, f.name), device)
    return EnvState(**kw)
