"""Export a trained actor for the deploy stack (port of export_model.py):

    python -m booster_gym_torch.export --task=T1 --checkpoint=PATH|-1 \
        [--output PATH] [--format torchscript|onnx]

PATH is the port's model_<it>.pt or the JAX package's model_<it>.ckpt; -1
picks the newest under logs/.  The actor becomes torch.nn.Sequential(
Linear, ELU, ..., Linear) in f32, keys 0.weight, 0.bias, 2.weight, ...,
the layout booster_gym_tpu/deploy/policy.py loads.  A task whose config
has a `standup` block (T1Standup, T1StandupFT) wraps it in StandupActor,
the deploy stack's standup interface (export_model.py's standup_module).
torchscript (default) scripts and saves it as <PATH without
extension>_policy.pt unless --output is given; onnx needs the onnx
package and takes the bare actor.
"""

import argparse
import os

import torch

from booster_gym_torch.convert import params_from_flax
from booster_gym_torch.utils.config import load_task_cfg
from booster_gym_torch.utils.recorder import load_checkpoint, resolve_checkpoint


def actor_params(saved):
    """The ActorCritic state_dict of a loaded checkpoint, the port's or a
    JAX package's."""
    return params_from_flax(saved["params"]) if "opt_state" in saved else saved["params"]


def actor_sequential(params):
    """An ActorCritic state_dict -> the actor as a torch.nn.Sequential of
    Linear and ELU in f32 on the CPU, weights copied exactly."""
    n = sum(1 for k in params if k.startswith("actor.layers.") and k.endswith(".weight"))
    layers = []
    for i in range(n):
        weight = params[f"actor.layers.{i}.weight"].float()
        lin = torch.nn.Linear(weight.shape[1], weight.shape[0])
        with torch.no_grad():
            lin.weight.copy_(weight)
            lin.bias.copy_(params[f"actor.layers.{i}.bias"].float())
        layers.append(lin)
        if i + 1 < n:
            layers.append(torch.nn.ELU())
    return torch.nn.Sequential(*layers)


class StandupActor(torch.nn.Module):
    """The standup actor behind the deploy interface: forward(obs [B, 42],
    stacked_obs [B, deploy_stack, 42]) -> actions [B, 12], the call the
    deploy stack's standup policy makes.  The policy was trained on the
    newest train_stack frames, so the module takes those from the deploy
    stack (newest first in both) and flattens them."""

    def __init__(self, actor, train_stack):
        super().__init__()
        self.actor = actor
        self.train_stack = train_stack

    def forward(self, obs, stacked_obs):
        x = stacked_obs[:, :self.train_stack, :]
        return self.actor(x.reshape(x.shape[0], -1))


def deploy_module(actor, cfg):
    """The module the deploy stack loads for a task config: the actor, or
    StandupActor around it where the config has a `standup` block."""
    if "standup" in cfg:
        return StandupActor(actor, int(cfg["standup"]["train_stack"]))
    return actor


def export_onnx(actor, output):
    try:
        import onnx  # noqa: F401
    except ImportError as e:
        raise RuntimeError("ONNX export needs the onnx package; use --format=torchscript") from e
    torch.onnx.export(
        actor, torch.zeros(1, actor[0].in_features), output,
        input_names=["obs"], output_names=["action"],
        dynamic_axes={"obs": {0: "batch"}, "action": {0: "batch"}})
    print(f"Saved ONNX actor to {output}")
    return output


def export(checkpoint, output=None, fmt="torchscript", task="T1", root="logs"):
    """Export the actor of `checkpoint` (a path, or -1 for the newest under
    `root`) for `task`; returns the written file's path."""
    cfg = load_task_cfg(task)   # the task must be one the port has
    path = resolve_checkpoint(checkpoint, root)
    print(f"Loading model from {path}")
    actor = actor_sequential(actor_params(load_checkpoint(path)))
    base = output or os.path.splitext(path)[0] + "_policy"
    base = os.path.splitext(base)[0] if base.endswith((".pt", ".onnx")) else base
    if fmt == "onnx":
        return export_onnx(actor, base + ".onnx")
    if fmt != "torchscript":
        raise ValueError(f"unknown format {fmt!r}")
    torch.jit.script(deploy_module(actor, cfg)).save(base + ".pt")
    print(f"Saved TorchScript actor to {base}.pt")
    return base + ".pt"


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--task", type=str, default="T1")
    parser.add_argument("--checkpoint", type=str, default="-1")
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--format", type=str, default="torchscript",
                        choices=["torchscript", "onnx"])
    args = parser.parse_args(argv)
    return export(args.checkpoint, args.output, args.format, task=args.task)


if __name__ == "__main__":
    main()
