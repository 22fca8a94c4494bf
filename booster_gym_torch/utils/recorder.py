"""Run logging and checkpoints (port of booster_gym_tpu/utils/recorder.py).

Each run gets logs/<timestamp>/ with a config snapshot, scalars.jsonl,
TensorBoard scalars under summaries/ (when torch.utils.tensorboard
imports), W&B under runner.use_wandb, and checkpoints nn/model_<it>.pt:
torch.save of a dict of plain tensors and numbers (network state_dict, Adam
moments and count, learning rate, iteration, curriculum grid, generator
state).

load_checkpoint also reads the JAX package's pickle checkpoints
(model_<it>.ckpt) without JAX: their optax states unpickle into the
stand-in namedtuples below.  The JAX package's orbax directories are found
by resolve_checkpoint but refused by load_checkpoint: orbax imports JAX.
"""

import collections
import glob
import json
import os
import pickle
import re
import sys
import time
import types

import torch
import yaml

# optax's NamedTuples, field for field: the pickle stores them by position
EmptyState = collections.namedtuple("EmptyState", [])
ScaleByAdamState = collections.namedtuple("ScaleByAdamState", ["count", "mu", "nu"])
InjectStatefulHyperparamsState = collections.namedtuple(
    "InjectStatefulHyperparamsState",
    ["count", "hyperparams", "hyperparams_states", "inner_state"])
_OPTAX_STANDINS = {cls.__name__: cls for cls in (
    EmptyState, ScaleByAdamState, InjectStatefulHyperparamsState)}
_NUMPY_NAMES = {"_reconstruct", "ndarray", "dtype", "scalar", "_frombuffer"}
_BUILTIN_NAMES = {"dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
                  "bool", "str", "bytes", "bytearray", "slice", "range"}
_PORT_CHECKPOINT = re.compile(r"model_\d+\.pt$")


class Recorder:
    def __init__(self, cfg, root="logs"):
        self.cfg = cfg
        name = time.strftime("%Y-%m-%d-%H-%M-%S", time.localtime())
        self.dir = os.path.join(root, name)
        self.model_dir = os.path.join(self.dir, "nn")
        os.makedirs(self.model_dir, exist_ok=True)

        self.writer = None
        try:
            # tensorboard's own switch to its TensorFlow-free writer: where
            # TensorFlow is installed it would otherwise import it, and
            # TensorFlow imports JAX
            sys.modules.setdefault("tensorboard.compat.notf",
                                   types.ModuleType("tensorboard.compat.notf"))
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(os.path.join(self.dir, "summaries"))
        except Exception:
            pass
        self.use_wandb = bool(cfg["runner"].get("use_wandb", False))
        if self.use_wandb:
            try:
                import wandb

                wandb.init(
                    project=cfg["basic"]["task"], dir=self.dir, name=name,
                    notes=cfg["basic"].get("description", ""), config=cfg)
            except Exception:
                self.use_wandb = False

        with open(os.path.join(self.dir, "config.yaml"), "w") as f:
            yaml.dump(cfg, f)
        self._scalars_path = os.path.join(self.dir, "scalars.jsonl")

    def record_statistics(self, statistics, it):
        row = {"it": int(it), **{k: float(v) for k, v in statistics.items()}}
        if self.writer is not None:
            for key, value in row.items():
                if key != "it":
                    self.writer.add_scalar(key, value, it)
        if self.use_wandb:
            import wandb

            wandb.log({k: v for k, v in row.items() if k != "it"}, step=it)
        with open(self._scalars_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def save(self, state_dict, it):
        path = os.path.join(self.model_dir, f"model_{it}.pt")
        torch.save(state_dict, path)
        print(f"Saving model to {path}")
        return path


def resolve_checkpoint(checkpoint, root="logs"):
    """-1 selects the newest checkpoint across runs under `root` by mtime:
    the port's model_<it>.pt, the JAX package's pickle model_<it>.ckpt and
    its orbax directories (which load_checkpoint refuses)."""
    if checkpoint in (-1, "-1"):
        pattern = lambda name: glob.glob(os.path.join(root, "**", name), recursive=True)
        paths = sorted(
            [p for p in pattern("model_*.pt") if _PORT_CHECKPOINT.match(os.path.basename(p))]
            + pattern("*.ckpt")
            + [os.path.dirname(p) for p in pattern("_CHECKPOINT_METADATA")],
            key=os.path.getmtime)
        if not paths:
            raise FileNotFoundError(f"no checkpoints under {root}")
        return paths[-1]
    if not os.path.exists(checkpoint):
        raise FileNotFoundError(f"no checkpoint at {checkpoint}")
    return checkpoint


class _JaxCheckpointUnpickler(pickle.Unpickler):
    """Unpickles the JAX package's .ckpt: numpy arrays and builtin
    containers, with optax's states as the stand-ins above.  Anything else
    is refused."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if top == "optax" and name in _OPTAX_STANDINS:
            return _OPTAX_STANDINS[name]
        if (top == "numpy" and name in _NUMPY_NAMES) or (
                module == "builtins" and name in _BUILTIN_NAMES):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"a checkpoint may not hold {module}.{name}")


def load_checkpoint(path):
    """A checkpoint as a dict: the port's .pt (torch.load, weights only),
    or the JAX package's pickle .ckpt (numpy leaves, optax states as
    namedtuples; convert.train_state_from_jax_checkpoint reads it)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is an orbax checkpoint directory; the port reads only its own .pt "
            f"files and the JAX package's pickle .ckpt files.  Re-save it on the JAX side: "
            f"pickle.dump(booster_gym_tpu.utils.recorder.load_checkpoint(path), "
            f"open(path + '.ckpt', 'wb'))")
    if path.endswith(".ckpt"):
        with open(path, "rb") as f:
            return _JaxCheckpointUnpickler(f).load()
    return torch.load(path, map_location="cpu", weights_only=True)
