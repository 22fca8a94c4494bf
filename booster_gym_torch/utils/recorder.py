"""Run logging and checkpoints (port of booster_gym_tpu/utils/recorder.py).

Each run gets logs/<timestamp>/ with a config snapshot, scalars.jsonl and
checkpoints nn/model_<it>.pt: torch.save of a dict of plain tensors and
numbers (network state_dict, Adam moments and count, learning rate,
iteration, curriculum grid).
"""

import json
import os
import time

import torch
import yaml


class Recorder:
    def __init__(self, cfg, root="logs"):
        self.cfg = cfg
        name = time.strftime("%Y-%m-%d-%H-%M-%S", time.localtime())
        self.dir = os.path.join(root, name)
        self.model_dir = os.path.join(self.dir, "nn")
        os.makedirs(self.model_dir, exist_ok=True)
        with open(os.path.join(self.dir, "config.yaml"), "w") as f:
            yaml.dump(cfg, f)
        self._scalars_path = os.path.join(self.dir, "scalars.jsonl")

    def record_statistics(self, statistics, it):
        row = {"it": int(it), **{k: float(v) for k, v in statistics.items()}}
        with open(self._scalars_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def save(self, state_dict, it):
        path = os.path.join(self.model_dir, f"model_{it}.pt")
        torch.save(state_dict, path)
        print(f"Saving model to {path}")
        return path
