"""Terrain, plane case (port of the plane branch of
booster_gym_tpu/terrain/heightfield.py).  Heightfield terrain and its
samplers are not ported yet."""

import torch


class Terrain:
    def __init__(self, cfg, seed=0):
        self.type = cfg["type"]
        self.static_friction = float(cfg.get("static_friction", 1.0))
        self.restitution = float(cfg.get("restitution", 0.0))
        if self.type != "plane":
            raise NotImplementedError(
                f"terrain type {self.type!r}: only 'plane' is ported (pass --terrain=plane)")
        self.height_field = None

    def heights(self, xy):
        """Terrain height at world xy [..., 2] -> [...]."""
        return torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)
