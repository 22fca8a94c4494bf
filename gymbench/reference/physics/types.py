"""Physics state and parameters as dataclasses of batch-leading tensors
(the flax struct pytrees of booster_gym_tpu/physics/types.py)."""

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SimState:
    """Batched simulator state.  root_lin_vel is the world-frame velocity
    of the base-frame origin; root_ang_vel the world-frame angular
    velocity; quaternions are wxyz."""

    root_pos: torch.Tensor      # [B, 3]
    root_quat: torch.Tensor     # [B, 4]
    root_lin_vel: torch.Tensor  # [B, 3]
    root_ang_vel: torch.Tensor  # [B, 3]
    q: torch.Tensor             # [B, nd]
    qd: torch.Tensor            # [B, nd]

    FIELDS = ("root_pos", "root_quat", "root_lin_vel", "root_ang_vel", "q", "qd")


@dataclasses.dataclass
class DynParams:
    """Per-env randomized dynamics parameters."""

    body_mass: torch.Tensor         # [B, nb]
    body_com: torch.Tensor          # [B, nb, 3] body frame
    body_inertia: torch.Tensor      # [B, nb, 3, 3] about com, body frame
    shape_friction: torch.Tensor    # [B, ns]
    shape_restitution: torch.Tensor  # [B, ns]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static solver configuration (same fields and defaults as the JAX
    package's SimConfig)."""

    dt: float = 0.002
    gravity: tuple = (0.0, 0.0, -9.81)
    solver_iterations: int = 4
    contact_margin: float = 0.0
    baumgarte: float = 0.2
    max_pushout_vel: float = 1.0
    contact_slop: float = 0.001
    bounce_threshold: float = 0.2
    relaxation: float = 1.0
    terrain_friction: float = 1.0
    terrain_restitution: float = 0.0
    mass_matrix_reg: float = 1e-6

    @property
    def gravity_arr(self):
        return np.asarray(self.gravity, dtype=np.float32)
