"""Env state and per-env parameters as dataclasses of batch-leading
tensors (the flax pytrees of booster_gym_tpu/envs/state.py).  The JAX
package's pre-sheared sampler table is a TPU layout and has no field here:
the port's sampler reads the height field itself."""

import dataclasses

import torch

from gymbench.reference.physics.types import DynParams, SimState


@dataclasses.dataclass
class EnvParams:
    """Per-env quantities randomized once at env creation."""

    dyn: DynParams
    dof_stiffness: torch.Tensor     # [B, nd]
    dof_damping: torch.Tensor       # [B, nd]
    dof_friction: torch.Tensor      # [B, nd] Coulomb joint friction torque
    base_mass_scaled: torch.Tensor  # [B, 4] raw noise -> privileged obs
    env_origins: torch.Tensor       # [B, 3]
    height_field: torch.Tensor      # [R, C] terrain heights ([1, 1] zeros on plane)


@dataclasses.dataclass
class EnvState:
    """Everything that evolves across steps.  Integer fields are int64."""

    sim: SimState
    actions: torch.Tensor              # [B, na]
    last_actions: torch.Tensor         # [B, na]
    last_dof_targets: torch.Tensor     # [B, nd] delay-latched PD targets
    delay_steps: torch.Tensor          # [B] in [0, decimation)
    torques: torch.Tensor              # [B, nd] decimation-averaged
    last_dof_vel: torch.Tensor         # [B, nd]
    last_root_vel: torch.Tensor        # [B, 6] (lin, ang)
    episode_length: torch.Tensor       # [B]
    common_step_counter: torch.Tensor  # scalar
    reset_buf: torch.Tensor            # [B] bool
    time_out_buf: torch.Tensor         # [B] bool
    commands: torch.Tensor             # [B, 3]
    cmd_resample_time: torch.Tensor    # [B]
    gait_frequency: torch.Tensor       # [B]
    gait_process: torch.Tensor         # [B]
    filtered_lin_vel: torch.Tensor     # [B, 3]
    filtered_ang_vel: torch.Tensor     # [B, 3]
    curriculum_prob: torch.Tensor      # [1 + 2 lin_levels, 1 + 2 ang_levels]
    env_curriculum_level: torch.Tensor  # [B, 2]
    push_force: torch.Tensor           # [B, 3] local frame
    push_torque: torch.Tensor          # [B, 3]
    last_feet_pos: torch.Tensor        # [B, 2, 3]
    feet_pos: torch.Tensor             # [B, 2, 3]
    feet_roll: torch.Tensor            # [B, 2]
    feet_yaw: torch.Tensor             # [B, 2]
    feet_contact: torch.Tensor         # [B, 2] bool
    contact_forces: torch.Tensor       # [B, nb, 3] last substep's
    base_lin_vel: torch.Tensor         # [B, 3]
    base_ang_vel: torch.Tensor         # [B, 3]
    projected_gravity: torch.Tensor    # [B, 3]
    terrain_height_root: torch.Tensor  # [B] (zeros on plane terrain)
    # terrain under each collision point, sampled once per control step and
    # carried into the next step's substeps (kernel path on trimesh)
    point_heights: torch.Tensor        # [B, npt]
    point_normals: torch.Tensor        # [B, npt, 3]

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)
