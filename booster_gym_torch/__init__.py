"""Booster Gym on PyTorch and CUDA: the port of booster_gym_tpu to one
NVIDIA H100.

The JAX package booster_gym_tpu stays beside this one as the reference.
This package imports torch, numpy and yaml, and nothing of JAX.  Layout
mirrors the JAX package:

    train.py / runner.py   CLI and training loop
    prof_update.py         times the update kernels at the training shape
    algo/                  actor-critic and PPO (fused update K2-K4,
                           csrc/update.cu, or the xla update); the rest of
                           the reference's FusedUpdate, K8 values, K9 grads
                           and K10 policy_old_logp, in the same source
    envs/                  T1 task, plane or heightfield (trimesh) terrain
    physics/               eager substep (plain version) and the CUDA
                           substep kernels (K1 plane, K5 general terrain,
                           csrc/substep.cu)
    terrain/               heightfield generation and queries, and the CUDA
                           terrain sampler (K6 + K7, csrc/terrain_sample.cu)
    model/                 URDF parser
    math/                  quaternion and spatial algebra
"""

import torch as _torch

# Physics is f32 small-matrix algebra; TF32 keeps ~3 decimal digits, far
# too coarse for contact dynamics.  The JAX package forces highest matmul
# precision for the same reason.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
