#!/usr/bin/env python3
"""Smoke run of the PyTorch port (booster_gym_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi); CUDA must be available;
  2. build the CUDA kernels, the nvcc runs in parallel: the substep kernel
     (csrc/substep.cu) as K1 (plane) and K5 (general terrain) for the toy
     robot and the T1-shaped robot, both with T1.yaml's foot edge points
     (the control step's epilogue; K5's also samples the terrain, K6 + K7
     folded in), and for the T1-shaped robot each again with the epilogue
     compiled out (-DEPILOGUE=0, for phase 6's cost of it), the standalone
     terrain sampler K6 + K7 (csrc/terrain_sample.cu), and the fused
     update's K2, K3 and K4 (csrc/update.cu); ptxas's registers, stack
     frame and spills (the control kernels' and K4's among them), each
     substep build's shared memory per block and resident blocks per SM,
     and the same for K3's pass 1 and pass 2 and for K2's (at the main
     path's T + 1 planes) and K8's critic kernel (its clusters too) in
     bf16 and f32;
  3. each kernel against its plain PyTorch version on the card: K1 on both
     robots at B = 4096 and B = 1000 (a ragged last block), several
     substeps; K5 the same with heights from T1.yaml's field and tilted
     normals, and on plane inputs against K1 with a difference of exactly
     0; then both through control_step (the decimation loop in one launch)
     against the plain loop, with delays spread over 0..9 and a push,
     launched twice to show that it repeats bitwise, beside ten
     single-substep launches, and K5 on plane inputs against K1 again (the
     foot edge points too); the epilogue's edge points against the torch
     ops on the kernel's own feet poses (bitwise), and K5's fused heights
     and normals against the standalone sampler kernel on the kernel's own
     queries (bitwise) and its plain version (2e-5); the standalone
     sampler at B = 4096 and 1000 with 65 queries per env, also with
     roots at the field's edge and queries 1-2 m from their root (the
     clamped cases); K2 past the planes its shared memory holds (T + 1 =
     k2_max_planes + 1 and 2 k2_max_planes, B = 1000, bf16 and f32, the
     spill poisoned with NaN between two launches that must agree
     bitwise); K2, K3 and K4 in bf16 and f32 at T = 24 with B = 4096
     (N = 98,304), 1000 and 4097 (every tile, slab and pass-2 step of K3
     ragged; K2's groups of envs ragged at 1000 and 4097), K2, K3 and K4
     launched twice to show that they repeat bitwise (K2's block partials
     filled with NaN between its two launches), and
     K3's weight gradients against torch.matmul on the rows its own pass 1
     wrote; then the whole fused update() against the xla (autograd)
     update() from the same parameters and rollout buffers, f32, 3
     mini-epochs; then K8 (values), K9 (grads) and K10 (policy_old_logp)
     in bf16 and f32 at the same shapes against their plain versions, K9
     launched twice to show that it repeats bitwise and checked against
     its pass 1's rows as K3 is, and the cross-checks between
     independently launched kernels on the same data: K9 on normalised
     advantages against K3, K8 (rows in no whole tile at B = 1000 and
     4097) against K2's value pass and K9's values,
     K10 against K3's self_old forward;
  4. the main path: booster_gym_torch.train's Runner on flat T1 (the
     T1-shaped stand-in URDF), 4096 envs, horizon 24, 20 mini-epochs,
     update_backend fused as T1.yaml has it, 3 iterations; per iteration
     K1 must be launched 24 times (one control step each) and K2, K3 and
     K4 20 times each.  Then
     the xla update on the same configuration, 2 iterations, for its times
     beside the fused path's from the same run;
  4b. the rough path: the same Runner on T1.yaml's own terrain (trimesh,
     a 900 x 200 field), 4096 envs, 3 iterations; per iteration K5 must be
     launched 24 times, each sampling the terrain in its epilogue, K1
     never, the standalone sampler never, and K2, K3 and K4 20 times each;
     then both paths' launches per iteration, rollout and update, from
     booster_gym_torch.profile_iteration (torch.profiler);
  4c. the path of K8-K10: booster_gym_torch.prof_update at its defaults
     (T = 24, B = 4096, bf16, 50 timed calls of each of K8, K9, K10, K2,
     K3, K4 after 3 warm-up calls); every call must count one launch;
  5. one control step of the env on the card against the same step on the
     CPU (plain versions) from the same state, a small batch, on the plane
     and on a small heightfield (one substep-kernel launch each);
  6. each kernel's time at its path's shapes beside its bound and the plain
     version's time, printed as a `kernels` JSON line (K1-K10): K1 and K5 as
     the main path runs them, one control step at 4096 envs (K5 sampling
     the terrain), and beside it one substep per launch and the control
     step of the build without the epilogue (the epilogue's cost; K6 + K7's
     entry gives K5's); K2-K4 and K8-K10 take their times from phase
     4c; K4 also under torch.profiler (its device time, one device kernel
     per call required) beside its yardstick (torch.linalg.vector_norm,
     torch._fused_adam_ with the clip as grad_scale and the cast to bf16, by
     CUDA events; no PyTorch call computes K4, so its library_ms is null); K3 also pass by pass (CUDA events between the passes, and each
     device kernel's time and count under torch.profiler: one each of the
     weight copy, pass 1, pass 2 and the reduce per call), its scratch and
     peak device memory, and beside pass 2 the eight torch.matmul products
     of its shapes on the same rows (a yardstick; no PyTorch call computes
     K3's whole function, so its library_ms is null), at N = 98,304 and
     again at the benchmark cells' N = 393,216; K2 part by part the
     same way (the weight copy and the critic kernel, one each per call);
  7. resume, play and export, the flat path's configuration with the fused
     update under a logs/ root of its own, after a full collection of the
     garbage that phases 1-6 left: 7a trains 2 iterations at 4096
     envs (a checkpoint each), resumes twice from model_1.pt (every piece
     restored bitwise: params, Adam m/v/count, lr, iteration, curriculum,
     generator state; the resumed iteration numbered 2, launching the
     control step 24 times and K2, K3, K4 20 times each), and prints the
     largest differences between the two resumes and against the
     uninterrupted run's model_2.pt; 7b loads the JAX package's
     logs/.../model_1100.ckpt without importing JAX and plays it 500 steps
     at 4096 envs on the plane (K1) and on T1.yaml's terrain (K5, sampling
     in its epilogue), one control-step launch per step and no standalone
     sampler launch, with steps/s by CUDA events, the mean reward per step
     and the share of envs done; 7c exports both checkpoints to
     TorchScript and holds each, loaded onto the card, bitwise to the f32
     Sequential built from the same state_dict on 4096 observations;
  8. the 23-DoF serial robot and the standup task, on the serial stand-in
     (booster_gym_torch.testing; its builds start with phase 2's): K1's
     launch shape per robot, as csrc/substep.cu picks it, against the
     card's occupancy; 8a K1 on the standup robot (85 MJCF contact points)
     and on T1Serial's (121 URDF points) against its plain version per
     substep and per control step (B = 4096 and 1000, env-like inputs,
     phase 3b's exclusion rule, the excluded share printed), and over
     T1Standup's bank settle at B = 4096, fallen bodies coming to rest (60
     rounds, each from the plain loop's state and finite where it is; every
     substep of every fifth round from the plain substep's state, held to
     the tolerance but where a contact decision falls the other way, and
     there the plain substep must reach the kernel's outcome from a
     rounding-perturbed state), K2-K4 and K8-K10 at T1Standup's widths (434-wide
     critic input) in bf16 and f32 at B = 4096 and 1000, and at T1Serial's
     (23 actions) at 4096; 8b T1Standup at 4096 envs: the bank's settle
     timed on its own (60 control-step launches), then 2 iterations (24
     control steps and 20 each of K2-K4 per iteration); 8d the standup
     policy exported with the deploy wrapper, bitwise against the f32
     actor on the card; 8b' T1StandupFT resumes that checkpoint for one
     iteration; 8c T1Serial, 1 iteration at 4096 envs; then every kernel
     at the new widths timed beside its bound and plain version (K8-K10
     through prof_update), and K3 pass by pass at T1Standup's widths at
     the benchmark cells' N = 393,216, as in phase 6;
  9. the sampling MPC (booster_gym_torch.mpc) at its defaults (K = 256
     samples, H = 16 control steps, decimation 10) on the T1-shaped
     stand-in on the plane, its rollout one K1 launch per control step (32
     blocks of 8 envs): 9a one plan's rollout held step by step to
     control_step_plain from the kernel's own state, state and cost, by
     phase 3b's and phase 8's exclusion rules (chaotic samples left out;
     a sample past the tolerance passes only where the plain step reaches
     its outcome from a rounding-perturbed state; both shares printed),
     and the plan's weighting, new mean and info equal exactly to torch's
     recomputation from the kernel's costs;
     9b 25 plans of closed-loop control (K1's count zeroed before: 16
     launches per plan and one per closed-loop step), ms per plan by CUDA
     events, the root held above 0.55 m and the cost finite; 9c K1's time
     per launch at K = 256 beside its bound and at 4096 envs; 9d the same
     planner on the rough path's env (T1.yaml's trimesh terrain, one env),
     whose rollout is K5 on flat ground (h = 0, n = +z at every point, no
     terrain sampled: the JAX planner's semantics on its Pallas backend):
     the rollout held step by step as in 9a, one plan from 9a's start and
     noise bitwise equal to 9a's K1 plan (targets, new mean, info) with 16
     K5 launches and no fused sampling, the closed loop of 9b on K5 (counts
     zeroed before it) giving 9b's targets at every plan bitwise, ms per
     plan by CUDA events, and K5's time per launch at K = 256 beside 4096
     envs, its bound and its plain time.  There is no MuJoCo phase: the
     card's machine has no mujoco package;
 10. data parallelism (booster_gym_torch/parallel), two ranks sharing the
     one card over gloo with CUDA tensors, each started as a process by the
     launcher of python -m booster_gym_torch.train (NCCL refuses two ranks
     on one card; NCCL across cards is not run here): 10a the flat path
     (4096 global envs, horizon 24, 20 mini-epochs, bf16, fused, seed 0), 2
     iterations at world size 1 in this process and in 2 ranks of 2048
     envs; each rank must launch K1 24 times and K2, K3 and K4 20 times each
     per iteration, the ranks' parameters, Adam m/v/count and lr must be
     bitwise equal after each iteration, the first rollout's buffers held to
     the world-1 rows at 2e-3 and iteration 1's reward and value loss to
     the world-1 run's at the CPU test's tolerances; each rank's iteration
     ms and all-reduce ms per mini-epoch printed (CUDA events; two ranks
     sharing one card, not a scaling number); 10b the rough path (K5), 2
     ranks, 1 iteration, launch counts; 10c the world-1 checkpoint resumed
     by both ranks and the 2-rank rank-0 checkpoint at world size 1, every
     piece bitwise; 10d play over ranks: the JAX run's model_1100.ckpt
     played 100 steps on the flat path at 4096 global envs at world size 1
     and in 2 ranks sharing the card (launch, gloo), rank 0's gathered
     trajectory bitwise the world-1 play, rank 1's None, one K1 launch per
     rank and step, each rank's steps/s; then 20 steps of the rough path in
     2 ranks, one K5 launch per step, each sampling the terrain in its
     epilogue.  A rank that fails or outlives DP_RANK_TIMEOUT_S fails the
     phase;
 11. the port's deploy stack, a CPU phase (the robot's runtime runs on the
     CPU by design): the JAX run's actor exported by
     booster_gym_torch.export drives python -m
     booster_gym_torch.deploy.main --mock --seconds 2 in a subprocess whose
     imports of jax and booster_gym_tpu raise; exit 0, the `mock run done`
     line, a nonzero leg target and neither module loaded are required;
     whether the native publisher built (g++) is printed;
 12. the port learns: tests/test_learning.py's run (testing.learning_cfg:
     flat terrain, horizon 24, 5 mini-epochs, lr 3e-4, 8 s episodes, a clean
     signal and gentle commands) on the T1-shaped stand-in at 4096 envs, bf16,
     the fused update, seed 3, 300 iterations; the curve printed every 15
     iterations; the JAX test's rule (testing.learning_rule: the last 40
     iterations' mean reward above max(1.5 x, + 0.1) iterations 21-60's,
     their mean episode steps above 0.85 x) must hold, through K1 (24
     launches an iteration) and K2-K4 (5 each); the phase's seconds printed.
The last line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

import dataclasses
import gc
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# K1 and K5 against their plain version: the state and the feet poses to
# rtol = atol = 2e-3, the JAX package's kernel-vs-engine tolerance; contact
# forces to rtol 5e-2 / atol 1 N, as the JAX package's tests; K5's contact-
# point xy to atol 1e-5 (one FK in f32 on both sides).  The env step on the
# card against the CPU: observations and rewards to the same 2e-3.  The
# terrain sampler against its plain version: atol 2e-5 on heights and
# normals, the JAX package's own tolerance for its sampler.
TOL_STATE = 2e-3
TOL_FORCE_RTOL, TOL_FORCE_ATOL = 5e-2, 1.0
TOL_PTXY = 1e-5
TOL_ENV = 2e-3
TOL_SAMPLER = 2e-5

# K2-K4 against their plain versions, as relative errors of the norm.  f32:
# the same products summed in another order.  bf16: both round to bf16 at the
# same places, and another f32 summation order lands some values one bf16
# ulp (2^-8 relative) apart; the gradient agrees to 2.5 ulps of its norm.
# K4 is elementwise in f32 after one norm: rtol 1e-5 / atol 1e-7, the JAX
# package's tolerance for its optimizer kernel; its staged copy is bitwise.
# K8-K10 are K2's and K3's device code: the same tolerances.
TOL_UPDATE = {"f32": dict(val=2e-4, grad=1e-4, stat=1e-4),
              "bf16": dict(val=2.0 ** -7, grad=2.5 * 2.0 ** -8, stat=1e-2)}
TOL_K4_RTOL, TOL_K4_ATOL = 1e-5, 1e-7
# K3's and K9's pass 2 against torch.matmul on pass 1's own scratch rows: the
# same f32 products summed in another order
TOL_SPLIT = 1e-4
# fused update() against the xla update(), f32: the CPU test's tolerances
TOL_PARAM_RTOL, TOL_PARAM_ATOL, TOL_STAT_RTOL, TOL_STAT_ATOL = 1e-4, 1e-6, 1e-4, 1e-6

ADAM = dict(entropy_coef=-0.01, b1=0.9, b2=0.999, eps=1e-8, max_norm=1.0)
GAMMA, LAM = 0.995, 0.95


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
def substep_op_count(model, cfg, plane=True):
    """f32 operations of one substep for one env (K1, or K5 with plane
    False), counted from the loop trip counts of csrc/substep.cu (a
    multiply-add is 2; sin, cos, sqrt, rsqrt and a division 1 each)."""
    import numpy as np

    from booster_gym_torch.physics.engine import ancestor_dof_mask

    nb, nd, npt = model.num_bodies, model.num_dofs, model.num_points
    nv = 6 + nd
    anc = ancestor_dof_mask(model)
    n_anc = int(anc.sum())
    ops = 0
    ops += 30 + (nb - 1) * (45 + 15 + 3 + 45 + 2 + 36 + 45 + 15 + 3 + 9)  # FK
    ops += nb * (15 + 3 + 45 + 30 + 5 + 24 + 3)                         # inertias
    ops += (nb - 1) * 10                                                # composite
    ops += nd * 48 + int(np.tril(anc[1:, :]).sum()) * 11 + nv           # mass matrix
    ops += sum(2 * i + 1 + (nv - i - 1) * (2 * i + 1) for i in range(nv))  # Cholesky
    ops += sum(2 * (j - i - 1) + 3 for i in range(nv) for j in range(i + 1, nv))  # L^-1
    ops += sum(2 * (nv - j) for i in range(nv) for j in range(i, nv))   # G
    minv = 2 * nv * nv
    ops += (nb - 1) * (12 + 12 + 18 + 6) + nb * (2 * 45 + 27 + 6)       # RNEA
    ops += (nb - 1) * 6 + 6 + 2 * nd * 5 + minv + 2 * nv                # C, rhs, u_free
    ops += n_anc * 6 * nv * 2 + 21 * 2 * n_anc                          # Lambda_b
    ops += npt * (15 + 3 + 3 + 1)                                       # points
    ops += (nb - 1) * 12                                                # free body vel.
    ops += npt * (9 * 4 + 9 * 4 + 9 * 4 + 2 + 9 * 3 + 3 + 12 + 1 + 9 + 12 + 7 + 6)
    wrench = npt * (9 + 6) + (nb - 1) * 6 + nd * 11 + minv
    sweep = wrench + nv + (nb - 1) * 12 + npt * (9 + 6 + 3 * 6 + 3 + 7 + 2 + 3)
    ops += cfg.solver_iterations * sweep + wrench + nv
    ops += 9 + 12 + 11 + 28 + 9 + nd * 6 + nb * 3                      # integrate
    if not plane:
        # depth from h; the approach speed along n (the full point velocity
        # and a dot product); per sweep the target along n, l . n, the
        # tangential vector and its norm, and the recombination about n
        ops += npt * (1 + 13) + cfg.solver_iterations * npt * (3 + 5 + 6 + 2 + 7)
    return ops


def substep_bytes(kernel):
    """Bytes the substep kernel must move per env: each input read once,
    each output written once (the model table is shared and negligible).
    K5 also reads h and n and writes the points' xy."""
    reads = kernel.nstate + kernel.ndyn + kernel.nd + 6
    writes = kernel.nstate + 3 * kernel.nb + 12 * kernel.nf
    if not kernel.plane:
        reads, writes = reads + 4 * kernel.npt, writes + 2 * kernel.npt
    return 4 * (reads + writes)


def control_bytes(kernel, sampled=True):
    """Bytes a control step must move per env: the state read once and
    written once, dyn, the targets, latched targets, gains and joint
    friction read, the latched targets and the torque sum written, the
    delay (int64) and the push read, the last substep's forces and feet
    written; K5 also reads h and n and writes the points' xy; the epilogue
    writes the foot edge points and, on K5 with its terrain and `sampled`
    (the call passes the field), the queries' heights and normals.  The
    torque limits, the edge offsets and the field are shared (the caller
    adds the field once)."""
    reads = kernel.nstate + kernel.ndyn + 5 * kernel.nd + 2 + 6
    writes = kernel.nstate + 2 * kernel.nd + 3 * kernel.nb + 12 * kernel.nf
    writes += 3 * kernel.nf * kernel.ne
    if not kernel.plane:
        reads, writes = reads + 4 * kernel.npt, writes + 2 * kernel.npt
        if kernel.sampler is not None and sampled:
            writes += 4 * kernel.nq
    return 4 * (reads + writes)


def epilogue_op_count(kernel, sampled=True):
    """f32 operations of the control step's epilogue for one env: 6 per
    edge coordinate; K5 with its terrain and `sampled` also ~50 per sampled
    query (the standalone sampler's count)."""
    ops = 18 * kernel.nf * kernel.ne
    if kernel.sampler is not None and sampled:
        ops += 50 * kernel.nq
    return ops


def point_terrain(terrain, model, B, seed):
    """K5's terrain inputs on the card: heights of `terrain`'s field at
    random xy over its tiles, and unit normals tilted up to ~0.3 rad."""
    import numpy as np
    import torch

    from booster_gym_torch.testing import point_terrain_inputs

    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, [terrain.env_width, terrain.env_length], (B, model.num_points, 2))
    h = terrain.heights(torch.as_tensor(xy.astype(np.float32), device="cuda"))
    n = point_terrain_inputs(model.num_points, B, seed + 1)[1]
    return h.contiguous(), torch.as_tensor(n, device="cuda")


def compare_kernel(name, kernel, plain, model, B, substeps=5, terrain=None, task="T1"):
    """K1 (or, with `terrain`, K5 on heights from its field and tilted
    normals) against the plain version for `substeps` substeps; each
    substep starts both from the plain version's state, so the comparison
    measures one substep's error, not chaotic divergence.  `task` names
    the config of the robot's default angles (T1Serial for the serial
    stand-in).  Returns max abs error."""
    import torch

    from booster_gym_torch.testing import rand_inputs

    from booster_gym_torch.physics import SimState

    state, dyn, tau, ef, et = rand_inputs(model, B, "cuda", seed=B,
                                          standing=name == "t1" and B % 1024 == 0, task=task)
    label = "K1" if kernel.plane else "K5"
    name = f"{label} {name}"
    worst = 0.0
    for i in range(substeps):
        z = torch.zeros_like(ef)
        args = (dyn, tau, ef if i == 0 else z, et if i == 0 else z)
        xy_k = xy_p = None
        if kernel.plane:
            s_k, f_k, fp_k, fR_k = kernel.step(state, *args)
            s_p, f_p, fp_p, fR_p = plain(state, *args)
        else:
            hn = point_terrain(terrain, model, B, seed=B + i)
            s_k, f_k, fp_k, fR_k, xy_k = kernel.terrain_form(state, *args, *hn)
            s_p, f_p, fp_p, fR_p, xy_p = plain.terrain_form(state, *args, *hn)
        torch.cuda.synchronize()
        fails = []
        for field in SimState.FIELDS:
            a, b = getattr(s_k, field), getattr(s_p, field)
            tol = TOL_STATE
            err = (a - b).abs()
            worst = max(worst, float(err.max()))
            rel = float((err / (b.abs() + 1e-6)).max())
            ok = bool((err <= tol + tol * b.abs()).all())
            log(f"  {name} B={B} substep {i} {field:12s} max_abs={float(err.max()):.3e} "
                f"max_rel={rel:.3e} tol={tol} {'ok' if ok else 'FAIL'}")
            if not ok:
                fails.append(field)
        for field, a, b, rtol, atol in (
                ("forces", f_k, f_p, TOL_FORCE_RTOL, TOL_FORCE_ATOL),
                ("feet_pos", fp_k, fp_p, TOL_STATE, TOL_STATE),
                ("feet_R", fR_k, fR_p, TOL_STATE, TOL_STATE),
                ("point_xy", xy_k, xy_p, 0.0, TOL_PTXY)):
            if a is None:
                continue
            err = (a - b).abs()
            worst = max(worst, float(err.max()))
            ok = bool((err <= atol + rtol * b.abs()).all())
            log(f"  {name} B={B} substep {i} {field:12s} max_abs={float(err.max()):.3e} "
                f"tol=rtol {rtol}/atol {atol} {'ok' if ok else 'FAIL'}")
            if not ok:
                fails.append(field)
        if fails:
            raise AssertionError(f"{label} disagrees with its plain version ({name}, B={B}, "
                                 f"substep {i}): {fails}")
        state = s_p
    return worst


def compare_general_with_plane(name, k1, k5, model, B, substeps=5):
    """K5 on plane inputs (h = 0, n = +z) against K1 from the same states:
    every output must differ by exactly 0."""
    import torch

    from booster_gym_torch.testing import rand_inputs

    from booster_gym_torch.physics import SimState

    state, dyn, tau, ef, et = rand_inputs(model, B, "cuda", seed=B + 7,
                                          standing=name == "t1" and B % 1024 == 0)
    worst = 0.0
    for i in range(substeps):
        z = torch.zeros_like(ef)
        args = (state, dyn, tau, ef if i == 0 else z, et if i == 0 else z)
        out1, out5 = k1.step(*args), k5.step(*args)
        torch.cuda.synchronize()
        pairs = [(f, getattr(out1[0], f), getattr(out5[0], f)) for f in SimState.FIELDS]
        pairs += list(zip(("forces", "feet_pos", "feet_R"), out1[1:], out5[1:]))
        diffs = {f: float((a - b).abs().max()) for f, a, b in pairs}
        worst = max(worst, *diffs.values())
        state = out1[0]
    log(f"  K5 on plane inputs minus K1, {name} B={B}, {substeps} substeps: max abs diff {worst}")
    require(worst == 0.0, f"K5 on plane inputs differs from K1 ({name}, B={B}): {diffs}")


def substep_loop(kernel, args, decimation=10):
    """The decimation loop in PyTorch around ten single-substep launches
    (packed_call): the loop the env ran before control_step."""
    import torch

    psim, pdyn, targets, last, delay, kp, kd, fric, lim, ext, ph, pn = args
    nd = kernel.nd
    p_last, p_ext = last.T, ext.T.contiguous()
    p_tsum = torch.zeros_like(p_last)
    for i in range(decimation):
        p_last = torch.where((delay == i)[None, :], targets.T, p_last)
        pd = kp.T * (p_last - psim[13:13 + nd]) - kd.T * psim[13 + nd:]
        f = torch.minimum(torch.abs(pd), fric.T) * torch.sign(pd)
        p_tau = torch.minimum(torch.maximum(pd - f, -lim[:, None]), lim[:, None]).contiguous()
        psim, pf, pfeet, pxy = kernel.packed_call(
            psim, pdyn, p_tau, p_ext if i == 0 else torch.zeros_like(p_ext), ph, pn)
        p_tsum = p_tsum + p_tau
    return psim, p_last.T, p_tsum.T, pf, pfeet, pxy


def compare_control(name, kernel, model, B, terrain=None, task="T1"):
    """control_step (one launch) against the plain decimation loop from the
    same env-like inputs, to the env step's tolerance, on every env whose
    plain trajectory is not chaotic (see below), and finite exactly where
    the plain loop is; launched twice, the two must be equal bitwise.  Also
    reported, not held: the difference from ten single-substep launches, and the state's difference from the plain loop
    on rand_inputs' random states (tumbling bodies hitting the ground; the
    single-substep check of phase 3 holds those states to 2e-3 one substep
    at a time).  `task` names the config of the robot's default angles and
    gains.  Returns (max abs error against the plain loop over the held
    envs, the share of envs left out)."""
    import torch

    from booster_gym_torch.testing import control_inputs

    label = "K1" if kernel.plane else "K5"
    args = control_inputs(kernel, model, B, "cuda", seed=B + 11, terrain=terrain, task=task)
    out, out2 = kernel.control_step(*args), kernel.control_step(*args)
    ref = kernel.control_step_plain(*args)
    nudged = list(args)
    nudged[0] = torch.nextafter(args[0], torch.full_like(args[0], float("inf")))
    ref_nudged = kernel.control_step_plain(*nudged)
    loop = substep_loop(kernel, args)
    rargs = control_inputs(kernel, model, B, "cuda", seed=B + 17, upright=False,
                           terrain=terrain, task=task)
    random_err = float((kernel.control_step(*rargs)[0]
                        - kernel.control_step_plain(*rargs)[0]).abs().max())
    torch.cuda.synchronize()
    # the torque sum compared as the mean over the substeps, as the env
    # returns it (a sum of 10 torques at kp ~ 200 carries the state's
    # rounding times 2000)
    names = ("state", "last_targets", "torque_mean", "forces", "feet", "point_xy", "edges")
    fields = []
    for what, a, b, c in zip(names, out, ref, ref_nudged):
        if a is None:
            continue
        if what == "torque_mean":
            a, b, c = a / 10, b / 10, c / 10
        if what == "edges":   # [B, 3, nf ne] -> [B, 3 nf ne]
            a, b, c = (x.reshape(x.shape[0], -1) for x in (a, b, c))
        rtol, atol = {"forces": (TOL_FORCE_RTOL, TOL_FORCE_ATOL),
                      "point_xy": (0.0, TOL_PTXY)}.get(what, (TOL_ENV, TOL_ENV))
        env_dim = 0 if what in ("last_targets", "torque_mean", "edges") else 1
        over = lambda x, y: ((x - y).abs() > atol + rtol * y.abs()).transpose(0, env_dim).any(1)
        fields.append((what, a, b, over(a, b), over(c, b), rtol, atol, env_dim))
    # Ten substeps of contact (activation at zero margin, the bounce gate,
    # the friction cone) are chaotic in a few envs: there a one-ulp nudge of
    # the state moves the plain loop's own new state past the tolerance, and
    # no other rounding can be held to it.  Those envs are counted, at most
    # 1% of them, and left out; every other env is held to every tolerance.
    chaotic = fields[0][4]
    keep = ~chaotic
    worst, fails = 0.0, []
    for what, a, b, bad, _, rtol, atol, env_dim in fields:
        finite = torch.isfinite(b)
        same_finite = torch.equal(torch.isfinite(a), finite)
        err = torch.where(finite, (a - b).abs(), 0.0)
        held = float(err.transpose(0, env_dim)[keep].max())
        worst = max(worst, held)
        ok = same_finite and not bool(bad[keep].any())
        log(f"  {label} control step {name} B={B} {what:12s} max_abs={held:.3e} (all envs "
            f"{float(err.max()):.3e}) tol=rtol {rtol}/atol {atol} {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(what)
    n_chaotic = int(chaotic.sum())
    n_nonfinite = int((~torch.isfinite(ref[0]).all(0)).sum())
    log(f"  {label} control step {name} B={B}: {n_chaotic} envs ({n_chaotic / B:.2%}) chaotic "
        f"(the plain loop's state moves past the tolerance under a one-ulp nudge of the state) "
        f"and left out; {n_nonfinite} envs non-finite in the plain loop, the same in the kernel")
    require(n_chaotic <= B // 100, f"{label}: {n_chaotic} of {B} envs chaotic ({name})")
    rerun = max(float((a - b).abs().max()) for a, b in zip(out, out2) if a is not None)
    vs_loop = max(float((a - b).abs().max()) for a, b in zip(out, loop) if a is not None)
    log(f"  {label} control step {name} B={B}: run-to-run max abs diff {rerun}; against ten "
        f"single-substep launches {vs_loop}; state max abs diff from the plain loop on random "
        f"states {random_err:.3e} (reported, not held)")
    require(not fails, f"{label}'s control step disagrees with the plain loop ({name}, B={B}): "
            f"{fails}")
    require(rerun == 0.0, f"{label}'s control step does not repeat bitwise ({name}, B={B})")
    return worst, n_chaotic / B


def compare_control_general_with_plane(name, k1, k5, model, B):
    """K5's control step on plane inputs against K1's: difference 0; and
    K1's and K5's single substeps, each launched twice: bitwise equal."""
    import torch

    from booster_gym_torch.testing import control_inputs

    args = control_inputs(k1, model, B, "cuda", seed=B + 13)
    args5 = list(args)
    args5[10] = torch.zeros((model.num_points, B), device="cuda")
    args5[11] = torch.zeros((3 * model.num_points, B), device="cuda")
    args5[11][2::3] = 1.0
    out1, out5 = k1.control_step(*args), k5.control_step(*args5)
    tau = torch.zeros((model.num_dofs, B), device="cuda")
    ext = args[9].T.contiguous()
    steps = [lambda: k1.packed_call(args[0], args[1], tau, ext),
             lambda: k5.packed_call(args[0], args[1], tau, ext, args5[10], args5[11])]
    runs = [(f(), f()) for f in steps]
    torch.cuda.synchronize()
    diff = max(float((a - b).abs().max())
               for a, b in zip(out1[:5] + (out1.edges,), out5[:5] + (out5.edges,)))
    rerun = max(float((a - b).abs().max()) for r1, r2 in runs for a, b in zip(r1[:3], r2[:3]))
    log(f"  K5 on plane inputs minus K1 through control_step, {name} B={B}: max abs diff "
        f"{diff} (foot edge points included); K1 and K5 single substep run-to-run {rerun}")
    require(diff == 0.0, f"K5's control step on plane inputs differs from K1's ({name}, B={B})")
    require(rerun == 0.0, f"a single substep does not repeat bitwise ({name}, B={B})")


def compare_fused_sampling(name, k5, model, terrain, B):
    """K5's control step with the field (its epilogue samples the terrain):
    the foot edge points against the torch ops on the kernel's own feet
    poses, bitwise; the heights and normals against the standalone sampler
    kernel on the kernel's own queries (contact points' xy, root, edge
    points), bitwise, and against the sampler's plain version to
    TOL_SAMPLER.  Returns max abs error against the plain version."""
    import torch

    from booster_gym_torch.physics.substep_kernel import feet_edge_world
    from booster_gym_torch.testing import control_inputs

    args = control_inputs(k5, model, B, "cuda", seed=B + 19, terrain=terrain)
    n0 = (k5.launches, k5.fused_sampler_launches, k5.sampler.launches)
    out = k5.control_step(*args, terrain.height_field)
    nf, ne, npt = k5.nf, k5.ne, k5.npt
    fe = out.feet.T.reshape(B, nf, 12)
    edge_xyz = feet_edge_world(fe[..., 0:3], fe[..., 3:12].reshape(B, nf, 3, 3), k5.edge_list)
    root_xy = out.state[0:2].T.contiguous()
    queries = torch.cat([out.ptxy.T.reshape(B, npt, 2), root_xy[:, None, :],
                         torch.stack([edge_xyz[0].reshape(B, -1), edge_xyz[1].reshape(B, -1)],
                                     -1)], dim=1).contiguous()
    h, n = k5.sampler(terrain.height_field, root_xy, queries)
    h_p, n_p = k5.sampler.plain(terrain.height_field, root_xy, queries)
    torch.cuda.synchronize()
    counts = tuple(c - c0 for c, c0 in zip(
        (k5.launches, k5.fused_sampler_launches, k5.sampler.launches), n0))
    edges = out.edges.view(B, 3, nf, ne).unbind(1)
    d_edge = max(float((a - b).abs().max()) for a, b in zip(edges, edge_xyz))
    fh, fn = out.heights, out.normals
    d_h, d_n = float((fh - h).abs().max()), float((fn - n).abs().max())
    e_h, e_n = float((fh - h_p).abs().max()), float((fn - n_p).abs().max())
    log(f"  K5 fused sampling {name} B={B} ({k5.nq} queries): edge points minus the torch ops "
        f"{d_edge}; heights and normals minus the standalone sampler kernel's {d_h}, {d_n}; "
        f"against its plain version max abs h {e_h:.2e} n {e_n:.2e} (tol {TOL_SAMPLER}); "
        f"launches control/fused/standalone {counts}")
    require(d_edge == 0.0, f"the epilogue's edge points differ from the torch ops ({name}, B={B})")
    require(d_h == 0.0 and d_n == 0.0,
            f"the fused sampling differs from the sampler kernel ({name}, B={B})")
    require(max(e_h, e_n) <= TOL_SAMPLER, f"the fused sampling disagrees with the plain "
            f"sampler ({name}, B={B})")
    require(counts == (1, 1, 1) and float(fh.abs().max()) > 0, "the fused sampling's launches")
    return max(e_h, e_n)


def compare_gae_past_planes(dtype, B=1000):
    """K2 at horizons past the planes its shared memory holds (T + 1 =
    k2_max_planes + 1 and 2 k2_max_planes): against its plain version at
    TOL_UPDATE's val and stat, launched twice with the spill poisoned with
    NaN between, bitwise equal.  Returns max abs error of adv and returns."""
    import torch

    from booster_gym_torch.testing import update_case

    tol = TOL_UPDATE[dtype]
    most = update_case(dtype, 1, 8, "cuda")[0].info(torch.device("cuda"))["k2_max_planes"]
    worst = 0.0
    for planes in (most + 1, 2 * most):
        T = planes - 1
        fused, p, staged, prep, d = update_case(dtype, T, B, "cuda", seed=planes)
        rew, nonterm, tf = gae_inputs(d)
        out = fused.gae(staged, prep["obsc"], rew, nonterm, tf, GAMMA, LAM)
        fused.k2_scratch(staged.device, 0)["spill"].fill_(float("nan"))
        out2 = fused.gae(staged, prep["obsc"], rew, nonterm, tf, GAMMA, LAM)
        ref = fused.gae_plain(staged, prep["obsc"], rew, nonterm, tf, GAMMA, LAM)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(out, ref)]
        rerun = float(torch.stack([(a - b).abs().max() for a, b in zip(out, out2)]).max())
        log(f"  K2 {dtype} T + 1 = {planes} planes ({planes - most} spilled), B={B}: rel err adv "
            f"{errs[0]:.2e} returns {errs[1]:.2e} (tol {tol['val']:.1e}) sum {errs[2]:.2e} sum^2 "
            f"{errs[3]:.2e} (tol {tol['stat']:.1e}); run-to-run max abs diff {rerun:.1e}")
        require(max(errs[:2]) <= tol["val"] and max(errs[2:]) <= tol["stat"],
                f"K2 past its planes disagrees with its plain version ({dtype}, {planes})")
        require(rerun == 0.0, f"K2 past its planes does not repeat bitwise ({dtype}, {planes})")
        worst = max(worst, *(float((a - b).abs().max()) for a, b in zip(out[:2], ref[:2])))
    return worst


def compare_sampler(sampler, terrain, B, clamped):
    """The terrain sampler against its plain version on T1.yaml's field;
    `clamped` puts roots at the field's edge and queries up to 2 m from
    their root.  Returns max abs error."""
    import torch

    from booster_gym_torch.testing import sampler_inputs

    root, pts = (torch.as_tensor(x, device="cuda") for x in sampler_inputs(
        terrain, B, sampler.num_points, 2.0 if clamped else 0.55, clamped, seed=B))
    h, n = sampler(terrain.height_field, root, pts)
    h_p, n_p = sampler.plain(terrain.height_field, root, pts)
    torch.cuda.synchronize()
    e_h, e_n = float((h - h_p).abs().max()), float((n - n_p).abs().max())
    direct = float((h - terrain.heights(pts)).abs().max())
    log(f"  sampler B={B} N={sampler.num_points} {'clamped' if clamped else 'inside '}: max abs "
        f"h {e_h:.2e} n {e_n:.2e} (tol {TOL_SAMPLER}); against the whole-field query "
        f"{direct:.2e}")
    require(max(e_h, e_n) <= TOL_SAMPLER, f"the sampler disagrees with its plain version (B={B})")
    require(direct > 1e-3 if clamped else direct <= TOL_SAMPLER,
            f"the sampler's patch clamp (B={B}, clamped={clamped})")
    return max(e_h, e_n)


def to_device(obj, device):
    """Dataclass of tensors (nested) onto `device`."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: to_device(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj)})
    return obj


def rel_err(a, b):
    return float((a - b).norm() / b.norm())


def require(ok, what):
    if not ok:
        raise AssertionError(what)


def gae_inputs(d):
    rew, done, timeout = d["buf"][5:]
    return rew, 1.0 - (done | timeout).float(), timeout.float()


def adam_inputs(p, seed):
    import torch

    gen = torch.Generator(device=p.device).manual_seed(seed)
    rand = lambda scale: scale * torch.randn(p.shape, generator=gen, device=p.device)
    return rand(0.3), rand(1e-2), rand(1e-3).abs(), torch.tensor(1e-3, device=p.device)


def check_pass2(fused, g, n, label):
    """K3's or K9's weight and bias gradients g against dz^T x and the row
    sums of the scratch rows that its own pass 1 wrote (torch.matmul in
    f32, used here only as the check).  Returns the max rel err."""
    import torch

    views = fused.scratch_views(torch.device("cuda"), n)
    worst = 0.0
    for (net, l), (x, dz) in views.items():
        w, b, o, i = fused.layers[net][l]
        worst = max(worst, rel_err(g[w:w + o * i].view(o, i), dz.float().T @ x.float()),
                    rel_err(g[b:b + o], dz.float().sum(0)))
    log(f"  {label}: pass 2 against dz^T x of pass 1's rows (8 layers): max rel err {worst:.2e} "
        f"(tol {TOL_SPLIT:.0e})")
    require(worst <= TOL_SPLIT, f"{label}: pass 2 disagrees with pass 1's rows")
    return worst


def compare_k3(fused, args, tol, n, tag):
    """K3 (grads_stats) on `args` over n rows against its plain version on
    the card: launched twice, the second call must repeat the first
    bitwise, and both must agree with grads_stats_plain within `tol`;
    then pass 2 against pass 1's scratch rows.  Returns the largest abs
    error of the gradient."""
    import torch

    self_old = args[-1]
    g, st, mu, logp = fused.grads_stats(*args)
    g2, st2, _, _ = fused.grads_stats(*args)
    g_p, st_p, mu_p, logp_p = fused.grads_stats_plain(*args)
    torch.cuda.synchronize()
    rerun = float((g - g2).abs().max())
    e_g = max(rel_err(g[w:w + o * i], g_p[w:w + o * i])
              for net in ("actor", "critic") for w, _, o, i in fused.layers[net])
    e_b = max(rel_err(g[b:b + o], g_p[b:b + o])
              for net in ("actor", "critic") for _, b, o, _ in fused.layers[net])
    e_ls = rel_err(g[fused.logstd_slice], g_p[fused.logstd_slice])
    e_mu, e_lp = rel_err(mu, mu_p), rel_err(logp, logp_p)
    # the actor-loss sum cancels (normalised advantages, and with
    # self_old the ratio is 1), so it is held to a share of sum |terms|
    e_st = max((abs(float(st[k]) - float(st_p[k]))
                - (1e-2 * tol["stat"] * n if k == "al" else 1e-6))
               / max(abs(float(st_p[k])), 1e-30) for k in ("vl", "al", "bhi", "blo"))
    kl = float(st["klsq"].abs().max()) if self_old else rel_err(st["klsq"], st_p["klsq"])
    log(f"  K3 {tag} self_old={int(self_old)}: rel err per leaf: weights {e_g:.2e} biases "
        f"{e_b:.2e} (tol {tol['grad']:.1e}) dlogstd {e_ls:.2e}; mu {e_mu:.2e} logp "
        f"{e_lp:.2e} (tol {tol['val']:.1e}); sums, past their atol, {max(e_st, 0.0):.2e} "
        f"(tol {tol['stat']:.1e}); "
        f"klsq {'max abs' if self_old else 'rel err'} {kl:.2e}; run-to-run max abs "
        f"diff {rerun:.1e}")
    require(max(e_g, e_b) <= tol["grad"] and e_ls <= 10 * tol["grad"]
            and e_mu <= tol["val"] and e_lp <= 10 * tol["val"] and e_st <= tol["stat"],
            f"K3 disagrees with its plain version ({tag}, self_old={self_old})")
    require(kl == 0.0 if self_old else kl <= 10 * tol["stat"], f"K3 klsq ({tag})")
    require(rerun == 0.0, f"K3 does not repeat bitwise ({tag})")
    check_pass2(fused, g, n, f"K3 {tag} self_old={int(self_old)}")
    return float((g - g_p).abs().max())


def compare_update_kernels(dtype, B, T=24, dims=None):
    """K2, K3 (both old-policy modes) and K4 against their plain versions
    on the card at [T, B], for a network of `dims` (actions, observations,
    privileged observations; T1's by default).  Returns {kernel: max abs
    error}."""
    import torch

    from booster_gym_torch.testing import T1_DIMS, update_case

    dims = dims or T1_DIMS
    tol = TOL_UPDATE[dtype]
    tag = f"{dtype} N={T * B}" + ("" if dims == T1_DIMS else f" dims {dims}")
    fused, p, staged, prep, d = update_case(dtype, T, B, "cuda", seed=B, dims=dims)
    worst = {}

    rew, nonterm, tf = gae_inputs(d)
    out = fused.gae(staged, prep["obsc"], rew, nonterm, tf, GAMMA, LAM)
    # the blocks' partial sums poisoned between the calls: a partial that the
    # summing block reads before its writer stored it shows as NaN, where a
    # stale copy of the first call's would repeat it bitwise
    fused.k2_scratch(staged.device, 0)["part"].fill_(float("nan"))
    out2 = fused.gae(staged, prep["obsc"], rew, nonterm, tf, GAMMA, LAM)
    ref = fused.gae_plain(staged, prep["obsc"], rew, nonterm, tf, GAMMA, LAM)
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip(out, ref)]
    rerun = float(torch.stack([(a - b).abs().max() for a, b in zip(out, out2)]).max())  # NaN stays
    log(f"  K2 {tag}: rel err adv {errs[0]:.2e} returns {errs[1]:.2e} (tol {tol['val']:.1e}) "
        f"sum {errs[2]:.2e} sum^2 {errs[3]:.2e} (tol {tol['stat']:.1e}); run-to-run max abs "
        f"diff {rerun:.1e}")
    require(max(errs[:2]) <= tol["val"] and max(errs[2:]) <= tol["stat"],
            f"K2 disagrees with its plain version ({tag})")
    require(rerun == 0.0, f"K2 does not repeat bitwise ({tag})")
    worst["K2"] = max(float((a - b).abs().max()) for a, b in zip(out[:2], ref[:2]))

    mean, rstd = d["adv"].mean(), 1.0 / (d["adv"].std() + 1e-8)
    worst["K3"] = max(compare_k3(fused, (staged, p, prep, d["adv"], d["ret"], mean, rstd, self_old),
                                 tol, T * B, tag) for self_old in (False, True))

    gr, m, v, lr = adam_inputs(p, seed=B)
    out = fused.opt_stage(gr, p, m, v, 7, lr, **ADAM)
    out2 = fused.opt_stage(gr, p, m, v, 7, lr, **ADAM)
    ref = fused.opt_stage_plain(gr, p, m, v, 7, lr, **ADAM)
    torch.cuda.synchronize()
    errs = [float((a - b).abs().max()) for a, b in zip(out[:3], ref[:3])]
    ok = all(bool(((a - b).abs() <= TOL_K4_ATOL + TOL_K4_RTOL * b.abs()).all())
             for a, b in zip(out[:3], ref[:3]))
    rerun = max(float((a - b).abs().max()) for a, b in zip(out[:3], out2[:3]))
    staged_ok = bool(torch.equal(out[3], out[0].to(fused.dtype)))
    log(f"  K4 {tag.split()[0]} n={fused.n_params}: max abs p {errs[0]:.2e} m {errs[1]:.2e} v "
        f"{errs[2]:.2e} (tol rtol {TOL_K4_RTOL}/atol {TOL_K4_ATOL}); staged is the cast "
        f"bitwise: {staged_ok}; run-to-run max abs diff {rerun:.1e}")
    require(ok and staged_ok and rerun == 0.0, f"K4 disagrees with its plain version ({tag})")
    worst["K4"] = max(errs)
    return worst


def compare_fused_with_xla(urdf, mini_epochs=3):
    """The whole fused update() against the xla update() on the card, f32,
    from the same parameters, Adam state and rollout buffers."""
    import types

    import torch

    from booster_gym_torch.algo.ppo import PPO, OptState, flat_params
    from booster_gym_torch.testing import main_path_cfg, update_inputs

    env = types.SimpleNamespace(num_actions=12, num_obs=47, num_privileged_obs=14)
    out = {}
    for backend in ("fused", "xla"):
        cfg = main_path_cfg(urdf)
        cfg["algorithm"].update(update_backend=backend, compute_dtype="f32")
        cfg["runner"]["mini_epochs"] = mini_epochs
        ppo = PPO(env, cfg, "cuda")
        ppo.network.reset_parameters(torch.Generator(device="cuda").manual_seed(11))
        d = update_inputs(ppo.network, 24, 4096, "cuda", seed=12)
        _, m, v, lr = adam_inputs(flat_params(ppo.network), seed=13)
        ts = types.SimpleNamespace(opt=OptState(m=m.abs() * 0.1, v=v * 0.01, count=7), lr=lr)
        opt, lr2, stats = ppo.update(ts, (None, d["obs_last"], d["priv_last"]), d["buf"])
        torch.cuda.synchronize()
        out[backend] = (flat_params(ppo.network), opt, lr2, stats)
        if backend == "fused":
            require(ppo.fused.grads_stats_launches == mini_epochs, "fused update launches")
    (p_f, opt_f, lr_f, st_f), (p_x, opt_x, lr_x, st_x) = out["fused"], out["xla"]
    dp, ds = (p_f - p_x).abs(), (st_f - st_x).abs()
    ok_p = bool((dp <= TOL_PARAM_ATOL + TOL_PARAM_RTOL * p_x.abs()).all())
    ok_s = bool((ds <= TOL_STAT_ATOL + TOL_STAT_RTOL * st_x.abs()).all())
    log(f"fused update() vs xla update() on the card (f32, N=98304, {mini_epochs} mini-epochs): "
        f"params max abs {float(dp.max()):.2e} (rtol {TOL_PARAM_RTOL}/atol {TOL_PARAM_ATOL}) "
        f"{'ok' if ok_p else 'FAIL'}; statistics max abs {float(ds.max()):.2e} (rtol "
        f"{TOL_STAT_RTOL}/atol {TOL_STAT_ATOL}) {'ok' if ok_s else 'FAIL'}; lr {float(lr_f):.6g} "
        f"vs {float(lr_x):.6g}; count {opt_f.count} vs {opt_x.count}")
    require(ok_p and ok_s and float(lr_f) == float(lr_x) and opt_f.count == opt_x.count == 10,
            "the fused update disagrees with the xla update on the card")


def compare_anchor_kernels(dtype, B, T=24, dims=None):
    """K8, K9 (launched twice) and K10 against their plain versions on the
    card at [T, B], for a network of `dims` (T1's by default); then the
    cross-checks on the same data: K9 on normalised advantages against K3
    (self_old 0), K8 against K2's value pass and K9's values, K10 against
    K3's self_old forward.  Returns {kernel: max abs error against the
    plain version}."""
    import torch

    from booster_gym_torch.testing import T1_DIMS, anchor_case, seeded_network

    dims = dims or T1_DIMS
    tol = TOL_UPDATE[dtype]
    tag = f"{dtype} N={T * B}" + ("" if dims == T1_DIMS else f" dims {dims}")
    fused, p, d = anchor_case(seeded_network(dtype, "cuda", B, dims), T, B, "cuda", seed=B)
    obs, priv, act, old_logp = d["obs"], d["priv"], d["act"], d["old_logp"]
    gen = torch.Generator(device="cuda").manual_seed(B)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    prep = fused.prepare(obs, priv, act, torch.zeros_like(act), old_logp, rnd(B, dims[1]),
                         rnd(B, dims[2]))

    v, v_p = fused.values(p, obs, priv), fused.values_plain(p, obs, priv)
    args = (p, obs, priv, act, d["adv"], d["ret"], old_logp)
    g, mu, val = fused.grads(*args)
    g2, mu2, val2 = fused.grads(*args)
    g_p, mu_p, val_p = fused.grads_plain(*args)
    mu10, logp10 = fused.policy_old_logp(p, prep)
    mu10_p, logp10_p = fused.policy_old_logp_plain(p, prep)
    torch.cuda.synchronize()
    e_v = rel_err(v, v_p)
    tile = fused.info(torch.device("cuda"))["k2_tile"]
    log(f"  K8 {tag}: rel err {e_v:.2e} (tol {tol['val']:.1e}); {T * B} rows, "
        f"{'a ragged last' if (T * B) % tile else 'no ragged'} tile of {tile}")
    require(e_v <= tol["val"], f"K8 disagrees with its plain version ({tag})")
    rerun = max(float((a - b).abs().max()) for a, b in ((g, g2), (mu, mu2), (val, val2)))
    e_g = max(rel_err(g[w:w + o * i], g_p[w:w + o * i])
              for net in ("actor", "critic") for w, _, o, i in fused.layers[net])
    e_b = max(rel_err(g[b:b + o], g_p[b:b + o])
              for net in ("actor", "critic") for _, b, o, _ in fused.layers[net])
    e_ls = rel_err(g[fused.logstd_slice], g_p[fused.logstd_slice])
    e_mu, e_val = rel_err(mu, mu_p), rel_err(val, val_p)
    log(f"  K9 {tag}: rel err per leaf: weights {e_g:.2e} biases {e_b:.2e} (tol "
        f"{tol['grad']:.1e}) dlogstd {e_ls:.2e}; mu {e_mu:.2e} values {e_val:.2e} (tol "
        f"{tol['val']:.1e}); run-to-run max abs diff {rerun:.1e}")
    require(max(e_g, e_b) <= tol["grad"] and e_ls <= 10 * tol["grad"]
            and max(e_mu, e_val) <= tol["val"], f"K9 disagrees with its plain version ({tag})")
    require(rerun == 0.0, f"K9 does not repeat bitwise ({tag})")
    check_pass2(fused, g, T * B, f"K9 {tag}")
    e_mu10, e_lp10 = rel_err(mu10, mu10_p), rel_err(logp10, logp10_p)
    log(f"  K10 {tag}: rel err mu {e_mu10:.2e} logp {e_lp10:.2e} (tol {tol['val']:.1e})")
    require(max(e_mu10, e_lp10) <= tol["val"], f"K10 disagrees with its plain version ({tag})")

    # the cross-checks between independently launched kernels
    staged = fused.stage(p)
    mean, rstd = d["adv"].mean(), 1.0 / (d["adv"].std() + 1e-8)
    g9, mu9, val9 = fused.grads(p, obs, priv, act, (d["adv"] - mean) * rstd, d["ret"], old_logp)
    g3, _, mu3, _ = fused.grads_stats(staged, p, prep, d["adv"], d["ret"], mean, rstd, False)
    # with no reward, no continuation and no timeout K2's advantage is -value
    zeros = torch.zeros(T, B, device="cuda")
    adv2 = fused.gae(staged, prep["obsc"], zeros, zeros, zeros, GAMMA, LAM)[0]
    _, _, mu_self, logp_self = fused.grads_stats(staged, p, prep, d["adv"], d["ret"], mean, rstd,
                                                 True)
    torch.cuda.synchronize()
    diff = lambda a, b: float((a - b).abs().max())
    d_g, d_mu = diff(g9, g3), diff(mu9.view(-1, fused.num_act), mu3.to(fused.dtype).float())
    d_v = max(diff(val9, v), diff(-adv2, v))
    d_10 = max(diff(mu10, mu_self), diff(logp10, logp_self))
    log(f"  cross-checks {tag}: K9 - K3 gradient max abs {d_g} (rel {rel_err(g9, g3):.2e}), mu "
        f"{d_mu}; K8 - K2 values (-adv at zero reward and nonterm) and K8 - K9 values {d_v}; K10 - K3 (self_old) mu and logp "
        f"{d_10}")
    require(d_v == 0.0 and d_10 == 0.0, f"K8 or K10 differs from K2 / K3 on the same rows ({tag})")
    require((d_g == 0.0 and d_mu == 0.0) or rel_err(g9, g3) <= tol["grad"],
            f"K9 disagrees with K3 on normalised advantages ({tag})")
    return {"K8": float((v - v_p).abs().max()), "K9": float((g - g_p).abs().max()),
            "K10": max(float((mu10 - mu10_p).abs().max()), float((logp10 - logp10_p).abs().max()))}


def time_k3_passes(card, fused, args, n, reps=20, dims=None):
    """K3's passes at n rows of a network of `dims` (T1's by default): the
    CUDA-event time of pass 1 (with the weight copy), pass 2 and the reduce
    within whole calls (events recorded between the passes), the device time
    and the count of each kernel under torch.profiler, and, as the yardstick
    beside pass 2 (never on the path), the CUDA-event time of the eight
    torch.matmul products dz_l^T x_l on pass 1's own rows, at the weight
    gradients' shapes; then the peak device memory of a first call with a
    fresh scratch."""
    import torch

    from booster_gym_torch.testing import (T1_DIMS, device_ms, per_call, seeded_network,
                                           time_cuda)

    fused.grads_stats(*args)
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(reps)]
    for ev in marks:
        for e in ev:
            e.record()    # creates the event, which the kernel library then records
    torch.cuda.synchronize()
    for ev in marks:
        fused.grads_stats_timed(*args, ev)
    torch.cuda.synchronize()
    events = {p: sum(ev[i].elapsed_time(ev[i + 1]) for ev in marks) / reps
              for i, p in enumerate(("pass1", "pass2", "reduce"))}
    names = ("k_pad", "k3_pass1", "k3_pass2", "k3_reduce")
    dev, count = device_ms(lambda: fused.grads_stats(*args), names)
    kernels = sum(count.values())
    require(all(per_call(c) == 1 for c in count.values()),
            f"K3 ran {count} device kernels per call, one each of {names} expected")
    views = fused.scratch_views(torch.device("cuda"), n)
    pairs = [(dz.T, x) for x, dz in views.values()]
    pass2_library_ms, _ = time_cuda(lambda: [torch.matmul(a, b) for a, b in pairs], reps)
    # a FusedUpdate of the same geometry with no scratch yet
    fresh = type(fused)(seeded_network("bf16", "cuda", 1, dims or T1_DIMS), fused.clip_ratio,
                        fused.bound_coef)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fresh.grads_stats(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    sc = fresh.k3_scratch(torch.device("cuda"), n)
    scratch = sc["rows"].numel() * sc["rows"].element_size() + sc["part"].numel() * 4
    log(f"K3 passes at N={n} bf16, {fused.num_crit}-wide critic [{card}]: CUDA events between "
        f"the passes of whole calls: "
        f"pass 1 {events['pass1']:.4f} ms (with the weight copy), pass 2 {events['pass2']:.4f} "
        f"ms, reduce {events['reduce']:.4f} ms; device time per kernel (torch.profiler): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in dev.items())
        + f"; {kernels:g} device kernels per call (torch.profiler); pass 2's yardstick, the 8 "
        f"torch.matmul products dz^T x of the same rows (bf16 out, CUDA events) "
        f"{pass2_library_ms:.4f} ms against pass 2's {events['pass2']:.4f} ms; scratch "
        f"{scratch / 1e6:.1f} MB ({sc['nslab']} slabs of {sc['slab_rows']} rows); peak device "
        f"memory of a first call {peak / 1e6:.1f} MB beyond its inputs")
    return {"pass1_ms": events["pass1"], "pass2_ms": events["pass2"],
            "reduce_ms": events["reduce"], "pass2_library_ms": pass2_library_ms,
            "device_ms": dev, "device_kernels": kernels, "scratch_bytes": scratch,
            "peak_bytes": peak}


# the benchmark cells' envs: K3 runs on T x CELL_B rows there
CELL_B = 16384


def cells_k3_passes(card, dims=None):
    """K3 at the benchmark cells' N = 24 x CELL_B = 393,216 rows, for a
    network of `dims` (T1's by default): its bitwise repeat and its plain
    version (compare_k3, bf16), then time_k3_passes."""
    from booster_gym_torch.testing import T1_DIMS

    T = 24
    fused, k3_args = update_plains(T, CELL_B, dims)[:2]
    tag = f"bf16 N={T * CELL_B}" + ("" if (dims or T1_DIMS) == T1_DIMS else f" dims {dims}")
    compare_k3(fused, k3_args, TOL_UPDATE["bf16"], T * CELL_B, tag)
    return time_k3_passes(card, fused, k3_args, T * CELL_B, dims=dims)


def time_k2_parts(card, T=24, B=4096):
    """K2 at the main path's shapes (prof_update's data), part by part:
    CUDA events between the weight copy and the critic kernel within whole
    calls, and each device kernel's time and count under torch.profiler (one
    each per call required)."""
    from booster_gym_torch import prof_update
    from booster_gym_torch.algo.ppo import flat_params
    from booster_gym_torch.algo.update_kernel import K2_KERNELS, FusedUpdate
    from booster_gym_torch.testing import per_call

    net, d = prof_update.make_data(T, B, "bf16", "cuda")
    d["p"] = flat_params(net)
    split = prof_update.k2_split(FusedUpdate(net, 0.2, 10.0), d)
    require(all(per_call(split["count"][k]) == 1 for k in K2_KERNELS),
            f"K2 ran {split['count']} device kernels per call, one each of {K2_KERNELS} "
            f"expected")
    log(f"K2 parts at N={T * B} bf16 [{card}]: CUDA events within whole calls: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in split["parts_ms"].items())
        + "; device time per kernel (torch.profiler): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in split["device_ms"].items())
        + f"; {split['device_kernels']:g} device kernels per call")
    return split


UPDATE_SRC = "booster_gym_tpu/algo/update_kernel.py"
UPDATE_META = {"K2": ("K2 gae (values + GAE)", f"{UPDATE_SRC}:217"),
               "K3": ("K3 grads_stats (gradients + metric sums)", f"{UPDATE_SRC}:381"),
               "K4": ("K4 opt_stage (clip + Adam + staging)", f"{UPDATE_SRC}:488"),
               "K8": ("K8 values (critic forward)", f"{UPDATE_SRC}:128"),
               "K9": ("K9 grads (row-major gradient anchor)", f"{UPDATE_SRC}:136"),
               "K10": ("K10 policy_old_logp (actor forward + log-prob)", f"{UPDATE_SRC}:358")}


def update_plains(T, B, dims=None):
    """(fused, K3's arguments, {kernel: a call of its plain version}) on
    update_case's data (bf16, seed 1) for a network of `dims` (T1's by
    default)."""
    from booster_gym_torch.testing import T1_DIMS, update_case

    fused, p, staged, prep, d = update_case("bf16", T, B, "cuda", seed=1, dims=dims or T1_DIMS)
    obs, priv, act = d["buf"][:3]
    rew, nonterm, tf = gae_inputs(d)
    mean, rstd = d["adv"].mean(), 1.0 / (d["adv"].std() + 1e-8)
    gr, m, v, lr = adam_inputs(p, seed=2)
    k3_args = (staged, p, prep, d["adv"], d["ret"], mean, rstd, False)
    plains = {
        "K2": lambda: fused.gae_plain(staged, prep["obsc"], rew, nonterm, tf, GAMMA, LAM),
        "K3": lambda: fused.grads_stats_plain(*k3_args),
        "K4": lambda: fused.opt_stage_plain(gr, p, m, v, 7, lr, **ADAM),
        "K8": lambda: fused.values_plain(p, obs, priv),
        "K9": lambda: fused.grads_plain(p, obs, priv, act, d["adv"], d["ret"], prep["old_logp"]),
        "K10": lambda: fused.policy_old_logp_plain(p, prep),
    }
    return fused, k3_args, (gr, p, m, v, lr), plains


def time_update_kernels(card, launches, max_err, prof):
    """The `kernels` entries of K2-K4 and K8-K10 at T = 24, B = 4096, bf16
    (the benchmark cells run B = 16384: cells_k3_passes): time per call, bound and work from
    prof_update's records `prof` (phase 4c), beside the plain version's
    time, measured here; for K3 also the passes (time_k3_passes), with
    the torch.matmul yardstick of pass 2 beside them."""
    from booster_gym_torch.testing import time_cuda

    T, B = 24, 4096
    fused, k3_args, adam, plains = update_plains(T, B)
    passes = time_k3_passes(card, fused, k3_args, T * B)
    passes["cells"] = cells_k3_passes(card)
    k2_parts = time_k2_parts(card)
    k4 = time_k4(card, fused, *adam, prof["K4"])
    entries = []
    for k, plain in plains.items():
        name, replaces = UPDATE_META[k]
        rec = prof[k]
        plain_ms, _ = time_cuda(plain, 5)
        log(f"{k} at N={T * B} bf16 [{card}]: {rec['ms']:.4f} ms/call (prof_update); plain "
            f"version {plain_ms:.3f} ms; bound {rec['bound_ms'] * 1e3:.2f} us by "
            f"{rec['bound_by']} ({rec['bytes'] / 1e6:.2f} MB, {rec['operations'] / 1e9:.3f} Gop "
            f"at {'67 TFLOP/s f32' if k == 'K4' else '989 TFLOP/s bf16 tensor cores'}); "
            f"library: none")
        entry = {
            "name": name, "route": "cuda", "source": "booster_gym_torch/csrc/update.cu",
            "replaces": replaces, "launches": launches[k], "max_abs_err": max_err[k],
            "ms": rec["ms"], "plain_ms": plain_ms, "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None}
        if k == "K3":
            entry["passes"] = passes
        if k == "K2":
            entry["parts"] = k2_parts
        if k == "K4":
            entry.update(k4)
        entries.append(entry)
    return entries


def time_k4(card, fused, g, p, m, v, lr, rec, reps=50):
    """K4 at the main path's shapes (bf16, the T1 networks' parameters):
    its device time and device kernels per call under torch.profiler (one
    required), and its yardstick (never on the path), by CUDA events on
    the same flat vectors: torch.linalg.vector_norm, torch._fused_adam_ with
    the clip as grad_scale (the gradients are divided by it) and the cast
    of the parameters to bf16.  The yardstick leaves out the entropy
    coefficient and updates its own copies in place."""
    import torch

    from booster_gym_torch.testing import device_kernels, per_call, time_cuda

    kw = dict(ADAM)
    call = lambda: fused.opt_stage(g, p, m, v, 7, lr, **kw)
    kernels = device_kernels(call)
    require(len(kernels) == 1 and "k4_opt" in next(iter(kernels))
            and per_call(next(iter(kernels.values()))[0]) == 1,
            f"K4 ran {kernels} device kernels per call, one k4_opt expected")
    dev_ms = next(iter(kernels.values()))[1]   # one launch per call
    pp, mm, vv = p.clone(), m.clone(), v.clone()
    step = [torch.tensor(7.0, device=p.device)]
    lr_f, max_norm = float(lr), kw["max_norm"]

    def yardstick():
        scale = torch.clamp(torch.linalg.vector_norm(g) / max_norm, min=1.0)
        torch._fused_adam_([pp], [g], [mm], [vv], [], step, lr=lr_f, beta1=kw["b1"],
                           beta2=kw["b2"], weight_decay=0.0, eps=kw["eps"], amsgrad=False,
                           maximize=False, grad_scale=scale, found_inf=None)
        return pp.to(torch.bfloat16)

    yard_ms, _ = time_cuda(yardstick, reps)
    log(f"K4 at n={fused.n_params} bf16 [{card}]: {rec['ms']:.4f} ms/call by CUDA events "
        f"(prof_update, host-bound); device {dev_ms * 1e3:.2f} us per call, one device "
        f"kernel per call (torch.profiler); bound "
        f"{rec['bound_ms'] * 1e3:.2f} us; yardstick (vector_norm + _fused_adam_ + cast, CUDA "
        f"events) {yard_ms:.4f} ms/call")
    return {"device_ms": dev_ms, "device_kernels": 1, "yardstick_ms": yard_ms}


# ---------------------------------------------------------------------------
JAX_CKPT = os.path.join(ROOT, "logs", "2026-08-17-04-03-56", "nn", "model_1100.ckpt")


def check_restored(label, runner, ts, saved):
    """Every piece of a port checkpoint restored bitwise by _init_state."""
    from booster_gym_torch.testing import restored_pieces

    checks = restored_pieces(runner, ts, saved)
    log(f"  {label}: restored bitwise {checks}")
    require(all(checks.values()), f"{label}: a piece was not restored bitwise")


def zero_counts(runner):
    env, fused = runner.env, runner.ppo.fused
    env.substep.launches = env.substep.fused_sampler_launches = 0
    if env.terrain_sampler is not None:
        env.terrain_sampler.launches = 0
    fused.gae_launches = fused.grads_stats_launches = fused.opt_stage_launches = 0


def resume_play_export(card, urdf):
    """Phase 7: resume on the card (7a), the JAX package's checkpoint
    played on the plane and on T1.yaml's terrain (7b), and the TorchScript
    export of both checkpoints (7c)."""
    import glob

    import numpy as np
    import torch

    from booster_gym_torch import export as port_export
    from booster_gym_torch.algo.ppo import flat_params
    from booster_gym_torch.runner import Runner, _Timer
    from booster_gym_torch.testing import main_path_cfg, rough_path_cfg
    from booster_gym_torch.utils.recorder import load_checkpoint

    # phases 1-6 leave garbage in reference cycles (the profiler's events
    # among it); until a full collection frees it, each one walks all of it,
    # and the host-bound loops below would pay for that
    n_before, t0 = len(gc.get_objects()), time.perf_counter()
    gc.collect()
    log(f"7. before phase 7: {n_before:,} objects tracked by the collector, "
        f"{len(gc.get_objects()):,} after a full collection ({time.perf_counter() - t0:.2f} s)")
    os.chdir(tempfile.mkdtemp(prefix="chip_smoke_resume_"))   # a logs/ root of its own
    horizon, mini_epochs = 24, 20

    # -- 7a. train 2 iterations, then resume twice from the first checkpoint
    def cfg(checkpoint=None):
        c = main_path_cfg(urdf)
        c["basic"].update(max_iterations=2, checkpoint=checkpoint)
        c["runner"]["save_interval"] = 1
        return c

    runner = Runner(cfg(), device="cuda")
    records = runner.train()
    (ckpt1,) = glob.glob(os.path.join("logs", "*", "nn", "model_1.pt"))
    (ckpt2,) = glob.glob(os.path.join("logs", "*", "nn", "model_2.pt"))
    saved1 = load_checkpoint(ckpt1)
    sd2 = load_checkpoint(ckpt2)["params"]
    straight = torch.cat([sd2[k].reshape(-1) for k, _ in runner.ppo.network.named_parameters()])
    log(f"7a. trained 2 iterations at 4096 envs [{card}]: iter "
        f"{[round(r['iter_ms'], 2) for r in records]} ms; checkpoints {ckpt1}, {ckpt2}")
    resumed = []
    for i in range(2):
        r = Runner(cfg(ckpt1), device="cuda")
        _, ts = r._init_state()
        check_restored(f"resume {i + 1} from {ckpt1}", r, ts, saved1)
        zero_counts(r)
        recs = r.train()
        torch.cuda.synchronize()
        fused = r.ppo.fused
        got = {"K1": r.env.substep.launches, "K2": fused.gae_launches,
               "K3": fused.grads_stats_launches, "K4": fused.opt_stage_launches}
        want = {"K1": horizon, "K2": mini_epochs, "K3": mini_epochs, "K4": mini_epochs}
        rec = recs[-1] if recs else {}
        log(f"  resume {i + 1} [{card}]: {len(recs)} iteration, numbered "
            f"{r.train_state.iteration}; iter {rec.get('iter_ms', float('nan')):.2f} ms (rollout "
            f"{rec.get('rollout_ms', float('nan')):.2f}, update "
            f"{rec.get('update_ms', float('nan')):.2f}); launches {got} (expected {want})")
        require(len(recs) == 1 and r.train_state.iteration == 2, "the resumed iteration")
        require(got == want and [int(rec[k]) for k in (
            "substep_kernel_launches", "gae_launches", "grads_stats_launches",
            "opt_stage_launches")] == list(want.values()), "the resumed iteration's launches")
        require(all(np.isfinite(v) for v in rec.values()), "non-finite metrics after resume")
        resumed.append((flat_params(r.ppo.network), r.train_state.opt.m.clone(),
                        r.train_state.opt.v.clone(), rec))
        del r
    (p0, m0, v0, r0), (p1, m1, v1, r1) = resumed
    diff = lambda a, b: float((a.float().cpu() - b.float().cpu()).abs().max())
    timing = ("rollout_ms", "update_ms", "iter_ms", "env_steps_per_sec")
    metrics_same = all(r0[k] == r1[k] for k in r0 if k not in timing)
    log(f"  two resumes [{card}]: params max |diff| {diff(p0, p1):.3e}, m {diff(m0, m1):.3e}, "
        f"v {diff(v0, v1):.3e}, metrics equal {metrics_same}; resume against the "
        f"uninterrupted run's model_2.pt: params max |diff| {diff(p0, straight):.3e} (a resume "
        f"starts from a fresh reset, so equality is not expected)")

    # -- 7b. the JAX package's checkpoint, played at 4096 envs ---------------
    saved = load_checkpoint(JAX_CKPT)
    loaded = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "optax", "flax"))
    log(f"7b. {JAX_CKPT}: iteration {int(saved['iteration'])}, lr {float(saved['lr']):.6g}; "
        f"jax/optax/flax modules loaded: {loaded}")
    require(not loaded, "loading the JAX checkpoint imported JAX")
    for label, cfg_fn in (("plane", main_path_cfg), ("trimesh", rough_path_cfg)):
        pcfg = cfg_fn(urdf)
        pcfg["basic"]["checkpoint"] = JAX_CKPT
        pr = Runner(pcfg, device="cuda")
        zero_counts(pr)
        timer = _Timer(pr.device)
        traj = pr.play(num_steps=500, timer=timer)
        ms = timer.ms("steps", "end")
        sub, sampler = pr.env.substep, pr.env.terrain_sampler
        got = {"control step": sub.launches, "fused sampler": sub.fused_sampler_launches,
               "standalone sampler": 0 if sampler is None else sampler.launches}
        want = {"control step": 500, "fused sampler": 0 if sub.plane else 500,
                "standalone sampler": 0}
        rew = np.stack([t["rew"] for t in traj])
        done = np.stack([t["done"] for t in traj])
        finite = all(np.isfinite(v).all() for t in traj for v in t.values())
        kernel = "K1" if sub.plane else "K5"
        log(f"  play on {label} ({kernel}), 500 steps at 4096 envs [{card}]: "
            f"{500 / (ms / 1e3):,.1f} steps/s ({500 * 4096 / (ms / 1e3):,.0f} env-steps/s, "
            f"{ms:.1f} ms by CUDA events); mean reward/step {rew.mean():.4f}; envs done at least "
            f"once {done.any(axis=0).mean():.4f}, done per step {done.mean():.5f}; launches {got} "
            f"(expected {want}); finite {finite}")
        require(got == want and sub.plane == (label == "plane"), f"play's launches on {label}")
        require(finite and rew.shape == (500, 4096), f"play's trajectory on {label}")
        del pr, traj

    # -- 7c. TorchScript export of both checkpoints, on the card --------------
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(4096, 47, generator=gen, device="cuda")
    for i, src in enumerate((JAX_CKPT, ckpt1)):
        out = port_export.export(src, output=os.path.abspath(f"policy_{i}.pt"))
        module = torch.jit.load(out, map_location="cuda")
        seq = port_export.actor_sequential(
            port_export.actor_params(load_checkpoint(src))).to("cuda")
        with torch.no_grad():
            a, b = module(x), seq(x)
        same = torch.equal(a, b)
        log(f"7c. export of {src} -> {out}: TorchScript on the card against the f32 Sequential "
            f"at 4096 observations: bitwise {same}, max |a| {float(a.abs().max()):.4f}")
        require(same and a.shape == (4096, 12) and bool(torch.isfinite(a).all()),
                f"the export of {src}")
    os.chdir(ROOT)


# ---------------------------------------------------------------------------
# Phase 8: the serial robot and the standup task
PHASE8_TASKS = ("T1Standup", "T1Serial")


def phase8_setup(workdir):
    """The serial stand-in's URDF and MJCF in `workdir`, and on the card,
    nothing built yet: each new path's env (T1Standup on the MJCF contact
    points, T1Serial on the URDF's), whose control-step kernels phase 2
    builds, and each path's FusedUpdate geometry (its sizes)."""
    from booster_gym_torch.algo.networks import ActorCritic
    from booster_gym_torch.algo.update_kernel import FusedUpdate
    from booster_gym_torch.envs import make_task
    from booster_gym_torch.testing import (
        serial_path_cfg,
        standup_path_cfg,
        task_dims,
        write_t1_serial_mjcf,
        write_t1_serial_urdf,
    )

    urdf, mjcf = write_t1_serial_urdf(workdir), write_t1_serial_mjcf(workdir)
    cfgs = {"T1Standup": standup_path_cfg(urdf, mjcf), "T1Serial": serial_path_cfg(urdf)}
    envs = {task: make_task(cfg, "cuda") for task, cfg in cfgs.items()}
    fused = {task: FusedUpdate(ActorCritic(*task_dims(task)), 0.2, 10.0)
             for task in PHASE8_TASKS}
    return {"urdf": urdf, "mjcf": mjcf, "cfgs": cfgs, "envs": envs, "fused": fused}


def phase8_builds(ctx):
    """The nvcc runs phase 8 needs, to start with phase 2's: each path's
    control-step kernel and update library."""
    from booster_gym_torch import kernel_build
    from booster_gym_torch.algo import update_kernel
    from booster_gym_torch.physics import substep_kernel as sk

    builds = {}
    for task, env in ctx["envs"].items():
        builds[f"K1 for {task} ({env.model.num_points} points)"] = kernel_build.start_build(
            sk.SOURCE, env.substep.sizes)
        builds[f"K2-K4, K8-K10 for {task}"] = kernel_build.start_build(
            update_kernel.SOURCE, ctx["fused"][task].sizes)
    return builds


def phase8_info(card, ctx):
    """Each new build's launch shape: K1's envs per block, shared memory
    per block and the resident blocks per SM that csrc/substep.cu picked
    (MINB, asked of ptxas) against the card's occupancy; K3's tile and
    K2's cluster and tile at the new widths."""
    import torch

    for task, env in ctx["envs"].items():
        m, k = env.model, env.substep
        info = k.info()
        log(f"K1 for {task} [{card}]: nb {m.num_bodies}, nd {m.num_dofs}, {m.num_points} contact "
            f"points ({len(m.shape_body)} shapes); sizes {k.sizes}; {info['envs_per_block']} envs "
            f"per block, {info['smem_bytes']} bytes of shared memory per block, "
            f"{info['min_blocks_per_sm']} resident blocks per SM asked of ptxas; the card's "
            f"{info['blocks_per_sm_substep']} (substep) / {info['blocks_per_sm_control']} "
            f"(control step)")
        require(1 <= info["envs_per_block"] <= 8
                and info["blocks_per_sm_control"] >= info["min_blocks_per_sm"] >= 1,
                f"K1's launch shape for {task}: the card holds fewer blocks than the source asked")
    from booster_gym_torch.algo.networks import ActorCritic
    from booster_gym_torch.algo.update_kernel import FusedUpdate
    from booster_gym_torch.testing import task_dims

    for task in PHASE8_TASKS:
        for dtype in ("bf16", "f32"):
            fused = FusedUpdate(ActorCritic(*task_dims(task), compute_dtype=dtype), 0.2, 10.0)
            info = fused.info(torch.device("cuda"))
            ci = {n: fused.critic_info(torch.device("cuda"), n) for n in (25, 0)}
            log(f"update for {task} {dtype} (inputs {fused.num_obs} + "
                f"{fused.num_crit - fused.num_obs}, {fused.num_act} actions, {fused.n_params} "
                f"parameters) [{card}]: K3 {info['tile']} rows a tile, {info['smem_pass1']} bytes "
                f"per block, resident blocks per SM {info['blocks_per_sm_pass1']}; last-layer dz "
                f"{info['dz3w']} wide, {info['nstat']} stat slots; K2/K8 clusters of "
                f"{info['k2_cluster']} blocks, {info['k2_tile']} rows a tile, {ci[25]['smem']} "
                f"bytes per block at 25 planes (at most {info['k2_max_planes']}), resident "
                f"clusters {ci[25]['clusters']} (K2) / {ci[0]['clusters']} (K8)")


def phase8_kernels(card, ctx):
    """8a: K1 on each new robot against its plain version (per substep, and
    per control step with the env's gains; at 4096 and 1000 envs), and K2-K4 and K8-K10 at the new
    widths in bf16 and f32.  Returns {(kernel, task): max abs error}."""
    import torch

    from booster_gym_torch.physics.engine import make_substep
    from booster_gym_torch.testing import task_dims

    err = {}
    for task, env in ctx["envs"].items():
        plain = make_substep(env.model, env.sim_cfg, env.feet_indices, "cuda")
        for B in (4096, 1000):   # the paths' batch, and a ragged one
            e1 = compare_kernel(task, env.substep, plain, env.model, B, task="T1Serial")
            e2, share = compare_control(task, env.substep, env.model, B, task="T1Serial")
            err[("K1", task)] = max(err.get(("K1", task), 0.0), e1, e2)
            log(f"8a. K1 for {task} at B={B} matches its plain version: per substep max abs err "
                f"{e1:.3e}, per control step {e2:.3e} ({share:.2%} of the envs left out as "
                "chaotic)")
    for task, Bs, anchor_dtypes in (("T1Standup", (4096, 1000), ("bf16", "f32")),
                                    ("T1Serial", (4096,), ("bf16",))):
        dims = task_dims(task)
        for dtype in ("bf16", "f32"):
            for B in Bs:
                for k, e in compare_update_kernels(dtype, B, dims=dims).items():
                    err[(k, task)] = max(err.get((k, task), 0.0), e)
                if dtype in anchor_dtypes:
                    for k, e in compare_anchor_kernels(dtype, B, dims=dims).items():
                        err[(k, task)] = max(err.get((k, task), 0.0), e)
        log(f"8a. K2-K4 and K8-K10 for {task} (dims {dims}) match their plain versions: max abs "
            "err " + ", ".join(f"{k} {e:.3e}" for (k, t), e in err.items() if t == task))
    torch.cuda.synchronize()
    return err


def compare_settle(card, ctx, every=5, samples=32):
    """K1 over T1Standup's bank settle at the path's 4096 envs, against the
    plain loop from the same drops (the env's draws from one seed), the
    standup path's regime: bodies falling onto the ground and coming to
    rest on dozens of contact points.  Every control step of the settle
    runs both from the plain loop's state, and the kernel's state must be
    finite exactly where the plain loop's is.  Every `every`-th round each
    of its substeps runs both from the plain substep's state, so that the
    comparison measures one substep's error, not divergence: each env is
    held to the env step's tolerance, but for a few (at most 1% a substep)
    where a contact decision (activation at zero margin, the bounce gate,
    the friction cone) falls the other way.  Those are held to a stricter
    rule: the plain substep reaches the kernel's outcome within the
    tolerance from one of `samples` copies of its input state perturbed by
    rounding (each component times 1 + eps N(0, 1), eps 1e-7 and 1e-6).
    Also reported: each held round's envs off the tolerance after the
    whole control step, and the non-finite entries of a settle by the
    kernel alone and by the plain loop alone.  Returns the max abs error of
    a substep over the held envs."""
    import copy

    import torch

    from booster_gym_torch.envs import make_task
    from booster_gym_torch.envs.t1 import T1
    from booster_gym_torch.physics.engine import make_substep

    env = make_task(copy.deepcopy(ctx["cfgs"]["T1Standup"]), "cuda")
    B, k, nd = env.num_envs, env.substep, env.model.num_dofs
    plain = make_substep(env.model, env.sim_cfg, env.feet_indices, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = T1.init_params(env, gen)   # the base env's: no bank
    drops = env._fallen_seed_states(env._draw_fallen(gen))
    targets = env.default_dof_pos.expand(B, nd).contiguous()
    pdyn = k.pack_dyn(params.dyn)
    gains = [x.contiguous() for x in (params.dof_stiffness, params.dof_damping,
                                      params.dof_friction)]
    held = (pdyn, targets, targets, torch.zeros(B, dtype=torch.int64, device="cuda"), *gains,
            env.torque_limits, torch.zeros(B, 6, device="cuda"))
    control = lambda ps: k.control_step(ps, *held, decimation=env.decimation).state
    kp, kd, fric = (x.T for x in gains)
    lim = env.torque_limits[:, None]

    def torques(ps):   # the settle's PD, its targets latched from substep 0
        pd = kp * (targets.T - ps[13:13 + nd]) - kd * ps[13 + nd:]
        f = torch.minimum(torch.abs(pd), fric) * torch.sign(pd)
        return torch.minimum(torch.maximum(pd - f, -lim), lim).contiguous()

    def plain_substep(ps, dyn, tau):
        z = torch.zeros(ps.shape[1], 3, device="cuda")
        return k.pack_sim(plain(k.unpack_sim(ps), k.unpack_dyn(dyn), tau.T, z, z)[0])

    off_tol = lambda a, b: ((a - b).abs() / (TOL_ENV + TOL_ENV * b.abs())).amax(0)
    noise = torch.Generator(device="cuda").manual_seed(7)

    def nearest(ps, tau, out, idx):
        """Per env of idx: the nearest plain outcome to the kernel's (max
        error over the tolerance) from `samples` perturbed copies of its
        input state at each eps."""
        rep = lambda t: t[:, idx].repeat_interleave(samples, 1)
        x, d, t, o = rep(ps), rep(pdyn), rep(tau), rep(out)
        best = None
        for eps in (1e-7, 1e-6):
            y = plain_substep(x * (1 + eps * torch.randn(x.shape, generator=noise, device="cuda")),
                              d, t)
            r = off_tol(y, o).view(len(idx), samples).amin(1)
            best = r if best is None else torch.minimum(best, r)
        return best

    ps = pk = k.pack_sim(drops)
    worst, flips, most, off_control = 0.0, 0, 0, []
    for r in range(env.settle_rounds):
        out = control(ps)
        pk = control(pk)
        hold = r % every == every - 1
        x = ps
        for i in range(env.decimation):
            tau = torques(x)
            nxt = plain_substep(x, pdyn, tau)
            if hold:
                sk = k.packed_call(x, pdyn, tau, torch.zeros(6, B, device="cuda"))[0]
                finite = torch.isfinite(nxt).all(0)
                require(torch.equal(torch.isfinite(sk).all(0), finite),
                        f"K1 on T1Standup's settle, round {r} substep {i}: the kernel's state is "
                        "non-finite where the plain substep's is finite, or the other way")
                ratio = off_tol(sk, nxt)
                off = (ratio > 1) & finite
                idx = off.nonzero()[:, 0]
                require(len(idx) <= B // 100, f"K1 on T1Standup's settle, round {r} substep {i}: "
                        f"{len(idx)} of {B} envs past the tolerance")
                if len(idx):
                    best = nearest(x, tau, sk, idx)
                    require(bool((best <= 1).all()),
                            f"K1 on T1Standup's settle, round {r} substep {i}: envs "
                            f"{idx[best > 1].tolist()} past the tolerance, and no perturbed plain "
                            f"substep reaches the kernel's outcome (nearest {float(best.max()):.2f})")
                keep = finite & ~off
                worst = max(worst, float((sk - nxt).abs()[:, keep].max()))
                flips, most = flips + len(idx), max(most, len(idx))
            x = nxt
        finite = torch.isfinite(x).all(0)
        require(torch.equal(torch.isfinite(out).all(0), finite),
                f"K1 on T1Standup's settle, round {r}: the kernel's control step is non-finite "
                "where the plain loop's is finite, or the other way")
        if hold:
            off_control.append(int(((off_tol(out, x) > 1) & finite).sum()))
        ps = x
    torch.cuda.synchronize()
    nonfinite = lambda p: int((~torch.isfinite(p).all(0)).sum())
    log(f"8a. T1Standup's bank settle at B={B} [{card}], {env.settle_rounds} rounds, each from the "
        f"plain loop's state: the kernel's control step finite exactly where the plain loop's is "
        f"in every round; every substep of {len(off_control)} rounds from the plain substep's "
        f"state: max abs err {worst:.3e} over the envs within {TOL_ENV}, {flips} (env, substep) "
        f"past it (at most {most} in a substep), each reached by the plain substep from a "
        f"rounding-perturbed state; envs off the tolerance after those rounds' whole control "
        f"steps {off_control}; non-finite entries after the settle: {nonfinite(pk)} by the kernel "
        f"alone, {nonfinite(ps)} by the plain loop alone")
    return worst


def phase8_train(card, ctx, workdir):
    """8b: T1Standup at 4096 envs: the bank's settle timed on its own (60
    control-step launches), then 2 training iterations (24 control steps
    and 20 each of K2-K4 per iteration, after the bank's 60); 8d: the
    exported standup policy against the f32 actor on the card, bitwise;
    8b': T1StandupFT resumes the checkpoint for one iteration; 8c:
    T1Serial, 1 iteration.  Returns {task: (runner, records)}."""
    import glob

    import numpy as np
    import torch

    from booster_gym_torch import export as port_export
    from booster_gym_torch.runner import Runner
    from booster_gym_torch.testing import standup_path_cfg
    from booster_gym_torch.utils.recorder import load_checkpoint

    os.chdir(tempfile.mkdtemp(prefix="chip_smoke_serial_", dir=workdir))   # logs/ of its own
    out = {}
    for task in PHASE8_TASKS:
        runner = Runner(ctx["cfgs"][task], device="cuda")
        env, fused = runner.env, runner.ppo.fused
        horizon = ctx["cfgs"][task]["runner"]["horizon_length"]
        epochs = ctx["cfgs"][task]["runner"]["mini_epochs"]
        iters = ctx["cfgs"][task]["basic"]["max_iterations"]
        settle = 0
        if task == "T1Standup":
            settle = env.settle_rounds
            gen = torch.Generator(device="cuda").manual_seed(1)
            env.init_params(gen)   # the kernel builds at its first launch
            n0 = env.substep.launches
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            params = env.init_params(gen)
            t1.record()
            t1.synchronize()
            bank = params.init_bank
            fields = [getattr(bank, f) for f in ("root_pos", "root_quat", "root_lin_vel",
                                                 "root_ang_vel", "q", "qd")]
            finite = torch.stack([torch.isfinite(x).all(1) for x in fields]).all(0)
            z = bank.root_pos[finite, 2]
            # a drop can blow the contact solve up, in the plain loop as in the
            # kernel (the JAX package banks such states too; a reset that
            # draws one is reset again by the termination's fault check)
            log(f"8b. T1Standup's bank at {env.num_envs} envs [{card}]: init_params with the "
                f"settle {t0.elapsed_time(t1):.2f} ms by CUDA events, "
                f"{env.substep.launches - n0} control-step launches; settled trunk heights "
                f"{float(z.min()):.3f}-{float(z.max()):.3f} m; {int((~finite).sum())} of "
                f"{env.num_envs} entries non-finite")
            require(env.substep.launches - n0 == settle
                    and int((~finite).sum()) <= env.num_envs // 100, "the bank's settle")
        zero_counts(runner)
        records = runner.train()
        torch.cuda.synchronize()
        per_iter = [[int(r[k]) for k in ("substep_kernel_launches", "gae_launches",
                                          "grads_stats_launches", "opt_stage_launches")]
                    for r in records]
        got = [env.substep.launches, fused.gae_launches, fused.grads_stats_launches,
               fused.opt_stage_launches]
        for r in records:
            log(f"8{'b' if task == 'T1Standup' else 'c'}. {task} iteration at {env.num_envs} envs "
                f"[{card}]: {r['iter_ms']:.2f} ms (rollout {r['rollout_ms']:.2f} ms, update "
                f"{r['update_ms']:.2f} ms), {r['env_steps_per_sec']:,.0f} env-steps/s, reward "
                f"{r['reward']:.4f}, value_loss {r['value_loss']:.4f}, kl {r['kl_mean']:.5f}")
        log(f"  {task} launches: K1/K2/K3/K4 per iteration {per_iter}, in all {got} (the bank's "
            f"{settle} control steps included)")
        require(len(records) == iters and per_iter == [[horizon, epochs, epochs, epochs]] * iters
                and got == [settle + iters * horizon] + [iters * epochs] * 3,
                f"{task}'s kernel launches")
        ts = runner.train_state
        require(ts.obs.shape == (env.num_envs, env.num_obs)
                and ts.privileged_obs.shape == (env.num_envs, 14)
                and bool(torch.isfinite(ts.obs).all())
                and all(np.isfinite(v) for r in records for v in r.values()),
                f"{task}'s observations and metrics after training")
        out[task] = (runner, records)
        if task == "T1Standup":
            # 8d. the exported standup policy, bitwise against the f32 actor
            (ckpt,) = glob.glob(os.path.join("logs", "*", "nn", f"model_{iters}.pt"))
            path = port_export.export(ckpt, output=os.path.abspath("standup_policy.pt"),
                                      task="T1Standup")
            module = torch.jit.load(path, map_location="cuda")
            seq = port_export.actor_sequential(
                port_export.actor_params(load_checkpoint(ckpt))).to("cuda")
            gen = torch.Generator(device="cuda").manual_seed(8)
            obs = torch.randn(4096, env.frame_obs, generator=gen, device="cuda")
            stack = torch.randn(4096, env.deploy_stack, env.frame_obs, generator=gen,
                                device="cuda")
            with torch.no_grad():
                a = module(obs, stack)
                b = seq(stack[:, :env.train_stack].reshape(4096, -1))
            same = torch.equal(a, b)
            log(f"8d. export of {ckpt} with the standup wrapper -> {path}: TorchScript on the "
                f"card (obs [4096, {env.frame_obs}], a {env.deploy_stack}-frame stack) against "
                f"the f32 Sequential on the newest {env.train_stack} frames: bitwise {same}, "
                f"max |a| {float(a.abs().max()):.4f}")
            require(same and a.shape == (4096, env.num_actions) and bool(torch.isfinite(a).all()),
                    "the standup export")
            # 8b'. the fine-tune stage (T1StandupFT.yaml, the standup class)
            # resumes that checkpoint for one iteration
            fcfg = standup_path_cfg(ctx["urdf"], ctx["mjcf"], task="T1StandupFT")
            fcfg["basic"].update(checkpoint=ckpt, max_iterations=iters + 1)
            ft = Runner(fcfg, device="cuda")
            zero_counts(ft)
            frecs = ft.train()
            torch.cuda.synchronize()
            fper = [[int(r[k]) for k in ("substep_kernel_launches", "gae_launches",
                                          "grads_stats_launches", "opt_stage_launches")]
                    for r in frecs]
            log(f"8b'. T1StandupFT from {ckpt} [{card}]: {len(frecs)} iteration, numbered "
                f"{ft.train_state.iteration}, {frecs[-1]['iter_ms']:.2f} ms (rollout "
                f"{frecs[-1]['rollout_ms']:.2f}, update {frecs[-1]['update_ms']:.2f}); launches "
                f"K1/K2/K3/K4 {fper}, in all {ft.env.substep.launches} control steps (the bank's "
                f"{settle} included)")
            require(type(ft.env).__name__ == "T1Standup" and ft.train_state.iteration == iters + 1
                    and fper == [[horizon, epochs, epochs, epochs]]
                    and ft.env.substep.launches == settle + horizon,
                    "the fine-tune stage's resumed iteration")
            del ft
    os.chdir(ROOT)
    return out


def phase8_timing(card, ctx, trained, err):
    """The `kernels` entries of phase 8: K1's control step on each new
    robot at 4096 envs (launches: its path's run, the bank's settle
    included on T1Standup), and K2-K4 and K8-K10 at each new path's widths
    from prof_update (bf16, T = 24, B = 4096; launches: K2-K4 the path's
    run, K8-K10 prof_update's), beside each plain version's time."""
    import torch

    from booster_gym_torch import prof_update
    from booster_gym_torch.testing import bound, control_inputs, task_dims, time_cuda

    entries = []
    for task, (runner, _) in trained.items():
        env = ctx["envs"][task]
        k, model, B = env.substep, env.model, 4096
        cargs = control_inputs(k, model, B, "cuda", seed=5, task="T1Serial")
        ms, _ = time_cuda(lambda: k.control_step(*cargs), 25)
        plain_ms, _ = time_cuda(lambda: k.control_step_plain(*cargs), 3, warmup=1)
        nbytes = control_bytes(k) * B
        nops = 10 * substep_op_count(model, env.sim_cfg) * B + epilogue_op_count(k) * B
        bound_ms, bound_by = bound(nbytes, nops)
        launches = runner.env.substep.launches
        epb = k.info()["envs_per_block"]
        log(f"8. K1 for {task} ({model.num_points} points, {epb} envs per block) one "
            f"control step at {B} envs [{card}]: {ms * 1e3:.2f} us per launch; plain loop "
            f"{plain_ms:.2f} ms; bound {bound_ms * 1e3:.2f} us by {bound_by} ({nbytes / 1e6:.2f} "
            f"MB, {nops / 1e6:.1f} Mop at 67 TFLOP/s f32); launches on the path {launches}")
        entries.append({
            "name": f"K1 substep (plane), {task}'s serial robot ({model.num_points} points), "
                    "one control step per launch",
            "route": "cuda", "source": "booster_gym_torch/csrc/substep.cu",
            "replaces": "booster_gym_tpu/physics/pallas_engine.py:267", "launches": launches,
            "max_abs_err": err[("K1", task)], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "envs_per_block": epb})
    for task, (runner, _) in trained.items():
        records = prof_update.main(["--task", task, "--iters", "20"])
        by_kernel = {r["kernel"]: r for r in records}
        plains = update_plains(24, 4096, task_dims(task))[3]
        path = runner.ppo.fused
        path_launches = {"K2": path.gae_launches, "K3": path.grads_stats_launches,
                         "K4": path.opt_stage_launches}
        for kname, plain in plains.items():
            rec = by_kernel[kname]
            plain_ms, _ = time_cuda(plain, 5)
            launches = path_launches.get(kname, rec["launches"])
            log(f"8. {kname} for {task} at N=98304 bf16 ({rec['n_params']} parameters) [{card}]: "
                f"{rec['ms']:.4f} ms/call (prof_update); plain version {plain_ms:.3f} ms; bound "
                f"{rec['bound_ms'] * 1e3:.2f} us by {rec['bound_by']} ({rec['bytes'] / 1e6:.2f} MB, "
                f"{rec['operations'] / 1e9:.3f} Gop); launches {launches} "
                f"({'the path' if kname in path_launches else 'prof_update'}); library: none")
            name, replaces = UPDATE_META[kname]
            entries.append({
                "name": f"{name}, {task}'s widths", "route": "cuda",
                "source": "booster_gym_torch/csrc/update.cu", "replaces": replaces,
                "launches": launches, "max_abs_err": err[(kname, task)], "ms": rec["ms"],
                "plain_ms": plain_ms, "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": None, "n_params": rec["n_params"]})
            if kname == "K3" and task == "T1Standup":
                entries[-1]["passes"] = {"cells": cells_k3_passes(card, task_dims(task))}
    return entries


def serial_and_standup(card, ctx, workdir):
    """Phase 8 after its builds: 8a, 8b-8d, then the timing; returns its
    `kernels` entries."""
    t0 = time.perf_counter()
    phase8_info(card, ctx)
    err = phase8_kernels(card, ctx)
    err[("K1", "T1Standup")] = max(err[("K1", "T1Standup")], compare_settle(card, ctx))
    trained = phase8_train(card, ctx, workdir)
    entries = phase8_timing(card, ctx, trained, err)
    log(f"8. phase 8 took {time.perf_counter() - t0:.1f} s")
    return entries


# ---------------------------------------------------------------------------
# Phase 9: the sampling MPC
MPC_PLANS = 25          # closed-loop plans: 0.5 s of control at 50 Hz
MPC_MIN_HEIGHT = 0.55   # the root height tests/test_torch_mpc.py holds the stand-in above


def mpc_phase(card, urdf):
    """Phase 9: booster_gym_torch.mpc's SamplingMPC at its defaults on the
    T1-shaped stand-in on the plane, its rollout through K1 (one launch per
    control step at K = 256).  9a holds each control step of one plan's
    rollout to control_step_plain from the kernel's own state, state and
    cost (testing.hold_mpc_rollout: chaotic and flipped samples left out,
    the shares printed), and the plan's weighting, new mean and info to
    torch's recomputation from the kernel's costs, exactly; 9b runs the
    closed loop (counts zeroed before it), ms per plan by CUDA events; 9c
    times K1 at the MPC's batch beside the main path's 4096 envs.  Returns
    K1's `kernels` entry on the MPC's path."""
    import math

    import torch

    from booster_gym_torch.mpc import SamplingMPC, standup_cost, tile
    from booster_gym_torch.testing import bound, hold_mpc_rollout, mpc_start, time_cuda

    t0 = time.perf_counter()
    log("9. no MuJoCo phase: the card's machine has no mujoco package; the MuJoCo evaluation, "
        "renderer and play_mujoco run on the CPU (tests/test_torch_eval.py)")
    env, sim, dyn1 = mpc_start(urdf, "cuda")
    mpc = SamplingMPC(env)
    sub, model = env.substep, env.model
    K, H = mpc.num_samples, mpc.horizon
    require((K, H, mpc.decimation) == (256, 16, 10) and sub.plane,
            "the MPC's defaults: K = 256, H = 16, decimation 10, on the plane kernel")
    epb = sub.info()["envs_per_block"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = math.ceil(K / epb)
    log(f"9. SamplingMPC: K={K} samples, H={H} control steps of {mpc.decimation} substeps; K1's "
        f"launch: {blocks} blocks of {epb} envs on the card's {sms} SMs")

    # -- 9a. one plan's rollout held step by step ----------------------------
    noise = mpc.draw(torch.Generator("cuda").manual_seed(0))
    held = hold_mpc_rollout(mpc, sim, dyn1, noise, tol=TOL_STATE)
    torch.cuda.synchronize()
    chaotic = held["chaotic"].sum(1).tolist()
    flipped = held["flipped"].sum(1).tolist()
    cost_err = torch.where(held["chaotic"] | held["flipped"], 0.0,
                           (held["costs"] - held["plain_costs"]).abs()).amax(1).tolist()
    for h in range(H):
        log(f"  9a. control step {h}: state max abs {held['state_err'][h]:.3e}, cost max abs "
            f"{cost_err[h]:.3e} over the samples held; {chaotic[h]} of {K} samples "
            f"({chaotic[h] / K:.2%}) chaotic and {flipped[h]} ({flipped[h] / K:.2%}) flipped "
            f"(past the tolerance, reached by the plain step from a rounding-perturbed state), "
            f"left out; tol {TOL_STATE} {'FAIL' if held['over'][h] else 'ok'}")
    require(held["finite_same"], "K1's MPC rollout is not finite where the plain one is")
    require(not any(held["over"]), "K1's MPC rollout disagrees with control_step_plain, and no "
            "perturbed plain step reaches its outcome")
    require(max(chaotic) <= K // 100, f"more than 1% of the MPC's samples chaotic: {chaotic}")
    max_err = max(max(held["state_err"]), max(cost_err))
    # the plan from the same mean and noise, against torch's recomputation
    # from the kernel's costs (the kernel repeats bitwise, so its costs are
    # the same)
    mean0 = mpc._mean.clone()
    targets, info = mpc.plan(sim, dyn1, noise=noise)
    k1_plan = (targets, mpc._mean.clone(), info)
    costs, deltas = held["costs"], held["deltas"]
    total = costs.sum(0)
    w = torch.softmax(-(total - total.min()) / mpc.temperature, dim=0)
    new_mean = torch.einsum("k,hkj->hj", w, deltas)
    ref = {"targets": (targets, env.default_dof_pos + new_mean[0]),
           "mean": (mpc._mean, torch.cat([new_mean[1:], new_mean[-1:]])),
           "best_cost": (info["best_cost"], total.min()),
           "mean_cost": (info["mean_cost"], total.mean()),
           "ess": (info["ess"], 1.0 / (w * w).sum())}
    same = {k: torch.equal(a, b) for k, (a, b) in ref.items()}
    log(f"9a. plan from mean {float(mean0.abs().max()):g} and the same noise: the weighting "
        f"recomputed by torch from the kernel's costs, equal exactly {same}; best cost "
        f"{float(info['best_cost']):.5f}, mean cost {float(info['mean_cost']):.4f}, ess "
        f"{float(info['ess']):.3f}; max abs err of the rollout {max_err:.3e}")
    require(all(same.values()), f"the plan's weighting from the kernel's costs: {same}")

    # -- 9b. the closed loop -------------------------------------------------
    sim0 = sim
    mpc.reset()
    gen = torch.Generator("cuda").manual_seed(42)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    plan_ms, host_ms, per_plan, loop_targets = [], [], [], []
    torch.cuda.synchronize()
    sub.launches = 0
    for _ in range(MPC_PLANS):
        n0 = sub.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        targets, info = mpc.plan(sim, dyn1, gen=gen)
        end.record()
        end.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t))
        plan_ms.append(start.elapsed_time(end))
        per_plan.append(sub.launches - n0)
        loop_targets.append(targets)
        sim = mpc._rollout(dyn1, sim, targets[None, None])[0]
    launches = sub.launches
    height = float(sim.root_pos[0, 2])
    cost = float(standup_cost(sim, env.default_dof_pos)[0])
    steady = sorted(plan_ms[1:])
    log(f"9b. closed loop, {MPC_PLANS} plans [{card}]: {steady[len(steady) // 2]:.3f} ms per "
        f"plan by CUDA events (median of plans 2-{MPC_PLANS}; first {plan_ms[0]:.3f}, mean "
        f"{sum(steady) / len(steady):.3f}), host {sorted(host_ms[1:])[len(steady) // 2]:.3f} ms; "
        f"K1 launches per plan {per_plan[0]} (all {sorted(set(per_plan))}), {launches} in the "
        f"run ({MPC_PLANS} plans and {MPC_PLANS} closed-loop steps); root height {height:.4f} "
        f"(held above {MPC_MIN_HEIGHT}), standup cost {cost:.4f}, last best cost "
        f"{float(info['best_cost']):.4f}")
    require(per_plan == [H] * MPC_PLANS and launches == MPC_PLANS * (H + 1),
            f"K1's launches in the MPC's closed loop: {per_plan}, {launches}")
    require(height > MPC_MIN_HEIGHT and math.isfinite(cost),
            f"the MPC did not keep the stand-in up (h={height:.4f}, cost {cost})")

    # -- 9c. K1 at the MPC's batch beside the main path's --------------------
    fixed = {B: mpc.rollout_inputs(B) for B in (K, 4096)}
    args = {}
    for B in (K, 4096):
        state_b, dyn_b = tile(sim, dyn1, B)
        t_ = (env.default_dof_pos + noise[0, :1]).expand(B, -1).contiguous()
        args[B] = (sub.pack_sim(state_b), sub.pack_dyn(dyn_b), t_, t_, *fixed[B])
    runs = {K: [], 4096: []}
    for B in (K, 4096, 4096, K):
        runs[B].append(time_cuda(lambda: sub.control_step(*args[B], decimation=10), 50)[0])
    ms = sum(runs[K]) / 2
    plain_ms, _ = time_cuda(lambda: sub.control_step_plain(*args[K], decimation=10), 3, warmup=1)
    nbytes = control_bytes(sub) * K
    nops = (10 * substep_op_count(model, env.sim_cfg) + epilogue_op_count(sub)) * K
    bound_ms, bound_by = bound(nbytes, nops)
    log(f"9c. K1 one control step at the MPC's K={K} ({blocks} blocks on {sms} SMs) [{card}]: "
        f"{ms * 1e3:.2f} us per launch (runs {[round(x * 1e3, 2) for x in runs[K]]}); at 4096 "
        f"envs {sum(runs[4096]) / 2 * 1e3:.2f} us ({[round(x * 1e3, 2) for x in runs[4096]]}); "
        f"plain loop {plain_ms:.2f} ms; bound {bound_ms * 1e3:.3f} us by {bound_by} "
        f"({nbytes / 1e6:.3f} MB, {nops / 1e6:.1f} Mop at 67 TFLOP/s f32), "
        f"{ms / bound_ms:.0f}x the bound; per plan {H} launches, {H * ms:.3f} ms of K1 of the "
        f"plan's {steady[len(steady) // 2]:.3f} ms")
    k1_entry = {"name": "K1 substep (plane), the sampling MPC's rollout (K = 256 samples), one "
                        "control step per launch",
                "route": "cuda", "source": "booster_gym_torch/csrc/substep.cu",
                "replaces": "booster_gym_tpu/physics/pallas_engine.py:267", "launches": launches,
                "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None, "launches_per_plan": H,
                "plan_ms": steady[len(steady) // 2], "ms_at_4096": sum(runs[4096]) / 2,
                "blocks": blocks, "sms": sms}
    k5_entry = mpc_rough_phase(card, urdf, sim0, dyn1, noise, k1_plan, loop_targets)
    log(f"9. phase 9 took {time.perf_counter() - t0:.1f} s")
    return [k1_entry, k5_entry]


def mpc_rough_phase(card, urdf, sim, dyn1, noise, k1_plan, k1_loop):
    """Phase 9d: the MPC on the rough path's env (T1.yaml's trimesh
    terrain, one env), whose rollout is K5 on flat ground (h = 0, n = +z at
    every point, no terrain sampled: the JAX planner's semantics on its
    Pallas backend).  From phase 9's start and noise one plan must equal
    9a's K1 plan bitwise (targets, new mean, info), with 16 K5 launches and
    no fused sampling, after the rollout is held step by step to
    control_step_plain as 9a holds K1's; the closed loop of 9b from the
    same generator seed must give 9b's targets at every plan, bitwise
    (counts zeroed before it); then K5's time per launch at K = 256 beside
    4096 envs, its bound and its plain time.  Returns the `K5 (MPC)`
    kernels entry."""
    import math

    import torch

    from booster_gym_torch.envs.t1 import T1
    from booster_gym_torch.mpc import SamplingMPC, tile
    from booster_gym_torch.testing import bound, hold_mpc_rollout, mpc_path_cfg, time_cuda

    t0 = time.perf_counter()
    env = T1(mpc_path_cfg(urdf, terrain="trimesh"), "cuda")
    mpc = SamplingMPC(env)
    sub, model = env.substep, env.model
    K, H = mpc.num_samples, mpc.horizon
    require((K, H) == (256, 16) and not sub.plane and sub.sampler is not None,
            "the MPC on the rough path's env: K = 256, H = 16, on K5 built with its terrain")
    field = tuple(env.terrain.height_field.shape)

    # -- 9d. one plan from 9a's inputs ----------------------------------------
    held = hold_mpc_rollout(mpc, sim, dyn1, noise, tol=TOL_STATE)
    chaotic = held["chaotic"].sum(1).tolist()
    flipped = held["flipped"].sum(1).tolist()
    cost_err = torch.where(held["chaotic"] | held["flipped"], 0.0,
                           (held["costs"] - held["plain_costs"]).abs()).amax(1).tolist()
    max_err = max(max(held["state_err"]), max(cost_err))
    log(f"9d. the MPC on the rough path's env (field {field}), K5 on flat ground: its rollout "
        f"held step by step to control_step_plain, max abs err {max_err:.3e} (tol {TOL_STATE}); "
        f"chaotic samples per step {chaotic}, flipped {flipped}")
    require(held["finite_same"], "K5's MPC rollout is not finite where the plain one is")
    require(not any(held["over"]), "K5's MPC rollout disagrees with control_step_plain, and no "
            "perturbed plain step reaches its outcome")
    require(max(chaotic) <= K // 100, f"more than 1% of the MPC's samples chaotic: {chaotic}")
    sub.launches = sub.fused_sampler_launches = 0
    targets, info = mpc.plan(sim, dyn1, noise=noise)
    torch.cuda.synchronize()
    got = {"K5": sub.launches, "fused sampling": sub.fused_sampler_launches}
    t1, mean1, info1 = k1_plan
    same = {"targets": torch.equal(targets, t1), "mean": torch.equal(mpc._mean, mean1),
            **{k: torch.equal(v, info1[k]) for k, v in info.items()}}
    log(f"9d. one plan from 9a's start and noise [{card}]: against 9a's K1 plan, bitwise {same}; "
        f"launches {got} (expected K5 {H}, fused sampling 0); best cost "
        f"{float(info['best_cost']):.5f}")
    require(all(same.values()), f"the trimesh env's plan against the plane env's K1 plan: {same}")
    require(got == {"K5": H, "fused sampling": 0}, f"the plan's launches: {got}")

    # -- the closed loop of 9b on K5 ------------------------------------------
    mpc.reset()
    gen = torch.Generator("cuda").manual_seed(42)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    plan_ms, per_plan, loop_same = [], [], []
    torch.cuda.synchronize()
    sub.launches = sub.fused_sampler_launches = 0
    for k1_targets in k1_loop:
        n0 = sub.launches
        start.record()
        targets, info = mpc.plan(sim, dyn1, gen=gen)
        end.record()
        end.synchronize()
        plan_ms.append(start.elapsed_time(end))
        per_plan.append(sub.launches - n0)
        loop_same.append(torch.equal(targets, k1_targets))
        sim = mpc._rollout(dyn1, sim, targets[None, None])[0]
    launches, fused = sub.launches, sub.fused_sampler_launches
    steady = sorted(plan_ms[1:])
    plan_med = steady[len(steady) // 2]
    log(f"9d. closed loop, {len(k1_loop)} plans [{card}]: {plan_med:.3f} ms per plan by CUDA "
        f"events (median of plans 2-{len(k1_loop)}; first {plan_ms[0]:.3f}); K5 launches per "
        f"plan {sorted(set(per_plan))}, {launches} in the run, fused sampling {fused}; every "
        f"plan's targets bitwise 9b's K1 targets: {all(loop_same)} ({sum(loop_same)} of "
        f"{len(loop_same)}); root height {float(sim.root_pos[0, 2]):.4f}")
    require(per_plan == [H] * len(k1_loop) and launches == len(k1_loop) * (H + 1)
            and fused == 0, f"K5's launches in the MPC's closed loop: {per_plan}, {launches}, "
            f"{fused}")
    require(all(loop_same), "the closed loop on K5 left 9b's K1 targets")

    # -- K5 at the MPC's batch beside 4096 envs ---------------------------------
    args = {}
    for B in (K, 4096):
        state_b, dyn_b = tile(sim, dyn1, B)
        t_ = (env.default_dof_pos + noise[0, :1]).expand(B, -1).contiguous()
        args[B] = (sub.pack_sim(state_b), sub.pack_dyn(dyn_b), t_, t_, *mpc.rollout_inputs(B))
    runs = {K: [], 4096: []}
    n0 = sub.launches
    for B in (K, 4096, 4096, K):
        runs[B].append(time_cuda(lambda: sub.control_step(*args[B], decimation=10), 50)[0])
    ms = sum(runs[K]) / 2
    plain_ms, _ = time_cuda(lambda: sub.control_step_plain(*args[K], decimation=10), 3, warmup=1)
    nbytes = control_bytes(sub, sampled=False) * K
    nops = (10 * substep_op_count(model, env.sim_cfg, plane=False)
            + epilogue_op_count(sub, sampled=False)) * K
    bound_ms, bound_by = bound(nbytes, nops)
    blocks = math.ceil(K / sub.info()["envs_per_block"])
    log(f"9d. K5 one control step on flat ground at the MPC's K={K} ({blocks} blocks) [{card}]: "
        f"{ms * 1e3:.2f} us per launch (runs {[round(x * 1e3, 2) for x in runs[K]]}); at 4096 "
        f"envs {sum(runs[4096]) / 2 * 1e3:.2f} us ({[round(x * 1e3, 2) for x in runs[4096]]}); "
        f"plain loop {plain_ms:.2f} ms; bound {bound_ms * 1e3:.3f} us by {bound_by} "
        f"({nbytes / 1e6:.3f} MB, {nops / 1e6:.1f} Mop at 67 TFLOP/s f32), {ms / bound_ms:.0f}x "
        f"the bound; per plan {H} launches, {H * ms:.3f} ms of K5 of the plan's {plan_med:.3f} "
        f"ms; timing launches {sub.launches - n0}")
    log(f"9d. took {time.perf_counter() - t0:.1f} s")
    return {"name": "K5 (MPC) substep (general terrain) on flat ground, the sampling MPC's "
                    "rollout on a trimesh env (K = 256 samples), one control step per launch",
            "route": "cuda", "source": "booster_gym_torch/csrc/substep.cu",
            "replaces": "booster_gym_tpu/physics/pallas_engine.py:267", "launches": launches,
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "launches_per_plan": H,
            "plan_ms": plan_med, "ms_at_4096": sum(runs[4096]) / 2, "blocks": blocks}


# ---------------------------------------------------------------------------
# Phase 10: data parallelism, two ranks sharing the one card
DP_RANK_TIMEOUT_S = 600     # a launch whose ranks have not all exited by then fails
TOL_REWARD_RTOL, TOL_REWARD_ATOL, TOL_VALUE_LOSS_RTOL = 1e-3, 1e-5, 5e-2   # the CPU test's


def dp_ranks(spec, out_dir, world=2):
    """The ranks' results of testing.dp_train launched as `world` ranks by
    booster_gym_torch.parallel.launch (the launcher of python -m
    booster_gym_torch.train): each rank a process with torchrun's
    environment; on one card the ranks share it over gloo.  A rank that
    fails or outlives DP_RANK_TIMEOUT_S makes launch raise."""
    import torch

    from booster_gym_torch.parallel import launch
    from booster_gym_torch.testing import dp_train

    os.makedirs(out_dir, exist_ok=True)
    launch(dp_train, world, (spec, out_dir), timeout_s=DP_RANK_TIMEOUT_S)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def dp_launches(rec):
    return {"K1/K5": int(rec["substep_kernel_launches"]),
            "K6+K7 fused": int(rec["fused_sampler_launches"]), "K2": int(rec["gae_launches"]),
            "K3": int(rec["grads_stats_launches"]), "K4": int(rec["opt_stage_launches"])}


def data_parallel_phase(card, urdf):
    """Phase 10: env-batch data parallelism, two ranks on the one card over
    gloo with CUDA tensors (NCCL refuses two ranks on one card; NCCL across
    cards is not run here).  10a the flat path (main_path_cfg: 4096 global
    envs, horizon 24, 20 mini-epochs, bf16, fused, seed 0), 2 iterations at
    world size 1 in this process and in 2 ranks of 2048 envs: each rank's
    launches per iteration, its parameters, Adam m/v/count and lr bitwise
    equal to the other's after each iteration, the first rollout's buffers
    held to the world-1 rows, the metrics of iteration 1 to the world-1
    run's; each rank's iteration ms and all-reduce ms per mini-epoch (CUDA
    events).  10b the rough path (K5), 2 ranks, 1 iteration, launch counts.
    10c the world-1 checkpoint resumed by both ranks, and the world-2 rank-0
    checkpoint at world size 1, every piece bitwise."""
    import numpy as np
    import torch

    from booster_gym_torch.parallel import Group
    from booster_gym_torch.runner import Runner
    from booster_gym_torch.testing import (
        dp_train,
        main_path_cfg,
        restored_pieces,
        rough_path_cfg,
        time_cuda,
    )
    from booster_gym_torch.utils.recorder import load_checkpoint

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    cfg = main_path_cfg(urdf)
    cfg["basic"]["max_iterations"] = 2
    horizon, epochs = cfg["runner"]["horizon_length"], cfg["runner"]["mini_epochs"]
    B, na = cfg["env"]["num_envs"], cfg["env"]["num_actions"]
    want = {"K1/K5": horizon, "K6+K7 fused": 0, "K2": epochs, "K3": epochs, "K4": epochs}

    # -- 10a. world size 1 here, then 2 ranks sharing the card --------------
    d1, d2 = os.path.join(root, "world1"), os.path.join(root, "world2")
    os.makedirs(d1)
    dp_train({"cfg": cfg, "device": "cuda"}, d1)
    os.chdir(ROOT)
    one = torch.load(os.path.join(d1, "rank0.pt"), weights_only=False)
    ckpt1 = glob_one(os.path.join(d1, "logs", "*", "nn", "model_2.pt"))
    t1 = time.perf_counter()
    two = dp_ranks({"cfg": cfg, "device": "cuda", "resume": ckpt1, "probe": True}, d2)
    log(f"10a. 2 ranks x {B // 2} envs on one card over gloo, 2 iterations, launched and "
        f"joined in {time.perf_counter() - t1:.1f} s (world size 1 in this process: "
        f"{[round(r['iter_ms'], 2) for r in one['records']]} ms per iteration)")
    require([r["world"] for r in two] == [2, 2] and one["world"] == 1, "the worlds' sizes")
    for r in two:
        log(f"  rank {r['rank']}: gloo's collectives on CUDA tensors {r['collectives']}")
        require(all(v == "ok" for v in r["collectives"].values()),
                f"a collective on rank {r['rank']}")
    n_params = two[0]["n_params"]
    for r in two:
        got = [dp_launches(rec) for rec in r["records"]]
        per_epoch = [sum(ms for numel, op, ms in calls
                         if op == "sum" and numel in (2, n_params + 4 + na)) / epochs
                     for calls in r["reduce"]]
        log(f"  rank {r['rank']} [{card}; two ranks sharing one card, not a scaling number]: "
            f"iteration {[round(rec['iter_ms'], 2) for rec in r['records']]} ms (rollout "
            f"{[round(rec['rollout_ms'], 2) for rec in r['records']]}, update "
            f"{[round(rec['update_ms'], 2) for rec in r['records']]}); all-reduce per "
            f"mini-epoch (K2's 2 sums + K3's {n_params + 4 + na} floats) "
            f"{[round(x, 3) for x in per_epoch]} ms by CUDA events; all-reduce calls per "
            f"iteration {[len(c) for c in r['reduce']]}; launches per iteration {got} "
            f"(expected {want})")
        require(got == [want, want], f"rank {r['rank']}'s launches per iteration")
    for i, (a, b) in enumerate(zip(two[0]["snaps"], two[1]["snaps"])):
        same = {k: torch.equal(a[k], b[k]) if k != "count" else a[k] == b[k] for k in a}
        log(f"  after iteration {i + 1}: rank 1's parameters, Adam state and lr against rank "
            f"0's, bitwise {same}")
        require(all(same.values()), f"the ranks' state after iteration {i + 1}")
    names = ("obs", "priv", "act", "mu", "std", "rew", "done", "time_outs")
    worst, bitwise = {}, True
    for i, name in enumerate(names):
        whole = one["buffers"][i].float()
        for r in two:
            part = r["buffers"][i].float()
            lo = r["rank"] * part.shape[1]
            ref = whole[:, lo:lo + part.shape[1]]
            worst[name] = max(worst.get(name, 0.0), float((part - ref).abs().max()))
            bitwise &= torch.equal(part, ref)
    log(f"  the first rollout's buffers, the ranks' rows against the world-1 run's: max |diff| "
        f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} } (tol {TOL_ENV}); bitwise "
        f"{bitwise}")
    require(max(worst.values()) <= TOL_ENV, "the 2-rank rollout against the world-1 rollout")
    ra, rb = one["records"][0], two[0]["records"][0]
    log(f"  iteration 1's metrics: reward {rb['reward']:.6g} against {ra['reward']:.6g}, "
        f"value_loss {rb['value_loss']:.6g} against {ra['value_loss']:.6g}, kl_mean "
        f"{rb['kl_mean']:.6g} against {ra['kl_mean']:.6g}")
    require(np.isclose(rb["reward"], ra["reward"], rtol=TOL_REWARD_RTOL, atol=TOL_REWARD_ATOL)
            and np.isclose(rb["value_loss"], ra["value_loss"], rtol=TOL_VALUE_LOSS_RTOL),
            "the 2-rank metrics against the world-1 metrics")
    timing = ("rollout_ms", "update_ms", "iter_ms", "env_steps_per_sec")
    require(all({k: v for k, v in x.items() if k not in timing}
                == {k: v for k, v in y.items() if k not in timing}
                for x, y in zip(two[0]["records"], two[1]["records"])),
            "the ranks' all-reduced metrics")
    # rule 1's cost: every draw at the global batch, sliced
    gen = torch.Generator(device="cuda").manual_seed(0)
    half = Group(B, torch.device("cuda"), world=2, rank=1, backend="gloo")
    sliced_ms, _ = time_cuda(lambda: half.draw(torch.randn, gen, (B // 2, na)), 200)
    local_ms, _ = time_cuda(lambda: torch.randn((B // 2, na), generator=gen, device="cuda"), 200)
    log(f"  a rank's draw of its {B // 2} x {na} action noise [{card}]: {sliced_ms * 1e3:.2f} us "
        f"at the global batch, sliced, against {local_ms * 1e3:.2f} us for its own rows alone")

    # -- 10b. the rough path, 2 ranks, 1 iteration ------------------------------
    rcfg = rough_path_cfg(urdf)
    rcfg["basic"]["max_iterations"] = 1
    rough = dp_ranks({"cfg": rcfg, "device": "cuda"}, os.path.join(root, "rough"))
    want_rough = {**want, "K6+K7 fused": horizon}
    for r in rough:
        got = dp_launches(r["records"][0])
        log(f"10b. rough path, rank {r['rank']} of 2 [{card}]: iteration "
            f"{r['records'][0]['iter_ms']:.2f} ms; launches {got} (expected {want_rough})")
        require(got == want_rough, f"rank {r['rank']}'s launches on the rough path")

    # -- 10c. resume across world sizes ---------------------------------------
    for r in two:
        log(f"10c. the world-1 checkpoint resumed on rank {r['rank']} of 2: restored bitwise "
            f"{r['restored']}")
        require(all(r["restored"].values()), "a piece of the world-1 checkpoint on 2 ranks")
    ckpt2 = glob_one(os.path.join(d2, "logs", "*", "nn", "model_2.pt"))
    rcfg = main_path_cfg(urdf)
    rcfg["basic"]["checkpoint"] = ckpt2
    resumed = Runner(rcfg, device="cuda")
    _, ts = resumed._init_state()
    pieces = restored_pieces(resumed, ts, load_checkpoint(ckpt2))
    log(f"10c. the 2-rank run's rank-0 checkpoint at world size 1: restored bitwise {pieces}")
    require(all(pieces.values()), "a piece of the 2-rank checkpoint at world size 1")
    os.chdir(ROOT)
    log(f"10. phase 10 took {time.perf_counter() - t0:.1f} s")


DP_PLAY_STEPS, DP_ROUGH_PLAY_STEPS = 100, 20


def dp_play_phase(card, urdf):
    """Phase 10d: play over ranks.  Phase 7's JAX checkpoint played on the
    flat path (4096 global envs, DP_PLAY_STEPS steps) at world size 1 in
    this process and in 2 ranks sharing the card over gloo, started by
    launch as in phase 10: rank 0's gathered trajectory must equal the
    world-1 trajectory bitwise, rank 1 returns None, and each rank launches
    K1 once per step; each rank's steps/s.  Then DP_ROUGH_PLAY_STEPS steps
    of the rough path in 2 ranks: one K5 launch per step, each sampling the
    terrain in its epilogue."""
    import numpy as np
    import torch

    from booster_gym_torch.parallel import launch
    from booster_gym_torch.testing import dp_play, main_path_cfg, rough_path_cfg

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_play_")

    def run(cfg_fn, steps, world, name):
        cfg = cfg_fn(urdf)
        cfg["basic"]["checkpoint"] = JAX_CKPT
        spec, out = {"cfg": cfg, "device": "cuda", "steps": steps}, os.path.join(root, name)
        os.makedirs(out)
        if world == 1:
            dp_play(spec, out)
            os.chdir(ROOT)
        else:
            launch(dp_play, world, (spec, out), timeout_s=DP_RANK_TIMEOUT_S)
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]

    (one,) = run(main_path_cfg, DP_PLAY_STEPS, 1, "world1")
    t1 = time.perf_counter()
    two = run(main_path_cfg, DP_PLAY_STEPS, 2, "world2")
    B = main_path_cfg(urdf)["env"]["num_envs"]
    log(f"10d. {JAX_CKPT} played {DP_PLAY_STEPS} steps on the flat path at {B} global envs: "
        f"world size 1 in this process {DP_PLAY_STEPS / (one['ms'] / 1e3):,.1f} steps/s; 2 ranks "
        f"x {B // 2} envs on one card over gloo, launched and joined in "
        f"{time.perf_counter() - t1:.1f} s")
    whole, gathered = one["plays"][0], two[0]["plays"][0]
    require(two[1]["plays"][0] is None and gathered is not None, "rank 0 alone returns the play")
    bitwise, worst = True, {}
    for k, ref in whole.items():
        got = gathered[k]
        require(got.shape == ref.shape == (DP_PLAY_STEPS, B, *ref.shape[2:]),
                f"the gathered {k}'s shape {got.shape}")
        bitwise &= np.array_equal(got, ref)
        worst[k] = float(np.abs(got.astype(np.float64) - ref.astype(np.float64)).max())
    finite = all(np.isfinite(v).all() for v in whole.values())
    log(f"  rank 0's gathered trajectory against the world-1 play: bitwise {bitwise}; max |diff| "
        f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} }; finite {finite}; mean reward "
        f"per step {whole['rew'].mean():.4f} (gathered {gathered['rew'].mean():.4f})")
    for r in two:
        log(f"  rank {r['rank']} of 2 [{card}; two ranks sharing one card, not a scaling "
            f"number]: {DP_PLAY_STEPS / (r['ms'] / 1e3):,.1f} steps/s ({r['ms']:.1f} ms by CUDA "
            f"events for {B // 2} envs); K1 launches {r['launches']} (expected {DP_PLAY_STEPS}), "
            f"fused sampling {r['fused']}")
        require((r["launches"], r["fused"]) == (DP_PLAY_STEPS, 0),
                f"rank {r['rank']}'s launches in play")
    require(finite and bitwise, "the 2-rank play against the world-1 play")
    rough = run(rough_path_cfg, DP_ROUGH_PLAY_STEPS, 2, "rough")
    for r in rough:
        log(f"10d. rough path, rank {r['rank']} of 2 [{card}]: {DP_ROUGH_PLAY_STEPS} steps "
            f"in {r['ms']:.1f} ms; K5 launches {r['launches']}, fused sampling {r['fused']} "
            f"(expected {DP_ROUGH_PLAY_STEPS} each)")
        require((r["launches"], r["fused"]) == (DP_ROUGH_PLAY_STEPS, DP_ROUGH_PLAY_STEPS),
                f"rank {r['rank']}'s launches in the rough play")
    require(rough[1]["plays"][0] is None and all(
        np.isfinite(v).all() and v.shape[:2] == (DP_ROUGH_PLAY_STEPS, B)
        for v in rough[0]["plays"][0].values()), "the rough play's gathered trajectory")
    log(f"10d. took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 11: the port's deploy stack, on the CPU
_DEPLOY_MAIN = r"""
import importlib.util, json, runpy, sys
specs = {m: importlib.util.find_spec(m) for m in ("jax", "booster_gym_tpu")}
installed = {m: spec and (spec.origin or str(spec.submodule_search_locations))
             for m, spec in specs.items()}


class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "booster_gym_tpu"):
            raise ImportError(f"{name} cannot be imported here")
        return None


sys.meta_path.insert(0, _Blocked())
sys.argv = ["booster_gym_torch.deploy.main"] + sys.argv[1:]
try:
    runpy.run_module("booster_gym_torch.deploy.main", run_name="__main__")
finally:
    loaded = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "booster_gym_tpu"))
    print("modules: " + json.dumps({"installed": installed, "loaded": loaded}))
"""


def deploy_phase(card):
    """Phase 11, a CPU phase: the deploy runtime runs on the CPU by design,
    as on the robot.  The JAX checkpoint's actor exported with
    booster_gym_torch.export drives `python -m booster_gym_torch.deploy.main
    --mock --seconds 2` (the port's deploy config with its policy_path
    pointed at the export) in a subprocess whose imports of jax and
    booster_gym_tpu raise (whether they are installed there is printed): it
    must exit 0, print its `mock run done` line with a nonzero leg target,
    and have loaded neither.  Then whether the native publisher built
    (g++)."""
    import subprocess

    import numpy as np
    import yaml

    from booster_gym_torch import export as port_export
    from booster_gym_torch.deploy import native

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    policy = port_export.export(JAX_CKPT, output=os.path.join(work, "policy.pt"))
    with open(os.path.join(ROOT, "booster_gym_torch", "deploy", "configs", "T1.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["policy"]["policy_path"] = policy
    cfg_path = os.path.join(work, "T1.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    env = {**os.environ, "PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", _DEPLOY_MAIN, "--mock", "--seconds", "2",
                          "--config", cfg_path], cwd=work, env=env, capture_output=True,
                         text=True, timeout=300)
    lines = out.stdout.splitlines()
    done = [ln for ln in lines if ln.startswith("mock run done")]
    mods = [json.loads(ln[len("modules: "):]) for ln in lines if ln.startswith("modules: ")]
    legs = ([float(v) for v in done[0].split("leg_target[0:4]=")[1].strip("[] ").split()]
            if done else [])
    log(f"11. the port's deploy stack on the CPU (the robot's runtime; no card): python -m "
        f"booster_gym_torch.deploy.main --mock --seconds 2 on the export of {JAX_CKPT}: exit "
        f"{out.returncode} in {time.perf_counter() - t0:.1f} s; {done[0] if done else 'no summary'}; "
        f"installed (found, importing them raises): {mods[0]['installed'] if mods else '?'}, "
        f"loaded {mods[0]['loaded'] if mods else '?'}")
    if out.returncode != 0:
        log(out.stdout[-3000:], out.stderr[-3000:])
    require(out.returncode == 0 and len(done) == 1, "the deploy stack's mock run")
    require(any(abs(v) > 1e-3 for v in legs), f"the policy moved no leg target: {legs}")
    require(len(mods) == 1 and mods[0]["loaded"] == [], f"the deploy run loaded JAX: {mods}")
    built = native.available()
    step = None
    if built:
        pub = native.NativePublisher(cfg)
        pub.init_filtered(np.zeros(23, np.float32))
        pub.set_targets(np.full(23, 0.1, np.float32), np.zeros(23, np.float32))
        step = [round(float(x), 4) for x in pub.step()[0][:4]]
    log(f"11. native publisher (g++ on first use, into {os.path.dirname(native._SO)}): built "
        f"{built}; one step's q[0:4] {step}; [{card}: not used by this phase]")


LEARNING_ENVS, LEARNING_ITERS, LEARNING_SEED = 4096, 300, 3


def learning_phase(card, urdf):
    """Phase 12: the JAX package's learning test at 4096 envs on the card
    (testing.learning_check), held to its own rule."""
    import torch

    from booster_gym_torch.testing import learning_cfg, learning_check, learning_rule

    gc.collect()
    t0 = time.perf_counter()
    log(f"12. the learning check: testing.learning_cfg on the stand-in, {LEARNING_ENVS} envs, "
        f"bf16, fused, seed {LEARNING_SEED}, {LEARNING_ITERS} iterations; reward and episode "
        f"steps every 15 iterations:")
    rewards, steps, counts = learning_check(learning_cfg(urdf, LEARNING_ENVS), LEARNING_ITERS,
                                            LEARNING_SEED, "cuda", every=15, log=log)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ok, early_r, late_r, early_s, late_s = learning_rule(rewards, steps)
    log(f"12. reward iterations 21-60 {early_r:.4f} -> last 40 {late_r:.4f} (rule: above "
        f"{max(1.5 * early_r, early_r + 0.1):.4f}); episode steps {early_s:.1f} -> {late_s:.1f} "
        f"(rule: above {0.85 * early_s:.1f}); launches {counts}; rule met: {ok}; phase 12 took "
        f"{secs:.1f} s [{card}]")
    require(counts == {"substep": 24 * LEARNING_ITERS, "gae": 5 * LEARNING_ITERS,
                       "grads_stats": 5 * LEARNING_ITERS, "opt_stage": 5 * LEARNING_ITERS},
            f"phase 12's launches {counts}")
    require(ok, "the learning check's rule (tests/test_learning.py) on the card")


def glob_one(pattern):
    import glob

    found = glob.glob(pattern)
    require(len(found) == 1, f"one file for {pattern}, found {found}")
    return found[0]


def main():
    if not os.path.isdir(os.path.join(ROOT, "booster_gym_torch")):
        print("chip_smoke.py: the booster_gym_torch package is not beside this script",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this smoke run needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from booster_gym_torch import kernel_build, prof_update
    from booster_gym_torch.algo import update_kernel
    from booster_gym_torch.algo.networks import ActorCritic
    from booster_gym_torch.model import load_urdf
    from booster_gym_torch.physics import SimConfig
    from booster_gym_torch.physics import substep_kernel as sk
    from booster_gym_torch.physics.engine import make_substep
    from booster_gym_torch.runner import Runner
    from booster_gym_torch.terrain import Terrain, sample_kernel
    from booster_gym_torch.testing import (
        bound,
        card_line,
        control_inputs,
        device_ms,
        main_path_cfg,
        rand_inputs,
        rough_path_cfg,
        sampler_inputs,
        time_cuda,
        toy_model,
        write_t1_shaped_urdf,
    )
    from booster_gym_torch.utils.config import load_task_cfg

    # -- 1. the card -----------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # -- 2. build the kernels, every nvcc at once ---------------------------
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    urdf = write_t1_shaped_urdf(workdir)
    models = {"toy": toy_model(), "t1": load_urdf(urdf, cylinder_rim_points=4)}
    cfg = SimConfig()
    # T1.yaml's terrain and foot edge points; the sampler at the rough
    # path's 56 + 1 + 8 queries
    t1_cfg = load_task_cfg("T1")
    terrain = Terrain(t1_cfg["terrain"], seed=0, device="cuda")
    edges = t1_cfg["asset"]["feet_edge_pos"]
    sampler = sample_kernel.make_terrain_sampler(terrain, 65, "cuda")
    kernels, general, plains, no_epilogue = {}, {}, {}, {}
    for name, model in models.items():
        feet = [i for i, n in enumerate(model.body_names) if "foot" in n]
        kernels[name] = sk.SubstepKernel(model, cfg, feet, "cuda", feet_edge_pos=edges)
        general[name] = sk.SubstepKernel(model, cfg, feet, "cuda", plane=False,
                                         feet_edge_pos=edges, terrain=terrain)
        plains[name] = make_substep(model, cfg, feet, "cuda")
    # the T1-shaped robot's control steps without the epilogue (its cost)
    for label, plane in (("K1", True), ("K5", False)):
        feet = [i for i, n in enumerate(models["t1"].body_names) if "foot" in n]
        k = sk.SubstepKernel(models["t1"], cfg, feet, "cuda", plane=plane, feet_edge_pos=edges,
                             terrain=None if plane else terrain)
        k.sizes = {**k.sizes, "EPILOGUE": 0}
        no_epilogue[label] = k
    update_sizes = update_kernel.FusedUpdate(ActorCritic(12, 47, 14), 0.2, 10.0).sizes
    t0 = time.perf_counter()
    builds = {f"K1 for {n}": kernel_build.start_build(sk.SOURCE, k.sizes)
              for n, k in kernels.items()}
    builds.update({f"K5 for {n}": kernel_build.start_build(sk.SOURCE, k.sizes)
                   for n, k in general.items()})
    builds.update({f"{n} for t1 without the epilogue": kernel_build.start_build(sk.SOURCE, k.sizes)
                   for n, k in no_epilogue.items()})
    builds["K6+K7"] = kernel_build.start_build(sample_kernel.SOURCE, {})
    builds["K2-K4, K8-K10"] = kernel_build.start_build(update_kernel.SOURCE, update_sizes)
    ctx8 = phase8_setup(workdir)
    builds.update(phase8_builds(ctx8))
    for name, (path, proc, tmp) in builds.items():
        report = kernel_build.finish_build(path, proc, tmp)
        log(f"built {name}: {os.path.basename(path)} (done {time.perf_counter() - t0:.1f} s "
            f"after the builds started)")
        lines = report.splitlines()
        for i, line in enumerate(lines):
            if "registers" in line:
                fn = lines[i - 2].split(" for ")[-1].strip()[:48] if i >= 2 else ""
                log(f"  ptxas {fn}: {lines[i - 1].strip()}; "
                    f"{line.strip().replace('ptxas info    : ', '')}")
    for k in (*kernels.values(), *general.values(), *no_epilogue.values(), sampler):
        k.build()   # loads the library just built
    log(f"kernel builds: {time.perf_counter() - t0:.1f} s (set-up)")
    planes = main_path_cfg(urdf)["runner"]["horizon_length"] + 1   # K2's T + 1 on the path
    for dtype in ("bf16", "f32"):
        fused = update_kernel.FusedUpdate(ActorCritic(12, 47, 14, compute_dtype=dtype), 0.2, 10.0)
        info = fused.info(torch.device("cuda"))
        log(f"K3/K9 {dtype} [{card}]: pass 1 {info['tile']} rows a tile, {info['smem_pass1']} "
            f"bytes of shared memory per block, resident blocks per SM "
            f"{info['blocks_per_sm_pass1']}; pass 2 {info['pass2_tiles']} tiles, "
            f"{info['smem_pass2']} bytes per block, resident blocks per SM "
            f"{info['blocks_per_sm_pass2']}; scratch {info['scratch_width']} values a row")
        for name, n in (("K2", planes), ("K8", 0)):
            ci = fused.critic_info(torch.device("cuda"), n)
            log(f"{name} {dtype} [{card}]: k2_critic {info['k2_tile']} rows a tile, clusters of "
                f"{info['k2_cluster']} blocks of {info['k2_threads']} threads, {ci['smem']} bytes "
                f"of shared memory per block at {n} planes of values (at most "
                f"{info['k2_max_planes']}), resident blocks per SM {ci['blocks_per_sm']}, "
                f"resident clusters {ci['clusters']}")
            require(ci["blocks_per_sm"] >= 1 and ci["clusters"] >= 1,
                    f"{name}'s critic kernel does not fit the card ({dtype})")
    for label, ks in (("K1", kernels), ("K5", general)):
        for n, k in ks.items():
            info = k.info()
            log(f"{label} for {n} [{card}]: {info['envs_per_block']} envs per block, "
                f"{info['smem_bytes']} bytes of shared memory per block, resident blocks per SM "
                f"{info['blocks_per_sm_substep']} (substep) / {info['blocks_per_sm_control']} "
                f"(control step)")

    # -- 3. K1 against its plain version -----------------------------------
    max_err = 0.0
    for name in ("toy", "t1"):
        for B in (4096, 1000):
            max_err = max(max_err, compare_kernel(name, kernels[name], plains[name],
                                                  models[name], B))
    log(f"K1 matches its plain version: max abs err {max_err:.3e}")

    # -- 3a. K5 against its plain version and against K1; the sampler ------
    k5_err = sampler_err = 0.0
    for name in ("toy", "t1"):
        for B in (4096, 1000):
            k5_err = max(k5_err, compare_kernel(name, general[name], plains[name],
                                                models[name], B, terrain=terrain))
            compare_general_with_plane(name, kernels[name], general[name], models[name], B)
    log(f"K5 matches its plain version: max abs err {k5_err:.3e}; on plane inputs it is K1")
    for B in (4096, 1000):
        for clamped in (False, True):
            sampler_err = max(sampler_err, compare_sampler(sampler, terrain, B, clamped))
    log(f"the sampler matches its plain version: max abs err {sampler_err:.3e}")
    for name in ("toy", "t1"):
        for B in (4096, 1000):
            sampler_err = max(sampler_err, compare_fused_sampling(
                name, general[name], models[name], terrain, B))
    log("K5's fused sampling equals the sampler kernel on its own queries; its edge points "
        f"equal the torch ops; sampler max abs err {sampler_err:.3e}")

    # -- 3b. K1 and K5 through control_step: the decimation loop in one launch
    control_err = {"K1": 0.0, "K5": 0.0}
    for name in ("toy", "t1"):
        for B in (4096, 1000):
            control_err["K1"] = max(control_err["K1"], compare_control(
                name, kernels[name], models[name], B)[0])
            control_err["K5"] = max(control_err["K5"], compare_control(
                name, general[name], models[name], B, terrain=terrain)[0])
            compare_control_general_with_plane(name, kernels[name], general[name],
                                               models[name], B)
    log("K1 and K5 control steps match the plain loop: max abs err "
        f"K1 {control_err['K1']:.3e}, K5 {control_err['K5']:.3e}; both repeat bitwise; on plane "
        "inputs K5 is K1")
    max_err, k5_err = max(max_err, control_err["K1"]), max(k5_err, control_err["K5"])

    # -- 3c. K2-K4 against their plain versions, then the whole update -----
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions' f32 products
    update_err = {"K2": 0.0, "K3": 0.0, "K4": 0.0}
    for dtype in ("bf16", "f32"):
        for B in (4096, 1000, 4097):
            for k, e in compare_update_kernels(dtype, B).items():
                update_err[k] = max(update_err[k], e)
    for dtype in ("bf16", "f32"):
        update_err["K2"] = max(update_err["K2"], compare_gae_past_planes(dtype))
    log("K2, K3 and K4 match their plain versions (K2 also past its shared memory's planes): "
        "max abs err " + ", ".join(f"{k} {e:.3e}" for k, e in update_err.items()))
    compare_fused_with_xla(urdf)
    anchor_err = {"K8": 0.0, "K9": 0.0, "K10": 0.0}
    for dtype in ("bf16", "f32"):
        for B in (4096, 1000, 4097):
            for k, e in compare_anchor_kernels(dtype, B).items():
                anchor_err[k] = max(anchor_err[k], e)
    log("K8, K9 and K10 match their plain versions and agree with K2 and K3: max abs err "
        + ", ".join(f"{k} {e:.3e}" for k, e in anchor_err.items()))
    update_err.update(anchor_err)

    # -- 4. main path ----------------------------------------------------
    tcfg = main_path_cfg(urdf)
    horizon, mini_epochs = tcfg["runner"]["horizon_length"], tcfg["runner"]["mini_epochs"]
    if (horizon, mini_epochs) != (24, 20) or tcfg["algorithm"]["update_backend"] != "fused":
        raise AssertionError(f"T1.yaml horizon/mini-epochs/update are {horizon}/{mini_epochs}/"
                             f"{tcfg['algorithm']['update_backend']}")
    os.chdir(workdir)   # run logs and checkpoints go to the scratch directory
    runner = Runner(tcfg, device="cuda")
    fused = runner.ppo.fused
    runner.env.substep.launches = 0
    fused.gae_launches = fused.grads_stats_launches = fused.opt_stage_launches = 0
    records = runner.train()
    torch.cuda.synchronize()
    launches = {"K1": runner.env.substep.launches, "K2": fused.gae_launches,
                "K3": fused.grads_stats_launches, "K4": fused.opt_stage_launches}
    k1_per_iter = horizon   # one control-step launch per env step
    expect = {"K1": 3 * k1_per_iter, "K2": 3 * mini_epochs, "K3": 3 * mini_epochs,
              "K4": 3 * mini_epochs}

    def log_records(label, records):
        for rec in records:
            bad = [k for k, v in rec.items() if not np.isfinite(v)]
            if bad:
                raise AssertionError(f"non-finite metrics: {bad}")
            log(f"{label} [{card}] iter: {rec['iter_ms']:.2f} ms (rollout "
                f"{rec['rollout_ms']:.2f} ms, update {rec['update_ms']:.2f} ms), "
                f"{rec['env_steps_per_sec']:,.0f} env-steps/s, reward {rec['reward']:.4f}, "
                f"value_loss {rec['value_loss']:.4f}, kl {rec['kl_mean']:.5f}")

    log_records("main path (fused update)", records)
    per_iter = [[int(rec[k]) for k in ("substep_kernel_launches", "gae_launches",
                                       "grads_stats_launches", "opt_stage_launches")]
                for rec in records]
    if any(rec["fused_sampler_launches"] or rec["terrain_sampler_launches"] for rec in records):
        raise AssertionError("the flat path sampled terrain")
    log(f"main path launches: {launches} (expected {expect}), per iteration K1/K2/K3/K4 "
        f"{per_iter}")
    if launches != expect or per_iter != [[k1_per_iter] + [mini_epochs] * 3] * 3:
        raise AssertionError(f"kernel launches on the main path: {launches} ({per_iter} per "
                             f"iteration), expected {expect}")
    ts = runner.train_state
    if ts.obs.shape != (4096, 47) or ts.privileged_obs.shape != (4096, 14):
        raise AssertionError(f"observation shapes {tuple(ts.obs.shape)}, "
                             f"{tuple(ts.privileged_obs.shape)}")
    if not bool(torch.isfinite(ts.obs).all()):
        raise AssertionError("non-finite observations after training")
    if runner.ppo.network.actor.dtype != torch.bfloat16:
        raise AssertionError("the main path's compute type is not bf16")

    # the earlier xla update on the same configuration, for its times
    xcfg = main_path_cfg(urdf)
    xcfg["algorithm"]["update_backend"] = "xla"
    xcfg["basic"]["max_iterations"] = 2
    xrunner = Runner(xcfg, device="cuda")
    xrecords = xrunner.train()
    torch.cuda.synchronize()
    log_records("same path, xla update", xrecords)
    if xrunner.ppo.fused.grads_stats_launches != 0 or [
            int(r["substep_kernel_launches"]) for r in xrecords] != [k1_per_iter] * 2:
        raise AssertionError("the xla run's kernel launches")
    f, x = records[-1], xrecords[-1]
    log(f"last iteration, fused vs xla update [{card}]: update {f['update_ms']:.2f} vs "
        f"{x['update_ms']:.2f} ms, rollout {f['rollout_ms']:.2f} vs {x['rollout_ms']:.2f} ms, "
        f"iteration {f['iter_ms']:.2f} vs {x['iter_ms']:.2f} ms")

    # -- 4b. the rough path: T1.yaml's own terrain ---------------------------
    rcfg = rough_path_cfg(urdf)
    if rcfg["terrain"] != load_task_cfg("T1")["terrain"] or rcfg["terrain"]["type"] != "trimesh":
        raise AssertionError("the rough path's terrain block is not T1.yaml's")
    rrunner = Runner(rcfg, device="cuda")
    renv, rfused = rrunner.env, rrunner.ppo.fused
    if tuple(renv.terrain.height_field.shape) != (900, 200):
        raise AssertionError(f"height field {tuple(renv.terrain.height_field.shape)}")
    if renv.substep.plane or renv.num_envs != 4096:
        raise AssertionError("the rough path does not run the general-terrain kernel at 4096")
    renv.substep.launches = renv.substep.fused_sampler_launches = 0
    renv.terrain_sampler.launches = 0
    rfused.gae_launches = rfused.grads_stats_launches = rfused.opt_stage_launches = 0
    k1_wrappers = (*kernels.values(), runner.env.substep, xrunner.env.substep)
    k1_before = sum(k.launches for k in k1_wrappers)
    rrecords = rrunner.train()
    torch.cuda.synchronize()
    # K6 + K7 run in K5's launches (the epilogue's sampling); the
    # standalone sampler kernel is not launched on the path
    rough_launches = {"K5": renv.substep.launches,
                      "K6+K7": renv.substep.fused_sampler_launches,
                      "standalone sampler": renv.terrain_sampler.launches,
                      "K2": rfused.gae_launches, "K3": rfused.grads_stats_launches,
                      "K4": rfused.opt_stage_launches,
                      "K1": sum(k.launches for k in k1_wrappers) - k1_before}
    log_records("rough path (fused update)", rrecords)
    rough_per_iter = [[int(rec[k]) for k in (
        "substep_kernel_launches", "fused_sampler_launches", "terrain_sampler_launches",
        "gae_launches", "grads_stats_launches", "opt_stage_launches")] for rec in rrecords]
    rough_expect = {"K5": 3 * k1_per_iter, "K6+K7": 3 * horizon, "standalone sampler": 0,
                    "K2": 3 * mini_epochs, "K3": 3 * mini_epochs, "K4": 3 * mini_epochs,
                    "K1": 0}
    log(f"rough path launches: {rough_launches} (expected {rough_expect}), per iteration "
        f"K5/K6+K7 in K5/standalone sampler/K2/K3/K4 {rough_per_iter}")
    if rough_launches != rough_expect or rough_per_iter != [
            [k1_per_iter, horizon, 0] + [mini_epochs] * 3] * 3:
        raise AssertionError(f"kernel launches on the rough path: {rough_launches} "
                             f"({rough_per_iter} per iteration), expected {rough_expect}")
    rts = rrunner.train_state
    if rts.obs.shape != (4096, 47) or not bool(torch.isfinite(rts.obs).all()):
        raise AssertionError("observations after rough training")
    rstate = rts.env_state
    if not (bool(torch.isfinite(rstate.point_heights).all())
            and float(rstate.point_heights.abs().max()) > 0
            and bool(torch.isfinite(rstate.point_normals).all())):
        raise AssertionError("the carried per-point terrain after rough training")
    f, r = records[-1], rrecords[-1]
    log(f"last iteration, flat vs rough path [{card}]: rollout {f['rollout_ms']:.2f} vs "
        f"{r['rollout_ms']:.2f} ms, update {f['update_ms']:.2f} vs {r['update_ms']:.2f} ms, "
        f"iteration {f['iter_ms']:.2f} vs {r['iter_ms']:.2f} ms")
    # the launches per iteration of both paths, from the profile
    from booster_gym_torch import profile_iteration

    profiles = {}
    for path in ("plane", "trimesh"):
        prof = profile_iteration.main(["--terrain", path])
        profiles[path] = {ph: prof[ph]["launches_per_iter"]
                          for ph in ("iteration", "rollout", "update")}
        k4 = sum(v["launches"] for k, v in prof["update"]["kernels"].items() if "k4_" in k)
        sampler_kernels = sum(v["launches"] for k, v in prof["iteration"]["kernels"].items()
                              if "terrain_sample" in k)
        # (a trace can lose events: the wrappers' counts above are the check;
        # a lost event cannot add a sampler kernel)
        log(f"{path} path launches per iteration (profile_iteration, torch.profiler) [{card}]: "
            f"{profiles[path]}; K4 device kernels {k4:g}; standalone sampler kernels "
            f"{sampler_kernels:g}")
        require(k4 <= mini_epochs and sampler_kernels == 0,
                f"the {path} path's K4 or sampler kernels per iteration")

    # -- 4c. the path of K8-K10: prof_update at its defaults ----------------
    # prof_update builds its own FusedUpdate, so every count starts at 0 here
    precords = prof_update.main([])
    calls = prof_update.WARMUP + 50
    by_kernel = {r["kernel"]: r for r in precords}
    prof_launches = {k: r["launches"] for k, r in by_kernel.items()}
    log(f"prof_update at T=24, B=4096, bf16 [{card}]: launches {prof_launches} for {calls} "
        f"calls each; ms per call " + ", ".join(f"{k} {r['ms']:.4f}" for k, r in by_kernel.items()))
    require(sorted(by_kernel) == sorted(["K2", "K3", "K4", "K8", "K9", "K10"])
            and all(n == calls for n in prof_launches.values())
            and all((r["T"], r["B"], r["dtype"]) == (24, 4096, "bf16") for r in precords),
            f"prof_update's launches {prof_launches}, expected {calls} each")
    launches.update({k: prof_launches[k] for k in ("K8", "K9", "K10")})

    # -- 5. env step on the card against the CPU ---------------------------
    from booster_gym_torch.envs.t1 import T1

    for label, terrain_cfg in (("plane", {"type": "plane"}), ("trimesh", dict(
            num_terrains=2, terrain_width=4.0, terrain_length=4.0, border_size=2.0))):
        ecfg = load_task_cfg("T1")
        ecfg["env"]["num_envs"] = 256
        ecfg["terrain"].update(terrain_cfg)
        ecfg["asset"]["file"] = urdf
        ecfg["noise"] = {}
        env_cpu, env_gpu = T1(ecfg, "cpu"), T1(ecfg, "cuda")
        gen = torch.Generator().manual_seed(1)
        params = env_cpu.init_params(gen)
        state, _, _ = env_cpu.reset_all(params, gen)
        actions = 0.3 * torch.randn(256, 12, generator=gen)
        out_c = env_cpu.step(params, state, actions, gen)
        out_g = env_gpu.step(to_device(params, "cuda"), to_device(state, "cuda"),
                             actions.cuda(), torch.Generator("cuda").manual_seed(1))
        keep = ~(out_c[3] | out_g[3].cpu())
        pairs = [("obs", out_g[1], out_c[1]), ("reward", out_g[2], out_c[2]),
                 ("privileged", out_g[4]["privileged_obs"], out_c[4]["privileged_obs"])]
        require(env_gpu.substep.launches == 1, f"the {label} env step's substep-kernel launches")
        if label == "trimesh":
            require(env_gpu.substep.fused_sampler_launches == 1
                    and env_gpu.terrain_sampler.launches == 0,
                    "the trimesh env step's kernel launches")
            # (the carried normals are left out: they jump at the field's grid
            # lines, which a point a rounding apart may straddle)
            pairs += [("point_heights", out_g[0].point_heights, out_c[0].point_heights)]
        for what, a, b in pairs:
            a, b = a.cpu()[keep], b[keep]
            err = float((a - b).abs().max())
            ok = bool(((a - b).abs() <= TOL_ENV + TOL_ENV * b.abs()).all())
            log(f"env step cuda vs cpu, {label} ({int(keep.sum())} envs): {what} "
                f"max_abs={err:.3e} tol={TOL_ENV} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"env step on the card disagrees with the CPU: {what}")

    # -- 6. timing: K1, K5 and the sampler, then K2-K4 ----------------------
    B = 4096
    plain, model = plains["t1"], models["t1"]
    state, dyn, tau, ef, et = rand_inputs(model, B, "cuda", seed=3, standing=True)
    ptau = tau.T.contiguous()
    pext = torch.cat([ef, et], dim=-1).T.contiguous()
    h, n = point_terrain(terrain, model, B, seed=4)
    ph, pn = h.T.contiguous(), n.reshape(B, -1).T.contiguous()
    entries, epilogue_ms = [], {}
    for k, hn, phn, n_launches, err in (
            (kernels["t1"], (), (), launches["K1"], max_err),
            (general["t1"], (h, n), (ph, pn), rough_launches["K5"], k5_err)):
        label = "K1" if k.plane else "K5"
        ps, pdyn = k.pack_sim(state), k.pack_dyn(dyn)
        n0 = k.launches
        # one substep per launch (packed_call)
        ms, _ = time_cuda(lambda: k.packed_call(ps, pdyn, ptau, pext, *phn), 200)
        plain_fn = plain if k.plane else plain.terrain_form
        plain_ms, _ = time_cuda(lambda: plain_fn(state, dyn, tau, ef, et, *hn), 20)
        nbytes = substep_bytes(k) * B
        nops = substep_op_count(model, cfg, k.plane) * B
        bound_ms, bound_by = bound(nbytes, nops)
        log(f"{label} one substep per launch at {B} envs [{card}]: {ms * 1e3:.2f} us/substep; "
            f"plain version {plain_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us by {bound_by} "
            f"({nbytes / 1e6:.2f} MB, {nops / 1e6:.1f} Mop at 67 TFLOP/s f32)")
        # one control step per launch, as the main path runs it (K5 sampling
        # the terrain in its epilogue); beside it the build without the
        # epilogue, in turns (with, without, without, with)
        cargs = control_inputs(k, model, B, "cuda", seed=5, terrain=terrain)
        if not k.plane:
            cargs.append(terrain.height_field)
        bare = no_epilogue[label]
        runs = {"with": [], "without": []}
        for which in ("with", "without", "without", "with"):
            kk = k if which == "with" else bare
            runs[which].append(time_cuda(lambda: kk.control_step(*cargs), 25)[0])
        cms = sum(runs["with"]) / 2
        bare_ms = sum(runs["without"]) / 2
        epilogue_ms[label] = cms - bare_ms
        cplain_ms, _ = time_cuda(lambda: k.control_step_plain(*cargs), 3, warmup=1)
        dec = 10
        cbytes = control_bytes(k) * B + (0 if k.plane else terrain.height_field.numel() * 4)
        cops = dec * nops + epilogue_op_count(k) * B
        cbound_ms, cbound_by = bound(cbytes, cops)
        log(f"{label} one control step per launch at {B} envs [{card}]: {cms * 1e3:.2f} us per "
            f"launch, {cms * 1e3 / dec:.2f} us per substep; without the epilogue "
            f"{bare_ms * 1e3:.2f} us (the epilogue: {epilogue_ms[label] * 1e3:.2f} us; runs with "
            f"{[round(x * 1e3, 2) for x in runs['with']]}, without "
            f"{[round(x * 1e3, 2) for x in runs['without']]}); plain loop {cplain_ms:.2f} ms; "
            f"bound {cbound_ms * 1e3:.2f} us by {cbound_by} ({cbytes / 1e6:.2f} MB, "
            f"{cops / 1e6:.1f} Mop at 67 TFLOP/s f32); timing launches {k.launches - n0}")
        entries.append({
            "name": ("K1 substep (plane)" if k.plane else "K5 substep (general terrain)")
            + ", one control step per launch",
            "route": "cuda", "source": "booster_gym_torch/csrc/substep.cu",
            "replaces": "booster_gym_tpu/physics/pallas_engine.py:267",
            "launches": n_launches, "max_abs_err": err, "ms": cms, "plain_ms": cplain_ms,
            "bound_ms": cbound_ms, "bound_by": cbound_by, "library_ms": None,
            "ms_without_epilogue": bare_ms})

    # the sampler at the rough path's shapes: 4096 roots over the tiles, 65
    # queries within 0.55 m of each (the contact points' reach); on the path
    # the same device code runs in K5's epilogue, whose cost is its entry's
    # epilogue_ms
    N = sampler.num_points
    root, pts = (torch.as_tensor(x, device="cuda")
                 for x in sampler_inputs(terrain, B, N, 0.55, False, seed=5))
    hf = terrain.height_field
    n0 = sampler.launches
    ms, _ = time_cuda(lambda: sampler(hf, root, pts), 200)
    plain_ms, _ = time_cuda(lambda: sampler.plain(hf, root, pts), 20)
    nbytes = B * (8 + N * 8 + N * 16) + hf.numel() * 4
    nops = B * N * 50
    bound_ms, bound_by = bound(nbytes, nops)
    dev_ms, dev_count = device_ms(lambda: sampler(hf, root, pts), ["terrain_sample"])
    log(f"K6+K7 sampler at {B} envs x {N} queries [{card}]: standalone kernel {ms * 1e3:.2f} "
        f"us/call (device {dev_ms['terrain_sample'] * 1e3:.2f} us, "
        f"{dev_count['terrain_sample']:g} kernel per call); in K5's epilogue "
        f"{epilogue_ms['K5'] * 1e3:.2f} us per control step (K1's edge points alone "
        f"{epilogue_ms['K1'] * 1e3:.2f} us); plain version {plain_ms * 1e3:.1f} us; bound "
        f"{bound_ms * 1e3:.2f} us by {bound_by} ({nbytes / 1e6:.2f} MB, {nops / 1e6:.1f} Mop at "
        f"67 TFLOP/s f32); library: none (grid_sample gives no slopes and clamps to the whole "
        f"field); timing launches {sampler.launches - n0}")
    entries.append({
        "name": "K6+K7 terrain sampler, in K5's control-step epilogue", "route": "cuda",
        "source": "booster_gym_torch/csrc/terrain_sample.cuh",
        "replaces": "booster_gym_tpu/terrain/sample_kernel.py:83 and :181",
        "launches": rough_launches["K6+K7"], "max_abs_err": sampler_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "device_ms": dev_ms["terrain_sample"], "epilogue_ms": epilogue_ms["K5"]})
    line = {"kernels": entries + time_update_kernels(card, launches, update_err, by_kernel)}

    # -- 7. resume, the JAX checkpoint played, export -------------------------
    resume_play_export(card, urdf)

    # -- 8. the serial robot and the standup task ------------------------------
    line["kernels"] += serial_and_standup(card, ctx8, workdir)

    # -- 9. the sampling MPC -----------------------------------------------------
    line["kernels"] += mpc_phase(card, urdf)

    # -- 10. data parallelism: two ranks sharing the card ---------------------
    data_parallel_phase(card, urdf)
    dp_play_phase(card, urdf)

    # -- 11. the deploy stack, on the CPU ---------------------------------------
    deploy_phase(card)

    # -- 12. the port learns ------------------------------------------------------
    learning_phase(card, urdf)
    log(card)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
