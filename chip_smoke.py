#!/usr/bin/env python3
"""Smoke run of the PyTorch port (booster_gym_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi); CUDA must be available;
  2. build the CUDA substep kernel K1 (csrc/substep.cu) for the toy robot
     and the T1-shaped robot, the two nvcc runs in parallel;
  3. K1 against its plain PyTorch version on the card, both robots, B = 4096
     and B = 1000 (a ragged last block), several substeps;
  4. the main path: booster_gym_torch.train's Runner on flat T1 (the
     T1-shaped stand-in URDF), 4096 envs, horizon 24, 20 mini-epochs,
     update_backend xla, 3 iterations; K1's launch count must be 24 x 10 per
     iteration;
  5. one control step of the env on the card against the same step on the
     CPU (plain substep) from the same state, a small batch;
  6. K1's time per substep at 4096 envs beside its bound and the plain
     version's time, printed as a `kernels` JSON line.
The last line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# K1 against its plain version: the state and the feet poses to rtol = atol
# = 2e-3, the JAX package's kernel-vs-engine tolerance; contact forces to
# rtol 5e-2 / atol 1 N, as the JAX package's tests.  The env step on the card
# against the CPU: observations and rewards to the same 2e-3.
TOL_STATE = 2e-3
TOL_FORCE_RTOL, TOL_FORCE_ATOL = 5e-2, 1.0
TOL_ENV = 2e-3

H100_BYTES_PER_S = 3.35e12      # HBM3, SXM
H100_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
def substep_op_count(model, cfg):
    """f32 operations of one K1 substep for one env, counted from the loop
    trip counts of csrc/substep.cu (a multiply-add is 2; sin, cos, sqrt,
    rsqrt and a division 1 each)."""
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
    return ops


def substep_bytes(kernel):
    """Bytes K1 must move per env: each input read once, each output
    written once (the model table is shared and negligible)."""
    reads = kernel.nstate + kernel.ndyn + kernel.nd + 6
    writes = kernel.nstate + 3 * kernel.nb + 12 * kernel.nf
    return 4 * (reads + writes)


def rand_inputs(model, B, device, seed, standing=False):
    """Random states (the JAX package's _rand_inputs, plus random contact
    materials); `standing` puts the T1-shaped robot on its feet."""
    import numpy as np
    import torch

    from booster_gym_torch.physics import DynParams, SimState

    rng = np.random.default_rng(seed)
    nd, ns = model.num_dofs, len(model.shape_body)
    quat = rng.normal(size=(B, 4))
    quat[: B // 2] = [1, 0, 0, 0]
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    pos = np.zeros((B, 3))
    pos[:, 2] = rng.uniform(0.2, 0.8, B)
    q = rng.uniform(-1, 1, (B, nd))
    qd = rng.uniform(-2, 2, (B, nd))
    if standing:
        pos[:, 2] = 0.72
        quat[:] = [1, 0, 0, 0]
        q = np.array([-0.2, 0, 0, 0.4, -0.25, 0] * 2) + rng.normal(0, 0.05, (B, nd))
        qd = rng.normal(0, 0.2, (B, nd))
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    state = SimState(root_pos=t(pos), root_quat=t(quat),
                     root_lin_vel=t(rng.uniform(-1, 1, (B, 3))),
                     root_ang_vel=t(rng.uniform(-1, 1, (B, 3))), q=t(q), qd=t(qd))
    dyn = DynParams(body_mass=t(np.tile(model.body_mass, (B, 1))),
                    body_com=t(np.tile(model.body_com, (B, 1, 1))),
                    body_inertia=t(np.tile(model.body_inertia, (B, 1, 1, 1))),
                    shape_friction=t(rng.uniform(0.5, 1.5, (B, ns))),
                    shape_restitution=t(rng.uniform(0.0, 0.5, (B, ns))))
    tau = t(rng.uniform(-5, 5, (B, nd)))
    ef = t(rng.uniform(-2, 2, (B, 3)))
    et = t(rng.uniform(-0.5, 0.5, (B, 3)))
    return state, dyn, tau, ef, et


def compare_kernel(name, kernel, plain, model, B, substeps=5):
    """K1 against the plain version for `substeps` substeps; each substep
    starts both from the plain version's state, so the comparison measures
    one substep's error, not chaotic divergence.  Returns max abs error."""
    import torch

    from booster_gym_torch.physics import SimState

    state, dyn, tau, ef, et = rand_inputs(model, B, "cuda", seed=B,
                                          standing=name == "t1" and B % 1024 == 0)
    worst = 0.0
    for i in range(substeps):
        z = torch.zeros_like(ef)
        args = (dyn, tau, ef if i == 0 else z, et if i == 0 else z)
        s_k, f_k, fp_k, fR_k = kernel.step(state, *args)
        s_p, f_p, fp_p, fR_p = plain(state, *args)
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
                ("feet_R", fR_k, fR_p, TOL_STATE, TOL_STATE)):
            err = (a - b).abs()
            worst = max(worst, float(err.max()))
            ok = bool((err <= atol + rtol * b.abs()).all())
            log(f"  {name} B={B} substep {i} {field:12s} max_abs={float(err.max()):.3e} "
                f"tol=rtol {rtol}/atol {atol} {'ok' if ok else 'FAIL'}")
            if not ok:
                fails.append(field)
        if fails:
            raise AssertionError(f"K1 disagrees with its plain version ({name}, B={B}, "
                                 f"substep {i}): {fails}")
        state = s_p
    return worst


def time_cuda(fn, iters):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def to_device(obj, device):
    """Dataclass of tensors (nested) onto `device`."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: to_device(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj)})
    return obj


# ---------------------------------------------------------------------------
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

    from booster_gym_torch.model import load_urdf
    from booster_gym_torch.physics import SimConfig
    from booster_gym_torch.physics import substep_kernel as sk
    from booster_gym_torch.physics.engine import make_substep
    from booster_gym_torch.runner import Runner
    from booster_gym_torch.testing import (
        card_line,
        main_path_cfg,
        toy_model,
        write_t1_shaped_urdf,
    )
    from booster_gym_torch.utils.config import load_task_cfg

    # -- 1. the card -----------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # -- 2. build K1 -----------------------------------------------------
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    urdf = write_t1_shaped_urdf(workdir)
    models = {"toy": toy_model(), "t1": load_urdf(urdf, cylinder_rim_points=4)}
    cfg = SimConfig()
    kernels, plains = {}, {}
    for name, model in models.items():
        feet = [i for i, n in enumerate(model.body_names) if "foot" in n]
        kernels[name] = sk.SubstepKernel(model, cfg, feet, "cuda")
        plains[name] = make_substep(model, cfg, feet, "cuda")
    t0 = time.perf_counter()
    builds = {n: sk.start_build(k.sizes) for n, k in kernels.items()}
    for name, (path, proc, tmp) in builds.items():
        report = sk.finish_build(path, proc, tmp)
        log(f"built K1 for {name}: {os.path.basename(path)}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                log(f"  ptxas: {line.strip()}")
        kernels[name].build()   # loads the library just built
    log(f"K1 build: {time.perf_counter() - t0:.1f} s (set-up)")

    # -- 3. K1 against its plain version -----------------------------------
    max_err = 0.0
    for name in ("toy", "t1"):
        for B in (4096, 1000):
            max_err = max(max_err, compare_kernel(name, kernels[name], plains[name],
                                                  models[name], B))
    log(f"K1 matches its plain version: max abs err {max_err:.3e}")

    # -- 4. main path ----------------------------------------------------
    tcfg = main_path_cfg(urdf)
    horizon, mini_epochs = tcfg["runner"]["horizon_length"], tcfg["runner"]["mini_epochs"]
    if (horizon, mini_epochs) != (24, 20):
        raise AssertionError(f"T1.yaml horizon/mini-epochs are {horizon}/{mini_epochs}")
    os.chdir(workdir)   # run logs and checkpoints go to the scratch directory
    runner = Runner(tcfg, device="cuda")
    runner.env.substep.launches = 0
    records = runner.train()
    torch.cuda.synchronize()
    launches = runner.env.substep.launches
    expect = 3 * horizon * runner.env.decimation
    for rec in records:
        bad = [k for k, v in rec.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite metrics: {bad}")
        log(f"main path [{card}] iter: {rec['iter_ms']:.2f} ms (rollout "
            f"{rec['rollout_ms']:.2f} ms, update {rec['update_ms']:.2f} ms), "
            f"{rec['env_steps_per_sec']:,.0f} env-steps/s, reward {rec['reward']:.4f}, "
            f"value_loss {rec['value_loss']:.4f}, kl {rec['kl_mean']:.5f}")
    per_iter = [int(rec["substep_kernel_launches"]) for rec in records]
    log(f"main path K1 launches: {launches} (expected {expect}), per iteration {per_iter}")
    if launches != expect or per_iter != [horizon * runner.env.decimation] * 3:
        raise AssertionError(f"K1 launched {launches} times on the main path ({per_iter} "
                             f"per iteration), expected {expect}")
    ts = runner.train_state
    if ts.obs.shape != (4096, 47) or ts.privileged_obs.shape != (4096, 14):
        raise AssertionError(f"observation shapes {tuple(ts.obs.shape)}, "
                             f"{tuple(ts.privileged_obs.shape)}")
    if not bool(torch.isfinite(ts.obs).all()):
        raise AssertionError("non-finite observations after training")

    # -- 5. env step on the card against the CPU ---------------------------
    from booster_gym_torch.envs.t1 import T1

    ecfg = load_task_cfg("T1")
    ecfg["env"]["num_envs"] = 256
    ecfg["terrain"]["type"] = "plane"
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
    for label, a, b in (("obs", out_g[1].cpu(), out_c[1]), ("reward", out_g[2].cpu(), out_c[2]),
                        ("privileged", out_g[4]["privileged_obs"].cpu(),
                         out_c[4]["privileged_obs"])):
        err = float((a[keep] - b[keep]).abs().max())
        ok = bool(((a[keep] - b[keep]).abs() <= TOL_ENV + TOL_ENV * b[keep].abs()).all())
        log(f"env step cuda vs cpu ({int(keep.sum())} envs): {label} max_abs={err:.3e} "
            f"tol={TOL_ENV} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"env step on the card disagrees with the CPU: {label}")

    # -- 6. K1 timing ------------------------------------------------------
    B = 4096
    k, plain, model = kernels["t1"], plains["t1"], models["t1"]
    state, dyn, tau, ef, et = rand_inputs(model, B, "cuda", seed=3, standing=True)
    ps, pdyn = k.pack_sim(state), k.pack_dyn(dyn)
    ptau = tau.T.contiguous()
    pext = torch.cat([ef, et], dim=-1).T.contiguous()
    n0 = k.launches
    ms = time_cuda(lambda: k.packed_call(ps, pdyn, ptau, pext), 200)
    plain_ms = time_cuda(lambda: plain(state, dyn, tau, ef, et), 20)
    nbytes = substep_bytes(k) * B
    nops = substep_op_count(model, cfg) * B
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, nops / H100_F32_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"K1 at {B} envs [{card}]: {ms * 1e3:.2f} us/substep; plain version "
        f"{plain_ms * 1e3:.1f} us; bound {bound_ms * 1e3:.2f} us "
        f"({nbytes / 1e6:.2f} MB -> {t_bytes * 1e3:.2f} us, {nops / 1e6:.1f} Mop -> "
        f"{t_ops * 1e3:.2f} us); timing launches {k.launches - n0}")
    line = {"kernels": [{
        "name": "K1 substep (plane)", "route": "cuda",
        "source": "booster_gym_torch/csrc/substep.cu",
        "replaces": "booster_gym_tpu/physics/pallas_engine.py:267",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None}]}
    log(card)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
