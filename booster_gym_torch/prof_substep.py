"""Where the substep kernel's time goes on the card (K1, or K5 with
--terrain trimesh), on the T1-shaped robot.

    python -m booster_gym_torch.prof_substep [--terrain plane|trimesh]
        [--variant NAME:KEY=VALUE,...]... [--batches 132,528,1584,3168,4096]

Builds the default kernel, a -DPHASE_CLOCKS=1 build of it and every
--variant (extra -D sizes, e.g. EPB=4,MINB=6), all nvcc runs at once, and
prints ptxas's registers and stack frames, shared memory per block and
resident blocks per SM of each.  Then, with CUDA events, one control step
(10 substeps) per launch at 4096 envs for each build; the cycles each warp
spends in each phase of a substep (the clocks build, 4096 envs); and the
default build at each batch size of --batches: at 132 envs each SM holds one
warp, so that time is a warp's own chain.  The inputs are
testing.control_inputs' (the env's gains, standing robots); the kernel is
the env's, with T1.yaml's foot edge points and, on trimesh, the epilogue
sampling T1.yaml's field.  The last line is one JSON object with the
numbers.  Needs a GPU.
"""

import argparse
import ctypes
import json
import tempfile

import torch

PHASES = ("FK", "inertias and CRBA", "Cholesky", "L^-1", "G", "RNEA", "Lambda",
          "points", "wrench and du", "body velocities", "sweep points", "integrate")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--terrain", choices=("plane", "trimesh"), default="plane")
    parser.add_argument("--variant", action="append", default=[])
    parser.add_argument("--batches", default="132,528,1584,3168,4096")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("prof_substep needs a CUDA card")

    from booster_gym_torch import kernel_build
    from booster_gym_torch.model import load_urdf
    from booster_gym_torch.physics import SimConfig
    from booster_gym_torch.physics import substep_kernel as sk
    from booster_gym_torch.terrain import Terrain
    from booster_gym_torch.testing import card_line, control_inputs, time_cuda, write_t1_shaped_urdf
    from booster_gym_torch.utils.config import load_task_cfg

    card = card_line()
    model = load_urdf(write_t1_shaped_urdf(tempfile.mkdtemp()), cylinder_rim_points=4)
    feet = [i for i, n in enumerate(model.body_names) if "foot" in n]
    plane = args.terrain == "plane"
    t1_cfg = load_task_cfg("T1")
    terrain = None if plane else Terrain(t1_cfg["terrain"], seed=0, device="cuda")
    edges = t1_cfg["asset"]["feet_edge_pos"]

    def path_args(k, B):
        """control_step's inputs as the env's path has them: on trimesh the
        field too, whose terrain the epilogue samples."""
        cargs = control_inputs(k, model, B, "cuda", seed=5, terrain=terrain)
        return cargs if plane else cargs + [terrain.height_field]

    variants = {"default": {}, "clocks": {"PHASE_CLOCKS": 1}}
    for spec in args.variant:
        name, _, rest = spec.partition(":")
        variants[name] = {k: int(v) for k, v in (a.split("=") for a in rest.split(",") if a)}
    kernels = {}
    for name, extra in variants.items():
        k = sk.SubstepKernel(model, SimConfig(), feet, "cuda", plane=plane, feet_edge_pos=edges,
                             terrain=terrain)
        k.sizes.update(extra)
        kernels[name] = k
    builds = {n: kernel_build.start_build(sk.SOURCE, k.sizes) for n, k in kernels.items()}
    out = {"card": card, "terrain": args.terrain, "builds": {}}
    for name, build in builds.items():
        report = kernel_build.finish_build(*build)
        ptxas = [line.strip() for line in report.splitlines()
                 if "stack frame" in line or "registers" in line]
        k = kernels[name]
        k.build()
        info = k.info()
        B = 4096
        cargs = path_args(k, B)
        ms, _ = time_cuda(lambda: k.control_step(*cargs), 20)
        out["builds"][name] = {"sizes": k.sizes, "ptxas": ptxas, **info, "control_step_ms": ms}
        print(f"{name} [{card}]: {ms * 1e3:.1f} us per control step at {B} envs "
              f"({ms * 1e2:.1f} us per substep); {info}; ptxas {ptxas}", flush=True)

    # cycles per phase, summed over warps by the clocks build
    k = kernels["clocks"]
    lib = ctypes.CDLL(kernel_build.library_path(sk.SOURCE, k.sizes))
    clocks = (ctypes.c_ulonglong * len(PHASES))()
    read = lambda: lib.bg_substep_clocks(ctypes.cast(clocks, ctypes.c_void_p))
    cargs = path_args(k, 4096)
    read()
    k.control_step(*cargs)
    torch.cuda.synchronize()
    if read() != 0:
        raise RuntimeError("reading the phase clocks failed")
    per = {p: clocks[i] / (4096 * 10) for i, p in enumerate(PHASES)}
    out["cycles_per_warp_substep"] = per
    print("cycles per warp and substep, 4096 envs: "
          + ", ".join(f"{p} {v:.0f}" for p, v in per.items()) + f"; total {sum(per.values()):.0f}")

    # the default build over batch sizes
    k = kernels["default"]
    out["batches"] = {}
    for B in (int(b) for b in args.batches.split(",")):
        cargs = path_args(k, B)
        ms, _ = time_cuda(lambda: k.control_step(*cargs), 10)
        out["batches"][B] = ms
        print(f"B={B}: {ms * 1e3:.1f} us per control step ({ms * 1e2:.1f} us per substep)",
              flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
