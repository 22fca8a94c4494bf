"""Two source trees of the port side by side on the card (a parent commit
unpacked with `git archive` into a git-ignored directory, and this one).

    python booster_gym_torch/compare_trees.py ptxas TREE [-D NAME=VALUE]...
    python booster_gym_torch/compare_trees.py gae TREE OUT
    python booster_gym_torch/compare_trees.py gae-diff OUT_A OUT_B
    python booster_gym_torch/compare_trees.py k3 TREE OUT
    python booster_gym_torch/compare_trees.py k3-diff OUT_A OUT_B
    python booster_gym_torch/compare_trees.py sass TREE OUT
    python booster_gym_torch/compare_trees.py sass-diff OUT_A OUT_B

`ptxas` builds TREE's substep kernel (the T1-shaped robot's sizes, K1 and
K5, each also with every -D given), its update kernels and its sampler,
all nvcc runs at once, and prints ptxas's registers, stack frame and
spills of the control-step, substep, K2, K4 and sampler kernels.  `gae`
runs TREE's K2 at T = 24 (bf16 and f32, B = 4096 and 1000, testing.
update_case's data) and saves its four outputs to OUT, with ms per call
(CUDA events) and the device kernels per call; `gae-diff` says whether two
such files are bitwise equal.  `k3` and `k3-diff` do the same for K3
(grads_stats at T = 24, B = 4096 and 1000, bf16 and f32, at the T1 widths
and at T1Standup's: the gradient, the metric sums, mu and logp), called as
every tree takes it, without n_total.  `sass` builds TREE's K1 (the T1-shaped
robot's sizes, its foot edge points) and its update library at the T1
networks' widths and writes each library's machine code (cuobjdump -sass,
every kernel, bf16 and f32) to OUT; `sass-diff` says whether two such
files hold the same code, library by library and kernel by kernel.  Run as a script, so that
TREE's package, not this one, is imported.  Needs the CUDA toolkit (ptxas,
sass) or a GPU (gae); gae-diff and sass-diff need neither.
"""

import argparse
import os
import sys
import time

T1_SIZES = dict(NB=13, ND=12, NPT=56, NS=7, NF=2)
UPDATE_SIZES = dict(NOBS=47, NPRIV=14, NACT=12, AH1=256, AH2=128, AH3=128, CH1=256, CH2=256,
                    CH3=128)
KERNELS = ("control", "substep_kernel", "k4", "k2_critic", "terrain")
# the update builds that k3 runs: (actions, observations, privileged
# observations) of T1 (61-wide critic) and of T1Standup (420 / 434 wide)
K3_WIDTHS = {"t1": (12, 47, 14), "standup": (12, 420, 14)}


def use_tree(tree):
    """Import the package from TREE from here on."""
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    return root


def ptxas(tree, defines):
    use_tree(tree)
    from booster_gym_torch import kernel_build as kb

    # a tree whose substep wrapper takes the foot edge points builds with NE
    src = open(os.path.join(os.path.abspath(tree), "booster_gym_torch", "physics",
                            "substep_kernel.py")).read()
    base = dict(T1_SIZES, **({"NE": 4} if "feet_edge_pos" in src else {}))
    jobs = {}
    for plane in (1, 0):
        name = "K1" if plane else "K5"
        jobs[name] = kb.start_build("substep.cu", dict(base, PLANE=plane, EPB=8))
        for d in defines:
            k, v = d.split("=")
            jobs[f"{name} -D{d}"] = kb.start_build("substep.cu",
                                                   dict(base, PLANE=plane, EPB=8, **{k: int(v)}))
    jobs["update"] = kb.start_build("update.cu", UPDATE_SIZES)
    jobs["sampler"] = kb.start_build("terrain_sample.cu", {})
    t0 = time.time()
    for name, job in jobs.items():
        lines = kb.finish_build(*job).splitlines()
        print(f"== {tree} {name} ({time.time() - t0:.1f} s)")
        for i, line in enumerate(lines):
            if "registers" in line and i >= 2:
                fn = lines[i - 2].split(" for ")[-1].strip()
                if any(k in fn for k in KERNELS):
                    print("  ", fn[:70], "|", lines[i - 1].strip(), "|",
                          line.strip().replace("ptxas info    : ", ""))


def gae(tree, out):
    use_tree(tree)
    import torch

    from booster_gym_torch import testing
    from booster_gym_torch.testing import update_case

    res = {}
    for dtype in ("bf16", "f32"):
        for B in (4096, 1000):
            fused, p, staged, prep, d = update_case(dtype, 24, B, "cuda", seed=B)
            rew, done, timeout = d["buf"][5:]
            args = (staged, prep["obsc"], rew, 1.0 - (done | timeout).float(),
                    timeout.float(), 0.995, 0.95)
            outputs = fused.gae(*args)
            torch.cuda.synchronize()
            res[f"{dtype}_{B}"] = [t.cpu() for t in outputs]
            ms, _ = testing.time_cuda(lambda: fused.gae(*args), 50)
            kernels = (testing.device_kernels(lambda: fused.gae(*args))
                       if hasattr(testing, "device_kernels") else None)
            print(tree, dtype, B, f"ms/call {ms:.4f}", "kernels", kernels, flush=True)
    torch.save(res, out)


def k3(tree, out):
    use_tree(tree)
    import torch

    from booster_gym_torch import testing
    from booster_gym_torch.testing import update_case

    res = {}
    for widths, dims in K3_WIDTHS.items():
        for dtype in ("bf16", "f32"):
            for B in (4096, 1000):
                fused, p, staged, prep, d = update_case(dtype, 24, B, "cuda", seed=B, dims=dims)
                adv = d["adv"]
                args = (staged, p, prep, adv, d["ret"], adv.mean(), 1.0 / (adv.std() + 1e-8),
                        False)
                g, st, mu, logp = fused.grads_stats(*args)
                torch.cuda.synchronize()
                res[f"{widths}_{dtype}_{B}"] = [t.cpu() for t in (g, *st.values(), mu, logp)]
                ms, _ = testing.time_cuda(lambda: fused.grads_stats(*args), 20)
                print(tree, widths, dtype, B, f"ms/call {ms:.4f}", flush=True)
    torch.save(res, out)


def outputs_diff(label, names, a, b):
    import torch

    a, b = torch.load(a), torch.load(b)
    for k in a:
        same = [torch.equal(x, y) for x, y in zip(a[k], b[k])]
        print(label, k, f"bitwise equal ({names}):", same)


def sass(tree, out):
    import json
    import subprocess

    use_tree(tree)
    from booster_gym_torch import kernel_build as kb

    # K1 at the tree's own launch shape (no EPB: the source's default, or
    # its pick from the sizes)
    jobs = {"K1": kb.start_build("substep.cu", dict(T1_SIZES, NE=4, PLANE=1)),
            "update": kb.start_build("update.cu", UPDATE_SIZES)}
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    res = {}
    for name, job in jobs.items():
        kb.finish_build(*job)
        text = subprocess.run([cuobjdump, "-sass", job[0]], capture_output=True, text=True,
                              check=True).stdout
        # the machine code only: the header names the library's file
        res[name] = [line for line in text.splitlines() if line.strip().startswith(("/*", "."))
                     or "Function" in line]
        print(f"{tree} {name}: {os.path.basename(job[0])}, {len(res[name])} lines of SASS")
    with open(out, "w") as f:
        json.dump(res, f)


def sass_diff(a, b):
    import json

    a, b = json.load(open(a)), json.load(open(b))
    for name in a:
        print(f"{name}: the same machine code: {a[name] == b.get(name)} ({len(a[name])} and "
              f"{len(b.get(name, []))} lines)")
        fa, fb = _functions(a[name]), _functions(b.get(name, []))
        differ = sorted(f for f in set(fa) | set(fb) if fa.get(f) != fb.get(f))
        print(f"  {len(fa)} and {len(fb)} kernels; those whose code differs: {differ}")


def _functions(lines):
    """{kernel name: its lines} of a library's SASS listing."""
    out, name = {}, None
    for line in lines:
        if "Function" in line:
            name = line.split(":", 1)[-1].strip()
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("ptxas")
    p.add_argument("tree")
    p.add_argument("-D", dest="defines", action="append", default=[])
    p = sub.add_parser("gae")
    p.add_argument("tree")
    p.add_argument("out")
    p = sub.add_parser("gae-diff")
    p.add_argument("a")
    p.add_argument("b")
    p = sub.add_parser("k3")
    p.add_argument("tree")
    p.add_argument("out")
    p = sub.add_parser("k3-diff")
    p.add_argument("a")
    p.add_argument("b")
    p = sub.add_parser("sass")
    p.add_argument("tree")
    p.add_argument("out")
    p = sub.add_parser("sass-diff")
    p.add_argument("a")
    p.add_argument("b")
    args = parser.parse_args(argv)
    if args.cmd == "ptxas":
        ptxas(args.tree, args.defines)
    elif args.cmd == "gae":
        gae(args.tree, args.out)
    elif args.cmd == "sass":
        sass(args.tree, args.out)
    elif args.cmd == "sass-diff":
        sass_diff(args.a, args.b)
    elif args.cmd == "k3":
        k3(args.tree, args.out)
    elif args.cmd == "k3-diff":
        outputs_diff("K3", "g, vl, al, bhi, blo, klsq, mu, logp", args.a, args.b)
    else:
        outputs_diff("K2", "adv, ret, sum, sum^2", args.a, args.b)


if __name__ == "__main__":
    main()
