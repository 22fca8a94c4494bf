"""Times the update kernels at the training shape (the port of
tools/prof_update.py).

    python -m booster_gym_torch.prof_update [--T 24] [--B 4096] [--dtype bf16]
        [--task T1] [--iters 50] [--trace DIR] [--device cuda]
        [--variant NAME:KEY=VALUE,...]... [--variant-of K3] [--split]

Makes the reference tool's data from a seed (the observation, privileged
and action dims of --task's config: T1's 47, 14 and 12; T1Standup's 420,
14 and 12; T1Serial's 80, 14 and 23; the ActorCritic's widths, weights
drawn from the seed) and times values (K8), grads (K9) and policy_old_logp (K10), then
gae (K2), grads_stats (K3) and opt_stage (K4) at the same shape: 3 warm-up
calls, then --iters calls between two CUDA events.  Prints one JSON line per
kernel: ms per call, the launches its wrapper counted, the bound (the larger
of its bytes at 3.35 TB/s and its operations at the H100's peak for the
compute type, counted from the shapes by update_work) and the card's name
and power limit.  --trace DIR writes a torch.profiler trace of five grads
calls to DIR/grads_trace.json.  Each --variant builds csrc/update.cu again
with extra -D sizes (all nvcc runs at once) and times the kernels that
--variant-of names (default K3) in that build on the same data: one more
record each, "variant" naming it, with the device time and the device
kernels per call under torch.profiler (a variant with no -D sizes, e.g.
`--variant default:`, gives the default build's beside them).
--split adds a record of K2 part by part (k2_split): CUDA events between its
device kernels, and each kernel's device time and count under
torch.profiler, with its phase clocks (k2_clocks), and one of K3's pass-1
phase clocks (k3_clocks).

It runs on the card unless --device cpu is given, and raises without CUDA.
On the CPU the wrappers run their plain versions, launch nothing, and the
times are the host's clock ("host_ms", not a device time).

Two parts of the reference tool are attribution experiments of the TPU's
compiler and are not ported: the ELU -> identity patch and the Pallas tile
sweep.
"""

import argparse
import json
import os
import time

import torch

from booster_gym_torch import testing

GAMMA, LAM = 0.995, 0.95
WARMUP = 3
# method, the kernel's name in the port's table
KERNELS = (("values", "K8"), ("grads", "K9"), ("policy_old_logp", "K10"),
           ("gae", "K2"), ("grads_stats", "K3"), ("opt_stage", "K4"))
LAUNCHES = {"values": "values_launches", "grads": "grads_launches",
            "policy_old_logp": "policy_logp_launches", "gae": "gae_launches",
            "grads_stats": "grads_stats_launches", "opt_stage": "opt_stage_launches"}


def update_work(fused, T, B):
    """{method: (bytes, operations)} of one call at [T, B]: each input read
    once, each output written once; a multiply-add is 2 operations."""
    n, rows = T * B, (T + 1) * B
    ct = 2 if fused.bf16 else 4
    macs = {net: [o * i for _, _, o, i in fused.layers[net]] for net in ("actor", "critic")}
    n_net = {net: sum(o * i + o for _, _, o, i in fused.layers[net]) for net in macs}
    na, nc, no = fused.num_act, fused.num_crit, fused.num_obs
    # forward, weight gradient, and input gradient of every layer but the first
    grad_ops = n * 2 * sum(3 * sum(m) - m[0] for m in macs.values())
    # obsc, act, staged weights, logstd (adv, ret and old_logp come on top)
    grad_in = n * nc * ct + n * na * 4 + fused.n_params * ct + na * 4
    return {
        "gae": (rows * nc * ct + 3 * n * 4 + n_net["critic"] * ct + 2 * n * 4 + 8,
                rows * 2 * sum(macs["critic"])),
        "grads_stats": (grad_in + 3 * n * 4 + n * na * 4 + 8 + fused.n_params * 4
                        + (4 + na) * 4 + n * na * 4 + n * 4, grad_ops),
        "opt_stage": (fused.n_params * (4 * 4 + 3 * 4 + ct) + 4, fused.n_params * 20),
        "values": (n * nc * ct + n_net["critic"] * ct + n * 4, n * 2 * sum(macs["critic"])),
        "grads": (grad_in + 3 * n * 4 + fused.n_params * 4 + n * na * ct + n * ct, grad_ops),
        "policy_old_logp": (n * no * ct + n * na * 4 + n_net["actor"] * ct + na * 4
                            + n * na * 4 + n * 4, n * 2 * sum(macs["actor"])),
    }


def bound(fused, method, nbytes, nops):
    """(bound_ms, "bytes" or "operations") on an H100 at its published peaks."""
    bf16_products = fused.bf16 and method != "opt_stage"
    return testing.bound(nbytes, nops, testing.H100_BF16_OPS_PER_S if bf16_products
                         else testing.H100_F32_OPS_PER_S)


def make_data(T, B, compute_dtype, device, seed=0, dims=testing.T1_DIMS):
    """The reference tool's make_data, drawn with a torch.Generator on the
    CPU and moved to `device`: (network, d) with d's obs, priv, act, adv,
    ret, old_logp and the policy's mu0, plus the post-rollout observation,
    rewards, nonterm and timeout_f that gae takes.  dims: (actions,
    observations, privileged observations)."""
    from booster_gym_torch.algo.networks import ActorCritic, normal_log_prob

    NA, NO, NP = dims
    gen = torch.Generator().manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=gen).to(device)
    net = ActorCritic(NA, NO, NP, compute_dtype=compute_dtype)
    net.reset_parameters(gen)
    net = net.to(device)
    obs, priv, act = randn(T, B, NO), randn(T, B, NP), 0.1 * randn(T, B, NA)
    adv, ret = randn(T, B), randn(T, B)
    with torch.no_grad():
        mu0, std0 = net.act(obs)
    d = dict(obs=obs, priv=priv, act=act, adv=adv, ret=ret, mu0=mu0,
             old_logp=normal_log_prob(mu0, std0, act), obs_last=randn(B, NO),
             priv_last=randn(B, NP), rew=randn(T, B))
    done = torch.rand((T, B), generator=gen).to(device) < 0.05
    timeout = torch.rand((T, B), generator=gen).to(device) < 0.05
    d["nonterm"], d["timeout_f"] = 1.0 - (done | timeout).float(), timeout.float()
    return net, d


def _calls(fused, d):
    """method -> a no-argument call of it on the data."""
    p = d["p"]
    staged = fused.stage(p)
    prep = fused.prepare(d["obs"], d["priv"], d["act"], d["mu0"], d["old_logp"], d["obs_last"],
                         d["priv_last"])
    mean, rstd = d["adv"].mean(), 1.0 / (d["adv"].std() + 1e-8)
    g = 1e-3 * torch.ones_like(p)
    m, v, lr = torch.zeros_like(p), torch.zeros_like(p), torch.tensor(1e-3, device=p.device)
    return {
        "values": lambda: fused.values(p, d["obs"], d["priv"]),
        "grads": lambda: fused.grads(p, d["obs"], d["priv"], d["act"], d["adv"], d["ret"],
                                     d["old_logp"]),
        "policy_old_logp": lambda: fused.policy_old_logp(p, prep),
        "gae": lambda: fused.gae(staged, prep["obsc"], d["rew"], d["nonterm"], d["timeout_f"],
                                 GAMMA, LAM),
        "grads_stats": lambda: fused.grads_stats(staged, p, prep, d["adv"], d["ret"], mean, rstd,
                                                 False),
        "opt_stage": lambda: fused.opt_stage(g, p, m, v, 0, lr, entropy_coef=-0.01, b1=0.9,
                                             b2=0.999, eps=1e-8, max_norm=1.0),
    }


def k2_split(fused, d, reps=20):
    """K2 at the data's shape, part by part: the CUDA-event time of each of
    its device kernels (K2_PARTS) within whole calls (events recorded
    between them), and each kernel's device time and count per call under
    torch.profiler.  On the card only."""
    from booster_gym_torch.algo.update_kernel import K2_KERNELS, K2_PARTS

    staged = fused.stage(d["p"])
    obsc = fused.prepare(d["obs"], d["priv"], d["act"], d["mu0"], d["old_logp"], d["obs_last"],
                         d["priv_last"])["obsc"]
    args = (staged, obsc, d["rew"], d["nonterm"], d["timeout_f"], GAMMA, LAM)
    fused.gae(*args)
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(len(K2_PARTS) + 1)]
             for _ in range(reps)]
    for ev in marks:
        for e in ev:
            e.record()    # creates the event, which the kernel library then records
    torch.cuda.synchronize()
    for ev in marks:
        fused.gae_timed(*args, ev)
    torch.cuda.synchronize()
    parts = {p: sum(ev[i].elapsed_time(ev[i + 1]) for ev in marks) / reps
             for i, p in enumerate(K2_PARTS)}
    dev, count = testing.device_ms(lambda: fused.gae(*args), K2_KERNELS)
    return {"parts_ms": parts, "device_ms": dev, "device_kernels": sum(count.values()),
            "count": count}


# the tile before's last layer (and the walk), each hidden layer and the
# wait for its outputs (a block barrier, then the mbarrier), the next x0 tile
K2_PHASES = ("layer4", "layer1", "wait1", "layer2", "wait2", "layer3", "x0", "wait3")


def k2_clocks(net, d, calls=5):
    """Cycles per warp and tile of each phase of K2's critic kernel
    (K2_PHASES), from a -DK2_CLOCKS=1 build of csrc/update.cu: lane 0 of
    every warp adds clock64() deltas per phase, bg_k2_clocks reads them.
    On the card only."""
    import ctypes

    from booster_gym_torch import kernel_build
    from booster_gym_torch.algo.update_kernel import SOURCE, FusedUpdate

    v = FusedUpdate(net, clip_ratio=0.2, bound_coef=10.0)
    v.sizes["K2_CLOCKS"] = 1
    v.build()
    lib = ctypes.CDLL(kernel_build.library_path(SOURCE, v.sizes))
    clocks = (ctypes.c_ulonglong * len(K2_PHASES))()
    read = lambda: lib.bg_k2_clocks(ctypes.cast(clocks, ctypes.c_void_p))
    gae = _calls(v, d)["gae"]
    gae()
    torch.cuda.synchronize()
    read()
    for _ in range(calls):
        gae()
    torch.cuda.synchronize()
    if read() != 0:
        raise RuntimeError("reading K2's phase clocks failed")
    info = v.info(d["p"].device)
    T, B = d["rew"].shape
    groups = -(-B // info["k2_tile"])
    warps = calls * groups * info["k2_cluster"] * info["k2_threads"] // 32 * (T + 1)
    return {p: clocks[i] / warps for i, p in enumerate(K2_PHASES)}


# The tile block's phases (K3's pass 1): a consumer warp's products (mma.sync
# and ldmatrix), its waits on a full stage of the weight ring, its group's
# barriers, the epilogues, the loss steps, the scratch stores (issue and the
# wait for their reads) and the x0 rows; then the producer warp's waits on an
# empty stage and its copies
K3_PHASES = ("products", "full_wait", "group_bar", "epilogue", "loss", "stores", "x0")
K3_PRODUCER = ("empty_wait", "copies")
CONSUMER_WARPS = 16   # a tile block's consumer warps (csrc/update.cu: NG x NWG)


def k3_clocks(net, d, calls=5):
    """Cycles per phase of K3's pass 1 from a -DK3_CLOCKS=1 build of
    csrc/update.cu: per consumer warp and tile (K3_PHASES; a tile's 16
    consumer warps each add theirs) and per tile for the producer warp
    (K3_PRODUCER).  On the card only."""
    import ctypes

    from booster_gym_torch import kernel_build
    from booster_gym_torch.algo.update_kernel import SOURCE, FusedUpdate

    v = FusedUpdate(net, clip_ratio=0.2, bound_coef=10.0)
    v.sizes["K3_CLOCKS"] = 1
    v.build()
    lib = ctypes.CDLL(kernel_build.library_path(SOURCE, v.sizes))
    names = K3_PHASES + K3_PRODUCER
    clocks = (ctypes.c_ulonglong * len(names))()
    read = lambda: lib.bg_k3_clocks(ctypes.cast(clocks, ctypes.c_void_p))
    grads_stats = _calls(v, d)["grads_stats"]
    grads_stats()
    torch.cuda.synchronize()
    read()
    for _ in range(calls):
        grads_stats()
    torch.cuda.synchronize()
    if read() != 0:
        raise RuntimeError("reading K3's phase clocks failed")
    tiles = calls * -(-d["adv"].numel() // v.info(d["p"].device)["tile"])
    out = {p: clocks[i] / (tiles * CONSUMER_WARPS) for i, p in enumerate(K3_PHASES)}
    out.update({p: clocks[len(K3_PHASES) + i] / tiles for i, p in enumerate(K3_PRODUCER)})
    return out


def _time(fn, iters, cuda):
    """ms per call after WARMUP calls: CUDA events on the card, the host
    clock on the CPU; returns (ms, the last call's outputs)."""
    if cuda:
        return testing.time_cuda(fn, iters, WARMUP)
    for _ in range(WARMUP):
        out = fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / iters, out


def _finite(out):
    if isinstance(out, dict):
        return all(_finite(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return all(_finite(v) for v in out)
    return bool(torch.isfinite(out.float()).all())


def spec_of(sizes, base):
    """The -D sizes of a variant build beyond the default build's."""
    return {k: v for k, v in sizes.items() if base.get(k) != v}


def main(argv=None):
    """Returns the printed records, one per kernel."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--T", type=int, default=24)
    parser.add_argument("--B", type=int, default=4096)
    parser.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    parser.add_argument("--task", default="T1",
                        help="the task config whose network widths to time")
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--trace", default=None)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--variant", action="append", default=[])
    parser.add_argument("--variant-of", default="K3",
                        help="the kernels each --variant build times, e.g. K2,K8")
    parser.add_argument("--split", action="store_true",
                        help="also time K2 part by part (k2_split) and read its phase clocks "
                             "(k2_clocks) and K3's pass-1 phase clocks (k3_clocks), on the card")
    args = parser.parse_args(argv)

    from booster_gym_torch import kernel_build
    from booster_gym_torch.algo.ppo import flat_params
    from booster_gym_torch.algo.update_kernel import SOURCE, FusedUpdate
    from booster_gym_torch.runner import resolve_device

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    card = testing.card_line() if cuda else "cpu"
    net, d = make_data(args.T, args.B, args.dtype, device, dims=testing.task_dims(args.task))
    fused = FusedUpdate(net, clip_ratio=0.2, bound_coef=10.0)
    d["p"] = flat_params(net)
    calls = _calls(fused, d)
    work = update_work(fused, args.T, args.B)
    if args.variant and not cuda:
        raise ValueError("--variant builds CUDA kernels: it needs the card")
    variants = {}
    for spec in args.variant:
        name, _, rest = spec.partition(":")
        v = FusedUpdate(net, clip_ratio=0.2, bound_coef=10.0)
        v.sizes.update({k: int(x) for k, x in (a.split("=") for a in rest.split(",") if a)})
        variants[name] = (v, kernel_build.start_build(SOURCE, v.sizes))
    records = []
    for method, kernel in KERNELS:
        ms, out = _time(calls[method], args.iters, cuda)
        if not _finite(out):
            raise FloatingPointError(f"{method} gave non-finite values")
        bound_ms, bound_by = bound(fused, method, *work[method])
        rec = {"kernel": kernel, "method": method, "T": args.T, "B": args.B,
               "dtype": args.dtype, "task": args.task, "n_params": fused.n_params,
               "device": str(device), "card": card,
               "ms" if cuda else "host_ms": ms, "calls": WARMUP + args.iters,
               "launches": getattr(fused, LAUNCHES[method]), "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": work[method][0], "operations": work[method][1]}
        print(json.dumps(rec), flush=True)
        records.append(rec)

    if args.split:
        if not cuda:
            raise ValueError("--split times device kernels: it needs the card")
        rec = {"kernel": "K2", "split": k2_split(fused, d), "T": args.T, "B": args.B,
               "dtype": args.dtype, "card": card,
               "cycles_per_warp_tile": k2_clocks(net, d)}
        print(json.dumps(rec), flush=True)
        records.append(rec)
        rec = {"kernel": "K3", "pass": 1, "T": args.T, "B": args.B, "dtype": args.dtype,
               "task": args.task, "card": card, "cycles_per_warp_tile": k3_clocks(net, d)}
        print(json.dumps(rec), flush=True)
        records.append(rec)

    methods = {kernel: method for method, kernel in KERNELS}
    for name, (v, build) in variants.items():
        kernel_build.finish_build(*build)
        for kernel in args.variant_of.split(","):
            method = methods[kernel]
            ms, _ = _time(_calls(v, d)[method], args.iters, cuda)
            kernels = testing.device_kernels(_calls(v, d)[method])
            rec = {"kernel": kernel, "variant": name, "defines": spec_of(v.sizes, fused.sizes),
                   "method": method, "T": args.T, "B": args.B, "dtype": args.dtype,
                   "device": str(device), "card": card, "ms" if cuda else "host_ms": ms,
                   "calls": WARMUP + args.iters, "launches": getattr(v, LAUNCHES[method]),
                   "blocks_per_sm_pass1": v.info(device)["blocks_per_sm_pass1"],
                   "device_ms": sum(testing.per_call(n) * t for n, t in kernels.values()),
                   "device_kernels": sum(n for n, _ in kernels.values())}
            print(json.dumps(rec), flush=True)
            records.append(rec)

    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        calls["grads"]()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(5):
                calls["grads"]()
            if cuda:
                torch.cuda.synchronize()
        path = os.path.join(args.trace, "grads_trace.json")
        prof.export_chrome_trace(path)
        print(f"trace written: {path}", flush=True)
    return records


if __name__ == "__main__":
    main()
