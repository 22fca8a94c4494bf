"""One run of one cell of BENCHMARK.json.

    python3 -m gymbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Prints, as the last line of standard output,
one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
device, with --trace 1 breakdown, and last `compared`, each compared
number beside its limit (also the last lines of standard error).  Exits
2, printing no result, without a CUDA card or with fewer cards than the
cell asks for; 3 when a module of JAX or of the JAX package is loaded once
the window has closed.  The build of the program's kernels stays in the
checkout (booster_gym_torch/kernel_build.py: build/kernels/), so only a
checkout's first run compiles.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

from gymbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "booster_gym_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", required=True, type=int, choices=(0, 1))
    return p.parse_args(argv)


def device_info(chips, peak):
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": peak}


def judge(numbers, limits):
    """(correct, {name: {value, limit}}): every number at or under its
    limit; a number missing or not finite reads null and fails."""
    finite = lambda v: isinstance(v, (int, float)) and math.isfinite(v)
    compared = {k: {"value": v if finite(v) else None, "limit": limits[k]}
                for k, v in ((k, numbers.get(k)) for k in limits)}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in compared.values())
    return ok, compared


def main(argv=None):
    args = parse(argv)
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    cfg, _ = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gymbench: cell {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2

    from gymbench import cells

    run_cell = {"train": cells.train_run}[traffic["kind"]]
    # the program seeds numpy too, which takes 0 <= seed < 2**32
    result = run_cell(cell, cfg, traffic, args.seed % 2 ** 32, args.seconds, bool(args.trace),
                      T_START)
    found = forbidden_modules()
    if found:
        print(f"gymbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3

    correct, compared = judge(result.pop("numbers"), limits)
    metrics = result.pop("metrics")
    wanted = spec.metrics_of(bench, cell["name"], "per_layer" if args.trace else "end_to_end")
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    line = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
            "metrics": {k: {"value": metrics[k], "unit": units[k]}
                        for k in wanted if metrics.get(k) is not None},
            "device": device_info(cell["chips"], result["memory_peak_bytes"])}
    if args.trace:
        line["device"].update(busy_s=result["busy_s"], window_s=result["window_s"])
        line["breakdown"] = result["breakdown"]
    line["compared"] = compared
    for name, c in compared.items():
        print(f"compared {name}: {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
