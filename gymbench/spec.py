"""Finds a cell's parts by name: BENCHMARK.json at the checkout's root,
configs/<config>.json, traffic/<traffic>.json, limits/<workload>.json and
metrics/<metric>.py beside this file."""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# keys of a configuration file that describe it rather than configure the
# task
CONFIG_META = ("source", "reduced", "assumed")


def _json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(bench, name):
    """The `workloads` entry called `name`; KeyError names the known ones."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    known = ", ".join(w["name"] for w in bench["workloads"])
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")


def config(name):
    """(the task config as it is run, the file's description keys)."""
    raw = _json(os.path.join(HERE, "configs", f"{name}.json"))
    cfg = {k: v for k, v in raw.items() if k not in CONFIG_META}
    return cfg, {k: raw[k] for k in CONFIG_META if k in raw}


def traffic(name):
    return _json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(workload_name):
    """{compared number: its limit} of a workload."""
    return _json(os.path.join(HERE, "limits", f"{workload_name}.json"))["limits"]


def metrics_of(bench, workload_name, kind):
    """The names of the `kind` ("end_to_end" or "per_layer") metrics that
    a cell reports: those that list it, and those with no list."""
    return [m["name"] for m in bench[kind]
            if workload_name in m.get("workloads", [workload_name])]


def metric_reader(name):
    """metrics/<name>.py's read(run) function."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"gymbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
