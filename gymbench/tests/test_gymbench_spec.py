"""BENCHMARK.json against the benchmark's contract, and every part of a
cell found by its name."""

import json
import os
import re

from gymbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _bench():
    return spec.benchmark()


def test_top_level_keys_and_limits():
    b = _bench()
    assert set(b) == KEYS
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert b["command"] == ["python3", "-m", "gymbench.run"] and b["paths"] == ["gymbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    # the full check of 24 cells fits its 43200 s
    n = 24
    assert (2 + 14 * n) * (b["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    b = _bench()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]] + [c["name"] for c in b["configs"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in b["end_to_end"] + b["per_layer"])) == \
        len(b["end_to_end"]) + len(b["per_layer"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gymbench/") and os.path.exists(
            os.path.join(spec.ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_finds_its_parts():
    b = _bench()
    for w in b["workloads"]:
        cfg, meta = spec.config(w["config"])
        assert {"env", "runner", "algorithm", "terrain"} <= set(cfg)
        assert meta["source"].startswith("https://")
        traffic = spec.traffic(w["traffic"])
        assert traffic["kind"] == "train"
        assert spec.limits(w["name"])
        e2e = spec.metrics_of(b, w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = spec.metrics_of(b, w["name"], "per_layer")
        assert layers
        for name in layers:
            assert callable(spec.metric_reader(name))
            moves = next(m["moves"] for m in b["per_layer"] if m["name"] == name)
            assert moves in e2e


def test_config_keeps_the_shipped_task_but_the_asset():
    """Each configuration is the port's task file with only the keys that
    `reduced` names changed."""
    import yaml

    b = _bench()
    for c in b["configs"]:
        cfg, meta = spec.config(c["name"])
        task = cfg["basic"]["task"]
        path = os.path.join(spec.ROOT, "booster_gym_torch", "envs", "configs", f"{task}.yaml")
        with open(path) as f:
            shipped = yaml.safe_load(f)
        changed = {k for k in shipped if shipped[k] != cfg.get(k)}
        assert changed == set(c["reduced"]) == set(meta["reduced"])


def test_metric_readers_find_nothing_in_an_empty_run():
    from gymbench.cells import Run
    from gymbench.counts import substep, update

    b = _bench()
    cfg, _ = spec.config("t1_shaped")
    robot = substep.Robot(13, 12, 56, 7, 2, 4, 4, __import__("numpy").zeros((13, 12)))
    run = Run(b["workloads"][0], cfg, spec.traffic("train_plane_16384"), robot, update.nets(cfg))
    for m in b["per_layer"]:
        assert spec.metric_reader(m["name"])(run) is None


def test_limits_files_hold_their_readings():
    for name in [w["name"] for w in _bench()["workloads"]]:
        with open(os.path.join(spec.HERE, "limits", f"{name}.json")) as f:
            d = json.load(f)
        assert set(d) == {"limits", "readings"}
        assert all(isinstance(v, (int, float)) for v in d["limits"].values())
