"""The last line of a run: its keys, the compared numbers last, the
per-layer metrics with --trace 1, and no line without a card."""

import json

import torch

from gymbench import cells, run


def _fake_cell(result):
    def fake(cell, cfg, traffic, seed, seconds, traced, t_start):
        out = dict(result)
        if traced:
            out.update(metrics={"rollout_ms.train": 300.0, "update_ms.train": 140.0},
                       busy_s=0.3, window_s=0.9,
                       breakdown={"device_ops": [["k3_pass1", 0.1]], "idle_gaps": []})
        return out
    return fake


def _card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")


RESULT = {"attempted": 61, "failed": 0, "memory_peak_bytes": 5 * 2 ** 30,
          "metrics": {"env_steps_per_s": 9.1e5, "setup_s": 25.0},
          "numbers": {"field_gap": 0.0, "step_gap": 1e-6, "step_share": 0.0, "done_share": 0.0, "reset_gap": 0.0,
                      "loss_gap": 1e-4, "grad_gap": 1e-3,
                      "change_gap": 1e-3}}


def test_line_keys_trace_0(monkeypatch, capsys):
    _card(monkeypatch)
    monkeypatch.setattr(cells, "train_run", _fake_cell(RESULT))
    assert run.main(["--workload", "t1_shaped_flat_train", "--seed", "2147483700", "--seconds", "1",
                     "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert set(line["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert line["metrics"]["env_steps_per_s"] == {"value": 9.1e5, "unit": "steps/s"}
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 5 * 2 ** 30}
    assert set(line["compared"]) == set(RESULT["numbers"])
    assert all(set(c) == {"value", "limit"} for c in line["compared"].values())
    assert err.strip().splitlines()[-1].startswith("compared ")


def test_line_keys_trace_1(monkeypatch, capsys):
    _card(monkeypatch)
    monkeypatch.setattr(cells, "train_run", _fake_cell(RESULT))
    assert run.main(["--workload", "t1_shaped_rough_train", "--seed", "5", "--seconds", "1",
                     "--trace", "1"]) == 0
    line = json.loads(capsys.readouterr()[0].strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "compared"]
    assert set(line["metrics"]) == {"rollout_ms.train", "update_ms.train"}
    assert line["device"]["busy_s"] == 0.3 and line["device"]["window_s"] == 0.9


def test_a_number_past_its_limit_or_not_finite_is_not_correct():
    ok, compared = run.judge({"a": 1.0, "b": float("nan")}, {"a": 2.0, "b": 1.0})
    assert not ok and compared["b"]["value"] is None
    assert run.judge({"a": 1.0}, {"a": 2.0})[0]
    assert not run.judge({"a": 3.0}, {"a": 2.0})[0]
    assert not run.judge({}, {"a": 2.0})[0]


def test_no_card_no_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "t1_shaped_flat_train", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "needs 1 CUDA card" in err
