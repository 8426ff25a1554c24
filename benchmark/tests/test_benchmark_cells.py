"""Cells resolve by name; a cell added from files alone runs; the command's
last line; what the command refuses."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import benchtiny
from benchmark import harness

ROOT = benchtiny.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_resolves_by_name():
    spec = _spec()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        cell = harness.resolve(w["name"])
        assert cell.config["name"] == w["config"]
        assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.load_reader(m["name"]))
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
        assert set(m["workloads"]) <= {w["name"] for w in spec["workloads"]}


def test_a_strategy_without_a_reference_is_refused(tmp_path):
    root = benchtiny.tiny_copy(str(tmp_path))
    path = os.path.join(root, "benchmark", "configs", "tinytop.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["selection"]["strategy"] = "emoc"
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(KeyError, match="no reference"):
        harness.resolve(benchtiny.NEW, root)


def test_names_and_files_keep_the_contract():
    spec = _spec()
    assert spec["command"] == ["python3", "benchmark/run.py"] and spec["paths"] == ["benchmark"]
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]] + [
        m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    assert all(m["bound"] <= 0.25 for m in spec["end_to_end"])


def _run(root, *args, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=root,
                          capture_output=True, text=True, timeout=600, env=env)


CPU_PER_LAYER = {"select_ms", "update_ms", "start_ms", "captures", "rbf_launches_per_turn"}


@pytest.mark.parametrize("cell,trace,judged,per_layer", [
    ("tiny.tinycohort", "0", "select_gap", CPU_PER_LAYER),
    ("tiny.tinycohort", "1", "select_gap", CPU_PER_LAYER),
    (benchtiny.NEW, "0", "top_gap", CPU_PER_LAYER),
    (benchtiny.NEW, "1", "top_gap", CPU_PER_LAYER | {"feedback_calls"})])
def test_cell_from_files_alone_runs_on_the_cpu(tmp_path, cell, trace, judged, per_layer):
    """``tiny.tinycohort`` adds a configuration and a mix of the built-in
    path; ``tinytop.tinymixed`` a strategy with its reference and launch
    table, a mix with code of its own and a metric: each from new files."""
    root = benchtiny.tiny_copy(str(tmp_path))
    p = _run(root, "--workload", cell, "--seed", str(2**31 + 7), "--seconds", "3",
             "--trace", trace, "--device", "cpu")
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "compared"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["compared"]) == {"failed_turns", "posterior_err", judged}
    want = {"0": {"turn_ms_p95", "rounds_per_s", "setup_s"}, "1": per_layer}
    assert set(out["metrics"]) == want[trace]
    assert out["device"]["platform"] == "cpu"
    assert p.stderr.strip().splitlines()[-1].startswith(f"compared {judged}")


def test_command_fails_without_a_card(tmp_path):
    root = benchtiny.tiny_copy(str(tmp_path))
    p = _run(root, "--workload", "tiny.tinycohort", "--seed", "1", "--seconds", "1",
             "--trace", "0", env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_command_fails_beside_nothing_but_itself(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    p = _run(str(tmp_path), "--workload", "mirflickr25k.cohort8", "--seed", "1",
             "--seconds", "1", "--trace", "0", "--device", "cpu")
    assert p.returncode != 0 and p.stdout.strip() == ""
