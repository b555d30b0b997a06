"""BENCHMARK.json and the files it names: they parse, keep the contract's
names, units and lengths, and a cell, a configuration or a metric is found
by adding files and entries alone."""
import copy
import json
import re
import shutil

import pytest

from portbench.harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return registry.benchmark()


def one_line(text, limit=200):
    return isinstance(text, str) and 1 <= len(text) <= limit and "\n" not in text \
        and "\t" not in text


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert all(one_line(w) for w in b["command"]) and len(b["command"]) <= 32
    assert (registry.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_allowed(kind):
    names = [e["name"] for e in bench()[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    for c in bench()["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and one_line(c["why"])
        assert one_line(c["source"]) and c["source"].startswith("https://")
        data = registry.load_json(registry.ROOT / c["file"])
        assert data["reduced"] == c["reduced"] and data["source"] == c["source"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert (registry.BENCH / "systems" / f"{c['name']}.py").exists()
        assert (registry.BENCH / "costs" / f"{c['name']}.py").exists()


def test_workloads_name_files_that_parse():
    b = bench()
    configs = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and one_line(w["why"])
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = registry.cell(w["name"])
        assert cell["workload"]["config"] == w["config"]
        assert (registry.BENCH / "drivers" / f"{cell['workload']['driver']}.py").exists()
        assert cell["traffic"]["tensors"] and cell["workload"]["limits"]
        assert cell["workload"]["control"]


def test_metrics():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["source"] in SOURCES
        assert m["moves"] in e2e and one_line(m["layer"])
        assert set(m["workloads"]) <= cells
        assert (registry.BENCH / "metrics" / f"{m['name']}.py").exists()
    for w in cells:
        cell = registry.cell(w)
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2 and cell["per_layer"]
        assert all(m["moves"] in names for m in cell["per_layer"])


def test_file_names_use_name_characters():
    for path in registry.BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(registry.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_a_new_cell_metric_and_config_are_found_from_files_alone(tmp_path, monkeypatch):
    """A later change adds files and entries only: copy the benchmark, add a
    configuration, a traffic mix, a cell and a metric, and the registry
    finds them with no file of the copy edited."""
    root = tmp_path / "checkout"
    shutil.copytree(registry.BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = copy.deepcopy(bench())
    src = registry.cell("flagship-train")
    (root / "portbench/configs/extra-config.json").write_text(json.dumps(src["config"]))
    (root / "portbench/traffic/extra-traffic.json").write_text(json.dumps(src["traffic"]))
    (root / "portbench/workloads/extra-cell.json").write_text(
        json.dumps(dict(src["workload"], config="extra-config")))
    (root / "portbench/metrics/extra_metric.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    b["configs"].append(dict(b["configs"][0], name="extra-config",
                             file="portbench/configs/extra-config.json"))
    b["workloads"].append({"name": "extra-cell", "config": "extra-config",
                           "traffic": "extra-traffic", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] in ("train_tokens_per_s", "train_step_p95_ms"):
            m["workloads"].append("extra-cell")
    b["per_layer"].append({"name": "extra_metric", "unit": "%", "better": "higher",
                           "source": "program_counter", "layer": "device",
                           "moves": "train_tokens_per_s",
                           "workloads": ["extra-cell", "flagship-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(registry, "ROOT", root)
    monkeypatch.setattr(registry, "BENCH", root / "portbench")
    cell = registry.cell("extra-cell")
    assert cell["config"] == src["config"] and cell["traffic"] == src["traffic"]
    assert "extra_metric" in [m["name"] for m in cell["per_layer"]]
    assert "extra_metric" in [m["name"] for m in registry.cell("flagship-train")["per_layer"]]
    assert "extra_metric" not in [m["name"] for m in registry.cell("flagship-gen")["per_layer"]]
    assert registry.module("metrics", "extra_metric").read(None) == 1.0
