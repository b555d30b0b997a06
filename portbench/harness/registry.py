"""Files found by the names in BENCHMARK.json: a cell's workload, its
configuration and traffic, its driver and system, a configuration's costs,
a per-layer metric's reader. Adding a cell, a configuration or a metric
adds files and entries; no file here names one."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def module(kind: str, name: str) -> ModuleType:
    """portbench/<kind>/<name>.py, loaded by path (names may hold '-' and
    '.'), once per process."""
    path = BENCH / kind / f"{name}.py"
    key = f"portbench_{kind}_{name}".replace("-", "_").replace(".", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def cell(name: str) -> dict:
    """The cell's entry of BENCHMARK.json joined with its files: the
    workload file, the configuration file and the traffic file."""
    bench = benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    workload = load_json(BENCH / "workloads" / f"{name}.json")
    config_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    end_to_end = [m for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])]
    # every per-layer metric lists the cells it is read in
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return {"name": name, "entry": entry, "workload": workload,
            "config": load_json(ROOT / config_entry["file"]),
            "traffic": load_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
            "end_to_end": end_to_end, "per_layer": per_layer,
            "run_seconds": bench["run_seconds"]}
