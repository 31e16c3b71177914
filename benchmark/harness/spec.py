"""Where the parts of a cell live, found by name.

  BENCHMARK.json                 the cells, metrics and bounds
  benchmark/workloads/<cell>.json the cell: config, traffic, chips, why,
                                 driver, store geometry, limits
  benchmark/configs/<name>.json  a configuration as run; <name>.py its
                                 shapes and counts of work and bytes
  benchmark/traffic/<mix>.json   a traffic mix's parameters
  benchmark/metrics/<name>.py    a per-layer metric's reader

A later cell, configuration, mix or metric is a new file and a new
entry; nothing here changes for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    counter: object            # the config's module of shapes and counts
    traffic: dict
    end_to_end: list           # BENCHMARK.json entries this cell reports
    per_layer: list


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported


def load_cell(name: str, *, bench_dir: Path = BENCH_DIR,
              manifest: dict | None = None) -> Cell:
    """The cell `name`: its workload file, configuration and traffic, and
    the metrics BENCHMARK.json gives it.  The manifest's entry for the
    cell, when it has one, must agree with the workload file."""
    wl = load_json(bench_dir / "workloads" / f"{name}.json")
    if manifest is None:
        path = bench_dir.parent / "BENCHMARK.json"
        manifest = load_json(path) if path.exists() else {}
    for entry in manifest.get("workloads", []):
        if entry["name"] == name:
            for key in ("config", "traffic", "chips"):
                if entry[key] != wl[key]:
                    raise ValueError(f"{name}: BENCHMARK.json {key} "
                                     f"{entry[key]!r} != workload file's "
                                     f"{wl[key]!r}")
    cfg = load_json(bench_dir / "configs" / f"{wl['config']}.json")
    counter = load_module(bench_dir / "configs" / f"{wl['config']}.py",
                          f"bench_config_{wl['config']}")
    traffic = load_json(bench_dir / "traffic" / f"{wl['traffic']}.json")
    e2e = [m for m in manifest.get("end_to_end", [])
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest.get("per_layer", [])
                 if _applies(m, name, reported)]
    return Cell(name, wl, cfg, counter, traffic, e2e, per_layer)


def metric_reader(name: str, *, bench_dir: Path = BENCH_DIR):
    return load_module(bench_dir / "metrics" / f"{name}.py",
                       f"bench_metric_{name.replace('.', '_')}")
