"""The harness finds a cell's parts by name, a new cell is a new file,
and BENCHMARK.json agrees with the files it names."""
import json
import re
import shutil

from benchmark.harness import spec

MANIFEST = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_a_dropped_workload_file_is_found(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    wl = json.loads((bench / "workloads" / "nomic-v1.5-ingest-docs.json")
                    .read_text())
    wl["traffic"] = "ingest-chunks"
    (bench / "workloads" / "nomic-v1.5-ingest-chunks.json").write_text(
        json.dumps(wl))
    cell = spec.load_cell("nomic-v1.5-ingest-chunks", bench_dir=bench,
                          manifest={})
    assert cell.traffic["tokens"]["max"] == 459
    assert cell.config["n_layer"] == 12


def test_every_cell_loads_with_its_metrics():
    for w in MANIFEST["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        for m in cell.per_layer:
            reader = spec.metric_reader(m["name"])
            assert reader.UNIT == m["unit"] and reader.MOVES == m["moves"]
            assert reader.LAYER == m["layer"] and reader.SOURCE == m["source"]


def test_manifest_keeps_to_its_contract():
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [c["name"] for c in MANIFEST["configs"]] \
        + [w["name"] for w in MANIFEST["workloads"]] \
        + [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for c in MANIFEST["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert sorted(c["reduced"]) == sorted(cfg["reduced"]) \
            == sorted(cfg["published"])
        assert all(k in cfg for k in c["reduced"])
        # what the port computes differently stays out of `reduced`: the
        # published value at the top level, the port's under departures
        assert not set(cfg["departures"]) & set(cfg["reduced"])
        assert all(k in cfg for k in cfg["departures"])
        assert cfg["serve_dtype"] == "bfloat16" and cfg["serve_dtype_source"]
