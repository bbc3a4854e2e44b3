"""BENCHMARK.json against the benchmark's rules, and a per-layer metric
added as files alone."""

import json
import math
import shutil

import pytest

from portbench.core import bench as B

BENCH = B.load()
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_benchmark_is_valid():
    assert B.validate(BENCH) == []


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (B.ROOT / p).is_dir()
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == CONFIG_KEYS
    assert B.NAME.match(entry["name"])
    assert entry["file"].startswith("portbench/")
    cfg = json.loads((B.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert 1 <= len(entry["source"]) <= 200


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_entry(entry):
    assert set(entry) == CELL_KEYS
    for k in ("name", "config", "traffic"):
        assert B.NAME.match(entry[k]), k
    assert entry["chips"] == 1
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    spec = B.workload(entry["name"])
    assert spec["why"] == entry["why"]


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_entry(entry):
    keys = E2E_KEYS if "bound" in entry else LAYER_KEYS
    assert set(entry) - {"workloads"} == keys
    assert B.NAME.match(entry["name"]) and B.UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    if "bound" in entry:
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    else:
        assert entry["source"] in B.SOURCES
        assert 1 <= len(entry["layer"]) <= 200
    if entry["name"].endswith("_roofline") or "mfu" in entry["name"]:
        assert entry["unit"] == "%"


def test_setup_bound_and_run_length():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and setup[0]["bound"] == 0.25
    assert "workloads" not in setup[0]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda e: e["name"])
def test_each_cell_of_a_layer_metric_reports_what_it_moves(metric):
    moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", [cell])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_and_a_layer_metric(cell):
    e2e = [m["name"] for m in B.metrics_for(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert B.metrics_for(BENCH, cell, True)


def test_four_chip_cells_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, math.floor(len(BENCH["workloads"]) / 4))


@pytest.mark.parametrize("bad", [
    ("configs", 0, "name", "has space"),
    ("workloads", 0, "traffic", "a/b"),
    ("end_to_end", 0, "unit", "pairs per s"),
    ("per_layer", 0, "moves", "nothing"),
    ("per_layer", 0, "source", "guess"),
])
def test_validate_catches(bad):
    group, i, key, value = bad
    b = json.loads(json.dumps(BENCH))
    b[group][i][key] = value
    assert B.validate(b)


DUMMY = '''"""calls_seen.offline: predict_arrays calls in the traced window."""


def read(ctx):
    return float(ctx.trace_result.count("portbench.call"))
'''


def test_a_metric_is_added_by_new_files_alone(tmp_path):
    """A copy of the benchmark gains a per-layer metric: a reader file and
    an entry in BENCHMARK.json, no existing file under portbench/ edited;
    a traced tiny run reports it."""
    from portbench.core import runner
    from portbench.tests.tiny import tiny_root
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    (root / "portbench" / "metrics" / "calls_seen.offline.py").write_text(
        DUMMY)
    bench = B.load(root)
    cell = "yolov5l-tfb-640-bf16.offline-b32"
    bench["per_layer"].append({
        "name": "calls_seen.offline", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "serve/engine.py: "
        "ServingEngine", "moves": "pairs_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert B.validate(bench, root) == []
    assert all(p.read_bytes() == data for p, data in before.items())
    res = runner.run(cell, 5, 2.0, True, device="cpu", root=root)
    assert res["metrics"]["calls_seen.offline"]["value"] >= 1
    shutil.rmtree(root)
