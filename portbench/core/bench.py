"""BENCHMARK.json and the files it names, found by name: a cell's
workload file ``portbench/workloads/<cell>.json``, its configuration
``portbench/configs/<config>.json``, its traffic driver
``portbench/traffic/<kind>.py``, each per-layer metric's reader
``portbench/metrics/<metric>.py`` and each module of a configuration that
the plain reference does not build itself
``portbench/reference/modules/<Module>.py``. Adding a cell, a
configuration, a module or a metric adds files and entries; nothing here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import List

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "portbench" / "workloads" /
                       f"{name}.json").read_text())


def config(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "portbench" / "configs" /
                       f"{name}.json").read_text())


def _module(path: Path, key: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def modules_dir(root: Path = ROOT) -> Path:
    """Where the plain reference finds the module files of a checkout."""
    return root / "portbench" / "reference" / "modules"


def driver(kind: str, root: Path = ROOT) -> ModuleType:
    return _module(root / "portbench" / "traffic" / f"{kind}.py",
                   f"portbench_traffic_{kind}")


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    return _module(root / "portbench" / "metrics" / f"{metric}.py",
                   "portbench_metric_" + metric.replace(".", "_").replace(
                       "-", "_"))


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics (trace
    1): those whose ``workloads`` list names it, or that have none."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def unmodelled(name: str, cfg: dict, root: Path = ROOT) -> List[str]:
    """The rows of configuration ``name`` whose module the plain reference
    can build neither itself nor from a module file under ``root``."""
    from portbench.reference import model as refm
    model = cfg.get("model", {})
    rows = list(model.get("backbone", [])) + list(model.get("head", []))
    with refm.modules_from(modules_dir(root)):
        return [f"config {name}: row {i}: module {r[2]} is neither built "
                f"into reference/model.py nor in reference/modules/"
                f"{r[2]}.py" for i, r in enumerate(rows)
                if not refm.modelled(r[2])]


def validate(bench: dict, root: Path = ROOT) -> List[str]:
    """What in ``bench`` breaks the benchmark's rules on names, units,
    sources, files and references between entries; [] when nothing."""
    errs: List[str] = []
    cfgs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def name_ok(n, what):
        if not isinstance(n, str) or not NAME.match(n):
            errs.append(f"{what} {n!r} is not a valid name")

    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in bench[group]]
        if len(seen) != len(set(seen)):
            errs.append(f"{group}: duplicate names")
    metric_names = [m["name"]
                    for m in bench["end_to_end"] + bench["per_layer"]]
    if len(metric_names) != len(set(metric_names)):
        errs.append("a metric name is used twice")
    for c in bench["configs"]:
        name_ok(c["name"], "config")
        for k in c["reduced"]:
            name_ok(k, "reduced key")
        f = root / c["file"]
        if not f.is_file() or not c["file"].startswith(tuple(
                p + "/" for p in bench["paths"])):
            errs.append(f"config file {c['file']} missing or outside paths")
        else:
            errs += unmodelled(c["name"], json.loads(f.read_text()), root)
    for w in bench["workloads"]:
        name_ok(w["name"], "workload")
        name_ok(w["traffic"], "traffic")
        if w["config"] not in cfgs:
            errs.append(f"{w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            errs.append(f"{w['name']}: chips must be 1 or 4")
        if not (1 <= len(w["why"]) <= 200) or "\n" in w["why"]:
            errs.append(f"{w['name']}: why must be one line of 1-200 chars")
        wf = root / "portbench" / "workloads" / f"{w['name']}.json"
        if not wf.is_file():
            errs.append(f"{w['name']}: no workload file")
        else:
            spec = json.loads(wf.read_text())
            if spec.get("config") != w["config"] or spec.get(
                    "traffic") != w["traffic"]:
                errs.append(f"{w['name']}: workload file disagrees")
            if not (root / "portbench" / "traffic" /
                    f"{spec.get('kind')}.py").is_file():
                errs.append(f"{w['name']}: no driver for {spec.get('kind')}")
    for m in bench["end_to_end"] + bench["per_layer"]:
        name_ok(m["name"], "metric")
        if not UNIT.match(m["unit"]):
            errs.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            errs.append(f"{m['name']}: better must be lower or higher")
        if m["source"] not in SOURCES:
            errs.append(f"{m['name']}: bad source {m['source']}")
        for c in m.get("workloads", []):
            if c not in cells:
                errs.append(f"{m['name']}: unknown cell {c}")
    for m in bench["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            errs.append(f"{m['name']}: an end-to-end source is host_clock "
                        "or device_trace")
        if not 0 < m["bound"] <= 0.25:
            errs.append(f"{m['name']}: bound out of (0, 0.25]")
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            errs.append(f"{m['name']}: moves an unknown metric")
            continue
        if not (root / "portbench" / "metrics" / f"{m['name']}.py").is_file():
            errs.append(f"{m['name']}: no reader file")
        if not m["layer"] or "\n" in m["layer"] or len(m["layer"]) > 200:
            errs.append(f"{m['name']}: layer must be one line")
        moved = e2e[m["moves"]]
        for c in m.get("workloads", list(cells)):
            if "workloads" in moved and c not in moved["workloads"]:
                errs.append(f"{m['name']}: cell {c} does not report "
                            f"{m['moves']}")
        if m["name"].endswith("_roofline") and m["unit"] != "%":
            errs.append(f"{m['name']}: a roofline share is in %")
    for c in cells:
        e = [m for m in bench["end_to_end"]
             if "workloads" not in m or c in m["workloads"]]
        if "setup_s" not in [m["name"] for m in e] or len(e) < 2:
            errs.append(f"{c}: needs setup_s and another end-to-end metric")
        if not metrics_for(bench, c, True):
            errs.append(f"{c}: needs a per-layer metric")
    used = {w["config"] for w in bench["workloads"]}
    if set(cfgs) - used:
        errs.append(f"configs used by no cell: {sorted(set(cfgs) - used)}")
    return errs
