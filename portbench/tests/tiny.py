"""A tiny copy of the benchmark for CPU tests: the cells' drivers, readers
and workload parameters on a two-stream model of the same family at
64 px (about 0.2 M parameters), in a temporary root."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.core import bench as B

ANCHORS = [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
           [116, 90, 156, 198, 373, 326]]


def _tower(f):
    return [[f, 1, "Conv", [16, 6, 2, 2]], [-1, 1, "Conv", [32, 3, 2]],
            [-1, 1, "C3", [32]], [-1, 1, "Conv", [48, 3, 2]],
            [-1, 1, "C3", [48]], [-1, 1, "Conv", [64, 3, 2]],
            [-1, 1, "C3", [128]], [-1, 1, "Conv", [96, 3, 2]],
            [-1, 1, "SPPF", [96, 5]]]


MODEL = {
    "nc": 3, "depth_multiple": 1.0, "width_multiple": 1.0, "anchors": ANCHORS,
    "backbone": _tower(-1) + _tower(-4) + [
        [[4, 13], 1, "TransformerFusionBlock", [48, 4, 4]],
        [[6, 15], 1, "TransformerFusionBlock", [128, 4, 4]],
        [[8, 17], 1, "TransformerFusionBlock", [96, 2, 2]]],
    "head": [
        [-1, 1, "Conv", [64, 1, 1]], [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 19], 1, "Concat", [1]], [-1, 3, "C3", [64, False]],
        [-1, 1, "Conv", [48, 1, 1]], [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 18], 1, "Concat", [1]], [-1, 3, "C3", [48, False]],
        [-1, 1, "Conv", [48, 3, 2]], [[-1, 25], 1, "Concat", [1]],
        [-1, 3, "C3", [64, False]], [-1, 1, "Conv", [64, 3, 2]],
        [[-1, 21], 1, "Concat", [1]], [-1, 3, "C3", [128, False]],
        [[28, 31, 34], 1, "Detect", [3, ANCHORS]]]}


def tiny_root(tmp: Path, limits: dict = None) -> Path:
    """A root whose BENCHMARK.json and files are the real ones with every
    configuration swapped for the tiny model at 64 px (its precision and
    limits kept) and every workload file's pool and batch cut to CPU
    size."""
    root = Path(tmp) / "tiny"
    (root / "portbench").mkdir(parents=True)
    for d in ("traffic", "metrics"):
        shutil.copytree(B.PB / d, root / "portbench" / d)
    bench = B.load()
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench" / "configs").mkdir()
    for c in bench["configs"]:
        cfg = json.loads((B.ROOT / c["file"]).read_text())
        cfg.update(model=MODEL, canvas=[64, 64], frame=[48, 64])
        if limits is not None:
            cfg["limits"] = limits
        (root / c["file"]).write_text(json.dumps(cfg))
    (root / "portbench" / "workloads").mkdir()
    for f in (B.PB / "workloads").glob("*.json"):
        spec = json.loads(f.read_text())
        if spec["kind"] == "train":
            spec.update(pool=12, batch=2)
        else:
            spec.update(pool=8, batch=4)
        (root / "portbench" / "workloads" / f.name).write_text(
            json.dumps(spec))
    return root
