"""The readings that a cell's limits are set from: for each seed, the cell's
set-up, a short window at the cell's own load, and the comparison with the
plain reference, for the program as configured and (``--control 1``) for
the control in its place: the program's own next lower precision (int8
under bf16) or the reference at int4 (under int8); ``--fault <name>``
plants one of ``tools/faults.py``'s faults under the program. One process
serves all seeds, so that the build and the card's start are paid once.

    python3 portbench/tools/readings.py --workload <cell> \
        --seeds 1,2,3 --seconds 4 --control 0 [--fault half_batch] \
        [--device cuda]

Prints one JSON line a seed and side: {"seed", "control", "checks"}.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seeds, seconds, control, device="cuda", root=ROOT,
             fault=None):
    from portbench.tools.faults import FAULTS, Patch
    patch = Patch()
    try:
        plant = FAULTS[fault](patch) if fault else None
        return _readings(cell, seeds, seconds, control, device, root, plant,
                         fault)
    finally:
        patch.undo()


def _readings(cell, seeds, seconds, control, device, root, plant, fault):
    import torch
    from portbench.core import bench as B
    from portbench.core.runner import Ctx
    spec = B.workload(cell, root)
    cfg = B.config(spec["config"], root)
    drv = B.driver(spec["kind"], root)
    out = []
    for seed in seeds:
        for ctl in control:
            t = time.perf_counter()
            ctx = Ctx(cell, seed, seconds, False, device, spec, cfg, ctl)
            st = drv.setup(ctx)
            if plant is not None:
                plant(st)
            o = drv.window(ctx, st, seconds)
            checks = drv.check(ctx, st)
            row = {"seed": seed, "control": ctl, "fault": fault,
                   "failed": o["failed"],
                   "attempted": o["attempted"],
                   "checks": {k: v["value"] for k, v in checks.items()},
                   "seconds": time.perf_counter() - t}
            print(json.dumps(row), flush=True)
            out.append(row)
            del st, ctx
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", default="0",
                    help="0, 1, or 0,1 for both sides on each seed")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    readings(a.workload, [int(s) for s in a.seeds.split(",")], a.seconds,
             [bool(int(c)) for c in a.control.split(",")], a.device,
             fault=a.fault)


if __name__ == "__main__":
    main()
