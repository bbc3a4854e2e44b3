"""Run one cell of the benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA devices.
Prints one JSON line (the last line of stdout): correct, attempted, failed,
the cell's end-to-end metrics (trace 0) or per-layer metrics (trace 1),
the device, with trace 1 a breakdown, and last the numbers compared with
their limits (also the last lines of stderr). Exits non-zero, printing no
result, without the CUDA devices the cell asks for, or where JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache in the checkout, at fixed paths
for var, sub in (("CUDA_CACHE_PATH", "cuda_cache"),
                 ("TRITON_CACHE_DIR", "triton_cache"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.core.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
