"""Nothing the harness loads is JAX, jaxlib, flax or the JAX package, by
top-level module name compared whole (icafusion_tpu_torch is the port);
no harness file reads the JAX package's benchmark records or folders."""

import os
import re
import subprocess
import sys

from portbench.core import bench as B
from portbench.core.runner import FORBIDDEN, forbidden_modules

LOAD_ALL = r"""
import runpy, sys
sys.argv = ["run.py"]
mod = runpy.run_path("portbench/run.py", run_name="portbench_run")
from portbench.core import bench as B, runner, serving, trace
import portbench.tools.readings
bench = B.load()
for spec in {B.workload(w["name"])["kind"] for w in bench["workloads"]}:
    B.driver(spec)
for m in bench["per_layer"]:
    B.reader(m["name"])
import icafusion_tpu_torch.serve.engine, icafusion_tpu_torch.serve.batcher
import icafusion_tpu_torch.utils.quantize, icafusion_tpu_torch.config
import icafusion_tpu_torch.models.assembler, icafusion_tpu_torch.nn.fusion
print(",".join(runner.forbidden_modules()) or "none")
print("icafusion_tpu_torch" in sys.modules)
"""


def test_whole_names_are_compared(monkeypatch):
    assert FORBIDDEN == ("jax", "jaxlib", "flax", "icafusion_tpu")
    import types
    monkeypatch.setitem(sys.modules, "icafusion_tpu_torchx",
                        types.ModuleType("icafusion_tpu_torchx"))
    monkeypatch.setitem(sys.modules, "jaxlib_like",
                        types.ModuleType("jaxlib_like"))
    assert "icafusion_tpu_torchx" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "icafusion_tpu.kernels",
                        types.ModuleType("icafusion_tpu.kernels"))
    assert "icafusion_tpu.kernels" in forbidden_modules()


def test_a_fresh_interpreter_loading_the_harness_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", LOAD_ALL], cwd=B.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(B.ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "none" and lines[-1] == "True"


def test_no_harness_file_reads_the_jax_records():
    pat = re.compile(r"(?<![\w/.])bench\.py|BENCH_|MULTICHIP_"
                     r"|icafusion_tpu/|(import|from)\s+(jax|jaxlib|flax)\b"
                     r"|(import|from)\s+icafusion_tpu(?!_torch)\b")
    for p in B.PB.rglob("*"):
        if p.suffix in (".py", ".json", ".md") and \
                "tests" not in p.relative_to(B.PB).parts:
            assert not pat.search(p.read_text()), p
