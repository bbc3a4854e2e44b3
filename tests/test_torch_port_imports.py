"""The port (icafusion_tpu_torch, the smoke run's phase bodies in
icafusion_tpu_torch/smoke/ included), chip_smoke.py and port_probes.py
import no JAX, no flax and nothing of the JAX package, in a fresh
interpreter; matplotlib and tensorboard only when a plot or a writer is
made."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

PROBE = """
import importlib, pkgutil, sys
import icafusion_tpu_torch
names = ["icafusion_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    icafusion_tpu_torch.__path__, "icafusion_tpu_torch.")]
for n in names:
    importlib.import_module(n)
train = ("cli.train", "data.synthetic", "train.autoanchor", "train.ema",
         "train.fit", "train.loss", "train.optim", "train.trainer")
assert all("icafusion_tpu_torch." + t in names for t in train), names
val = ("cli._common", "cli.val", "eval.cocoeval", "eval.kaist", "models.tta",
       "ops.confluence", "utils.plots")
assert all("icafusion_tpu_torch." + t in names for t in val), names
serve = ("cli.detect", "data.decode", "data.streams", "hub", "ops.nms",
         "serve.batcher", "serve.engine", "serve.http_server", "train.fit",
         "utils.plots")
assert all("icafusion_tpu_torch." + t in names for t in serve), names
assert "icafusion_tpu_torch.nn.backbones" in names, names
assert "icafusion_tpu_torch.parallel.mesh" in names, names
weights = ("utils.torch_convert", "utils.loggers")
assert all("icafusion_tpu_torch." + t in names for t in weights), names
smoke = ("common", "train", "val", "int8", "serve", "configs", "parallel",
         "reference")
assert all("icafusion_tpu_torch.smoke." + t in names for t in smoke), names
import chip_smoke, port_probes
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "icafusion_tpu",
                                    "matplotlib", "tensorboard",
                                    "tensorflow"))
print(len(names), bad)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]", bad
    assert int(n) >= 70, out.stdout      # every module was walked


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Outside a checkout, and here without a card, the smoke run exits
    non-zero and prints no result line. (With a card, the checkout's own
    script would run in full, so it is only started where there is none.)"""
    import torch
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    runs = [alone]
    if not torch.cuda.is_available():
        runs.append(REPO / "chip_smoke.py")
    for script in runs:
        out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0, script
        assert '"ok": true' not in out.stdout
