"""utils/profiling.py of the port against the JAX package's, on the CPU:
model_info's layers and parameters equal, its GFLOPs within 5 % (the port
counts the convolutions and matrix products of the plain versions with
torch's FlopCounterMode, two operations a multiply-add; XLA's cost
analysis also counts the elementwise operations and its own rewrites:
measured +2.2 % at zoo:tiny 64 px and -2.3 % at yolov5n 320 against
JAX); profile_layers' rows; a trace written and parsed."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import build_model as jax_build
from icafusion_tpu.utils import profiling as jprof
from icafusion_tpu_torch.models import zoo
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.utils import profiling as prof
from icafusion_tpu_torch.utils.convert import load_jax_variables
from icafusion_tpu_torch.utils.stream_merge import merged_model
from torch_port_common import random_variables

torch.set_num_threads(1)

GFLOPS_RTOL = 0.05


@pytest.fixture(scope="module")
def tiny():
    jm = jax_build(jax_zoo.tiny_icafusion_config())
    x = jnp.zeros((1, 64, 64, 3))
    v = random_variables(jm, x, x, train=False, decode=False)
    return jm, v, load_jax_variables(build_model(
        zoo.tiny_icafusion_config()), v)


def test_model_info_matches_jax(tiny, capsys):
    jm, v, model = tiny
    want = jprof.model_info(jm, v, img_size=64, verbose=False)
    got = prof.model_info(model, img_size=64)
    assert "Model Summary: 36 layers, 1.08M params" in capsys.readouterr().out
    assert got["layers"] == want["layers"] == 36
    assert got["params"] == want["params"] == prof.count_params(
        dict(model.named_parameters()))
    assert got["gflops"] == pytest.approx(want["gflops"], rel=GFLOPS_RTOL)
    # the count is the graph's: merging doubles the merged stages' work,
    # bf16 weights count as float32, the model is left where it was
    mm = merged_model(model, 3)
    assert prof.model_info(mm, 64, verbose=False)["gflops"] > got["gflops"]
    assert prof.model_info(
        build_model(zoo.tiny_icafusion_config()).to(torch.bfloat16), 64,
        verbose=False)["gflops"] == got["gflops"]
    assert next(model.parameters()).dtype == torch.float32


def test_profile_layers_gives_a_finite_row_for_every_layer_but_detect(
        tiny, capsys):
    jm, v, model = tiny
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    rows = prof.profile_layers(model, x, x, iters=2)
    assert [r["i"] for r in rows] == list(range(35))
    assert all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in rows)
    by_module = {r["module"] for r in rows}
    assert {"Conv", "C3", "SPPF", "TransformerFusionBlock", "Concat",
            "Upsample"} <= by_module
    assert sum(r["params"] for r in rows) + prof.count_params(
        model.m35) == prof.count_params(model)
    assert len(capsys.readouterr().out.splitlines()) == 35
    with pytest.raises(ValueError, match="capture/overrides"):
        prof.profile_layers(merged_model(model, 2), x, x, iters=1)


def test_profile_op_and_trace(tiny, tmp_path):
    _, _, model = tiny
    x = torch.rand(1, 3, 64, 64)
    assert prof.profile_op(model, x, x, iters=2) > 0
    prof.start_trace(str(tmp_path / "tb"))
    with pytest.raises(RuntimeError, match="already"):
        prof.start_trace(str(tmp_path / "tb"))
    with torch.no_grad():
        model(x, x)
    path = Path(prof.stop_trace())
    assert path.parent == tmp_path / "tb" and path.name.endswith(
        ".pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    with pytest.raises(RuntimeError, match="no trace"):
        prof.stop_trace()
