"""On the card, at each cell's own size: one short run comes out correct,
and the control (the next lower precision in the program's place: the
program's int8 path under bf16 serving, the reference at int4 under int8,
the reference at fp8 under bf16 training) reads one compared number above
its limit. Marked ``cuda``; they skip where no
card is present. Run them on the card with

    python -m pytest -m cuda portbench/tests/test_portbench_card.py -q
"""

import pytest

from portbench.core import bench as B

CELLS = [w["name"] for w in B.load()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    from portbench.core import runner
    res = runner.run(cell, 2 ** 31 + 4321, 3.0, False, device="cuda")
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    from portbench.tools.readings import readings
    lim = B.config(B.workload(cell)["config"])["limits"]
    row, = readings(cell, [2 ** 31 + 8765], 3.0, [True], "cuda")
    assert any(v > lim[k] for k, v in row["checks"].items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c in CELLS if B.config(
    B.workload(c)["config"])["precision"] == "int8"])
def test_a_float_engine_in_an_int8_cell_is_not_correct(card, cell):
    from portbench.tools.readings import readings
    row, = readings(cell, [2 ** 31 + 5678], 3.0, [False], "cuda",
                    fault="float_engine")
    assert row["checks"]["w8a8_convs_missing"] > 0
