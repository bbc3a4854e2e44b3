"""The comparison that decides ``correct``, with the timed path broken
underneath: a tiny copy of each cell runs on the CPU (the look for a card
skipped), first as shipped, then with each fault the cell can have
planted in the measured package (``tools/faults.py``), and ``correct``
must come out false. An exchange between chips does not exist on one.
The int8 conv has no CPU kernel, so ``float_engine`` is read on the card
(``test_portbench_card.py``).
"""

import pytest

from portbench.core import runner
from portbench.tests.tiny import tiny_root
from portbench.tools import faults as F

CELLS = ["yolov5l-tfb-640-bf16.offline-b32",
         "yolov5l-tfb-640-int8.offline-b32"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("faults"))


def run(root, cell, plant=None):
    return runner.run(cell, 2 ** 31 + 99, 2.0, False, device="cpu",
                      root=root, plant=plant)


@pytest.mark.parametrize("cell", CELLS)
def test_the_shipped_path_is_correct(root, cell):
    res = run(root, cell)
    assert res["correct"] and res["failed"] == 0
    c = res["checks"]["served_err"]
    assert c["value"] < c["limit"]


@pytest.mark.parametrize("fault", ["altered_answers", "half_batch",
                                   "stale_answers"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(root, cell, fault, monkeypatch):
    plant = F.FAULTS[fault](monkeypatch.setattr)
    res = run(root, cell, plant)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


TRAIN = "yolov5l-tfb-640-bf16.train-b64"
# the training numbers' limits at the tiny size (its sound runs read loss
# gaps under 1e-3 and median leaves under 0.03; a half batch 0.7 and 0.1
# to 0.2; a state left unchanged median leaves of 1)
TINY_TRAIN_LIMITS = {"loss_gap": 0.01, "grad_gap_median": 0.08,
                     "change_gap_median": 0.08, "ema_gap_median": 0.04}


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("train_faults"),
                     limits=TINY_TRAIN_LIMITS)


def test_the_shipped_train_step_is_correct(train_root):
    res = runner.run(TRAIN, 2 ** 31 + 98, 1.0, False, device="cpu",
                     root=train_root)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert set(res["checks"]) == set(TINY_TRAIN_LIMITS)


@pytest.mark.parametrize("fault", ["train_half_batch", "train_unchanged"])
def test_a_planted_train_fault_is_not_correct(train_root, fault,
                                              monkeypatch):
    F.FAULTS[fault](monkeypatch.setattr)
    res = runner.run(TRAIN, 2 ** 31 + 98, 1.0, False, device="cpu",
                     root=train_root)
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
