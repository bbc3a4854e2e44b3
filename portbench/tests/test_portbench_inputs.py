"""The inputs are made from the seed alone: the pool of pairs and the
weights."""

import numpy as np
import pytest
import torch

from portbench.core.inputs import make_pool, make_weights
from portbench.tests.tiny import MODEL
from portbench.reference import model as refm

SEEDS = [0, 7, 2 ** 31 + 12345]


@pytest.mark.parametrize("seed", SEEDS)
def test_pool_is_made_from_the_seed(seed):
    a = make_pool(seed, 6, (48, 64), (64, 64))
    b = make_pool(seed, 6, (48, 64), (64, 64))
    c = make_pool(seed + 1, 6, (48, 64), (64, 64))
    for x, y in zip(a[:2], b[:2]):
        assert x.dtype == np.uint8 and x.shape == (6, 64, 64, 3)
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert all(np.array_equal(x, y) for x, y in zip(a[2], b[2]))


def test_pool_is_letterboxed_flir_frames():
    rgb, ir, labels = make_pool(3, 4, (512, 640), (640, 640))
    assert rgb.shape == (4, 640, 640, 3)
    # 64 gray rows above and below the 512-row frame
    assert (rgb[:, :64] == 114).all() and (rgb[:, -64:] == 114).all()
    assert (ir[:, :64] == 114).all() and (ir[:, -64:] == 114).all()
    for lab in labels:
        assert 1 <= len(lab) <= 3 and (lab[:, 0] < 3).all()
        # the boxes lie in the frame, bright in IR
        assert (lab[:, 2] - lab[:, 4] / 2 >= 64 / 640 - 1e-6).all()
    assert ir[:, 64:-64].max() == 220


@pytest.mark.parametrize("seed", SEEDS)
def test_weights_are_made_from_the_seed(seed):
    with torch.device("meta"):
        m = refm.Model(MODEL)
    a = make_weights(m, seed, "cpu")
    b = make_weights(m, seed, "cpu")
    c = make_weights(m, seed + 1, "cpu")
    assert a.keys() == b.keys() == set(m.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["m0.conv.weight"], c["m0.conv.weight"])
    w = a["m1.conv.weight"]
    bound = (6.0 / w[0].numel()) ** 0.5
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert 0.15 <= float(a["m1.bn.weight"].min()) <= 0.25


def test_the_training_feed_is_made_from_the_seed():
    """The train cell's step batches: the same from one seed, another
    order from another, and the checked steps' rows all differ."""
    from portbench.core import bench as B
    from portbench.core.runner import Ctx
    from portbench.core.serving import Inputs
    spec = dict(B.workload("yolov5l-tfb-640-bf16.train-b64"), pool=12,
                batch=2)
    cfg = dict(B.config(spec["config"]), model=MODEL, canvas=[64, 64],
               frame=[48, 64])
    drv = B.driver("train")

    def feed(seed):
        ctx = Ctx("train", seed, 1.0, False, "cpu", spec, cfg)
        return drv.collate(ctx, Inputs(cfg, seed, spec["pool"], "cpu"))

    a, b, c = feed(2 ** 31 + 1), feed(2 ** 31 + 1), feed(2 ** 31 + 2)
    assert len(a) == spec["checked_steps"]
    for x, y in zip(a, b):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
    assert not torch.equal(a[0][0], c[0][0])
    rows = torch.cat([x[0] for x in a]).flatten(1)
    assert len({tuple(r[::97].tolist()) for r in rows}) == len(rows)
