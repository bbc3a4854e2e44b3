"""The train half of icafusion_tpu_torch's data path against the JAX
package's, bit for bit: the same seeds give the same augmented samples,
batches and anchors."""

import numpy as np
import pytest

from icafusion_tpu.config import load_hyp_config as jax_hyp
from icafusion_tpu.data import augment as jax_augment
from icafusion_tpu.data.datasets import \
    PairedDetectionDataset as JaxDataset
from icafusion_tpu.data.loader import PairedLoader as JaxLoader
from icafusion_tpu.train import autoanchor as jax_autoanchor
from icafusion_tpu.utils import general as jax_general
from icafusion_tpu_torch.config import load_hyp_config
from icafusion_tpu_torch.data import augment
from icafusion_tpu_torch.data.datasets import PairedDetectionDataset
from icafusion_tpu_torch.data.loader import PairedLoader
from icafusion_tpu_torch.data.synthetic import make_dataset
from icafusion_tpu_torch.train import autoanchor
from icafusion_tpu_torch.utils import general

S = 96


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    base = tmp_path_factory.mktemp("pairs") / "data"
    make_dataset(base, 14, np.random.default_rng(0), hw=(120, 150))
    return base


HYPS = {"mosaic": {}, "letterbox": {"mosaic": 0.0},
        "flips": {"mosaic": 0.0, "flipud": 1.0, "fliplr": 1.0},
        "perspective": {"degrees": 10.0, "shear": 5.0, "perspective": 1e-4}}


def _datasets(root, hyp_kw, augment_=True, single_cls=False):
    args = (str(root / "visible" / "train"), str(root / "infrared" / "train"))
    ours = PairedDetectionDataset(*args, img_size=S, nc=3,
                                  hyp=load_hyp_config(**hyp_kw),
                                  augment=augment_, single_cls=single_cls)
    theirs = JaxDataset(*args, img_size=S, hyp=jax_hyp(**hyp_kw),
                        augment=augment_, nc=3, single_cls=single_cls)
    return ours, theirs


@pytest.mark.parametrize("case", sorted(HYPS))
def test_train_sample_bit_equal(root, case):
    ours, theirs = _datasets(root, HYPS[case])
    for i in range(len(ours)):
        a = ours.train_sample(i, np.random.default_rng((3, i)))
        b = theirs.train_sample(i, np.random.default_rng((3, i)))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_val_side_unaugmented_train_sample_bit_equal(root):
    ours, theirs = _datasets(root, {}, augment_=False)
    for i in range(3):
        a = ours.train_sample(i, np.random.default_rng(i))
        b = theirs.train_sample(i, np.random.default_rng(i))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_labels_cache_histogram_and_single_cls(root, tmp_path):
    ours, theirs = _datasets(root, {})
    np.testing.assert_array_equal(ours.class_histogram(),
                                  theirs.class_histogram())
    one, _ = _datasets(root, {}, single_cls=True)
    assert all((l[:, 0] == 0).all() for l in one.labels)
    args = (str(root / "visible" / "train"), str(root / "infrared" / "train"))
    cached = [PairedDetectionDataset(*args, img_size=S, nc=3,
                                     cache_dir=str(tmp_path))
              for _ in range(2)]
    assert len(list(tmp_path.glob("labels_*.npz"))) == 1
    for a, b, c in zip(cached[0].labels, cached[1].labels, theirs.labels):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    with pytest.raises(ValueError, match="exceeds nc"):
        PairedDetectionDataset(*args, img_size=S, nc=1,
                               cache_dir=str(tmp_path))


@pytest.mark.parametrize("image_weights", [False, True])
def test_loader_epochs_bit_equal(root, image_weights):
    """Two epochs of batches (the permutation, each sample's generator keyed
    on (seed, epoch, index), the padded targets), with 3 workers against the
    JAX loader's 1."""
    ours, theirs = _datasets(root, {})
    cw = general.labels_to_class_weights(ours.labels, 3)
    np.testing.assert_array_equal(
        cw, jax_general.labels_to_class_weights(theirs.labels, 3))
    a = PairedLoader(ours, 4, max_targets=6, seed=5, num_workers=3,
                     image_weights=image_weights, class_weights=cw)
    b = JaxLoader(theirs, 4, max_targets=6, seed=5, num_workers=1,
                  image_weights=image_weights, class_weights=cw)
    assert a.steps_per_epoch == b.steps_per_epoch == 2    # 11 train pairs
    for epoch in (0, 1):
        np.testing.assert_array_equal(a._epoch_indices(epoch),
                                      b._epoch_indices(epoch))
        got, want = list(a.epoch(epoch)), list(b.epoch(epoch))
        assert len(got) == len(want) == 2
        for x, y in zip(got, want):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_loader_raises_a_worker_error(root):
    ours, _ = _datasets(root, {})
    ours.files_rgb[2] = str(root / "missing.jpg")
    with pytest.raises(FileNotFoundError):
        list(PairedLoader(ours, 4, seed=0, num_workers=2,
                          shuffle=False).epoch(0))


def test_augment_helpers_bit_equal():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (40, 56, 3), np.uint8)
    np.testing.assert_array_equal(
        augment.shift_augment(img, np.random.default_rng(1)),
        jax_augment.shift_augment(img, np.random.default_rng(1)))
    for clahe in (True, False):
        np.testing.assert_array_equal(augment.hist_equalize(img, clahe),
                                      jax_augment.hist_equalize(img, clahe))
    a, b = img.copy(), img.copy()
    augment.augment_hsv(a, np.random.default_rng(2))
    jax_augment.augment_hsv(b, np.random.default_rng(2))
    np.testing.assert_array_equal(a, b)
    boxes = rng.uniform(0, 50, (4, 10))
    np.testing.assert_array_equal(augment.box_candidates(boxes, boxes * 1.1),
                                  jax_augment.box_candidates(boxes,
                                                             boxes * 1.1))
    xywh = rng.uniform(0.1, 0.9, (6, 4)).astype(np.float32)
    np.testing.assert_array_equal(augment.xywhn2xyxy(xywh, 50, 40, 3, 2),
                                  jax_augment.xywhn2xyxy(xywh, 50, 40, 3, 2))
    np.testing.assert_array_equal(augment.xyxy2xywhn(xywh * 40, 50, 40),
                                  jax_augment.xyxy2xywhn(xywh * 40, 50, 40))
    for c, e, lim, after in ((30, 20, 100, False), (30, 80, 100, True)):
        assert augment._tile_span(c, e, lim, after) == \
            jax_augment._tile_span(c, e, lim, after)


def test_autoanchor_bit_equal(root):
    ours, theirs = _datasets(root, {})
    shapes = [(120, 150)] * len(ours)
    wh = autoanchor.dataset_shapes(ours.labels, shapes, 320,
                                   rng=np.random.default_rng(1))
    np.testing.assert_array_equal(
        wh, jax_autoanchor.dataset_shapes(theirs.labels, shapes, 320,
                                          rng=np.random.default_rng(1)))
    anchors = np.array([[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
                        [116, 90, 156, 198, 373, 326]],
                       np.float32).reshape(3, 3, 2)
    assert autoanchor.check_anchors(wh, anchors) == \
        jax_autoanchor.check_anchors(wh, anchors)
    np.testing.assert_array_equal(
        autoanchor.kmean_anchors(wh, n=9, img_size=320, gen=200),
        jax_autoanchor.kmean_anchors(wh, n=9, img_size=320, gen=200))
    far = anchors * 20          # forces the k-means and genetic search
    a, changed_a = autoanchor.maybe_autoanchor(ours, far, S)
    b, changed_b = jax_autoanchor.maybe_autoanchor(theirs, far, S)
    assert changed_a == changed_b
    np.testing.assert_array_equal(a, b)
