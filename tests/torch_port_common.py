"""Shared helpers of the tests that hold icafusion_tpu_torch against the JAX
package: random flax variables from a numpy seed, layout moves, and a tiny
JAX Trainer beside a port Trainer from one init."""

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp


def random_variables(module, *args, seed: int = 0, **kwargs):
    """{"params", "batch_stats"} for a flax module as nested dicts of numpy
    arrays drawn from ``seed``, scaled so that every parameter matters:
    He-normal kernels, BatchNorm statistics away from identity, non-zero
    positional embeddings and gains near their inits."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("scale", "coefficients"):
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name in ("w1", "w2"):
            v = 0.5 + 0.1 * rng.normal(size=shape)
        else:                   # bias, mean, pos_emb_*
            v = 0.1 * rng.normal(size=shape)
        return v.astype(np.float32)

    tree = {k: shapes[k] for k in ("params", "batch_stats") if k in shapes}
    return jax.tree_util.tree_map_with_path(draw, tree)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


class NoDropout:
    """Stands in for flax.linen.Dropout inside a test: the identity."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x, *args, **kwargs):
        return x


def no_dropout(model):
    """The port model with every Dropout at p = 0."""
    from icafusion_tpu_torch.nn.fusion import Dropout
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


TRAIN_SIZE = 64


def train_batch(B, seed=0, T=8):
    """(rgb, ir) NHWC float images, padded targets and mask, numpy."""
    from icafusion_tpu.train.loss import pad_targets
    rng = np.random.default_rng(seed)
    S = TRAIN_SIZE
    rgb = rng.random((B, S, S, 3), np.float32)
    ir = rng.random((B, S, S, 3), np.float32)
    labels = [np.array([[0, 0.5, 0.5, 0.4, 0.4], [1, 0.25, 0.25, 0.2, 0.3],
                        [2, 0.7, 0.3, 0.1, 0.15]], np.float32)] * B
    t, m = pad_targets(labels, T)
    return rgb, ir, t, m


def tiny_trainers(B, accum=1, bf16=False, **kw):
    """(JAX trainer, its state, its compiled step with dropout off, port
    Trainer on the CPU from the same weights with dropout off, the
    variables) for the tiny model at TRAIN_SIZE px."""
    from icafusion_tpu.config import load_hyp_config as jax_hyp
    from icafusion_tpu.models import build_model as jax_build
    from icafusion_tpu.models.zoo import tiny_icafusion_config as jax_tiny
    from icafusion_tpu.train.trainer import Trainer as JaxTrainer
    from icafusion_tpu_torch.config import load_hyp_config
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
    from icafusion_tpu_torch.train.trainer import Trainer
    from icafusion_tpu_torch.utils.convert import load_jax_variables
    kw = dict(epochs=3, steps_per_epoch=1, batch_size=B, imgsz=TRAIN_SIZE,
              warmup_min_steps=2, accum_steps=accum, **kw)
    jm = jax_build(jax_tiny(), dtype=jnp.bfloat16 if bf16 else jnp.float32)
    jtr = JaxTrainer(model=jm, hyp=jax_hyp(), **kw)
    rgb, ir, _, _ = train_batch(1)
    state = jtr.init_state(jax.random.PRNGKey(0), rgb, ir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn, "Dropout", NoDropout)
        jstep = jax.jit(jtr.make_train_step()).lower(
            state, *(jnp.asarray(a) for a in train_batch(B * accum))
        ).compile()
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    model = no_dropout(load_jax_variables(
        build_model(tiny_icafusion_config()), variables))
    tr = Trainer(model=model, hyp=load_hyp_config(), bf16=bf16,
                 device="cpu", **kw)
    return jtr, state, jstep, tr, variables


def val_ground_truth(data_yaml, out_dir):
    """(KAIST json, COCO json) of the val pairs of a data YAML written by
    data/synthetic.make_dataset: every box a KAIST 'person' (category 1,
    height = box height in pixels) on image id = val index, and a COCO
    annotation of its class on image id = file stem, as the Evaluator's
    MR lines and COCO dump number them."""
    import json
    from pathlib import Path

    import cv2
    import yaml

    d = yaml.safe_load(Path(data_yaml).read_text())
    root = Path(d["path"])
    images = sorted((root / d["val_rgb"]).glob("*.jpg"))
    kaist = {"images": [], "annotations": []}
    coco = {"images": [], "annotations": [],
            "categories": [{"id": c} for c in range(int(d["nc"]))]}
    for idx, img in enumerate(images):
        h, w = cv2.imread(str(img)).shape[:2]
        kaist["images"].append({"id": idx, "height": h, "width": w})
        coco["images"].append({"id": img.stem})
        lab = root / "labels" / Path(d["val_rgb"]).name / f"{img.stem}.txt"
        for row in np.loadtxt(lab, ndmin=2):
            c, cx, cy, bw, bh = row
            box = [float((cx - bw / 2) * w), float((cy - bh / 2) * h),
                   float(bw * w), float(bh * h)]
            n = len(coco["annotations"]) + 1
            kaist["annotations"].append({
                "id": n, "image_id": idx, "category_id": 1, "bbox": box,
                "height": box[3], "occlusion": 0, "ignore": 0})
            coco["annotations"].append({
                "id": n, "image_id": img.stem, "category_id": int(c),
                "bbox": box, "area": box[2] * box[3], "iscrowd": 0})
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = out_dir / "kaist_gt.json", out_dir / "coco_gt.json"
    for p, doc in zip(paths, (kaist, coco)):
        p.write_text(json.dumps(doc))
    return paths
