"""The training slice as a whole: one epoch of icafusion_tpu_torch's fit
against one epoch of the JAX package's fit on the same on-disk pairs, from
the same weights (a .ckpt given as pretrained), dropout off on both sides,
on the CPU. The data path is bit-equal and autoanchor too, so the per-epoch
train losses of results.csv agree as the steps do
(test_torch_port_trainer.py); the evaluation columns are not compared (the
JAX fit's EMA starts from its own init, not from the pretrained
weights)."""

import csv
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

import flax.linen as flax_nn
from icafusion_tpu.config import DataConfig as JaxDataConfig
from icafusion_tpu.config import load_hyp_config as jax_hyp
from icafusion_tpu.models import build_model as jax_build
from icafusion_tpu.models.zoo import tiny_icafusion_config as jax_tiny
from icafusion_tpu.train import fit as jax_fit
from icafusion_tpu_torch.config import load_data_config, load_hyp_config
from icafusion_tpu_torch.data.synthetic import make_dataset
from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
from icafusion_tpu_torch.nn import fusion
from icafusion_tpu_torch.train import fit
from torch_port_common import NoDropout

torch.set_num_threads(1)

LOSS_RTOL = 1e-3     # epoch means of three steps, printed to 5 decimals


def _losses(run_dir):
    with open(Path(run_dir) / "results.csv") as f:
        rows = list(csv.DictReader(f))
    return [[float(r[k]) for k in ("lbox", "lobj", "lcls", "lr")]
            for r in rows]


def test_one_epoch_of_fit_matches_jax_fit(tmp_path, monkeypatch):
    data_yaml = make_dataset(tmp_path / "data", 14, np.random.default_rng(1),
                             hw=(64, 80))
    x = jnp.zeros((1, 64, 64, 3))
    v = jax_build(jax_tiny()).init(jax.random.PRNGKey(0), x, x)
    pre = tmp_path / "init.ckpt"
    pre.write_bytes(serialization.msgpack_serialize(
        {"params": jax.device_get(v["params"]),
         "batch_stats": jax.device_get(v["batch_stats"]),
         "meta": {"epoch": -1, "best_fitness": 0.0}}))
    common = dict(epochs=1, batch_size=4, imgsz=64, workers=1,
                  warmup_min_steps=2, max_targets=16, pretrained=str(pre),
                  seed=3)

    monkeypatch.setattr(flax_nn, "Dropout", NoDropout)
    dc = load_data_config(data_yaml)
    jdc = JaxDataConfig(nc=dc.nc, names=dc.names, path=dc.path,
                        train_rgb=dc.train_rgb, val_rgb=dc.val_rgb,
                        train_ir=dc.train_ir, val_ir=dc.val_ir)
    want = jax_fit.fit(jax_fit.FitConfig(
        model_cfg=jax_tiny(), data_cfg=jdc, hyp=jax_hyp(), n_devices=1,
        project=str(tmp_path / "jax"), **common))

    monkeypatch.setattr(fusion.Dropout, "forward", lambda self, x: x)
    got = fit.fit(fit.FitConfig(
        model_cfg=tiny_icafusion_config(), data_cfg=dc, hyp=load_hyp_config(),
        project=str(tmp_path / "port"), device="cpu", **common))

    (a,), (b,) = _losses(got["run_dir"]), _losses(want["run_dir"])
    np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, atol=2e-5)
    assert a[3] > 0
