"""icafusion_tpu_torch's training loop on the CPU: fit and cli.train on a
tiny on-disk set (results.csv in both layouts, the KAIST MR columns, the
plots, checkpoints, resume, pretrained weights, multi-scale, stream-merged
training and hyperparameter evolution, the last two against the JAX
package), the refusal to run without a card unless the CPU is asked for,
and the options that raise."""

import csv
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from icafusion_tpu_torch.cli import train as cli_train
from icafusion_tpu_torch.config import load_data_config, load_hyp_config
from icafusion_tpu_torch.data.synthetic import make_dataset
from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
from icafusion_tpu_torch.train.fit import (REFERENCE_RESULTS_KEYS,
                                           RESULTS_HEADER, EpochMeter,
                                           FitConfig, fit)
from icafusion_tpu_torch.utils.checkpoint import load_checkpoint
from torch_port_common import val_ground_truth

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("fit") / "data", 10,
                        np.random.default_rng(0), hw=(64, 80))


def _cfg(data_yaml, project, **kw):
    base = dict(model_cfg=tiny_icafusion_config(nc=3),
                data_cfg=load_data_config(data_yaml), hyp=load_hyp_config(),
                epochs=1, batch_size=4, imgsz=64, project=str(project),
                workers=2, warmup_min_steps=2, max_targets=16, device="cpu")
    base.update(kw)
    return FitConfig(**base)


def _rows(run):
    with open(Path(run) / "results.csv") as f:
        return list(csv.reader(f))


def test_fit_one_epoch_writes_results_and_checkpoints(data_yaml, tmp_path):
    r = fit(_cfg(data_yaml, tmp_path))
    run = Path(r["run_dir"])
    rows = _rows(run)
    assert rows[0] == RESULTS_HEADER and len(rows) == 2
    assert all(np.isfinite(float(x)) for x in rows[1][1:])
    for f in ("hyp.yaml", "opt.json", "weights/last.ckpt",
              "weights/stripped.ckpt"):
        assert (run / f).is_file(), f
    ckpt = load_checkpoint(run / "weights" / "last.ckpt")
    assert ckpt["meta"]["epoch"] == 0 and ckpt["opt_step"] == 2
    assert set(ckpt) == {"params", "batch_stats", "opt_momentum", "opt_step",
                         "ema_tree", "ema_updates", "rng", "meta"}
    stripped = load_checkpoint(run / "weights" / "stripped.ckpt")
    assert stripped["params"]["m0"]["conv"]["kernel"].dtype == np.float16
    assert {"map50", "best_fitness", "run_dir"} <= set(r)


def test_fit_resumes_and_takes_pretrained(data_yaml, tmp_path):
    first = Path(fit(_cfg(data_yaml, tmp_path, name="a"))["run_dir"])
    resumed = fit(_cfg(data_yaml, tmp_path, name="b", epochs=2,
                       resume=str(first / "weights" / "last.ckpt")))
    rows = _rows(resumed["run_dir"])
    assert [r[0] for r in rows[1:]] == ["1"]          # epoch 0 was done
    ckpt = load_checkpoint(Path(resumed["run_dir"]) / "weights" / "last.ckpt")
    assert ckpt["opt_step"] == 4 and ckpt["meta"]["epoch"] == 1
    pre = fit(_cfg(data_yaml, tmp_path, name="c", multi_scale=True,
                   pretrained=str(first / "weights" / "stripped.ckpt")))
    assert len(_rows(pre["run_dir"])) == 2


def test_cli_train_main(data_yaml, tmp_path):
    r = cli_train.main(["--cfg", "zoo:tiny", "--data", str(data_yaml),
                        "--epochs", "1", "--batch-size", "4", "--img-size",
                        "64", "--project", str(tmp_path), "--device", "cpu",
                        "--workers", "2", "--warmup-min", "2", "--adam",
                        "--accum", "2", "--batch-size", "2", "--freeze",
                        "/m0/", "--noautoanchor", "--single-cls"])
    run = Path(r["run_dir"])
    assert len(_rows(run)) == 2 and (run / "weights" / "last.ckpt").is_file()
    ckpt = load_checkpoint(run / "weights" / "last.ckpt")
    assert set(ckpt["opt_momentum"]) == {"m", "v"}          # Adam
    assert ckpt["params"]["m35"]["m0"]["bias"].shape == (18,)   # nc = 1
    assert cli_train.resolve_accum("auto", 8) == 8
    assert cli_train.resolve_accum(None, 8) == 1


def test_fit_and_trainer_need_a_card_unless_the_cpu_is_asked(data_yaml,
                                                             tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.train.trainer import Trainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(_cfg(data_yaml, tmp_path, device=None))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(build_model(tiny_icafusion_config()), load_hyp_config(), 1,
                1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--cfg", "zoo:tiny", "--data", str(data_yaml),
                        "--project", str(tmp_path)])


@pytest.mark.parametrize("kaist", [False, True])
def test_fit_writes_the_reference_row(data_yaml, tmp_path, monkeypatch,
                                      capsys, kaist):
    """results_format="reference": the reference's header and 29-key row,
    the val losses from the Evaluator's loss_fn. Without kaist_ann the MR
    columns are 0 and, with matplotlib, the curves, results.png and the
    confusion matrix are drawn, with the label distributions and the first
    batches' mosaics; with kaist_ann (a KAIST json of the val
    boxes) each evaluation writes the MR txts and the row its miss rates,
    and here matplotlib is hidden: the plots are skipped and logged."""
    kw = {"results_format": "reference"}
    if kaist:
        kw["kaist_ann"] = str(val_ground_truth(data_yaml, tmp_path / "gt")[0])
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    run = Path(fit(_cfg(data_yaml, tmp_path, **kw))["run_dir"])
    rows = _rows(run)
    assert rows[0] == ["epoch"] + REFERENCE_RESULTS_KEYS and len(rows) == 2
    row = dict(zip(rows[0], (float(x) for x in rows[1])))
    assert all(np.isfinite(v) for v in row.values())
    assert row["val/box_loss"] > 0 and row["val/obj_loss"] > 0
    assert row["val/rank_loss"] == 0 and row["train/rank_loss"] == 0
    assert row["x/lr0"] == row["x/lr1"] == row["x/lr2"] > 0
    mr = [row[k] for k in REFERENCE_RESULTS_KEYS[19:]]
    pngs = {p.name for p in run.glob("*.png")}
    if kaist:
        assert (run / "mr_txt" / "result.txt").is_file()
        # -1: a setup with no ground truth (the 'Reasonable' ones need
        # boxes 55 px tall, taller than these 64 x 80 images hold)
        assert all(v == -1 or 0 <= v <= 1 for v in mr) and max(mr) > 0
        assert not pngs and not list(run.glob("train_batch*.jpg"))
        assert "the plots are skipped" in capsys.readouterr().out
    else:
        assert mr == [0.0] * 10 and not (run / "mr_txt").exists()
        assert {"PR_curve.png", "F1_curve.png", "P_curve.png", "R_curve.png",
                "results.png", "confusion_matrix.png", "labels.png"} <= pngs
        assert (run / "train_batch0.jpg").is_file()


@pytest.mark.parametrize("kw,err,match", [
    # data parallel: no torchrun environment to join, no device
    ({"distributed": True}, ValueError, "RANK expected"),
    ({"n_devices": 0}, ValueError, "n_devices 0 < 1"),
    # stream merging: a count the graph does not have (JAX's words)
    ({"merge_streams": 11}, ValueError, "merge_pairs must be in 1..9")])
def test_unported_fit_options_raise(data_yaml, tmp_path, kw, err, match,
                                    monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(err, match=match):
        fit(_cfg(data_yaml, tmp_path, **kw))


def _jax_forward_of(ckpt, rgb, ir):
    """The JAX package's unmerged tiny model on a checkpoint's inference
    variables (its own loader), decoded predictions."""
    import jax.numpy as jnp

    from icafusion_tpu.models import zoo as jax_zoo
    from icafusion_tpu.models.assembler import build_model as jax_build
    from icafusion_tpu.utils.checkpoint import load_inference_variables
    v = load_inference_variables(str(ckpt))
    return np.asarray(jax_build(jax_zoo.tiny_icafusion_config(nc=3)).apply(
        v, jnp.asarray(rgb), jnp.asarray(ir), train=False, decode=True)[0])


def _port_forward_of(ckpt, rgb, ir):
    from icafusion_tpu_torch.cli._common import load_model_for_inference
    from torch_port_common import nchw
    _, model = load_model_for_inference("zoo:tiny", str(ckpt))
    with torch.no_grad():
        return model(nchw(rgb), nchw(ir)).numpy()


def test_fit_merge_streams_matches_the_unmerged_run(data_yaml, tmp_path):
    """fit(merge_streams=2) trains the merged graph from the same seeded
    init as the unmerged run: its epoch's losses equal the unmerged run's
    (1e-4), its checkpoints hold the standard layout (the unmerged keys,
    values within 1e-4 of the unmerged run's), last.ckpt resumes into an
    unmerged Trainer, and the stripped weights load into the JAX package's
    unmerged model, which predicts what the port's does (1e-4)."""
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.train.trainer import Trainer
    from icafusion_tpu_torch.utils.checkpoint import restore_train_state
    plain = Path(fit(_cfg(data_yaml, tmp_path, name="plain"))["run_dir"])
    merged = Path(fit(_cfg(data_yaml, tmp_path, name="merged",
                           merge_streams=2))["run_dir"])
    a, b = _rows(plain)[1], _rows(merged)[1]
    np.testing.assert_allclose([float(x) for x in b[1:4]],
                               [float(x) for x in a[1:4]], atol=1e-4)
    want = load_checkpoint(plain / "weights" / "last.ckpt")
    got = load_checkpoint(merged / "weights" / "last.ckpt")
    assert "m0" in got["params"] and "m0_9" not in got["params"]
    for k in ("params", "batch_stats", "opt_momentum", "ema_tree"):
        flat_w = dict(_flat(want[k]))
        flat_g = dict(_flat(got[k]))
        assert flat_g.keys() == flat_w.keys(), k
        for p, w in flat_w.items():
            np.testing.assert_allclose(flat_g[p], w, atol=1e-4,
                                       err_msg=f"{k}/{p}")
    tr = Trainer(build_model(tiny_icafusion_config(nc=3)), load_hyp_config(),
                 1, 2, 4, imgsz=64, device="cpu")
    restore_train_state(got, tr)
    assert tr.opt.step == got["opt_step"] == 2
    rng = np.random.default_rng(0)
    rgb, ir = (rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
               for _ in range(2))
    stripped = merged / "weights" / "stripped.ckpt"
    np.testing.assert_allclose(_port_forward_of(stripped, rgb, ir),
                               _jax_forward_of(stripped, rgb, ir),
                               rtol=1e-4, atol=1e-4)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


@pytest.mark.parametrize("flag", [["--evolve", "2"], ["--merge-streams", "2"]])
def test_unported_cli_flags_raise(data_yaml, tmp_path, flag):
    """The two flags the CLI refused before they were ported, now run
    against the JAX package. --evolve 2 --epochs 1: two generations write
    <project>/evolve.csv, byte-equal to the log JAX's evolve() writes when
    fed the port's fitness values (so every candidate is JAX's), and
    hyp_evolved.yaml holds the best of them, JAX's best. --merge-streams 2
    trains the merged graph, and its checkpoint serves in the JAX
    package's unmerged model as in the port's (1e-4)."""
    import yaml

    project = tmp_path / "p"
    out = cli_train.main(["--cfg", "zoo:tiny", "--data", str(data_yaml),
                          "--epochs", "1", "--batch-size", "4",
                          "--img-size", "64", "--project", str(project),
                          "--device", "cpu", "--workers", "2",
                          "--warmup-min", "2", *flag])
    if flag[0] == "--evolve":
        from icafusion_tpu.config import HypConfig as JaxHyp
        from icafusion_tpu.train.evolve import evolve as jax_evolve
        log = (project / "evolve.csv").read_text().splitlines()
        assert len(log) == 3                   # the header and two rows
        fits = [float(r.split(",")[0]) for r in log[1:]]
        jlog = tmp_path / "jax_evolve.csv"
        best = jax_evolve(lambda h: fits.pop(0), JaxHyp(), generations=2,
                          log_path=str(jlog), seed=0)
        assert (project / "evolve.csv").read_text() == jlog.read_text()
        assert out.as_dict() == best.as_dict()
        assert yaml.safe_load((project / "hyp_evolved.yaml").read_text()
                              ) == best.as_dict()
        assert len(list(project.glob("exp_evolve*"))) == 2
        return
    run = Path(out["run_dir"])
    ckpt = run / "weights" / "last.ckpt"
    assert "m0_9" not in load_checkpoint(ckpt)["params"]
    rng = np.random.default_rng(1)
    rgb, ir = (rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
               for _ in range(2))
    np.testing.assert_allclose(_port_forward_of(ckpt, rgb, ir),
                               _jax_forward_of(ckpt, rgb, ir), rtol=1e-4,
                               atol=1e-4)


def test_epoch_meter_is_the_mean():
    m = EpochMeter()
    for i in range(4):
        m.add({k: torch.tensor(float(i)) for k in EpochMeter.KEYS})
    np.testing.assert_allclose(m.means(), [1.5] * 4)
    assert (EpochMeter().means() == 0).all()
