"""Reference .pt checkpoints through icafusion_tpu_torch (utils/torch_convert,
cli/_common.load_model_for_inference, fit's pretrained) against the JAX
package's utils/torch_convert, and fit's TensorBoard scalars (utils/loggers).

No reference checkpoint is fetched: the reference-named state dicts are the
JAX package's reverse_convert of flax variables drawn from a numpy seed,
written with torch.save under tmp_path in the dict layouts the reference
and its tools write (a plain state dict, {"model": sd}, {"ema": sd,
"model": other}) and in float16, as the reference's trainer saves them."""

import csv
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.config import load_model_config as jax_load_model_config
from icafusion_tpu.models import build_model as jax_build_model
from icafusion_tpu.models.zoo import icafusion_config as jax_icafusion_config
from icafusion_tpu.models.zoo import tiny_icafusion_config as jax_tiny
from icafusion_tpu.utils import torch_convert as jax_tc
from icafusion_tpu_torch.cli import _common, val
from icafusion_tpu_torch.config import (load_data_config, load_hyp_config,
                                        load_model_config)
from icafusion_tpu_torch.data.synthetic import make_dataset
from icafusion_tpu_torch.models.assembler import build_model
from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
from icafusion_tpu_torch.train import fit as fit_mod
from icafusion_tpu_torch.utils import torch_convert as tc
from icafusion_tpu_torch.utils.checkpoint import msgpack_serialize
from icafusion_tpu_torch.utils.convert import (flax_paths, load_jax_variables,
                                               to_jax_variables)
from icafusion_tpu_torch.smoke.reference import kitchen_sink_yaml
from icafusion_tpu_torch.utils.loggers import Loggers
from torch_port_common import nchw, random_variables

torch.set_num_threads(1)

PX = 64
FORMS = ("state_dict", "model", "ema", "fp16")


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, drawn variables, the JAX reverse_convert of them)."""
    jm = jax_build_model(jax_tiny())
    x = jnp.zeros((1, PX, PX, 3), jnp.float32)
    v = random_variables(jm, x, x, train=False)
    return jm, v, jax_tc.reverse_convert(v)


def _save(sd, path: Path, form: str) -> Path:
    """torch.save of a reference state dict in one of FORMS; "ema" puts a
    decoy under "model", which the loader must not take."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    if form == "state_dict":
        obj = t
    elif form == "model":
        obj = {"model": t, "epoch": 3}
    elif form == "ema":
        obj = {"ema": t, "model": {k: torch.zeros_like(v)
                                   for k, v in t.items()}}
    else:
        obj = {"ema": {k: v.half() for k, v in t.items()}, "model": None,
               "optimizer": None, "epoch": -1}
    torch.save(obj, path)
    return path


def test_translate_matches_jax(tiny):
    """Every flax path of the tiny, kitchen-sink, VGG16 and ResNet50 models
    names the same reference key in both packages."""
    from icafusion_tpu_torch.models.zoo import (resnet50_icafusion_config,
                                                vgg16_icafusion_config)
    models = [build_model(tiny_icafusion_config()),
              build_model(load_model_config(kitchen_sink_yaml())),
              build_model(vgg16_icafusion_config()),
              build_model(resnet50_icafusion_config())]
    n = 0
    for m in models:
        for _, path in flax_paths(m).values():
            assert tc._translate(path) == jax_tc._translate(path), path
            n += 1
    assert n > 1000


@pytest.mark.parametrize("form", FORMS)
def test_load_torch_checkpoint_forms(tiny, tmp_path, form):
    """Each layout loads to the EMA (or only) state dict, float32, as the
    JAX loader reads it."""
    _, _, sd = tiny
    path = _save(sd, tmp_path / f"{form}.pt", form)
    got = tc.load_torch_checkpoint(str(path))
    want = jax_tc.load_torch_checkpoint(str(path))
    assert got.keys() == want.keys() == sd.keys()
    for k in sd:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k].astype(np.float32))
        ref = sd[k].astype(np.float16) if form == "fp16" else sd[k]
        np.testing.assert_array_equal(got[k], ref.astype(np.float32))


def test_load_model_for_inference_pt_matches_jax(tiny, tmp_path):
    """The port's model read from a .pt, in every layout, equals the JAX
    model on convert_state_dict of the same file, forward for forward
    (fp32: rtol 1e-4, atol 1e-3 in pixels, as the serving tests)."""
    jm, v, sd = tiny
    rng = np.random.default_rng(1)
    rgb, ir = (rng.random((2, PX, PX, 3), np.float32) for _ in range(2))
    apply = jax.jit(lambda var: jm.apply(var, jnp.asarray(rgb),
                                         jnp.asarray(ir), train=False,
                                         decode=True)[0])
    for form in FORMS:
        path = _save(sd, tmp_path / f"{form}.pt", form)
        mc, model = _common.load_model_for_inference("zoo:tiny", str(path))
        assert not model.training
        jv, unused = jax_tc.convert_state_dict(
            jax_tc.load_torch_checkpoint(str(path)), v, strict=False)
        assert unused == []
        np.testing.assert_array_equal(
            tc.reverse_convert(model)["model.0.conv.weight"],
            jax_tc.reverse_convert(jv)["model.0.conv.weight"])
        if form not in ("state_dict", "fp16"):
            continue            # "model" and "ema" read the same tensors
        want = np.asarray(apply(jv))
        with torch.no_grad():
            got = model(nchw(rgb), nchw(ir)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_convert_state_dict_round_trip_and_strictness(tiny):
    """reverse_convert then convert_state_dict restores every tensor; a
    missing key raises when strict and keeps the init otherwise; unused
    keys are those JAX reports."""
    _, v, sd = tiny
    model = load_jax_variables(build_model(tiny_icafusion_config()), v)
    fresh = build_model(tiny_icafusion_config())
    _, unused = tc.convert_state_dict(tc.reverse_convert(model), fresh)
    assert unused == []
    for k, t in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(fresh.state_dict()[k], t, rtol=0,
                                       atol=0)
    extra = dict(sd, **{"model.0.bn.num_batches_tracked": np.int64(5),
                        "model.25.anchors": np.ones((3, 3, 2), np.float32),
                        "model.99.stray.weight": np.ones(3, np.float32)})
    short = {k: a for k, a in extra.items() if k != "model.3.bn.running_var"}
    with pytest.raises(KeyError, match="model.3.bn.running_var"):
        tc.convert_state_dict(short, build_model(tiny_icafusion_config()))
    fresh = build_model(tiny_icafusion_config())
    before = fresh.m3.bn.running_var.clone()
    _, unused = tc.convert_state_dict(short, fresh, strict=False)
    torch.testing.assert_close(fresh.m3.bn.running_var, before)
    _, jax_unused = jax_tc.convert_state_dict(short, v, strict=False)
    assert unused == jax_unused == ["model.99.stray.weight"]


@pytest.mark.parametrize("graph", ["tiny", "kitchen_sink"])
def test_reverse_convert_matches_jax(tiny, graph):
    """Key for key and value for value, with and without ``like`` (dead
    keys copied from it, its shapes taken, a key it has and the model does
    not raises)."""
    if graph == "tiny":
        _, v, _ = tiny
        cfg = tiny_icafusion_config()
    else:
        cfg = load_model_config(kitchen_sink_yaml())
        jm = jax_build_model(jax_load_model_config(kitchen_sink_yaml()))
        x = jnp.zeros((1, PX, PX, 3), jnp.float32)
        with jax.ensure_compile_time_eval():   # MixConv2d's linspace
            v = random_variables(jm, x, x, train=False)
    model = load_jax_variables(build_model(cfg), v)
    want = jax_tc.reverse_convert(v)
    got = tc.reverse_convert(model)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    like = {k: np.zeros(a.shape, np.float32) for k, a in want.items()}
    like.update({"model.0.bn.num_batches_tracked": np.array(7),
                 "model.1.conv.ln_input.weight": np.ones(4, np.float32)})
    key = next(k for k in like if k.endswith("bn.weight"))
    like[key] = like[key][None]                        # a (1, c) template
    got, want = tc.reverse_convert(model, like), jax_tc.reverse_convert(v,
                                                                        like)
    assert got.keys() == want.keys() == like.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got[key].shape == like[key].shape
    like["model.1.conv.extra.weight"] = np.zeros(3, np.float32)
    for fn, arg in ((tc.reverse_convert, model), (jax_tc.reverse_convert, v)):
        with pytest.raises(KeyError, match="did not produce"):
            fn(arg, like)


@pytest.fixture(scope="module")
def n_scale():
    """(drawn variables of yolov5n-Transfusion, their JAX reverse_convert):
    the CSPDarknet towers of 10 rows that the stream remap assumes."""
    jm = jax_build_model(jax_icafusion_config("n", nc=3, fusion="tfb"))
    x = jnp.zeros((1, 320, 320, 3), jnp.float32)
    v = random_variables(jm, x, x, train=False)
    return v, jax_tc.reverse_convert(v)


def _single_stream(sd):
    """A single-stream reference state dict: only model.0-9, with model.2
    cut so that a tensor keeps its init."""
    return {k: a for k, a in sd.items() if int(k.split(".")[1]) < 10
            and not k.startswith("model.2.")}


def test_remap_single_stream_matches_jax(n_scale):
    single = _single_stream(n_scale[1])
    got = tc.remap_single_stream_to_two_stream(single)
    want = jax_tc.remap_single_stream_to_two_stream(single)
    assert got.keys() == want.keys()
    assert all(got[k] is want[k] for k in want)
    assert got["model.10.conv.weight"] is single["model.0.conv.weight"]
    assert len(got) == 2 * len(single)


def test_pretrained_pt_remaps_onto_both_towers(n_scale, tmp_path, capsys):
    """fit's _load_pretrained on a single-stream yolov5n .pt fills
    model.0-9 and their IR twins 10-19 as the JAX package's
    _load_pretrained does (remap, then convert_state_dict(strict=False));
    the rest keep the init, the fusion gains too (the JAX converter would
    raise on their absence, so it is handed the init's)."""
    from icafusion_tpu_torch.models.zoo import icafusion_config
    v, sd = n_scale
    path = _save(_single_stream(sd), tmp_path / "single.pt", "ema")
    cfg = icafusion_config("n", nc=3, fusion="tfb")
    init = build_model(cfg, generator=torch.Generator().manual_seed(3))
    model = build_model(cfg)
    model.load_state_dict(init.state_dict())
    fit_mod._load_pretrained(str(path), model)
    said = capsys.readouterr().out
    assert re.search(r"pretrained: converted .*single\.pt \(0 unused ref "
                     r"keys\)", said), said
    jsd = jax_tc.remap_single_stream_to_two_stream(
        jax_tc.load_torch_checkpoint(str(path)))
    jsd.update({k: a for k, a in tc.reverse_convert(init).items()
                if ".coefficient" in k})
    start = to_jax_variables(init)
    want, _ = jax_tc.convert_state_dict(jsd, start, strict=False)
    got = to_jax_variables(model)
    for c in ("params", "batch_stats"):
        w = dict(jax.tree_util.tree_flatten_with_path(want[c])[0])
        g = dict(jax.tree_util.tree_flatten_with_path(got[c])[0])
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], np.asarray(w[k]),
                                          err_msg=str(k))
    now, before = model.state_dict(), init.state_dict()
    torch.testing.assert_close(now["m10.conv.weight"], now["m0.conv.weight"])
    assert not torch.equal(now["m0.conv.weight"], before["m0.conv.weight"])
    torch.testing.assert_close(now["m12.cv1.conv.weight"],
                               before["m12.cv1.conv.weight"])


def test_missing_pt_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="nope.pt"):
        _common.load_model_for_inference("zoo:tiny", str(tmp_path / "nope.pt"))
    with pytest.raises(FileNotFoundError, match="nope.pt"):
        fit_mod.fit(fit_mod.FitConfig(
            model_cfg=tiny_icafusion_config(), data_cfg=None,
            hyp=load_hyp_config(), pretrained=str(tmp_path / "nope.pt"),
            project=str(tmp_path / "runs"), device="cpu"))
    assert not (tmp_path / "runs").exists()


@pytest.fixture(scope="module")
def val_setup(tmp_path_factory, tiny):
    """(data yaml, the tiny model's .ckpt, the same weights as a .pt)."""
    root = tmp_path_factory.mktemp("ptval")
    data = make_dataset(root / "data", 12, np.random.default_rng(0),
                        hw=(64, 80))
    _, v, sd = tiny
    model = load_jax_variables(build_model(tiny_icafusion_config()), v)
    ckpt = root / "tiny.ckpt"
    ckpt.write_bytes(msgpack_serialize({**to_jax_variables(model),
                                        "meta": {"epoch": 0}}))
    return data, ckpt, _save(sd, root / "tiny.pt", "model")


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_cli_val_pt_equals_ckpt(val_setup, tmp_path, int8):
    """python -m icafusion_tpu_torch.cli.val with --weights x.pt scores
    exactly as with the .ckpt of the same weights, in fp32 and --int8
    (each calibrating on the same val batches)."""
    data, ckpt, pt = val_setup
    out = {}
    for w in (ckpt, pt):
        argv = ["--weights", str(w), "--cfg", "zoo:tiny", "--data",
                str(data), "--img-size", "64", "--batch-size", "2",
                "--device", "cpu", "--conf-thres", "0.01", "--save-dir",
                str(tmp_path / w.suffix[1:])]
        if int8:
            argv.append("--int8")
        out[w.suffix] = val.main(argv)
    for k in ("seen", "mp", "mr", "map50", "map"):
        assert out[".pt"][k] == out[".ckpt"][k], k


TAGS = {"train/box_loss": "lbox", "train/obj_loss": "lobj",
        "train/cls_loss": "lcls", "metrics/precision": "P",
        "metrics/recall": "R", "metrics/mAP_0.5": "mAP50",
        "metrics/mAP_0.5:0.95": "mAP", "x/lr": "lr"}


def test_fit_from_pt_writes_tensorboard_scalars(tiny, tmp_path, capsys):
    """One epoch of the tiny fit from a reference .pt in the trainer's
    fp16 layout: the unused-key count is logged, and the nine scalars land
    in TensorBoard with
    results.csv's values (to the csv's 5 decimals, the lr's 6);
    train/loss is the reference's total."""
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    _, _, sd = tiny
    pt = _save(sd, tmp_path / "tiny.pt", "fp16")
    data = make_dataset(tmp_path / "data", 10, np.random.default_rng(0),
                        hw=(64, 80))
    r = fit_mod.fit(fit_mod.FitConfig(
        model_cfg=tiny_icafusion_config(nc=3),
        data_cfg=load_data_config(data), hyp=load_hyp_config(), epochs=1,
        batch_size=4, imgsz=64, project=str(tmp_path / "runs"), workers=2,
        warmup_min_steps=2, max_targets=16, device="cpu",
        pretrained=str(pt)))
    assert "(0 unused ref keys)" in capsys.readouterr().out
    run = Path(r["run_dir"])
    with open(run / "results.csv") as f:
        row = list(csv.DictReader(f))[0]
    ea = EventAccumulator(str(run / "tb"))
    ea.Reload()
    assert set(ea.Tags()["scalars"]) == set(TAGS) | {"train/loss"}
    for tag, col in TAGS.items():
        (ev,) = ea.Scalars(tag)
        assert ev.step == 0
        assert ev.value == pytest.approx(float(row[col]), abs=1e-5), tag
    (loss,) = ea.Scalars("train/loss")
    parts = sum(ea.Scalars(t)[0].value for t in ("train/box_loss",
                                                 "train/obj_loss",
                                                 "train/cls_loss"))
    # the reference's loss: the sum of the three, times the batch size
    assert loss.value == pytest.approx(4 * parts, rel=1e-5)


def test_loggers_without_tensorboard(tmp_path, monkeypatch):
    """Where torch.utils.tensorboard does not import, the writer is None
    and every call is a no-op; enable_tb=False (ranks other than 0) makes
    none."""
    import builtins
    real = builtins.__import__

    def no_tb(name, *a, **k):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tb)
    lg = Loggers(tmp_path)
    assert lg.tb is None
    lg.log_scalars({"a": 1.0}, 0)
    lg.log_image("img", np.zeros((4, 4, 3), np.uint8), 0)
    lg.close()
    assert Loggers(tmp_path, enable_tb=False).tb is None
    assert not (tmp_path / "tb").exists()
