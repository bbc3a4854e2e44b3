"""The port's data-parallel training over several processes on the CPU:
two gloo ranks (parallel/mesh.spawn), each holding half of every global
batch, against the port's single process on the whole batch and against
the JAX package's train step jitted over a 2-device mesh; fit and
cli.train over two local ranks and under torchrun; a failing rank.

Every rank and subprocess runs one thread (OMP_NUM_THREADS=1); the ranks
import this module, so it imports JAX inside the tests only. Dropout is
off on both sides (flax.linen.Dropout is the identity inside these tests;
the port's p is 0), since the JAX package draws one mask over the global
batch and the ranks draw their own.

Tolerances. BatchNorm and the loss on two ranks against one process: fp32
sums in another order, 1e-5. Trainer steps: those of
tests/test_torch_port_trainer.py (losses 1e-4 relative, first gradients
2e-3 of their tensor's scale, weights and statistics 1e-3), whose
docstring gives why BatchNorm over a few values a channel magnifies fp32
rounding; against the single process the ranks' BatchNorm also sums in
another order. fit: dropout is on there, and the ranks draw other masks
than the single process, so per-epoch losses are held within 2e-2
relative (measured 0.5 %); two ranks started by fit and by torchrun draw
the same masks and agree to the printed digits.
"""

import csv
import os
import socket
import subprocess
import sys
import time
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from icafusion_tpu_torch.cli import train as cli_train
from icafusion_tpu_torch.config import load_hyp_config
from icafusion_tpu_torch.data.synthetic import make_dataset
from icafusion_tpu_torch.models.assembler import (anchors_grid_units,
                                                  build_model, init_weights)
from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
from icafusion_tpu_torch.nn.fusion import Dropout
from icafusion_tpu_torch.nn.layers import BN_EPS, BN_MOMENTUM, BatchNorm2d
from icafusion_tpu_torch.parallel import mesh
from icafusion_tpu_torch.train.loss import YoloLoss
from icafusion_tpu_torch.train.trainer import Trainer
from icafusion_tpu_torch.utils.convert import (flax_tree, load_jax_variables,
                                               to_jax_variables)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
PX = 64                   # torch_port_common.TRAIN_SIZE
JOIN_S = 120              # every spawned run is bounded by this
LOSS_RTOL = 1e-4
GRAD_RTOL = 2e-3
STATE_ATOL = 1e-3
FIT_RTOL = 2e-2


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """Ranks and subprocesses start with one intra-op thread."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _gather(obj):
    """Every rank's ``obj``, in rank order (on every rank)."""
    out = [None] * mesh.world()
    dist.all_gather_object(out, obj)
    return out


# ---- BatchNorm and the loss --------------------------------------------------


def _bn_loss_rank(x, g, w, b, preds, targets, mask):
    torch.set_num_threads(1)
    lo, hi = mesh.process_batch_slice(len(x))
    bn = BatchNorm2d(x.shape[1], eps=BN_EPS, momentum=BN_MOMENTUM).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    xr = torch.from_numpy(x[lo:hi]).requires_grad_()
    y = bn(xr)
    (y * torch.from_numpy(g[lo:hi])).sum().backward()

    cfg = tiny_icafusion_config(nc=3)
    loss_fn = YoloLoss(hyp=load_hyp_config(), nc=3,
                       anchors=anchors_grid_units(cfg))
    ps = [torch.from_numpy(p[lo:hi]).requires_grad_() for p in preds]
    loss, items = loss_fn(ps, torch.from_numpy(targets[lo:hi]),
                          torch.from_numpy(mask[lo:hi]))
    loss.backward()
    total = torch.cat([loss.detach()[None], items.detach()])
    dist.all_reduce(total)
    return _gather({"y": y.detach().numpy(), "dx": xr.grad.numpy(),
                    "mean": bn.running_mean.numpy(),
                    "var": bn.running_var.numpy(),
                    "loss": total.numpy(),
                    "dp": [p.grad.numpy() for p in ps]})


def _loss_inputs(rng):
    """Raw maps of the tiny model at 64 px (B 4, 3 anchors, 5 + 3 values)
    and targets where rows 2 and 3 (rank 1's) have none."""
    preds = [rng.normal(0, 1.5, (4, s, s, 3, 8)).astype(np.float32)
             for s in (8, 4, 2)]
    from torch_port_common import train_batch
    _, targets, mask = train_batch(4)[1:]
    mask = mask.copy()
    mask[2:] = False
    return preds, targets, mask


def test_batchnorm_and_loss_over_two_ranks():
    """Two ranks of a global batch of 4: BatchNorm's output, input gradient
    and running statistics equal one process on the whole batch (and the
    statistics are equal bit for bit across the ranks); YoloLoss's shares
    sum to JAX's loss on the global batch, rank 1 holding no target, and
    each rank's gradient of its share is JAX's gradient of the global
    loss."""
    import jax
    import jax.numpy as jnp
    from icafusion_tpu.config import load_hyp_config as jax_hyp
    from icafusion_tpu.models import zoo as jax_zoo
    from icafusion_tpu.models.assembler import (
        anchors_grid_units as jax_anchors)
    from icafusion_tpu.train.loss import YoloLoss as JaxYoloLoss
    rng = np.random.default_rng(0)
    x = (rng.normal(0, 2, (4, 8, 5, 6)) + 1).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    b = rng.normal(0, 0.1, 8).astype(np.float32)
    preds, targets, mask = _loss_inputs(rng)
    ranks = mesh.spawn(_bn_loss_rank, WORLD,
                       (x, g, w, b, preds, targets, mask), timeout=JOIN_S)

    bn = BatchNorm2d(8, eps=BN_EPS, momentum=BN_MOMENTUM).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(g)).sum().backward()
    got = {k: np.concatenate([r[k] for r in ranks]) for k in ("y", "dx")}
    np.testing.assert_allclose(got["y"], y.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(got["dx"], xt.grad.numpy(), atol=1e-5)
    for k, want in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
        np.testing.assert_allclose(ranks[0][k], want.numpy(), atol=1e-6)

    jloss = JaxYoloLoss(hyp=jax_hyp(), nc=3, anchors=jax_anchors(
        jax_zoo.tiny_icafusion_config(nc=3)))

    def total(ps):
        return jloss([jnp.asarray(p) for p in ps], jnp.asarray(targets),
                     jnp.asarray(mask))

    (want_loss, want_items), want_dp = jax.jit(jax.value_and_grad(
        total, has_aux=True))(preds)
    np.testing.assert_allclose(ranks[0]["loss"], np.concatenate(
        [[want_loss], want_items]), rtol=1e-5, atol=1e-7)
    assert want_items[0] > 0
    for i, w_dp in enumerate(want_dp):
        dp = np.concatenate([r["dp"][i] for r in ranks])
        np.testing.assert_allclose(dp, np.asarray(w_dp), rtol=1e-4,
                                   atol=1e-6 * np.abs(w_dp).max())
    assert not np.abs(ranks[1]["dp"][0][..., :4]).any()  # no box target there


# ---- Trainer -------------------------------------------------------------------


def _trainer(variables, B, accum):
    """The port's Trainer of the tiny model holding ``variables``, dropout
    off (torch_port_common.no_dropout)."""
    model = load_jax_variables(build_model(tiny_icafusion_config()),
                               variables)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return Trainer(model=model, hyp=load_hyp_config(), epochs=3,
                   steps_per_epoch=1, batch_size=B, imgsz=PX,
                   warmup_min_steps=2, accum_steps=accum, device="cpu")


def _steps(tr, data, steps, rows=None):
    """(metrics of each step, momentum after the first in flax layout,
    final params and batch_stats in flax layout, the whole state flat)."""
    rows = np.arange(len(data[0])) if rows is None else rows
    tdata = [_nchw(data[0][rows]), _nchw(data[1][rows]),
             torch.from_numpy(data[2][rows]), torch.from_numpy(data[3][rows])]
    step = tr.make_train_step()
    metrics, first = [], None
    for i in range(steps):
        metrics.append({k: float(v) for k, v in step(*tdata).items()})
        if i == 0:
            first = flax_tree(tr.model, tr.opt.momentum)
    sd = tr.model.state_dict()
    flat = torch.cat([t.detach().reshape(-1).double() for t in
                      [*sd.values(), *tr.opt.momentum.values(),
                       *tr.ema.tree.values()]]).numpy()
    return (metrics, first, flax_tree(tr.model, sd),
            flax_tree(tr.model, sd, "batch_stats"), flat)


def _trainer_rank(variables, data, B, accum, steps):
    torch.set_num_threads(1)
    tr = _trainer(variables, B, accum)
    return _gather(_steps(tr, data, steps, mesh.process_rows(B, accum)))


def _leaves(tree, prefix=()):
    """{path: array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _assert_grads(got, want):
    """Tensor by tensor within GRAD_RTOL of the tensor's largest gradient
    plus a tenth of the largest of all."""
    g, w = _leaves(got), _leaves(want)
    top = max(float(np.abs(np.asarray(v)).max()) for v in w.values())
    for p, v in w.items():
        v = np.asarray(v)
        assert np.abs(g[p] - v).max() <= GRAD_RTOL * (np.abs(v).max()
                                                      + top / 10), p


def _max_diff(got, want):
    g = _leaves(got)
    return max(float(np.abs(np.asarray(v) - g[p]).max())
               for p, v in _leaves(want).items())


def _assert_run(got, want):
    """Two Trainer runs (_steps' tuples) agree within the stated
    tolerances."""
    for a, b in zip(got[0], want[0]):
        for k in ("loss", "lbox", "lobj", "lcls"):
            assert a[k] == pytest.approx(b[k], rel=LOSS_RTOL), k
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
    _assert_grads(got[1], want[1])
    assert _max_diff(got[2], want[2]) <= STATE_ATOL
    assert _max_diff(got[3], want[3]) <= STATE_ATOL


@pytest.fixture(scope="module")
def three_steps():
    """(JAX metrics, first-step momentum and states of the train step jitted
    over a 2-device mesh; the two ranks' runs; the single process's run),
    three steps on one global batch of 4 from the JAX Trainer's init."""
    import flax.linen as flax_nn
    import jax
    import jax.numpy as jnp
    from icafusion_tpu.config import load_hyp_config as jax_hyp
    from icafusion_tpu.models import zoo as jax_zoo
    from icafusion_tpu.models.assembler import build_model as jax_build_model
    from icafusion_tpu.parallel import mesh as jax_mesh
    from icafusion_tpu.train.trainer import Trainer as JaxTrainer
    from torch_port_common import NoDropout, train_batch
    B = 4
    jtr = JaxTrainer(model=jax_build_model(jax_zoo.tiny_icafusion_config()),
                     hyp=jax_hyp(), epochs=3, steps_per_epoch=1, batch_size=B,
                     imgsz=PX, warmup_min_steps=2)
    data = train_batch(B)
    state = jtr.init_state(jax.random.PRNGKey(0), data[0][:1], data[1][:1])
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    m = jax_mesh.make_mesh(2)
    repl = jax.sharding.NamedSharding(m, jax.sharding.PartitionSpec())
    shard = jax_mesh.batch_sharding(m)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn, "Dropout", NoDropout)
        jstep = jax.jit(jtr.make_train_step(),
                        in_shardings=(repl,) + (shard,) * 4,
                        out_shardings=(repl, repl)).lower(
            state, *(jnp.asarray(a) for a in data)).compile()
    ranks = mesh.spawn(_trainer_rank, WORLD, (variables, data, B, 1, 3),
                       timeout=JOIN_S)
    jm, jstates = [], []
    for _ in range(3):
        state, met = jstep(state, *(jnp.asarray(a) for a in data))
        jstates.append(jax.device_get(state))
        jm.append({k: float(v) for k, v in met.items()})
    single = _steps(_trainer(variables, B, 1), data, 3)
    return jm, jstates, ranks, single


def test_two_ranks_match_single_process(three_steps):
    """Losses of each step, first-step gradients, final weights and
    BatchNorm statistics: each rank against the single process on the
    global batch; and the whole state (weights, statistics, momentum, EMA)
    equal bit for bit across the ranks."""
    _, _, ranks, single = three_steps
    for r in ranks:
        _assert_run(r, single)
    np.testing.assert_array_equal(ranks[0][4], ranks[1][4])


def test_two_ranks_match_jax_step_over_two_devices(three_steps):
    """Rank 0's three steps against JAX's train step over a 2-device mesh:
    losses, first-step gradients (the momentum after one step), weights and
    BatchNorm statistics."""
    jm, jstates, ranks, _ = three_steps
    _assert_run(ranks[0], (jm, jstates[0].opt.momentum, jstates[-1].params,
                           jstates[-1].batch_stats))


def test_two_ranks_accum_2_match_single_process():
    """accum_steps 2, microbatches of 2: each rank holds one row of each
    microbatch (process_rows), and two steps equal the single process's
    on the same 4 rows."""
    from torch_port_common import train_batch
    variables = to_jax_variables(init_weights(
        build_model(tiny_icafusion_config()), torch.Generator().manual_seed(7)))
    data = train_batch(4, seed=3)
    ranks = mesh.spawn(_trainer_rank, WORLD, (variables, data, 2, 2, 2),
                       timeout=JOIN_S)
    assert mesh.process_rows(2, 2, 1, 2).tolist() == [1, 3]
    single = _steps(_trainer(variables, 2, 2), data, 2)
    for r in ranks:
        _assert_run(r, single)
    np.testing.assert_array_equal(ranks[0][4], ranks[1][4])


# ---- fit and cli.train -------------------------------------------------------------


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("dist") / "data", 10,
                        np.random.default_rng(0), hw=(64, 80))


def _train_args(data_yaml, project, name):
    return ["--cfg", "zoo:tiny", "--data", str(data_yaml), "--img-size", "64",
            "--batch-size", "4", "--epochs", "2", "--device", "cpu",
            "--warmup-min", "2", "--workers", "2", "--project", str(project),
            "--name", name]


def _losses(run):
    with open(Path(run) / "results.csv") as f:
        rows = list(csv.DictReader(f))
    return np.array([[float(r[k]) for k in ("lbox", "lobj", "lcls")]
                     for r in rows])


@pytest.fixture(scope="module")
def two_rank_fit(data_yaml, tmp_path_factory):
    """cli.train --devices 2 and --devices 1: (project, two-rank run dir,
    one-process run dir)."""
    project = tmp_path_factory.mktemp("runs")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        two = cli_train.main(_train_args(data_yaml, project, "two")
                             + ["--devices", "2"])
    one = cli_train.main(_train_args(data_yaml, project, "one")
                         + ["--devices", "1"])
    return project, Path(two["run_dir"]), Path(one["run_dir"])


def test_fit_two_ranks_writes_once_and_matches_one(two_rank_fit):
    """fit over two local ranks (cli.train --devices 2): per-epoch losses
    close to one process's; rank 0 alone wrote the run's files (one header
    and one row an epoch, one cache directory a rank); the checkpoint reads
    back in the JAX package's reader at the step count of 2 epochs of 2
    global batches."""
    from icafusion_tpu.utils import checkpoint as jax_checkpoint
    _, two, one = two_rank_fit
    got, want = _losses(two), _losses(one)
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL)
    assert len((two / "results.csv").read_text().splitlines()) == 3
    assert sorted(p.name for p in two.iterdir() if p.name.startswith(
        ".cache")) == [".cache_p0", ".cache_p1"]
    assert {"hyp.yaml", "opt.json", "weights"} <= {p.name
                                                   for p in two.iterdir()}
    ckpt = jax_checkpoint.load_checkpoint(str(two / "weights" / "last.ckpt"))
    assert int(ckpt["opt_step"]) == 4 and ckpt["meta"]["epoch"] == 1
    mine = jax_checkpoint.load_checkpoint(str(one / "weights" / "last.ckpt"))
    assert _leaves(ckpt["params"]).keys() == _leaves(mine["params"]).keys()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_fit_distributed_under_torchrun(two_rank_fit, data_yaml):
    """python -m torch.distributed.run --nproc-per-node 2 -m
    icafusion_tpu_torch.cli.train --distributed: the env:// group of a
    torchrun launch; the same losses as fit's own two ranks."""
    project, two, _ = two_rank_fit
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get(
               "PYTHONPATH", "")])}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc-per-node", "2", "--master-addr", "localhost",
           "--master-port", str(_free_port()), "-m",
           "icafusion_tpu_torch.cli.train", "--distributed",
           *_train_args(data_yaml, project, "torchrun")]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=JOIN_S)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("done: mAP50=") == 1, out.stdout
    run = project / "torchrun"
    np.testing.assert_allclose(_losses(run), _losses(two), atol=2e-5)


# ---- failures ------------------------------------------------------------------------


def test_fit_raises_when_one_rank_fails(tmp_path):
    """The image in row 2 of the first global batch is unreadable, and only
    rank 1 reads it (mosaic off, autoanchor off: no other rank opens it):
    fit over two ranks raises with rank 1's error while rank 0 waits in a
    collective, well within the time a run is given."""
    from icafusion_tpu_torch.config import load_data_config
    from icafusion_tpu_torch.data.datasets import discover_images
    from icafusion_tpu_torch.train.fit import FitConfig, fit
    y = make_dataset(tmp_path / "data", 10, np.random.default_rng(0),
                     hw=(64, 80))
    dc = load_data_config(y)
    files = discover_images(str(Path(dc.path) / dc.train_rgb))
    order = np.arange(len(files))
    np.random.default_rng(0).shuffle(order)      # PairedLoader's epoch 0
    Path(files[order[2]]).write_bytes(b"not an image")
    cfg = FitConfig(model_cfg=tiny_icafusion_config(nc=3), data_cfg=dc,
                    hyp=load_hyp_config().replace(mosaic=0.0), epochs=1,
                    batch_size=4, imgsz=64, project=str(tmp_path / "runs"),
                    workers=2, warmup_min_steps=2, max_targets=16,
                    autoanchor=False, n_devices=2, device="cpu")
    t = time.monotonic()
    with pytest.raises(RuntimeError,
                       match=r"^rank 1 failed:(.|\n)*unreadable"):
        fit(cfg)
    assert time.monotonic() - t < JOIN_S


def _failing_rank(how):
    if mesh.rank() == 1:
        if how == "raise":
            raise ValueError("rank one gives up")
        os._exit(3)
    mesh.barrier()            # rank 0 waits for a rank that never comes


@pytest.mark.parametrize("how,match", [
    ("raise", r"rank 1 failed:(.|\n)*rank one gives up"),
    ("exit", "rank 1 exited with code 3")])
def test_a_failing_rank_fails_the_call(how, match):
    t = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        mesh.spawn(_failing_rank, WORLD, (how,), timeout=JOIN_S)
    assert time.monotonic() - t < 30
