"""The port's data parallelism in one process (parallel/mesh.py) against the
JAX package's, on the CPU: the rows each process holds, the mesh and its
shards, the Evaluator and the ServingEngine over two logical CPU replicas
against the JAX package's over its 8-device CPU mesh, an int8 engine of two
replicas against one, and the MicroBatcher's bucket rule.

Tolerances: detections rtol 1e-4 / atol 1e-3 px and val loss items rtol
1e-4, as tests/test_torch_port_serve_entry.py and
tests/test_torch_port_eval.py hold the one-device paths (fp32 through
about 70 layers summed in other orders); matches, classes and counts
exact; mAP within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icafusion_tpu.config import load_hyp_config as jax_hyp
from icafusion_tpu.eval import evaluator as jax_evaluator
from icafusion_tpu.models import zoo as jax_zoo
from icafusion_tpu.models.assembler import anchors_grid_units as jax_anchors
from icafusion_tpu.models.assembler import build_model as jax_build_model
from icafusion_tpu.parallel import mesh as jax_mesh
from icafusion_tpu.serve import batcher as jax_batcher
from icafusion_tpu.serve.engine import ServingEngine as JaxServingEngine
from icafusion_tpu.train.loss import YoloLoss as JaxYoloLoss
from icafusion_tpu_torch.config import load_hyp_config
from icafusion_tpu_torch.eval import evaluator
from icafusion_tpu_torch.models import zoo
from icafusion_tpu_torch.models.assembler import (anchors_grid_units,
                                                  build_model)
from icafusion_tpu_torch.parallel import mesh
from icafusion_tpu_torch.serve import batcher
from icafusion_tpu_torch.serve.engine import ServingEngine
from icafusion_tpu_torch.train.loss import YoloLoss
from icafusion_tpu_torch.utils.convert import load_jax_variables
from torch_port_common import random_variables

torch.set_num_threads(1)

PX = 64


def assert_dets_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :5], w[:, :5], rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, flax variables, the port model holding them), nc 3."""
    jm = jax_build_model(jax_zoo.tiny_icafusion_config(nc=3))
    x = jnp.zeros((1, PX, PX, 3), jnp.float32)
    v = random_variables(jm, x, x, train=False, seed=2)
    return jm, v, load_jax_variables(
        build_model(zoo.tiny_icafusion_config(nc=3)), v)


# ---- rows and meshes --------------------------------------------------------


@pytest.mark.parametrize("global_batch", [8, 16, 24, 64])
def test_process_batch_slice_matches_jax(global_batch):
    """For each world size W that divides the 8 CPU devices, process p of a
    process-major mesh owns devices [p * 8 / W, (p + 1) * 8 / W): the rows
    JAX's batch sharding gives them, joined, are the port's slice."""
    jmesh = jax_mesh.make_mesh(8)
    imap = jax_mesh.batch_sharding(jmesh).devices_indices_map((global_batch,))
    devs = list(jmesh.devices.flat)
    for w in (1, 2, 4, 8):
        for p in range(w):
            mine = [imap[d][0] for d in devs[p * 8 // w:(p + 1) * 8 // w]]
            want = (mine[0].start or 0, mine[-1].stop or global_batch)
            assert mesh.process_batch_slice(global_batch, p, w) == want
    # every rank's rows of every microbatch, once, in microbatch order
    rows = [mesh.process_rows(global_batch, 3, p, 4) for p in range(4)]
    assert sorted(np.concatenate(rows).tolist()) == list(
        range(3 * global_batch))
    assert rows[1][:global_batch // 4].tolist() == list(
        range(global_batch // 4, global_batch // 2))
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        mesh.process_batch_slice(global_batch + 1, 0, 2)


def test_mesh_and_shards(monkeypatch):
    """CPU meshes are logical replicas; a CUDA mesh takes the first n of
    cuda_devices() and raises where fewer exist (JAX's devs[:n] shrinks);
    shards are contiguous and must divide."""
    assert mesh.make_mesh(None, "cpu").devices == (torch.device("cpu"),)
    m = mesh.make_mesh(3, "cpu")
    assert m.size == 3 and set(m.devices) == {torch.device("cpu")}
    with pytest.raises(ValueError, match="n_devices 0 < 1"):
        mesh.make_mesh(0, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    two = [torch.device("cuda", 0)] * 2
    monkeypatch.setattr(mesh, "cuda_devices", lambda: two)
    assert mesh.make_mesh(None, "cuda").devices == tuple(two)
    assert mesh.make_mesh(1, "cuda").size == 1
    assert mesh.device_count("cuda") == 2 and mesh.device_count("cpu") == 1
    with pytest.raises(ValueError, match="3 CUDA devices asked for, 2"):
        mesh.make_mesh(3, "cuda")
    x = np.arange(12).reshape(6, 2)
    a, b = mesh.shard_batch(x, mesh.make_mesh(2, "cpu"))
    assert a.tolist() == x[:3].tolist() and b.tolist() == x[3:].tolist()
    with pytest.raises(ValueError, match="6 rows do not divide over 4"):
        mesh.shard_batch(x, mesh.make_mesh(4, "cpu"))
    # without a process group: the one-process answers
    assert (mesh.rank(), mesh.world(), mesh.is_main()) == (0, 1, True)
    assert mesh.broadcast_object({"a": 1}) == {"a": 1}
    mesh.barrier()
    t = torch.ones(2, requires_grad=True)
    assert mesh.all_reduce_sum(t) is t


def test_named_card_stays_alone(tiny, monkeypatch):
    """On a host of two cards (a patched cuda_devices), a card named by its
    index is used alone by default: ServingEngine, the Evaluator and fit
    with device='cuda:1' stay on cuda:1, a mesh of two that would not
    start there raises, and a rank on another card refuses it; 'cuda'
    takes every card."""
    from icafusion_tpu_torch.serve import engine as engine_mod
    from icafusion_tpu_torch.train import fit as fit_mod
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mesh, "cuda_devices", lambda: [cuda0, cuda1])
    assert mesh.device_count("cuda:1") == 1 and mesh.device_count("cuda") == 2
    assert mesh.make_mesh(None, "cuda:1").devices == (cuda1,)
    assert mesh.make_mesh(1, "cuda:1").devices == (cuda1,)
    assert mesh.make_mesh(2, "cuda:0").devices == (cuda0, cuda1)
    assert mesh.make_mesh(None, "cuda").devices == (cuda0, cuda1)
    with pytest.raises(ValueError, match="from cuda:0, not cuda:1"):
        mesh.make_mesh(2, "cuda:1")

    # the replicas stay on the CPU here: only the placement is checked
    placed = lambda m, msh: [m] * msh.size
    monkeypatch.setattr(engine_mod, "replicate", placed)
    model = tiny[2]
    eng = ServingEngine(model, PX, 4, dtype="float32", device="cuda:1")
    assert eng.device == cuda1 and eng.mesh.devices == (cuda1,)
    assert ServingEngine(model, PX, 4, dtype="float32",
                         device="cuda").mesh.devices == (cuda0, cuda1)
    with pytest.raises(ValueError, match="not cuda:1"):
        ServingEngine(model, PX, 4, dtype="float32", device="cuda:1",
                      n_devices=2)
    with pytest.raises(ValueError, match="not cuda:1"):
        evaluator.Evaluator(model, 3, device="cuda:1", n_devices=2)

    ran = []
    monkeypatch.setattr(fit_mod, "_fit", lambda cfg, dev: ran.append(
        ("one", dev)))
    monkeypatch.setattr(mesh, "spawn", lambda fn, n, args, backend: ran.append(
        ("spawn", n, backend)))
    cfg = fit_mod.FitConfig(model_cfg=zoo.tiny_icafusion_config(nc=3),
                            data_cfg=None, hyp=load_hyp_config(),
                            device="cuda:1")
    fit_mod.fit(cfg)
    cfg.device = "cuda"
    fit_mod.fit(cfg)
    assert ran == [("one", cuda1), ("spawn", 2, "nccl")]
    cfg.device, cfg.n_devices = "cuda:1", 2
    with pytest.raises(ValueError, match="not cuda:1"):
        fit_mod.fit(cfg)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert fit_mod._rank_device(torch.device("cuda")) == cuda0
    with pytest.raises(ValueError, match="runs on cuda:0, not the cuda:1"):
        fit_mod._rank_device(cuda1)


# ---- Evaluator ---------------------------------------------------------------


def _eval_batches():
    """The two batches of 8 of tests/test_multidevice_serve_eval.py."""
    rng = np.random.default_rng(2)
    for _ in range(2):
        rgb = rng.integers(0, 255, (8, PX, PX, 3), dtype=np.uint8)
        ir = rng.integers(0, 255, (8, PX, PX, 3), dtype=np.uint8)
        labels = [np.array([[0, 0.5, 0.5, 0.4, 0.4]], np.float32)
                  for _ in range(8)]
        shapes = [((PX, PX), ((1.0, 1.0), (0.0, 0.0)))] * 8
        yield {"rgb": rgb, "ir": ir, "labels": labels, "shapes": shapes,
               "count": 8, "paths": [f"i{k}" for k in range(8)]}


def _capture_stats(monkeypatch, module):
    seen = []
    real = module.summarize

    def capture(stats, nc, *a, **kw):
        seen.append(stats)
        return real(stats, nc, *a, **kw)

    monkeypatch.setattr(module, "summarize", capture)
    return seen


def test_evaluator_two_replicas_match_jax_mesh(tiny, monkeypatch):
    """Evaluator(n_devices=2) on the CPU against JAX's Evaluator(n_devices=8)
    with the val loss: the same stats rows, metrics and loss items; and the
    port's one replica gives the same."""
    jm, v, model = tiny
    ours = _capture_stats(monkeypatch, evaluator)
    theirs = _capture_stats(monkeypatch, jax_evaluator)
    loss = YoloLoss(hyp=load_hyp_config(), nc=3, anchors=anchors_grid_units(
        zoo.tiny_icafusion_config(nc=3)))
    jloss = JaxYoloLoss(hyp=jax_hyp(), nc=3, anchors=jax_anchors(
        jax_zoo.tiny_icafusion_config(nc=3)))
    got = {n: evaluator.Evaluator(model, nc=3, loss_fn=loss, n_devices=n,
                                  device="cpu").run(_eval_batches(), PX)
           for n in (2, 1)}
    want = jax_evaluator.Evaluator(model=jm, nc=3, n_devices=8,
                                   loss_fn=jloss).run(v, _eval_batches(), PX)
    w_stats = theirs[0]
    assert len(w_stats) == 16
    n_det = 0
    for g_stats in ours:
        for g, w in zip(g_stats, w_stats):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_allclose(g[1], w[1], rtol=1e-4, atol=1e-6)
            np.testing.assert_array_equal(g[2], w[2])
            np.testing.assert_array_equal(g[3], w[3])
            n_det += len(g[1])
    assert n_det > 100
    for out in got.values():
        assert out["seen"] == 16
        for k in ("map50", "map", "mp", "mr"):
            assert out[k] == pytest.approx(want[k], abs=1e-6), k
        np.testing.assert_allclose(out["val_loss_items"],
                                   want["val_loss_items"], rtol=1e-4)
    assert got[2]["val_loss_items"][0] > 0


# ---- ServingEngine and MicroBatcher --------------------------------------------


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, PX, PX, 3), np.uint8),
            rng.integers(0, 256, (n, PX, PX, 3), np.uint8))


def test_engine_two_replicas_match_jax_and_buckets(tiny):
    """ServingEngine(n_devices=2) against JAX's n_devices=2 engine: full,
    ragged and bucket-2 batches; the default gcd mesh; the bucket rule and
    its error message, word for word."""
    jm, v, model = tiny
    kw = dict(img_size=PX, batch_size=4, conf_thres=0.001, max_det=100)
    eng = ServingEngine(model, dtype="float32", device="cpu", n_devices=2,
                        **kw)
    jeng = JaxServingEngine(model=jm, variables=v, n_devices=2,
                            dtype="float32", merge_streams=0, **kw)
    assert eng.mesh.size == 2 and len(eng.replicas) == 2
    for n, seed in ((4, 0), (3, 1)):
        rgb, ir = _pairs(n, seed)
        assert_dets_close(eng.predict_arrays(rgb, ir),
                          jeng.predict_arrays(rgb, ir))
    rgb, ir = _pairs(1, 2)
    got = eng._finalize(*eng._dispatch(rgb, ir, batch=2))
    want = jeng._finalize(*jeng._dispatch(rgb, ir, batch=2))
    assert_dets_close(got, want)
    with pytest.raises(ValueError, match="do not divide over 2"):
        eng._dispatch(rgb, ir, batch=1)
    assert ServingEngine(model, device="cpu", **kw).mesh.size == 1
    assert batcher.default_buckets(eng) == jax_batcher.default_buckets(
        jeng) == [2, 4]
    for bad in ([1, 2], [8]):
        with pytest.raises(ValueError) as ours:
            batcher.MicroBatcher(eng, buckets=bad)
        with pytest.raises(ValueError) as theirs:
            jax_batcher.MicroBatcher(jeng, buckets=bad)
        assert str(ours.value) == str(theirs.value)


def test_int8_engine_two_replicas_match_one(tiny):
    """quantize calibrates once and gives every replica the same int8
    state; two replicas serve what one does."""
    _, _, model = tiny
    kw = dict(img_size=PX, batch_size=4, conf_thres=0.001, max_det=100,
              dtype="float32", device="cpu")
    calib = [_pairs(2, 5)]
    one, two = (ServingEngine(model, n_devices=n, **kw) for n in (1, 2))
    for e in (one, two):
        assert e.quantize(calib) is False
    bufs = [{k: b for k, b in r.named_buffers() if k.endswith(
        ("w8", "s_w", "s_in"))} for r in two.replicas + [one.model]]
    assert len(bufs[0]) > 10
    for b in bufs[1:]:
        assert b.keys() == bufs[0].keys()
        assert all(torch.equal(b[k], bufs[0][k]) for k in b)
    rgb, ir = _pairs(4, 6)
    assert_dets_close(two.predict_arrays(rgb, ir),
                      one.predict_arrays(rgb, ir))
