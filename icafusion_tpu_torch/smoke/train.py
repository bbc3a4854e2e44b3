"""Phase 6 of chip_smoke.py: Trainer steps on the card against the CPU,
the flagship's training step timed, and fit."""

from __future__ import annotations

import copy
import itertools
import math
import time
from pathlib import Path

import numpy as np
import torch

from icafusion_tpu_torch.smoke.common import profile_calls

TRAIN_WARMUP, TRAIN_TIMED, TRAIN_BATCH = 2, 10, 8


def _no_dropout(model):
    from icafusion_tpu_torch.nn.fusion import Dropout
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


# Card against CPU, tiny model, 64 px, batch 2, fp32. BatchNorm over 8
# values per channel at P5 magnifies rounding: on the CPU alone a change of
# one ulp in the input moves the weights and statistics by 7.7e-6 after
# three steps, and the card's own summation orders (cuDNN's choice of
# algorithm, atomics) moved them by 2.4e-5 and 1.9e-4 in two runs. So the
# first step's gradients are held tensor by tensor (GRAD_RTOL of the
# tensor's largest gradient, plus GRAD_RTOL / 10 of the largest of all for
# those near zero) and the state after three steps to STATE_ATOL.
GRAD_RTOL, STATE_ATOL = 1e-3, 1e-3
# seeded draws of the printed one-ulp probe (not a gate; phase 10c): each
# draw is a CPU training run, most of 10c's time
ULP_DRAWS = 2


def train_card_vs_cpu(cfg=None, steps: int = 3, ulp_probe=()):
    """One tiny model (``cfg``, default the zoo's tiny DMFF model) from one
    batch, dropout off, on the card and on the CPU: the first step's
    gradients; then ``steps`` Trainer steps: loss and items rtol 1e-4,
    parameters, BatchNorm statistics and EMA within STATE_ATOL (the
    momentum printed). For each count of steps in ``ulp_probe`` it also
    prints how far the CPU's own state and loss items move when each RGB
    value moves by one ulp up, down or not at all (the most over ULP_DRAWS
    seeded draws): what rounding alone does to the comparison."""
    from icafusion_tpu_torch.config import load_hyp_config
    from icafusion_tpu_torch.models.assembler import build_model, init_weights
    from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
    from icafusion_tpu_torch.train.loss import pad_targets
    from icafusion_tpu_torch.train.trainer import Trainer
    base = _no_dropout(init_weights(
        build_model(cfg or tiny_icafusion_config()),
        torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(0)
    rgb = torch.from_numpy(rng.random((2, 3, 64, 64), np.float32))
    ir = torch.from_numpy(rng.random((2, 3, 64, 64), np.float32))
    labels = [np.array([[0, 0.5, 0.5, 0.4, 0.4], [1, 0.25, 0.25, 0.2, 0.3],
                        [2, 0.7, 0.3, 0.1, 0.15]], np.float32)] * 2
    t, m = (torch.from_numpy(a) for a in pad_targets(labels, 8))

    def trainer(dev):
        return Trainer(copy.deepcopy(base), load_hyp_config(), epochs=3,
                       steps_per_epoch=1, batch_size=2, imgsz=64,
                       warmup_min_steps=2, device=dev)

    def cpu_run(x, n):
        tr = trainer("cpu")
        step = tr.make_train_step()
        mets = [step(x, ir, t, m) for _ in range(n)]
        return tr.model.state_dict(), mets

    drift, g = {}, torch.Generator().manual_seed(5)
    for n in ulp_probe:
        (ref, ref_mets), drift[n] = cpu_run(rgb, n), [0.0, 0.0]
        for _ in range(ULP_DRAWS):
            way = torch.randint(-1, 2, rgb.shape, generator=g).float()
            x = torch.where(way == 0, rgb, torch.nextafter(rgb, 2.0 * way))
            state, mets = cpu_run(x, n)
            drift[n][0] = max(drift[n][0], max(
                (v - ref[k]).abs().max().item() for k, v in state.items()
                if not k.endswith("num_batches_tracked")))
            drift[n][1] = max(drift[n][1], max(
                abs(float(a[k]) / float(b[k]) - 1) for a, b in
                zip(mets, ref_mets) for k in ("loss", "lbox", "lobj",
                                              "lcls")))
    runs, grads = {}, {}
    for dev in ("cuda", "cpu"):
        tr = trainer(dev)
        batch = [x.to(dev) for x in (rgb, ir, t, m)]
        model = copy.deepcopy(base).to(dev).train()
        tr.loss_fn(model(*batch[:2]), *batch[2:])[0].backward()
        grads[dev] = {k: p.grad.double().cpu()
                      for k, p in model.named_parameters()}
        step = tr.make_train_step()
        mets = [step(*batch) for _ in range(steps)]
        runs[dev] = (tr, [{k: float(v) for k, v in mt.items()}
                          for mt in mets])
    top = max(g.abs().max().item() for g in grads["cpu"].values())
    worst_g = 0.0
    for k, g in grads["cpu"].items():
        d = (grads["cuda"][k] - g).abs().max().item()
        worst_g = max(worst_g, d / (g.abs().max().item() + top / 10))
        assert d <= GRAD_RTOL * (g.abs().max().item() + top / 10), (k, d)
    (tc, mc), (tp, mp) = runs["cuda"], runs["cpu"]
    for a, b in zip(mc, mp):
        for k in ("loss", "lbox", "lobj", "lcls"):
            assert math.isclose(a[k], b[k], rel_tol=1e-4), (k, a[k], b[k])
    worst = {}
    for name, x, y in (("state", tc.model.state_dict(),
                        tp.model.state_dict()),
                       ("momentum", tc.opt.momentum, tp.opt.momentum),
                       ("ema", tc.ema.tree, tp.ema.tree)):
        worst[name] = max((x[k].double().cpu() - y[k].double()).abs().max()
                          .item() for k in y
                          if not k.endswith("num_batches_tracked"))
    print(f"   first-step gradients: max |card - CPU| / (tensor max + "
          f"global max / 10) = {worst_g:.3g}; losses "
          f"{[round(r['loss'], 6) for r in mc]} (card) vs "
          f"{[round(r['loss'], 6) for r in mp]} (CPU); max |card - CPU| "
          f"after {steps} steps: {worst}")
    for n, (ds, dl) in drift.items():
        print(f"   the CPU's own run of {n} steps, each RGB value one ulp off "
              f"({ULP_DRAWS} draws): state max |change| {ds:.3g}, loss "
              f"items max relative change {dl:.3g}")
    for name in ("state", "ema"):
        assert worst[name] <= STATE_ATOL, (name, worst[name])


def train_slice(data_yaml: Path, card: str):
    """yolov5l-Transfusion at 640, batch 8, bf16 autocast, SGD: batches from
    the port's PairedLoader (mosaic, HSV, flips) over the synthetic pairs,
    2 warm-up and 10 timed steps; every loss finite, the parameters moved,
    every tensor of the state on the card."""
    from icafusion_tpu_torch.config import load_data_config, load_hyp_config
    from icafusion_tpu_torch.data.datasets import PairedDetectionDataset
    from icafusion_tpu_torch.data.loader import PairedLoader
    from icafusion_tpu_torch.models.assembler import build_model, init_weights
    from icafusion_tpu_torch.models.zoo import icafusion_config
    from icafusion_tpu_torch.train.trainer import Trainer
    dc = load_data_config(data_yaml)
    hyp = load_hyp_config("hyp.scratch.yaml")
    root = Path(dc.path)
    ds = PairedDetectionDataset(str(root / dc.train_rgb),
                                str(root / dc.train_ir), 640, nc=dc.nc,
                                hyp=hyp, augment=True)
    loader = PairedLoader(ds, TRAIN_BATCH, max_targets=128, seed=0,
                          num_workers=8)
    t = time.perf_counter()
    host = []
    epoch = 0
    while len(host) < TRAIN_WARMUP + TRAIN_TIMED:
        host += list(loader.epoch(epoch))
        epoch += 1
    host = host[:TRAIN_WARMUP + TRAIN_TIMED]
    load_s = time.perf_counter() - t

    def up(b):
        img = lambda a: (torch.from_numpy(a).cuda().permute(0, 3, 1, 2)
                         .float().div_(255.0))
        return (img(b["rgb"]), img(b["ir"]), torch.from_numpy(
            b["targets"]).cuda(), torch.from_numpy(b["mask"]).cuda())

    batches = [up(b) for b in host]
    print(f"   {len(batches)} batches of {TRAIN_BATCH} from PairedLoader over "
          f"{len(ds)} pairs in {load_s:.1f} s; targets per image "
          f"{float(np.mean([b['mask'].sum(1).mean() for b in host])):.1f}")
    model = init_weights(build_model(icafusion_config("l", nc=3)),
                         torch.Generator().manual_seed(0))
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(model, hyp, epochs=10, steps_per_epoch=loader.steps_per_epoch,
                 batch_size=TRAIN_BATCH, imgsz=640, bf16=True)
    step = tr.make_train_step()
    losses, ms = [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        met = step(*b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        losses.append(float(met["loss"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert all(math.isfinite(x) for x in losses), losses
    moved = sum(not torch.equal(before[k], v.cpu())
                for k, v in tr.model.state_dict().items())
    assert moved > 0.9 * len(before), (moved, len(before))
    on_card = [t.is_cuda for t in itertools.chain(
        tr.model.parameters(), tr.model.buffers(),
        tr.opt.momentum.values(), tr.ema.tree.values())]
    assert all(on_card), "a tensor of the train state is off the card"
    timed = ms[TRAIN_WARMUP:]
    med = float(np.median(timed))
    dev_us, wall_us = profile_calls(lambda: step(*batches[-1]), 3)
    busy = sum(dev_us.values()) / 3 / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    print(f"   {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"parameters; losses {[round(x, 4) for x in losses]}; "
          f"{moved}/{len(before)} state tensors moved")
    print(f"   step ms (host clock, synchronised): warm-up "
          f"{[round(x, 1) for x in ms[:TRAIN_WARMUP]]}, timed "
          f"{[round(x, 1) for x in timed]}; median {med:.2f} ms -> "
          f"{1e3 * TRAIN_BATCH / med:.1f} images/s (pairs)")
    if busy:
        print(f"   device busy {busy:.2f} ms per step (torch.profiler, 3 "
              f"steps; profiled wall {wall_us / 3 / 1e3:.2f} ms) -> idle "
              f"share {1 - busy / med:.3f} of the unprofiled median")
    else:
        print("   device busy and idle share: not measured (the profiler "
              "recorded no device events)")
    print(f"   peak memory {peak:.2f} GiB (max_memory_allocated); {card}")
    for k, v in top:
        print(f"   {100 * v / 3e3 / busy:5.1f}%  {v / 3e3:8.3f} ms  {k[:90]}")


def fit_slice(data_yaml: Path, project: Path):
    """fit() of yolov5n-Transfusion at 320 on the synthetic pairs: 2 epochs
    of batch 16 in bf16 with the EMA evaluated after each; results.csv,
    last/best checkpoints, the kernels launched by the evaluations, and the
    stripped checkpoint read back and served on the card. Returns the rows
    of results.csv."""
    from icafusion_tpu_torch.config import load_data_config, load_hyp_config
    from icafusion_tpu_torch.kernels.cross_attention import dual_cross_attention
    from icafusion_tpu_torch.kernels.nms import greedy_nms
    from icafusion_tpu_torch.kernels.packed_conv import conv3x3_bn_silu
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.models.zoo import icafusion_config
    from icafusion_tpu_torch.serve.engine import ServingEngine
    from icafusion_tpu_torch.train.fit import FitConfig, fit
    from icafusion_tpu_torch.utils.checkpoint import load_inference_variables
    from icafusion_tpu_torch.utils.convert import load_jax_variables
    import csv
    cfg = FitConfig(model_cfg=icafusion_config("n", nc=3),
                    data_cfg=load_data_config(data_yaml),
                    hyp=load_hyp_config("hyp.scratch.yaml"), epochs=2,
                    batch_size=16, imgsz=320, project=str(project),
                    bf16=True, workers=8)
    wrappers = (dual_cross_attention, greedy_nms, conv3x3_bn_silu)
    for fn in wrappers:
        fn.launches = 0
    t = time.perf_counter()
    result = fit(cfg)
    fit_s = time.perf_counter() - t
    counts = {fn.__name__: fn.launches for fn in wrappers}
    run = Path(result["run_dir"])
    with open(run / "results.csv") as f:
        rows = list(csv.DictReader(f))
    print(f"   fit {fit_s:.1f} s; launches during fit {counts}")
    for r in rows:
        print(f"   {dict(r)}")
    assert len(rows) == 2, rows
    for r in rows:
        for k in ("lbox", "lobj", "lcls", "mAP50", "mAP"):
            assert math.isfinite(float(r[k])), (k, r)
    w = run / "weights"
    for name in ("last.ckpt", "best.ckpt", "stripped.ckpt"):
        assert (w / name).is_file(), name
    assert all(counts.values()), counts
    model = load_jax_variables(build_model(icafusion_config("n", nc=3)),
                               load_inference_variables(w / "stripped.ckpt"))
    engine = ServingEngine(model, 320, 4, conf_thres=0.001)
    rng = np.random.default_rng(2)
    out = engine.predict_arrays(
        rng.integers(0, 256, (4, 320, 320, 3), np.uint8),
        rng.integers(0, 256, (4, 320, 320, 3), np.uint8))
    assert len(out) == 4 and all(
        x.ndim == 2 and x.shape[1] == 6 and np.isfinite(x).all()
        for x in out), [x.shape for x in out]
    print(f"   stripped.ckpt served on the card: detections per image "
          f"{[len(x) for x in out]}")
    return rows
