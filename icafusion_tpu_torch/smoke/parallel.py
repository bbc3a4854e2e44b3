"""Phase 12 of chip_smoke.py: data parallel (parallel/mesh.py) on the one
card: fit under torchrun's contract, two gloo ranks sharing cuda:0, and
two replicas of the Evaluator and the ServingEngine on cuda:0."""

from __future__ import annotations

import contextlib
import json
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from icafusion_tpu_torch.smoke.common import (CONVS_PER_FORWARD, MAP50_GATE,
                                              REPO, counted, done, phase)
from icafusion_tpu_torch.smoke.train import GRAD_RTOL, STATE_ATOL, _no_dropout

# Phase 12: data parallel (parallel/mesh.py). The card is one H100: NCCL
# refuses two ranks on one GPU, so (a) runs NCCL at world size 1, (b) two
# gloo ranks that share cuda:0 (gloo stages CUDA tensors through the host),
# and (c), (d) two single-process replicas placed on cuda:0 by patching
# mesh.cuda_devices, the one place the port reads the device list.
DIST_BATCH, DIST_STEPS, DIST_BF16_STEPS = 8, 3, 5
DIST_TARGETS = 32


@contextlib.contextmanager
def two_replicas_on_one_card():
    """mesh.cuda_devices() lists cuda:0 twice inside the block."""
    from icafusion_tpu_torch.parallel import mesh
    real = mesh.cuda_devices
    mesh.cuda_devices = lambda: [torch.device("cuda", 0)] * 2
    try:
        yield
    finally:
        mesh.cuda_devices = real


def dist_fit_slice(data_yaml: Path, project: Path, ref_rows) -> dict:
    """12a: fit(distributed=True) as a torchrun launch of one process gives
    it (env://, NCCL, world size 1): yolov5n-Transfusion at 320, one epoch of
    6c's configuration; its losses against 6c's first epoch. Returns the
    launches of its evaluation."""
    import csv
    import os
    import socket
    from icafusion_tpu_torch.config import load_data_config, load_hyp_config
    from icafusion_tpu_torch.models.zoo import icafusion_config
    from icafusion_tpu_torch.train.fit import FitConfig, fit
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    cfg = FitConfig(model_cfg=icafusion_config("n", nc=3),
                    data_cfg=load_data_config(data_yaml),
                    hyp=load_hyp_config("hyp.scratch.yaml"), epochs=1,
                    batch_size=16, imgsz=320, project=str(project),
                    name="dist", bf16=True, workers=8, distributed=True)
    try:
        t = time.perf_counter()
        result, counts = counted(lambda: fit(cfg))
        fit_s = time.perf_counter() - t
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    assert not torch.distributed.is_initialized()
    with open(Path(result["run_dir"]) / "results.csv") as f:
        (row,) = list(csv.DictReader(f))
    diffs = {k: abs(float(row[k]) / float(ref_rows[0][k]) - 1)
             for k in ("lbox", "lobj", "lcls")}
    print(f"   NCCL world size 1 (env://, torchrun's contract): fit {fit_s:.1f}"
          f" s; epoch 0 {[row[k] for k in ('lbox', 'lobj', 'lcls')]} vs 6c "
          f"{[ref_rows[0][k] for k in ('lbox', 'lobj', 'lcls')]} (relative "
          f"{ {k: round(v, 6) for k, v in diffs.items()} }, gate "
          f"{DIST_FIT_RTOL}); mAP50 {row['mAP50']} vs 6c's "
          f"{ref_rows[0]['mAP50']}; launches during its evaluation {counts}")
    assert all(v <= DIST_FIT_RTOL for v in diffs.values()), diffs
    assert all(counts.values()), counts
    return counts


# bf16 autocast, the same weights and pairs: one epoch of 6c and of 12a
# differ only by the card's own summation orders (atomics in the loss's
# gather backward, cuDNN's choices), which three bf16 steps carry into the
# epoch's mean losses.
DIST_FIT_RTOL = 2e-2


def dist_data():
    """One global batch of DIST_BATCH seeded 640 pairs in [0, 1], NCHW, and
    their padded targets (4 boxes an image), numpy. Image i's values are
    scaled by a gain from 0.25 (first) to 1 (last), so each rank's rows
    have statistics of their own and a rank that normalised by its own
    BatchNorm statistics would not pass for one that takes the global
    batch's."""
    from icafusion_tpu_torch.train.loss import pad_targets
    rng = np.random.default_rng(12)
    gain = np.linspace(0.25, 1.0, DIST_BATCH, dtype=np.float32)
    rgb, ir = (rng.random((DIST_BATCH, 3, 640, 640), np.float32)
               * gain[:, None, None, None] for _ in range(2))
    labels = [np.concatenate([rng.integers(0, 3, (4, 1)),
                              rng.uniform(0.2, 0.8, (4, 2)),
                              rng.uniform(0.05, 0.3, (4, 2))],
                             1).astype(np.float32)
              for _ in range(DIST_BATCH)]
    t, m = pad_targets(labels, DIST_TARGETS)
    return rgb, ir, t, m


def dist_trainer(device):
    """yolov5l-Transfusion, seeded init, dropout off, fp32 SGD over the
    global batch DIST_BATCH, on the reference's schedule (its 1000-step
    warm-up floor: at 6a's floor of 2 the third step's state moved half
    a tensor's scale under a one-ulp change of the input)."""
    from icafusion_tpu_torch.config import load_hyp_config
    from icafusion_tpu_torch.models.assembler import build_model, init_weights
    from icafusion_tpu_torch.models.zoo import icafusion_config
    from icafusion_tpu_torch.train.trainer import Trainer
    model = _no_dropout(init_weights(build_model(icafusion_config("l", nc=3)),
                                     torch.Generator().manual_seed(0)))
    return Trainer(model, load_hyp_config("hyp.scratch.yaml"), epochs=10,
                   steps_per_epoch=10, batch_size=DIST_BATCH, imgsz=640,
                   device=device)


def dist_steps(tr, rows, ulp: int = 0):
    """DIST_STEPS fp32 steps on ``rows`` of dist_data(), every RGB value
    moved ``ulp`` (-1, 0, 1) units in the last place: (losses, the first
    step's gradients, the state after the first step, the data, the
    step)."""
    data = [torch.from_numpy(a[rows]).cuda() for a in dist_data()]
    if ulp:
        data[0] = torch.nextafter(data[0], torch.full_like(data[0],
                                                           2.0 * ulp))
    step = tr.make_train_step()
    losses, grads, first = [], None, None
    for i in range(DIST_STEPS):
        losses.append({k: float(v) for k, v in step(*data).items()})
        if i == 0:
            grads = {k: p.grad.detach().clone() for k, p in tr.params.items()}
            first = {k: v.detach().clone() for k, v in
                     tr.model.state_dict().items()
                     if not k.endswith("num_batches_tracked")}
    return losses, grads, first, data, step


def loss_err(got, want) -> float:
    """Largest relative difference of the loss and its items over steps."""
    return max(abs(a[k] / b[k] - 1) for a, b in zip(got, want)
               for k in ("loss", "lbox", "lobj", "lcls"))


def grad_err(got, want) -> float:
    """Largest |got - want| of a tensor over (its largest |want| + a tenth
    of the largest of all), as 6a holds gradients."""
    top = max(g.abs().max().item() for g in want.values())
    return max((got[k] - g).abs().max().item()
               / (g.abs().max().item() + top / 10) for k, g in want.items())


def state_err(got, want) -> float:
    """Largest |got - want| of a tensor over its largest |want| plus 1e-3
    (biases that stay within rounding of 0 would divide by 1e-10)."""
    return max((got[k].double() - v.double()).abs().max().item()
               / (v.abs().max().item() + 1e-3) for k, v in want.items())


def dist_rank_fp32(ref_path: str):
    """One gloo rank of 12b on cuda:0, its fp32 steps: (what it reports,
    the trainer, the step, its data). Rank 0 holds its losses, first-step
    gradients and state against the one process's in ``ref_path``; the
    whole state after the steps (weights, statistics, momentum, EMA) is
    compared across the ranks."""
    import torch.distributed as dist
    from icafusion_tpu_torch.parallel import mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    tr = dist_trainer("cuda:0")
    losses, grads, first, data, step = dist_steps(
        tr, mesh.process_rows(DIST_BATCH))
    flat = torch.cat([t.detach().reshape(-1).float() for t in
                      [*tr.model.state_dict().values(),
                       *tr.opt.momentum.values(), *tr.ema.tree.values()]])
    other = flat.clone()
    dist.broadcast(other, src=1)
    out = {"losses": losses, "equal": bool(torch.equal(flat, other)),
           "numel": flat.numel(), "rows": len(data[0])}
    del flat, other
    if mesh.is_main():
        ref = torch.load(ref_path, map_location="cuda:0")
        out["loss"] = loss_err(losses, ref["losses"])
        out["grad"] = grad_err(grads, ref["grads"])
        out["first"] = state_err(first, ref["first"])
        del ref
    return out, tr, step, data


def _dist_train_rank(ref_path: str) -> dict:
    """One gloo rank of 12b on cuda:0 (parallel/mesh.spawn): the fp32
    steps, then bf16 steps timed."""
    import torch.distributed as dist
    out, tr, step, data = dist_rank_fp32(ref_path)
    # bf16: step time, and the time of every all-reduce in it
    tr.bf16 = True
    real = dist.all_reduce
    spent = {"grads": 0.0, "other": 0.0, "calls": 0}

    def timed(t, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = real(t, *a, **kw)
        torch.cuda.synchronize()
        spent["grads" if t.numel() > 1_000_000 else "other"] += (
            time.perf_counter() - t0) * 1e3
        spent["calls"] += 1
        return r

    dist.all_reduce = timed
    try:
        out["bf16"] = []
        for _ in range(DIST_BF16_STEPS):
            for k in spent:
                spent[k] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            met = step(*data)
            torch.cuda.synchronize()
            out["bf16"].append(((time.perf_counter() - t0) * 1e3,
                                spent["grads"], spent["other"],
                                spent["calls"], float(met["loss"])))
    finally:
        dist.all_reduce = real
    return out


def dist_reference(ref_path: Path):
    """12b's one process on the global batch of DIST_BATCH, saved to
    ``ref_path`` for the ranks, and its gates: the one process's own drift
    when every RGB value moves one ulp up or down, ten times over and no
    less than 6a's tolerances, for the losses over DIST_STEPS steps, the
    first step's gradients and the state after it. Returns (losses,
    drift, gates, parameter count)."""
    runs = []
    for ulp in (0, 1, -1):
        tr = dist_trainer("cuda")
        runs.append(dist_steps(tr, np.arange(DIST_BATCH), ulp)[:3])
        n_params = sum(p.numel() for p in tr.params.values())
        del tr
    errs = {"loss": loss_err, "grad": grad_err, "first": state_err}
    drift = {k: max(f(r[i], runs[0][i]) for r in runs[1:])
             for i, (k, f) in enumerate(errs.items())}
    floor = {"loss": 1e-4, "grad": GRAD_RTOL, "first": STATE_ATOL}
    tol = {k: max(floor[k], 10 * drift[k]) for k in errs}
    losses, grads, first = runs[0]
    torch.save({"losses": losses, "grads": grads, "first": first}, ref_path)
    del runs, grads, first
    torch.cuda.empty_cache()
    return losses, drift, tol, n_params


DIST_MEASURES = (("loss", "losses and items, relative"),
                 ("grad", "first-step gradients, of tensor scale"),
                 ("first", "state after one step, of tensor scale"))


def dist_train_slice(card: str):
    """12b: two gloo ranks on cuda:0, yolov5l-Transfusion 640, fp32, global
    batch 8 = 2 x 4, against one process on the 8 (dist_reference's
    gates: the two sum the global batch's BatchNorm statistics and losses
    in another order, and the steps carry such rounding on). The whole
    state after DIST_STEPS steps is bit-equal across the ranks. Then bf16
    steps, timed."""
    from icafusion_tpu_torch.parallel import mesh
    with tempfile.TemporaryDirectory() as tmp:
        ref = Path(tmp) / "ref.pt"
        losses, drift, tol, n_params = dist_reference(ref)
        t = time.perf_counter()
        out = mesh.spawn(_dist_train_rank, 2, (str(ref),), backend="gloo",
                         timeout=400)
        spawn_s = time.perf_counter() - t
    print(f"   gloo, 2 ranks on cuda:0, {out['rows']} rows each of a global "
          f"{DIST_BATCH}; {n_params / 1e6:.1f} M parameters; ranks ran "
          f"{spawn_s:.1f} s (start, build, steps)")
    print(f"   fp32 losses: ranks {[round(r['loss'], 6) for r in out['losses']]}"
          f" vs one process {[round(r['loss'], 6) for r in losses]}")
    for k, what in DIST_MEASURES:
        print(f"   {what}: ranks vs one {out[k]:.3g}; one process's own "
              f"one-ulp drift {drift[k]:.3g}; gate {tol[k]:.3g}")
    print(f"   state after {DIST_STEPS} steps, {out['numel']} values, "
          f"bit-equal across ranks: {out['equal']}")
    for i, (ms, g, o, n, loss) in enumerate(out["bf16"]):
        print(f"   bf16 step {i}: {ms:.1f} ms (host clock, synchronised); "
              f"all-reduce {g + o:.1f} ms ({n} calls: gradients {g:.1f} ms, "
              f"BatchNorm and loss counts {o:.1f} ms); loss {loss:.4f}")
    med = np.median([b[0] for b in out["bf16"][1:]])
    med_ar = np.median([b[1] + b[2] for b in out["bf16"][1:]])
    print(f"   bf16 median of steps 1-{DIST_BF16_STEPS - 1}: step {med:.1f} ms,"
          f" all-reduce {med_ar:.1f} ms; {card}")
    assert all(out[k] <= tol[k] for k in tol), (out, tol)
    assert out["equal"], "the ranks' states differ"
    assert all(math.isfinite(b[4]) for b in out["bf16"]), out["bf16"]


def replica_eval_slice(n320, val, p5):
    """12c: the Evaluator with two replicas on cuda:0 over trained n320's 77
    val pairs, fp32: mAP@50 within the gate of TRAINED_PARITY.json and
    within 1e-3 of phase 5's; each kernel launched twice as often as in
    phase 5."""
    from icafusion_tpu_torch.data.loader import PairedLoader
    from icafusion_tpu_torch.eval.evaluator import Evaluator
    record = json.loads((REPO / "TRAINED_PARITY.json").read_text())
    ref_map50 = record["torch"]["map50"]
    one, one_counts = p5
    with two_replicas_on_one_card():
        ev = Evaluator(n320, nc=3, dtype="float32", n_devices=2)
    assert ev.mesh.size == 2 and len(ev.replicas) == 2
    r, counts = counted(lambda: ev.run(PairedLoader(val, 8).val_batches(),
                                       320))
    print(f"   2 replicas: mAP@50 {r['map50']:.5f} mAP {r['map']:.5f} over "
          f"{r['seen']} pairs; phase 5 (1 replica) {one['map50']:.5f}; "
          f"reference stack {ref_map50:.5f}; launches {counts} vs phase 5 "
          f"{one_counts}; {r['t_total_ms']:.2f} ms per image")
    assert r["seen"] == record["n_images"], r["seen"]
    assert abs(r["map50"] - ref_map50) <= MAP50_GATE, r["map50"]
    assert abs(r["map50"] - one["map50"]) <= 1e-3, (r["map50"], one["map50"])
    assert counts == {k: 2 * v for k, v in one_counts.items()}, counts
    return counts


def replica_serve_slice(card: str) -> dict:
    """12d: ServingEngine(n_devices=2) of yolov5l-Transfusion 640 (phase 4b's
    weights), bf16, batch 8, with both replicas on cuda:0, and its
    quantized twin: detections against two one-replica batch-4 calls
    (fp32-rounded boxes within 1e-3 px, classes and counts equal); every
    wrapper launched once per replica and forward, the int8 conv 162 times;
    then one request under torch.cuda.set_sync_debug_mode('warn')."""
    import warnings
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.models.zoo import icafusion_config
    from icafusion_tpu_torch.serve.engine import ServingEngine
    model = build_model(icafusion_config("l", nc=3, fusion="tfb"),
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(13)
    rgb, ir = (rng.integers(0, 256, (8, 640, 640, 3), np.uint8)
               for _ in range(2))
    calib = [tuple(rng.integers(0, 256, (4, 640, 640, 3), np.uint8)
                   for _ in range(2)) for _ in range(2)]
    kw = dict(img_size=640, conf_thres=0.001, dtype="bfloat16")
    launches = {}
    for tag in ("bf16", "int8"):
        with two_replicas_on_one_card():
            two = ServingEngine(model, batch_size=8, n_devices=2, **kw)
        one = ServingEngine(model, batch_size=4, **kw)
        assert two.mesh.size == 2 and one.mesh.size == 1
        if tag == "int8":
            for e in (two, one):
                e.quantize(calib)
        two.predict_arrays(rgb, ir)                     # warm-up
        got, counts = counted(lambda: two.predict_arrays(rgb, ir),
                              int8=True)
        want = one.predict_arrays(rgb[:4], ir[:4]) + one.predict_arrays(
            rgb[4:], ir[4:])
        exact = all(np.array_equal(g, w) for g, w in zip(got, want))
        print(f"   {tag}: 2 replicas, one batch of 8: launches {counts}; "
              f"detections per image {[len(x) for x in got]}; equal to two "
              f"one-replica batches of 4: bit for bit {exact}")
        assert [len(x) for x in got] == [len(x) for x in want]
        for g, w in zip(got, want):
            assert np.array_equal(g[:, 5], w[:, 5])
            assert np.allclose(g[:, :5], w[:, :5], rtol=0, atol=1e-3)
        assert counts["dual_cross_attention"] == 2 * 3, counts
        assert counts["greedy_nms"] == 2, counts
        if tag == "int8":
            assert counts["conv_int8_bn_act"] == 2 * 162, counts
            assert counts["conv3x3_bn_silu"] == 0, counts
        else:
            assert counts["conv3x3_bn_silu"] == 2 * CONVS_PER_FORWARD, counts
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            two.predict_arrays(rgb, ir)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "called a synchronizing" in str(w.message):  # not the notice
            key = f"{Path(w.filename).parent.name}/{Path(w.filename).name}"
            key += f":{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    print(f"   sync debug ('warn') over one int8 request of 8 on 2 replicas:"
          f" {sum(sites.values())} synchronising calls, by site {sites}; "
          f"{card}")
    return launches


def parallel_slice(card, data_yaml, project, fit_rows, n320, val, p5):
    """Phase 12; returns the launches of its counted runs."""
    t0 = phase("12a fit(distributed=True): NCCL, world size 1, yolov5n 320")
    launches = dict(dist_fit_slice(data_yaml, project, fit_rows))
    done(t0)
    t0 = phase("12b 2 gloo ranks on cuda:0: yolov5l-Transfusion 640, "
               "global batch 8 = 2 x 4")
    dist_train_slice(card)
    done(t0)
    t0 = phase("12c Evaluator, 2 replicas on cuda:0: trained n320, fp32")
    for k, v in replica_eval_slice(n320, val, p5).items():
        launches[k] = launches.get(k, 0) + v
    done(t0)
    t0 = phase("12d ServingEngine, 2 replicas on cuda:0: yolov5l 640, b8, "
               "bf16 and int8")
    for k, v in replica_serve_slice(card).items():
        launches[k] = launches.get(k, 0) + v
    done(t0)
    return launches
