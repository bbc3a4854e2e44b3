"""Phase 10 of chip_smoke.py: every shipped model config on the card (the
other l-scale fusions, x, VGG16 and ResNet50 at full width; all 21 YAMLs
at 320; the other families' Trainer steps against the CPU)."""

from __future__ import annotations

import time

import numpy as np
import torch

from icafusion_tpu_torch.parallel.mesh import shard_batch
from icafusion_tpu_torch.smoke.common import (BATCH, REPO, counted, device_ms,
                                              done, phase, timing_source)
from icafusion_tpu_torch.smoke.train import train_card_vs_cpu

# Phase 10: every shipped model config on the card.
FULL_WIDTH = ("yolov5l_NiNfusion.yaml", "yolov5l_Add.yaml",
              "yolov5x_Transfusion.yaml", "yolov5_VGG16_Transfusion.yaml",
              "yolov5_ResNet50_Transfusion.yaml")
FULL_REQUESTS = 3        # bf16 requests of BATCH pairs a config, counted
ALL_CONFIGS_SIZE = 320
RESIDUAL_SCALE = 0.3     # see seeded_model


def narrow_config(kind: str):
    """Narrow two-stream VGG16 (TransformerFusionBlocks at grids 4x4, 4x4,
    2x2) and ResNet50 (NiNfusion) configs for 64 px training: the zoo's
    graphs at a fraction of the widths, as tests/test_torch_port_backbones.py
    builds them."""
    from icafusion_tpu_torch.models import zoo
    if kind == "vgg16":
        tower = lambda f: [[f, 1, "VGGblock", [2, 3, 8]],
                           [-1, 1, "VGGblock", [2, 8, 16]],
                           [-1, 1, "VGGblock", [3, 16, 16]],
                           [-1, 1, "VGGblock", [3, 16, 24]],
                           [-1, 1, "VGGblock", [3, 24, 32]]]
        fused = [[[2, 7], 1, "TransformerFusionBlock", [16, 4, 4]],
                 [[3, 8], 1, "TransformerFusionBlock", [24, 4, 4]],
                 [[4, 9], 1, "TransformerFusionBlock", [32, 2, 2]]]
        return zoo._two_stream(tower(-1) + tower(-4), "tfb", fused, 3, 1.0,
                               1.0, zoo.COCO_ANCHORS, "narrow_vgg16",
                               widths=(32, 16), p5_out=32)
    tower = lambda f: [[f, 1, "ResNetlayer", [3, 8, 1, "True", 1]],
                       [-1, 1, "ResNetlayer", [8, 8, 1, "False", 1]],
                       [-1, 1, "ResNetlayer", [32, 8, 2, "False", 2]],
                       [-1, 1, "ResNetlayer", [32, 16, 2, "False", 1]],
                       [-1, 1, "ResNetlayer", [64, 16, 2, "False", 1]]]
    fused = zoo._fusion_rows("nin", ((2, 7), (3, 8), (4, 9)), (32, 64, 64))
    return zoo._two_stream(tower(-1) + tower(-4), "nin", fused, 3, 1.0, 1.0,
                           zoo.COCO_ANCHORS, "narrow_resnet50",
                           widths=(32, 16))


def seeded_model(cfg, residual_scale: float = RESIDUAL_SCALE):
    """``cfg`` with build_model's He-uniform weights from seed 0, as phases
    4a and 4b draw them, and in each ResNet50 bottleneck the last
    BatchNorm's scale at ``residual_scale`` (1.0 leaves build_model's).
    With BatchNorm at identity statistics every bottleneck would otherwise
    add a branch as large as its input, doubling the residual stream's
    variance 16 times over, and fp32 itself then misses 10a's 1e-3: on
    ResNet50-Transfusion at 640 the CPU's own fp32 predictions lie 3.8
    times that bound from a float64 run, the card's 8.1 times (2.2 with
    cuDNN off), each of its layers' own error within 1-9 times the CPU's
    (port_probes.py fp64; PERF.md, section 6). At 0.3 the variance grows
    by 1.09 a block, about 4 in all, those ratios fall to 0.05 and 0.19,
    and the towers still carry the signal: a wrong attention output moves
    the boxes by pixels."""
    from icafusion_tpu_torch.models.assembler import build_model
    from icafusion_tpu_torch.nn.backbones import ResNetblock
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ResNetblock):
                m.bn3.weight.fill_(residual_scale)
    return model


def expected_launches(model, requests: int) -> dict:
    """What a forward launches, from the modules: the attention once per
    TransformerFusionBlock, the fused conv once per 64-channel 3x3 SiLU
    Conv (none in the VGG16 and ResNet50 towers, nor at the m and x scales,
    whose C3 widths never reach 64), NMS once a batch."""
    from icafusion_tpu_torch.nn.fusion import TransformerFusionBlock
    from icafusion_tpu_torch.nn.layers import Conv
    mods = list(model.modules())
    return {"dual_cross_attention": requests * sum(
                isinstance(m, TransformerFusionBlock) for m in mods),
            "greedy_nms": requests,
            "conv3x3_bn_silu": requests * sum(
                isinstance(m, Conv) and m.fused for m in mods)}


def full_width_slice(card: str) -> dict:
    """Phase 10a: five shipped configs at 640 with seeded weights
    (seeded_model). fp32 decoded predictions at batch 1, card against the
    port on the CPU (rtol/atol 1e-3, as 4a); then FULL_REQUESTS bf16
    requests of BATCH pairs through ServingEngine.predict_arrays with
    every launch counted and held to expected_launches; the device ms of
    a request's forward and NMS on uploaded pairs. Returns the launches of
    the counted requests."""
    from icafusion_tpu_torch.config import load_model_config
    from icafusion_tpu_torch.nn import backbones, fusion
    from icafusion_tpu_torch.nn.layers import Conv
    from icafusion_tpu_torch.serve.engine import ServingEngine
    total = {"dual_cross_attention": 0, "greedy_nms": 0, "conv3x3_bn_silu": 0}
    FUSIONS = (fusion.TransformerFusionBlock, fusion.NiNfusion, fusion.Add)
    rng = np.random.default_rng(10)
    for name in FULL_WIDTH:
        t0 = phase(f"10a {name} at 640: fp32 card vs CPU (b1), bf16 serving "
                   f"(b{BATCH})")
        model = seeded_model(load_model_config(name))
        n_params = sum(p.numel() for p in model.parameters())
        towers = [m for m in model.modules()
                  if isinstance(m, (backbones.VGGblock,
                                    backbones.ResNetlayer))]
        assert not any(isinstance(m, Conv) for t in towers
                       for m in t.modules()), name
        one = [rng.integers(0, 256, (1, 640, 640, 3), np.uint8)
               for _ in range(2)]
        preds, fused = {}, {}
        for dev in ("cuda", "cpu"):
            eng = ServingEngine(model, 640, 1, conf_thres=0.001,
                                dtype="float32", device=dev)
            fused[dev] = {}
            hooks = [m.register_forward_hook(
                lambda mod, i, o, n=n, d=fused[dev]: d.__setitem__(n, o.cpu()))
                for n, m in eng.model.named_children()
                if isinstance(m, FUSIONS)]
            with torch.inference_mode():
                x, y = (torch.from_numpy(a).to(dev).permute(0, 3, 1, 2)
                        .float() / 255 for a in one)
                preds[dev] = eng.model(x, y).cpu()
            for h in hooks:
                h.remove()
            del eng
        torch.testing.assert_close(preds["cuda"], preds["cpu"], rtol=1e-3,
                                   atol=1e-3)
        err = (preds["cuda"] - preds["cpu"]).abs().max().item()
        # the fused P3/P4/P5 maps, where the attention kernel enters: max
        # |card - CPU| within 1e-3 of the map's largest value
        rel = {n: ((fused["cuda"][n] - v).abs().max()
                   / v.abs().max()).item()
               for n, v in fused["cpu"].items()}
        assert len(rel) == 3 and max(rel.values()) <= 1e-3, rel
        engine = ServingEngine(model, 640, BATCH, conf_thres=0.001,
                               dtype="bfloat16")
        pair = [rng.integers(0, 256, (BATCH, 640, 640, 3), np.uint8)
                for _ in range(2)]
        engine.predict_arrays(*pair)                      # warm-up
        torch.cuda.synchronize()
        req_ms = []

        def serve():
            for _ in range(FULL_REQUESTS):
                t = time.perf_counter()
                out = engine.predict_arrays(*pair)
                req_ms.append(1e3 * (time.perf_counter() - t))
            return out

        out, launches = counted(serve)
        want = expected_launches(engine.model, FULL_REQUESTS)
        assert launches == want, (name, launches, want)
        assert len(out) == BATCH and all(
            x.ndim == 2 and x.shape[1] == 6 and np.isfinite(x).all()
            for x in out), [x.shape for x in out]
        for k, v in launches.items():
            total[k] += v
        on_card = [shard_batch(torch.from_numpy(a).cuda(), engine.mesh)
                   for a in pair]
        dev_ms = device_ms(lambda: engine._serve(*on_card), iters=5,
                           warmup=1)
        print(f"   {n_params / 1e6:.1f} M parameters; fp32 decoded "
              f"predictions card vs CPU max |diff| {err:.3g} (rtol/atol "
              f"1e-3), fused maps max |diff| / max |CPU| "
              f"{max(rel.values()):.3g}; bf16 request of {BATCH}: device "
              f"{dev_ms:.3f} ms (forward + NMS on uploaded pairs, "
              f"{timing_source()}), "
              f"predict_arrays host clock "
              f"{[round(x, 1) for x in req_ms]} ms; launches in "
              f"{FULL_REQUESTS} requests {launches}; detections per image "
              f"{[len(x) for x in out]}; {card}")
        del model, engine, preds
        torch.cuda.empty_cache()
        done(t0)
    return total


def all_configs_slice():
    """Phase 10b: every configs/models/*.yaml and zoo:dmaf:n on the card at
    ALL_CONFIGS_SIZE, batch 1, bf16, seeded weights: finite decoded
    predictions and one (k, 6) detection array, launches as
    expected_launches."""
    from icafusion_tpu_torch.cli._common import resolve_model_config
    from icafusion_tpu_torch.serve.engine import ServingEngine
    specs = sorted(p.name for p in (REPO / "configs" / "models").glob(
        "*.yaml")) + ["zoo:dmaf:n"]
    assert len(specs) == 22, specs
    S = ALL_CONFIGS_SIZE
    rng = np.random.default_rng(11)
    pair = [rng.integers(0, 256, (1, S, S, 3), np.uint8) for _ in range(2)]
    for spec in specs:
        t = time.perf_counter()
        model = seeded_model(resolve_model_config(spec, nc=3))
        engine = ServingEngine(model, S, 1, conf_thres=0.001,
                               dtype="bfloat16")
        build_s = time.perf_counter() - t
        with torch.inference_mode():
            x, y = (torch.from_numpy(a).cuda().permute(0, 3, 1, 2).float()
                    .div(255).to(torch.bfloat16) for a in pair)
            pred = engine.model(x, y)
        assert bool(torch.isfinite(pred).all()), spec
        t = time.perf_counter()
        out, launches = counted(lambda: engine.predict_arrays(*pair))
        ms = 1e3 * (time.perf_counter() - t)
        assert launches == expected_launches(engine.model, 1), (spec,
                                                                 launches)
        assert len(out) == 1 and out[0].ndim == 2 and out[0].shape[1] == 6
        assert np.isfinite(out[0]).all(), spec
        n_params = sum(p.numel() for p in model.parameters())
        print(f"   {spec:34s} {n_params / 1e6:6.1f} M  pred "
              f"{tuple(pred.shape)}  {len(out[0]):3d} detections  request "
              f"{ms:6.1f} ms (host, first)  launches "
              f"{list(launches.values())}  built in {build_s:.1f} s")
        del model, engine, pred
        torch.cuda.empty_cache()


# Trainer steps of phase 10c: as many as rounding alone leaves the
# comparison well inside phase 6a's tolerances, as the one-ulp probe that
# 10c prints at these counts and at two and three steps shows (PERF.md,
# section 6). At three steps the CPU's own loss items move by about 1e-4
# for the nin kind and the narrow ResNet50, the loss tolerance itself; the
# VGG16 towers have no normalisation, and the narrow VGG16's training is
# chaotic from its second step (its state moves by 0.02, twenty times
# STATE_ATOL). Every count holds the first step's gradients.
FAMILY_STEPS = {"tiny nin": 2, "tiny add": 2, "tiny dmaf": 2,
                "narrow vgg16": 1, "narrow resnet50": 2}


def train_families_card_vs_cpu():
    """Phase 10c: phase 6a's card-against-CPU Trainer check for the nin,
    add and dmaf zoo kinds and the narrow VGG16 and ResNet50 configs."""
    from icafusion_tpu_torch.models.zoo import tiny_icafusion_config
    for tag, cfg in [(f"tiny {k}", tiny_icafusion_config(fusion=k))
                     for k in ("nin", "add", "dmaf")] + [
            (f"narrow {k}", narrow_config(k)) for k in ("vgg16", "resnet50")]:
        print(f"   {tag}:")
        steps = FAMILY_STEPS[tag]
        train_card_vs_cpu(cfg, steps, ulp_probe=sorted({steps, 2, 3}))
