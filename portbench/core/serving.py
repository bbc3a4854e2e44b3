"""What the serving cells share: the measured engine built from a
configuration and the run's weights, the capture of what its timed calls
produced, the plain reference in its place (the int4 control), and the
comparison that decides ``correct``.

The comparison takes a sample of the window's device batches, drawn from
the seed (a reservoir, so the whole window is covered), and for each
sampled image three stages of what the timed path produced:

- the forward: the three Detect levels' logits against the reference's own
  forward of the same input pair (from the pool, in fp32 with TF32 off;
  for an int8 configuration with its own calibration and W8A8 weights),
  e = ||served - reference|| / ||reference||;
- Detect's decode: the served decoded predictions against the reference's
  decode of the served logits (at most 1e-3 apart, boxes in canvas
  widths, scores as they are);
- NMS and the copy back: the returned detections against the reference's
  NMS of the served decoded predictions (the same count and classes, boxes
  within 1e-3 px, scores within 1e-6).

An image whose decode or detections the reference does not reproduce
counts e = UNREPRODUCED. The number compared, ``served_err``, is the root
mean square of e over the sampled images.

A second number catches an answer that belongs to another image, which
``served_err`` dilutes: random weights answer two scenes alike, so such an
answer reads little further from the reference than a sound int8 one
does. ``identity_ratio`` is, over the sampled images, the largest ratio of
an image's distance to its own reference logits over its distance to the
nearest other image's of its batch: under 1 where each answer is nearest
its own image.

An int8 configuration states W8A8 on every Conv but Detect's feeders.
Its logits alone do not pin that: a float engine reads about as far from
the W8A8 reference as the int8 engine does. So on a card a second number,
``w8a8_convs_missing``, holds the int8 conv kernel's launches a forward
over the window against the number of convs the reference quantized:
max(0, quantized - launches / forwards), limit 0.

The reference never reads the program's weights: it takes the harness's
state dict, works out int8 scales and weights again from the same
calibration batches, and reads the program's outputs only to judge them.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.core.inputs import make_pool, make_weights, rng
from portbench.reference import model as refm
from portbench.reference.nms import nms as ref_nms

UNREPRODUCED = 100.0  # e of an image whose decode or NMS is not reproduced
FIT_PAIRS = 8         # pairs whose statistics the BatchNorms take
REF_CHUNK = 8         # images a reference forward takes at once


class tf32_off:
    """TF32 off for the reference's float32 products, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def to_nchw(a: np.ndarray, device) -> torch.Tensor:
    """(n, H, W, 3) uint8 -> (n, 3, H, W) float32 in [0, 1] on device."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device).permute(
        0, 3, 1, 2).float() / 255.0


def reference_model(config: dict, state: Dict[str, torch.Tensor],
                    device) -> refm.Model:
    with torch.device(device):
        m = refm.Model(config["model"])
    m.load_state_dict(state, strict=True)
    return m.eval()


def quantized_reference(config: dict, inputs: "Inputs", batch: int, device,
                        q: int) -> refm.Model:
    """The reference with its own calibration on the run's calibration
    batches and its own W8A8 (q = 127) or W4A4 (q = 7) weights."""
    m = reference_model(config, inputs.state, device)
    with tf32_off(), torch.no_grad():
        am = refm.calibrate(m, ((to_nchw(r, device), to_nchw(i, device))
                                for r, i in inputs.calib_batches(batch)))
    m.n_quantized = refm.quantize(m, am, q=q)
    return m


class Inputs:
    """The run's pool and weights, from the seed: what both sides get."""

    def __init__(self, config: dict, seed: int, pool: int, device):
        self.config, self.seed, self.device = config, seed, device
        self.rgb, self.ir, self.labels = make_pool(
            seed, pool, tuple(config["frame"]), tuple(config["canvas"]),
            int(config["model"]["nc"]))
        self.state = self.weights()

    def weights(self) -> Dict[str, torch.Tensor]:
        """The state dict: the draws of make_weights, then each BatchNorm's
        statistics fitted on the pool's first FIT_PAIRS pairs."""
        with torch.device("meta"):
            meta = refm.Model(self.config["model"])
        state = make_weights(meta, self.seed, self.device)
        m = reference_model(self.config, state, self.device)
        n = min(FIT_PAIRS, len(self.rgb))
        with tf32_off():
            refm.fit_batchnorm(m, to_nchw(self.rgb[:n], self.device),
                               to_nchw(self.ir[:n], self.device))
        out = {k: v.detach().clone() for k, v in m.state_dict().items()}
        del m
        return out

    def calib_batches(self, batch: int) -> List[tuple]:
        """The int8 calibration set: the pool's first ``calib_batches``
        batches of ``batch`` pairs, uint8."""
        k = int(self.config.get("calib_batches", 2))
        return [(self.rgb[i * batch:(i + 1) * batch],
                 self.ir[i * batch:(i + 1) * batch]) for i in range(k)]


def build_engine(config: dict, inputs: Inputs, batch: int, device,
                 int8: Optional[bool] = None):
    """The measured package's ServingEngine on the run's weights, in the
    configuration's dtype, quantized to W8A8 on the calibration batches
    where the configuration says int8 (or ``int8`` forces it)."""
    from icafusion_tpu_torch.config import load_model_config
    from icafusion_tpu_torch.models.assembler import ICAFusionModel
    from icafusion_tpu_torch.serve.engine import ServingEngine
    s = config["serve"]
    dev = torch.device(device)
    with torch.device(dev):
        model = ICAFusionModel(load_model_config(config["model"]))
    model = model.to(dev)
    model.load_state_dict(inputs.state, strict=True)
    engine = ServingEngine(model, tuple(config["canvas"]), batch_size=batch,
                           conf_thres=s["conf_thres"],
                           iou_thres=s["iou_thres"], max_det=s["max_det"],
                           dtype=config["dtype"], device=dev)
    q = config["precision"] == "int8" if int8 is None else int8
    if q:
        cal = inputs.calib_batches(batch)
        engine.quantize(calib_pairs=cal)
    return engine


def int8_launches() -> int:
    """The measured package's count of int8 conv kernel launches so far
    (its wrapper's counter; the CPU's plain version launches nothing)."""
    from icafusion_tpu_torch.kernels.conv_int8 import conv_int8_bn_act
    return int(conv_int8_bn_act.launches)


class ReferenceServer:
    """The reference put in the program's place, quantized with ``q``
    levels a side, its forward and NMS behind ``predict_arrays``: the
    control of an int8 configuration, at q = 7."""

    def __init__(self, config: dict, inputs: Inputs, batch: int, device,
                 q: int):
        self.config, self.device = config, torch.device(device)
        self.model = quantized_reference(config, inputs, batch, self.device,
                                         q)

    @torch.no_grad()
    def predict_arrays(self, rgb, ir) -> List[np.ndarray]:
        s = self.config["serve"]
        with tf32_off():
            pred, _ = self.model(to_nchw(rgb, self.device),
                                 to_nchw(ir, self.device))
        return ref_nms(pred, s["conf_thres"], s["iou_thres"], s["max_det"],
                       s["top_k"])


def make_server(ctx, inputs, batch):
    """The engine of the configuration or, for the control, the nearest
    precision below it: the program's own int8 path under a bf16
    configuration, the reference at int4 under an int8 one."""
    cfg = ctx.config
    if ctx.control and cfg["precision"] == "int8":
        return ReferenceServer(cfg, inputs, batch, ctx.device, q=7)
    return build_engine(cfg, inputs, batch, ctx.device,
                        int8=True if ctx.control else None)


class Capture:
    """Forward hooks on the served model that keep, for a sample of its
    forwards, the input images, Detect's level logits and the decoded
    predictions (references to the device tensors, no copy), and the host
    time at which every forward returned. The sample is a reservoir of
    ``k`` forwards drawn with the seed's generator, counted from
    ``start()``."""

    def __init__(self, model: torch.nn.Module, k: int, seed: int):
        self.k, self.g = k, rng(seed, 7)
        self.n, self.on = 0, False
        self.slots: List[dict] = []
        self.ends: List[float] = []      # host time each forward returned
        self.cur: Optional[dict] = None
        last = max(int(n[1:]) for n, _ in model.named_children()
                   if n[1:].isdigit())
        det = model.get_submodule(f"m{last}")
        self.handles = [model.register_forward_pre_hook(self._pre),
                        model.register_forward_hook(self._post)]
        i = 0
        while hasattr(det, f"m{i}"):
            self.handles.append(getattr(det, f"m{i}").register_forward_hook(
                self._level))
            i += 1

    def start(self):
        self.n, self.on, self.slots, self.ends = 0, True, [], []

    def stop(self):
        self.on = False

    def _pre(self, m, args):
        self.cur = None
        if not self.on:
            return
        i, self.n = self.n, self.n + 1
        if i < self.k:
            slot = i
        else:
            j = int(self.g.integers(0, i + 1))
            slot = j if j < self.k else None
        if slot is not None:
            self.cur = {"index": i, "slot": slot, "rgb": args[0],
                        "ir": args[1] if len(args) > 1 else args[0],
                        "logits": []}

    def _level(self, m, args, out):
        if self.cur is not None:
            self.cur["logits"].append(out)

    def _post(self, m, args, out):
        if self.on:
            self.ends.append(time.perf_counter())
        if self.cur is None:
            return
        c, self.cur = self.cur, None
        c["pred"] = out[0] if isinstance(out, (tuple, list)) else out
        if c["slot"] < len(self.slots):
            self.slots[c["slot"]] = c
        else:
            self.slots.append(c)

    def host(self) -> List[dict]:
        """The sampled forwards, copied to the host, in forward order."""
        out = []
        for c in sorted(self.slots, key=lambda c: c["index"]):
            out.append({"index": c["index"],
                        "rgb": c["rgb"].float().cpu(),
                        "ir": c["ir"].float().cpu(),
                        "logits": [t.float().cpu() for t in c["logits"]],
                        "pred": c["pred"].float().cpu()})
        return out

    def remove(self):
        for h in self.handles:
            h.remove()


def match_pool(x: torch.Tensor, pool: np.ndarray) -> List[Optional[int]]:
    """For each image of a served batch (N, 3, H, W) in [0, 1], the index of
    the pool pair it was made from, by the nearest mean absolute
    difference on a fixed grid of pixels; None for a padding image (all
    zeros)."""
    n_h, n_w = x.shape[2], x.shape[3]
    ys = np.linspace(0, n_h - 1, 48).astype(int)
    xs = np.linspace(0, n_w - 1, 48).astype(int)
    p = torch.from_numpy(pool[:, ys][:, :, xs].astype(np.float32) / 255.0)
    p = p.permute(0, 3, 1, 2)                       # (P, 3, 48, 48)
    out = []
    for img in x:
        if not bool(img.abs().amax() > 0):
            out.append(None)
            continue
        s = img[:, ys][:, :, xs]
        out.append(int((p - s[None]).abs().mean((1, 2, 3)).argmin()))
    return out


def same_detections(a: np.ndarray, b: np.ndarray) -> bool:
    if a.shape != b.shape:
        return False
    if not len(a):
        return True
    return (np.abs(a[:, :4] - b[:, :4]).max() <= 1e-3
            and np.abs(a[:, 4] - b[:, 4]).max() <= 1e-6
            and np.array_equal(a[:, 5], b[:, 5]))


@torch.no_grad()
def compare(config: dict, inputs: Inputs, samples: List[dict],
            rows_pool: List[List[Optional[int]]],
            served: List[list], device, batch: int,
            launches: Optional[tuple] = None) -> Dict[str, float]:
    """The module docstring's numbers, and their parts for the log.
    ``rows_pool[k][j]``: the pool index of image j of sample k (None:
    padding); ``served[k][j]``: the detections returned for it;
    ``launches``: (int8 conv launches, forwards) over the window, on a
    card."""
    s = config["serve"]
    canvas = float(max(config["canvas"]))
    ref = (quantized_reference(config, inputs, batch, device, 127)
           if config["precision"] == "int8"
           else reference_model(config, inputs.state, device))
    det = ref.get_submodule(f"m{ref.rows[-1][0]}")
    errs, gaps, ratios, mismatched = [], [], [], 0
    for k, smp in enumerate(samples):
        # images the served forward did not produce count as unreproduced
        held = min(t.shape[0] for t in smp["logits"] + [smp["pred"]])
        lost = sum(1 for j, p in enumerate(rows_pool[k])
                   if p is not None and j >= held)
        if lost:
            errs.append(torch.full((lost,), UNREPRODUCED,
                                   dtype=torch.float64))
        rows = [j for j, p in enumerate(rows_pool[k])
                if p is not None and j < held]
        if not rows:
            continue
        idx = [rows_pool[k][j] for j in rows]
        got, want_l = [], []
        for c0 in range(0, len(rows), REF_CHUNK):
            jj, pp = rows[c0:c0 + REF_CHUNK], idx[c0:c0 + REF_CHUNK]
            with tf32_off():
                _, lref = ref(to_nchw(inputs.rgb[pp], device),
                              to_nchw(inputs.ir[pp], device))
            want_l.append(torch.cat([lr.double().flatten(1) for lr in lref],
                                    1))
            got.append(torch.cat([lv[jj].to(device).double().flatten(1)
                                  for lv in smp["logits"]], 1))
        want_l, got = torch.cat(want_l), torch.cat(got)
        dist = torch.cdist(got, want_l)         # served i against ref j
        e = (dist.diagonal() / want_l.norm(dim=1)).cpu()
        if len(rows) > 1:
            other = dist + torch.diag(torch.full((len(rows),), math.inf,
                                                 dtype=dist.dtype,
                                                 device=dist.device))
            ratios.append((dist.diagonal() / other.amin(1)).cpu())
        del want_l, got, dist
        dec = torch.cat([refm.decode_level(lv[rows].to(device), det.na,
                                           det.no, det.strides[i],
                                           det.anchors_px[i])
                         for i, lv in enumerate(smp["logits"])], 1)
        pred = smp["pred"][rows].to(device)
        gap = (dec - pred).abs()
        gap[..., :4] /= canvas
        gap = gap.flatten(1).amax(1).cpu()
        want = ref_nms(pred, s["conf_thres"], s["iou_thres"], s["max_det"],
                       s["top_k"])
        for n, (w, j) in enumerate(zip(want, rows)):
            got = served[k][j]
            same = got is not None and same_detections(got, w)
            mismatched += not same
            if not same or gap[n] > 1e-3:
                e[n] = UNREPRODUCED
        errs.append(e)
        gaps.append(gap)
    e = torch.cat(errs) if errs else torch.full((1,), UNREPRODUCED)
    out = {}
    if config["precision"] == "int8" and launches is not None:
        n, forwards = launches
        out["w8a8_convs_missing"] = max(
            0.0, ref.n_quantized - n / max(forwards, 1))
    if ratios:
        out["identity_ratio"] = float(torch.cat(ratios).max())
    return {"served_err": float(e.pow(2).mean().sqrt()), **out,
            "parts": {"images": int(e.numel()),
                      "max_image_err": float(e.max()),
                      "decode_gap": float(torch.cat(gaps).max())
                      if gaps else None,
                      "nms_mismatched": mismatched}}


def judge(config: dict, numbers: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} of the numbers that the configuration
    gives a limit; the parts and the numbers it does not compare (kept for
    the readings) go to stderr."""
    import sys
    lim = config.get("limits", {})
    rest = {k: v for k, v in numbers.items() if k not in lim}
    print(f"compared: {rest}", file=sys.stderr)
    return {k: {"value": v, "limit": lim[k]} for k, v in numbers.items()
            if k in lim}


def passed(checks: Dict[str, dict]) -> bool:
    """Every compared number within its limit, and at least one compared."""
    return bool(checks) and all(c["limit"] is not None and math.isfinite(c["value"])
               and c["value"] <= c["limit"] for c in checks.values())
