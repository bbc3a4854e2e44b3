"""Plain float32 PyTorch reference of the two-stream YOLOv5 + DMFF detector.

The graph of the ICAFusion YAMLs (github.com/chanchanchan97/ICAFusion,
models/transformer/yolov5l_Transfusion_FLIR.yaml; models/common.py and
models/yolo_test.py there): two CSPDarknet towers (Conv + BatchNorm + SiLU,
C3, SPPF), the second reading the IR image through the ``from: -4`` row,
three TransformerFusionBlocks (DMFF), the PANet head and the Detect decode.
NCHW, no fused kernels: every conv is ``F.conv2d`` followed by BatchNorm
and SiLU, attention is einsum and softmax. In train mode (reference/
train.py) the BatchNorms take batch statistics, DMFF resizes its tokens
back by nearest neighbour, and the attention's three dropouts draw their
masks from ``Model.drop`` where it is set.

Module and parameter names follow the measured package's, so that one
state dict fills both (``m{i}``, ``cv1``, ``conv``, ``bn``, ``q_vis``...).
Departures from the published code, each the measured package's too:
DMFF resizes its tokens back with a linear (half-pixel, antialiased)
resize in eval mode; Detect emits candidates in (ny, nx, na) order.

W8A8 (``quantize``): a Conv with ``quant`` set quantizes its input per
input channel, x8 = clip(round(x / s_in), -q, q), multiplies it exactly
with the int weights (float64 products and sums, exact below 2^53), and
applies act(acc * s_w * g + (beta - mean * g)), g = gamma / sqrt(var + eps),
in float32. q = 127 is int8; q = 7 the int4 control.

``fq``, where set on a module (``Model.fake_quant``), rounds the inputs
and weights of every conv and linear product before it, with the gradient
passed straight through: the control of a training cell (fp8).

This file imports torch and numpy alone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
LN_EPS = 1e-6
NAMES = ("q_vis", "k_vis", "v_vis", "q_ir", "k_ir", "v_ir")


def autopad(k, p=None):
    return k // 2 if p is None else p


def product_in(m: nn.Module, x):
    """x as a conv or linear product of ``m`` takes it (fake-quantized
    where ``m.fq`` is set)."""
    fq = getattr(m, "fq", None)
    return x if fq is None else fq(x)


def conv2d(m: nn.Conv2d, x):
    """m(x), its products rounded where ``m.fq`` is set."""
    if getattr(m, "fq", None) is None:
        return m(x)                     # a module call: hooks see it
    return F.conv2d(product_in(m, x), product_in(m, m.weight), m.bias,
                    m.stride, m.padding, m.dilation, m.groups)


def linear(m: nn.Linear, x):
    if getattr(m, "fq", None) is None:
        return m(x)
    return F.linear(product_in(m, x), product_in(m, m.weight), m.bias)


class Conv(nn.Module):
    """Conv2d (no bias) + eval BatchNorm + optional SiLU."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p), groups=g,
                              bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS)
        self.act = act
        self.quant: Optional[Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor, int]] = None
        self.record = False
        self.absmax: Optional[torch.Tensor] = None

    def forward(self, x):
        if self.quant is not None:
            return self._int(x)
        if self.record:
            a = x.detach().abs().amax(dim=(0, 2, 3)).float()
            self.absmax = a if self.absmax is None else torch.maximum(
                self.absmax, a)
        if self.training:                   # batch statistics
            y = self.bn(conv2d(self.conv, x))
            return F.silu(y) if self.act else y
        y = F.batch_norm(conv2d(self.conv, x), self.bn.running_mean,
                         self.bn.running_var, self.bn.weight, self.bn.bias,
                         False, 0.0, self.bn.eps)
        return F.silu(y) if self.act else y

    def _int(self, x):
        w_int, s_in, s_w, q = self.quant
        s = s_in.reshape(-1, 1, 1) if s_in.dim() else s_in
        x8 = torch.clamp(torch.round(x.float() / s), -q, q)
        acc = F.conv2d(x8.double(), w_int, None, self.conv.stride,
                       self.conv.padding, 1, self.conv.groups).float()
        bn = self.bn
        g = bn.weight.float() * (1.0 / torch.sqrt(bn.running_var.float()
                                                  + bn.eps))
        mult = s_w * g
        add = bn.bias.float() - bn.running_mean.float() * g
        y = acc * mult[:, None, None] + add[:, None, None]
        return F.silu(y) if self.act else y


class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True, g=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_, c2, 3, 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c_, c_, shortcut, g, e=1.0))

    def forward(self, x):
        y = self.cv1(x)
        for i in range(self.n):
            y = getattr(self, f"m{i}")(y)
        return self.cv3(torch.cat([y, self.cv2(x)], 1))


class SPPF(nn.Module):
    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.k = k

    def forward(self, x):
        x = self.cv1(x)
        y1 = F.max_pool2d(x, self.k, 1, self.k // 2)
        y2 = F.max_pool2d(y1, self.k, 1, self.k // 2)
        y3 = F.max_pool2d(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


class Concat(nn.Module):
    def __init__(self, d=1):
        super().__init__()
        self.d = d

    def forward(self, xs):
        return torch.cat(list(xs), self.d)


class Upsample(nn.Module):
    def __init__(self, size=None, scale=2, mode="nearest"):
        super().__init__()
        if size is not None or mode != "nearest" or scale != int(scale):
            raise ValueError("only integer nearest upsampling is modelled")
        self.s = int(scale)

    def forward(self, x):
        return x.repeat_interleave(self.s, 2).repeat_interleave(self.s, 3)


def adaptive_pool2d(x, oh: int, ow: int, kind: str):
    """Floor-mode pooling to (oh, ow) where the map is at least that large
    (the published code's stride = in // out, kernel = in - (out-1)*stride),
    true adaptive pooling otherwise."""
    h, w = x.shape[-2:]
    if (h, w) == (oh, ow):
        return x
    if h >= oh and w >= ow:
        sh, sw = h // oh, w // ow
        k = (h - (oh - 1) * sh, w - (ow - 1) * sw)
        return (F.avg_pool2d if kind == "avg" else F.max_pool2d)(x, k,
                                                                (sh, sw))
    return (F.adaptive_avg_pool2d if kind == "avg"
            else F.adaptive_max_pool2d)(x, (oh, ow))


def linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of a half-pixel linear resize whose triangle
    kernel widens by in/out when downsampling, rows normalised to 1."""
    scale = np.float32(n_out) / np.float32(n_in)
    inv = np.float32(1.0) / scale
    kscale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    d = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0.0), np.float32(1.0) - d / kscale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0)
    return np.ascontiguousarray(w.T, dtype=np.float32)


def resize_linear(x, oh: int, ow: int):
    h, w = x.shape[-2:]
    wh = torch.from_numpy(linear_resize_matrix(h, oh)).to(x.device, x.dtype)
    ww = torch.from_numpy(linear_resize_matrix(w, ow)).to(x.device, x.dtype)
    return torch.einsum("bchw,Hh,Ww->bcHW", x, wh, ww)


class LearnableWeights(nn.Module):
    def __init__(self):
        super().__init__()
        self.w1 = nn.Parameter(torch.full((1,), 0.5))
        self.w2 = nn.Parameter(torch.full((1,), 0.5))

    def forward(self, a, b):
        return a * self.w1 + b * self.w2


class CrossAttention(nn.Module):
    """Each modality's values attended by the other modality's queries."""

    def __init__(self, d, h=8):
        super().__init__()
        self.h = h
        for n in NAMES:
            self.add_module(n, nn.Linear(d, d))
        self.ln_vis = nn.LayerNorm(d, eps=LN_EPS)
        self.ln_ir = nn.LayerNorm(d, eps=LN_EPS)
        self.out_vis = nn.Linear(d, d)
        self.out_ir = nn.Linear(d, d)
        self.drop = None        # train mode: the dropout (Model.drop)

    def forward(self, vis, ir):
        b, n, d = vis.shape
        dk = d // self.h
        vn, irn = self.ln_vis(vis), self.ln_ir(ir)
        drop = self.drop if self.training and self.drop else (lambda x: x)

        def heads(x, name):
            return linear(getattr(self, name), x).reshape(
                b, n, self.h, dk).transpose(1, 2)

        def attend(q, k, v):
            a = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k)
                              / math.sqrt(dk), dim=-1)
            o = torch.einsum("bhqk,bhkd->bhqd", drop(a), v)
            return o.transpose(1, 2).reshape(b, n, d)

        a_vis = attend(heads(irn, "q_ir"), heads(vn, "k_vis"),
                       heads(vn, "v_vis"))
        a_ir = attend(heads(vn, "q_vis"), heads(irn, "k_ir"),
                      heads(irn, "v_ir"))
        o_vis = drop(linear(self.out_vis, a_vis))
        return o_vis, drop(linear(self.out_ir, a_ir))


class CrossTransformerBlock(nn.Module):
    def __init__(self, d, h=8, block_exp=4):
        super().__init__()
        self.crossatt = CrossAttention(d, h)
        self.mlp_ln = nn.LayerNorm(d, eps=LN_EPS)
        for m in ("mlp_vis", "mlp_ir"):
            self.add_module(f"{m}_fc1", nn.Linear(d, block_exp * d))
            self.add_module(f"{m}_fc2", nn.Linear(block_exp * d, d))
        self.coefficients = nn.Parameter(torch.ones(8))
        self.drop = None

    def _mlp(self, name, x):
        y = F.gelu(linear(getattr(self, f"{name}_fc1"), self.mlp_ln(x)),
                   approximate="none")
        y = linear(getattr(self, f"{name}_fc2"), y)
        return self.drop(y) if self.training and self.drop else y

    def forward(self, vis, ir):
        c = self.coefficients
        a_vis, a_ir = self.crossatt(vis, ir)
        vis_att = c[0] * vis + c[1] * a_vis
        ir_att = c[2] * ir + c[3] * a_ir
        vis = c[4] * vis_att + c[5] * self._mlp("mlp_vis", vis_att)
        ir = c[6] * ir_att + c[7] * self._mlp("mlp_ir", ir_att)
        return vis, ir


class TransformerFusionBlock(nn.Module):
    """DMFF: pool both maps to the anchor grid (avg and max, blended by
    learnable weights), add positional embeddings, one cross transformer,
    resize back, add as a residual, concatenate, 1x1 Conv."""

    def __init__(self, d, va, ha, h=8, block_exp=4):
        super().__init__()
        self.grid = (va, ha)
        self.pos_emb_vis = nn.Parameter(torch.zeros(1, va * ha, d))
        self.pos_emb_ir = nn.Parameter(torch.zeros(1, va * ha, d))
        self.vis_coefficient = LearnableWeights()
        self.ir_coefficient = LearnableWeights()
        self.crosstransformer0 = CrossTransformerBlock(d, h, block_exp)
        self.conv1x1_out = Conv(2 * d, d, 1, 1, 0)

    def _flat(self, x, coeff, pos):
        va, ha = self.grid
        y = coeff(adaptive_pool2d(x, va, ha, "avg"),
                  adaptive_pool2d(x, va, ha, "max"))
        return y.flatten(2).transpose(1, 2) + pos

    def _up(self, flat, x):
        b, c, hh, ww = x.shape
        y = flat.transpose(1, 2).reshape(b, c, *self.grid)
        if self.training:       # nearest: input floor(i * in / out)
            iy, ix = (torch.div(torch.arange(n, device=x.device) * g, n,
                                rounding_mode="floor")
                      for g, n in zip(self.grid, (hh, ww)))
            return x + y[:, :, iy][:, :, :, ix]
        return x + resize_linear(y, hh, ww)

    def forward(self, xs):
        vis, ir = xs
        v = self._flat(vis, self.vis_coefficient, self.pos_emb_vis)
        r = self._flat(ir, self.ir_coefficient, self.pos_emb_ir)
        v, r = self.crosstransformer0(v, r)
        return self.conv1x1_out(torch.cat([self._up(v, vis), self._up(r, ir)],
                                          1))


def anchor_order(anchors: np.ndarray, strides: Sequence[int]) -> np.ndarray:
    """Flip the levels where their area order disagrees with the strides."""
    a = anchors.reshape(len(strides), -1, 2)
    da = a.prod(-1).mean(-1)[-1] - a.prod(-1).mean(-1)[0]
    return a[::-1].copy() if np.sign(da) != np.sign(strides[-1] - strides[0]) \
        else a


class Detect(nn.Module):
    """1x1 conv per level to na * (nc + 5) logits, decoded in float32:
    xy = (sig * 2 - 0.5 + grid) * stride, wh = (sig * 2)^2 * anchor."""

    def __init__(self, nc, anchors, ch):
        super().__init__()
        self.nc, self.nl = nc, len(anchors)
        self.na, self.no = len(anchors[0]) // 2, nc + 5
        self.strides = tuple(8 * 2 ** i for i in range(self.nl))
        a = np.asarray(anchors, np.float32).reshape(self.nl, self.na, 2)
        self.anchors_px = anchor_order(a, self.strides)
        for i, c in enumerate(ch):
            self.add_module(f"m{i}", nn.Conv2d(c, self.no * self.na, 1))

    def forward(self, xs):
        """(decoded (B, N, 5 + nc), [level logits (B, na * no, ny, nx)])."""
        logits, z = [], []
        for i, x in enumerate(xs):
            t = conv2d(getattr(self, f"m{i}"), x)
            logits.append(t)
            z.append(decode_level(t, self.na, self.no, self.strides[i],
                                  self.anchors_px[i]))
        return torch.cat(z, 1), logits


def decode_level(t, na: int, no: int, stride: int, anchors_px) -> torch.Tensor:
    """One level's logits (B, na * no, ny, nx) -> (B, ny * nx * na, no)."""
    b, _, ny, nx = t.shape
    y = t.float().view(b, na, no, ny, nx).permute(0, 3, 4, 1, 2).sigmoid()
    gy, gx = torch.meshgrid(torch.arange(ny, device=t.device,
                                         dtype=torch.float32),
                            torch.arange(nx, device=t.device,
                                         dtype=torch.float32), indexing="ij")
    grid = torch.stack([gx, gy], -1)[:, :, None, :]
    anc = torch.as_tensor(np.asarray(anchors_px, np.float32), device=t.device)
    xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * float(stride)
    wh = (y[..., 2:4] * 2.0) ** 2 * anc
    return torch.cat([xy, wh, y[..., 4:]], -1).reshape(b, ny * nx * na, no)


def make_divisible(x, d=8):
    return int(math.ceil(x / d) * d)


def parse(cfg: dict):
    """The layer rows of a model dict (YAML keys: nc, depth_multiple,
    width_multiple, anchors, backbone, head) -> [(i, from, module name,
    constructor args, repeats)], channels inferred as parse_model does.
    Rows are [from, n, module, args]; from -4 reads the IR image."""
    nc, gd, gw = int(cfg["nc"]), cfg["depth_multiple"], cfg["width_multiple"]
    anchors = cfg["anchors"]
    no = (len(anchors[0]) // 2) * (nc + 5)
    rows = list(cfg["backbone"]) + list(cfg["head"])
    ch, out = [3], []
    for i, (f, n, m, args) in enumerate(rows):
        f = tuple(f) if isinstance(f, list) else f
        f = (tuple(x if x in (-1, -4) or x >= 0 else x % i for x in f)
             if isinstance(f, tuple) else (f if f in (-1, -4) or f >= 0
                                           else f % i))
        n = max(round(n * gd), 1) if n > 1 else n

        def src(j):
            return 3 if j == -4 else ch[j]

        reps = 1
        if m in ("Conv", "C3", "SPPF"):
            c1 = 3 if (f == -4 or i == 0) else src(f)
            c2 = args[0] if args[0] == no else make_divisible(args[0] * gw, 8)
            a = [c1, c2, *args[1:]]
            if m == "C3":
                a.insert(2, n)
            else:
                reps = n
        elif m == "Concat":
            c2, a = sum(src(x) for x in f), [args[0] if args else 1]
        elif m == "Upsample":
            c2, a = src(f), list(args)
        elif m == "TransformerFusionBlock":
            c2 = src(f[0])
            a = [c2, *args[1:]]
        elif m == "Detect":
            c2, a = -1, [nc, anchors, [src(x) for x in f]]
        else:
            raise ValueError(f"module {m} is not modelled by the reference")
        out.append((i, f, m, a, reps))
        if i == 0:
            ch = []
        ch.append(c2)
    return out


_BUILD = {"Conv": Conv, "C3": C3, "SPPF": SPPF, "Concat": Concat,
          "Upsample": Upsample, "TransformerFusionBlock":
          TransformerFusionBlock, "Detect": Detect}


class Repeat(nn.Module):
    def __init__(self, m, args, n):
        super().__init__()
        self.n = n
        for j in range(n):
            self.add_module(f"r{j}", _BUILD[m](*args))

    def forward(self, x):
        for j in range(self.n):
            x = getattr(self, f"r{j}")(x)
        return x


class Model(nn.Module):
    """forward(rgb, ir) with NCHW float images in [0, 1] -> (decoded
    predictions (B, N, 5 + nc), Detect's level logits)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.rows = parse(cfg)
        self.save = {x for _, f, *_ in self.rows
                     for x in (f if isinstance(f, tuple) else (f,))
                     if x not in (-1, -4)}
        for i, f, m, a, reps in self.rows:
            self.add_module(f"m{i}", Repeat(m, a, reps) if reps > 1
                            else _BUILD[m](*a))
        self.eval()

    def forward(self, rgb, ir):
        y: Dict[int, torch.Tensor] = {}
        out = rgb
        for i, f, m, _, _ in self.rows:
            if f == -4:
                inp = ir
            elif f == -1:
                inp = out
            elif isinstance(f, int):
                inp = y[f]
            else:
                inp = [out if j == -1 else y[j] for j in f]
            out = getattr(self, f"m{i}")(inp)
            if i in self.save:
                y[i] = out
        return out

    def set_drop(self, drop) -> None:
        """The dropout of the attention blocks in train mode: ``drop(x)``
        in the measured package's order of draws (None: no dropout)."""
        for m in self.modules():
            if isinstance(m, (CrossAttention, CrossTransformerBlock)):
                m.drop = drop

    def fake_quant(self, fq) -> None:
        """Round every conv and linear product's inputs and weights by
        ``fq`` (None: off)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.fq = fq


@torch.no_grad()
def fit_batchnorm(model: Model, rgb, ir) -> None:
    """Set every BatchNorm's running mean and variance to the statistics of
    its input on one batch, layer after layer (as a trained network's
    statistics match its data), so that each normalised map is about
    N(0, 1) before its scale and shift, whatever the random weights."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = 1.0
    model.train()
    try:
        model(rgb, ir)
    finally:
        model.eval()
        for bn in bns:
            bn.momentum = 0.1


def conv_modules(model: Model) -> List[Tuple[str, Conv]]:
    return [(n, m) for n, m in model.named_modules() if isinstance(m, Conv)]


def detect_feeders(model: Model) -> Tuple[str, ...]:
    """The convs feeding Detect that stay in float under W8A8: a C3
    feeder's cv3, another module whole."""
    i, f, *_ = model.rows[-1]
    by = {r[0]: r[2] for r in model.rows}
    return tuple(f"m{j}.cv3" if by[j] == "C3" else f"m{j}" for j in f)


@torch.no_grad()
def calibrate(model: Model, batches) -> Dict[str, torch.Tensor]:
    """Per-channel max |x| of every Conv input over the (rgb, ir) batches
    of NCHW float images."""
    convs = conv_modules(model)
    for _, m in convs:
        m.record, m.absmax = True, None
    try:
        for rgb, ir in batches:
            model(rgb, ir)
        return {n: m.absmax for n, m in convs if m.absmax is not None}
    finally:
        for _, m in convs:
            m.record, m.absmax = False, None


@torch.no_grad()
def quantize(model: Model, absmax: Dict[str, torch.Tensor], q: int = 127,
             min_scale: float = 1e-8) -> int:
    """Symmetric static W8A8 (q = 127) or W4A4 (q = 7) of every calibrated
    Conv but Detect's feeders: s_in = max(absmax / q, min_scale) per input
    channel, folded into the weights; s_w = max(max |w s_in| / q, min_scale)
    per output channel; w_int = clip(round(w s_in / s_w), -q, q). Returns
    the number of convs quantized."""
    skip = detect_feeders(model)
    n = 0
    for name, m in conv_modules(model):
        if name in absmax and not any(name == s or name.startswith(s + ".")
                                      for s in skip):
            a = absmax[name].float()
            w = m.conv.weight.float()                       # OIHW
            if m.conv.groups == 1:
                s_in = torch.clamp(a / q, min=min_scale)
                w_eff = w * s_in[None, :, None, None]
            else:
                s_in = torch.clamp(a.max() / q, min=min_scale)
                w_eff = w * s_in
            s_w = torch.clamp(w_eff.abs().amax(dim=(1, 2, 3)) / q,
                              min=min_scale)
            w_int = torch.clamp(torch.round(w_eff / s_w[:, None, None, None]),
                                -q, q)
            m.quant = (w_int.double(), s_in, s_w, q)
            n += 1
    return n
