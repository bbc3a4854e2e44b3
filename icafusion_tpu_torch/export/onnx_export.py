"""Two-stream detector -> ONNX, without the `onnx` package.

Counterpart of the JAX package's export/onnx_export.py (reference
models/export.py:85-107, which exports only the single-input model): the
full TWO-stream graph — (rgb, ir) NCHW float inputs in [0,1] -> decoded
predictions (b, N, 5+nc) in pixels, or with ``nms`` final detections —
emitted node for node as the JAX exporter emits it, so that the two
packages write the same bytes for the same weights, the producer name
aside.

Design: the exporter walks the port's ``ICAFusionModel`` (its ``resolved``
layers and their ``m{i}`` modules) and reads each module's own tensors in
float32 numpy; no flax tree is built. BN is folded into conv weights (the
standard fuse() the reference applies before export — torch_utils.py:
182-202); the graph is NCHW; every module the port builds has an emitter
(the shipped CSP / VGG16 / ResNet50 x Transfusion(DMFF) / NiNfusion / Add
families, DMAF+Add2 and the 17 legacy modules with repeated rows), except
Classify, which a Detect-terminated graph never holds. A Conv quantized by
utils/quantize.quantize_model (grouped ones too) is emitted in W8A8 QDQ
form; the fusion QLinears stay float. Opset 13, ir_version 7.

Validation: export/onnx_numpy.py executes the emitted bytes (parsed back by
onnx_proto.load) with plain numpy; ``cli.export --validate`` and the port's
tests hold them against the port's forward and the JAX exporter's bytes.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from icafusion_tpu_torch.export import onnx_proto as P
from icafusion_tpu_torch.models.detect import (check_anchor_order,
                                               default_strides)
from icafusion_tpu_torch.nn.layers import autopad as _autopad

LN_EPS = 1e-6   # flax nn.LayerNorm default, used by the fusion transformer
BN_EPS = 1e-3   # icafusion_tpu_torch.nn.layers.BN_EPS


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class OnnxGraph:
    """Tiny ONNX graph writer with static shape tracking (NCHW)."""

    def __init__(self):
        self.nodes: List[bytes] = []
        self.inits: List[bytes] = []
        self.shape: Dict[str, Tuple[int, ...]] = {}
        self._n = 0

    def fresh(self, stem: str) -> str:
        self._n += 1
        return f"{stem}_{self._n}"

    def init(self, stem: str, arr: np.ndarray) -> str:
        name = self.fresh(stem)
        self.inits.append(P.tensor_proto(name, np.ascontiguousarray(arr)))
        self.shape[name] = tuple(arr.shape)
        return name

    def node(self, op: str, inputs: List[str], out_shape: Tuple[int, ...],
             attrs: Optional[Dict[str, Any]] = None, stem: str = "") -> str:
        out = self.fresh(stem or op.lower())
        self.nodes.append(P.node_proto(op, inputs, [out], name=out, attrs=attrs))
        self.shape[out] = tuple(out_shape)
        return out

    # --- elementwise / shape helpers -------------------------------------
    def _bshape(self, a: str, b: str) -> Tuple[int, ...]:
        return tuple(np.broadcast_shapes(self.shape[a], self.shape[b]))

    def add(self, a, b):
        return self.node("Add", [a, b], self._bshape(a, b))

    def sub(self, a, b):
        return self.node("Sub", [a, b], self._bshape(a, b))

    def mul(self, a, b):
        return self.node("Mul", [a, b], self._bshape(a, b))

    def div(self, a, b):
        return self.node("Div", [a, b], self._bshape(a, b))

    def sigmoid(self, x):
        return self.node("Sigmoid", [x], self.shape[x])

    def silu(self, x):
        return self.mul(x, self.sigmoid(x))

    def relu(self, x):
        return self.node("Relu", [x], self.shape[x])

    def leaky_relu(self, x, alpha: float):
        return self.node("LeakyRelu", [x], self.shape[x], {"alpha": float(alpha)})

    def tanh(self, x):
        return self.node("Tanh", [x], self.shape[x])

    def gelu(self, x):
        """Exact GELU: 0.5*x*(1+erf(x/sqrt(2)))."""
        inv = self.const(np.float32(1.0 / math.sqrt(2.0)))
        e = self.node("Erf", [self.mul(x, inv)], self.shape[x])
        one = self.const(np.float32(1.0))
        half = self.const(np.float32(0.5))
        return self.mul(self.mul(x, half), self.add(e, one))

    def const(self, arr) -> str:
        return self.init("const", np.asarray(arr))

    def concat(self, xs: List[str], axis: int) -> str:
        shapes = [self.shape[x] for x in xs]
        out = list(shapes[0])
        ax = axis % len(out)
        out[ax] = sum(s[ax] for s in shapes)
        return self.node("Concat", xs, tuple(out), {"axis": ax})

    def reshape(self, x, new_shape: Sequence[int]) -> str:
        tgt = self.init("shape", np.asarray(new_shape, np.int64))
        n = int(np.prod(self.shape[x]))
        resolved = list(new_shape)
        if -1 in resolved:
            known = int(np.prod([d for d in resolved if d != -1]))
            resolved[resolved.index(-1)] = n // known
        return self.node("Reshape", [x, tgt], tuple(resolved))

    def transpose(self, x, perm: Sequence[int]) -> str:
        s = self.shape[x]
        return self.node("Transpose", [x], tuple(s[p] for p in perm),
                         {"perm": list(perm)})

    def slice(self, x, starts, ends, axes, steps=None) -> str:
        s = list(self.shape[x])
        stp = steps or [1] * len(axes)
        for st, en, ax, sp in zip(starts, ends, axes, stp):
            dim = self.shape[x][ax]
            st2 = min(st if st >= 0 else st + dim, dim)
            en2 = min(en if en >= 0 else en + dim, dim)
            s[ax] = max(0, -(-(en2 - st2) // sp))
        ins = [x, self.init("starts", np.asarray(starts, np.int64)),
               self.init("ends", np.asarray(ends, np.int64)),
               self.init("axes", np.asarray(axes, np.int64)),
               self.init("steps", np.asarray(stp, np.int64))]
        return self.node("Slice", ins, tuple(s))

    def matmul(self, a, b) -> str:
        sa, sb = self.shape[a], self.shape[b]
        if len(sb) == 2:
            out = sa[:-1] + (sb[1],)
        else:
            out = tuple(np.broadcast_shapes(sa[:-2], sb[:-2])) + (sa[-2], sb[-1])
        return self.node("MatMul", [a, b], out)

    def softmax(self, x, axis: int = -1) -> str:
        return self.node("Softmax", [x], self.shape[x],
                         {"axis": axis % len(self.shape[x])})

    def _reduce(self, op: str, x, axes: Sequence[int], keepdims: bool) -> str:
        s = list(self.shape[x])
        for ax in axes:
            s[ax % len(s)] = 1
        if not keepdims:
            s = [d for i, d in enumerate(s)
                 if i not in [a % len(self.shape[x]) for a in axes]]
        return self.node(op, [x], tuple(s),
                         {"axes": list(axes), "keepdims": int(keepdims)})

    def reduce_mean(self, x, axes: Sequence[int], keepdims: bool = True) -> str:
        return self._reduce("ReduceMean", x, axes, keepdims)

    def reduce_max(self, x, axes: Sequence[int], keepdims: bool = True) -> str:
        return self._reduce("ReduceMax", x, axes, keepdims)

    # --- quantization (QDQ form, opset 13) --------------------------------
    def qdq(self, x, scale, axis: Optional[int] = None) -> str:
        """Fake-quantize a tensor: QuantizeLinear -> DequantizeLinear with a
        symmetric int8 zero-point. scale: scalar (per-tensor) or 1-D array
        with ``axis`` (per-axis, standard for weights on axis 0)."""
        s_arr = np.asarray(scale, np.float32)
        s = self.init("scale", s_arr)
        zp = self.init("zp", np.zeros(s_arr.shape, np.int8))
        attrs = {} if axis is None else {"axis": int(axis)}
        x8 = self.node("QuantizeLinear", [x, s, zp], self.shape[x], attrs)
        return self.node("DequantizeLinear", [x8, s, zp], self.shape[x], attrs)

    def dequant_weight(self, w8: np.ndarray, s_w: np.ndarray) -> str:
        """int8 OIHW weight initializer + per-out-channel DequantizeLinear."""
        w = self.init("w8", w8.astype(np.int8))
        s = self.init("s_w", np.asarray(s_w, np.float32))
        zp = self.init("zp", np.zeros(s_w.shape, np.int8))
        return self.node("DequantizeLinear", [w, s, zp], w8.shape, {"axis": 0})

    # --- conv / pool / resize --------------------------------------------
    def conv(self, x, w_oihw, b: Optional[np.ndarray],
             stride=(1, 1), pads=(0, 0), group: int = 1) -> str:
        """Conv, NCHW. pads (py, px) applied symmetrically. ``w_oihw`` is
        either an ndarray (becomes an initializer) or the name of an
        already-emitted weight tensor (the QDQ path's DequantizeLinear)."""
        if isinstance(w_oihw, str):
            wn, wshape = w_oihw, self.shape[w_oihw]
        else:
            wn = self.init("w", w_oihw.astype(np.float32))
            wshape = w_oihw.shape
        ins = [x, wn]
        if b is not None:
            ins.append(self.init("b", b.astype(np.float32)))
        n, _, h, wd = self.shape[x]
        co, _, kh, kw = wshape
        oh = (h + 2 * pads[0] - kh) // stride[0] + 1
        ow = (wd + 2 * pads[1] - kw) // stride[1] + 1
        return self.node("Conv", ins, (n, co, oh, ow), {
            "strides": [int(stride[0]), int(stride[1])],
            "pads": [int(pads[0]), int(pads[1]), int(pads[0]), int(pads[1])],
            "group": int(group), "kernel_shape": [int(kh), int(kw)]})

    def pool(self, x, op: str, k, stride, pads=(0, 0)) -> str:
        n, c, h, w = self.shape[x]
        oh = (h + 2 * pads[0] - k[0]) // stride[0] + 1
        ow = (w + 2 * pads[1] - k[1]) // stride[1] + 1
        return self.node(op, [x], (n, c, oh, ow), {
            "kernel_shape": [int(k[0]), int(k[1])],
            "strides": [int(stride[0]), int(stride[1])],
            "pads": [int(pads[0]), int(pads[1]), int(pads[0]), int(pads[1])]})

    def resize(self, x, out_hw: Tuple[int, int], mode: str) -> str:
        """mode 'nearest' or 'linear' (half_pixel — torch bilinear
        align_corners=False / jax 'linear').

        Nearest follows the JAX package's Upsample (its
        nn/layers.py:482-493): an integer upscale is an exact repeat, which
        asymmetric/floor (== torch nearest) reproduces; any other ratio runs
        jax.image.resize, whose
        half-pixel source centers floor((i+0.5)*in/out) are exactly ONNX
        half_pixel + round_prefer_ceil."""
        n, c, h, w = self.shape[x]
        sizes = self.init("sizes", np.asarray([n, c, *out_hw], np.int64))
        attrs = {"mode": mode, "coordinate_transformation_mode": "half_pixel"}
        if mode == "nearest":
            if out_hw[0] % h == 0 and out_hw[1] % w == 0:
                attrs["coordinate_transformation_mode"] = "asymmetric"
                attrs["nearest_mode"] = "floor"
            else:
                attrs["nearest_mode"] = "round_prefer_ceil"
        return self.node("Resize", [x, "", "", sizes], (n, c, *out_hw), attrs)


# ---------------------------------------------------------------------------
# module emitters (mirror the port's nn layer semantics, NCHW); ``p`` is the
# port module, whose tensors are read in float32 numpy
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _bn_arrays(bn) -> Tuple[np.ndarray, ...]:
    """(gamma, beta, running mean, running var) of a BatchNorm module."""
    return (_np(bn.weight), _np(bn.bias), _np(bn.running_mean),
            _np(bn.running_var))


def _fold_bn(w_oihw: np.ndarray, bn, bias: Optional[np.ndarray] = None,
             eps: float = BN_EPS) -> Tuple[np.ndarray, np.ndarray]:
    """Fold BatchNorm running stats into (OIHW weight, bias) — the same
    conv+BN fusion as ops/fuse.py / reference torch_utils.py:182-202, in
    the JAX exporter's order of operations."""
    gamma, beta, mean, var = _bn_arrays(bn)
    scale = gamma / np.sqrt(var + eps)                      # (co,)
    w = w_oihw * scale[:, None, None, None]
    b0 = np.zeros_like(mean) if bias is None else np.asarray(bias, np.float32)
    return w, beta + (b0 - mean) * scale


def _conv_kernel(conv) -> np.ndarray:
    """OIHW weight of a bare nn.Conv2d."""
    return _np(conv.weight)


def _kernel(lin) -> np.ndarray:
    """(in, out) kernel of an nn.Linear, flax's layout."""
    return _np(lin.weight).T


class Exporter:
    """Walks the model's resolved layer list and emits ONNX nodes per
    module."""

    def __init__(self, model, nms: Optional[Tuple[float, float, int]] = None):
        self.model = model
        self.cfg = model.cfg
        self.nms = nms                    # (conf_thres, iou_thres, max_det)
        self.b = OnnxGraph()

    # -- primitive emitters -------------------------------------------------
    def conv_mod(self, x: str, p, k=1, stride=1, pad=None, g=1,
                 act=True) -> str:
        """layers.Conv: conv(bias=False)+BN+SiLU (BN folded).

        A Conv that utils/quantize.quantize_model filled (``w8``) is emitted
        in standard W8A8 QDQ form, as the JAX exporter emits one: per-tensor
        activation Quantize/DequantizeLinear (scale = max of the calibrated
        input scales — ONNX runtimes fuse per-tensor-activation QDQ into
        QLinearConv; the card keeps the finer per-channel scales), int8
        weight initializer with per-out-channel scales quantized AFTER BN
        folding, fp32 bias."""
        k2, s2 = _pair(k), _pair(stride)
        p2 = _pair(_autopad(k, pad))
        w, bias = _fold_bn(_np(p.conv.weight), p.bn)
        if p.w8 is not None:
            s_a = float(np.max(_np(p.s_in)))
            x = self.b.qdq(x, np.float32(s_a))
            s_w = np.maximum(np.abs(w).max(axis=(1, 2, 3)) / 127.0, 1e-8)
            w8 = np.clip(np.round(w / s_w[:, None, None, None]),
                         -127, 127).astype(np.int8)
            wname = self.b.dequant_weight(w8, s_w)
            y = self.b.conv(x, wname, bias, s2, p2, g)
        else:
            y = self.b.conv(x, w, bias, s2, p2, g)
        return self.b.silu(y) if act is True else y

    def bottleneck(self, x: str, p, c1: int, c2: int, shortcut: bool,
                   g: int = 1) -> str:
        y = self.conv_mod(x, p.cv1, 1, 1)
        y = self.conv_mod(y, p.cv2, 3, 1, g=g)
        return self.b.add(x, y) if (shortcut and c1 == c2) else y

    def c3(self, x: str, p, c1: int, c2: int, n: int, shortcut: bool = True,
           g: int = 1, e: float = 0.5) -> str:
        c_ = int(c2 * e)
        y1 = self.conv_mod(x, p.cv1, 1, 1)
        for i in range(n):
            y1 = self.bottleneck(y1, getattr(p, f"m{i}"), c_, c_, shortcut, g)
        y2 = self.conv_mod(x, p.cv2, 1, 1)
        y = self.b.concat([y1, y2], axis=1)
        return self.conv_mod(y, p.cv3, 1, 1)

    def bottleneck_csp(self, x: str, p, c1: int, c2: int, n: int,
                       shortcut: bool = True, g: int = 1,
                       e: float = 0.5) -> str:
        """layers.BottleneckCSP: v4-style CSP with bare cv2/cv3 convs, a
        standalone BN on the concat, and a LeakyReLU(0.1) mix."""
        c_ = int(c2 * e)
        y1 = self.conv_mod(x, p.cv1, 1, 1)
        for i in range(n):
            y1 = self.bottleneck(y1, getattr(p, f"m{i}"), c_, c_, shortcut, g)
        y1 = self.b.conv(y1, _conv_kernel(p.cv3), None)
        y2 = self.b.conv(x, _conv_kernel(p.cv2), None)
        y = self.b.concat([y1, y2], axis=1)
        y = self.bn_affine(y, p.bn)
        y = self.b.leaky_relu(y, 0.1)
        return self.conv_mod(y, p.cv4, 1, 1)

    def bn_affine(self, x: str, bn) -> str:
        """Standalone (not conv-foldable) BatchNorm as per-channel Mul+Add."""
        gamma, beta, mean, var = _bn_arrays(bn)
        scale = gamma / np.sqrt(var + BN_EPS)
        return self.b.add(
            self.b.mul(x, self.b.const(scale.reshape(1, -1, 1, 1))),
            self.b.const((beta - mean * scale).reshape(1, -1, 1, 1)))

    def sppf(self, x: str, p, k: int = 5) -> str:
        x = self.conv_mod(x, p.cv1, 1, 1)
        pd = k // 2
        y1 = self.b.pool(x, "MaxPool", (k, k), (1, 1), (pd, pd))
        y2 = self.b.pool(y1, "MaxPool", (k, k), (1, 1), (pd, pd))
        y3 = self.b.pool(y2, "MaxPool", (k, k), (1, 1), (pd, pd))
        y = self.b.concat([x, y1, y2, y3], axis=1)
        return self.conv_mod(y, p.cv2, 1, 1)

    def spp(self, x: str, p, ks=(5, 9, 13)) -> str:
        x = self.conv_mod(x, p.cv1, 1, 1)
        ys = [x] + [self.b.pool(x, "MaxPool", (k, k), (1, 1), (k // 2, k // 2))
                    for k in ks]
        return self.conv_mod(self.b.concat(ys, axis=1), p.cv2, 1, 1)

    def focus(self, x: str, p, k=1, stride=1, pad=None, g=1,
              act=True) -> str:
        sl = lambda so, eo: self.b.slice(x, [so, eo], [2**31, 2**31],
                                         [2, 3], [2, 2])
        y = self.b.concat([sl(0, 0), sl(1, 0), sl(0, 1), sl(1, 1)], axis=1)
        return self.conv_mod(y, p.conv, k, stride, pad, g, act)

    def ghost_conv(self, x: str, p, c2: int, k=1, stride=1, g=1,
                   act=True) -> str:
        """layers.GhostConv: half real features + depthwise 5x5 cheap half."""
        y = self.conv_mod(x, p.cv1, k, stride, None, g, act)
        c_ = c2 // 2
        y2 = self.conv_mod(y, p.cv2, 5, 1, None, c_, act)
        return self.b.concat([y, y2], axis=1)

    def ghost_bottleneck(self, x: str, p, c1: int, c2: int, k: int = 3,
                         stride: int = 1) -> str:
        """layers.GhostBottleneck; the two stride-2 DWConvs carry flax's
        names Conv_0 (main path) / Conv_1 (shortcut)."""
        c_ = c2 // 2
        y = self.ghost_conv(x, p.conv0, c_, 1, 1)
        if stride == 2:
            y = self.conv_mod(y, p.Conv_0, k, stride, None, c_, False)
        y = self.ghost_conv(y, p.conv2, c2, 1, 1, act=False)
        if stride == 2:
            sc = self.conv_mod(x, p.Conv_1, k, stride, None, c1, False)
            sc = self.conv_mod(sc, p.sc_pw, 1, 1, None, 1, False)
        else:
            sc = x
        return self.b.add(y, sc)

    def cross_conv(self, x: str, p, c1: int, c2: int, k: int = 3,
                   stride: int = 1, g: int = 1, e: float = 1.0,
                   shortcut: bool = False) -> str:
        """layers.CrossConv: (1,k) then (k,1) convs, optional residual."""
        y = self.conv_mod(x, p.cv1, (1, k), (1, stride))
        y = self.conv_mod(y, p.cv2, (k, 1), (stride, 1), g=g)
        return self.b.add(x, y) if (shortcut and c1 == c2) else y

    def mixconv(self, x: str, p, c1: int, c2: int, ks=(1, 3),
                stride: int = 1) -> str:
        """layers.MixConv2d: equal_ch kernel split, standalone BN,
        LeakyReLU(0.1), residual."""
        ys = []
        for g, kk in enumerate(ks):
            ys.append(self.b.conv(x, _conv_kernel(getattr(p, f"m{g}")), None,
                                  (stride, stride), (kk // 2, kk // 2)))
        y = self.b.concat(ys, axis=1)
        y = self.bn_affine(y, p.bn)
        return self.b.add(x, self.b.leaky_relu(y, 0.1))

    def contract(self, x: str, gain: int) -> str:
        """layers.Contract: space-to-depth, channel order (s, s, C)
        major->minor (the reference's NCHW permute(0,3,5,1,2,4))."""
        b = self.b
        n, c, h, w = b.shape[x]
        g = gain
        y = b.reshape(x, (n, c, h // g, g, w // g, g))
        y = b.transpose(y, (0, 3, 5, 1, 2, 4))
        return b.reshape(y, (n, g * g * c, h // g, w // g))

    def expand(self, x: str, gain: int) -> str:
        """layers.Expand: depth-to-space, inverse of contract."""
        b = self.b
        n, c, h, w = b.shape[x]
        g = gain
        y = b.reshape(x, (n, g, g, c // (g * g), h, w))
        y = b.transpose(y, (0, 3, 4, 1, 5, 2))
        return b.reshape(y, (n, c // (g * g), h * g, w * g))

    def _dense_as_conv(self, x: str, kernel, bias=None) -> str:
        """Apply a Dense kernel (cin, cout) as a 1x1 Conv on an NCHW map."""
        w = np.transpose(np.asarray(kernel, np.float32))[:, :, None, None]
        b = None if bias is None else np.asarray(bias, np.float32)
        return self.b.conv(x, w, b)

    def se_block(self, x: str, p) -> str:
        """layers.SE_Block: GAP -> fc1 -> relu -> fc2 -> sigmoid gate."""
        y = self.b.reduce_mean(x, [2, 3], True)
        y = self.b.relu(self._dense_as_conv(y, _kernel(p.fc1)))
        y = self.b.sigmoid(self._dense_as_conv(y, _kernel(p.fc2)))
        return self.b.mul(x, y)

    def channel_attention(self, x: str, p) -> str:
        """layers.ChannelAttention (CBAM channel gate): shared MLP over the
        avg- and max-pooled descriptors (flax's names Dense_0/Dense_1)."""
        def mlp(t):
            t = self.b.relu(self._dense_as_conv(t, _kernel(p.Dense_0)))
            return self._dense_as_conv(t, _kernel(p.Dense_1))
        avg = self.b.reduce_mean(x, [2, 3], True)
        mx = self.b.reduce_max(x, [2, 3], True)
        return self.b.mul(x, self.b.sigmoid(self.b.add(mlp(avg), mlp(mx))))

    def spatial_attention(self, x: str, p, k: int = 7) -> str:
        """layers.SpatialAttention (CBAM spatial gate)."""
        avg = self.b.reduce_mean(x, [1], True)
        mx = self.b.reduce_max(x, [1], True)
        y = self.b.concat([avg, mx], axis=1)
        y = self.b.conv(y, _conv_kernel(p.conv), None, (1, 1),
                        (k // 2, k // 2))
        return self.b.mul(x, self.b.sigmoid(y))

    def transformer_layer(self, x: str, p, c: int, h: int = 4) -> str:
        """layers.TransformerLayer: bare q/k/v denses feeding flax's
        MultiHeadDotProductAttention, then a 2-dense MLP, both residual."""
        b = self.b
        b_, n, _ = b.shape[x]
        dk = c // h
        q = b.matmul(x, b.const(_kernel(p.q)))
        k = b.matmul(x, b.const(_kernel(p.k)))
        v = b.matmul(x, b.const(_kernel(p.v)))

        def proj(t, name):
            dense = getattr(p.ma, name)
            kern = _np(dense.kernel)                        # (c,h,dk)
            bias = _np(dense.bias)                          # (h,dk)
            y = b.add(b.matmul(t, b.const(kern.reshape(c, h * dk))),
                      b.const(bias.reshape(h * dk)))
            y = b.reshape(y, (b_, n, h, dk))
            return b.transpose(y, (0, 2, 1, 3))

        qh, kh, vh = proj(q, "query"), proj(k, "key"), proj(v, "value")
        scale = b.const(np.float32(1.0 / math.sqrt(dk)))
        logits = b.matmul(b.mul(qh, scale), b.transpose(kh, (0, 1, 3, 2)))
        o = b.matmul(b.softmax(logits, -1), vh)
        o = b.reshape(b.transpose(o, (0, 2, 1, 3)), (b_, n, c))
        out_k = _np(p.ma.out.kernel)                         # (h,dk,c)
        o = b.add(b.matmul(o, b.const(out_k.reshape(h * dk, c))),
                  b.const(_np(p.ma.out.bias)))
        x = b.add(o, x)
        y = b.matmul(x, b.const(_kernel(p.fc1)))
        y = b.matmul(y, b.const(_kernel(p.fc2)))
        return b.add(y, x)

    def transformer_block(self, x: str, p, c: int, n_layers: int) -> str:
        """layers.TransformerBlock: flatten -> learned pos-emb -> layers."""
        b = self.b
        if hasattr(p, "conv"):
            x = self.conv_mod(x, p.conv, 1, 1)
        b_, _, hh, ww = b.shape[x]
        seq = b.reshape(b.transpose(x, (0, 2, 3, 1)), (b_, hh * ww, c))
        e = self.dense(seq, p.linear)
        y = b.add(seq, e)
        for i in range(n_layers):
            y = self.transformer_layer(y, getattr(p, f"tr{i}"), c)
        return b.transpose(b.reshape(y, (b_, hh, ww, c)), (0, 3, 1, 2))

    def c3tr(self, x: str, p, c1: int, c2: int, n: int,
             e: float = 0.5) -> str:
        """layers.C3TR: C3 whose inner stack is a TransformerBlock."""
        c_ = int(c2 * e)
        y1 = self.conv_mod(x, p.cv1, 1, 1)
        y1 = self.transformer_block(y1, p.m, c_, n)
        y2 = self.conv_mod(x, p.cv2, 1, 1)
        y = self.b.concat([y1, y2], axis=1)
        return self.conv_mod(y, p.cv3, 1, 1)

    def vggblock(self, x: str, p, num_convs: int) -> str:
        for i in range(num_convs):
            conv = getattr(p, f"conv{i}")
            y = self.b.conv(x, _conv_kernel(conv), _np(conv.bias),
                            (1, 1), (1, 1))
            x = self.b.relu(y)
        return self.b.pool(x, "MaxPool", (2, 2), (2, 2))

    def resnetblock(self, x: str, p, c1: int, c2: int, stride: int) -> str:
        def cb(xx, conv, bn, k, st, pd):
            w, bias = _fold_bn(_conv_kernel(getattr(p, conv)),
                               getattr(p, bn))
            return self.b.conv(xx, w, bias, (st, st), (pd, pd))
        out = self.b.relu(cb(x, "conv1", "bn1", 1, 1, 0))
        out = self.b.relu(cb(out, "conv2", "bn2", 3, stride, 1))
        out = cb(out, "conv3", "bn3", 1, 1, 0)
        if stride != 1 or c1 != 4 * c2:
            sc = cb(x, "shortcut_conv", "shortcut_bn", 1, stride, 0)
        else:
            sc = x
        return self.b.relu(self.b.add(out, sc))

    def resnetlayer(self, x: str, p, c1: int, c2: int, stride: int,
                    is_first: bool, num_blocks: int) -> str:
        if is_first:
            w, bias = _fold_bn(_conv_kernel(p.stem_conv), p.stem_bn)
            x = self.b.relu(self.b.conv(x, w, bias, (2, 2), (3, 3)))
            return self.b.pool(x, "MaxPool", (3, 3), (2, 2), (1, 1))
        x = self.resnetblock(x, p.blk0, c1, c2, stride)
        for i in range(1, num_blocks):
            x = self.resnetblock(x, getattr(p, f"blk{i}"), 4 * c2, c2, 1)
        return x

    # -- fusion family ------------------------------------------------------
    def nin_fusion(self, xs: List[str], p, k: int = 1) -> str:
        y = self.b.concat(xs, axis=1)
        y = self.b.conv(y, _conv_kernel(p.conv), None, (1, 1),
                        (k // 2, k // 2))
        return self.b.silu(y)

    def dmaf(self, xs: List[str]) -> Tuple[str, str]:
        x1, x2 = xs
        sub_vis = self.b.sub(x1, x2)
        sub_ir = self.b.sub(x2, x1)
        w_vis = self.b.tanh(self.b.reduce_mean(sub_vis, [2, 3], True))
        w_ir = self.b.tanh(self.b.reduce_mean(sub_ir, [2, 3], True))
        return self.b.mul(sub_vis, w_ir), self.b.mul(sub_ir, w_vis)

    def layer_norm(self, x: str, ln) -> str:
        mean = self.b.reduce_mean(x, [-1], True)
        d = self.b.sub(x, mean)
        var = self.b.reduce_mean(self.b.mul(d, d), [-1], True)
        denom = self.b.node("Sqrt",
                            [self.b.add(var, self.b.const(np.float32(LN_EPS)))],
                            self.b.shape[var])
        y = self.b.div(d, denom)
        y = self.b.mul(y, self.b.const(_np(ln.weight)))
        return self.b.add(y, self.b.const(_np(ln.bias)))

    def dense(self, x: str, lin) -> str:
        y = self.b.matmul(x, self.b.const(_kernel(lin)))
        return self.b.add(y, self.b.const(_np(lin.bias)))

    def cross_attention(self, vis: str, ir: str, p, d: int,
                        h: int = 8) -> Tuple[str, str]:
        b_, n, _ = self.b.shape[vis]
        dk = d // h
        vis_n = self.layer_norm(vis, p.ln_vis)
        ir_n = self.layer_norm(ir, p.ln_ir)

        def heads(t):
            t = self.b.reshape(t, (b_, n, h, dk))
            return self.b.transpose(t, (0, 2, 1, 3))

        pr = {k: heads(self.dense(x, getattr(p, k)))
              for k, x in (("q_vis", vis_n), ("k_vis", vis_n), ("v_vis", vis_n),
                           ("q_ir", ir_n), ("k_ir", ir_n), ("v_ir", ir_n))}
        scale = self.b.const(np.float32(1.0 / math.sqrt(dk)))

        def attend(q, k, v):
            kt = self.b.transpose(k, (0, 1, 3, 2))
            logits = self.b.mul(self.b.matmul(q, kt), scale)
            a = self.b.softmax(logits, -1)
            o = self.b.matmul(a, v)
            o = self.b.transpose(o, (0, 2, 1, 3))
            return self.b.reshape(o, (b_, n, d))

        out_vis = attend(pr["q_ir"], pr["k_vis"], pr["v_vis"])
        out_ir = attend(pr["q_vis"], pr["k_ir"], pr["v_ir"])
        return (self.dense(out_vis, p.out_vis),
                self.dense(out_ir, p.out_ir))

    def cross_transformer(self, vis: str, ir: str, p, d: int,
                          block_exp: int = 4, loops: int = 1) -> Tuple[str, str]:
        coef = _np(p.coefficients)
        c = [self.b.const(np.float32(coef[i])) for i in range(8)]

        def mlp(x, stem):
            y = self.dense(x, getattr(p, f"{stem}_fc1"))
            y = self.b.gelu(y)
            return self.dense(y, getattr(p, f"{stem}_fc2"))

        for _ in range(loops):
            a_vis, a_ir = self.cross_attention(vis, ir, p.crossatt, d)
            vis_att = self.b.add(self.b.mul(c[0], vis), self.b.mul(c[1], a_vis))
            ir_att = self.b.add(self.b.mul(c[2], ir), self.b.mul(c[3], a_ir))
            vis = self.b.add(self.b.mul(c[4], vis_att),
                             self.b.mul(c[5], mlp(self.layer_norm(vis_att, p.mlp_ln), "mlp_vis")))
            ir = self.b.add(self.b.mul(c[6], ir_att),
                            self.b.mul(c[7], mlp(self.layer_norm(ir_att, p.mlp_ln), "mlp_ir")))
        return vis, ir

    def adaptive_pool(self, x: str, out_h: int, out_w: int, op: str) -> str:
        _, _, h, w = self.b.shape[x]
        if h <= out_h and w <= out_w:
            return x
        sh, sw = h // out_h, w // out_w
        kh, kw = h - (out_h - 1) * sh, w - (out_w - 1) * sw
        return self.b.pool(x, op, (kh, kw), (sh, sw))

    def tfb(self, xs: List[str], p, d: int, va: int, ha: int,
            n_layer: int = 1) -> str:
        vis, ir = xs
        b_, c, hh, ww = self.b.shape[vis]
        seq = va * ha

        def pool_flat(x, coeff, pos):
            a = self.adaptive_pool(x, va, ha, "AveragePool")
            m = self.adaptive_pool(x, va, ha, "MaxPool")
            w1 = self.b.const(_np(getattr(p, coeff).w1))
            w2 = self.b.const(_np(getattr(p, coeff).w2))
            y = self.b.add(self.b.mul(a, w1), self.b.mul(m, w2))
            y = self.b.reshape(y, (b_, c, seq))
            y = self.b.transpose(y, (0, 2, 1))                  # (b, seq, c)
            return self.b.add(y, self.b.const(_np(getattr(p, pos))))

        vis_f = pool_flat(vis, "vis_coefficient", "pos_emb_vis")
        ir_f = pool_flat(ir, "ir_coefficient", "pos_emb_ir")
        for i in range(n_layer):
            vis_f, ir_f = self.cross_transformer(
                vis_f, ir_f, getattr(p, f"crosstransformer{i}"), d)

        def up_res(flat, x):
            y = self.b.transpose(self.b.reshape(flat, (b_, va, ha, c)),
                                 (0, 3, 1, 2))
            # eval path: bilinear half-pixel (fusion.py _up_residual)
            y = self.b.resize(y, (hh, ww), "linear")
            return self.b.add(y, x)

        y = self.b.concat([up_res(vis_f, vis), up_res(ir_f, ir)], axis=1)
        return self.conv_mod(y, p.conv1x1_out, 1, 1, 0)

    # -- Detect -------------------------------------------------------------
    def detect(self, xs: List[str], p, nc: int, anchors) -> str:
        nl = len(anchors)
        na = len(anchors[0]) // 2
        no = nc + 5
        strides = default_strides(nl)
        anchors_px = check_anchor_order(
            np.asarray(anchors, np.float32).reshape(nl, na, 2), strides)
        outs = []
        for i, x in enumerate(xs):
            b_, _, ny, nx = self.b.shape[x]
            pm = getattr(p, f"m{i}")
            t = self.b.conv(x, _conv_kernel(pm), _np(pm.bias))
            # NCHW (b, na*no, ny, nx) -> (b, ny, nx, na, no): the head's
            # (ny, nx, na) candidate order (models/detect.py)
            t = self.b.transpose(t, (0, 2, 3, 1))
            t = self.b.reshape(t, (b_, ny, nx, na, no))
            y = self.b.sigmoid(t)
            gx, gy = np.meshgrid(np.arange(nx, dtype=np.float32),
                                 np.arange(ny, dtype=np.float32))
            grid = np.stack([gx, gy], axis=-1)[None, :, :, None, :]
            anc = anchors_px[i][None, None, None, :, :].astype(np.float32)
            xy = self.b.slice(y, [0], [2], [4])
            wh = self.b.slice(y, [2], [4], [4])
            rest = self.b.slice(y, [4], [no], [4])
            two = self.b.const(np.float32(2.0))
            xy = self.b.mul(
                self.b.add(self.b.sub(self.b.mul(xy, two),
                                      self.b.const(np.float32(0.5))),
                           self.b.const(grid)),
                self.b.const(np.float32(strides[i])))
            wh2 = self.b.mul(wh, two)
            wh2 = self.b.mul(self.b.mul(wh2, wh2), self.b.const(anc))
            out = self.b.concat([xy, wh2, rest], axis=4)
            outs.append(self.b.reshape(out, (b_, ny * nx * na, no)))
        return self.b.concat(outs, axis=1)

    def nms_tail(self, pred: str, conf_thres: float, iou_thres: float,
                 max_det: int) -> str:
        """Bake NMS into the graph via the standard NonMaxSuppression op.

        The reference's ONNX export stops at the pre-NMS prediction tensor
        (models/export.py:85-107, NMS left to the consumer); this tail goes
        further and emits final detections. Semantics match ops/nms.py with
        multi_label=True (the reference's eval-mode NMS, general.py:566-568):
        per-class greedy suppression at iou_thres on conf = obj*cls, score
        gate conf > conf_thres (the reference's obj>conf candidate gate is
        implied: conf <= obj since cls is a sigmoid), up to max_det keeps
        per class (ONNX caps per class where ops/nms.py caps the padded
        total; equal whenever max_det is not binding).

        Output: (num_dets, 7) float32 rows [batch, x1, y1, x2, y2, conf, cls]
        with a dynamic (data-dependent) first dimension — batch id first so
        multi-image exports stay splittable.
        """
        b = self.b
        _, _, no = b.shape[pred]
        boxes = b.slice(pred, [0], [4], [2])           # (B,N,4) xywh center
        obj = b.slice(pred, [4], [5], [2])             # (B,N,1)
        cls = b.slice(pred, [5], [no], [2])            # (B,N,nc)
        scores = b.transpose(b.mul(cls, obj), (0, 2, 1))   # (B,nc,N)
        sel = b.node(
            "NonMaxSuppression",
            [boxes, scores,
             b.init("max_out", np.asarray([max_det], np.int64)),
             b.init("iou_t", np.asarray([iou_thres], np.float32)),
             b.init("score_t", np.asarray([conf_thres], np.float32))],
            (-1, 3), {"center_point_box": 1}, stem="nms")    # (S,3) i64
        xy = b.slice(boxes, [0], [2], [2])
        half = b.mul(b.slice(boxes, [2], [4], [2]), b.const(np.float32(0.5)))
        xyxy = b.concat([b.sub(xy, half), b.add(xy, half)], axis=2)
        bi = b.slice(sel, [0], [1], [1])               # (S,1) each, i64
        ci = b.slice(sel, [1], [2], [1])
        di = b.slice(sel, [2], [3], [1])
        box_sel = b.node("GatherND", [xyxy, b.concat([bi, di], axis=1)],
                         (-1, 4))
        sc = b.node("GatherND", [scores, sel], (-1,))
        sc = b.node("Unsqueeze",
                    [sc, b.init("axes", np.asarray([1], np.int64))], (-1, 1))

        def to_f(t):
            return b.node("Cast", [t], b.shape[t], {"to": P.FLOAT})

        return b.concat([to_f(bi), box_sel, sc, to_f(ci)], axis=1)

    # -- the graph ----------------------------------------------------------
    def run(self, batch: int, imgsz: int) -> bytes:
        cfg = self.cfg
        resolved, save = self.model.resolved, self.model.save
        self.b.shape["rgb"] = (batch, cfg.ch, imgsz, imgsz)
        self.b.shape["ir"] = (batch, cfg.ch, imgsz, imgsz)
        y: Dict[int, str] = {}
        out: str = "rgb"

        for r in resolved:
            if r.f == -4:
                inp = "ir"
            elif r.f == -1:
                inp = out
            elif isinstance(r.f, int):
                inp = y[r.f]
            else:
                inp = [out if j == -1 else y[j] for j in r.f]
            out = self.emit(r, inp)
            if r.i in save:
                y[r.i] = out

        pred = out
        n, npred, no = self.b.shape[pred]
        inputs = [P.value_info("rgb", P.FLOAT, self.b.shape["rgb"]),
                  P.value_info("ir", P.FLOAT, self.b.shape["ir"])]
        if self.nms:
            dets = self.nms_tail(pred, *self.nms)
            outputs = [P.value_info(dets, P.FLOAT, ("num_dets", 7))]
            doc = ("two-stream ICAFusion detector (rgb, ir) NCHW [0,1] -> "
                   "(num_dets, 7) [batch, x1, y1, x2, y2, conf, cls]; NMS "
                   "baked in (conf %.3g, iou %.3g, max %d/class)" % self.nms)
        else:
            outputs = [P.value_info(pred, P.FLOAT, (n, npred, no))]
            doc = "two-stream ICAFusion detector (rgb, ir) NCHW [0,1] -> (b, N, 5+nc)"
        g = P.graph_proto(self.b.nodes, cfg.name or "icafusion",
                          self.b.inits, inputs, outputs)
        return P.model_proto(g, doc=doc)

    def emit(self, r, inp):
        p = getattr(self.model, f"m{r.i}")
        if r.n > 1:   # a Repeat of r.n copies, r0..
            x = inp
            for j in range(r.n):
                rr = type(r)(i=r.i, f=-1, n=1, module=r.module, args=r.args,
                             c2=r.c2)
                x = self._emit_one(rr, x, getattr(p, f"r{j}"))
            return x
        return self._emit_one(r, inp, p)

    def _emit_one(self, r, inp, p):
        m, a = r.module, list(r.args)
        b = self.b
        if m == "Conv":
            return self.conv_mod(inp, p, a[2] if len(a) > 2 else 1,
                                 a[3] if len(a) > 3 else 1,
                                 a[4] if len(a) > 4 else None,
                                 a[5] if len(a) > 5 else 1,
                                 a[6] if len(a) > 6 else True)
        if m == "DWConv":
            g = math.gcd(a[0], a[1])
            return self.conv_mod(inp, p, a[2] if len(a) > 2 else 1,
                                 a[3] if len(a) > 3 else 1, None, g,
                                 a[4] if len(a) > 4 else True)
        if m == "Bottleneck":
            return self.bottleneck(inp, p, a[0], a[1],
                                   a[2] if len(a) > 2 else True,
                                   a[3] if len(a) > 3 else 1)
        if m == "C3":
            return self.c3(inp, p, a[0], a[1], a[2],
                           _to_bool(a[3]) if len(a) > 3 else True,
                           a[4] if len(a) > 4 else 1,
                           a[5] if len(a) > 5 else 0.5)
        if m == "BottleneckCSP":
            return self.bottleneck_csp(inp, p, a[0], a[1], a[2],
                                       _to_bool(a[3]) if len(a) > 3 else True,
                                       a[4] if len(a) > 4 else 1,
                                       a[5] if len(a) > 5 else 0.5)
        if m == "C3TR":
            return self.c3tr(inp, p, a[0], a[1], a[2],
                             a[5] if len(a) > 5 else 0.5)
        if m == "GhostConv":
            return self.ghost_conv(inp, p, a[1], a[2] if len(a) > 2 else 1,
                                   a[3] if len(a) > 3 else 1,
                                   a[4] if len(a) > 4 else 1,
                                   a[5] if len(a) > 5 else True)
        if m == "GhostBottleneck":
            return self.ghost_bottleneck(inp, p, a[0], a[1],
                                         a[2] if len(a) > 2 else 3,
                                         a[3] if len(a) > 3 else 1)
        if m == "CrossConv":
            return self.cross_conv(inp, p, a[0], a[1],
                                   a[2] if len(a) > 2 else 3,
                                   a[3] if len(a) > 3 else 1,
                                   a[4] if len(a) > 4 else 1,
                                   a[5] if len(a) > 5 else 1.0,
                                   _to_bool(a[6]) if len(a) > 6 else False)
        if m == "MixConv2d":
            return self.mixconv(inp, p, a[0], a[1],
                                tuple(a[2]) if len(a) > 2 else (1, 3),
                                a[3] if len(a) > 3 else 1)
        if m == "Contract":
            return self.contract(inp, a[0])
        if m == "Expand":
            return self.expand(inp, a[0])
        if m == "BatchNorm2d":
            return self.bn_affine(inp, p.bn)
        if m == "MaxPool2d":
            k = a[0]
            st = a[1] if len(a) > 1 else k
            return b.pool(inp, "MaxPool", (k, k), (st, st))
        if m == "SE_Block":
            return self.se_block(inp, p)
        if m == "Channel_Attention":
            return self.channel_attention(inp, p)
        if m == "Spatial_Attention":
            return self.spatial_attention(inp, p, a[0] if a else 7)
        if m == "CBAM":
            x = self.channel_attention(inp, p.ca)
            return self.spatial_attention(x, p.sa,
                                          a[2] if len(a) > 2 else 7)
        if m == "SPPF":
            return self.sppf(inp, p, a[2] if len(a) > 2 else 5)
        if m == "SPP":
            return self.spp(inp, p, tuple(a[2]) if len(a) > 2 else (5, 9, 13))
        if m == "Focus":
            return self.focus(inp, p, a[2] if len(a) > 2 else 1,
                              a[3] if len(a) > 3 else 1,
                              a[4] if len(a) > 4 else None,
                              a[5] if len(a) > 5 else 1,
                              a[6] if len(a) > 6 else True)
        if m == "Concat":
            # YAML dim 1 means channels; any other value is an NHWC axis of
            # the JAX package's layout, remapped to this graph's NCHW one
            d = a[0] if a else 1
            ax = 1 if d == 1 else {0: 0, 1: 2, 2: 3, 3: 1}[d % 4]
            return b.concat(list(inp), axis=ax)
        if m == "Upsample":
            _, _, h, w = b.shape[inp]
            size, scale = a[0], a[1] if len(a) > 1 else None
            mode = a[2] if len(a) > 2 else "nearest"
            nh, nw = (size if size else (int(h * scale), int(w * scale)))
            return b.resize(inp, (nh, nw),
                            "nearest" if mode == "nearest" else "linear")
        if m == "Add":
            half = b.const(np.float32(0.5))
            return b.add(b.mul(inp[0], half), b.mul(inp[1], half))
        if m == "DMAF":
            return self.dmaf(list(inp))
        if m == "Add2":
            return b.add(inp[0], inp[1][a[1]])
        if m == "NiNfusion":
            return self.nin_fusion(list(inp), p)
        if m == "TransformerFusionBlock":
            return self.tfb(list(inp), p, a[0], a[1], a[2])
        if m == "VGGblock":
            return self.vggblock(inp, p, a[0])
        if m == "ResNetlayer":
            return self.resnetlayer(inp, p, a[0], a[1], a[2], bool(a[3]),
                                    a[4])
        if m == "ResNetblock":
            return self.resnetblock(inp, p, a[0], a[1],
                                    a[2] if len(a) > 2 else 1)
        if m == "Detect":
            nc, anchors, ch = r.args
            return self.detect(list(inp), p, nc, anchors)
        raise NotImplementedError(
            f"ONNX export: module {m!r} (layer {r.i}) has no emitter; every "
            "registered assembler module exports except Classify (the "
            "assembler only builds Detect-terminated graphs, so a Classify "
            "layer can never appear in a buildable config)")


def _to_bool(v):
    if isinstance(v, str):
        return v not in ("False", "false", "0")
    return bool(v)


def export_onnx(model, batch: int = 1, imgsz: int = 640,
                nms: Optional[Tuple[float, float, int]] = None) -> bytes:
    """Serialize the port's two-stream detector ``model`` (an
    ICAFusionModel, its float32 eval-mode weights; quantized Convs become
    QDQ) to ONNX bytes (opset 13, NCHW, decode included — boxes in
    pixels). ``nms=(conf_thres, iou_thres, max_det)`` additionally bakes
    NonMaxSuppression into the graph, making the output final (num_dets, 7)
    detections (Exporter.nms_tail) — the reference's ONNX export has no
    such option (models/export.py:85-107)."""
    return Exporter(model, nms=nms).run(batch, imgsz)
