"""Numpy reference evaluator for the ONNX subset this framework emits.

The port's own copy of the JAX package's export/onnx_numpy.py. Executes a
parsed OnnxModel (onnx_proto.load) node by node with plain numpy — the
validation half of the dependency-free ONNX path: ``cli.export --validate``
and the port's tests run the emitted graph here and compare it against the
port's forward, covering the serializer, the lowering, and the op semantics
in one pass. Op semantics follow the ONNX operator spec at opset 13 (padded
values: -inf for MaxPool, excluded from AveragePool means per the default
count_include_pad=0; Resize asymmetric/floor == torch nearest, half_pixel
round_prefer_ceil == jax.image.resize nearest, half_pixel linear == torch
bilinear align_corners=False).

Not a general ONNX runtime: implements exactly the ops the exporter uses.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from icafusion_tpu_torch.export.onnx_proto import _ONNX_TO_NP, OnnxModel


def _windows(x: np.ndarray, kh: int, kw: int, sh: int, sw: int) -> np.ndarray:
    """(N, C, H, W) -> (N, C, OH, OW, kh, kw) strided view."""
    n, c, h, w = x.shape
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1
    sn, sc, sy, sx = x.strides
    return np.lib.stride_tricks.as_strided(
        x, (n, c, oh, ow, kh, kw), (sn, sc, sy * sh, sx * sw, sy, sx),
        writeable=False)


def _conv(x, w, b, strides, pads, group):
    py0, px0, py1, px1 = pads
    xp = np.pad(x, ((0, 0), (0, 0), (py0, py1), (px0, px1)))
    co, ci_g, kh, kw = w.shape
    win = _windows(xp, kh, kw, strides[0], strides[1])   # (N,C,OH,OW,kh,kw)
    n, c, oh, ow = win.shape[:4]
    if group == 1:
        y = np.einsum("nchwij,ocij->nohw", win, w, optimize=True)
    else:
        cg_out = co // group
        ys = []
        for g in range(group):
            wg = w[g * cg_out:(g + 1) * cg_out]
            xg = win[:, g * ci_g:(g + 1) * ci_g]
            ys.append(np.einsum("nchwij,ocij->nohw", xg, wg, optimize=True))
        y = np.concatenate(ys, axis=1)
    if b is not None:
        y = y + b[None, :, None, None]
    return y.astype(np.float32)


def _pool(x, op, k, strides, pads, count_include_pad=0):
    fill = -np.inf if op == "MaxPool" else 0.0
    py0, px0, py1, px1 = pads
    xp = np.pad(x, ((0, 0), (0, 0), (py0, py1), (px0, px1)),
                constant_values=fill)
    win = _windows(xp, k[0], k[1], strides[0], strides[1])
    if op == "MaxPool":
        return win.max(axis=(4, 5)).astype(np.float32)
    if count_include_pad or not any(pads):
        return win.mean(axis=(4, 5)).astype(np.float32)
    # spec default count_include_pad=0: divide by the number of non-pad cells
    ones = np.pad(np.ones(x.shape[2:], np.float32),
                  ((py0, py1), (px0, px1)))[None, None]
    cnt = _windows(ones, k[0], k[1], strides[0], strides[1]).sum(axis=(4, 5))
    return (win.sum(axis=(4, 5)) / cnt).astype(np.float32)


def _resize(x, sizes, mode, coord, nearest_mode):
    n, c, h, w = x.shape
    nh, nw = int(sizes[2]), int(sizes[3])
    if mode == "nearest":
        if coord == "asymmetric" and nearest_mode == "floor":
            iy = np.floor(np.arange(nh) * (h / nh)).astype(np.int64)
            ix = np.floor(np.arange(nw) * (w / nw)).astype(np.int64)
        else:   # half_pixel + round_prefer_ceil == floor((i+0.5)*in/out)
            assert coord == "half_pixel" and \
                nearest_mode == "round_prefer_ceil", (coord, nearest_mode)
            iy = np.clip(np.floor((np.arange(nh) + 0.5) * (h / nh)),
                         0, h - 1).astype(np.int64)
            ix = np.clip(np.floor((np.arange(nw) + 0.5) * (w / nw)),
                         0, w - 1).astype(np.int64)
        return x[:, :, iy][:, :, :, ix]
    assert mode == "linear" and coord == "half_pixel", (mode, coord)

    def axis_w(out_n, in_n):
        src = (np.arange(out_n) + 0.5) * (in_n / out_n) - 0.5
        i0 = np.clip(np.floor(src), 0, in_n - 1).astype(np.int64)
        i1 = np.clip(i0 + 1, 0, in_n - 1)
        t = np.clip(src - np.floor(src), 0.0, 1.0)
        t = np.where(src < 0, 0.0, np.where(src > in_n - 1, 1.0, t))
        return i0, i1, t.astype(np.float32)

    y0, y1, ty = axis_w(nh, h)
    x0, x1, tx = axis_w(nw, w)
    top = x[:, :, y0][:, :, :, x0] * (1 - tx) + x[:, :, y0][:, :, :, x1] * tx
    bot = x[:, :, y1][:, :, :, x0] * (1 - tx) + x[:, :, y1][:, :, :, x1] * tx
    return (top * (1 - ty[None, None, :, None])
            + bot * ty[None, None, :, None]).astype(np.float32)


def _nms(boxes, scores, max_per_class, iou_t, score_t, center_point_box):
    """ONNX NonMaxSuppression: boxes (B,N,4), scores (B,C,N) ->
    selected_indices (S,3) int64 rows [batch, class, box], selected in
    batch-major / class-major / score-descending order (onnxruntime order)."""
    B, C, N = scores.shape
    if center_point_box:
        xy, wh = boxes[..., :2], boxes[..., 2:4]
        corners = np.concatenate([xy - wh / 2, xy + wh / 2], axis=-1)
    else:                       # spec layout [y1,x1,y2,x2] -> [x1,y1,x2,y2]
        corners = boxes[..., [1, 0, 3, 2]]
    sel = []
    for bi in range(B):
        bx = corners[bi]
        area = np.clip(bx[:, 2] - bx[:, 0], 0, None) * \
            np.clip(bx[:, 3] - bx[:, 1], 0, None)
        for ci in range(C):
            sc = scores[bi, ci]
            cand = np.nonzero(sc > score_t)[0] if score_t is not None \
                else np.arange(N)
            cand = cand[np.argsort(-sc[cand], kind="stable")]
            keep: list = []
            for j in cand:
                if len(keep) >= max_per_class:
                    break
                kb = bx[keep]
                lt = np.maximum(kb[:, :2], bx[j, :2])
                rb = np.minimum(kb[:, 2:], bx[j, 2:])
                inter = np.clip(rb - lt, 0, None).prod(-1)
                iou = inter / (area[keep] + area[j] - inter + 1e-16)
                if not len(keep) or (iou <= iou_t).all():
                    keep.append(int(j))
            sel += [[bi, ci, j] for j in keep]
    return np.asarray(sel, np.int64).reshape(-1, 3)


def _slice(x, starts, ends, axes, steps):
    sl = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        sl[int(ax)] = slice(int(st), int(en), int(sp))
    return x[tuple(sl)]


def run(model: OnnxModel, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Execute the graph; returns {output_name: array}."""
    env: Dict[str, np.ndarray] = dict(model.initializers)
    for name, arr in feeds.items():
        env[name] = np.asarray(arr, np.float32)

    erf = np.vectorize(math.erf, otypes=[np.float32])
    for node in model.nodes:
        i = [env[n] if n else None for n in node.inputs]
        a = node.attrs
        op = node.op_type
        if op == "Conv":
            y = _conv(i[0], i[1], i[2] if len(i) > 2 else None,
                      a["strides"], a["pads"], a.get("group", 1))
        elif op in ("MaxPool", "AveragePool"):
            y = _pool(i[0], op, a["kernel_shape"], a["strides"],
                      a.get("pads", [0, 0, 0, 0]),
                      a.get("count_include_pad", 0))
        elif op == "Resize":
            y = _resize(i[0], i[3], a["mode"],
                        a["coordinate_transformation_mode"],
                        a.get("nearest_mode", "round_prefer_floor"))
        elif op == "Add":
            y = i[0] + i[1]
        elif op == "Sub":
            y = i[0] - i[1]
        elif op == "Mul":
            y = i[0] * i[1]
        elif op == "Div":
            y = i[0] / i[1]
        elif op == "Sqrt":
            y = np.sqrt(i[0])
        elif op == "Erf":
            y = erf(i[0])
        elif op == "Tanh":
            y = np.tanh(i[0])
        elif op == "Sigmoid":
            with np.errstate(over="ignore"):
                y = 1.0 / (1.0 + np.exp(-i[0].astype(np.float64)))
            y = y.astype(np.float32)
        elif op == "Relu":
            y = np.maximum(i[0], 0)
        elif op == "LeakyRelu":
            y = np.where(i[0] >= 0, i[0], i[0] * a["alpha"])
        elif op == "Concat":
            y = np.concatenate(i, axis=a["axis"])
        elif op == "Reshape":
            y = i[0].reshape([int(d) for d in i[1]])
        elif op == "Transpose":
            y = np.transpose(i[0], a["perm"])
        elif op == "Slice":
            y = _slice(i[0], i[1], i[2], i[3], i[4])
        elif op == "MatMul":
            y = np.matmul(i[0], i[1]).astype(np.float32)
        elif op == "Softmax":
            z = i[0] - i[0].max(axis=a["axis"], keepdims=True)
            e = np.exp(z)
            y = (e / e.sum(axis=a["axis"], keepdims=True)).astype(np.float32)
        elif op == "ReduceMean":
            y = i[0].mean(axis=tuple(a["axes"]),
                          keepdims=bool(a.get("keepdims", 1))).astype(np.float32)
        elif op == "ReduceMax":
            y = i[0].max(axis=tuple(a["axes"]),
                         keepdims=bool(a.get("keepdims", 1))).astype(np.float32)
        elif op == "QuantizeLinear":
            s = i[1]
            if s.ndim:  # per-axis
                ax = a.get("axis", 1)
                s = s.reshape([-1 if d == ax % i[0].ndim else 1
                               for d in range(i[0].ndim)])
            # round-half-to-even per spec, saturate to int8 (zero_point 0)
            y = np.clip(np.rint(i[0] / s), -128, 127).astype(np.int8)
        elif op == "DequantizeLinear":
            s = i[1]
            if s.ndim:
                ax = a.get("axis", 1)
                s = s.reshape([-1 if d == ax % i[0].ndim else 1
                               for d in range(i[0].ndim)])
            y = (i[0].astype(np.float32) * s).astype(np.float32)
        elif op == "NonMaxSuppression":
            # spec default max_output_boxes_per_class=0 selects NOTHING
            y = _nms(i[0], i[1],
                     int(i[2][0]) if len(i) > 2 and i[2] is not None else 0,
                     float(i[3][0]) if len(i) > 3 and i[3] is not None else 0.0,
                     float(i[4][0]) if len(i) > 4 and i[4] is not None else None,
                     a.get("center_point_box", 0))
        elif op == "GatherND":
            idx = i[1].astype(np.int64)
            y = i[0][tuple(idx.T)]
        elif op == "Cast":
            y = i[0].astype(_ONNX_TO_NP[a["to"]])
        elif op == "Unsqueeze":
            y = np.expand_dims(i[0], tuple(int(ax) for ax in i[1]))
        else:
            raise NotImplementedError(f"numpy evaluator: op {op}")
        env[node.outputs[0]] = np.asarray(y, dtype=y.dtype)

    return {name: env[name] for name, _, _ in model.outputs}
