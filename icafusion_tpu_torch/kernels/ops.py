"""The four kernels as PyTorch operators that ``torch.export`` can capture.

The wrappers launch their kernels through ``ctypes`` on raw pointers,
which a FakeTensor trace cannot follow. So while ``torch.export`` traces
(``torch.compiler.is_exporting()``), each wrapper calls its operator here
instead, and the exported program holds the node:

- ``icafusion::dual_cross_attention`` (kernels/cross_attention.py);
- ``icafusion::conv3x3_bn_silu`` (kernels/packed_conv.py);
- ``icafusion::conv_int8_bn_act`` (kernels/conv_int8.py);
- ``icafusion::greedy_nms`` (kernels/nms.py).

The CUDA implementation of each is its wrapper's launch (the hand-written
kernel, counted in the wrapper's ``launches``; a kernel that does not
build or launch raises), the CPU implementation its plain version, and a
fake implementation gives the output shapes, dtypes and strides. Eager
calls never come here: an operator call costs host time that the serving
path, bound by the host, would pay at every launch.

A program saved with ``torch.export.save`` loads where this module has
been imported (importing ``icafusion_tpu_torch.nn.layers`` does that).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from icafusion_tpu_torch.kernels import conv_int8, cross_attention, nms
from icafusion_tpu_torch.kernels import packed_conv

Tensor = torch.Tensor


# --- icafusion::dual_cross_attention --------------------------------------

@torch.library.custom_op("icafusion::dual_cross_attention", mutates_args=())
def _dual_cross_attention(vis: Tensor, ir: Tensor, weights: List[Tensor],
                          biases: List[Tensor],
                          num_heads: int) -> Tuple[Tensor, Tensor]:
    raise NotImplementedError(f"icafusion::dual_cross_attention: device "
                              f"{vis.device}")


@_dual_cross_attention.register_kernel("cuda")
def _(vis, ir, weights, biases, num_heads):
    return cross_attention.launch(vis, ir, weights, biases, num_heads)


@_dual_cross_attention.register_kernel("cpu")
def _(vis, ir, weights, biases, num_heads):
    return cross_attention.dual_cross_attention_reference(
        vis, ir, weights, biases, num_heads)


@_dual_cross_attention.register_fake
def _(vis, ir, weights, biases, num_heads):
    return torch.empty_like(vis), torch.empty_like(vis)


def dual_cross_attention(vis, ir, weights: Sequence[Tensor],
                         biases: Sequence[Tensor], num_heads: int):
    return _dual_cross_attention(vis, ir, list(weights), list(biases),
                                 num_heads)


# --- icafusion::conv3x3_bn_silu -------------------------------------------

@torch.library.custom_op("icafusion::conv3x3_bn_silu", mutates_args=())
def conv3x3_bn_silu(x: Tensor, w: Tensor, scale: Tensor,
                    bias: Tensor) -> Tensor:
    raise NotImplementedError(f"icafusion::conv3x3_bn_silu: device "
                              f"{x.device}")


@conv3x3_bn_silu.register_kernel("cuda")
def _(x, w, scale, bias):
    return packed_conv.launch(x, w, scale, bias)


@conv3x3_bn_silu.register_kernel("cpu")
def _(x, w, scale, bias):
    return packed_conv.conv3x3_bn_silu_reference(x, w, scale, bias)


@conv3x3_bn_silu.register_fake
def _(x, w, scale, bias):
    return torch.empty_like(x)       # x's layout, as the kernel writes


# --- icafusion::conv_int8_bn_act ------------------------------------------

@torch.library.custom_op("icafusion::conv_int8_bn_act", mutates_args=())
def _conv_int8_bn_act(x: Tensor, w8: Tensor, s_in: Tensor, s_w: Tensor,
                      gamma: Tensor, beta: Tensor, mean: Tensor, var: Tensor,
                      eps: float, stride: List[int], padding: List[int],
                      act: bool, epilogue: bool, groups: int) -> Tensor:
    raise NotImplementedError(f"icafusion::conv_int8_bn_act: device "
                              f"{x.device}")


def _bn(gamma, beta, mean, var, eps, epilogue):
    return (gamma, beta, mean, var, eps) if epilogue else None


@_conv_int8_bn_act.register_kernel("cuda")
def _(x, w8, s_in, s_w, gamma, beta, mean, var, eps, stride, padding, act,
      epilogue, groups):
    return conv_int8.launch(x, w8, s_in, s_w,
                            _bn(gamma, beta, mean, var, eps, epilogue),
                            tuple(stride), tuple(padding), act, epilogue,
                            groups)


@_conv_int8_bn_act.register_kernel("cpu")
def _(x, w8, s_in, s_w, gamma, beta, mean, var, eps, stride, padding, act,
      epilogue, groups):
    return conv_int8.conv_int8_bn_act_reference(
        x, w8, s_in, s_w, _bn(gamma, beta, mean, var, eps, epilogue),
        tuple(stride), tuple(padding), act, epilogue, groups)


@_conv_int8_bn_act.register_fake
def _(x, w8, s_in, s_w, gamma, beta, mean, var, eps, stride, padding, act,
      epilogue, groups):
    B, _, H, W = x.shape
    Cout, kh, kw, _ = w8.shape
    Ho = (H + 2 * padding[0] - kh) // stride[0] + 1
    Wo = (W + 2 * padding[1] - kw) // stride[1] + 1
    return torch.empty((B, Cout, Ho, Wo), device=x.device,
                       dtype=x.dtype if epilogue else torch.int32,
                       memory_format=torch.channels_last)


def conv_int8_bn_act(x, w8, s_in, s_w, bn, stride, padding, act: bool,
                     epilogue: bool, groups: int):
    pair = lambda v: [int(v)] * 2 if isinstance(v, int) else [*map(int, v)]
    gamma, beta, mean, var, eps = bn if bn is not None else (
        s_w, s_w, s_w, s_w, 0.0)
    return _conv_int8_bn_act(x, w8, s_in, s_w, gamma, beta, mean, var,
                             float(eps), pair(stride), pair(padding),
                             bool(act), bool(epilogue), int(groups))


# --- icafusion::greedy_nms ------------------------------------------------

@torch.library.custom_op("icafusion::greedy_nms", mutates_args=())
def _greedy_nms(boxes: Tensor, scores: Tensor, iou_thres: float,
                max_det: int) -> Tuple[Tensor, Tensor]:
    raise NotImplementedError(f"icafusion::greedy_nms: device "
                              f"{boxes.device}")


@_greedy_nms.register_kernel("cuda")
def _(boxes, scores, iou_thres, max_det):
    return nms.launch(boxes, scores, iou_thres, max_det)


@_greedy_nms.register_kernel("cpu")
def _(boxes, scores, iou_thres, max_det):
    return nms.greedy_nms_reference(boxes, scores, iou_thres, max_det)


@_greedy_nms.register_fake
def _(boxes, scores, iou_thres, max_det):
    B = boxes.shape[0]
    return (boxes.new_empty((B, max_det), dtype=torch.int32),
            boxes.new_empty((B, max_det), dtype=torch.bool))


def greedy_nms(boxes, scores, iou_thres: float, max_det: int):
    return _greedy_nms(boxes, scores, float(iou_thres), int(max_det))
