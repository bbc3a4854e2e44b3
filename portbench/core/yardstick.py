"""The yardstick: the card's published peaks and the least time a piece of
work can take on it.

One NVIDIA H100 SXM (data sheet, dense, without sparsity, at the full
700 W): bf16 989 TFLOP/s, int8 1979 TOP/s, fp32 outside the tensor cores
67 TFLOP/s, TF32 495 TFLOP/s (a 3xTF32 product, fp32 accuracy from three
TF32 products, a third of it), HBM3 3.35 TB/s. A roofline share is the
least time over the measured time: the least time is the larger of the
operations at the peak of the precision they run in and the bytes at the
HBM rate, each input read once and each output written once.
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12,
            "3xtf32": 495e12 / 3}
BYTES = {"bf16": 2, "fp32": 4, "int8": 1}


def least_s(ops: float, nbytes: float, precision: str) -> Tuple[float, str]:
    """(least seconds, what bounds it: "operations" or "bytes")."""
    t_ops = ops / PEAK_OPS[precision]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_work(B: int, N: int, D: int, precision: str) -> Tuple[int, int]:
    """(operations, bytes) of one dual cross-attention module: the six q/k/v
    projections and both attention directions (12 B N D^2 + 8 B N^2 D, as
    the kernel's own bound counts them) and the two output projections
    (4 B N D^2). Bytes: the two token maps in and out, the eight D x D
    weights and eight biases in the activation precision, the two
    LayerNorms' fp32 scales and shifts."""
    s = BYTES[precision]
    ops = 16 * B * N * D * D + 8 * B * N * N * D
    nbytes = 4 * B * N * D * s + 8 * D * D * s + 8 * D * s + 4 * D * 4
    return ops, nbytes


def conv3x3_work(B: int, C: int, H: int, W: int,
                 precision: str) -> Tuple[int, int]:
    """(operations, bytes) of the fused 3x3 C -> C conv + BN + SiLU, stride
    1: x in, y out, the weights, the folded fp32 scale and bias."""
    s = BYTES[precision]
    return (2 * B * H * W * C * C * 9,
            2 * B * C * H * W * s + C * C * 9 * s + 2 * C * 4)


def conv_int8_work(B: int, Cin: int, H: int, W: int, Cout: int, k: int,
                   Ho: int, Wo: int, groups: int,
                   act_precision: str) -> Tuple[int, int]:
    """(operations, bytes) of one W8A8 conv with its input quantization,
    dequantization, BatchNorm and activation: x in and y out in the
    activation precision, int8 weights, fp32 per-channel vectors (s_in;
    s_w, the BatchNorm's four and eps' fold, six a channel out, as the
    port's chip smoke run counts them)."""
    s = BYTES[act_precision]
    macs = B * Ho * Wo * Cout * k * k * (Cin // groups)
    nbytes = (B * Cin * H * W * s + Cout * k * k * (Cin // groups)
              + B * Cout * Ho * Wo * s + 6 * Cout * 4 + Cin * 4)
    return 2 * macs, nbytes
