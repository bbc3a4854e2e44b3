"""Eval-mode BatchNorm affine + activation, in place, after a library conv.

Replaces no Pallas kernel: on the TPU, XLA fuses a Conv's eval BatchNorm
and SiLU into the convolution. In the port, every eval ``Conv`` off the
int8 and fused 64-channel paths runs its conv on cuDNN; once the serving
engine has folded each BatchNorm into a float32 ``(scale, bias)``
(ops/fuse.py: fold_bn_act), one pass of ``csrc/bn_act_epilogue.cu`` over
the conv's output takes the place of PyTorch's BatchNorm and SiLU
kernels, which read and wrote it once each. It is bound by bytes: one
read and one write of the output.

``bn_act_`` launches the kernel on CUDA tensors and runs
``bn_act_reference_``, the plain PyTorch version, on CPU tensors only.
Both write y in place and return it. ``check_affine`` holds the folded
(scale, bias) and the maps' dtype and channels to what the kernel takes,
once, when they are made; a call then reads only what can change: y's
device, whether it requires grad, its dtype (which picks the kernel) and
its layout.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from icafusion_tpu_torch.kernels import _build


@functools.cache
def _launch():
    """The C entry, bound once."""
    return _build.library().icaf_bn_act


KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def bn_act_reference_(y, scale, bias, silu: bool = True):
    """y = act(y * scale[c] + bias[c]) in float32 (in y's dtype where it is
    wider), rounded once to y's dtype, written into y."""
    v = y.to(torch.promote_types(y.dtype, torch.float32))
    v = v * scale[:, None, None] + bias[:, None, None]
    return y.copy_(F.silu(v) if silu else v)


def check_affine(scale, bias, channels: int, dtype) -> None:
    """Raise unless maps of ``dtype`` are ones the kernel takes and (scale,
    bias) are (channels,) float32, contiguous and on one device: what the
    kernel reads for every y of ``channels``."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"bn_act_: dtype {dtype} not supported")
    for t in (scale, bias):
        if (t.shape != (channels,) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != scale.device):
            raise ValueError(f"bn_act_: scale and bias must be ({channels},) "
                             "float32, contiguous and on one device; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def bn_act_(y, scale, bias, silu: bool = True):
    """y: (B, C, H, W) float32 or bfloat16, contiguous in channels_last or
    in NCHW, not requiring grad; scale, bias: (C,) float32 on its device,
    held by ``check_affine`` to y's dtype and C when they were made (the
    call does not compare them again). Writes act(y * scale + bias) into
    y, act SiLU or the identity, and returns y. Costs the host no more
    than ``F.silu`` does: the C entry takes eight arguments, the current
    stream's raw handle among them, and y's device is entered only where
    another one is current."""
    if not y.is_cuda:
        if y.device.type == "cpu":
            return bn_act_reference_(y, scale, bias, silu)
        raise ValueError(f"bn_act_: unsupported device {y.device}")
    if y.requires_grad:
        raise ValueError("bn_act_: y requires grad; the kernel writes in "
                         "place and has no backward")
    # the C entry's flags: bit 0 bf16, bit 1 channels_last, bit 2 SiLU
    if y.dtype is torch.bfloat16:
        flags = 5 if silu else 1
    elif y.dtype is torch.float32:
        flags = 4 if silu else 0
    else:
        raise TypeError(f"bn_act_: dtype {y.dtype} not supported")
    if y.is_contiguous(memory_format=torch.channels_last):
        flags |= 2
    elif not y.is_contiguous():
        raise ValueError("bn_act_: y must be contiguous in NCHW or in "
                         "channels_last")
    _, C, H, W = y.shape
    dev = y.get_device()
    if dev != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return bn_act_(y, scale, bias, silu)
    err = _launch()(y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                    y.numel(), C, H * W, flags,
                    torch._C._cuda_getCurrentRawStream(dev))
    if err:
        _build.check(err, "bn_act_")
    bn_act_.launches += 1
    return y


bn_act_.launches = 0
