"""bn_act_ms.offline (ms): device time inside the model's BatchNorm and
activation (SiLU) modules, per predict_arrays call, in the traced
window's second half, where the module ranges are on: the unfused
normalisation and activation around the library convolutions."""

import torch


def ranges(add, model):
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            add(m, "bn")
        elif isinstance(m, torch.nn.SiLU):
            add(m, "act")


def read(ctx):
    tr = ctx.fine_result
    calls = tr.count("portbench.call")
    s = tr.device_s(within="bn") + tr.device_s(within="act")
    return 1e3 * s / calls if calls and s > 0 else None
