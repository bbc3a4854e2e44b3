"""conv3x3_roofline (%): the least time of the fused 64-channel 3x3 conv +
BatchNorm + SiLU (every eval-mode Conv(64, 64, 3, 1) the model runs in
float) over its device time in the traced window's second half, where
the module ranges are on."""

from portbench.core.yardstick import conv3x3_work, least_s


def ranges(add, model):
    from icafusion_tpu_torch.nn.layers import Conv
    for m in model.modules():
        if isinstance(m, Conv) and m.fused and m.w8 is None:
            add(m, "conv3x3", record=True)


def read(ctx):
    tr = ctx.fine_result
    t = tr.device_s(within="conv3x3")
    calls = ctx.ranges.calls.get("conv3x3", [])
    if not t or not calls:
        return None
    least = sum(least_s(*conv3x3_work(B, C, H, W, "bf16"), "bf16")[0]
                for _, (B, C, H, W), _ in calls)
    return 100.0 * least / t
