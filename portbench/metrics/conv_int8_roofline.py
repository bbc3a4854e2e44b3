"""conv_int8_roofline (%): the least time of the W8A8 convs (input
quantization, exact int8 products, dequantization, BatchNorm, SiLU; every
Conv the engine quantized) over their device time in the traced window's
second half, where the module ranges are on."""

from portbench.core.yardstick import conv_int8_work, least_s


def ranges(add, model):
    from icafusion_tpu_torch.nn.layers import Conv
    for m in model.modules():
        if isinstance(m, Conv) and m.w8 is not None:
            add(m, "conv_int8", record=True)


def read(ctx):
    tr = ctx.fine_result
    t = tr.device_s(within="conv_int8")
    calls = ctx.ranges.calls.get("conv_int8", [])
    if not t or not calls:
        return None
    least = 0.0
    for m, (B, Cin, H, W), (_, Cout, Ho, Wo) in calls:
        ops, nbytes = conv_int8_work(B, Cin, H, W, Cout,
                                     m.conv.kernel_size[0], Ho, Wo,
                                     m.conv.groups, "bf16")
        least += least_s(ops, nbytes, "int8")[0]
    return 100.0 * least / t
