"""attention_roofline (%): the least time of the model's dual
cross-attention modules (LayerNorms, q/k/v projections, both attention
directions, output projections; portbench/core/yardstick.py) over their
device time, summed over every call of each module in the traced
window's second half, where the module ranges are on."""

from portbench.core.yardstick import attention_work, least_s


def ranges(add, model):
    from icafusion_tpu_torch.nn.fusion import CrossAttention
    for m in model.modules():
        if isinstance(m, CrossAttention):
            add(m, "attention", record=True)


def read(ctx):
    tr = ctx.fine_result
    t = tr.device_s(within="attention")
    calls = ctx.ranges.calls.get("attention", [])
    if not t or not calls:
        return None
    least = 0.0
    for m, (B, N, D), _ in calls:
        least += least_s(*attention_work(B, N, D, "bf16"), "bf16")[0]
    return 100.0 * least / t
