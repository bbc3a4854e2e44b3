"""mfu.train (%): the whole train step's share of the card's peak. The
operations of one image's forward and backward are counted by
FlopCounterMode on the plain reference model in train mode at the canvas
(no data: meta tensors, the loss left out); each is taken at the peak of
the precision it runs in under bf16 autocast: the attention's two
products (float32, autocast off in the measured package) at fp32, the
rest at bf16. Images stepped in the traced window times that least time,
over the window."""

from portbench.core.yardstick import PEAK_OPS


def image_flops(config):
    """(all operations, the attention's fp32 products) of one image's
    forward and backward."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from portbench.reference import model as refm
    with torch.device("meta"):
        m = refm.Model(config["model"]).train()
        H, W = config["canvas"]
        x = torch.empty(1, 3, H, W)
        fc = FlopCounterMode(display=False)
        with fc:
            _, logits = m(x, x)
            sum(t.sum() for t in logits).backward()
    counts = fc.get_flop_counts()
    total = sum(counts["Global"].values())
    fp32 = 0
    for name, ops in counts.items():
        if name.endswith(".crossatt"):
            fp32 += sum(v for op, v in ops.items() if "bmm" in str(op))
    return total, fp32


def least_s_per_image(config):
    total, fp32 = image_flops(config)
    if config["precision"] != "bf16":
        return total / PEAK_OPS["fp32"]
    return (total - fp32) / PEAK_OPS["bf16"] + fp32 / PEAK_OPS["fp32"]


def read(ctx):
    tr = ctx.trace_result
    steps = tr.count("portbench.call")
    if not steps or not tr.window_s or not tr.ops:
        return None
    images = steps * int(ctx.spec["batch"]) * int(ctx.spec["accum_steps"])
    return 100.0 * images * least_s_per_image(ctx.config) / tr.window_s
