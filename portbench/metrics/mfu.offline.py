"""mfu.offline (%): the whole served step's share of the card's peak. The
operations of one pair's forward are counted by FlopCounterMode on the
plain reference model at the canvas (no data: meta tensors); each is taken
at the peak of the precision it runs in (the configuration's W8A8 convs at
int8, the rest at bf16). Pairs served in the traced window times that least
time, over the window."""

from portbench.core.yardstick import PEAK_OPS


def pair_flops(config):
    """(all operations, those of the W8A8 convs) of one pair's forward."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from portbench.reference import model as refm
    with torch.device("meta"):
        m = refm.Model(config["model"])
        H, W = config["canvas"]
        x = torch.empty(1, 3, H, W)
        fc = FlopCounterMode(display=False)
        with fc, torch.no_grad():
            m(x, x)
    counts = fc.get_flop_counts()
    total = sum(counts["Global"].values())
    int8 = 0
    if config["precision"] == "int8":
        skip = refm.detect_feeders(m)
        for name, _ in refm.conv_modules(m):
            if not any(name == s or name.startswith(s + ".") for s in skip):
                int8 += sum(counts.get(f"Model.{name}.conv", {}).values())
    return total, int8


def least_s_per_pair(config):
    total, int8 = pair_flops(config)
    return (total - int8) / PEAK_OPS["bf16"] + int8 / PEAK_OPS["int8"]


def read(ctx):
    tr = ctx.trace_result
    calls = tr.count("portbench.call")
    if not calls or not tr.window_s or not tr.ops:
        return None
    pairs = calls * int(ctx.spec["batch"])
    return 100.0 * pairs * least_s_per_pair(ctx.config) / tr.window_s
