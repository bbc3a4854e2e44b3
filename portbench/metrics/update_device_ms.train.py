"""update_device_ms.train (ms): device time a Trainer step of the
operations launched inside its ``train.optimizer`` (the gradients, the
masks, the three-group SGD update) and ``train.ema`` spans. None where the
program opens no such span."""

from portbench.core import spans


def read(ctx):
    tr = ctx.trace_result
    return spans.per(tr, spans.device_s(tr, ["train.optimizer", "train.ema"]),
                     "train.step")
