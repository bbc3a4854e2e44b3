"""forward_device_ms.train (ms): device time a Trainer step of the
operations launched inside its ``train.forward`` (the autocast forward)
and ``train.loss`` (YoloLoss) spans, over both microbatches. None where
the program opens no such span."""

from portbench.core import spans


def read(ctx):
    tr = ctx.trace_result
    return spans.per(tr, spans.device_s(tr, ["train.forward", "train.loss"]),
                     "train.step")
