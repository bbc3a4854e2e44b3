"""step_device_ms.train (ms): device time of a Trainer step (both
microbatches' forward and backward, the loss, SGD, EMA): every kernel,
copy and memset of the traced window, which runs steps alone, over the
steps begun in it. The window's own total, not the operations launched
inside the step's range: autograd launches the backward from a thread of
its own, outside that range."""


def read(ctx):
    tr = ctx.trace_result
    steps = tr.count("portbench.call")
    s = tr.device_s()
    return 1e3 * s / steps if steps and s > 0 else None
