"""nms_device_ms.offline (ms): device time a predict_arrays call of the
operations launched inside the engine's ``serve.nms`` span (the
candidates' gate, the stable top-k sort, the greedy NMS kernel, the
gathers), part of what ``device_ms.offline`` sums. From the traced
window's first half; None where the program opens no such span."""

from portbench.core import spans


def read(ctx):
    tr = ctx.trace_result
    return spans.per(tr, spans.device_s(tr, ["serve.nms"]), "portbench.call")
