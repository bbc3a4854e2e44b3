"""idle_io_ms.offline (ms): the device's idle time a predict_arrays call
in gaps that start while the engine's ``serve.upload`` (the padding and
the pageable copy of the uint8 pairs) or ``serve.fetch`` (the four
blocking copies of the detections to the host, the unpad) span is open,
from the traced window's first half. None where the program opens
neither."""

from portbench.core import spans


def read(ctx):
    tr = ctx.trace_result
    return spans.per(tr, spans.idle_s(tr, ["serve.upload", "serve.fetch"]),
                     "portbench.call")
