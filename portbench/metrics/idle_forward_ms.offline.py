"""idle_forward_ms.offline (ms): the device's idle time a predict_arrays
call in gaps that start while the engine's ``serve.forward`` span is open
(the scaling, the cast and the model's forward, whose operations the host
enqueues one by one): the host's dispatch of the model, from the traced
window's first half. None where the program opens no such span."""

from portbench.core import spans


def read(ctx):
    tr = ctx.trace_result
    return spans.per(tr, spans.idle_s(tr, ["serve.forward"]),
                     "portbench.call")
