"""backward_device_ms.train (ms): device time a Trainer step of the
backward, over both microbatches. Autograd enqueues it from a thread of
its own while the step's thread waits inside ``train.backward``; that
thread opens no range, so its operations carry none. The reader takes the
operations launched with no range open, provided a launching thread that
opened no range exists (autograd's), plus those launched inside
``train.backward`` on the step's thread. The window runs steps alone, and
the step's thread launches only inside the harness's window range, so no
other operation is left without a range but one whose launch the profiler
did not record (the run reports their count; on an H100 there were none,
and the thread that opened no range launched exactly the operations that
carry none). None where the program opens no ``train.backward`` or no
such thread launched."""

from portbench.core import spans


def read(ctx):
    tr = ctx.trace_result
    if not any(not tr.annotations.get(t) for t in tr.launch_threads):
        return None
    return spans.per(tr, spans.device_s(tr, ["train.backward"], quiet=True),
                     "train.step")
