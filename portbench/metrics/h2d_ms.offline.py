"""h2d_ms.offline (ms): device time of the host-to-device copies a call
makes (the engine's upload of its uint8 pairs), per predict_arrays call,
from the profiler's copy events inside the window."""


def read(ctx):
    tr = ctx.trace_result
    calls = tr.count("portbench.call")
    s = tr.device_s(kinds=("gpu_memcpy",), name_has="HtoD")
    return 1e3 * s / calls if calls and s > 0 else None
