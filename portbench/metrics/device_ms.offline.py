"""device_ms.offline (ms): device time of the kernels a predict_arrays call
launches (the scaling of the uploaded pairs, the model's forward, the
decode and the NMS; not its copies), per call."""


def read(ctx):
    tr = ctx.trace_result
    calls = tr.count("portbench.call")
    s = tr.device_s(within="portbench.call", kinds=("kernel", "gpu_memset"))
    return 1e3 * s / calls if calls and s > 0 else None
