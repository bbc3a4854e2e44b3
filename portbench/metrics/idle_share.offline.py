"""Idle share (%): the share of the traced window in which no kernel,
copy or memset ran on the device, 100 * (1 - busy / window), from the
profiler's device timeline of that one window."""


def read(ctx):
    tr = ctx.trace_result
    if not tr.ops or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
