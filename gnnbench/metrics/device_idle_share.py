"""1 - busy / wall over the profiled span: busy is the union of the
device operations' intervals in the profiler's trace, wall the span's
host time."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 1.0 - t.busy_s / t.window_s
