"""The trainer's ``host_gather`` phase (``PhaseTimers``: the staged miss
path's gather of the stage rows from the host tier), in ms per window of
the traced run's unprofiled stretch."""


def read(ctx):
    if "host_gather" not in ctx.timers or not ctx.windows:
        return None
    return 1e3 * ctx.timers["host_gather"] / len(ctx.windows)
