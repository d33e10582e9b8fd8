"""The trainer's ``insert_dispatch`` phase (``PhaseTimers``: the offer of
a window's stage to the cache through ``insert_rows``), in ms per window
of the traced run's unprofiled stretch."""


def read(ctx):
    if "insert_dispatch" not in ctx.timers or not ctx.windows:
        return None
    return 1e3 * ctx.timers["insert_dispatch"] / len(ctx.windows)
