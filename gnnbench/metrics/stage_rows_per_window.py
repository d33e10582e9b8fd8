"""The trainer's ``stage_rows`` tally (rows the staged miss path gathered
on the host and uploaded) per window of the traced run's unprofiled
stretch."""


def read(ctx):
    if "stage_rows" not in ctx.tallies or not ctx.windows:
        return None
    return ctx.tallies["stage_rows"] / len(ctx.windows)
