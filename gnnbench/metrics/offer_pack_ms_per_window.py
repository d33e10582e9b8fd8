"""The program's ``insert.pack`` phase (``PhaseTimers``: the offer's
selection of the offered stage rows and, for each chunk of
``ShardedFeatureCache.insert_rows``, the selection and the zero-filled
buffers it builds on the host), in ms per window of the traced run's
unprofiled stretch."""


def read(ctx):
    if "insert.pack" not in ctx.timers or not ctx.windows:
        return None
    return 1e3 * ctx.timers["insert.pack"] / len(ctx.windows)
