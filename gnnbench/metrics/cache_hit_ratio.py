"""hits / (hits + misses) of the trainer's counters (``trainer.stats()``,
read once after the traced run's unprofiled stretch): valid frontier
slots served by the cache, stage-served rows counted as misses."""


def read(ctx):
    s = ctx.stats
    if not s or s["hits"] + s["misses"] == 0:
        return None
    return s["hits"] / (s["hits"] + s["misses"])
