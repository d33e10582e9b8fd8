"""Process start to the first measured window: the data made from the
seed, the program built, the cache filled, the first window and the
warm-up windows (host clock)."""


def read(ctx):
    return ctx.setup_s
