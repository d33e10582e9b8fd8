"""The 95th percentile (numpy's linear interpolation) of the host wall
time of every measured window of K steps; each ``train_window`` call ends
in its counter readback, so a window's time holds its device work."""

import numpy as np


def read(ctx):
    if not ctx.windows:
        return None
    return 1e3 * float(np.percentile([w.seconds for w in ctx.windows], 95))
