"""Host-to-device bytes the window path hands to copies, in MB (10^6 B)
per window of the traced run's unprofiled stretch: the program's
``h2d_pinned_bytes`` tally (the stage buffers uploaded from pinned
memory, at their ``stage_cap`` rows) plus ``h2d_pageable_bytes``: the
windows' seed grids, and the offer's uploads, which depend on the stage
transport. At f32 the offer reads the stage on the card and uploads only
an int32 index of the offered positions where they are not one range; at
bf16 and int8 it uploads three arrays per chunk."""

NAMES = ("h2d_pinned_bytes", "h2d_pageable_bytes")


def read(ctx):
    if not ctx.windows or not any(n in ctx.tallies for n in NAMES):
        return None
    return sum(ctx.tallies.get(n, 0.0) for n in NAMES) / 1e6 / \
        len(ctx.windows)
