"""Valid sampled edges the measured windows trained (the sum of the block
masks that ``train_window`` returns), over the windows' whole wall time
on the host clock, ending in ``torch.cuda.synchronize()``, per chip."""


def read(ctx):
    if not ctx.windows or ctx.wall <= 0:
        return None
    return sum(w.edges for w in ctx.windows) / ctx.wall / ctx.cell.chips
