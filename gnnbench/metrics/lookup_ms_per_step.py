"""Stream time of the program's ``lookup`` spans over the profiled span,
in ms per profiled step (its windows times K): the cache lookup of a
step's frontier with the stage rows overlaid where it misses
(``ResidentBase._frontier``). Stream time runs from the device reaching a
span's entry to its finishing the span's last operation, and includes any
time the stream waits on the host inside the span
(``gnnbench/spans.py``). Left out without a card, or where the program
has no tracer."""

from gnnbench import spans

span_probe = spans.span_probe


def read(ctx):
    return spans.ms_per_step(ctx, "lookup")
