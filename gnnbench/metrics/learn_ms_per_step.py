"""Stream time of the program's ``learn`` spans over the profiled span,
in ms per profiled step (its windows times K): the model step of a
window's step (``ResidentBase._window`` around ``_learn``: forward, loss,
backward, optimizer update). Stream time runs from the device reaching a
span's entry to its finishing the span's last operation, and includes any
time the stream waits on the host inside the span
(``gnnbench/spans.py``). Left out without a card, or where the program
has no tracer."""

from gnnbench import spans

span_probe = spans.span_probe


def read(ctx):
    return spans.ms_per_step(ctx, "learn")
