"""The device's idle time a step in the gaps that open inside the
program's span ``difacto.epoch_end`` (``train_epoch`` after its loop: the
metrics' fold and the table's counts read to the host), by
fmbench/trace.py's reading of the traced window by span, in ms. Nothing
where the trace holds no device operation by span (the CPU). Moves
``train_examples_per_s``."""


def read(ctx):
    s = ctx["spans"]
    if s is None or not s.by_span:
        return None
    v = s.idle_by_span.get("difacto.epoch_end")
    return None if v is None else v / ctx["traced_steps"] * 1e3
