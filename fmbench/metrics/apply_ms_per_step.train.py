"""Device time a step of the operations launched inside the program's span
``difacto.apply``, the table's update (``LocalStore._apply``:
``apply_payload``, B2), by fmbench/trace.py's reading of the traced window
by span, in ms. Nothing where the trace holds no device operation by span
(the CPU) or none in this span. Moves ``train_examples_per_s``."""


def read(ctx):
    s = ctx["spans"]
    v = s.by_span.get("difacto.apply") if s is not None else None
    return None if v is None else v / ctx["traced_steps"] * 1e3
