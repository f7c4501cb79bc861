"""Device time of the traced window's operations over its steps. Moves
``train_examples_per_s``."""


def read(ctx):
    t = ctx["trace"]
    if not t.ops:
        return None
    return sum(d for _, _, d in t.ops) / ctx["traced_steps"] * 1e3
