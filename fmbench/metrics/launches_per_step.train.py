"""Device operations (kernels, copies, memsets) in the traced window over
its steps: the launches behind each step. Moves
``train_examples_per_s``."""


def read(ctx):
    t = ctx["trace"]
    return len(t.ops) / ctx["traced_steps"] if t.ops else None
