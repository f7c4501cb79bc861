"""Mean host time of a call of the store's step entry
(``train_step_prepped``) in the window, with no sync: the host's enqueue of
a step. Only the first calls of each epoch count (fmbench/run.py's
``ENQUEUE_STEPS``): they follow the learner's epoch-end sync, so none waits
on a full queue of launches, which would make it read the card's pace.
Moves ``train_examples_per_s`` where the host, not the card, sets the
pace."""


def read(ctx):
    ms = ctx.get("host_ms")
    return sum(ms) / len(ms) if ms else None
