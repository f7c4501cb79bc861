"""The host clock in the batch iterator's ``next()`` over epoch 0, in
set-up, where the learner streams the traffic's parts through its host
prep into its device cache: the program's counter ``step.batch_wait_s``.
Moves ``setup_s``."""


def read(ctx):
    c = (ctx["counters"] or {}).get("setup") or {}
    return c.get("step.batch_wait_s") or None
