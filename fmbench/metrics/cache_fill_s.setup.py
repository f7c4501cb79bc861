"""Host clock around epoch 0, in set-up: the learner streams the traffic's
parts through its host prep (parse, hash, dedup, slot sort) and copies
each batch into its device cache. Moves ``setup_s``."""


def read(ctx):
    return ctx["phases"].get("cache_fill")
