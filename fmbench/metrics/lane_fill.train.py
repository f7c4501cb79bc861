"""The share of the unique lanes the kernels launch over that hold a
distinct row of the batch, over the traced epochs: the program's counters
``step.unique_rows`` over ``step.lanes``, in % (below 100 the bucket
ladder pads). Nothing where the program counts no distinct rows (a batch
localized on the device). Moves ``train_examples_per_s``."""


def read(ctx):
    c = (ctx["counters"] or {}).get("train") or {}
    lanes, rows = c.get("step.lanes"), c.get("step.unique_rows")
    return 100.0 * rows / lanes if lanes and rows else None
