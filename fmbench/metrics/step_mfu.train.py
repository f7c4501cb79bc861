"""The whole step's share of the card's peak: its least time on the chip
(the larger of its operations at 67 TFLOP/s float32 and its bytes at
3.35 TB/s, fmbench/counts.py, averaged over the replayed batches) over the
measured step time (the window's wall time over its steps), in %. For
these cells the bytes bound it. Moves ``train_examples_per_s``."""


def read(ctx):
    c, w = ctx["counts"], ctx["window"]
    if ctx["device"] != "cuda" or not w["steps"]:
        return None
    least = 0.0
    for s in ctx["shapes"]:
        nb = c.step_bytes(s["B"], s["L"], s["n"], s["K"], s["fields"])
        fl = c.step_flops(s["loss"], s["B"], s["L"], s["n"], s["K"], s["F"])
        least += c.least_time_s(nb, fl)[0]
    least /= len(ctx["shapes"])
    return 100.0 * least / (w["wall_s"] / w["steps"])
