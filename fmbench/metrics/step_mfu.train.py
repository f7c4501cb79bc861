"""The whole step's share of the card's peak: its least time on the chip
(the larger of its operations at 67 TFLOP/s float32 and its bytes at
3.35 TB/s, the model module's ``step_flops`` and ``step_bytes``, averaged
over the replayed batches) over the measured step time (the window's wall
time over its steps), in %. For these cells the bytes bound it. Moves
``train_examples_per_s``."""


def read(ctx):
    c, w, m = ctx["counts"], ctx["window"], ctx["model"]
    if ctx["device"] != "cuda" or not w["steps"]:
        return None
    least = 0.0
    for s in ctx["shapes"]:
        least += c.least_time_s(m.step_bytes(s), m.step_flops(s))[0]
    least /= len(ctx["shapes"])
    return 100.0 * least / (w["wall_s"] / w["steps"])
