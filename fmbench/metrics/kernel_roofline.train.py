"""The hand-written kernels of the step, B1 (``rowmajor_pull_kernel``),
B3 (``segsum_tiles_kernel`` and its second pass ``segsum_cross``) and B2
(``rowmajor_apply_kernel``): their byte bound at 3.35 TB/s over their
device time in the trace, weighted by time, in %. The bytes are
fmbench/counts.py's, from each replayed batch's slots, distinct rows and
factor width. A kernel the trace does not show counts neither its bytes
nor its time; with none of them, nothing is read. Moves
``train_examples_per_s``."""

KERNELS = {
    "pull": ("rowmajor_pull_kernel",),
    "segsum": ("segsum_tiles_kernel", "segsum_cross"),
    "apply": ("rowmajor_apply_kernel",),
}


def read(ctx):
    c, t = ctx["counts"], ctx["trace"]
    shapes = ctx["shapes"]

    def nbytes(kind):
        tot = 0
        for s in shapes:
            n, K = s["n"], s["K"]
            if kind == "pull":
                tot += c.pull_bytes(n, K)
            elif kind == "apply":
                tot += c.apply_bytes(n, K)
            else:
                tot += c.segsum_bytes(s["B"] * s["L"], n,
                                      c.payload_rows(s["loss"], K))
        return tot / len(shapes)

    bound_s = time_s = 0.0
    for kind, names in KERNELS.items():
        secs = sum(v for k, v in t.by_name.items()
                   if any(name in k for name in names))
        if secs > 0:
            time_s += secs
            bound_s += (nbytes(kind) * ctx["traced_steps"]
                        / c.HBM_BYTES_PER_S)
    return 100.0 * bound_s / time_s if time_s > 0 else None
