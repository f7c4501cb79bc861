"""The step's hand-written kernels, as the model's module lists them
(``KERNELS``: a kind, its names in the trace and its useful bytes of a
replayed batch's shape; FM: B1 ``rowmajor_pull_kernel``, the fused per-key
sums ``fm_keysum_kernel`` and ``fm_keysum_join``, B2
``rowmajor_apply_kernel``; FFM: B1, B3 ``segsum_tiles_kernel`` and
``segsum_cross``, B2): their byte bound at 3.35 TB/s over their device time
in the trace, weighted by time, in %. The bytes are fmbench/counts.py's,
averaged over the replayed batches. A kind the trace does not show counts
neither its bytes nor its time; with none of them, nothing is read. Moves
``train_examples_per_s``."""


def read(ctx):
    c, t, shapes = ctx["counts"], ctx["trace"], ctx["shapes"]
    bound_s = time_s = 0.0
    for names, nbytes in ctx["model"].KERNELS.values():
        secs = sum(v for k, v in t.by_name.items()
                   if any(name in k for name in names))
        if secs > 0:
            time_s += secs
            bound_s += (sum(nbytes(s) for s in shapes) / len(shapes)
                        * ctx["traced_steps"] / c.HBM_BYTES_PER_S)
    return 100.0 * bound_s / time_s if time_s > 0 else None
