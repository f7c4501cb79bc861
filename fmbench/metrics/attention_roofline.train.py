"""The interacting layers' share of their roofline: the least time of the
stack's work, forward and backward with the output (the model module's
``attention_flops`` and ``attention_bytes`` of each replayed batch, at
67 TFLOP/s float32 and 3.35 TB/s, fmbench/counts.py's
``least_time_s``), over the device time of the operations in the
program's span ``difacto.attention``, in %. The same work whatever
implements the stack. Nothing without the span (the CPU; a program
without it) or where the model has no such counts. Moves
``train_examples_per_s``."""


def read(ctx):
    s, m, c = ctx["spans"], ctx["model"], ctx["counts"]
    t = s.by_span.get("difacto.attention") if s is not None else None
    if not t or not hasattr(m, "attention_flops"):
        return None
    least = sum(c.least_time_s(m.attention_bytes(x), m.attention_flops(x))[0]
                for x in ctx["shapes"]) / len(ctx["shapes"])
    return 100.0 * least * ctx["traced_steps"] / t
