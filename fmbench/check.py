"""The comparison that decides ``correct``.

The program's first ``CHECKED_STEPS`` training steps (fmbench/run.py's
hooks, on the window's own call and feed, in set-up) against the plain
reference's on the same rows and the same initial table, as the model's
module (``fmbench/models/<model>.py``: ``keep``, ``reference``) reads them.
Three numbers, each held to its own limit (``fmbench/limits/``):

* ``loss``: the largest relative gap of a step's summed logloss;
* ``grad``: the first gradient as the optimizer holds it, by its worst
  leaf of the module's ``LEAVES`` (``grad_<leaf>``; a leaf whose
  reference gives no gradient, such as a count, is left out). FM and FFM:
  FTRL's ``sqrt(sum n)`` after step 1 (w) and AdaGrad's ``sqrt(sum nV)``
  after step 2 (V, whose rows pass the count gate in the second step at
  the earliest);
* ``change``: the norm of the parameters' change after the last checked
  step, by its worst leaf of ``LEAVES`` (``change_<leaf>``, which the
  reference gives for every leaf: one it lacks stops the comparison).

A reading the program does not give counts as not a number.

A leaf's gap is ``|program - reference|`` over the reference's norm of
that leaf or of the median leaf, whichever is larger.
"""

from __future__ import annotations

import math
import statistics


def _worst(gaps) -> float:
    """The largest gap; infinite when any is not a number (``max`` would
    pass over a NaN)."""
    gaps = list(gaps)
    return max(gaps) if all(g == g for g in gaps) else math.inf


def worst_leaf(pairs: dict[str, tuple[float, float]]) -> float:
    """``pairs``: leaf -> (program's norm, reference's norm)."""
    med = statistics.median(r for _, r in pairs.values())
    return _worst(abs(p - r) / max(r, med) if max(r, med) > 0
                  else (0.0 if p == r else math.inf)
                  for p, r in pairs.values())


def compare(prog: dict, ref: dict, leaves) -> dict[str, float]:
    loss = (_worst(abs(p - r) / abs(r)
                   for p, r in zip(prog["loss"], ref["loss"]))
            if len(prog["loss"]) == len(ref["loss"]) else math.inf)

    missing = [f"change_{leaf}" for leaf in leaves
               if f"change_{leaf}" not in ref]
    if missing:
        raise KeyError(f"the reference gives no {', '.join(missing)}: every "
                       f"leaf's change is compared")

    def by_leaf(number):
        keys = [f"{number}_{leaf}" for leaf in leaves]
        return worst_leaf({k: (prog.get(k, math.nan), ref[k])
                           for k in keys if k in ref})

    return {"loss": loss, "grad": by_leaf("grad"),
            "change": by_leaf("change")}


def judge(numbers: dict[str, float], limits: dict) -> dict[str, bool]:
    """Each number within its limit (a NaN or an infinity is not)."""
    return {k: math.isfinite(v) and v <= limits[k]
            for k, v in numbers.items()}
