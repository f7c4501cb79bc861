"""Kernel probes: each A/Bs one kernel design against the production one.

One module per probe script of the JAX package (``scripts/hw_apply2.py``,
``scripts/hw_packed_pairs.py``, ``scripts/bisect_apply.py``,
``scripts/bench_slot_accum.py``), under the script's name, at the
script's shapes. No path of the package calls the probes' kernels; run a
probe on the card as ``python -m difacto_tpu_torch.probes.<name>``. Each
``main(argv=None, device=None)`` follows the port's device rule: it
defaults to the card and raises without one unless ``device="cpu"``, where
the wrappers run their plain versions and no time is printed.
"""
