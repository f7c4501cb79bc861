"""The port's device rule.

Entry points (``LocalStore``, ``SGDLearner``, ``cli.main``) take a
``device`` and default to the card. Without a card they raise unless the
caller asked for the CPU explicitly — the CPU runs every kernel's plain
PyTorch version, which is what the tests use, and never stands in for a
missing card by accident.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "difacto_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
