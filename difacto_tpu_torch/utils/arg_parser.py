"""``key = val`` config-file + CLI-override parsing.

Counterpart of the reference's ``src/common/arg_parser.h`` :: ArgParser
(ReadFile/ReadArgs -> KWArgs). Same surface: a config file of
``key = value`` lines (``#`` comments allowed) plus ``key=value`` CLI
overrides, producing an ordered kwargs list consumed hierarchically by the
Param dataclasses in :mod:`difacto_tpu_torch.config`.
"""

from __future__ import annotations

import os

from ..base import KWArgs


def read_file(path: str) -> KWArgs:
    kwargs: KWArgs = []
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                raise ValueError(f"{path}:{lineno}: expected 'key = value', got {raw!r}")
            k, v = line.split("=", 1)
            kwargs.append((k.strip(), v.strip()))
    return kwargs


def read_args(args: list[str]) -> KWArgs:
    kwargs: KWArgs = []
    for a in args:
        if "=" not in a:
            raise ValueError(f"expected key=value argument, got {a!r}")
        k, v = a.split("=", 1)
        kwargs.append((k.strip(), v.strip()))
    return kwargs


def parse(argv: list[str]) -> KWArgs:
    """First arg may be a config file; the rest are key=value overrides."""
    kwargs: KWArgs = []
    rest = argv
    if argv and os.path.isfile(argv[0]) and "=" not in argv[0]:
        kwargs.extend(read_file(argv[0]))
        rest = argv[1:]
    kwargs.extend(read_args(rest))
    return kwargs
