"""Local file streams.

Copy of the local half of ``difacto_tpu/data/io.py``: a data URI is a
file, a directory or a glob on the local filesystem. Remote URIs (fsspec
schemes) wait for ROADMAP A19 and raise.
"""

from __future__ import annotations

import glob as _glob
import os


def is_remote(uri: str) -> bool:
    """True when the URI names a non-local filesystem."""
    if "://" not in uri:
        return False
    return not uri.startswith("file://")


def _local(uri: str) -> str:
    if is_remote(uri):
        raise NotImplementedError(
            f"remote URI {uri!r}: not in the PyTorch port yet (ROADMAP A19, "
            "remote IO)"
        )
    return uri.removeprefix("file://")


def open_uri(uri: str, mode: str = "rb"):
    return open(_local(uri), mode)


def uri_size(uri: str) -> int:
    return os.path.getsize(_local(uri))


def expand_uri(uri: str) -> list[str]:
    """A data URI may be a file, a directory, or a glob (reference: dmlc
    InputSplit accepts the same forms)."""
    local = _local(uri)
    if os.path.isdir(local):
        names = sorted(
            os.path.join(local, f) for f in os.listdir(local)
            if not f.startswith(".")
        )
        if not names:
            raise FileNotFoundError(f"no data files in directory {uri!r}")
        return names
    hits = sorted(_glob.glob(local))
    if not hits:
        raise FileNotFoundError(f"no data files match {uri!r}")
    return hits
