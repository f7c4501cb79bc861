"""URI-addressed streams: local filesystem natively, any fsspec scheme
(``gs://``, ``s3://``, ``http://``, ``memory://``, ...) when a scheme is
present.

Copy of ``difacto_tpu/data/io.py`` (reference: dmlc-core ``src/io/`` ::
local / HDFS / S3 filesystems behind ``dmlc::Stream``, and
``InputSplit``'s URI handling): data, model and prediction URIs work the
same whether they point at local disk or an object store. fsspec file
objects are seekable, so the byte-range parts of text files
(``libsvm.py :: iter_file_chunks``), gzip streams and ``np.load`` of csr
parts and checkpoints work unchanged over remote streams, through the
same chunk parser, native or NumPy, as local files. fsspec is a
requirement of PyTorch, and is imported only for a remote URI. The tests
exercise the remote path with fsspec's in-process ``memory://``
filesystem (per process: a run on it is in process, never a subprocess).
"""

from __future__ import annotations

import glob as _glob
import os


def is_remote(uri: str) -> bool:
    """True when the URI names a non-local fsspec filesystem."""
    if "://" not in uri:
        return False
    return not uri.startswith("file://")


def _fs(uri: str):
    try:
        import fsspec
    except ImportError as e:  # pragma: no cover - a requirement of torch
        raise ImportError(
            f"reading {uri!r} needs fsspec (remote URI schemes); "
            "install fsspec or use a local path"
        ) from e
    return fsspec.core.url_to_fs(uri)


def open_uri(uri: str, mode: str = "rb"):
    """Open a (possibly remote) URI as a seekable file object."""
    if is_remote(uri):
        fs, path = _fs(uri)
        return fs.open(path, mode)
    return open(uri.removeprefix("file://"), mode)


def uri_size(uri: str) -> int:
    if is_remote(uri):
        fs, path = _fs(uri)
        return fs.size(path)
    return os.path.getsize(uri.removeprefix("file://"))


def expand_uri(uri: str) -> list[str]:
    """A data URI may be a file, a directory, or a glob (reference: dmlc
    InputSplit accepts the same forms), local or remote."""
    if is_remote(uri):
        fs, path = _fs(uri)
        proto = uri.split("://", 1)[0]
        if fs.isdir(path):
            names = [p for p in fs.ls(path, detail=False)
                     if not p.rsplit("/", 1)[-1].startswith(".")]
        else:
            names = fs.glob(path)
        if not names:
            raise FileNotFoundError(f"no data files match {uri!r}")
        return [f"{proto}://{n}" for n in sorted(names)]
    local = uri.removeprefix("file://")
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
