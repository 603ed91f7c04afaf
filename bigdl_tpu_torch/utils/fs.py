"""Scheme-dispatched file IO for checkpoints and model files (port of
``bigdl_tpu/utils/fs.py``).

Built in: local paths (no scheme, or ``file://``) and ``memory://``, an
in-process store.  ``register_filesystem`` installs another scheme.
The reference reaches any other scheme (``gs://``, ``hdfs://``) through
fsspec; the port does not, and such a path raises ``ValueError`` naming
its scheme until a filesystem is registered for it.
"""
from __future__ import annotations

import io
import os
import threading
from typing import BinaryIO


def _split_scheme(path: str) -> tuple[str, str]:
    """('memory', 'dir/f') for 'memory://dir/f'; ('', path) for a local
    path.  A drive letter ('C:/x') is not a scheme."""
    idx = path.find("://")
    if idx <= 1:
        return "", path
    return path[:idx], path[idx + 3:]


class FileSystem:
    """What the checkpoint code needs: streams and a few queries."""

    def open(self, path: str, mode: str = "rb") -> BinaryIO:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def remove(self, path: str) -> None:
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        """Replace ``dst`` with ``src`` (atomic where the backend can)."""
        raise NotImplementedError

    def listdir(self, path: str) -> list:
        """Entry names directly under ``path``."""
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    def open(self, path: str, mode: str = "rb") -> BinaryIO:
        if "w" in mode or "a" in mode:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        return open(path, mode)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def remove(self, path: str) -> None:
        os.remove(path)

    def rename(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def listdir(self, path: str) -> list:
        return os.listdir(path)


class MemoryFileSystem(FileSystem):
    """In-process blob store keyed by path: a flat keyspace, like an
    object store (the tests' stand-in for a remote filesystem)."""

    def __init__(self):
        self._blobs: dict[str, bytes] = {}
        self._lock = threading.Lock()

    class _Writer(io.BytesIO):
        def __init__(self, fs: "MemoryFileSystem", path: str):
            super().__init__()
            self._fs = fs
            self._path = path

        def close(self):
            with self._fs._lock:
                self._fs._blobs[self._path] = self.getvalue()
            super().close()

    def open(self, path: str, mode: str = "rb") -> BinaryIO:
        if "w" in mode:
            return MemoryFileSystem._Writer(self, path)
        with self._lock:
            if path not in self._blobs:
                raise FileNotFoundError(f"memory://{path}")
            return io.BytesIO(self._blobs[path])

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._blobs

    def makedirs(self, path: str) -> None:
        pass

    def remove(self, path: str) -> None:
        with self._lock:
            del self._blobs[path]

    def rename(self, src: str, dst: str) -> None:
        with self._lock:
            self._blobs[dst] = self._blobs.pop(src)

    def listdir(self, path: str) -> list:
        prefix = path.rstrip("/") + "/"
        with self._lock:
            return sorted({k[len(prefix):].split("/")[0]
                           for k in self._blobs if k.startswith(prefix)})


_local = LocalFileSystem()
_registry: dict[str, FileSystem] = {
    "": _local,
    "file": _local,
    "memory": MemoryFileSystem(),
}


def register_filesystem(scheme: str, fs: FileSystem) -> None:
    """Install (or replace) the filesystem serving ``scheme://`` paths."""
    _registry[scheme] = fs


def get_filesystem(path: str) -> tuple[FileSystem, str]:
    """(filesystem, the path without its scheme)."""
    scheme, rest = _split_scheme(path)
    if scheme not in _registry:
        raise ValueError(
            f"no filesystem for scheme {scheme!r} in {path!r}: the port "
            f"reads and writes local paths, file:// and memory://; "
            f"register one with bigdl_tpu_torch.utils.fs.register_filesystem")
    return _registry[scheme], rest


def open_file(path: str, mode: str = "rb") -> BinaryIO:
    fs, p = get_filesystem(path)
    return fs.open(p, mode)


def exists(path: str) -> bool:
    fs, p = get_filesystem(path)
    return fs.exists(p)


def makedirs(path: str) -> None:
    fs, p = get_filesystem(path)
    fs.makedirs(p)


def remove(path: str) -> None:
    fs, p = get_filesystem(path)
    fs.remove(p)


def listdir(path: str) -> list:
    fs, p = get_filesystem(path)
    return fs.listdir(p)


def join(base: str, *parts: str) -> str:
    """Path join that keeps a URI scheme ('memory://dir' + 'f')."""
    scheme, rest = _split_scheme(base)
    joined = "/".join([rest.rstrip("/")] + [p.strip("/") for p in parts])
    return f"{scheme}://{joined}" if scheme else os.path.join(base, *parts)


def atomic_write(path: str, data: bytes) -> None:
    """Write to ``path + ".tmp"``, then rename over ``path``: a killed
    writer never leaves a truncated file at the final path."""
    fs, p = get_filesystem(path)
    tmp = p + ".tmp"
    with fs.open(tmp, "wb") as f:
        f.write(data)
    fs.rename(tmp, p)
