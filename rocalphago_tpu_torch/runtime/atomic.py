"""Atomic artifact writes: tmp file + fsync + ``os.replace``.

A copy of the reference package's ``runtime/atomic.py``.

Every artifact a crashed run leaves behind must be either the old
complete version or the new complete version — never a torn prefix.
Bare ``open(path, "w")`` offers no such guarantee: a kill between
``write`` and ``close`` (or between ``close`` and the kernel flushing
the page cache) leaves a truncated file that poisons every later
resume. The fix is the standard three-step dance:

1. write the full payload to a sibling temp file in the SAME
   directory (``os.replace`` is only atomic within a filesystem);
2. ``fsync`` the file so the data is durable before the rename;
3. ``os.replace`` onto the destination — atomic on POSIX.

The directory entry itself is fsynced too (best-effort — not all
filesystems allow opening a directory) so the rename survives a
power loss, not just a process kill.
"""

from __future__ import annotations

import json
import os
import tempfile


def _fsync_dir(path: str) -> None:
    """Best-effort durability for the rename itself."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes,
                       makedirs: bool = True) -> None:
    """Write ``data`` to ``path`` so a crash at ANY point leaves
    either the previous complete file or the new complete file."""
    parent = os.path.dirname(path)
    if makedirs and parent:
        os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=parent or ".", prefix=os.path.basename(path) + ".",
        suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # the temp file is the one artifact we may leak — never the
        # destination; remove it on any failure (including the
        # injected ones the chaos tests raise)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(parent)


def atomic_write_text(path: str, text: str,
                      makedirs: bool = True) -> None:
    atomic_write_bytes(path, text.encode("utf-8"), makedirs=makedirs)


def atomic_write_json(path: str, obj, indent: int | None = 2,
                      makedirs: bool = True) -> None:
    atomic_write_text(path, json.dumps(obj, indent=indent),
                      makedirs=makedirs)
