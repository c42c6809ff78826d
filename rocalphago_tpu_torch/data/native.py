"""ctypes binding for the C++ game replayer ``csrc/goreplay.cpp``.

The port of ``data/native.py``: :func:`replay_arrays` and
:class:`IllegalReplay`, with the reference's signature and outputs. The
source is built with the system ``g++`` (``-O3 -shared -fPIC
-std=c++17``) at first use, into ``build/native/`` at the repository
root, named by a hash of the source and the flags as the kernels are
(:mod:`..ops._build`): written to a temporary path and renamed into
place, so a concurrent or killed build never leaves a truncated
library. The reference's copy (``native/libgoreplay.so``) is never read
or written.

The converter replays every game through this library. Where the
reference falls back to the pure-Python ``pygo`` replay when the
library cannot be built, the port raises, as its kernel wrappers do;
``pygo`` stays the rules oracle the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "goreplay.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None               # guarded-by: _lock


def library_path() -> str:
    """Where the library of the current source and flags is built."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"goreplay-{digest}.so")


def _build(out: str) -> None:
    """Compile to a temporary path and rename it into place; raise with
    the compiler's output when the build fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the native replayer is built "
                           f"from {SOURCE} on first use")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.go_replay.restype = ctypes.c_int
            lib.go_replay.argtypes = [
                ctypes.c_int,
                np.ctypeslib.ndpointer(np.int32), ctypes.c_int,
                np.ctypeslib.ndpointer(np.int32), ctypes.c_int,
                np.ctypeslib.ndpointer(np.int32),
                np.ctypeslib.ndpointer(np.int8), ctypes.c_int,
                np.ctypeslib.ndpointer(np.int8),
                np.ctypeslib.ndpointer(np.int8),
                np.ctypeslib.ndpointer(np.int32),
                np.ctypeslib.ndpointer(np.int32),
                np.ctypeslib.ndpointer(np.int32),
            ]
            _lib = lib
        return _lib


class IllegalReplay(ValueError):
    """A recorded move was illegal (ply index in ``.ply``)."""

    def __init__(self, ply: int):
        super().__init__(f"illegal move at ply {ply}")
        self.ply = ply


def replay_arrays(size: int, setup_black, setup_white, moves, colors):
    """Replay a recorded game natively.

    ``moves`` are flat actions (``size*size`` = pass), ``colors`` ±1 per
    ply, the setup stones flat points. Returns pre-move snapshots
    ``(boards int8 [T,N], to_move int8 [T], kos int32 [T], steps int32
    [T], ages int32 [T,N])``; raises :class:`IllegalReplay` at the
    first illegal move (a setup collision is ply 0).
    """
    lib = load()
    n = size * size
    t = len(moves)
    sb = np.ascontiguousarray(setup_black, np.int32).reshape(-1)
    sw = np.ascontiguousarray(setup_white, np.int32).reshape(-1)
    mv = np.ascontiguousarray(moves, np.int32).reshape(-1)
    cl = np.ascontiguousarray(colors, np.int8).reshape(-1)
    # ndpointer rejects zero-size views: give empties real storage
    rows = max(t, 1)
    boards = np.empty((rows, n), np.int8)
    to_move = np.empty((rows,), np.int8)
    kos = np.empty((rows,), np.int32)
    steps = np.empty((rows,), np.int32)
    ages = np.empty((rows, n), np.int32)
    rc = lib.go_replay(
        size,
        sb if sb.size else np.zeros(1, np.int32), sb.size,
        sw if sw.size else np.zeros(1, np.int32), sw.size,
        mv if mv.size else np.zeros(1, np.int32),
        cl if cl.size else np.zeros(1, np.int8), t,
        boards, to_move, kos, steps, ages)
    if rc < 0:
        raise IllegalReplay(-rc - 1)
    return (boards[:t], to_move[:t], kos[:t], steps[:t], ages[:t])
