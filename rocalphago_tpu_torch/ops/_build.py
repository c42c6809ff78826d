"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with :mod:`ctypes` (no
PyTorch headers: a build takes seconds, not minutes). Libraries go to
``build/kernels/`` at the repository root, named by a hash of the
source, so an edited kernel is rebuilt and an unchanged one is reused.
A source builds on the first request for it, and only it;
:meth:`KernelLibraries.build_all` builds every source at once, one
``nvcc`` process each. Nothing is built when a module is imported.

Launch accounting: each kernel wrapper keeps its process total (the
module's ``launches``) and calls :func:`count_launch` where it
launches, which counts the launch on the calling thread
(:data:`THREAD`) and, when no tracked entry is open on that thread, in
:data:`UNTRACKED`. :mod:`..obs.torchobs` reads the thread's counts
around each tracked call, so a launch on one thread is never another
thread's, and nothing here syncs with the card. The one exception is
named: autograd runs a CUDA backward on a device thread of its own
while the thread that called ``backward()`` waits, so a backward's
launches are counted for the thread that ran the forward
(:func:`launch_owner`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("labels", "chase", "tree", "conv_epilogue")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class ThreadLaunches(threading.local):
    """The calling thread's launch counts: ``counts[i]``, the launches
    of kernel ``SOURCES[i]`` made on this thread, and ``frames``, one
    list of nested launches per tracked entry open on it
    (:class:`~..obs.torchobs.TrackedFunction`). Each thread sees its
    own, from zero."""

    def __init__(self):
        self.counts = [0] * len(SOURCES)
        self.frames: list[list[int]] = []


#: the launch counts of the calling thread
THREAD = ThreadLaunches()
#: launches made on a thread with no tracked entry open, by kernel
#: (``SOURCES`` order), in this process
UNTRACKED = [0] * len(SOURCES)


def launch_owner() -> tuple[list, list]:
    """The calling thread's ``(counts, frames)``, for
    :func:`count_launch` to count a launch that another thread makes
    for this one."""
    return THREAD.counts, THREAD.frames


def count_launch(kernel: int, owner: tuple | None = None) -> None:
    """Count one launch of kernel ``SOURCES[kernel]`` on this thread,
    or on the thread whose :func:`launch_owner` is ``owner``."""
    counts, frames = owner or launch_owner()
    counts[kernel] += 1
    if not frames:
        UNTRACKED[kernel] += 1


class KernelLibraries:
    """Compiles the kernels once per process and hands out the loaded
    libraries; ``seconds`` and ``log`` record what the build cost and
    what ``nvcc`` reported (registers, shared memory, spills)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._libs: dict[str, ctypes.CDLL] = {}
        self.seconds = 0.0
        self.log: dict[str, str] = {}

    @staticmethod
    def nvcc() -> str:
        path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(path):
            raise RuntimeError(
                "nvcc not found: the CUDA kernels are built from "
                f"{CSRC} on first use and need the CUDA toolkit")
        return path

    @staticmethod
    def _target(name: str) -> tuple[str, str]:
        src = os.path.join(CSRC, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(
                NVCC_FLAGS).encode()).hexdigest()[:16]
        return src, os.path.join(BUILD_DIR, f"{name}-{digest}.so")

    def build(self, names) -> None:
        """Load each of ``names`` (sources in ``SOURCES``), compiling,
        all in parallel, those that have no up-to-date library; raise
        with ``nvcc``'s output if any build fails."""
        with self._lock:
            names = [n for n in names if n not in self._libs]
            if not names:
                return
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.monotonic()
            procs = {}
            for name in names:
                src, out = self._target(name)
                if os.path.exists(out):
                    continue
                tmp = f"{out}.{os.getpid()}.tmp"
                procs[name] = (subprocess.Popen(
                    [self.nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, out)
            failed = []
            for name, (proc, tmp, out) in procs.items():
                self.log[name], _ = proc.communicate()
                if proc.returncode == 0:
                    os.replace(tmp, out)
                else:
                    failed.append(name)
            self.seconds += time.monotonic() - t0
            if failed:
                raise RuntimeError("nvcc failed for " + ", ".join(
                    f"{n}.cu:\n{self.log[n]}" for n in failed))
            for name in names:
                self._libs[name] = ctypes.CDLL(self._target(name)[1])

    def build_all(self) -> None:
        """Load every source, building those that need it at once."""
        self.build(SOURCES)

    def library(self, name: str) -> ctypes.CDLL:
        if name not in self._libs:
            self.build((name,))
        return self._libs[name]


KERNELS = KernelLibraries()


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``."""
    return KERNELS.library(name)
