"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with :mod:`ctypes` (no
PyTorch headers: a build takes seconds, not minutes). Libraries go to
``build/kernels/`` at the repository root, named by a hash of the
source, so an edited kernel is rebuilt and an unchanged one is reused.
All sources build at once, one ``nvcc`` process each, on the first
request for any of them; nothing is built when a module is imported.

Launch accounting: each kernel wrapper keeps its process total (the
module's ``launches``) and calls :func:`count_launch` where it
launches, which counts the launch on the calling thread
(:data:`THREAD`) and, when no tracked entry is open on that thread, in
:data:`UNTRACKED`. :mod:`..obs.torchobs` reads the thread's counts
around each tracked call, so a launch on one thread is never another
thread's, and nothing here syncs with the card.
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
SOURCES = ("labels", "chase", "tree")
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


def count_launch(kernel: int) -> None:
    """Count one launch of kernel ``SOURCES[kernel]`` on this thread."""
    thread = THREAD
    thread.counts[kernel] += 1
    if not thread.frames:
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

    def build_all(self) -> None:
        """Compile every source that has no up-to-date library, all in
        parallel; raise with ``nvcc``'s output if any build fails."""
        with self._lock:
            if len(self._libs) == len(SOURCES):
                return
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.monotonic()
            procs = {}
            for name in SOURCES:
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
            for name in SOURCES:
                self._libs[name] = ctypes.CDLL(self._target(name)[1])

    def library(self, name: str) -> ctypes.CDLL:
        if name not in self._libs:
            self.build_all()
        return self._libs[name]


KERNELS = KernelLibraries()


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``."""
    return KERNELS.library(name)
