"""Checkpoint / resume with ``torch.save``, and ``metadata.json``.

The port of ``io/checkpoint.py``. A checkpoint is one directory per
step under the checkpointer's root, holding the whole training state
-- params, optimizer state, step and the symmetry generator's state --
so resume is exact (the same augmentation stream; the batch order is
derived from the step). A step is written under a temporary name and
renamed when complete, so an interrupted save is invisible to
:meth:`TrainCheckpointer.latest_step`. Saves are synchronous; ``wait``
and ``close`` are kept for the reference's call sites.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import torch

from rocalphago_tpu_torch.runtime.atomic import _fsync_dir, atomic_write_json
from rocalphago_tpu_torch.runtime.retries import retry

_STATE_FILE = "state.pt"


class TrainCheckpointer:
    """One ``torch.save`` file per step directory ``<root>/<step>``.

    Data-parallel ranks hold the same replicated state, so one writes
    it: ``write=False`` on the others, and ``mesh`` (a
    :class:`~..parallel.mesh.Mesh`) makes every save a barrier, after
    which every rank restores the written files."""

    def __init__(self, directory: str, write: bool = True, mesh=None):
        self.directory = os.path.abspath(directory)
        self.write = write
        self.mesh = mesh
        os.makedirs(self.directory, exist_ok=True)

    def save(self, step: int, state: dict) -> None:
        """Write ``state`` as step ``step`` (on the writing rank), then
        wait for every rank."""
        if self.write:
            self.write_step(step, state)
        if self.mesh is not None:
            self.mesh.barrier()

    # transient-failure backoff around the filesystem: a flaky shared
    # filesystem can fail a write or a read that succeeds a moment
    # later; both are idempotent
    @retry(max_attempts=3, base_delay=0.5)
    def write_step(self, step: int, state: dict) -> None:
        """Write ``state`` (a dict of tensors, numbers and nested dicts
        of them; tensors are saved as they are given) as step ``step``,
        with no barrier (a watchdog's last save)."""
        final = os.path.join(self.directory, str(int(step)))
        tmp = os.path.join(self.directory, f".tmp-{int(step)}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        path = os.path.join(tmp, _STATE_FILE)
        with open(path, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        # a re-save of a step (a resumed run re-running an epoch)
        # replaces the old directory
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        _fsync_dir(self.directory)

    def all_steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @retry(max_attempts=3, base_delay=0.5)
    def _restore_step(self, step: int) -> dict:
        path = os.path.join(self.directory, str(int(step)), _STATE_FILE)
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore(self, step: int | None = None):
        """``(state, step)`` of the newest step, or of ``step``;
        ``(None, None)`` when there is none. Tensors come back on the
        CPU.

        Fallback: a damaged newest step (files missing or truncated
        after the rename) logs a warning and restore falls back to the
        next older step; an explicitly requested step raises (the
        caller asked for THAT step)."""
        if step is not None:
            return self._restore_step(step), step
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            return None, None
        last_exc = None
        for i, s in enumerate(steps):
            try:
                return self._restore_step(s), s
            except Exception as e:  # noqa: BLE001 — warned + fall back
                last_exc = e
                older = steps[i + 1] if i + 1 < len(steps) else None
                tail = (f"; falling back to step {older}"
                        if older is not None
                        else "; no older step retained")
                print(f"checkpoint: step {s} failed to restore "
                      f"({type(e).__name__}: {e}){tail}",
                      file=sys.stderr)
        raise last_exc

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        """Nothing to release."""


class MetadataWriter:
    """Append-per-epoch ``metadata.json`` (the reference's
    ``MetadataWriterCallback`` format -- tooling reads this file)."""

    def __init__(self, path: str, header: dict | None = None,
                 enabled: bool = True):
        self.path = path
        #: False on ranks that are not the coordinator: nothing written
        self.enabled = enabled
        self.data = None
        if enabled and os.path.exists(path):
            try:
                with open(path) as f:
                    self.data = json.load(f)
            except ValueError:
                # a torn file from a crash before atomic writes; start
                # a fresh record rather than poisoning the resumed run
                print(f"metadata: {path} is corrupt, starting fresh",
                      file=sys.stderr)
        if self.data is None:
            self.data = dict(header or {})
            self.data.setdefault("epochs", [])
            self._flush()
        self.data.setdefault("epochs", [])

    def record_epoch(self, entry: dict) -> None:
        entry = dict(entry, wall_time=time.time())
        # resume overwrite semantics: re-running an epoch after a crash
        # REPLACES its provisional record, so a resumed run's metadata
        # converges to the uninterrupted run's
        for key in ("iteration", "epoch"):
            if key in entry:
                self.data["epochs"] = [
                    e for e in self.data["epochs"]
                    if e.get(key) != entry[key]]
                break
        self.data["epochs"].append(entry)
        self._flush()

    def update(self, **fields) -> None:
        self.data.update(fields)
        self._flush()

    def _flush(self) -> None:
        if self.enabled:
            atomic_write_json(self.path, self.data)
