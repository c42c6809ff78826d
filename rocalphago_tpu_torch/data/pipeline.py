"""Host→device input pipeline over converted shards.

The port of ``data/pipeline.py``. The host half -- :class:`ShardedDataset`,
:func:`split_indices`, :func:`batch_iterator` -- is numpy and copied as
it stands, so that a seed gives the reference's split files and batch
orders bit for bit (the same permutations, the same ``skip`` cursor).
:func:`device_prefetch` stages batches on the card from a worker
thread: pinned host copies, ``non_blocking`` transfers on a side CUDA
stream, and an event per batch that the consumer's stream waits on;
it counts its own work in the registry (:mod:`..obs.registry`): each
stage of the worker, and the consumer's gets that found nothing staged.
Dihedral augmentation runs on the device in the train step
(:mod:`..training.symmetries`), not per sample on the host.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import zipfile

import numpy as np
import torch

from rocalphago_tpu_torch.obs import registry as obs_registry


class ShardedDataset:
    """Random-access view over ``prefix-NNNNN.npz`` shards."""

    def __init__(self, prefix: str):
        with open(f"{prefix}-manifest.json") as f:
            self.manifest = json.load(f)
        self.prefix = prefix
        counts = self.manifest["shard_counts"]
        self._starts = np.cumsum([0] + counts)
        self.num_positions = int(self._starts[-1])
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return self.num_positions

    @property
    def planes(self) -> int:
        return int(self.manifest["planes"])

    @property
    def board_size(self) -> int:
        return int(self.manifest["board_size"])

    def _shard(self, i: int):
        if i not in self._cache:
            z = np.load(f"{self.prefix}-{i:05d}.npz")
            self._cache[i] = (z["states"], z["actions"])
            # keep at most 4 shards resident
            while len(self._cache) > 4:
                self._cache.pop(next(iter(self._cache)))
        return self._cache[i]

    def gather(self, indices: np.ndarray):
        """(states [b,s,s,F] uint8, actions [b] int32) for global
        indices (any order)."""
        states = None
        actions = np.empty(len(indices), np.int32)
        shard_ids = np.searchsorted(self._starts, indices, "right") - 1
        for sid in np.unique(shard_ids):
            s_states, s_actions = self._shard(int(sid))
            sel = shard_ids == sid
            local = indices[sel] - self._starts[sid]
            if states is None:
                states = np.empty(
                    (len(indices),) + s_states.shape[1:], s_states.dtype)
            states[sel] = s_states[local]
            actions[sel] = s_actions[local]
        return states, actions


def load_hdf5(path: str):
    """Reference-layout HDF5 → (states uint8 NHWC, actions int32).
    Interchange reader for corpora converted by the reference stack;
    needs ``h5py``."""
    import h5py
    with h5py.File(path, "r") as h5:
        states = np.asarray(h5["states"], np.uint8).transpose(0, 2, 3, 1)
        actions = np.asarray(h5["actions"], np.int32)
    return states, actions


def split_indices(n: int, fractions=(0.93, 0.05, 0.02), seed: int = 0,
                  path: str | None = None, write: bool = True):
    """Shuffled train/val/test index split; persisted to ``path`` (npz)
    so interrupted runs resume with the identical split (the
    reference's ``shuffle.npz`` behavior). ``write=False`` (a rank
    that is not the coordinator) reads an existing file but never
    writes one: the split is a pure function of the seed."""
    if path is not None:
        try:
            z = np.load(path)
            tr, va, te = z["train"], z["val"], z["test"]
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            # BadZipFile/ValueError: a torn read of a file another
            # process is mid-writing -- recompute; the permutation is
            # a pure function of the seed, so every process agrees
            tr = None
        if tr is not None:
            total = len(tr) + len(va) + len(te)
            if total != n:
                raise ValueError(
                    f"persisted split at {path} covers {total} positions "
                    f"but the dataset has {n}; the corpus changed — "
                    "delete the split file to reshuffle (this breaks "
                    "resume reproducibility) or restore the old corpus")
            return tr, va, te
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(n * fractions[0])
    n_val = int(n * fractions[1])
    train = perm[:n_train]
    val = perm[n_train:n_train + n_val]
    test = perm[n_train + n_val:]
    if path is not None and write:
        # atomic write (.npz suffix on the temp name stops np.savez
        # appending another one)
        tmp = path + ".tmp.npz"
        np.savez(tmp, train=train, val=val, test=test)
        os.replace(tmp, path)
    return train, val, test


def batch_iterator(dataset, indices: np.ndarray, batch_size: int,
                   rng: np.random.Generator, epochs: int | None = None,
                   drop_remainder: bool = True,
                   shard_window: int | None = 4, skip: int = 0):
    """Yield host (states, actions) batches, reshuffling every epoch.

    Shuffling is two-level when the corpus spans many shards: shard
    visit order is permuted per epoch, then indices are fully permuted
    inside windows of ``shard_window`` shards -- so a minibatch only
    touches shards the dataset cache holds resident.
    ``shard_window=None`` restores the global permutation.

    ``skip`` drops the first ``skip`` batches of the FIRST epoch only --
    index arithmetic, no shard reads -- the mid-epoch resume cursor:
    with the same ``rng`` seed the epoch's batch order is reproduced
    and the already-consumed prefix is skipped.
    """
    starts = getattr(dataset, "_starts", None)
    epoch = 0
    while epochs is None or epoch < epochs:
        if shard_window is None or starts is None or len(starts) <= 2:
            order = rng.permutation(indices)
        else:
            shard_of = np.searchsorted(starts, indices, "right") - 1
            shard_ids = rng.permutation(np.unique(shard_of))
            chunks = []
            for w in range(0, len(shard_ids), shard_window):
                window = shard_ids[w:w + shard_window]
                pool = indices[np.isin(shard_of, window)]
                chunks.append(rng.permutation(pool))
            order = np.concatenate(chunks)
        end = (len(order) // batch_size) * batch_size if drop_remainder \
            else len(order)
        start = (skip * batch_size) if epoch == 0 else 0
        for i in range(start, end, batch_size):
            yield dataset.gather(order[i:i + batch_size])
        epoch += 1


def device_prefetch(host_iter, device, size: int = 2, registry=None):
    """Stage host batches (tuples of numpy arrays) on ``device`` ahead
    of consumption; yields tuples of tensors.

    On CUDA a worker thread pins each array, copies it with
    ``non_blocking=True`` on a side stream and records an event behind
    the copies; the consumer's stream waits on that event before the
    batch is handed out, and each tensor is marked as used by the
    consumer's stream (``record_stream``), so the allocator cannot
    reuse its memory while a step that reads it is still queued. On
    the CPU the arrays are wrapped as they are: no stream, no pinning.

    Worker exceptions propagate to the consumer. Close is bounded: the
    stop event is set, staged batches are drained so the worker's
    pending ``put`` sees the stop within its 100 ms poll, and the
    worker is joined (5 s cap -- it may be inside one last host batch
    read).

    Every batch is counted in ``registry`` (the process default when
    None), on CUDA and on the CPU alike. The worker times each staged
    batch's stages in ``prefetch_stage_seconds{stage=}`` (wall) and
    ``prefetch_stage_cpu_seconds_total{stage=}`` (its own thread's CPU,
    ``read`` and ``pin`` only): ``read`` is the ``next()`` on
    ``host_iter`` (batch order, gather, shard loads), ``pin`` the host
    tensors, the pinned copies and the event queued on the side stream
    (host time only), ``put`` the time blocked on a full queue (the
    worker's slack). The consumer counts the batches it hands out
    (``prefetch_batches_total``), the gets that found the queue empty
    (``prefetch_starved_total``) and their wait
    (``prefetch_starved_seconds_total``). CPU seconds are the worker
    thread's alone: a wait for a core or the GIL, and torch's intra-op
    helper threads in the pin copy, read as wall time without CPU.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    _END = object()
    reg = registry or obs_registry.REGISTRY
    read_s, pin_s, put_s = (reg.histogram("prefetch_stage_seconds",
                                          stage=name)
                            for name in ("read", "pin", "put"))
    read_cpu, pin_cpu = (reg.counter("prefetch_stage_cpu_seconds_total",
                                     stage=name) for name in ("read", "pin"))
    handed = reg.counter("prefetch_batches_total")
    starved = reg.counter("prefetch_starved_total")
    starved_s = reg.counter("prefetch_starved_seconds_total")

    def stage(item):
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in item]
        if not cuda:
            return tuple(host), None
        # pinned blocks from the caching host allocator are not reused
        # before the copies that read them have completed
        with torch.cuda.stream(copy_stream):
            out = tuple(t.pin_memory().to(device, non_blocking=True)
                        for t in host)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return out, ready

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            if cuda and device.index is not None:
                torch.cuda.set_device(device)
            it = iter(host_iter)
            # a stage's CPU clock pair lies inside its wall clock pair,
            # so its CPU seconds never exceed its wall seconds (a
            # tick-based thread clock keeps that only over many batches)
            w0 = time.monotonic()
            while True:
                c0 = time.thread_time()
                item = next(it, _END)
                if item is _END:
                    break
                c1 = time.thread_time()
                w1 = time.monotonic()
                c2 = time.thread_time()
                staged = stage(item)
                c3 = time.thread_time()
                w2 = time.monotonic()
                queued = put(staged)
                w3 = time.monotonic()
                read_s.observe(w1 - w0)
                read_cpu.inc(c1 - c0)
                pin_s.observe(w2 - w1)
                pin_cpu.inc(c3 - c2)
                put_s.observe(w3 - w2)
                if not queued:
                    return
                w0 = w3
            put(_END)
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            try:
                item, waited = q.get_nowait(), None
            except queue.Empty:
                t0 = time.monotonic()
                item = q.get()
                waited = time.monotonic() - t0
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            tensors, ready = item
            if cuda:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for x in tensors:
                    x.record_stream(consumer)
            handed.inc()
            if waited is not None:
                starved.inc()
                starved_s.inc(waited)
            yield tensors
    finally:
        stop.set()
        # drain staged batches so a worker blocked on the full queue
        # reaches its stop-event poll, then wait for it to exit
        while not q.empty():
            q.get_nowait()
        t.join(timeout=5.0)
