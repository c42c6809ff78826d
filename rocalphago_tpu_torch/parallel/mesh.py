"""The port's communication layer: the reference's ``parallel/mesh.py``
as ``torch.distributed``.

The reference builds one ``jax.sharding.Mesh`` over every device and
lets XLA insert the collectives. The port runs one process -- a rank --
per device, and a :class:`Mesh` is one rank's view of the data axis:
its process group, its rank, the data width (``shape["data"]``; the
``model`` axis is kept at width 1) and its device. Sharding is
placement only: a sharded run computes what the one-rank run computes.

* Every rank builds the same global batch from the same seeded draws
  and takes its own rows (:meth:`Mesh.rows`): a contiguous block, or
  with ``layout="halves"`` the rank's chunk of each half of the batch
  (self-play's colour split: net A is Black in the first half, so
  every rank holds an equal share of each half).
* Gradients are summed over the ranks (:meth:`Mesh.all_reduce_grads`).
  Each loss divides by the *global* count or batch, so the sum is the
  one-rank gradient.
* A gather is an ``all_reduce`` of a zero-padded buffer
  (:meth:`Mesh.gather`). The mesh uses only ``broadcast`` and
  ``all_reduce``: gloo supports no other collective on CUDA tensors,
  and ranks that share one card run gloo.

Launching: ``python -m torch.distributed.run --nproc-per-node N -m
MODULE ...`` on a CLI. :func:`distributed_init` reads that launcher's
contract (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) and is a no-op
for one process. The backend follows from the topology: gloo on the
CPU, NCCL when each rank has a card of its own, gloo when ranks share a
card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from rocalphago_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: the dtypes that go over the wire as they are; others are widened
_WIRE_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64)


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "")
    return int(value) if value else default


def cpu_collectives_available() -> bool:
    """Whether this torch ships gloo, the collectives of CPU ranks."""
    return dist.is_available() and dist.is_gloo_available()


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if initialized() else 0


def local_rank() -> int:
    """This rank's index among the ranks of its host."""
    return _env_int("LOCAL_RANK", process_index())


def choose_backend(device, local_ranks: int) -> tuple[str, str]:
    """``(backend, why)`` for ranks on ``device``'s type, ``local_ranks``
    of them on this host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return "gloo", "CPU ranks"
    cards = torch.cuda.device_count()
    if local_ranks <= cards:
        return "nccl", f"{local_ranks} rank(s) on {cards} card(s)"
    return "gloo", (f"{local_ranks} ranks share {cards} card(s); NCCL "
                    "refuses two ranks on one device")


def distributed_init(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device=None) -> str | None:
    """Join the process group; a no-op for one process. Returns the
    backend (None when there is no group).

    With no arguments the launcher's environment decides
    (``torch.distributed.run``); otherwise ``coordinator`` is
    ``HOST:PORT`` or an init URL (``file:///path`` for a file store)
    and ``num_processes``/``process_id`` the world and this rank.
    ``device`` is where the ranks compute (default: the card), which
    picks the backend (module docstring). The choice goes to stderr."""
    multiproc = (num_processes is not None and num_processes > 1
                 or coordinator is not None
                 or _env_int("WORLD_SIZE", 1) > 1)
    if not multiproc:
        return None
    if initialized():
        return dist.get_backend()
    world = (num_processes if num_processes is not None
             else _env_int("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else _env_int("RANK", 0)
    backend, why = choose_backend(device, _env_int("LOCAL_WORLD_SIZE",
                                                   world))
    if backend == "nccl":
        torch.cuda.set_device(_env_int("LOCAL_RANK", rank)
                              % torch.cuda.device_count())
    if coordinator is None:
        init = "env://"
    elif "://" in coordinator:
        init = coordinator
    else:
        init = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    # one write, newline included: ranks share the launcher's stderr, and
    # print's separate end write could land after another rank's line
    sys.stderr.write(f"parallel: rank {rank} of {world}, backend {backend} "
                     f"({why})\n")
    sys.stderr.flush()
    return backend


def is_coordinator() -> bool:
    """True on the rank that owns artifact writes: ``metadata.json``,
    ``metrics.jsonl``, weight exports, the persisted split, checkpoint
    files and SGFs. One-process runs are always the coordinator."""
    return process_index() == 0


class Mesh:
    """One rank's view of the data axis (module docstring). A mesh of
    width 1 takes every row; without a ``group`` (as :func:`make_mesh`
    builds it) its collectives are no-ops, and with one they run over
    that group (a one-rank NCCL group, say)."""

    def __init__(self, width: int, rank: int, device: torch.device,
                 group=None):
        self.width = width
        self.rank = rank
        self.device = device
        self.group = group
        self.shape = {DATA_AXIS: width, MODEL_AXIS: 1}

    @property
    def sharded(self) -> bool:
        return self.width > 1

    @property
    def backend(self) -> str | None:
        if self.group is None or not initialized():
            return None
        return dist.get_backend(self.group)

    # ----------------------------------------------------------- rows

    def local_batch(self, batch: int, layout: str = "contiguous") -> int:
        """This rank's share of a global ``batch``; raises unless it
        divides evenly (``halves``: by twice the width)."""
        if layout == "halves":
            if batch % (2 * self.width):
                raise ValueError(
                    f"batch {batch} must be a multiple of 2x the "
                    f"data-axis width ({self.width})")
        elif batch % self.width:
            raise ValueError(
                f"batch {batch} not divisible by data-parallel width "
                f"{self.width}")
        return batch // self.width

    def rows(self, batch: int, layout: str = "contiguous") -> np.ndarray:
        """The global indices of this rank's rows, in local order (int64):
        ``contiguous`` -- block ``rank`` of ``width``; ``halves`` --
        chunk ``rank`` of the first half, then chunk ``rank`` of the
        second."""
        local = self.local_batch(batch, layout)
        if layout == "halves":
            h = local // 2
            first = np.arange(self.rank * h, (self.rank + 1) * h)
            return np.concatenate([first, batch // 2 + first])
        if layout != "contiguous":
            raise ValueError(f"unknown layout {layout!r}")
        return np.arange(self.rank * local, (self.rank + 1) * local)

    def take(self, x, axis: int = 0, layout: str = "contiguous"):
        """This rank's rows of ``x`` (numpy or torch) along ``axis``, the
        global batch axis."""
        if not self.sharded or x is None:
            return x
        idx = self.rows(x.shape[axis], layout)
        if isinstance(x, torch.Tensor):
            return x.index_select(axis, torch.from_numpy(idx).to(x.device))
        return np.take(x, idx, axis=axis)

    # ---------------------------------------------------- collectives

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in a dtype every backend carries: integers and bools as
        int64, other floats as float32."""
        if t.dtype in _WIRE_DTYPES:
            return t
        if t.is_floating_point():
            return t.float()
        return t.long()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` over the ranks in place (``sum``, ``min`` or
        ``max``); returns it."""
        if self.group is not None:
            red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                   "max": dist.ReduceOp.MAX}[op]
            wire = self._wire(t)
            dist.all_reduce(wire, op=red, group=self.group)
            if wire is not t:
                t.copy_(wire)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns it."""
        if self.group is not None:
            wire = self._wire(t)
            dist.broadcast(wire, src, group=self.group)
            if wire is not t:
                t.copy_(wire)
        return t

    def barrier(self) -> None:
        """Wait for every rank (an ``all_reduce`` of one number)."""
        if self.group is not None:
            self.all_reduce(torch.zeros(1, device=self.device))

    def all_true(self, flags: torch.Tensor) -> bool:
        """Whether ``flags`` (bool, any shape) holds everywhere on every
        rank: one host read."""
        left = (~flags).sum(dtype=torch.int64).reshape(1)
        return int(self.all_reduce(left)) == 0

    def any_true(self, flags: torch.Tensor) -> bool:
        """Whether ``flags`` holds somewhere on some rank: one host
        read."""
        hits = flags.sum(dtype=torch.int64).reshape(1)
        return int(self.all_reduce(hits)) > 0

    def gather(self, local: torch.Tensor, axis: int = 0,
               layout: str = "contiguous") -> torch.Tensor:
        """The global tensor whose rows along ``axis`` are every rank's
        ``local`` (each rank gets it): an ``all_reduce`` of a
        zero-padded buffer, exact for every dtype."""
        if self.group is None:
            return local
        batch = local.shape[axis] * self.width
        idx = torch.from_numpy(self.rows(batch, layout)).to(local.device)
        wire = self._wire(local)
        shape = list(local.shape)
        shape[axis] = batch
        out = torch.zeros(shape, dtype=wire.dtype, device=local.device)
        out.index_copy_(axis, idx, wire)
        return self.all_reduce(out).to(local.dtype)

    def all_reduce_grads(self, modules, extra=()) -> list:
        """Sum the gradients of ``modules``' parameters over the ranks
        in place, together with the tensors ``extra`` (one
        ``all_reduce``); returns the summed ``extra``. Parameters
        without a gradient are skipped (the same on every rank)."""
        if self.group is None:
            return list(extra)
        params = [p for m in modules for p in m.parameters()
                  if p.grad is not None]
        targets = [p.grad for p in params] + [e.detach() for e in extra]
        flat = self.all_reduce(torch.cat([t.reshape(-1).float()
                                          for t in targets]))
        out, offset = [], 0
        for t in targets:
            part = flat[offset:offset + t.numel()].view(t.shape).to(t.dtype)
            offset += t.numel()
            out.append(part)
        for p, g in zip(params, out):
            p.grad.copy_(g)
        return out[len(params):]

    def replicate(self, *modules) -> None:
        """Rank 0's parameters and buffers on every rank (in place)."""
        if self.group is None:
            return
        with torch.no_grad():
            for m in modules:
                for t in m.state_dict().values():
                    self.broadcast(t)


def make_mesh(num_devices: int | None = None, device=None) -> Mesh:
    """This rank's mesh over ``num_devices`` ranks (default: every rank
    of the group; 1 without one). One rank holds one device: on the
    card rank *r* computes on ``cuda:(local_rank % device_count)``, so
    ranks beyond the cards share them. ``device`` names the device type
    (default the card; ``resolve_device``). A mesh spans one rank or
    all of them; a width above the world size raises."""
    world = world_size()
    width = world if num_devices is None else int(num_devices)
    if width < 1:
        raise ValueError(f"num_devices={width} must be >= 1")
    if width > world:
        raise ValueError(
            f"num_devices={width} but {world} rank(s) run: launch one "
            f"rank per device, e.g. python -m torch.distributed.run "
            f"--nproc-per-node {width} -m <module> ...")
    if width not in (1, world):
        raise ValueError(f"num_devices={width}: a mesh spans one rank or "
                         f"all {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if width == 1:
        return Mesh(1, 0, dev)
    return Mesh(width, process_index(), dev, group=dist.group.WORLD)


def _map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch, axis: int = 0,
                layout: str = "contiguous"):
    """This rank's slice of a pytree of global arrays (numpy or torch):
    along ``axis`` 0, or 1 for the time-major ``[T, B, ...]`` game
    records. ``mesh`` None: the batch as it is."""
    if mesh is None:
        return batch
    return _map(lambda x: mesh.take(x, axis, layout), batch)


def global_batch_size(mesh: Mesh, per_device: int) -> int:
    return per_device * mesh.shape[DATA_AXIS]
