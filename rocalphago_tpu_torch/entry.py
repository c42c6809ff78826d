"""Driver entry points: the flagship forward, and the multi-rank dry
run (the counterpart of the repository's ``__graft_entry__.py``).

``entry()`` returns the flagship 19×19 12-layer/128-filter 48-plane
``CNNPolicy``'s forward and an example batch, on the card unless asked
for the CPU. ``dryrun_multichip(n)`` runs one data-parallel SL train
step over ``n`` gloo ranks on the CPU, each a child process
(:func:`.parallel.launch.spawn_ranks`), as the reference runs its step
over ``n`` virtual devices: every rank must end on the same params and
loss, equal within a stated tolerance to one rank's step on the whole
batch, run in the calling process.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch


def entry(device=None):
    """``(fn, example_args)``: the flagship policy's forward and a batch
    of 8 empty positions (NHWC float32 planes)."""
    from rocalphago_tpu_torch.models import CNNPolicy

    net = CNNPolicy(board=19, layers=12, filters_per_layer=128,
                    device=device)
    planes = torch.zeros((8, 19, 19, net.preprocess.output_dim),
                         dtype=torch.float32, device=net.device)
    return net.module, (planes,)


_BOARD, _FEATURES = 9, ("board", "ones", "liberties")


def _sl_step(num_devices: int | None = None,
             batch: int | None = None) -> dict:
    """One SL train step of a small seeded float32 policy on a seeded
    global batch of ``batch`` (default ``2 × width``) positions over the
    mesh; the loss and the params after the step."""
    from rocalphago_tpu_torch.models import CNNPolicy
    from rocalphago_tpu_torch.parallel import mesh as meshlib
    from rocalphago_tpu_torch.training.sl import (
        SLConfig,
        TrainState,
        make_optimizer,
        make_train_step,
    )

    mesh = meshlib.make_mesh(num_devices, "cpu")
    net = CNNPolicy(_FEATURES, board=_BOARD, layers=3, filters_per_layer=16,
                    device="cpu", dtype=torch.float32)
    mesh.replicate(net.module)
    opt, lr_at = make_optimizer(SLConfig(learning_rate=0.01),
                                net.module.parameters())
    gen = torch.Generator().manual_seed(0)
    state = TrainState(net.module, opt, gen)
    step = make_train_step(net.module, opt, lr_at, _BOARD, symmetries=True,
                           mesh=mesh if mesh.sharded else None)
    batch = batch or 2 * mesh.width
    planes = np.random.default_rng(0).random(
        (batch, _BOARD, _BOARD, net.preprocess.output_dim)).astype(np.float32)
    actions = (np.arange(batch, dtype=np.int32) % (_BOARD * _BOARD))
    planes, actions = meshlib.shard_batch(mesh, (planes, actions))
    state, m = step(state, torch.from_numpy(planes),
                    torch.from_numpy(actions))
    return {"rank": mesh.rank, "width": mesh.width,
            "backend": mesh.backend, "loss": float(m["loss"]),
            "step": state.step,
            "params": {k: v.clone() for k, v in
                       net.module.state_dict().items()}}


#: the ranks' step against one rank's on the whole batch: float32, the
#: gradient summed over the ranks in another order (summation order only)
_RTOL, _ATOL = 1e-4, 1e-5


def dryrun_multichip(n_devices: int, workdir: str | None = None) -> dict:
    """One data-parallel SL step over ``n_devices`` gloo CPU ranks.
    Raises unless every rank stepped and agrees on the loss and the
    params bit for bit, and rank 0 equals one rank's step on the whole
    global batch, run in this process, within ``_RTOL``/``_ATOL`` (a
    divisor off by the width fails it); returns rank 0's result."""
    from rocalphago_tpu_torch.parallel.launch import spawn_ranks

    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        outs = spawn_ranks(f"{__name__}:_sl_step", n_devices, tmp,
                           {"num_devices": n_devices}, device="cpu")
    first = outs[0]
    for out in outs:
        if out["width"] != n_devices or out["step"] != 1:
            raise RuntimeError(f"rank {out['rank']}: width {out['width']}, "
                               f"step {out['step']}")
        if out["loss"] != first["loss"] or any(
                not torch.equal(out["params"][k], v)
                for k, v in first["params"].items()):
            raise RuntimeError(f"rank {out['rank']} disagrees with rank 0")
    if not np.isfinite(first["loss"]):
        raise RuntimeError(f"non-finite loss {first['loss']}")
    one = _sl_step(None, batch=2 * n_devices)
    off = [k for k, v in one["params"].items() if not np.allclose(
        first["params"][k].numpy(), v.numpy(), rtol=_RTOL, atol=_ATOL)]
    if off or not np.isclose(first["loss"], one["loss"], rtol=_RTOL,
                             atol=_ATOL):
        raise RuntimeError(
            f"{n_devices} ranks' step differs from one rank's on the whole "
            f"batch: loss {first['loss']} vs {one['loss']}, params {off}")
    print(f"dryrun_multichip({n_devices}): SL step ok over "
          f"{n_devices} {first['backend']} ranks, "
          f"loss={first['loss']:.4f}")
    return first
