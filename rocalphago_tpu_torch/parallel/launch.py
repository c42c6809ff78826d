"""Ranks as child processes over a file store.

:func:`spawn_ranks` starts ``n`` Python processes. Each joins one
process group through a ``FileStore`` in a scratch directory (no port
to pick), sets ``torch.set_num_threads(1)``, calls a function named
``module:function`` with keyword arguments and saves what it returns;
the parent reads every rank's value back, in rank order, and raises
with the ranks' logs if any fails. The function builds its own mesh
(:func:`.mesh.make_mesh`), as the trainers do. The CLIs are launched
with ``torch.distributed.run`` instead.

One rank, as :func:`spawn_ranks` runs it::

    python -m rocalphago_tpu_torch.parallel.launch STORE RANK WORLD \\
        MODULE:FUNCTION ARGS.pt OUT.pt DEVICE
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn_ranks(target: str, n: int, workdir: str, kwargs: dict | None = None,
                device: str | None = None, timeout: float = 300.0,
                paths: tuple = ()) -> list:
    """Run ``target(**kwargs)`` in ``n`` ranks; their return values.
    ``paths`` go on the ranks' ``sys.path`` (before the repository's
    root); ``device`` is where the ranks compute (default the card,
    ``resolve_device``) and picks the backend (``distributed_init``)."""
    import torch

    from rocalphago_tpu_torch.device import resolve_device

    device = resolve_device(device).type
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    args_path = os.path.join(workdir, "args.pt")
    torch.save(dict(kwargs or {}), args_path)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [*paths, _ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                           else []))
    outs = [os.path.join(workdir, f"rank{r}.pt") for r in range(n)]
    logs = [os.path.join(workdir, f"rank{r}.log") for r in range(n)]
    procs = []
    try:
        for r in range(n):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, store, str(r), str(n),
                     target, args_path, outs[r], device],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = []
        for r in failed:
            with open(logs[r]) as f:
                tails.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                             + f.read()[-4000:])
        raise RuntimeError(f"{target}: rank(s) {failed} failed\n"
                           + "\n".join(tails))
    return [torch.load(path, weights_only=False) for path in outs]


def main(argv=None) -> int:
    store, rank, world, target, args_path, out_path, device = (
        argv if argv is not None else sys.argv[1:])
    import torch

    from rocalphago_tpu_torch.parallel import mesh as meshlib

    torch.set_num_threads(1)
    meshlib.distributed_init(coordinator=f"file://{store}",
                             num_processes=int(world),
                             process_id=int(rank), device=device)
    module, _, name = target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    result = fn(**torch.load(args_path, weights_only=False))
    torch.save(result, out_path)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
