"""Actor process: self-play games over the wire, crash-resumable.

The port of the reference package's ``replaynet/actor.py``. Each actor
process owns a :class:`~rocalphago_tpu_torch.replaynet.client.
ReplayClient` with a local spool WAL and ships finished games to the
replay service; degraded-mode rules apply (service down: keep playing,
keep spooling; reconnect: re-ship in order).

Two game sources:

* ``--mode synthetic`` (default) -- a deterministic generator that
  loads no torch: game ``i`` of actor ``k`` is a pure numpy function of
  ``(seed, k, i)``, the reference's, so a SIGKILLed actor restarted
  with the same arguments regenerates byte-identical content, hence
  identical ``game_id``\\ s (in either package), and every replayed
  overlap collapses in the server's dedup window;
* ``--mode selfplay`` -- real search self-play of
  :class:`~rocalphago_tpu_torch.training.zero.ZeroIteration` on the
  reference's tiny nets (1 layer, 4 filters, features ``board`` and
  ``ones``), on the card unless ``--device`` names another device (with
  no card it raises). Params stay at version 0.

Resume: on start the actor counts its durably produced games (``acked ∪
spooled``, :meth:`ReplayClient.produced_ids`) and continues from that
index. Exit status: 0 once every requested game is produced AND the
spool drained; 2 when games remain spooled at the flush deadline (the
WAL holds them for the next run).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from rocalphago_tpu_torch.data.replay import ZeroGames
from rocalphago_tpu_torch.replaynet.client import ReplayClient


def synth_games(seed: int, actor_id: int, index: int, *,
                batch: int = 2, plies: int = 4,
                board: int = 5) -> ZeroGames:
    """Deterministic synthetic batch: content (hence ``game_id``) is a
    pure function of ``(seed, actor_id, index)``."""
    rng = np.random.default_rng(
        np.random.SeedSequence((seed, actor_id, index)))
    actions = board * board + 1
    return ZeroGames(
        actions=rng.integers(0, actions, size=(plies, batch),
                             dtype=np.int32),
        live=np.ones((plies, batch), dtype=bool),
        visits=rng.integers(0, 8, size=(plies, batch, actions),
                            dtype=np.int32),
        winners=rng.choice(np.array([-1, 1], dtype=np.int32),
                           size=(batch,)),
        finished=np.ones((batch,), dtype=bool),
    )


def _drain_spool(client: ReplayClient, timeout: float) -> bool:
    """Final flush loop: True once the spool is empty."""
    deadline = time.monotonic() + timeout
    while client.spool_depth:
        client.flush(best_effort=True)
        if not client.spool_depth:
            break
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.25)
    return True


def _run_synthetic(a, client: ReplayClient) -> int:
    done = len(client.produced_ids())
    while done < a.games:
        games = synth_games(a.seed, a.actor_id, done,
                            batch=a.batch, plies=a.plies,
                            board=a.board)
        client.put_games(games, version=0)
        done += 1
        if a.rate_s:
            time.sleep(a.rate_s)
    return done


def _run_selfplay(a, client: ReplayClient) -> int:
    """Search self-play on the reference's tiny nets; ships one batch
    per produced game index."""
    import torch

    from rocalphago_tpu_torch.engine.torchgo import GoConfig
    from rocalphago_tpu_torch.models import CNNPolicy, CNNValue
    from rocalphago_tpu_torch.parallel import mesh as meshlib
    from rocalphago_tpu_torch.training.actor import games_to_host
    from rocalphago_tpu_torch.training.zero import ZeroIteration, next_keys

    # its own mesh: the width from the local ranks (one device a rank),
    # reduced to divide --batch
    n_dev = meshlib.world_size()
    while a.batch % n_dev:
        n_dev -= 1
    mesh = meshlib.make_mesh(n_dev if n_dev in (1, meshlib.world_size())
                             else 1, a.device)
    dev = mesh.device
    feats = ("board", "ones")
    vfeats = feats + ("color",)
    pol = CNNPolicy(feats, board=a.board, layers=1, filters_per_layer=4,
                    device=dev)
    val = CNNValue(vfeats, board=a.board, layers=1, filters_per_layer=4,
                   device=dev)
    iteration = ZeroIteration(
        GoConfig(size=a.board), feats, vfeats, batch=a.batch,
        move_limit=a.move_limit, n_sim=a.sims, max_nodes=16,
        sim_chunk=a.sim_chunk, device=dev, mesh=mesh)
    rng = torch.Generator().manual_seed(
        a.seed + 1000 * (a.actor_id + 1)).get_state()
    done = len(client.produced_ids())
    # self-play content is not restart-deterministic (the chain is not
    # checkpointed): the count-based resume still never under- or
    # over-produces
    for _ in range(done, a.games):
        rng, game_seed = next_keys(rng)
        games = games_to_host(iteration.play(pol.module, val.module,
                                             game_seed))
        client.put_games(games, version=0)
        done += 1
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Replay actor process: generate self-play games "
                    "and ship them to a replay service")
    ap.add_argument("--connect", required=True,
                    metavar="HOST:PORT",
                    help="replay service address")
    ap.add_argument("--spool-dir", required=True,
                    help="local WAL directory (degraded-mode spool "
                         "+ acked ledger; also the resume state)")
    ap.add_argument("--actor-id", type=int, default=0)
    ap.add_argument("--games", type=int, default=16,
                    help="total games to produce (resume-aware)")
    ap.add_argument("--mode", choices=("synthetic", "selfplay"),
                    default="synthetic")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--board", type=int, default=5)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--plies", type=int, default=4,
                    help="synthetic: plies per game batch")
    ap.add_argument("--rate-s", type=float, default=0.0,
                    help="synthetic: sleep between games (pacing)")
    ap.add_argument("--move-limit", type=int, default=16,
                    help="selfplay: move cap")
    ap.add_argument("--sims", type=int, default=4,
                    help="selfplay: search budget")
    ap.add_argument("--sim-chunk", type=int, default=2)
    ap.add_argument("--attempts", type=int, default=6,
                    help="ship attempts before degrading to spool")
    ap.add_argument("--flush-timeout", type=float, default=30.0,
                    help="final spool-drain budget (seconds)")
    ap.add_argument("--device", default="cuda",
                    help="selfplay: torch device (default cuda; 'cpu' to "
                         "play on the CPU)")
    a = ap.parse_args(argv)

    host, _, port = a.connect.rpartition(":")
    client = ReplayClient(host or "127.0.0.1", int(port),
                          spool_dir=a.spool_dir,
                          attempts=a.attempts,
                          base_delay=0.1, max_delay=1.0,
                          seed=a.actor_id)
    try:
        if a.mode == "synthetic":
            done = _run_synthetic(a, client)
        else:
            done = _run_selfplay(a, client)
        drained = _drain_spool(client, a.flush_timeout)
    finally:
        client.close()
    print(f"actor {a.actor_id}: produced {done}/{a.games} games, "
          f"spool_depth={client.spool_depth} "
          f"reconnects={client.reconnects} "
          f"dup_acks={client.dup_acks}", flush=True)
    return 0 if drained else 2


if __name__ == "__main__":
    sys.exit(main())
