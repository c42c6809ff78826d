"""SGF corpus → training-data converter, encoding on the card.

The port of ``data/convert.py`` (the reference's ``GameConverter``:
``convert_game``, ``sgfs_to_shards``, ``sgfs_to_hdf5`` and the
``run_game_converter`` CLI). Games are replayed on the host by the C++
replayer (:mod:`.native`, built at first use; a failed build raises,
where the reference falls back to pygo); the positions of a game are
encoded together on the device: one labels-kernel launch seeds the
carried labels of an encode batch (:func:`pack_states`), and the two
ladder planes run the chase kernel. The pygo replay through
:func:`..data.sgf.replay` stays as the plain version the tests hold the
native one to (``GameConverter._replay_pygo``).

Output is sharded ``.npz`` (uint8 NHWC states, int32 flat actions, a
JSON manifest) in the reference's file names and manifest format, so
each package reads the other's corpora; the HDF5 writer keeps the
reference's layout (uint8 NCHW) and needs ``h5py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

import numpy as np
import torch

from rocalphago_tpu_torch.data import native
from rocalphago_tpu_torch.data import sgf as sgflib
from rocalphago_tpu_torch.device import resolve_device
from rocalphago_tpu_torch.engine import pygo, torchgo
from rocalphago_tpu_torch.engine.torchgo import GoConfig, GoState
from rocalphago_tpu_torch.features import DEFAULT_FEATURES, Preprocess

# positions per encode (one labels launch each); rows are independent,
# so the batch only bounds the encoder's working memory
_ENCODE_BATCH = 256

# the reference converter's ladder reader: rungs per read, candidate
# lanes per plane and live chases per lane. Preprocess defaults to 6
# chase slots; a corpus read with another count differs in its ladder
# planes, so the converter pins the reference's values.
LADDER_DEPTH = 40
LADDER_LANES = 16
LADDER_CHASE_SLOTS = 4


def pack_states(cfg: GoConfig, boards, turns, kos, steps, ages,
                device) -> GoState:
    """Assemble a batched GoState on ``device`` from raw numpy fields
    (hash and history zeroed -- converters run with superko off, so
    legality inside the encoder never consults them). The carried
    labels are seeded with one batched fill (:func:`torchgo.seed_labels`,
    the labels kernel on the card)."""
    b = len(boards)
    n = cfg.num_points

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x, dtype), device=device)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    state = GoState(
        board=t(boards, np.int8), turn=t(turns, np.int8),
        ko=t(kos, np.int32), pass_count=zeros((b,), torch.int8),
        done=zeros((b,), torch.bool), step_count=t(steps, np.int32),
        hash=zeros((b, 2), torch.int64),
        hash_history=zeros((b, cfg.max_history, 2), torch.int64),
        stone_ages=t(ages, np.int32), prisoners=zeros((b, 2), torch.int32),
        labels=torch.full((b, n), n, dtype=torch.int32, device=device))
    return torchgo.seed_labels(cfg, state)


class GameConverter:
    """Replay SGF games and emit (encoded state, expert action) pairs,
    on CUDA unless ``device`` names another device."""

    def __init__(self, feature_list=DEFAULT_FEATURES, board_size: int = 19,
                 device=None):
        self.board_size = board_size
        self.device = resolve_device(device)
        self.cfg = GoConfig(size=board_size, enforce_superko=False,
                            max_history=8)
        self.pre = Preprocess(feature_list, cfg=self.cfg,
                              ladder_depth=LADDER_DEPTH,
                              ladder_lanes=LADDER_LANES,
                              ladder_chase_slots=LADDER_CHASE_SLOTS,
                              device=self.device)
        self.feature_list = tuple(feature_list)

    # ------------------------------------------------------------ encoding

    def _encode_fields(self, fields):
        """fields: list of (board, turn, ko, step, ages) → [n,s,s,F]
        uint8."""
        out = []
        for i in range(0, len(fields), _ENCODE_BATCH):
            chunk = fields[i:i + _ENCODE_BATCH]
            st = pack_states(self.cfg, *map(list, zip(*chunk)),
                             device=self.device)
            out.append((self.pre.states_to_tensor(st) > 0.5).to(torch.uint8))
        return torch.cat(out).cpu().numpy()

    def convert_game(self, sgf_text: str, include_passes: bool = False):
        """One game → (states uint8 [n,s,s,F] NHWC, actions int32 [n]).

        Positions whose move is a pass are dropped unless
        ``include_passes`` (the policy output space is board points, as
        in the reference; pass handling lives at the agent layer), and
        so are out-of-turn moves.
        """
        game = sgflib.parse(sgf_text)
        if game.size != self.board_size:
            raise sgflib.SGFError(
                f"board size {game.size} != converter size "
                f"{self.board_size}")
        fields, actions = self._replay_native(game, include_passes)
        if not fields:
            return (np.zeros((0, game.size, game.size,
                              self.pre.output_dim), np.uint8),
                    np.zeros((0,), np.int32))
        return (self._encode_fields(fields),
                np.asarray(actions, np.int32))

    def _replay_native(self, game, include_passes: bool):
        """The positions of ``game`` to encode, ``(fields, actions)``,
        replayed by the C++ library (:func:`.native.replay_arrays`)."""
        size = game.size
        n = self.cfg.num_points

        def flat(p):
            return p[0] * size + p[1]

        moves = np.asarray([n if mv is None else flat(mv)
                            for _, mv in game.moves], np.int32)
        colors = np.asarray([c for c, _ in game.moves], np.int8)
        boards, to_move, kos, steps, ages = native.replay_arrays(
            size, [flat(p) for p in game.setup_black],
            [flat(p) for p in game.setup_white], moves, colors)
        keep = [t for t in range(len(moves))
                if (include_passes or moves[t] != n)
                and colors[t] == to_move[t]]
        fields = [(boards[t], np.int8(to_move[t]), np.int32(kos[t]),
                   np.int32(steps[t]), ages[t]) for t in keep]
        return fields, [int(moves[t]) for t in keep]

    def _replay_pygo(self, game, include_passes: bool):
        """:meth:`_replay_native` on the rules oracle (pygo): the plain
        version the tests hold the native replayer to."""
        n = self.cfg.num_points
        fields, actions = [], []
        for st, move, player in sgflib.replay(game):
            if move is None and not include_passes:
                continue
            if player != st.current_player:
                # out-of-turn move (free placement SGF) — skip position
                continue
            # snapshot with copies: pygo mutates stone_ages in place as
            # the generator advances, so a view here would give every
            # position the END-of-game ages
            fields.append((
                np.array(st.board, np.int8).reshape(-1),
                np.int8(st.current_player),
                np.int32(-1 if st.ko is None
                         else st.ko[0] * game.size + st.ko[1]),
                np.int32(st.turns_played),
                np.array(st.stone_ages, np.int32).reshape(-1),
            ))
            actions.append(n if move is None
                           else move[0] * game.size + move[1])
        return fields, actions

    # ------------------------------------------------------------- corpora

    def _iter_sgf_files(self, directory: str, recurse: bool):
        if recurse:
            for root, _, names in sorted(os.walk(directory)):
                for name in sorted(names):
                    if name.lower().endswith(".sgf"):
                        yield os.path.join(root, name)
        else:
            for name in sorted(os.listdir(directory)):
                if name.lower().endswith(".sgf"):
                    yield os.path.join(directory, name)

    def _convert_file(self, path: str, errors: list | None):
        """(states, actions) of one file, or None when it is skipped
        (``errors`` given: the failure is recorded and warned)."""
        try:
            with open(path, "r", errors="replace") as f:
                return self.convert_game(f.read())
        except (sgflib.SGFError, pygo.IllegalMove, OSError,
                ValueError) as e:
            if errors is None:
                raise
            errors.append({"file": path, "error": str(e)})
            warnings.warn(f"skipping {path}: {e}")
            return None

    def sgfs_to_shards(self, files, out_prefix: str,
                       shard_size: int = 8192,
                       ignore_errors: bool = True) -> dict:
        """Convert SGF files to ``{out_prefix}-NNNNN.npz`` shards plus a
        ``{out_prefix}-manifest.json``. Corrupt or illegal games are
        skipped with a warning (reference ``ignore_errors`` behavior).
        """
        parent = os.path.dirname(out_prefix)
        if parent:
            os.makedirs(parent, exist_ok=True)
        buf_s, buf_a = [], []
        counts, errors = [], []
        n_shards = n_positions = n_games = 0

        def flush():
            nonlocal n_shards, n_positions
            if not buf_s:
                return
            states = np.concatenate(buf_s, axis=0)
            actions = np.concatenate(buf_a, axis=0)
            path = f"{out_prefix}-{n_shards:05d}.npz"
            np.savez_compressed(path, states=states, actions=actions)
            counts.append(len(actions))
            n_shards += 1
            n_positions += len(actions)
            buf_s.clear()
            buf_a.clear()

        for path in files:
            got = self._convert_file(path, errors if ignore_errors else None)
            if got is None or len(got[1]) == 0:
                continue
            n_games += 1
            buf_s.append(got[0])
            buf_a.append(got[1])
            if sum(len(a) for a in buf_a) >= shard_size:
                flush()
        flush()

        manifest = {
            "format": "rocalphago_tpu/npz-shards/v1",
            "board_size": self.board_size,
            "features": list(self.feature_list),
            "planes": self.pre.output_dim,
            "layout": "NHWC",
            "num_shards": n_shards,
            "num_positions": n_positions,
            "num_games": n_games,
            "shard_counts": counts,
            "errors": errors,
        }
        with open(f"{out_prefix}-manifest.json", "w") as f:
            json.dump(manifest, f, indent=2)
        return manifest

    def sgfs_to_hdf5(self, files, outfile: str,
                     ignore_errors: bool = True) -> int:
        """Reference-layout HDF5: growable uint8 ``states`` (n, F, s, s)
        NCHW + int32 ``actions`` (n,), feature list as a file attr."""
        import h5py
        parent = os.path.dirname(outfile)
        if parent:
            os.makedirs(parent, exist_ok=True)
        n_positions = 0
        with h5py.File(outfile, "w") as h5:
            s = self.board_size
            states = h5.create_dataset(
                "states", shape=(0, self.pre.output_dim, s, s),
                maxshape=(None, self.pre.output_dim, s, s),
                dtype=np.uint8, chunks=(64, self.pre.output_dim, s, s),
                compression="lzf")
            acts = h5.create_dataset(
                "actions", shape=(0,), maxshape=(None,), dtype=np.int32,
                chunks=(1024,))
            h5.attrs["features"] = ",".join(self.feature_list)
            h5.attrs["board_size"] = s
            for path in files:
                got = self._convert_file(path, [] if ignore_errors else None)
                if got is None or len(got[1]) == 0:
                    continue
                st, ac = got
                k = len(ac)
                states.resize(n_positions + k, axis=0)
                acts.resize(n_positions + k, axis=0)
                states[n_positions:] = st.transpose(0, 3, 1, 2)  # → NCHW
                acts[n_positions:] = ac
                n_positions += k
        return n_positions


def run_game_converter(argv=None):
    """CLI mirroring the reference's ``run_game_converter``; runs on the
    card unless ``--device`` names another device."""
    ap = argparse.ArgumentParser(
        description="Convert SGF games to training data")
    ap.add_argument("--directory", "-d", required=True)
    ap.add_argument("--outfile", "-o", required=True,
                    help="shard prefix (npz) or .h5 path (hdf5)")
    ap.add_argument("--recurse", "-R", action="store_true")
    ap.add_argument("--features", default=",".join(DEFAULT_FEATURES))
    ap.add_argument("--size", type=int, default=19)
    ap.add_argument("--format", choices=("npz", "hdf5"), default="npz")
    ap.add_argument("--shard-size", type=int, default=8192)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    conv = GameConverter(tuple(args.features.split(",")),
                         board_size=args.size, device=args.device)
    files = conv._iter_sgf_files(args.directory, args.recurse)
    if args.format == "npz":
        manifest = conv.sgfs_to_shards(files, args.outfile,
                                       shard_size=args.shard_size)
        result = {k: manifest[k] for k in
                  ("num_shards", "num_positions", "num_games")}
    else:
        result = {"num_positions": conv.sgfs_to_hdf5(files, args.outfile)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    run_game_converter(sys.argv[1:])
