"""Standalone model evaluation: model.json + corpus → metric JSON.

The port of ``training/evaluate.py``: the measurement path for
BASELINE.md metric 1 (SL policy top-1 move accuracy on held-out
positions) and its value-net analogue, without running a trainer.
Load a registered net from its JSON spec, stream a converted corpus
through the forward, and print one JSON line with the metric(s).

Usage::

    python -m rocalphago_tpu_torch.training.evaluate model.json corpus-prefix
        [--split test --shuffle-npz out/shuffle.npz]
        [--minibatch 256] [--max-batches N] [--device cpu]

With ``--shuffle-npz`` the persisted trainer split is honored, so the
reported number is on exactly the positions the trainer never touched;
otherwise the whole corpus is evaluated. Runs on the CUDA card unless
``--device`` names another device. Under ``torch.distributed.run``
(``--num-devices``, default every rank) each rank evaluates its rows of
every global minibatch (rounded down to a multiple of the width) and
the sums and counts are reduced over the ranks before they divide;
rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from rocalphago_tpu_torch.data.pipeline import ShardedDataset
from rocalphago_tpu_torch.models.nn_util import NeuralNetBase
from rocalphago_tpu_torch.parallel import mesh as meshlib
from rocalphago_tpu_torch.training.sl import (
    evaluate_batches,
    make_eval_step as make_policy_eval_step,
)
from rocalphago_tpu_torch.training.value import (
    make_eval_step as make_value_eval_step,
)


def evaluate_model(net: NeuralNetBase, dataset: ShardedDataset,
                   indices: np.ndarray, minibatch: int = 256,
                   max_batches: int | None = None,
                   num_devices: int | None = None) -> dict:
    """Loss/top-1 (policy-shaped nets) or MSE (value nets, on an
    outcome corpus) over ``indices``, on the net's device; short
    batches padded with zero weights. ``num_devices`` (default every
    rank): the data width; the minibatch is rounded to a multiple of
    it."""
    mesh = meshlib.make_mesh(num_devices, net.device)
    dwidth = mesh.shape[meshlib.DATA_AXIS]
    if minibatch % dwidth:
        minibatch = dwidth * max(minibatch // dwidth, 1)
    mesh = mesh if mesh.sharded else None
    if dataset.manifest.get("targets") == "outcome":
        eval_step = make_value_eval_step(net.module, mesh=mesh)
    else:
        eval_step = make_policy_eval_step(net.module, net.board * net.board,
                                          mesh=mesh)
    out, count = evaluate_batches(eval_step, dataset, indices, minibatch,
                                  net.device, max_batches, mesh=mesh)
    if not count:
        return {"positions": 0}
    out["positions"] = int(count)
    if "accuracy" in out:
        out["top1"] = out.pop("accuracy")
    return out


def pick_split(dataset, split: str, shuffle_npz: str | None):
    if shuffle_npz is None:
        return np.arange(len(dataset))
    z = np.load(shuffle_npz)
    if split not in z:
        raise ValueError(f"split {split!r} not in {shuffle_npz} "
                         f"(has {sorted(z.keys())})")
    return z[split]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="Evaluate a saved model on a converted corpus")
    ap.add_argument("model_json")
    ap.add_argument("corpus", help="npz shard prefix")
    ap.add_argument("--split", default="test",
                    choices=("train", "val", "test"))
    ap.add_argument("--shuffle-npz", default=None,
                    help="trainer split file; restricts to --split")
    ap.add_argument("--minibatch", "-B", type=int, default=256)
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--num-devices", type=int, default=None,
                    help="data-parallel width (default: every rank)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args(argv)
    meshlib.distributed_init(device=a.device)
    device = meshlib.make_mesh(a.num_devices, a.device).device
    net = NeuralNetBase.load_model(a.model_json, device=device)
    dataset = ShardedDataset(a.corpus)
    if dataset.planes != net.preprocess.output_dim:
        raise ValueError(
            f"corpus has {dataset.planes} planes but the model needs "
            f"{net.preprocess.output_dim}")
    indices = pick_split(dataset, a.split, a.shuffle_npz)
    result = dict(evaluate_model(net, dataset, indices,
                                 minibatch=a.minibatch,
                                 max_batches=a.max_batches,
                                 num_devices=a.num_devices),
                  model=a.model_json, split=a.split)
    if meshlib.is_coordinator():
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
