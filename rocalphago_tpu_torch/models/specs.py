"""CLI that writes a model JSON spec with fresh weights: the port of
``models/specs.py``::

    python -m rocalphago_tpu_torch.models.specs policy --out policy.json
    python -m rocalphago_tpu_torch.models.specs value --out value.json
    python -m rocalphago_tpu_torch.models.specs rollout --out rollout.json

The spec and its Flax msgpack weights are the reference's format, so
either package loads them. The weights come from the port's seeded
:func:`~.nn_util.init_params`, not from the reference's draws. A net
without the ladder planes is asked for with ``--features``, a legacy
value head with ``--head dense``. The nets are built on the card unless
``--device`` names another device.
"""

from __future__ import annotations

import argparse
import sys

from rocalphago_tpu_torch.features import DEFAULT_FEATURES, VALUE_FEATURES
from rocalphago_tpu_torch.models.policy import CNNPolicy
from rocalphago_tpu_torch.models.rollout import ROLLOUT_FEATURES, CNNRollout
from rocalphago_tpu_torch.models.value import CNNValue


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Write a model JSON spec with fresh weights")
    ap.add_argument("kind", choices=("policy", "value", "rollout"))
    ap.add_argument("--out", required=True, help="spec path (.json)")
    ap.add_argument("--board", type=int, default=19)
    ap.add_argument("--layers", type=int, default=12,
                    help="conv trunk depth (policy/value only; the "
                         "rollout net is fixed at one conv layer)")
    ap.add_argument("--filters", type=int, default=None,
                    help="filters per conv layer (default 128; rollout "
                         "default 32)")
    ap.add_argument("--features", nargs="*", default=None,
                    help=f"feature names (policy default: the AlphaGo "
                         f"48-plane set {', '.join(DEFAULT_FEATURES)}; "
                         f"value default adds the 'color' plane (49); "
                         f"rollout default: {', '.join(ROLLOUT_FEATURES)})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--head", default=None,
                    help="head variant: 'fcn' (size-generic params, the "
                         "default) or the legacy size-locked head "
                         "('dense' for value, 'bias' for policy/rollout)")
    ap.add_argument("--trunk-pool", type=int, default=0,
                    help="global-pooling bias blocks in the conv trunk "
                         "(policy/value only; default 0, the plain "
                         "AlphaGo trunk)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run on "
                         "the CPU)")
    a = ap.parse_args(argv)

    common = dict(board=a.board, seed=a.seed, device=a.device,
                  **({"head": a.head} if a.head else {}))
    if a.kind == "policy":
        net = CNNPolicy(tuple(a.features or DEFAULT_FEATURES),
                        layers=a.layers, filters_per_layer=a.filters or 128,
                        **({"trunk_pool": a.trunk_pool}
                           if a.trunk_pool else {}), **common)
    elif a.kind == "value":
        net = CNNValue(tuple(a.features or VALUE_FEATURES),
                       layers=a.layers, filters_per_layer=a.filters or 128,
                       **({"trunk_pool": a.trunk_pool}
                          if a.trunk_pool else {}), **common)
    else:
        net = CNNRollout(tuple(a.features or ROLLOUT_FEATURES),
                         filters=a.filters or 32, **common)
    net.save_model(a.out)
    print(f"wrote {a.out} ({type(net).__name__}, board={a.board}, "
          f"head={net.spec_kwargs['head']}, "
          f"{net.preprocess.output_dim} planes)")
    return net


if __name__ == "__main__":
    main(sys.argv[1:])
