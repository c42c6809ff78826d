"""Live model rollout: hot-swap serving, the Wilson-gated canary, and
the federated gateway router.

The port of the reference package's ``rollout/``; spills, frames and
probe blocks are the reference's, so either package's watcher follows
either package's spill and the router federates either package's
gateways:

* :mod:`~rocalphago_tpu_torch.rollout.hotswap` -- swap a promoted pair
  under live sessions as a versioned pointer flip (no dropped games),
  fed in process by a :class:`~rocalphago_tpu_torch.training.actor.
  ParamsPublisher` or across processes by the spill pointer;
* :mod:`~rocalphago_tpu_torch.rollout.canary` -- route a slice of
  sessions to a candidate version and gate full rollout on the Wilson
  95% lower bound, with instant rollback to the incumbent;
* :mod:`~rocalphago_tpu_torch.rollout.router` -- federate N gateway
  replicas behind one front door: sticky routing, spillover on
  ``overload``, drain-aware failover, health probing, and convergence
  checks for a fleet-wide promotion.
"""

from rocalphago_tpu_torch.rollout.canary import CanaryController
from rocalphago_tpu_torch.rollout.hotswap import (
    HotSwapper,
    PublisherWatcher,
    SpillWatcher,
)
from rocalphago_tpu_torch.rollout.router import Replica, RolloutRouter

__all__ = [
    "CanaryController",
    "HotSwapper",
    "PublisherWatcher",
    "Replica",
    "RolloutRouter",
    "SpillWatcher",
]
