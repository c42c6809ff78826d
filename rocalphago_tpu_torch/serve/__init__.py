"""Fleet-grade play service: one batching evaluator, many live games.

The port of the reference package's ``serve/``. Every active search
waits on the same small policy and value evaluation, so the pending leaf
evaluations of all live games coalesce into one device batch:

* :mod:`.evaluator` -- the shared :class:`~.evaluator.
  BatchingEvaluator`: the pool's evaluation at a few fixed batch sizes,
  fed by a queue that coalesces pending leaf requests across sessions
  under a fill-target / max-wait dispatch policy, padding to the next
  size;
* :mod:`.sessions` -- :class:`~.sessions.ServePool`,
  :class:`~.sessions.SessionPlayer` and :class:`~.sessions.FleetDriver`:
  concurrent game sessions sharing one device searcher
  (``search/device_mcts.py``'s ``prepare_sim`` / ``apply_sim`` seam)
  whose leaf evaluations go through the shared evaluator;
* :mod:`.admission` -- the bounded queue and the session cap; under
  overload a shed (:class:`~.admission.EvaluatorOverload`) steps the
  session down its :class:`~rocalphago_tpu_torch.interface.resilient.
  ResilientPlayer` ladder;
* :mod:`.evalcache` -- the optional transposition cache.
"""

from rocalphago_tpu_torch.serve.admission import (  # noqa: F401
    AdmissionController,
    AdmissionError,
    EvaluatorOverload,
)
from rocalphago_tpu_torch.serve.evaluator import BatchingEvaluator  # noqa: F401
from rocalphago_tpu_torch.serve.sessions import (  # noqa: F401
    FleetDriver,
    ServePool,
    ServeSession,
    SessionPlayer,
)
